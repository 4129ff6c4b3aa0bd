from repro_torch.core import modes, qos, slo  # noqa: F401
from repro_torch.core.modes import AsyncMode  # noqa: F401
