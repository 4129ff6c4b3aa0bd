from repro_torch.optim import adamw, compression, outer  # noqa: F401
from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig,
    apply_updates,
    init_opt_state,
)
from repro_torch.optim.compression import get_compressor  # noqa: F401
from repro_torch.optim.outer import OuterConfig, init_outer_state  # noqa: F401
