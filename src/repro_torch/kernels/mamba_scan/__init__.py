from repro_torch.kernels.mamba_scan.ops import (  # noqa: F401
    mamba_scan,
    mamba_scan_torch,
)
