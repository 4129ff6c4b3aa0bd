from repro_torch.kernels.duct_exchange.ops import (  # noqa: F401
    CommitResult,
    WindowResult,
    dense_halo_select,
    dense_stage,
    duct_commit,
    duct_commit_torch,
    duct_window,
    duct_window_torch,
)
