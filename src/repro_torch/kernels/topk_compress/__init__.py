from repro_torch.kernels.topk_compress.ops import (  # noqa: F401
    topk_compress,
    topk_compress_blocks,
    topk_compress_torch,
)
