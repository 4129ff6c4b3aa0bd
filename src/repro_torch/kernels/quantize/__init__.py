from repro_torch.kernels.quantize.ops import (  # noqa: F401
    dequantize,
    dequantize_blocks,
    dequantize_torch,
    fma32,
    quantize,
    quantize_blocks,
    quantize_torch,
)
