"""Hand-written CUDA int8 quantize and dequantize, bound with ctypes.

``csrc/quantize.cu`` -> ``quantize`` and ``dequantize`` (float32); they
replace src/repro/kernels/quantize/kernel.py:_quant_kernel and
:_dequant_kernel (Pallas TPU).  The int8 compressor launches ``quantize``
once per gradient leaf per pod and ``dequantize`` once per leaf per pod in
its pod sum.  Both are bound by bytes (the source's header gives the
numbers and the design).

The wrappers take CUDA tensors only: they check device, dtype, shape and
contiguity, allocate the outputs with ``torch.empty``, launch on the
current stream, raise if the launch reports an error, and count the launch
in ``build.LAUNCHES["quantize"]`` / ``["dequantize"]``.  There is no
fallback: ``ops.py`` sends CPU tensors to the plain torch versions before
anything here is reached.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.build import check_tensor, launch, load

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: x, q, scale, residual; nb, block; stream
_QUANT_ARGS = [_P] * 4 + [_I, _L, _P]
#: q, scale, out; nb, block, accumulate; stream
_DEQUANT_ARGS = [_P] * 3 + [_I, _L, _I, _P]


def _check_grid(nb: int, block: int, what: str) -> None:
    if not 1 <= nb < 2 ** 31:
        raise ValueError(f"{what} takes 1 to 2^31 - 1 blocks, got {nb}")
    if block < 1:
        raise ValueError(f"{what} needs a positive block, got {block}")


def quantize_cuda(x: torch.Tensor, *, residual: bool = False):
    """x: (nb, block) float32, contiguous, on the card.  Returns (q int8
    (nb, block), scale float32 (nb, 1)), and the residual
    ``fma(-q, scale, x)`` (float32) as a third output when asked."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"quantize_cuda needs a CUDA tensor, got {dev}")
    if x.ndim != 2:
        raise ValueError(f"quantize_cuda takes (nb, block), got "
                        f"{tuple(x.shape)}")
    nb, block = x.shape
    _check_grid(nb, block, "quantize_cuda")
    check_tensor(x, "x", (nb, block), torch.float32, dev)
    lib = load("quantize", {"quantize": _QUANT_ARGS})
    q = torch.empty((nb, block), dtype=torch.int8, device=dev)
    scale = torch.empty((nb, 1), dtype=torch.float32, device=dev)
    res = torch.empty_like(x) if residual else None
    launch(lib.quantize, (x, q, scale, res), (nb, block), dev, "quantize")
    return (q, scale, res) if residual else (q, scale)


def dequantize_cuda(q: torch.Tensor, scale: torch.Tensor,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: int8 (nb, block); scale: float32 (nb, 1).  Returns float32
    ``q * scale``; with ``out`` (float32 (nb, block)) it computes
    ``fma(q, scale, out)`` into ``out`` in place and returns it."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"dequantize_cuda needs CUDA tensors, got {dev}")
    if q.ndim != 2:
        raise ValueError(f"dequantize_cuda takes (nb, block), got "
                         f"{tuple(q.shape)}")
    nb, block = q.shape
    _check_grid(nb, block, "dequantize_cuda")
    check_tensor(q, "q", (nb, block), torch.int8, dev)
    check_tensor(scale, "scale", (nb, 1), torch.float32, dev)
    accumulate = out is not None
    if accumulate:
        check_tensor(out, "out", (nb, block), torch.float32, dev)
    else:
        out = torch.empty((nb, block), dtype=torch.float32, device=dev)
    lib = load("dequantize", {"dequantize": _DEQUANT_ARGS})
    launch(lib.dequantize, (q, scale, out), (nb, block, int(accumulate)),
           dev, "dequantize")
    return out
