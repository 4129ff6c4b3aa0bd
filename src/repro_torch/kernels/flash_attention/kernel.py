"""Hand-written CUDA flash attention (forward), bound with ctypes.

``csrc/flash_attention.cu`` -> ``flash_attention_bf16`` /
``flash_attention_f32``, picked by q's dtype; replaces
src/repro/kernels/flash_attention/kernel.py:_flash_kernel (Pallas TPU),
once per attention layer per prefill.  It is bound by operations (the
source's header gives the numbers and the design).  The kernel is
instantiated for the head dims in ``HEAD_DIMS``; the wrapper refuses any
other.

The wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates the output with ``torch.empty``, launches on the
current stream, raises if the launch reports an error, and counts the
launch in ``build.LAUNCHES["flash_attention"]``.  There is no fallback:
``ops.py`` sends CPU tensors to the plain torch version before anything
here is reached.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import check_tensor, launch, load

#: head dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 128)

_P, _I = ctypes.c_void_p, ctypes.c_int
#: q, k, v, out; BK, G, S, hd, causal; scale; stream
_ARGTYPES = [_P] * 4 + [_I] * 5 + [ctypes.c_float, _P]
#: dtype -> entry-point suffix
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}


def _entry(dtype: torch.dtype):
    suffix = _SUFFIX.get(dtype)
    if suffix is None:
        raise TypeError(f"flash_attention_cuda takes bfloat16 or float32, "
                        f"got {dtype}")
    lib = load("flash_attention", {f"flash_attention_{s}": _ARGTYPES
                                   for s in _SUFFIX.values()})
    return getattr(lib, f"flash_attention_{suffix}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True) -> torch.Tensor:
    """q: (BK, G, S, hd); k, v: (BK, S, hd), all of one dtype and
    contiguous.  Returns (BK, G, S, hd) in q's dtype."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got {dev}")
    BK, G, S, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda is instantiated for head dims "
                         f"{HEAD_DIMS}, got {hd}")
    if BK > 65535 or G > 65535:
        raise ValueError(f"flash_attention_cuda takes BK and G up to 65535, "
                         f"got {BK} and {G}")
    fn = _entry(q.dtype)
    check_tensor(q, "q", (BK, G, S, hd), q.dtype, dev)
    check_tensor(k, "k", (BK, S, hd), q.dtype, dev)
    check_tensor(v, "v", (BK, S, hd), q.dtype, dev)
    out = torch.empty_like(q)
    launch(fn, (q, k, v, out), (BK, G, S, hd, int(causal), hd ** -0.5), dev,
           "flash_attention")
    return out
