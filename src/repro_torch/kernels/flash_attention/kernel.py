"""Hand-written CUDA flash attention (forward), bound with ctypes.

``csrc/flash_attention.cu`` holds two routes, picked by ``route`` from the
dtype and the head dim before the launch (never after a failure):

* ``"wgmma"``: bf16 at hd 64 and 128 (``flash_attention_wgmma_bf16``), the
  tensor cores fed by TMA;
* ``"simt"``: float32 at every head dim in ``HEAD_DIMS`` and bf16 at hd 16
  and 32 (``flash_attention_simt_bf16`` / ``_f32``), float32 FMA on the
  CUDA cores.

Both replace src/repro/kernels/flash_attention/kernel.py:_flash_kernel
(Pallas TPU), once per attention layer per prefill, and both count as a
launch of ``flash_attention`` (``build.LAUNCHES``); ``build.ROUTES``
counts them by route.  The kernel is bound by operations (the source's
header gives the numbers and the design).

The wrapper takes CUDA tensors only: it checks device, dtype, shape,
contiguity and alignment, allocates the output with ``torch.empty``,
launches on the current stream, raises if the launch reports an error,
and counts the launch.  There is no fallback: ``ops.py`` sends CPU
tensors to the plain torch version before anything here is reached.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import check_tensor, launch, load

#: head dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 128)
#: head dims of the tensor-core route (64-column TMA boxes)
WGMMA_HEAD_DIMS = (64, 128)
#: TMA reads from 16-byte aligned addresses
ALIGN = 16

_P, _I = ctypes.c_void_p, ctypes.c_int
#: q, k, v, out; BK, G, S, hd, causal; scale; stream
_ARGTYPES = [_P] * 4 + [_I] * 5 + [ctypes.c_float, _P]
#: dtype -> entry-point suffix
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}
_ENTRIES = ("flash_attention_wgmma_bf16", "flash_attention_simt_bf16",
            "flash_attention_simt_f32")


def route(dtype: torch.dtype, hd: int) -> str:
    """The kernel that computes attention at this dtype and head dim:
    ``"wgmma"`` (tensor cores) for bf16 at hd 64 and 128, else ``"simt"``
    (float32 FMA: a float32 product on the tensor cores would be TF32)."""
    if dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "simt"


def _entry(dtype: torch.dtype, hd: int):
    suffix = _SUFFIX.get(dtype)
    if suffix is None:
        raise TypeError(f"flash_attention_cuda takes bfloat16 or float32, "
                        f"got {dtype}")
    lib = load("flash_attention", {e: _ARGTYPES for e in _ENTRIES})
    r = route(dtype, hd)
    return r, getattr(lib, f"flash_attention_{r}_{suffix}")


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
    name, fn = _entry(q.dtype, hd)
    check_tensor(q, "q", (BK, G, S, hd), q.dtype, dev)
    check_tensor(k, "k", (BK, S, hd), q.dtype, dev)
    check_tensor(v, "v", (BK, S, hd), q.dtype, dev)
    if name == "wgmma" and any(t.data_ptr() % ALIGN for t in (q, k, v)):
        raise ValueError(f"flash_attention_cuda's {name} route reads q, k "
                         f"and v by TMA from {ALIGN}-byte aligned addresses")
    out = torch.empty_like(q)
    launch(fn, (q, k, v, out), (BK, G, S, hd, int(causal), hd ** -0.5), dev,
           "flash_attention", route=name)
    return out
