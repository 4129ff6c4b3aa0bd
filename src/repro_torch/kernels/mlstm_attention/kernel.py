"""Hand-written CUDA mLSTM sequence mix (forward), bound with ctypes.

``csrc/mlstm_attention.cu`` -> ``mlstm_attention_bf16`` (bf16 q, k, v
with float32 F and I: the model's path) / ``mlstm_attention_f32``
(float32 throughout), picked by q's dtype; replaces
src/repro/kernels/mlstm_attention/kernel.py:_mlstm_kernel (Pallas TPU),
once per mLSTM layer per prefill.  It is bound by operations (the
source's header gives the numbers and the design).  The kernel reads the
model's (B, S, H, hd) layout in place, so no transposed or widened copy
of q, k or v is made; it is instantiated for the head dims in
``HEAD_DIMS``, and the wrapper refuses any other.

The wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates the output with ``torch.empty``, launches on the
current stream, raises if the launch reports an error, and counts the
launch in ``build.LAUNCHES["mlstm_attention"]``.  There is no fallback:
``ops.py`` sends CPU tensors to the plain torch version before anything
here is reached.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import check_tensor, launch, load

#: head dims the kernel is instantiated for (xlstm-125m's is 384)
HEAD_DIMS = (16, 32, 64, 128, 256, 384)
#: query rows per block (the grid's y walks S in such tiles)
BLOCK_Q = 64

_P, _I = ctypes.c_void_p, ctypes.c_int
#: q, k, v, F, I, out; B, S, H, hd; stream
_ARGTYPES = [_P] * 6 + [_I] * 4 + [_P]
#: dtype of q, k, v -> entry-point suffix
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}


def _entry(dtype: torch.dtype):
    suffix = _SUFFIX.get(dtype)
    if suffix is None:
        raise TypeError(f"mlstm_attention_cuda takes bfloat16 or float32 "
                        f"q, k, v, got {dtype}")
    lib = load("mlstm_attention", {f"mlstm_attention_{s}": _ARGTYPES
                                   for s in _SUFFIX.values()})
    return getattr(lib, f"mlstm_attention_{suffix}")


def mlstm_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         F: torch.Tensor, I: torch.Tensor) -> torch.Tensor:
    """q, k, v: (B, S, H, hd) of one dtype (bf16 or float32), k already
    scaled by hd**-0.5; F (inclusive cumulative log-forget) and I (log
    input gate): (B, S, H) float32; all contiguous.  Returns (B, S, H,
    hd) in q's dtype."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"mlstm_attention_cuda needs CUDA tensors, got {dev}")
    if q.ndim != 4:
        raise ValueError(f"mlstm_attention_cuda takes q (B, S, H, hd), got "
                         f"{tuple(q.shape)}")
    B, S, H, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"mlstm_attention_cuda is instantiated for head "
                         f"dims {HEAD_DIMS}, got {hd}")
    if not (1 <= S and 1 <= B * H < 2 ** 31
            and -(-S // BLOCK_Q) <= 65535):
        raise ValueError(f"mlstm_attention_cuda takes B * H < 2^31 and S in "
                         f"[1, {65535 * BLOCK_Q}], got {tuple(q.shape)}")
    fn = _entry(q.dtype)
    check_tensor(q, "q", (B, S, H, hd), q.dtype, dev)
    check_tensor(k, "k", (B, S, H, hd), q.dtype, dev)
    check_tensor(v, "v", (B, S, H, hd), q.dtype, dev)
    check_tensor(F, "F", (B, S, H), torch.float32, dev)
    check_tensor(I, "I", (B, S, H), torch.float32, dev)
    out = torch.empty_like(q)
    launch(fn, (q, k, v, F, I, out), (B, S, H, hd), dev, "mlstm_attention")
    return out
