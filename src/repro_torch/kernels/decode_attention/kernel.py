"""Hand-written CUDA flash-decoding (phase 1), bound with ctypes.

``csrc/decode_attention.cu`` -> ``decode_attention_bf16`` /
``decode_attention_f32``, picked by q's dtype; replaces
src/repro/kernels/decode_attention/kernel.py:_decode_kernel (Pallas TPU),
once per attention layer per decode step.  It is bound by bytes (the
source's header gives the numbers and the design).  The kernel is
instantiated for the head dims in ``HEAD_DIMS``; the wrapper refuses any
other.

The wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates the partials with ``torch.empty``, launches on the
current stream, raises if the launch reports an error, and counts the
launch in ``build.LAUNCHES["decode_attention"]``.  There is no fallback:
``ops.py`` sends CPU tensors to the plain torch version before anything
here is reached.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import check_tensor, launch, load

#: head dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 128)
#: the kernel keeps at most 8 (g, d) accumulators in each of 256 threads
MAX_G_X_HD = 2048
#: shared memory a block may use on Hopper (227 KB)
MAX_SMEM_BYTES = 232448
_TILE_KEYS = 64

_P, _I = ctypes.c_void_p, ctypes.c_int
#: q, k, v, acc, m, l; B, KH, G, S, hd, kv_len, bc; scale; stream
_ARGTYPES = [_P] * 6 + [_I] * 7 + [ctypes.c_float, _P]
#: dtype -> entry-point suffix
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}


def _entry(dtype: torch.dtype):
    suffix = _SUFFIX.get(dtype)
    if suffix is None:
        raise TypeError(f"decode_attention_cuda takes bfloat16 or float32, "
                        f"got {dtype}")
    lib = load("decode_attention", {f"decode_attention_{s}": _ARGTYPES
                                    for s in _SUFFIX.values()})
    return getattr(lib, f"decode_attention_{suffix}")


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, kv_len: int, bc: int):
    """q: (B, KH, G, hd); k, v: the cache, (B, S, KH, hd), of q's dtype;
    keys ``[0, kv_len)`` count.  Returns float32 partials acc
    (B*KH, G, nc, hd), m and l (B*KH, G, nc), nc = ceil(S / bc)."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"decode_attention_cuda needs CUDA tensors, got "
                         f"{dev}")
    B, KH, G, hd = q.shape
    S = k.shape[1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention_cuda is instantiated for head "
                         f"dims {HEAD_DIMS}, got {hd}")
    if G * hd > MAX_G_X_HD:
        raise ValueError(f"decode_attention_cuda takes G x hd up to "
                         f"{MAX_G_X_HD}, got {G} x {hd}")
    if not 1 <= kv_len <= S:
        raise ValueError(f"kv_len must lie in [1, {S}], got {kv_len}")
    if bc < 1:
        raise ValueError(f"bc must be positive, got {bc}")
    smem = 4 * (_TILE_KEYS * (hd + 4) + G * hd + G * bc)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"decode_attention_cuda keeps G x bc scores in "
                         f"shared memory: G = {G}, bc = {bc} needs {smem} "
                         f"bytes, more than {MAX_SMEM_BYTES}")
    if B * KH > 65535:
        raise ValueError(f"decode_attention_cuda takes B x KH up to 65535, "
                         f"got {B * KH}")
    fn = _entry(q.dtype)
    check_tensor(q, "q", (B, KH, G, hd), q.dtype, dev)
    check_tensor(k, "k", (B, S, KH, hd), q.dtype, dev)
    check_tensor(v, "v", (B, S, KH, hd), q.dtype, dev)
    nc = -(-S // bc)
    f32 = torch.float32
    acc = torch.empty((B * KH, G, nc, hd), dtype=f32, device=dev)
    m = torch.empty((B * KH, G, nc), dtype=f32, device=dev)
    l = torch.empty((B * KH, G, nc), dtype=f32, device=dev)
    launch(fn, (q, k, v, acc, m, l),
           (B, KH, G, S, hd, kv_len, bc, hd ** -0.5), dev, "decode_attention")
    return acc, m, l
