"""Hand-written CUDA flash-decoding, both phases in one launch, bound with
ctypes.

``csrc/decode_attention.cu`` -> ``decode_attention_bf16`` /
``decode_attention_f32``, picked by q's dtype; replaces
src/repro/kernels/decode_attention/kernel.py:_decode_kernel (Pallas TPU)
and the jnp combine of its ``ops.py``, once per attention layer per decode
step.  It is bound by bytes (the source's header gives the numbers and the
design).  The kernel is instantiated for the head dims in ``HEAD_DIMS``
and up to ``MAX_G`` query heads per kv head; the wrapper refuses any
other.

``plan_splits`` is the split plan, plain Python: the keys ``[0, kv_len)``
of each (b, kv head) are cut into ``nsplit`` splits of ``kps`` keys (the
last may be shorter, none is empty), enough of them to keep about
``BLOCKS_PER_SM`` blocks on each SM.  On the card the splits take the
place of the reference's chunk ``bc``: the result is the same function up
to the order of the float32 sums.

The wrapper takes CUDA tensors only: it checks device, dtype, shape,
contiguity and alignment, allocates the output and the float32 workspace
with ``torch.empty``, launches on the current stream, raises if the launch
reports an error, and counts the launch in
``build.LAUNCHES["decode_attention"]``.  The kernel's counters, one int32
per (b, kv head), are zeroed once when first allocated on a device, and
grown when B x KH grows; the kernel leaves them at 0.  Two calls running
at once on two streams must not share them, and the port runs on one
stream.  There is no fallback: ``ops.py`` sends CPU tensors to the plain
torch version before anything here is reached.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels.build import check_tensor, launch, load

#: head dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 128)
#: query heads per kv head the kernel keeps in registers
MAX_G = 8
#: the planner's aims: blocks an SM, keys a split, splits a (b, kv head)
BLOCKS_PER_SM = 2
MIN_SPLIT_KEYS = 64
MAX_SPLITS = 256
#: 16-byte loads of q, k and v
ALIGN = 16

_P, _I = ctypes.c_void_p, ctypes.c_int
#: q, k, v, out, ws, counters; B, KH, G, S, hd, kv_len, nsplit, kps;
#: scale; stream
_ARGTYPES = [_P] * 6 + [_I] * 8 + [ctypes.c_float, _P]
#: dtype -> entry-point suffix
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}
#: device index -> the kernel's int32 counters (zero at rest)
_COUNTERS: Dict[int, torch.Tensor] = {}
#: device index -> its SM count
_SMS: Dict[int, int] = {}


def plan_splits(kv_len: int, bkh: int, sms: int) -> Tuple[int, int]:
    """(nsplit, kps) for ``bkh`` (b, kv head) pairs over ``kv_len`` live
    keys on a card with ``sms`` SMs: split s takes keys
    ``[s * kps, min((s + 1) * kps, kv_len))``.  About ``BLOCKS_PER_SM``
    blocks an SM, at least ``MIN_SPLIT_KEYS`` keys a split (so a short
    cache gets fewer splits, down to 1), at most ``MAX_SPLITS``, and no
    empty split."""
    if kv_len < 1 or bkh < 1 or sms < 1:
        raise ValueError(f"plan_splits needs kv_len, bkh and sms >= 1, got "
                         f"{kv_len}, {bkh}, {sms}")
    want = -(-BLOCKS_PER_SM * sms // bkh)
    nsplit = max(1, min(want, kv_len // MIN_SPLIT_KEYS, MAX_SPLITS))
    kps = -(-kv_len // nsplit)
    return -(-kv_len // kps), kps


def _entry(dtype: torch.dtype):
    suffix = _SUFFIX.get(dtype)
    if suffix is None:
        raise TypeError(f"decode_attention_cuda takes bfloat16 or float32, "
                        f"got {dtype}")
    lib = load("decode_attention", {f"decode_attention_{s}": _ARGTYPES
                                    for s in _SUFFIX.values()})
    return getattr(lib, f"decode_attention_{suffix}")


def _index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _sms(dev: torch.device) -> int:
    idx = _index(dev)
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _counters(dev: torch.device, n: int) -> torch.Tensor:
    idx = _index(dev)
    buf = _COUNTERS.get(idx)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 2 * (0 if buf is None else buf.numel())),
                          dtype=torch.int32, device=dev)
        _COUNTERS[idx] = buf
    return buf


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, kv_len: int) -> torch.Tensor:
    """q: (B, KH, G, hd); k, v: the cache, (B, S, KH, hd), of q's dtype;
    keys ``[0, kv_len)`` count.  Returns (B, KH, G, hd) in q's dtype."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"decode_attention_cuda needs CUDA tensors, got "
                         f"{dev}")
    B, KH, G, hd = q.shape
    S = k.shape[1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention_cuda is instantiated for head "
                         f"dims {HEAD_DIMS}, got {hd}")
    if G > MAX_G:
        raise ValueError(f"decode_attention_cuda takes G up to {MAX_G} query "
                         f"heads per kv head, got {G}")
    if not 1 <= kv_len <= S:
        raise ValueError(f"kv_len must lie in [1, {S}], got {kv_len}")
    if B * KH > 65535:
        raise ValueError(f"decode_attention_cuda takes B x KH up to 65535, "
                         f"got {B * KH}")
    fn = _entry(q.dtype)
    check_tensor(q, "q", (B, KH, G, hd), q.dtype, dev)
    check_tensor(k, "k", (B, S, KH, hd), q.dtype, dev)
    check_tensor(v, "v", (B, S, KH, hd), q.dtype, dev)
    if any(t.data_ptr() % ALIGN for t in (q, k, v)):
        raise ValueError(f"decode_attention_cuda reads q, k and v in "
                         f"{ALIGN}-byte loads: they must be {ALIGN}-byte "
                         f"aligned")
    nsplit, kps = plan_splits(kv_len, B * KH, _sms(dev))
    out = torch.empty_like(q)
    # each split's (m, l, 2 floats of padding, acc): 16-byte records
    ws = None if nsplit == 1 else torch.empty(
        (B * KH, nsplit, G, hd + 4), dtype=torch.float32, device=dev)
    launch(fn, (q, k, v, out, ws, _counters(dev, B * KH)),
           (B, KH, G, S, hd, kv_len, nsplit, kps, hd ** -0.5), dev,
           "decode_attention")
    return out
