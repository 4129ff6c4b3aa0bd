"""Hand-written CUDA mLSTM sequence mix and its gradient, bound with
ctypes.

``csrc/mlstm_attention.cu`` holds two routes, picked by ``route`` from the
dtype and the head dim before the launch (never after a failure):

* ``"wgmma"``: bf16 at hd 128, 256 and 384 (``mlstm_attention_wgmma_bf16``;
  xlstm-125m's head dim is 384), the tensor cores fed by TMA, the
  accumulator split over two consumer warpgroups;
* ``"simt"``: float32 at every head dim in ``HEAD_DIMS`` and bf16 at hd 16,
  32 and 64 (``mlstm_attention_simt_bf16`` / ``_f32``), float32 FMA on the
  CUDA cores.

Both replace src/repro/kernels/mlstm_attention/kernel.py:26 _mlstm_kernel
(Pallas TPU), once per mLSTM layer per prefill or training forward (twice
a train step under ``remat``), and both count as a launch of
``mlstm_attention`` (``build.LAUNCHES``); ``build.ROUTES`` counts them by
route.  The kernel is bound by operations (the source's header gives
the numbers and the design).  Both read the model's (B, S, H, hd) layout
in place, so no transposed or widened copy of q, k or v is made.

``csrc/mlstm_attention_backward.cu`` holds the gradient, in the same two
routes, picked by the same ``route``:

* ``"wgmma"``: bf16 at hd 128, 256 and 384
  (``mlstm_attention_backward_wgmma_bf16``): four tensor-core kernels fed
  by TMA (the row statistics, then dq, dk and dv);
* ``"simt"``: float32 at every head dim and bf16 at hd 16, 32 and 64
  (``mlstm_attention_backward_simt_bf16`` / ``_f32``), float32 FMA on the
  CUDA cores.

It replaces no Pallas kernel (the reference differentiates its jnp
mLSTM), runs once per mLSTM layer per train step and counts as a launch
of ``mlstm_attention_backward`` (``build.ROUTES`` by route).  ``wgmma.cuh``
holds the TMA and wgmma pieces both sources' tensor-core routes use.

The wrappers take CUDA tensors only: they check device, dtype, shape,
contiguity and alignment, allocate the outputs with ``torch.empty``,
launch on the current stream, raise if the launch reports an error, and
count the launch.  There is no fallback: ``ops.py`` sends CPU tensors to
the plain torch versions before anything here is reached.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import check_tensor, launch, load

#: head dims the kernel is instantiated for (xlstm-125m's is 384)
HEAD_DIMS = (16, 32, 64, 128, 256, 384)
#: head dims of the tensor-core route: each consumer warpgroup owns hd / 2
#: output columns, whole 64-column TMA boxes
WGMMA_HEAD_DIMS = (128, 256, 384)
#: query rows per block on both routes (the grid's y walks S in such tiles)
BLOCK_Q = 64
#: TMA reads from 16-byte aligned addresses
ALIGN = 16

_P, _I = ctypes.c_void_p, ctypes.c_int
#: q, k, v, F, I, out; B, S, H, hd; stream
_ARGTYPES = [_P] * 6 + [_I] * 4 + [_P]
#: dtype of q, k, v -> entry-point suffix
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}
_ENTRIES = ("mlstm_attention_wgmma_bf16", "mlstm_attention_simt_bf16",
            "mlstm_attention_simt_f32")


def route(dtype: torch.dtype, hd: int) -> str:
    """The kernel that computes the mix at this dtype and head dim:
    ``"wgmma"`` (tensor cores) for bf16 at hd 128, 256 and 384, else
    ``"simt"`` (float32 FMA: a float32 product on the tensor cores would be
    TF32)."""
    if dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "simt"


def _entry(dtype: torch.dtype, hd: int, simt: bool):
    suffix = _SUFFIX.get(dtype)
    if suffix is None:
        raise TypeError(f"mlstm_attention_cuda takes bfloat16 or float32 "
                        f"q, k, v, got {dtype}")
    r = "simt" if simt else route(dtype, hd)
    lib = load("mlstm_attention", {e: _ARGTYPES for e in _ENTRIES})
    return r, getattr(lib, f"mlstm_attention_{r}_{suffix}")


def mlstm_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         F: torch.Tensor, I: torch.Tensor, *,
                         simt: bool = False) -> torch.Tensor:
    """q, k, v: (B, S, H, hd) of one dtype (bf16 or float32), k already
    scaled by hd**-0.5; F (inclusive cumulative log-forget) and I (log
    input gate): (B, S, H) float32; all contiguous.  Returns (B, S, H,
    hd) in q's dtype.  ``simt=True`` takes the CUDA-core route where
    ``route`` would take the tensor cores: the chip smoke test and the
    ablation time both routes on the same inputs; the model's path never
    passes it."""
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
    name, fn = _entry(q.dtype, hd, simt)
    check_tensor(q, "q", (B, S, H, hd), q.dtype, dev)
    check_tensor(k, "k", (B, S, H, hd), q.dtype, dev)
    check_tensor(v, "v", (B, S, H, hd), q.dtype, dev)
    check_tensor(F, "F", (B, S, H), torch.float32, dev)
    check_tensor(I, "I", (B, S, H), torch.float32, dev)
    if name == "wgmma" and any(t.data_ptr() % ALIGN for t in (q, k, v)):
        raise ValueError(f"mlstm_attention_cuda's {name} route reads q, k "
                         f"and v by TMA from {ALIGN}-byte aligned addresses")
    out = torch.empty_like(q)
    launch(fn, (q, k, v, F, I, out), (B, S, H, hd), dev, "mlstm_attention",
           route=name)
    return out


#: q, k, v, F, I, dh, dq, dk, dv, dF, dI, the scratch m / den / dn; B, S,
#: H, hd; stream
_BACKWARD_ARGTYPES = [_P] * 14 + [_I] * 4 + [_P]
_BACKWARD_ENTRIES = ("mlstm_attention_backward_wgmma_bf16",
                     "mlstm_attention_backward_simt_bf16",
                     "mlstm_attention_backward_simt_f32")


def mlstm_attention_backward_cuda(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, F: torch.Tensor,
                                  I: torch.Tensor, dh: torch.Tensor, *,
                                  simt: bool = False):
    """The gradient of the mix: q, k, v and the output gradient dh (B, S,
    H, hd) of one dtype (bf16 or float32); F, I (B, S, H) float32; all
    contiguous, on the card, at a head dim of ``HEAD_DIMS``.  Returns (dq,
    dk, dv) in q's dtype and (dF, dI) float32.  One launch of the route
    ``route`` picks (``wgmma``: the statistics, dq, dk and dv kernels;
    ``simt``: a pass over query tiles, then one over key tiles); the
    scratch (each row's m, den and dn) is allocated here and dropped on
    return.  ``simt=True`` takes the CUDA-core route where ``route`` would
    take the tensor cores: the chip smoke test and the ablation time both
    on the same inputs; the model's path never passes it."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"mlstm_attention_backward_cuda needs CUDA tensors, "
                         f"got {dev}")
    if q.ndim != 4:
        raise ValueError(f"mlstm_attention_backward_cuda takes q (B, S, H, "
                         f"hd), got {tuple(q.shape)}")
    B, S, H, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"mlstm_attention_backward_cuda is instantiated for "
                         f"head dims {HEAD_DIMS}, got {hd}")
    if not (1 <= S and 1 <= B * H < 2 ** 31 and -(-S // 32) <= 65535):
        raise ValueError(f"mlstm_attention_backward_cuda takes B * H < 2^31 "
                         f"and S in [1, {65535 * 32}], got {tuple(q.shape)}")
    suffix = _SUFFIX.get(q.dtype)
    if suffix is None:
        raise TypeError(f"mlstm_attention_backward_cuda takes bfloat16 or "
                        f"float32 q, k, v, dh, got {q.dtype}")
    for t, name in ((q, "q"), (k, "k"), (v, "v"), (dh, "dh")):
        check_tensor(t, name, (B, S, H, hd), q.dtype, dev)
    check_tensor(F, "F", (B, S, H), torch.float32, dev)
    check_tensor(I, "I", (B, S, H), torch.float32, dev)
    name = "simt" if simt else route(q.dtype, hd)
    if name == "wgmma" and any(t.data_ptr() % ALIGN for t in (q, k, v, dh)):
        raise ValueError(f"mlstm_attention_backward_cuda's {name} route "
                         f"reads q, k, v and dh by TMA from {ALIGN}-byte "
                         f"aligned addresses")
    lib = load("mlstm_attention_backward",
               {e: _BACKWARD_ARGTYPES for e in _BACKWARD_ENTRIES})
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dF, dI, m, den, dn = (torch.empty_like(F) for _ in range(5))
    launch(getattr(lib, f"mlstm_attention_backward_{name}_{suffix}"),
           (q, k, v, F, I, dh, dq, dk, dv, dF, dI, m, den, dn),
           (B, S, H, hd), dev, "mlstm_attention_backward", route=name)
    return dq, dk, dv, dF, dI
