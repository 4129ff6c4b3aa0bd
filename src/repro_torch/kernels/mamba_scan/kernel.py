"""Hand-written CUDA Mamba-1 selective scan, bound with ctypes.

``csrc/mamba_scan.cu`` -> ``mamba_scan`` (float32); it replaces
src/repro/kernels/mamba_scan/kernel.py:_mamba_kernel (Pallas TPU).  The
Mamba mixer's prefill (``models.ssm.mamba_forward``) launches it once per
Mamba layer.  It is bound by bytes, with the special-function units close
behind (the source's header gives the numbers and the design).

The wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates y and h_final with ``torch.empty``, launches on the
current stream, raises if the launch reports an error, and counts the
launch in ``build.LAUNCHES["mamba_scan"]``.  There is no fallback:
``ops.py`` sends CPU tensors to the plain torch version before anything
here is reached.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import check_tensor, launch, load

_P, _I = ctypes.c_void_p, ctypes.c_int
#: x, dt, B, C, A, y, h; Bb, S, di, N; stream
_ARGTYPES = [_P] * 7 + [_I] * 4 + [_P]

#: the state sizes the kernel is instantiated for
STATE_SIZES = (4, 8, 16, 32)


def mamba_scan_cuda(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                    C: torch.Tensor, A: torch.Tensor):
    """x, dt: (Bb, S, di); B, C: (Bb, S, N); A: (di, N); all float32,
    contiguous, on the card.  Returns (y (Bb, S, di), h_final
    (Bb, di, N)), both float32."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"mamba_scan_cuda needs CUDA tensors, got {dev}")
    if x.ndim != 3 or A.ndim != 2:
        raise ValueError(f"mamba_scan_cuda takes x (Bb, S, di) and A "
                         f"(di, N), got {tuple(x.shape)} and "
                         f"{tuple(A.shape)}")
    Bb, S, di = x.shape
    N = A.shape[1]
    if N not in STATE_SIZES:
        raise ValueError(f"mamba_scan_cuda takes N in {STATE_SIZES}, got {N}")
    if not (1 <= Bb <= 65535 and 1 <= S < 2 ** 31 and 1 <= di < 2 ** 31):
        raise ValueError(f"mamba_scan_cuda takes Bb in [1, 65535] and S, di "
                         f"in [1, 2^31), got {tuple(x.shape)}")
    f32 = torch.float32
    check_tensor(x, "x", (Bb, S, di), f32, dev)
    check_tensor(dt, "dt", (Bb, S, di), f32, dev)
    check_tensor(B, "B", (Bb, S, N), f32, dev)
    check_tensor(C, "C", (Bb, S, N), f32, dev)
    check_tensor(A, "A", (di, N), f32, dev)
    lib = load("mamba_scan", {"mamba_scan_f32": _ARGTYPES})
    y = torch.empty((Bb, S, di), dtype=f32, device=dev)
    h = torch.empty((Bb, di, N), dtype=f32, device=dev)
    launch(lib.mamba_scan_f32, (x, dt, B, C, A, y, h), (Bb, S, di, N), dev,
           "mamba_scan")
    return y, h
