"""Mamba-1 selective scan: dispatch and the plain torch version.

The counterpart of src/repro/kernels/mamba_scan/{ops,ref}.py.  A CUDA
tensor goes through the hand-written kernel (``kernel.py``), a CPU tensor
through ``mamba_scan_torch``, the reference oracle's sequential recurrence
(``mamba_scan_ref``) in float32.  The two differ only in the order of the
sums over N and in the FMAs that nvcc contracts, so they agree within a
stated tolerance, not bitwise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import device_kind


def mamba_scan_torch(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                     C: torch.Tensor, A: torch.Tensor):
    """Plain version.  x, dt: (Bb, S, di); B, C: (Bb, S, N); A: (di, N)
    (A < 0).  From h = 0: ``h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t``,
    ``y_t = h_t . C_t``, in float32.  Returns (y (Bb, S, di) in x's
    dtype, h_final (Bb, di, N) float32)."""
    Bb, S, di = x.shape
    xf, dtf, Bf, Cf = (t.float() for t in (x, dt, B, C))
    Af = A.float()
    h = torch.zeros((Bb, di, A.shape[1]), dtype=torch.float32,
                    device=x.device)
    y = torch.empty((Bb, S, di), dtype=torch.float32, device=x.device)
    for t in range(S):
        dA = torch.exp(dtf[:, t, :, None] * Af)
        dBx = (dtf[:, t] * xf[:, t])[:, :, None] * Bf[:, t, None, :]
        h = dA * h + dBx
        y[:, t] = torch.einsum("bdn,bn->bd", h, Cf[:, t])
    return y.to(x.dtype), h


def mamba_scan(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
               C: torch.Tensor, A: torch.Tensor):
    """Selective scan, x/dt (Bb, S, di), B/C (Bb, S, N), A (di, N) ->
    (y (Bb, S, di), h_final (Bb, di, N)), dispatched on x's device: the
    plain torch version for a CPU tensor, the CUDA kernel (float32 only;
    another dtype raises) for a CUDA tensor."""
    if device_kind(x, "mamba_scan") == "cpu":
        return mamba_scan_torch(x, dt, B, C, A)
    from repro_torch.kernels.mamba_scan.kernel import mamba_scan_cuda
    return mamba_scan_cuda(*(t.contiguous() for t in (x, dt, B, C, A)))
