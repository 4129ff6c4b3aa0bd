"""Mamba-1 selective scan: dispatch, the plain torch versions and the
gradient.

The counterpart of src/repro/kernels/mamba_scan/{ops,ref}.py.  A CUDA
tensor goes through the hand-written kernels (``kernel.py``), a CPU tensor
through ``mamba_scan_torch``, the reference oracle's sequential recurrence
(``mamba_scan_ref``) in float32.  The two differ only in the order of the
sums over N and in the FMAs that nvcc contracts, so they agree within a
stated tolerance, not bitwise.

``mamba_scan`` is differentiable (``_MambaScan``).  The reference
differentiates its jnp scan with ``jax.grad`` and its Pallas kernel has no
backward, so the backward here is new: ``mamba_scan_backward_torch``, the
reverse-time recurrence in float32, for a CPU tensor, and the
``mamba_scan_backward_f32`` kernel for a CUDA tensor.
"""
from __future__ import annotations

from typing import Optional

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


def mamba_scan_backward_torch(x: torch.Tensor, dt: torch.Tensor,
                              B: torch.Tensor, C: torch.Tensor,
                              A: torch.Tensor, dy: torch.Tensor,
                              dh_final: Optional[torch.Tensor] = None):
    """Plain backward of ``mamba_scan_torch`` for the output gradients dy
    (Bb, S, di) and dh_final (Bb, di, N) (None: zero), in float32.  With
    a_t = exp(dt_t A), the states h_t are recomputed forward and kept,
    then the state gradient g_t = dy_t C_t + a_{t+1} g_{t+1} (from g =
    dh_final) runs back in time; the loops carry only the two
    recurrences, and every gradient is taken from the kept h and g at
    once::

        dC_t[n] = sum_d dy_t[d] h_t[d, n]
        dB_t[n] = sum_d g_t[d, n] dt_t[d] x_t[d]
        dx_t[d] = sum_n g_t[d, n] dt_t[d] B_t[n]
        ddt_t[d] = sum_n g_t[d, n] (h_{t-1}[d, n] a_t[d, n] A[d, n]
                                    + x_t[d] B_t[n])
        dA[d, n] = sum_{b, t} g_t[d, n] h_{t-1}[d, n] a_t[d, n] dt_t[d]

    Returns (dx, ddt, dB, dC, dA), each in its input's dtype."""
    Bb, S, di = x.shape
    xf, dtf, Bf, Cf, dyf = (t.float() for t in (x, dt, B, C, dy))
    Af = A.float()
    a = torch.exp(dtf[..., None] * Af)                 # (Bb, S, di, N)
    bx = (dtf * xf)[..., None] * Bf[:, :, None, :]
    h = torch.zeros_like(a[:, 0])
    hs = []                          # h_{t-1} for t = 0 .. S - 1
    for t in range(S):
        hs.append(h)
        h = a[:, t] * h + bx[:, t]
    g = (torch.zeros_like(h) if dh_final is None else dh_final.float())
    gs = [None] * S
    dyC = dyf[..., None] * Cf[:, :, None, :]
    for t in range(S - 1, -1, -1):
        g = dyC[:, t] + g
        gs[t] = g
        g = a[:, t] * g
    del dyC, bx
    G, h_prev = torch.stack(gs, dim=1), torch.stack(hs, dim=1)
    del gs, hs
    h_cur = torch.cat([h_prev[:, 1:], h[:, None]], dim=1)
    dC = torch.einsum("bsd,bsdn->bsn", dyf, h_cur)
    del h_cur
    dB = torch.einsum("bsdn,bsd->bsn", G, dtf * xf)
    gB = torch.einsum("bsdn,bsn->bsd", G, Bf)
    gha = G * h_prev * a
    del G, h_prev, a
    ddt = (gha * Af).sum(-1) + gB * xf
    dA = (gha * dtf[..., None]).sum((0, 1))
    return ((gB * dtf).to(x.dtype), ddt.to(dt.dtype), dB.to(B.dtype),
            dC.to(C.dtype), dA.to(A.dtype))


def _forward(x, dt, B, C, A):
    if device_kind(x, "mamba_scan") == "cpu":
        return mamba_scan_torch(x, dt, B, C, A)
    from repro_torch.kernels.mamba_scan.kernel import mamba_scan_cuda
    return mamba_scan_cuda(*(t.contiguous() for t in (x, dt, B, C, A)))


def mamba_scan_backward(x, dt, B, C, A, dy, dh_final=None):
    """(dx, ddt, dB, dC, dA), dispatched on x's device: the plain backward
    for a CPU tensor, the ``mamba_scan_backward_f32`` kernel (float32
    only; another dtype raises) for a CUDA tensor."""
    if device_kind(x, "mamba_scan_backward") == "cpu":
        return mamba_scan_backward_torch(x, dt, B, C, A, dy, dh_final)
    from repro_torch.kernels.mamba_scan.kernel import (
        mamba_scan_backward_cuda,
    )
    return mamba_scan_backward_cuda(
        *(t.contiguous() for t in (x, dt, B, C, A, dy)),
        None if dh_final is None else dh_final.contiguous())


class _MambaScan(torch.autograd.Function):
    """Forward through the ``mamba_scan`` kernel (CUDA tensor) or the plain
    version (CPU tensor); backward through ``mamba_scan_backward``, which
    recomputes the states from the saved inputs.  An output whose gradient
    is not needed (training never uses h_final) reaches the backward as
    None."""

    @staticmethod
    def forward(ctx, x, dt, B, C, A):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, B, C, A)
        return _forward(x, dt, B, C, A)

    @staticmethod
    def backward(ctx, dy, dh_final):
        x, dt, B, C, A = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        return mamba_scan_backward(x, dt, B, C, A, dy, dh_final)


def mamba_scan(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
               C: torch.Tensor, A: torch.Tensor):
    """Selective scan, x/dt (Bb, S, di), B/C (Bb, S, N), A (di, N) ->
    (y (Bb, S, di), h_final (Bb, di, N)), dispatched on x's device: the
    plain torch version for a CPU tensor, the CUDA kernel (float32 only;
    another dtype raises) for a CUDA tensor.  Differentiable in all five
    inputs, its backward dispatched the same way."""
    return _MambaScan.apply(x, dt, B, C, A)
