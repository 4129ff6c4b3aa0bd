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
``mamba_scan_backward_f32`` kernel for a CUDA tensor.  When it saves for
a backward, the forward also returns the states after every
``SAVED_EVERY`` steps (both versions), and the backward recomputes each
chunk from them instead of running the recurrence from the start.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.build import device_kind

#: steps between the states the forward saves for the backward: the CUDA
#: kernels' kBound / kL (``kernel.backward_geometry`` checks it)
SAVED_EVERY = 16


def _decay(dtf: torch.Tensor, Af: torch.Tensor, t: int) -> torch.Tensor:
    """a_t = exp(dt_t A), (Bb, di, N), computed one step at a time by both
    plain versions: torch's CPU exp takes a scalar path for the tail of a
    tensor and a vector path for the rest, which may differ in the last
    bit, so the same step must be the same tensor in both."""
    return torch.exp(dtf[:, t, :, None] * Af)


def mamba_scan_torch(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                     C: torch.Tensor, A: torch.Tensor, bounds: bool = False):
    """Plain version.  x, dt: (Bb, S, di); B, C: (Bb, S, N); A: (di, N)
    (A < 0).  From h = 0: ``h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t``,
    ``y_t = h_t . C_t``, in float32.  Returns (y (Bb, S, di) in x's
    dtype, h_final (Bb, di, N) float32), and with ``bounds`` also the
    states after every SAVED_EVERY steps but the last chunk's, (Bb,
    ceil(S / SAVED_EVERY) - 1, di, N) float32: the kernels' contract."""
    Bb, S, di = x.shape
    xf, dtf, Bf, Cf = (t.float() for t in (x, dt, B, C))
    Af = A.float()
    h = torch.zeros((Bb, di, A.shape[1]), dtype=torch.float32,
                    device=x.device)
    y = torch.empty((Bb, S, di), dtype=torch.float32, device=x.device)
    saved = []
    for t in range(S):
        dBx = (dtf[:, t] * xf[:, t])[:, :, None] * Bf[:, t, None, :]
        h = _decay(dtf, Af, t) * h + dBx
        y[:, t] = torch.einsum("bdn,bn->bd", h, Cf[:, t])
        if bounds and (t + 1) % SAVED_EVERY == 0 and t + 1 < S:
            saved.append(h)
    if not bounds:
        return y.to(x.dtype), h
    hb = torch.stack(saved, dim=1) if saved else h.new_zeros(
        (Bb, 0) + tuple(h.shape[1:]))
    return y.to(x.dtype), h, hb


def mamba_scan_backward_torch(x: torch.Tensor, dt: torch.Tensor,
                              B: torch.Tensor, C: torch.Tensor,
                              A: torch.Tensor, dy: torch.Tensor,
                              dh_final: Optional[torch.Tensor] = None,
                              hbound: Optional[torch.Tensor] = None):
    """Plain backward of ``mamba_scan_torch`` for the output gradients dy
    (Bb, S, di) and dh_final (Bb, di, N) (None: zero), in float32.  With
    a_t = exp(dt_t A), the states h_t are recomputed and kept, every chunk
    of SAVED_EVERY steps at once from its saved start: the forward's
    saved states ``hbound`` (``mamba_scan_torch(..., bounds=True)``; run
    here when None), the same operations on the same values as the
    forward's, so the same bits.  Then the state gradient g_t = dy_t C_t
    + a_{t+1} g_{t+1} (from g = dh_final) runs back in time; the loops
    carry only the two recurrences, and every gradient is taken from the
    kept h and g at once::

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
    a = torch.stack([_decay(dtf, Af, t) for t in range(S)], dim=1)
    bx = (dtf * xf)[..., None] * Bf[:, :, None, :]     # (Bb, S, di, N)
    if hbound is None:
        hbound = mamba_scan_torch(x, dt, B, C, A, bounds=True)[2]
    L, nC = SAVED_EVERY, -(-S // SAVED_EVERY)
    pad = (0, 0, 0, 0, 0, nC * L - S)

    def chunks(z):   # (Bb, S, di, N) -> (Bb, nC, L, di, N)
        return torch.nn.functional.pad(z, pad).view(Bb, nC, L, *z.shape[2:])
    ac, bc = chunks(a), chunks(bx)
    h = torch.cat([torch.zeros_like(a[:, :1]), hbound.float()], dim=1)
    hs = []                          # h_{t-1} for t = i, L + i, 2 L + i, ...
    for i in range(L):
        hs.append(h)
        h = ac[:, :, i] * h + bc[:, :, i]
    hs = list(torch.stack(hs, dim=2).view(Bb, nC * L, di, -1)[:, :S]
              .unbind(1))
    h = a[:, S - 1] * hs[-1] + bx[:, S - 1]
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


def _forward(x, dt, B, C, A, bounds=False):
    if device_kind(x, "mamba_scan") == "cpu":
        return mamba_scan_torch(x, dt, B, C, A, bounds=bounds)
    from repro_torch.kernels.mamba_scan.kernel import mamba_scan_cuda
    return mamba_scan_cuda(*(t.contiguous() for t in (x, dt, B, C, A)),
                           bounds=bounds)


def mamba_scan_backward(x, dt, B, C, A, dy, dh_final=None, hbound=None):
    """(dx, ddt, dB, dC, dA), dispatched on x's device: the plain backward
    for a CPU tensor, the ``mamba_scan_backward_f32`` kernel (float32
    only; another dtype raises) for a CUDA tensor.  ``hbound``: the
    forward's saved states, or None (then both run the forward for
    them)."""
    if device_kind(x, "mamba_scan_backward") == "cpu":
        return mamba_scan_backward_torch(x, dt, B, C, A, dy, dh_final,
                                         hbound)
    from repro_torch.kernels.mamba_scan.kernel import (
        mamba_scan_backward_cuda,
    )
    return mamba_scan_backward_cuda(
        *(t.contiguous() for t in (x, dt, B, C, A, dy)),
        None if dh_final is None else dh_final.contiguous(),
        None if hbound is None else hbound.contiguous())


class _MambaScan(torch.autograd.Function):
    """Forward through the ``mamba_scan`` kernel (CUDA tensor) or the plain
    version (CPU tensor), which also returns the states after every
    SAVED_EVERY steps when the call is for a backward (``bounds``);
    backward through ``mamba_scan_backward``, which recomputes each chunk
    from them.  An output whose gradient is not needed (training never
    uses h_final) reaches the backward as None."""

    @staticmethod
    def forward(ctx, x, dt, B, C, A, bounds):
        ctx.set_materialize_grads(False)
        if not bounds:
            ctx.save_for_backward(x, dt, B, C, A)
            return _forward(x, dt, B, C, A)
        y, h, hb = _forward(x, dt, B, C, A, bounds=True)
        ctx.save_for_backward(x, dt, B, C, A, hb)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh_final):
        x, dt, B, C, A, *hb = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        return (*mamba_scan_backward(x, dt, B, C, A, dy, dh_final,
                                     hb[0] if hb else None), None)


def mamba_scan(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
               C: torch.Tensor, A: torch.Tensor):
    """Selective scan, x/dt (Bb, S, di), B/C (Bb, S, N), A (di, N) ->
    (y (Bb, S, di), h_final (Bb, di, N)), dispatched on x's device: the
    plain torch version for a CPU tensor, the CUDA kernel (float32 only;
    another dtype raises) for a CUDA tensor.  Differentiable in all five
    inputs, its backward dispatched the same way; where autograd records
    the call (grad enabled, an input requiring grad), the forward also
    saves the states every SAVED_EVERY steps for it, and otherwise (the
    serving prefill) writes nothing more."""
    bounds = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, dt, B, C, A))
    return _MambaScan.apply(x, dt, B, C, A, bounds)
