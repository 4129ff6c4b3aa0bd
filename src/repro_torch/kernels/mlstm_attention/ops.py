"""Stabilized causal mLSTM sequence mix: dispatch and the plain torch
version.

The counterpart of src/repro/kernels/mlstm_attention/{ops,ref}.py.  A CUDA
tensor goes through the hand-written kernel (``kernel.py``), a CPU tensor
through ``mlstm_attention_torch``, the reference oracle's materialised form
(``mlstm_attention_ref``) in float32.  The two differ in the order of the
float32 sums (the kernel accumulates key tile by key tile: under an online
stabilizer on its ``simt`` route, with the exact stabilizer and P in three
bf16 terms on its ``wgmma`` route), so they agree within a stated
tolerance, not bitwise.

``mlstm_attention`` is differentiable (``_MLSTMAttention``).  The
reference differentiates its jnp form with ``jax.grad`` and its Pallas
kernel has no backward, so the backward here is new:
``mlstm_attention_backward_torch`` for a CPU tensor and the
``mlstm_attention_backward`` kernel for a CUDA tensor.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import device_kind


def mlstm_attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          F: torch.Tensor, I: torch.Tensor) -> torch.Tensor:
    """Plain version, the kernel's layout.  q, k, v: (BH, S, hd) (k
    pre-scaled by hd**-0.5); F: (BH, S) inclusive cumulative log-forget;
    I: (BH, S) log input gate.  With ``D_ts = F_t - F_s + I_s`` masked to
    s <= t and ``m_t = max(max_s D_ts, -1e30)``::

        h_t = sum_s exp(D_ts - m_t) (q_t . k_s) v_s
              / max(|sum_s exp(D_ts - m_t) (q_t . k_s)|, exp(-m_t))

    in float32 (in float64 for float64 inputs: the exact value that the
    tests hold the kernels' arithmetic to), rounded once to q's dtype.
    Returns (BH, S, hd)."""
    S = q.shape[1]
    acc = torch.promote_types(q.dtype, torch.float32)
    D = (F[:, :, None] - F[:, None, :] + I[:, None, :]).to(acc)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    D = D.masked_fill(~mask, float("-inf"))
    m = D.amax(dim=-1, keepdim=True).clamp(min=-1e30)
    W = torch.exp(D - m)
    scores = torch.bmm(q.to(acc), k.to(acc).transpose(1, 2)) * W
    num = torch.bmm(scores, v.to(acc))
    den = torch.maximum(scores.sum(-1).abs(), torch.exp(-m[..., 0]))
    return (num / den[..., None]).to(q.dtype)


#: query rows per chunk of the plain backward: the reference's own chunking
#: of its jnp mLSTM (``mlstm_forward``'s ``q_chunk``)
BACKWARD_CHUNK = 1024


def mlstm_attention_backward_torch(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, F: torch.Tensor,
                                   I: torch.Tensor, dh: torch.Tensor):
    """Plain backward of ``mlstm_attention_torch`` for the output gradient
    dh, the kernel's layout: q, k, v, dh (BH, S, hd); F, I (BH, S).
    Returns (dq, dk, dv) in their inputs' dtypes and (dF, dI) float32.

    Per chunk of BACKWARD_CHUNK query rows (keys past the chunk's last row
    are masked for every row of it, so they are left out), the forward is
    recomputed in float32 (float64 for float64 inputs): W_ts = exp(D_ts -
    m_t), S_ts = (q_t . k_s) W_ts, n_t = sum_s S_ts, den_t = max(|n_t|,
    exp(-m_t)).  Then, with e_ts = dh_t . v_s::

        dh_t . h_t = sum_s S_ts e_ts / den_t   (the exact output, not h
                                                 rounded to q's dtype)
        dn_t  = -sign(n_t) (dh_t . h_t) / den_t where |n_t| > exp(-m_t),
                else 0
        dS_ts = e_ts / den_t + dn_t
        dq_t = sum_s dS_ts W_ts k_s,  dk_s = sum_t dS_ts W_ts q_t,
        dv_s = sum_t S_ts dh_t / den_t
        dD_ts = dS_ts S_ts: dF_t += sum_s dD_ts, dF_s -= sum_t dD_ts,
                            dI_s = sum_t dD_ts

    The stabilizer m_t is held constant: h_t does not depend on it (in
    either branch of den its factor exp(-m_t) cancels), so its exact
    gradient is 0.  ``jax.grad`` of the reference does differentiate
    through the max, and its terms there cancel to rounding."""
    BH, S, hd = q.shape
    acc = torch.promote_types(q.dtype, torch.float32)
    qf, kf, vf, dhf = (t.to(acc) for t in (q, k, v, dh))
    Ff, If = F.to(acc), I.to(acc)
    dq = torch.empty((BH, S, hd), dtype=acc, device=q.device)
    dk = torch.zeros((BH, S, hd), dtype=acc, device=q.device)
    dv = torch.zeros_like(dk)
    dF = torch.zeros((BH, S), dtype=acc, device=q.device)
    dI = torch.zeros_like(dF)
    for c0 in range(0, S, BACKWARD_CHUNK):
        c1 = min(S, c0 + BACKWARD_CHUNK)
        D = (Ff[:, c0:c1, None] - Ff[:, None, :c1]) + If[:, None, :c1]
        rows = torch.arange(c0, c1, device=q.device)[:, None]
        D = D.masked_fill(rows < torch.arange(c1, device=q.device),
                          float("-inf"))
        m = D.amax(dim=-1, keepdim=True).clamp(min=-1e30)
        W = torch.exp(D - m)
        Sc = torch.bmm(qf[:, c0:c1], kf[:, :c1].transpose(1, 2)) * W
        e = torch.bmm(dhf[:, c0:c1], vf[:, :c1].transpose(1, 2))
        n = Sc.sum(-1)
        floor = torch.exp(-m[..., 0])
        den = torch.maximum(n.abs(), floor)
        dhh = (Sc * e).sum(-1) / den
        dn = torch.where(n.abs() > floor, -torch.sign(n) * dhh / den,
                         torch.zeros_like(n))
        dS = e / den[..., None] + dn[..., None]
        G = dS * W
        dq[:, c0:c1] = torch.bmm(G, kf[:, :c1])
        dk[:, :c1] += torch.bmm(G.transpose(1, 2), qf[:, c0:c1])
        dv[:, :c1] += torch.bmm((Sc / den[..., None]).transpose(1, 2),
                                dhf[:, c0:c1])
        dD = dS * Sc
        dF[:, c0:c1] += dD.sum(-1)
        col = dD.sum(-2)
        dF[:, :c1] -= col
        dI[:, :c1] += col
    fdt = torch.promote_types(F.dtype, torch.float32)
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dF.to(fdt),
            dI.to(fdt))


def to_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, ...) -> (B * H, S, ...), the kernel's layout."""
    B, S, H = x.shape[:3]
    return x.transpose(1, 2).reshape(B * H, S, *x.shape[3:])


def from_heads(x: torch.Tensor, B: int) -> torch.Tensor:
    """(B * H, S, ...) -> (B, S, H, ...), the model's layout."""
    BH, S = x.shape[:2]
    return x.reshape(B, BH // B, S, *x.shape[2:]).transpose(1, 2)


def mlstm_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          F: torch.Tensor, I: torch.Tensor) -> torch.Tensor:
    """``mlstm_attention_torch`` in the model's layout: q, k, v (B, S, H,
    hd), F and I (B, S, H) -> (B, S, H, hd)."""
    h = mlstm_attention_torch(*(to_heads(t) for t in (q, k, v, F, I)))
    return from_heads(h, q.shape[0])


def _forward(q, k, v, F, I):
    if device_kind(q, "mlstm_attention") == "cpu":
        return mlstm_attention_plain(q, k, v, F, I)
    from repro_torch.kernels.mlstm_attention.kernel import (
        mlstm_attention_cuda,
    )
    return mlstm_attention_cuda(*(t.contiguous() for t in (q, k, v, F, I)))


def mlstm_attention_backward_plain(q, k, v, F, I, dh):
    """``mlstm_attention_backward_torch`` in the model's layout: q, k, v,
    dh (B, S, H, hd), F and I (B, S, H) -> (dq, dk, dv, dF, dI) in the
    same layouts."""
    grads = mlstm_attention_backward_torch(
        *(to_heads(t) for t in (q, k, v, F, I, dh)))
    return tuple(from_heads(g, q.shape[0]) for g in grads)


def mlstm_attention_backward(q, k, v, F, I, dh):
    """(dq, dk, dv, dF, dI) of the mix in the model's layout (q, k, v, dh
    (B, S, H, hd); F, I (B, S, H)), dispatched on q's device: the plain
    backward for a CPU tensor, the ``mlstm_attention_backward`` kernel
    (bf16 or float32 q, k, v, dh with float32 F and I) for a CUDA
    tensor."""
    if device_kind(q, "mlstm_attention_backward") == "cpu":
        return mlstm_attention_backward_plain(q, k, v, F, I, dh)
    from repro_torch.kernels.mlstm_attention.kernel import (
        mlstm_attention_backward_cuda,
    )
    return mlstm_attention_backward_cuda(
        *(t.contiguous() for t in (q, k, v, F, I, dh)))


class _MLSTMAttention(torch.autograd.Function):
    """Forward through the ``mlstm_attention`` kernel (CUDA tensor) or the
    plain version (CPU tensor); backward through
    ``mlstm_attention_backward``, which recomputes the scores from the
    saved inputs."""

    @staticmethod
    def forward(ctx, q, k, v, F, I):
        ctx.save_for_backward(q, k, v, F, I)
        return _forward(q, k, v, F, I)

    @staticmethod
    def backward(ctx, dh):
        return mlstm_attention_backward(*ctx.saved_tensors, dh)


def mlstm_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    F: torch.Tensor, I: torch.Tensor) -> torch.Tensor:
    """The mLSTM mix in the model's layout, as the reference's
    ``ops.mlstm_attention``: q, k, v (B, S, H, hd) (k pre-scaled by
    hd**-0.5), F (inclusive cumulative log-forget) and I (log input gate)
    (B, S, H) -> (B, S, H, hd) in q's dtype.  Dispatched on q's device:
    the plain torch version for a CPU tensor, the CUDA kernel for a CUDA
    tensor (bf16 or float32 q, k, v with float32 F and I; another dtype
    raises).  Differentiable in all five inputs, its backward dispatched
    the same way."""
    return _MLSTMAttention.apply(q, k, v, F, I)
