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


def mlstm_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    F: torch.Tensor, I: torch.Tensor) -> torch.Tensor:
    """The mLSTM mix in the model's layout, as the reference's
    ``ops.mlstm_attention``: q, k, v (B, S, H, hd) (k pre-scaled by
    hd**-0.5), F (inclusive cumulative log-forget) and I (log input gate)
    (B, S, H) -> (B, S, H, hd) in q's dtype.  Dispatched on q's device:
    the plain torch version for a CPU tensor, the CUDA kernel for a CUDA
    tensor (bf16 or float32 q, k, v with float32 F and I; another dtype
    raises)."""
    if device_kind(q, "mlstm_attention") == "cpu":
        return mlstm_attention_plain(q, k, v, F, I)
    from repro_torch.kernels.mlstm_attention.kernel import (
        mlstm_attention_cuda,
    )
    return mlstm_attention_cuda(*(t.contiguous() for t in (q, k, v, F, I)))
