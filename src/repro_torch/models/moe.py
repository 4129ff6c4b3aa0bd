"""Mixture-of-experts FFN: top-k routing with capacity, shared experts.
The counterpart of src/repro/models/moe.py.

Routing is the reference's: float32 router logits, softmax, the top k
experts by probability (descending, ties to the lower index, as
``lax.top_k``), weights renormalised.  Over a whole sequence (prefill)
each batch row is one routing group: the (token, choice) pairs are ranked
within their expert by a stable sort, and the pairs ranked at or beyond
``capacity = round(S k / E * capacity_factor)`` are dropped (their
residual carries them), as in the reference.  Where the reference
dispatches and combines through one-hot einsums, the port scatters the
kept tokens into an (E, groups * capacity, d) expert batch and gathers
each pair's expert output back: the same function, since every slot holds
at most one token, with the same rounding points (the expert products in
the compute dtype, the weighted sum of a token's experts in float32,
rounded once).  A single token (decode) runs every expert densely and
drops nothing, so prefill and decode are different functions wherever
prefill drops a pair (ROADMAP Queue 3).  The expert weights stay in their
stored (E, d, ff) layout: every product is batched over E.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers

ROUTER_AUX_WEIGHT = 0.01


class MoE(nn.Module):
    """The weights of one MoE FFN under the reference's leaf names:
    ``router`` (d, E) float32, ``gate`` / ``up`` (E, d, ff), ``down``
    (E, ff, d), and ``shared`` (a SwiGLU MLP) where the config has shared
    experts; applied by ``apply_moe``."""

    def __init__(self, gen: torch.Generator, cfg, dtype):
        super().__init__()
        d, E, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
        scale = d ** -0.5
        self.router = layers.param(
            layers.dense_init(gen, d, E, torch.float32, scale))
        self.gate = layers.param(
            layers.truncated_normal(gen, (E, d, ff), scale, dtype))
        self.up = layers.param(
            layers.truncated_normal(gen, (E, d, ff), scale, dtype))
        self.down = layers.param(
            layers.truncated_normal(gen, (E, ff, d), ff ** -0.5, dtype))
        if cfg.num_shared_experts > 0:
            self.shared = layers.MLP(gen, d, ff * cfg.num_shared_experts,
                                     dtype)


def _route(p, x: torch.Tensor, cfg):
    """x: (..., d) -> (probs (..., E), weight (..., k), expert_idx (..., k)
    int64)."""
    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort keeps equal probabilities in index order
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_tok
    w, idx = w[..., :k], idx[..., :k]
    return probs, w / w.sum(-1, keepdim=True).clamp(min=1e-9), idx


def _positions_in_expert(expert_idx: torch.Tensor,
                         num_experts: int) -> torch.Tensor:
    """Rank of each (token, choice) pair within its expert, in (token,
    choice) order, via a stable sort over expert ids.  expert_idx:
    (..., T, k) over any leading group dims -> int32 of its shape."""
    *lead, T, k = expert_idx.shape
    flat = expert_idx.reshape(*lead, T * k).long()
    sorted_e, order = torch.sort(flat, dim=-1, stable=True)
    counts = torch.zeros((*lead, num_experts), dtype=torch.long,
                         device=flat.device)
    counts.scatter_add_(-1, flat, torch.ones_like(flat))
    starts = counts.cumsum(-1) - counts
    pos_sorted = (torch.arange(T * k, device=flat.device)
                  - starts.gather(-1, sorted_e))
    pos = torch.empty_like(flat).scatter_(-1, order, pos_sorted)
    return pos.reshape(expert_idx.shape).to(torch.int32)


def _moe_groups(p, x: torch.Tensor, cfg, capacity: int):
    """x: (G, T, d), each row one routing group.  Returns (y (G, T, d),
    the load-balance aux loss averaged over the groups)."""
    G, T, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_tok
    cd = x.dtype
    probs, w, idx = _route(p, x, cfg)
    pos = _positions_in_expert(idx, E)
    keep = pos < capacity                           # capacity drop, no retry
    group = torch.arange(G, device=x.device)[:, None, None]
    slot = (idx * G + group) * capacity + pos       # row of the expert batch
    xe = x.new_zeros((E * G * capacity, d))
    xe.index_copy_(0, slot[keep], x[:, :, None].expand(G, T, k, d)[keep])
    xe = xe.view(E, G * capacity, d)
    h = F.silu(torch.bmm(xe, p["gate"].to(cd))) * torch.bmm(xe, p["up"].to(cd))
    ye = torch.bmm(h, p["down"].to(cd)).view(E * G * capacity, d)
    comb = (w.to(cd) * keep).float()               # weight in cd, as ref
    picked = ye[torch.where(keep, slot, 0)].float()  # (G, T, k, d)
    y = (comb[..., None] * picked).sum(-2).to(cd)
    # the reference sums a one-hot in the compute dtype, so a count above
    # 256 is rounded in bf16 (513 -> 512), and divides in that dtype
    ce = F.one_hot(idx, E).sum(dim=(1, 2)).to(cd) / (T * k)   # (G, E)
    aux = (E * (probs.mean(dim=1) * ce).sum(-1)).mean()
    return y, aux


def _moe_dense_decode(p, x: torch.Tensor, cfg):
    """x: (B, S, d), the single-token path: every expert on every token,
    mixed by the renormalised top-k weights (zero elsewhere); nothing is
    dropped.  Each product is batched over E on the stored (E, d, ff)
    weights, which are read once and never copied."""
    B, S, d = x.shape
    E = cfg.num_experts
    cd = x.dtype
    probs, w, idx = _route(p, x, cfg)
    wfull = torch.zeros_like(probs).scatter_(-1, idx, w).to(cd)
    xt = x.reshape(1, B * S, d)
    gate = torch.matmul(xt, p["gate"].to(cd))            # (E, B S, ff)
    up = torch.matmul(xt, p["up"].to(cd))
    ye = torch.matmul(F.silu(gate) * up, p["down"].to(cd))  # (E, B S, d)
    wt = wfull.reshape(B * S, E).T.float()[..., None]     # (E, B S, 1)
    y = (wt * ye.float()).sum(0).to(cd)
    return y.reshape(B, S, d), torch.zeros((), dtype=torch.float32,
                                           device=x.device)


def apply_moe(p, x: torch.Tensor, cfg, capacity_factor: float = 1.25):
    """x: (B, S, d) -> (y, aux loss).  Routing groups = batch rows; S == 1
    runs every expert densely.  ``p``: the reference's leaf dict (router,
    gate, up, down[, shared])."""
    B, S, d = x.shape
    if S == 1:
        y, aux = _moe_dense_decode(p, x, cfg)
    else:
        capacity = int(max(1, round(
            S * cfg.experts_per_tok / cfg.num_experts * capacity_factor)))
        y, aux = _moe_groups(p, x, cfg, capacity)
    if cfg.num_shared_experts > 0:
        y = y + layers.apply_mlp(p["shared"], x)
    return y, aux * ROUTER_AUX_WEIGHT
