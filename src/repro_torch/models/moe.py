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

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import sharded
from repro_torch.models import layers
from repro_torch.models.partitioning import constrain, settle

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


def _moe_groups(p, x: torch.Tensor, cfg, capacity: int, e0: int = 0):
    """x: (G, T, d), each row one routing group; ``p``'s expert weights are
    experts ``[e0, e0 + E_loc)`` (all of them in one process; a device's
    block on a mesh).  Returns (y (G, T, d) float32, the sum over each
    token's choices of its LOCAL experts' weighted outputs, the load-
    balance aux loss of each group (G,)).  The pairs of other experts, and
    the pairs past an expert's capacity, are sent to a dump row of the
    expert batch that nothing reads, so no tensor's size depends on the
    routing."""
    G, T, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_tok
    E_loc = p["gate"].shape[0]
    cd = x.dtype
    probs, w, idx = _route(p, x, cfg)
    pos = _positions_in_expert(idx, E)
    keep = (pos < capacity) & (idx >= e0) & (idx < e0 + E_loc)
    group = torch.arange(G, device=x.device)[:, None, None]
    rows = E_loc * G * capacity
    slot = ((idx - e0) * G + group) * capacity + pos  # row of the expert batch
    dest = torch.where(keep, slot, rows)            # capacity drop, no retry
    xe = x.new_zeros((rows + 1, d))
    xe.index_copy_(0, dest.reshape(-1),
                   x[:, :, None].expand(G, T, k, d).reshape(-1, d))
    xe = xe[:rows].view(E_loc, G * capacity, d)
    h = F.silu(torch.bmm(xe, p["gate"].to(cd))) * torch.bmm(xe, p["up"].to(cd))
    ye = torch.bmm(h, p["down"].to(cd)).view(rows, d)
    comb = (w.to(cd) * keep).float()               # weight in cd, as ref
    picked = ye[torch.where(keep, slot, 0)].float()  # (G, T, k, d)
    y = (comb[..., None] * picked).sum(-2)
    # the reference sums a one-hot in the compute dtype, so a count above
    # 256 is rounded in bf16 (513 -> 512), and divides in that dtype
    ce = F.one_hot(idx, E).sum(dim=(1, 2)).to(cd) / (T * k)   # (G, E)
    return y, E * (probs.mean(dim=1) * ce).sum(-1)


def _moe_dense_decode(p, x: torch.Tensor, cfg, e0: int = 0):
    """x: (B, S, d), the single-token path: every expert on every token,
    mixed by the renormalised top-k weights (zero elsewhere); nothing is
    dropped.  Each product is batched over E on the stored (E, d, ff)
    weights, which are read once and never copied.  ``p``'s experts are
    ``[e0, e0 + E_loc)``; returns their part of y (B, S, d), float32."""
    B, S, d = x.shape
    E_loc = p["gate"].shape[0]
    cd = x.dtype
    probs, w, idx = _route(p, x, cfg)
    wfull = torch.zeros_like(probs).scatter_(-1, idx, w).to(cd)
    xt = x.reshape(1, B * S, d)
    gate = torch.matmul(xt, p["gate"].to(cd))            # (E, B S, ff)
    up = torch.matmul(xt, p["up"].to(cd))
    ye = torch.matmul(F.silu(gate) * up, p["down"].to(cd))  # (E, B S, d)
    wt = wfull.reshape(B * S, -1)[:, e0:e0 + E_loc].T.float()[..., None]
    return (wt * ye.float()).sum(0).reshape(B, S, d)


def _routed_on_mesh(fn, p, x: torch.Tensor, cfg, with_aux: bool):
    """``fn(p, x, cfg, e0)`` (``_moe_groups`` or ``_moe_dense_decode``)
    on every device's block of DTensors, the reference's expert
    parallelism: the groups (batch rows) keep their dp sharding and the
    experts their tp sharding, every other dim (tokens within a group, d,
    ff, the router) is replicated first; each device routes its tokens
    over every expert and computes its own experts' pairs, and the
    outputs' sum over the experts' mesh dims is a pending reduction
    (``Partial``) that the caller settles.  With ``with_aux``, ``fn``'s
    second output (the per-group aux) is laid out as y.  An input's
    gradient is a pending sum over the mesh dims that split what it
    lacks (``sharded.grad_placements_of``)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    w = {n: p[n] for n in ("gate", "up", "down")}
    mesh, chosen = sharded.plan((x, w["gate"], w["up"], w["down"]),
                                ("gtd", "edf", "edf", "efd"), free="ge")
    n = mesh.ndim
    x_pl = sharded.placements_of("gtd", chosen, n)
    w_pl = {k: sharded.placements_of(lay, chosen, n)
            for k, lay in (("gate", "edf"), ("up", "edf"), ("down", "efd"))}
    rep = tuple(Replicate() for _ in range(n))
    x = sharded.settle_grad(sharded.redistribute(
        sharded.as_dtensor(x, mesh), x_pl))
    w = {k: sharded.settle_grad(sharded.redistribute(
        sharded.as_dtensor(v, mesh), w_pl[k])) for k, v in w.items()}
    router = sharded.settle_grad(sharded.redistribute(
        sharded.as_dtensor(p["router"], mesh), rep))
    e0 = sharded.local_offset(w["gate"], 0)
    y_pl = [Shard(0) if chosen.get(m) == "g" else
            Partial() if chosen.get(m) == "e" else Replicate()
            for m in range(n)]

    # the routing (and so the aux loss) is computed alike on every device
    # of the experts' mesh dims: each reports its share of the aux as a
    # pending sum, so that its gradient is counted once
    e_ways = math.prod(mesh.size(m) for m in range(n)
                       if chosen.get(m) == "e")

    def local(xl, rl, gl, ul, dl):
        out = fn({"router": rl, "gate": gl, "up": ul, "down": dl}, xl, cfg,
                 e0)
        return (out[0], out[1] / e_ways) if with_aux else out

    outs = (y_pl, y_pl) if with_aux else y_pl
    # the router is passed whole: its layout names no sharded letter
    grads = [list(sharded.grad_placements_of(lay, chosen, n))
             for lay in ("gtd", "..", "edf", "edf", "efd")]
    return local_map(local, out_placements=outs,
                     in_placements=(list(x_pl), list(rep),
                                    list(w_pl["gate"]), list(w_pl["up"]),
                                    list(w_pl["down"])),
                     in_grad_placements=tuple(grads),
                     device_mesh=mesh)(x, router, w["gate"], w["up"],
                                       w["down"])


def apply_moe(p, x: torch.Tensor, cfg, capacity_factor: float = 1.25):
    """x: (B, S, d) -> (y, aux loss).  Routing groups = batch rows; S == 1
    runs every expert densely.  ``p``: the reference's leaf dict (router,
    gate, up, down[, shared]).  DTensors run with the experts over the
    mesh (``_routed_on_mesh``), the reference's constraints pinning the
    expert batch and the output."""
    B, S, d = x.shape
    cd = x.dtype
    mesh = sharded.any_dtensor(x, p["gate"])
    if S == 1:
        y = (_routed_on_mesh(_moe_dense_decode, p, x, cfg, False) if mesh
             else _moe_dense_decode(p, x, cfg))
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        capacity = int(max(1, round(
            S * cfg.experts_per_tok / cfg.num_experts * capacity_factor)))
        def groups(p, x, cfg, e0=0):
            return _moe_groups(p, x, cfg, capacity, e0)

        y, aux = (_routed_on_mesh(groups, p, x, cfg, True) if mesh
                  else groups(p, x, cfg))
        aux = aux.mean()
    y = constrain(settle(y).to(cd), "dp", None, None)
    if cfg.num_shared_experts > 0:
        y = y + layers.apply_mlp(p["shared"], x)
    return y, aux * ROUTER_AUX_WEIGHT
