"""Basic neural-net layers: RMSNorm, linear init, RoPE, SwiGLU MLP,
embeddings.  The counterpart of src/repro/models/layers.py.

Parameters are created in ``cfg.param_dtype`` (float32 masters) from an
explicit ``torch.Generator``; ``lm.cast_params_for_compute`` casts them to
``cfg.dtype`` (bf16) once, when a server is built, and training casts its
stacked leaves once per step (``lm.cast_leaves``).  The normalisations,
RoPE and the logits run in float32 as in the reference.  Every function
here is differentiable.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.sharded import any_dtensor, on_mesh
from repro_torch.models.partitioning import fsdp_gather


def param(t: torch.Tensor) -> nn.Parameter:
    """A weight of the serving path's modules: no gradient (training runs
    the same functions on the train state's leaves, ``lm.forward``)."""
    return nn.Parameter(t, requires_grad=False)


def truncated_normal(gen: torch.Generator, shape, scale: float,
                     dtype) -> torch.Tensor:
    """A normal truncated to [-2, 2] by the inverse CDF, times ``scale``,
    on the generator's device; computed in place, so that a large weight
    (a (16, 4096, 14336) expert stack) needs no temporaries."""
    lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, \
        (1 + math.erf(2 / math.sqrt(2))) / 2
    x = torch.rand(shape, generator=gen, device=gen.device)
    x.mul_(hi - lo).add_(lo).mul_(2).sub_(1).erfinv_().mul_(math.sqrt(2))
    return x.clamp_(-2.0, 2.0).mul_(scale).to(dtype)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype,
               scale: float | None = None) -> torch.Tensor:
    """Truncated-normal (to [-2, 2]) fan-in init, on the generator's
    device."""
    if scale is None:
        scale = in_dim ** -0.5
    return truncated_normal(gen, (in_dim, out_dim), scale, dtype)


def leaves(module: nn.Module) -> dict:
    """A module's weights under the reference's leaf names: its own
    parameters, and each child module's leaves nested under its name."""
    out = dict(module._parameters)
    for name, child in module.named_children():
        out[name] = leaves(child)
    return out


def zeros(n: int, dtype, device) -> nn.Parameter:
    return param(torch.zeros((n,), dtype=dtype, device=device))


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim in float32, scaled by ``1 + scale``."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dtype)


#: RMSNorm over the last (head) dim of a (..., heads, head_dim) tensor
head_rms_norm = rms_norm


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    """``1 / theta ** (2i / head_dim)`` in float32, made on ``device``
    (theta is a kernel argument: a tensor of it would be a host-to-device
    copy, which waits for the stream)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) int32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs      # (..., seq, hd/2)
    sin = torch.sin(angles)[..., None, :]               # over heads
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------
def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for activations x (..., k) and a weight w (k, n).  On
    DTensors the product runs on every device's block
    (``kernels.sharded.on_mesh``): w is gathered over every mesh dim but
    the rules' tensor-parallel axis (FSDP's weight gather: the "data"
    axis, and every axis under ``dp_only``), the output dim keeps w's
    tensor-parallel split (column-parallel; a sequence split over that
    mesh dim is gathered, as in sequence parallelism), x's leading dims
    keep theirs on the other mesh dims, and a contraction dim that both
    split over a mesh dim left stays split, the output a pending sum over
    it (row-parallel); otherwise it is gathered.  So DTensor's own search
    over the strategies of a product of two split dims is never run.
    Plain tensors: ``x @ w`` itself."""
    if not any_dtensor(x, w):
        return x @ w
    w = fsdp_gather(w)
    lead = "abcdefgh"[:x.ndim - 1]
    return on_mesh(lambda ww, xx: xx @ ww, (w, x), ("kn", lead + "k"),
                   lead + "n", free=lead + "n", summed="k")


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``F.logsigmoid(x)``; on a DTensor, elementwise on every device's
    block (``kernels.sharded.on_mesh``): DTensor has no strategy for its
    backward."""
    if not any_dtensor(x):
        return F.logsigmoid(x)
    lay = "abcdefgh"[:x.ndim]
    return on_mesh(F.logsigmoid, (x,), (lay,), lay, free=lay)


def apply_mlp(p, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: ``(silu(x @ gate) * (x @ up)) @ down`` in x's dtype; ``p``
    maps "gate", "up", "down" to (in, out) weights, as in the reference,
    so ``x @ w``."""
    dt = x.dtype
    gate = matmul(x, p["gate"].to(dt))
    up = matmul(x, p["up"].to(dt))
    return matmul(F.silu(gate) * up, p["down"].to(dt))


class MLP(nn.Module):
    """The SwiGLU MLP's weights, applied by ``apply_mlp``."""

    def __init__(self, gen: torch.Generator, d_model: int, d_ff: int, dtype):
        super().__init__()
        self.gate = param(dense_init(gen, d_model, d_ff, dtype))
        self.up = param(dense_init(gen, d_model, d_ff, dtype))
        self.down = param(dense_init(gen, d_ff, d_model, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_mlp(self._parameters, x)


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------
def init_embedding(gen: torch.Generator, vocab: int, d_model: int,
                   dtype) -> torch.Tensor:
    return (torch.randn((vocab, d_model), generator=gen, device=gen.device)
            * 0.02).to(dtype)


def embed(table: torch.Tensor, tokens: torch.Tensor,
          compute_dtype) -> torch.Tensor:
    """``table[tokens]`` in ``compute_dtype``.  On DTensors the lookup
    runs on every device's block (``kernels.sharded.on_mesh``): the
    tokens keep their batch and sequence sharding, the table is gathered
    whole (the reference's partitioner replicates it for the gather too),
    so its gradient is a local scatter-add."""
    if any_dtensor(table, tokens):
        return on_mesh(lambda tk, tb: tb[tk], (tokens, table),
                       ("bs", "vd"), "bsd", free="bs").to(compute_dtype)
    return table[tokens].to(compute_dtype)


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Logits in float32 for a numerically stable loss, with TF32 off for
    the product (set explicitly: a float32 product on the card must stay
    float32 here)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return matmul(x.float(), table.float().T)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
