"""Flash-decoding: dispatch of the whole function, the plain torch
versions of the per-chunk partials and of the whole function, and the
log-sum-exp combine.

The counterpart of src/repro/kernels/decode_attention/{ops,ref}.py, over
the model's KV cache layout: q is (B, KH, G, hd), the cache k, v is
(B, S, KH, hd); the reference's (BK, G, hd) / (BK, S, hd) layout is the
case KH = 1 (``q[:, None]``, ``k[:, :, None]``).  The cache is
preallocated, so only keys ``[0, kv_len)`` count: the partials are those
of the reference's Pallas kernel on ``k[:, :kv_len]``, with chunks of
``bc`` keys cut at ``kv_len`` (the last may be ragged), and a chunk wholly
past ``kv_len`` gives m = -inf, l = 0, acc = 0, which the combine weighs
by exp(-inf) = 0.  A CPU tensor takes the plain partials and the combine
(plain torch, as it is jnp in the reference); a CUDA tensor takes the
hand-written kernel (``kernel.py``), which computes both phases in one
launch over its own split of the keys (the chunk ``bc`` is the CPU's).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import device_kind


def decode_attention_partials_torch(q: torch.Tensor, k: torch.Tensor,
                                    v: torch.Tensor, *, kv_len: int,
                                    bc: int):
    """Plain version of the partials: acc (B*KH, G, nc, hd), m and l
    (B*KH, G, nc), float32, nc = ceil(S / bc).  The scores are computed
    one kv head at a time, each from that head's own contiguous slices,
    as the kernel computes each head in its own blocks: a host BLAS picks
    its blocking by the operands' shapes and strides, so a product over
    all KH heads at once need not round head h as the KH = 1 call does."""
    B, KH, G, hd = q.shape
    S = k.shape[1]
    nc = -(-S // bc)
    s = torch.stack([
        torch.bmm(q[:, h].float().contiguous(),
                  k[:, :kv_len, h].float().transpose(1, 2).contiguous())
        for h in range(KH)], dim=1) * hd ** -0.5
    s_all = s.new_full((B, KH, G, nc * bc), float("-inf"))
    s_all[..., :kv_len] = s
    s_all = s_all.reshape(B * KH, G, nc, bc)
    m = s_all.amax(dim=-1)
    m_use = torch.where(m == float("-inf"), torch.zeros_like(m), m)
    p = torch.exp(s_all - m_use[..., None])
    l = p.sum(dim=-1)
    v_all = v.new_zeros((B, nc * bc, KH, hd), dtype=torch.float32)
    v_all[:, :kv_len] = v[:, :kv_len].float()
    v_all = v_all.permute(0, 2, 1, 3).reshape(B * KH, nc, bc, hd)
    acc = torch.einsum("bgcs,bcsd->bgcd", p, v_all)
    return acc, m, l


def decode_attention_partials(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, kv_len: int, bc: int):
    """The partials of a CPU tensor (the plain version).  On the card the
    kernel computes the whole function in one launch and never hands out
    partials: a CUDA tensor raises (call ``decode_attention``)."""
    if device_kind(q, "decode_attention") == "cuda":
        raise ValueError("decode_attention_partials is the plain version for "
                         "CPU tensors: on the card the fused kernel computes "
                         "the whole function (decode_attention)")
    return decode_attention_partials_torch(q, k, v, kv_len=kv_len, bc=bc)


def combine_partials(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
    """Phase 2, the log-sum-exp combine of (acc, m, l) over the chunk axis:
    (BK, G, nc, hd) -> (BK, G, hd) in ``dtype``."""
    m_g = m.amax(dim=-1, keepdim=True)
    w = torch.exp(m - m_g)
    num = (acc * w[..., None]).sum(dim=2)
    den = (l * w).sum(dim=-1, keepdim=True)
    return (num / den.clamp_min(1e-30)).to(dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     *, kv_len: int | None = None, bc: int = 512
                     ) -> torch.Tensor:
    """Single-token attention over the first ``kv_len`` keys of a cache,
    dispatched on q's device: a CPU tensor takes the plain partials over
    chunks of ``bc`` keys and the combine, a CUDA tensor the fused kernel
    (one launch; its split plan replaces ``bc``).

    q: (B, KH, G, hd); k, v: (B, S, KH, hd).  Returns (B, KH, G, hd).
    """
    B, KH, G, hd = q.shape
    S = k.shape[1]
    kv_len = S if kv_len is None else kv_len
    if device_kind(q, "decode_attention") == "cuda":
        from repro_torch.kernels.decode_attention.kernel import (
            decode_attention_cuda,
        )
        return decode_attention_cuda(q, k, v, kv_len=kv_len)
    acc, m, l = decode_attention_partials_torch(q, k, v, kv_len=kv_len,
                                                bc=min(bc, S))
    return combine_partials(acc, m, l, q.dtype).reshape(B, KH, G, hd)


def decode_attention_torch(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, kv_len: int | None = None
                           ) -> torch.Tensor:
    """Plain version of the whole function, the reference's
    ``decode_attention_ref`` over ``k[:, :kv_len]``: one softmax over the
    live keys in float32.  Returns (B, KH, G, hd) in q's dtype."""
    hd = q.shape[-1]
    kv_len = k.shape[1] if kv_len is None else kv_len
    s = torch.einsum("bhgd,bshd->bhgs", q.float(),
                     k[:, :kv_len].float()) * hd ** -0.5
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgs,bshd->bhgd", p,
                        v[:, :kv_len].float()).to(q.dtype)
