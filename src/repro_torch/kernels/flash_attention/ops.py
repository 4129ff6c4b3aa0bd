"""Causal grouped-query flash attention: model-layout wrapper, dispatch and
plain torch version.

The counterpart of src/repro/kernels/flash_attention/{ops,ref}.py.  A CUDA
tensor goes through the hand-written kernel (``kernel.py``), a CPU tensor
through ``flash_attention_torch``, which has the semantics of the
reference's ``flash_attention_ref`` and of its Pallas kernel: scores,
softmax and the weighted sum in float32, one cast to q's dtype at the end.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import device_kind


def flash_attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True) -> torch.Tensor:
    """Plain version.  q: (BK, G, S, hd); k, v: (BK, S, hd), BK = batch x
    kv heads, G query heads per kv head.  Returns (BK, G, S, hd)."""
    S, hd = q.shape[-2:]
    s = torch.einsum("bgqd,bkd->bgqk", q.float(), k.float()) * hd ** -0.5
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bgqk,bkd->bgqd", p, v.float()).to(q.dtype)


def flash_attention_grouped(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True
                            ) -> torch.Tensor:
    """The kernel's layout, q: (BK, G, S, hd); k, v: (BK, S, hd),
    dispatched on q's device: the plain torch version for a CPU tensor,
    the CUDA kernel for a CUDA tensor."""
    if device_kind(q, "flash_attention") == "cpu":
        return flash_attention_torch(q, k, v, causal=causal)
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda,
    )
    return flash_attention_cuda(q, k, v, causal=causal)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    *, causal: bool = True) -> torch.Tensor:
    """Flash attention in model layout.

    q: (B, S, KH, G, hd); k, v: (B, S, KH, hd).  Returns (B, S, KH, G, hd).
    """
    B, S, KH, G, hd = q.shape
    qk = q.permute(0, 2, 3, 1, 4).reshape(B * KH, G, S, hd).contiguous()
    kk = k.permute(0, 2, 1, 3).reshape(B * KH, S, hd).contiguous()
    vk = v.permute(0, 2, 1, 3).reshape(B * KH, S, hd).contiguous()
    o = flash_attention_grouped(qk, kk, vk, causal=causal)
    return o.reshape(B, KH, G, S, hd).permute(0, 3, 1, 2, 4)
