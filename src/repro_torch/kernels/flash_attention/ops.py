"""Causal grouped-query flash attention: model-layout wrapper, dispatch and
plain torch version.

The counterpart of src/repro/kernels/flash_attention/{ops,ref}.py.  A CUDA
tensor goes through the hand-written kernel (``kernel.py``), a CPU tensor
through ``flash_attention_torch``, which has the semantics of the
reference's ``flash_attention_ref`` and of its Pallas kernel: scores,
softmax and the weighted sum in float32, one cast to q's dtype at the end.
Both are differentiable through a ``torch.autograd.Function`` whose
backward recomputes the softmax in torch operations.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import count_fake, device_kind
from repro_torch.kernels.sharded import any_dtensor, on_mesh


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


#: query rows per chunk of the backward pass: the reference's own chunking
#: of its jnp attention (``attention_forward``'s ``q_chunk``)
BACKWARD_CHUNK = 1024


def flash_attention_shape(q, k, v, *, causal: bool = True):
    """The shape function (a ``FakeTensor``, the dry run's): the output's
    shape and dtype, and the kernel's work counted, nothing computed.  The
    work is the reference's: both products over every key, 4 BK G S^2 hd
    (its jnp attention masks the scores, it does not skip them)."""
    BK, G, S, hd = q.shape
    count_fake("flash_attention", 4.0 * BK * G * S * k.shape[1] * hd)
    return torch.empty_like(q)


def _forward(q, k, v, causal):
    kind = device_kind(q, "flash_attention")
    if kind == "fake":
        return flash_attention_shape(q, k, v, causal=causal)
    if kind == "cpu":
        return flash_attention_torch(q, k, v, causal=causal)
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda,
    )
    return flash_attention_cuda(q, k, v, causal=causal)


def flash_attention_backward_torch(q, k, v, do, *, causal: bool = True,
                                   chunk: int = BACKWARD_CHUNK):
    """dq, dk, dv of ``flash_attention_torch`` for the output gradient
    ``do``, in torch operations: per chunk of ``chunk`` query rows, the
    causal softmax is recomputed in float32 from q and k (keys past the
    chunk's last query are masked for every row of it, so they are left
    out), and ``ds = p * (dp - rowsum(p * dp))``.  The counterpart of XLA's
    autodiff of the reference's chunked jnp attention; the gradients are
    rounded once, to the inputs' dtypes."""
    BK, G, S, hd = q.shape
    scale = hd ** -0.5
    kf, vf = k.float(), v.float()
    dq = torch.empty((BK, G, S, hd), dtype=torch.float32, device=q.device)
    dk = torch.zeros((BK, S, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for c0 in range(0, S, chunk):
        c1 = min(S, c0 + chunk)
        end = c1 if causal else S
        qc, doc = q[:, :, c0:c1].float(), do[:, :, c0:c1].float()
        kc, vc = kf[:, :end], vf[:, :end]
        s = torch.einsum("bgqd,bkd->bgqk", qc, kc) * scale
        if causal:
            rows = torch.arange(c0, c1, device=q.device)[:, None]
            s = s.masked_fill(rows < torch.arange(end, device=q.device),
                              float("-inf"))
        p = torch.softmax(s, dim=-1)
        dv[:, :end] += torch.einsum("bgqk,bgqd->bkd", p, doc)
        dp = torch.einsum("bgqd,bkd->bgqk", doc, vc)
        ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
        dq[:, :, c0:c1] = torch.einsum("bgqk,bkd->bgqd", ds, kc) * scale
        dk[:, :end] += torch.einsum("bgqk,bgqd->bkd", ds, qc) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """Forward through the kernel (CUDA tensor) or the plain version (CPU
    tensor); backward by ``flash_attention_backward_torch`` (the kernel
    has no backward yet)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v, causal)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        return (*flash_attention_backward_torch(q, k, v, do.contiguous(),
                                                causal=ctx.causal), None)


def flash_attention_grouped(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True
                            ) -> torch.Tensor:
    """The kernel's layout, q: (BK, G, S, hd); k, v: (BK, S, hd),
    dispatched on q's device: the plain torch version for a CPU tensor,
    the CUDA kernel for a CUDA tensor.  Differentiable."""
    return _FlashAttention.apply(q, k, v, causal)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    *, causal: bool = True) -> torch.Tensor:
    """Flash attention in model layout.

    q: (B, S, KH, G, hd); k, v: (B, S, KH, hd).  Returns (B, S, KH, G, hd).
    DTensor inputs run on every device's block (``kernels/sharded.py``):
    batch, kv heads and query groups stay sharded, the sequence and the
    head dim are replicated (causal rows are read by position).
    """
    if any_dtensor(q, k, v):
        return on_mesh(lambda a, b, c: flash_attention(a, b, c,
                                                       causal=causal),
                       (q, k, v), ("bskgd", "btkd", "btkd"), "bskgd",
                       free="bkg")
    B, S, KH, G, hd = q.shape
    qk = q.permute(0, 2, 3, 1, 4).reshape(B * KH, G, S, hd).contiguous()
    kk = k.permute(0, 2, 1, 3).reshape(B * KH, S, hd).contiguous()
    vk = v.permute(0, 2, 1, 3).reshape(B * KH, S, hd).contiguous()
    o = flash_attention_grouped(qk, kk, vk, causal=causal)
    return o.reshape(B, KH, G, S, hd).permute(0, 3, 1, 2, 4)
