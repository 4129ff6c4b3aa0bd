"""Grouped-query attention: the whole-sequence causal forward (prefill and
training) and single-token decode against a preallocated KV cache.  The
counterpart of src/repro/models/attention.py.

The reference computes attention in jnp; its Pallas kernels compute the
same function.  Here attention goes through the port's kernels: the
forward through ``flash_attention`` (differentiable: its backward
recomputes the softmax in torch operations) and decode through
``decode_attention``, which on a CUDA tensor are the hand-written CUDA
kernels and on a CPU tensor their plain torch versions.  So scores,
probabilities and the accumulator stay in float32 and only the output is
rounded to the compute dtype, where the reference model also rounds the
scores and the probabilities to it (ROADMAP Queue 3, known differences).
The reference's sharding constraints are kept (``partitioning.constrain``):
on DTensors under rules they redistribute, on plain tensors they do
nothing.  The decode step writes the new token's k/v into the cache in
place (``kernels.sharded.write_at``: on a DTensor cache, only the device
whose block holds the position writes).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.sharded import write_at
from repro_torch.models import layers
from repro_torch.models.partitioning import (constrain, merge_dims,
                                             split_dim)

#: keys per flash-decoding chunk of the plain version (the reference
#: kernel's default); the CUDA kernel plans its own split of the keys
DECODE_CHUNK = 512


def project_qkv(p, x: torch.Tensor, cfg, positions: torch.Tensor):
    """Projections (q, k, v; optional QKV bias and q/k RMSNorm) and RoPE.
    ``p`` maps the reference's leaf names ("wq", "wk", "wv", and "bq",
    "bk", "bv", "q_norm", "k_norm" where the config has them) to weights.
    Returns q: (B,S,KH,G,hd), k/v: (B,S,KH,hd)."""
    B, S, _ = x.shape
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    dt = x.dtype
    q = layers.matmul(x, p["wq"].to(dt))
    k = layers.matmul(x, p["wk"].to(dt))
    v = layers.matmul(x, p["wv"].to(dt))
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q = split_dim(q, 2, (H, hd))
    k = split_dim(k, 2, (KH, hd))
    v = split_dim(v, 2, (KH, hd))
    if cfg.qk_norm:
        q = layers.head_rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = layers.head_rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    return split_dim(q, 2, (KH, H // KH)), k, v


def attention_forward(p, x: torch.Tensor, cfg, positions: torch.Tensor
                      ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                     torch.Tensor]]:
    """Causal self-attention over the whole sequence (prefill, and the
    training forward: differentiable, ``flash_attention`` carries the
    gradient).  Returns (y, (k, v)): k/v seed the decode cache."""
    B, S, _ = x.shape
    q, k, v = project_qkv(p, x, cfg, positions)
    if cfg.num_kv_heads <= 4:
        # the reference's sequence-parallel attention for few kv heads:
        # q's rows over tp, k and v replicated over it
        q = constrain(q, "dp", "tp", None, None, None)
        k = constrain(k, "dp", None, None, None)
        v = constrain(v, "dp", None, None, None)
    out = flash_attention(q, k, v, causal=True)
    out = merge_dims(out, 2, (B, S, cfg.num_heads * cfg.hd))
    out = constrain(out, "dp", None, "tp")
    return layers.matmul(out, p["wo"].to(x.dtype)), (k, v)


class Attention(nn.Module):
    """The weights of one attention layer ((in, out), as in the
    reference), applied by ``attention_forward`` and ``decode``."""

    def __init__(self, gen: torch.Generator, cfg, dtype):
        super().__init__()
        d, H, KH, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
        dev = gen.device
        self.cfg = cfg
        self.wq = layers.param(layers.dense_init(gen, d, H * hd, dtype))
        self.wk = layers.param(layers.dense_init(gen, d, KH * hd, dtype))
        self.wv = layers.param(layers.dense_init(gen, d, KH * hd, dtype))
        self.wo = layers.param(layers.dense_init(gen, H * hd, d, dtype))
        if cfg.qkv_bias:
            self.bq = layers.zeros(H * hd, dtype, dev)
            self.bk = layers.zeros(KH * hd, dtype, dev)
            self.bv = layers.zeros(KH * hd, dtype, dev)
        if cfg.qk_norm:
            self.q_norm = layers.zeros(hd, dtype, dev)
            self.k_norm = layers.zeros(hd, dtype, dev)

    def forward(self, x: torch.Tensor, positions: torch.Tensor
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        return attention_forward(self._parameters, x, self.cfg, positions)

    def decode(self, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               write_idx: int) -> torch.Tensor:
        """Single-token decode.  x: (B, 1, d); cache {"k","v"}:
        (B, S, KH, hd).  The new token's k/v is written into the cache at
        ``write_idx`` IN PLACE (the reference returns a new cache from
        ``dynamic_update_slice``); attention runs over positions
        ``<= write_idx``."""
        cfg = self.cfg
        B = x.shape[0]
        positions = torch.full((B, 1), write_idx, dtype=torch.int32,
                               device=x.device)
        q, k_new, v_new = project_qkv(self._parameters, x, cfg, positions)
        write_at(cache["k"], write_idx, k_new[:, 0], dim=1)
        write_at(cache["v"], write_idx, v_new[:, 0], dim=1)
        k = constrain(cache["k"].to(q.dtype), "dp", "sp", None, None)
        v = constrain(cache["v"].to(q.dtype), "dp", "sp", None, None)
        out = decode_attention(q[:, 0].contiguous(), k, v,
                               kv_len=write_idx + 1, bc=DECODE_CHUNK)
        out = merge_dims(out, 1, (B, 1, cfg.num_heads * cfg.hd))
        return layers.matmul(out, self.wo.to(x.dtype))


def init_kv_cache(cfg, batch: int, seq: int, dtype=torch.bfloat16,
                  device="cuda") -> Dict[str, torch.Tensor]:
    shape = (batch, seq, cfg.num_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
