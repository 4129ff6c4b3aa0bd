"""Reduced configs for CPU smoke tests: same family/structure, tiny sizes.

The reduced config preserves everything structural (block pattern, GQA-ness,
MoE periodicity, qk_norm/bias flags, frontend) while shrinking width, depth,
and vocab so one forward/train step runs in milliseconds on CPU.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    from repro_torch.models.transformer import block_specs  # avoid import cycle

    period = len(block_specs(cfg))
    kv = 2 if cfg.num_kv_heads < cfg.num_heads else 4
    return cfg.replace(
        name=cfg.name + "-smoke",
        num_layers=period * (2 if period == 1 else 1),
        d_model=64,
        num_heads=4,
        num_kv_heads=kv,
        head_dim=16 if cfg.head_dim is not None else None,
        d_ff=128 if cfg.d_ff > 0 else 0,
        vocab_size=503,
        num_experts=min(8, cfg.num_experts),
        experts_per_tok=min(2, cfg.experts_per_tok),
        moe_d_ff=32 if cfg.num_experts else 0,
        frontend_len=8 if cfg.frontend else 0,
        grad_accum=1,
    )
