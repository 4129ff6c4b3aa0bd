"""deepseek-moe-16b [moe] — 2 shared + 64 routed top-6, fine-grained experts
(per-expert hidden 1408) [arXiv:2401.06066].
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    num_experts=64,
    experts_per_tok=6,
    num_shared_experts=2,
    moe_d_ff=1408,
    moe_period=1,
))
