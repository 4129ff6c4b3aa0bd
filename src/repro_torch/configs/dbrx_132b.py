"""dbrx-132b [moe] — 16 experts top-4, per-expert hidden 10752
[hf:databricks/dbrx-base].
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    num_experts=16,
    experts_per_tok=4,
    moe_d_ff=10752,
    moe_period=1,
    rope_theta=5e5,
))
