"""jamba-v0.1-52b [hybrid] — Mamba + attention 1:7 interleave, MoE 16e top-2 on
every other layer [arXiv:2403.19887].
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    num_experts=16,
    experts_per_tok=2,
    moe_d_ff=14336,
    moe_period=2,
    moe_offset=1,
    block_pattern=(
        "mamba", "mamba", "mamba", "mamba",
        "attn", "mamba", "mamba", "mamba",
    ),
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    # §Perf cell B: SP residual transitions cost more than they save in this
    # hybrid stack (period=8 => only 4 scan carries stored); disabling SP cut
    # memory 4.06->2.81s and collective 3.68->2.62s.  See EXPERIMENTS.md.
    seq_sharded_residual=False,
))
