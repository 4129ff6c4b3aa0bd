"""xlstm-125m [ssm] — sLSTM + mLSTM blocks, ratio 5:1 (xLSTM[7:1]-style mix),
d_ff=0 (block-internal projections) [arXiv:2405.04517].
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern=("mlstm", "mlstm", "slstm", "mlstm", "mlstm", "mlstm"),
    xlstm_proj_factor=2.0,
    tie_embeddings=True,
    # §Perf cell A: TP over 16 chips is counterproductive at d_model=768 /
    # 4 heads (replicated quadratic compute + activation all-reduces).
    # Pure DP cut the collective term 33x; see EXPERIMENTS.md §Perf.
    sharding_profile="dp_only",
))
