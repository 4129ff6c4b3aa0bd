"""qwen2.5-3b [dense] — GQA kv=2, QKV bias [hf:Qwen/Qwen2.5 family]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    num_layers=36,
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    d_ff=11008,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1e6,
))
