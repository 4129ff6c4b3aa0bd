"""llava-next-mistral-7b [vlm] — mistral-7b backbone; anyres vision tiling is a
STUB: ``input_specs()`` provides precomputed patch embeddings for the first
``frontend_len`` sequence positions [hf:llava-hf/llava-v1.6-mistral-7b-hf].
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    frontend="vision",
    frontend_len=576,
    rope_theta=1e6,
))
