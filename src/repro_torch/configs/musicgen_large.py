"""musicgen-large [audio] — decoder-only over EnCodec tokens [arXiv:2306.05284].

The EnCodec/conditioning frontend is a STUB: ``input_specs()`` provides
precomputed conditioning-frame embeddings occupying the first ``frontend_len``
positions of the sequence (see models/modality.py).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    frontend="audio",
    frontend_len=256,
))
