from repro_torch.kernels.decode_attention.ops import (  # noqa: F401
    combine_partials,
    decode_attention,
    decode_attention_partials,
    decode_attention_partials_torch,
    decode_attention_torch,
)
