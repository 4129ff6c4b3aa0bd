from repro_torch.kernels.mlstm_attention.ops import (  # noqa: F401
    mlstm_attention,
    mlstm_attention_plain,
    mlstm_attention_torch,
)
