"""Architecture registry of the port — importing this package registers
every config of the reference's registry: the dense family and the MoE
family (deepseek-moe-16b, dbrx-132b), served and trained; the audio and
vision families (musicgen-large, llava-next-mistral-7b), whose frontends
are stubs fed with precomputed embeddings, served and trained; jamba (the
hybrid family) and xlstm-125m (the xLSTM family), served."""
from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    ModelConfig,
    ShapeConfig,
    get_config,
    list_configs,
    register,
    shape_applicable,
)

# importing each module registers its CONFIG
from repro_torch.configs import (  # noqa: F401
    dbrx_132b,
    deepseek_moe_16b,
    jamba_v0p1_52b,
    llava_next_mistral_7b,
    minitron_8b,
    musicgen_large,
    qwen2_1p5b,
    qwen25_3b,
    qwen3_0p6b,
    xlstm_125m,
)

ARCHS = list_configs()
