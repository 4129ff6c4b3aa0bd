"""Architecture registry of the port — importing this package registers the
configs copied so far: the dense family (served and trained), jamba, the
hybrid family, and xlstm-125m, the xLSTM family (both served).  The other
families' configs come with their slices (ROADMAP Queue 1)."""
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
    jamba_v0p1_52b,
    minitron_8b,
    qwen2_1p5b,
    qwen25_3b,
    qwen3_0p6b,
    xlstm_125m,
)

ARCHS = list_configs()
