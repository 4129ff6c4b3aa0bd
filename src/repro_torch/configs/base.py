"""Configuration dataclasses for architectures and input shapes.

Every assigned architecture is expressed as a ``ModelConfig``; benchmark input
shapes are ``ShapeConfig``.  Configs are plain frozen dataclasses so they can be
hashed into jit static args and printed into experiment logs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters (decoder-only LM backbone)."""

    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # --- mixture of experts -------------------------------------------------
    num_experts: int = 0
    experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0           # per-expert hidden dim (fine-grained MoE)
    moe_period: int = 1         # MoE FFN at layers where layer % moe_period == moe_offset
    moe_offset: int = 0

    # --- block pattern (tiled to num_layers): attn | mamba | mlstm | slstm --
    block_pattern: Tuple[str, ...] = ("attn",)

    # --- mamba (jamba) ------------------------------------------------------
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2

    # --- xlstm --------------------------------------------------------------
    xlstm_proj_factor: float = 2.0

    # --- modality frontend (stub: precomputed embeddings) -------------------
    frontend: Optional[str] = None      # None | "audio" | "vision"
    frontend_len: int = 0               # prefix positions fed from the frontend

    # --- numerics / memory --------------------------------------------------
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    scan_layers: bool = True
    grad_accum: int = 1                 # microbatch count for train_step

    # --- distribution -------------------------------------------------------
    # "2d": FSDP over data axes x TP over model (default);
    # "dp_only": pure data parallelism over every non-pod axis, params
    #            replicated — right for small-width models where TP forces
    #            replicated compute + activation all-reduces (see §Perf).
    sharding_profile: str = "2d"
    # sequence-parallel residual stream (Megatron-SP): shards the residual's
    # seq dim over the model axis between blocks; trades gather/scatter
    # traffic for 1/TP residual memory (see §Perf cell B).
    seq_sharded_residual: bool = True

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def pattern_period(self) -> int:
        return len(self.block_pattern)

    def kind_at(self, layer: int) -> str:
        return self.block_pattern[layer % self.pattern_period]

    def moe_at(self, layer: int) -> bool:
        return self.num_experts > 0 and (layer % self.moe_period) == self.moe_offset

    @property
    def attention_free(self) -> bool:
        return all(k != "attn" for k in self.block_pattern)

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch can serve 500k-token contexts (SSM/hybrid state decode)."""
        return any(k in ("mamba", "mlstm", "slstm") for k in self.block_pattern)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """A benchmark input shape."""

    name: str
    kind: str           # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """long_500k needs sub-quadratic sequence mixing (see DESIGN.md §6)."""
    if shape.name == "long_500k":
        return cfg.sub_quadratic
    return True


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    # populate registry lazily
    from repro_torch import configs as _c  # noqa: F401

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list:
    from repro_torch import configs as _c  # noqa: F401

    return sorted(_REGISTRY)
