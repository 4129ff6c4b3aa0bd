"""Block assembly: (mixer, ffn) blocks stacked into the layer stack.  The
counterpart of src/repro/models/transformer.py.

The reference stacks each period position's parameters over periods and
scans; the port holds one ``Block`` per layer in an ``nn.ModuleList`` (layer
``i`` is period ``i // len(block_specs(cfg))``, position
``i % len(block_specs(cfg))``; ``interop.params_from_numpy`` unstacks).
So far only the dense ``('attn', 'mlp')`` block is ported.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
from torch import nn

from repro_torch.models import layers
from repro_torch.models.attention import Attention, init_kv_cache


def block_specs(cfg) -> List[Tuple[str, str]]:
    """Per-position (mixer, ffn) specs for one effective period."""
    period = cfg.pattern_period
    if cfg.num_experts > 0:
        period = math.lcm(period, cfg.moe_period)
    assert cfg.num_layers % period == 0, (cfg.name, cfg.num_layers, period)
    specs = []
    for p in range(period):
        mixer = cfg.kind_at(p)
        if mixer in ("mlstm",):
            ffn = "none"            # mLSTM block embeds its own projections
        elif mixer == "slstm":
            ffn = "ffn43"           # xLSTM post-up-projection FFN (4/3)
        elif cfg.moe_at(p):
            ffn = "moe"
        else:
            ffn = "mlp"
        specs.append((mixer, ffn))
    return specs


def num_periods(cfg) -> int:
    return cfg.num_layers // len(block_specs(cfg))


#: the reference module of each block part the port does not have yet
_UNPORTED = {"mamba": "src/repro/models/ssm.py (mamba)",
             "mlstm": "src/repro/models/ssm.py (mlstm)",
             "slstm": "src/repro/models/ssm.py (slstm)",
             "moe": "src/repro/models/moe.py",
             "ffn43": "src/repro/models/transformer.py (ffn43, xLSTM)"}


def check_ported(spec: Tuple[str, str]) -> None:
    """Raise ``NotImplementedError`` for a block spec the port lacks."""
    for part in spec:
        if part in _UNPORTED:
            raise NotImplementedError(
                f"block spec {spec}: {part!r} is not ported yet; its "
                f"reference is {_UNPORTED[part]} (ROADMAP Queue 1)")


class Block(nn.Module):
    """Pre-norm residual block: ``x + mixer(norm(x))``, then
    ``x + mlp(norm(x))``."""

    def __init__(self, gen: torch.Generator, cfg, spec: Tuple[str, str]):
        super().__init__()
        check_ported(spec)
        dtype = getattr(torch, cfg.param_dtype)
        dev = gen.device
        self.cfg = cfg
        self.mixer_norm = layers.zeros(cfg.d_model, dtype, dev)
        self.mixer = Attention(gen, cfg, dtype)
        self.ffn_norm = layers.zeros(cfg.d_model, dtype, dev)
        self.ffn = layers.MLP(gen, cfg.d_model, cfg.d_ff, dtype)

    def _ffn(self, x: torch.Tensor) -> torch.Tensor:
        h = layers.rms_norm(x, self.ffn_norm, self.cfg.norm_eps)
        return x + self.ffn(h)

    def prefill(self, x: torch.Tensor, positions: torch.Tensor):
        """Whole-sequence forward that also returns the decode cache."""
        h = layers.rms_norm(x, self.mixer_norm, self.cfg.norm_eps)
        y, (k, v) = self.mixer(h, positions)
        return self._ffn(x + y), {"k": k, "v": v}

    def decode(self, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               write_idx: int) -> torch.Tensor:
        """Single-token decode; writes the cache in place."""
        h = layers.rms_norm(x, self.mixer_norm, self.cfg.norm_eps)
        return self._ffn(x + self.mixer.decode(h, cache, write_idx))


class Stack(nn.Module):
    """The layer stack, one ``Block`` per layer."""

    def __init__(self, gen: torch.Generator, cfg):
        super().__init__()
        specs = block_specs(cfg)
        self.blocks = nn.ModuleList(
            Block(gen, cfg, specs[i % len(specs)])
            for i in range(cfg.num_layers))

    def prefill(self, x: torch.Tensor, positions: torch.Tensor):
        caches = []
        for block in self.blocks:
            x, cache = block.prefill(x, positions)
            caches.append(cache)
        return x, caches

    def decode(self, x: torch.Tensor, caches: List[Dict[str, torch.Tensor]],
               write_idx: int) -> torch.Tensor:
        for block, cache in zip(self.blocks, caches):
            x = block.decode(x, cache, write_idx)
        return x


def init_caches(cfg, batch: int, seq: int, dtype=torch.bfloat16,
                device="cuda") -> List[Dict[str, torch.Tensor]]:
    """One zeroed KV cache per layer, (batch, seq, KH, hd) each."""
    for spec in block_specs(cfg):
        check_ported(spec)
    return [init_kv_cache(cfg, batch, seq, dtype, device)
            for _ in range(cfg.num_layers)]
