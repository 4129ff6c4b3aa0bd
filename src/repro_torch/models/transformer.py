"""Block assembly: (mixer, ffn) blocks stacked into the layer stack.  The
counterpart of src/repro/models/transformer.py.

The reference stacks each period position's parameters over periods and
scans.  The serving path holds one ``Block`` per layer in an
``nn.ModuleList`` (layer ``i`` is period ``i // len(block_specs(cfg))``,
position ``i % len(block_specs(cfg))``; ``interop.params_from_numpy``
unstacks); training keeps the reference's stacked leaves and reads each
layer as a slice of them (``stack_forward``).  Both run ``block_forward``.
So far only the dense ``('attn', 'mlp')`` block is ported.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
from torch import nn

from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers
from repro_torch.models.attention import (
    Attention,
    attention_forward,
    init_kv_cache,
)


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


def block_forward(p, x: torch.Tensor, cfg, positions: torch.Tensor):
    """The dense pre-norm residual block, ``x + attn(norm(x))`` then
    ``x + mlp(norm(x))``, over the whole sequence.  ``p`` is one layer's
    leaves under the reference's names ({"mixer_norm", "mixer": {...},
    "ffn_norm", "ffn": {...}}).  Returns (x, (k, v)); differentiable."""
    h = layers.rms_norm(x, p["mixer_norm"], cfg.norm_eps)
    y, kv = attention_forward(p["mixer"], h, cfg, positions)
    x = x + y
    h = layers.rms_norm(x, p["ffn_norm"], cfg.norm_eps)
    return x + layers.apply_mlp(p["ffn"], h), kv


def _block_output(p, x, cfg, positions):
    return block_forward(p, x, cfg, positions)[0]


def stack_forward(stack, x: torch.Tensor, cfg, positions: torch.Tensor
                  ) -> torch.Tensor:
    """The training forward of the layer stack.  ``stack`` is the
    reference's layout: a tuple over period positions of {name: leaf}
    dicts (nested as the reference nests them), each leaf stacked over
    periods as ``(P, ...)``.  Layer ``i`` reads slice ``i // n_pos`` of
    position ``i % n_pos``'s leaves (``unbind``: views, so gradients land
    in the stacked leaves).  With ``cfg.remat`` each block is recomputed
    in the backward pass (``torch.utils.checkpoint``, the counterpart of
    the reference's ``jax.checkpoint``)."""
    specs = block_specs(cfg)
    for spec in specs:
        check_ported(spec)

    def unbind(tree):
        return {k: unbind(v) if isinstance(v, dict) else v.unbind(0)
                for k, v in tree.items()}

    def layer(tree, i):
        return {k: layer(v, i) if isinstance(v, dict) else v[i]
                for k, v in tree.items()}

    views = [unbind(pos) for pos in stack]
    for i in range(num_periods(cfg)):
        for pos in range(len(specs)):
            p = layer(views[pos], i)
            if cfg.remat:
                x = checkpoint(_block_output, p, x, cfg, positions,
                               use_reentrant=False)
            else:
                x = _block_output(p, x, cfg, positions)
    return x


class Block(nn.Module):
    """The weights of one dense block, applied by ``block_forward``."""

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

    def leaves(self):
        """This layer's weights under the reference's leaf names."""
        return {"mixer_norm": self.mixer_norm,
                "mixer": self.mixer._parameters,
                "ffn_norm": self.ffn_norm, "ffn": self.ffn._parameters}

    def prefill(self, x: torch.Tensor, positions: torch.Tensor):
        """Whole-sequence forward that also returns the decode cache."""
        x, (k, v) = block_forward(self.leaves(), x, self.cfg, positions)
        return x, {"k": k, "v": v}

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
