"""Block assembly: (mixer, ffn) blocks stacked into the layer stack.  The
counterpart of src/repro/models/transformer.py.

The reference stacks each period position's parameters over periods and
scans.  The serving path holds one ``Block`` per layer in an
``nn.ModuleList`` (layer ``i`` is period ``i // len(block_specs(cfg))``,
position ``i % len(block_specs(cfg))``; ``interop.params_from_numpy``
unstacks); training keeps the reference's stacked leaves and reads each
layer as a slice of them (``stack_forward``).  Both run ``block_forward``:
serving asks it for the decode cache, training does not (the reference's
training forward builds none).  Both take every mixer (``attn``,
``mamba``, ``mlstm``, ``slstm``) and every FFN (``mlp``, ``moe``,
``ffn43``, ``none``): the dense, MoE, jamba and xLSTM blocks; in training
``stack_forward`` sums the MoE router's aux loss over the layers as the
reference does.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers
from repro_torch.models.attention import (
    Attention,
    attention_forward,
    init_kv_cache,
)
from repro_torch.models.moe import MoE, apply_moe
from repro_torch.models.ssm import (
    MLSTM,
    SLSTM,
    Mamba,
    init_mamba_state,
    init_mlstm_state,
    init_slstm_state,
    mamba_forward,
    mlstm_forward,
    slstm_forward,
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


#: each mixer's weights module
_MIXERS = {"attn": Attention, "mamba": Mamba, "mlstm": MLSTM,
           "slstm": SLSTM}
#: each recurrent mixer's whole-sequence forward
_FORWARD = {"mamba": mamba_forward, "mlstm": mlstm_forward,
            "slstm": slstm_forward}


def ffn_forward(p, x: torch.Tensor, cfg, ffn: str
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(``x + ffn(norm(x))``, the FFN's aux loss) with the SwiGLU MLP
    (``mlp``, or xLSTM's ``ffn43`` of width ``int(d * 4 / 3)``) or the MoE
    (its router's load-balance loss, scaled, float32); ``x`` itself for
    ``none`` (the mLSTM block has no FFN).  The aux is None but for the
    MoE: the reference's float32 zero would cost a device launch a layer
    on every decode step, and adding it changes no sum."""
    if ffn == "none":
        return x, None
    h = layers.rms_norm(x, p["ffn_norm"], cfg.norm_eps)
    if ffn in ("mlp", "ffn43"):
        return x + layers.apply_mlp(p["ffn"], h), None
    if ffn == "moe":
        y, aux = apply_moe(p["ffn"], h, cfg)
        return x + y, aux
    raise ValueError(ffn)


def block_forward(p, x: torch.Tensor, cfg, spec: Tuple[str, str],
                  positions: torch.Tensor, return_state: bool = True):
    """The pre-norm residual block, ``x + mixer(norm(x))`` then
    ``x + ffn(norm(x))``, over the whole sequence.  ``p`` is one layer's
    leaves under the reference's names ({"mixer_norm", "mixer": {...},
    "ffn_norm", "ffn": {...}}; no FFN leaves for ``none``); ``spec`` its
    (mixer, ffn).  Returns (x, the FFN's aux loss or None, the mixer's decode
    cache: {"k", "v"} for attention, {"h", "conv"} for Mamba, {"C", "n",
    "m", "conv"} for mLSTM, {"c", "n", "h", "m"} for sLSTM; None without
    ``return_state``, which training passes: the recurrent mixers then
    build no state), in the reference's order.  Differentiable for every
    block."""
    mixer, ffn = spec
    h = layers.rms_norm(x, p["mixer_norm"], cfg.norm_eps)
    cache = None
    if mixer == "attn":
        y, (k, v) = attention_forward(p["mixer"], h, cfg, positions)
        if return_state:
            cache = {"k": k, "v": v}
    elif mixer in _FORWARD:
        y = _FORWARD[mixer](p["mixer"], h, cfg, return_state=return_state)
        if return_state:
            y, cache = y
    else:
        raise ValueError(mixer)
    x, aux = ffn_forward(p, x + y, cfg, ffn)
    return x, aux, cache


def _block_output(p, x, cfg, spec, positions):
    """(x, aux) of one block, no decode cache: what ``cfg.remat``
    recomputes."""
    return block_forward(p, x, cfg, spec, positions, return_state=False)[:2]


def stack_forward(stack, x: torch.Tensor, cfg, positions: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward of the layer stack.  ``stack`` is the
    reference's layout: a tuple over period positions of {name: leaf}
    dicts (nested as the reference nests them), each leaf stacked over
    periods as ``(P, ...)``.  Layer ``i`` reads slice ``i // n_pos`` of
    position ``i % n_pos``'s leaves (``unbind``: views, so gradients land
    in the stacked leaves).  With ``cfg.remat`` each block is recomputed
    in the backward pass (``torch.utils.checkpoint``, the counterpart of
    the reference's ``jax.checkpoint``).  Returns (x, aux): the MoE
    blocks' aux losses added to a float32 zero in layer order, as the
    reference's scan body adds every block's (the others' are zeros).
    Every block kind trains: attention, Mamba, mLSTM and sLSTM mixers,
    MLP, ``ffn43`` and MoE FFNs."""
    specs = block_specs(cfg)

    def unbind(tree):
        return {k: unbind(v) if isinstance(v, dict) else v.unbind(0)
                for k, v in tree.items()}

    def layer(tree, i):
        return {k: layer(v, i) if isinstance(v, dict) else v[i]
                for k, v in tree.items()}

    views = [unbind(pos) for pos in stack]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(num_periods(cfg)):
        for pos, spec in enumerate(specs):
            p = layer(views[pos], i)
            if cfg.remat:
                x, a = checkpoint(_block_output, p, x, cfg, spec, positions,
                                  use_reentrant=False)
            else:
                x, a = _block_output(p, x, cfg, spec, positions)
            if a is not None:
                aux = aux + a
    return x, aux


class Block(nn.Module):
    """The weights of one block of spec (mixer, ffn): ``Attention``,
    ``Mamba``, ``MLSTM`` or ``SLSTM``, then ``MLP`` (``mlp`` or
    ``ffn43``), ``MoE`` or nothing (``none``: no ``ffn_norm`` and no
    ``ffn``, as the reference's leaves); applied by ``block_forward``."""

    def __init__(self, gen: torch.Generator, cfg, spec: Tuple[str, str]):
        super().__init__()
        mixer, ffn = spec
        dtype = getattr(torch, cfg.param_dtype)
        dev = gen.device
        d = cfg.d_model
        self.cfg, self.spec = cfg, spec
        self.mixer_norm = layers.zeros(d, dtype, dev)
        self.mixer = _MIXERS[mixer](gen, cfg, dtype)
        if ffn == "none":
            return
        self.ffn_norm = layers.zeros(d, dtype, dev)
        if ffn == "moe":
            self.ffn = MoE(gen, cfg, dtype)
        else:
            width = cfg.d_ff if ffn == "mlp" else int(d * 4 / 3)
            self.ffn = layers.MLP(gen, d, width, dtype)

    def prefill(self, x: torch.Tensor, positions: torch.Tensor):
        """Whole-sequence forward that also returns the decode cache
        (serving drops the aux loss, as the reference's prefill does)."""
        x, _, cache = block_forward(layers.leaves(self), x, self.cfg,
                                    self.spec, positions)
        return x, cache

    def decode(self, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               write_idx: int) -> torch.Tensor:
        """Single-token decode; writes the cache in place."""
        mixer, ffn = self.spec
        h = layers.rms_norm(x, self.mixer_norm, self.cfg.norm_eps)
        y = (self.mixer.decode(h, cache, write_idx) if mixer == "attn"
             else self.mixer.decode(h, cache))
        return ffn_forward(layers.leaves(self), x + y, self.cfg, ffn)[0]


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


def init_block_cache(cfg, spec: Tuple[str, str], batch: int, seq: int,
                     dtype=torch.bfloat16, device="cuda"
                     ) -> Dict[str, torch.Tensor]:
    """A zeroed decode cache for one block: {"k", "v"} (batch, seq, KH,
    hd) for attention, {"h" (batch, di, N) float32, "conv"} for Mamba,
    {"C", "n", "m" float32, "conv"} for mLSTM, {"c", "n", "h", "m"}
    float32 for sLSTM."""
    mixer = spec[0]
    if mixer == "attn":
        return init_kv_cache(cfg, batch, seq, dtype, device)
    if mixer == "mamba":
        return init_mamba_state(cfg, batch, dtype, device)
    if mixer == "mlstm":
        return init_mlstm_state(cfg, batch, dtype, device)
    if mixer == "slstm":
        return init_slstm_state(cfg, batch, device)
    raise ValueError(mixer)


def init_caches(cfg, batch: int, seq: int, dtype=torch.bfloat16,
                device="cuda") -> List[Dict[str, torch.Tensor]]:
    """One zeroed decode cache per layer, by the layer's spec."""
    specs = block_specs(cfg)
    return [init_block_cache(cfg, specs[i % len(specs)], batch, seq, dtype,
                             device)
            for i in range(cfg.num_layers)]
