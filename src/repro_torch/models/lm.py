"""Top-level decoder-only LM: init, the compute cast, forward, prefill and
decode.  The counterpart of src/repro/models/lm.py (``loss_fn`` comes with
the training slice, modality frontends with the audio and VLM families).

The reference casts its float32 masters to the compute dtype inside every
step; a server here casts once, when it is built
(``cast_params_for_compute``).  The steps run under ``torch.no_grad`` and
write the decode caches in place.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers
from repro_torch.models.transformer import Stack
from repro_torch.device import resolve_device

Caches = List[Dict[str, torch.Tensor]]


class LM(nn.Module):
    """Embedding, layer stack, final norm and (tied or own) unembedding,
    initialised from ``seed`` with a ``torch.Generator`` on ``device``
    (the card unless the caller asks for the CPU)."""

    def __init__(self, cfg, *, seed: int = 0, device="cuda"):
        super().__init__()
        if cfg.frontend is not None:
            raise NotImplementedError(
                f"{cfg.name}: modality frontends are not ported yet; their "
                f"reference is src/repro/models/modality.py (ROADMAP Queue 1)")
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        dtype = getattr(torch, cfg.param_dtype)
        self.cfg = cfg
        self.embed = layers.param(
            layers.init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype))
        self.stack = Stack(gen, cfg)
        self.final_norm = layers.zeros(cfg.d_model, dtype, dev)
        if not cfg.tie_embeddings:
            self.unembed = layers.param(
                layers.init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                      dtype))

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.dtype)

    def _table(self) -> torch.Tensor:
        return self.embed if self.cfg.tie_embeddings else self.unembed

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = layers.rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return layers.unembed(self._table(), x)

    def _prefill(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, Caches]:
        B, S = tokens.shape
        x = layers.embed(self.embed, tokens, self.compute_dtype)
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device).expand(B, S)
        return self.stack.prefill(x, positions)

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens: (B, S) -> logits (B, S, V) float32."""
        x, _ = self._prefill(tokens)
        return self._logits(x)


def cast_params_for_compute(model: LM) -> LM:
    """Cast the float32 weights of two or more dims to ``cfg.dtype``, IN
    PLACE, once (the reference casts inside every step).  1-D parameters
    (norm scales, biases) stay float32, as in the reference; so does
    everything when ``cfg.dtype`` is float32."""
    cd = model.compute_dtype
    for p in model.parameters():
        if p.dtype == torch.float32 and p.ndim >= 2:
            p.data = p.data.to(cd)
    return model


@torch.no_grad()
def prefill_step(model: LM, tokens: torch.Tensor,
                 cache_len: Optional[int] = None
                 ) -> Tuple[torch.Tensor, Caches]:
    """Prefill: logits (B, 1, V) for the last position, and one decode
    cache {"k", "v"} (B, cache_len, KH, hd) per layer: the prompt's k/v in
    the first S positions, zeros after them for the decode steps to fill.
    ``cache_len`` defaults to S, the reference's prefill caches."""
    x, caches = model._prefill(tokens)
    S = tokens.shape[1]
    if cache_len is not None and cache_len != S:
        if cache_len < S:
            raise ValueError(f"cache_len {cache_len} < prompt length {S}")
        caches = [{n: F.pad(c[n], (0, 0, 0, 0, 0, cache_len - S))
                   for n in ("k", "v")} for c in caches]
    return model._logits(x[:, -1:]), caches


@torch.no_grad()
def decode_step(model: LM, tokens: torch.Tensor, caches: Caches,
                write_idx: int) -> Tuple[torch.Tensor, torch.Tensor, Caches]:
    """One decode step.  tokens: (B, 1), the current token, written at
    ``write_idx`` into the caches (in place).  Returns (next_token (B, 1),
    logits (B, 1, V), caches)."""
    x = layers.embed(model.embed, tokens, model.compute_dtype)
    x = model.stack.decode(x, caches, write_idx)
    logits = model._logits(x)
    return logits.argmax(dim=-1).to(tokens.dtype), logits, caches
