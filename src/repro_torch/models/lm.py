"""Top-level decoder-only LM: init, the compute cast, forward, loss,
prefill and decode.  The counterpart of src/repro/models/lm.py.  A
config with a frontend (audio, vision) takes its stub input, precomputed
embeddings (B, ``cfg.frontend_len``, d), spliced over the first positions
of the token embedding (``models/modality.py``) in prefill and in the
training forward; decode takes tokens only.

Serving holds the weights in an ``LM`` module, one block per layer; the
reference casts its float32 masters to the compute dtype inside every
step, a server here casts once, when it is built
(``cast_params_for_compute``).  Prefill and decode run under
``torch.no_grad`` and write the decode caches in place.

Training keeps the reference's layout instead: {path: leaf} with each
layer parameter stacked over layers (``init_params``), cast once per step
(``cast_leaves``), and ``forward`` / ``loss_fn`` are differentiable with
respect to those leaves.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import layers
from repro_torch.models.modality import frontend_input_name, splice_frontend
from repro_torch.models.transformer import Stack, block_specs, stack_forward
from repro_torch.pytree import flatten, unflatten

Caches = List[Dict[str, torch.Tensor]]


class LM(nn.Module):
    """Embedding, layer stack, final norm and (tied or own) unembedding,
    initialised from ``seed`` with a ``torch.Generator`` on ``device``
    (the card unless the caller asks for the CPU)."""

    def __init__(self, cfg, *, seed: int = 0, device="cuda"):
        super().__init__()
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

    def _prefill(self, tokens: torch.Tensor,
                 frontend_embeds: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Caches]:
        B, S = tokens.shape
        x = embed_inputs(self.embed, tokens, self.cfg, frontend_embeds,
                         self.compute_dtype)
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device).expand(B, S)
        return self.stack.prefill(x, positions)

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor,
                frontend_embeds: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """tokens: (B, S), frontend_embeds: (B, P, d) or None -> logits
        (B, S, V) float32."""
        x, _ = self._prefill(tokens, frontend_embeds)
        return self._logits(x)


def embed_inputs(table: torch.Tensor, tokens: torch.Tensor, cfg,
                 frontend_embeds: Optional[torch.Tensor],
                 dtype: torch.dtype) -> torch.Tensor:
    """The token embedding in ``dtype``, its first P positions replaced by
    ``frontend_embeds`` (B, P, d) where ``cfg`` has a frontend and they
    are given (the reference's ``_embed_inputs``)."""
    x = layers.embed(table, tokens, dtype)
    if cfg.frontend is not None and frontend_embeds is not None:
        x = splice_frontend(x, frontend_embeds)
    return x


def _cast_rule(path: str, leaf_ndim: int) -> bool:
    """The reference's rule (``lm.cast_params_for_compute``): a float32
    leaf is cast to the compute dtype where the REFERENCE's leaf has two or
    more dims and is not a router weight.  The reference stacks every layer
    parameter as ``(P, ...)``, so that takes in every block parameter,
    norm scales and biases included; only ``final_norm`` stays float32."""
    return leaf_ndim >= 2 and "router" not in path.split("/")


def cast_params_for_compute(model: LM) -> LM:
    """Cast the float32 weights to ``cfg.dtype``, IN PLACE, once (the
    reference casts inside every step), under the reference's rule: every
    parameter of the layer stack (its reference leaf is stacked over
    layers) and the embedding tables; ``final_norm`` stays float32, and so
    does everything when ``cfg.dtype`` is float32."""
    cd = model.compute_dtype
    if cd == torch.float32:
        return model
    for name, p in model.named_parameters():
        ref_ndim = p.ndim + 1 if name.startswith("stack.") else p.ndim
        if p.dtype == torch.float32 and _cast_rule(name.replace(".", "/"),
                                                   ref_ndim):
            p.data = p.data.to(cd)
    return model


# ---------------------------------------------------------------------------
# Training: the reference's leaf layout, differentiable
# ---------------------------------------------------------------------------
def init_params(cfg, *, seed: int = 0, device="cuda") -> Dict[str, torch.Tensor]:
    """Random float32 masters in the reference's layout: an ``LM`` made
    from ``seed`` on ``device`` (the card unless the caller asks for the
    CPU), its layers stacked as the reference stacks them.  {path: leaf}
    in the reference's leaf order, each layer parameter stacked over
    periods as ``(P, ...)`` (``stack/0/mixer/wq`` is ``(P, d, H * hd)``).
    The draws differ from the reference's ``jax.random`` ones; ``interop``
    carries weights across."""
    model = LM(cfg, seed=seed, device=device)
    n_pos = len(block_specs(cfg))
    flat = {name.replace(".", "/"): p.detach()
            for name, p in model.named_parameters()
            if not name.startswith("stack.")}
    for pos in range(n_pos):
        blocks = [dict(b.named_parameters())
                  for b in model.stack.blocks[pos::n_pos]]
        for name in blocks[0]:
            flat[f"stack/{pos}/{name.replace('.', '/')}"] = torch.stack(
                [b[name].detach() for b in blocks])
    return flatten(unflatten(flat))


def abstract_params(cfg) -> Dict[str, torch.Tensor]:
    """``init_params``' leaves as meta tensors: their shapes and dtypes,
    built under ``FakeTensorMode``, so nothing is allocated (the
    reference's ``abstract_params``, ``jax.eval_shape``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        fake = init_params(cfg, device="cpu")
        shapes = {k: (tuple(v.shape), v.dtype) for k, v in fake.items()}
    return {k: torch.empty(s, dtype=d, device="meta")
            for k, (s, d) in shapes.items()}


def cast_leaves(params: Dict[str, torch.Tensor], cfg
                ) -> Dict[str, torch.Tensor]:
    """One cast of the float32 leaves to ``cfg.dtype`` under the
    reference's rule (every leaf of two or more dims, router excepted);
    differentiable, so gradients reach the float32 masters."""
    cd = getattr(torch, cfg.dtype)
    if cd == torch.float32:
        return params
    return {k: v.to(cd) if v.dtype == torch.float32 and _cast_rule(k, v.ndim)
            else v for k, v in params.items()}


def forward(params: Dict[str, torch.Tensor], tokens: torch.Tensor, cfg,
            frontend_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward, differentiable.  ``params``: {path: leaf} in
    the reference's layout (``init_params``); tokens (B, S);
    frontend_embeds (B, P, d) or None.  Returns (logits (B, S, V) float32,
    the stack's aux loss, float32).  The counterpart of the reference's
    ``lm.forward``."""
    tree = unflatten(cast_leaves(params, cfg))
    B, S = tokens.shape
    x = embed_inputs(tree["embed"], tokens, cfg, frontend_embeds,
                     getattr(torch, cfg.dtype))
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)
    x, aux = stack_forward(tree["stack"], x, cfg, positions)
    x = layers.rms_norm(x, tree["final_norm"], cfg.norm_eps)
    table = tree["embed"] if cfg.tie_embeddings else tree["unembed"]
    return layers.unembed(table, x), aux


def loss_fn(params: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
            cfg) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy (logsumexp minus the gold logit, averaged
    over the tokens whose label is >= 0) plus the aux loss.  batch:
    {"tokens", "labels"} (B, S), and the frontend input (B, P, d) under
    ``frontend_input_name(cfg)`` where ``cfg`` has a frontend.  Returns
    (ce + aux, {"ce", "aux"}), as the reference's ``lm.loss_fn``."""
    logits, aux = forward(params, batch["tokens"], cfg,
                          batch.get(frontend_input_name(cfg))
                          if cfg.frontend else None)
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    ce = ((logz - gold) * mask).sum() / mask.sum().clamp(min=1.0)
    return ce + aux, {"ce": ce, "aux": aux}


@torch.no_grad()
def prefill_step(model: LM, tokens: torch.Tensor,
                 cache_len: Optional[int] = None,
                 frontend_embeds: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Caches]:
    """Prefill of ``tokens`` (B, S), with ``frontend_embeds`` (B, P, d)
    over the first P positions where the model has a frontend: logits
    (B, 1, V) for the last position, and one decode
    cache per layer: an attention layer's {"k", "v"} (B, cache_len, KH,
    hd), the prompt's k/v in the first S positions and zeros after them
    for the decode steps to fill (``cache_len`` defaults to S, the
    reference's prefill caches); a recurrent layer's state as the prompt
    leaves it (Mamba {"h", "conv"}, mLSTM {"C", "n", "m", "conv"}, sLSTM
    {"c", "n", "h", "m"})."""
    x, caches = model._prefill(tokens, frontend_embeds)
    S = tokens.shape[1]
    if cache_len is not None and cache_len != S:
        if cache_len < S:
            raise ValueError(f"cache_len {cache_len} < prompt length {S}")
        caches = [{n: F.pad(t, (0, 0, 0, 0, 0, cache_len - S))
                   for n, t in c.items()} if "k" in c else c
                  for c in caches]
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
