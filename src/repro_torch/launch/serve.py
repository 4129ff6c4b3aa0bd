"""Serving entry point: batched prefill, then greedy decode.

The counterpart of src/repro/launch/serve.py (its step factories, its
cache spec rules over the port's per-layer caches, its serve input specs
as meta tensors) and examples/serve_lm.py (its driver).  A server builds
the LM from a seed, casts it to
the compute dtype once, prefills a batch of random prompts, allocates each
attention layer's KV cache to ``prompt + tokens`` positions with the
prefill's k/v in front (a Mamba layer's cache is its state, as the prompt
leaves it) and runs ``tokens - 1`` decode steps, each writing its token's
k/v or new state into the caches in place.  It serves every registered
arch, and ``NAME-smoke``, NAME's reduced config: the dense archs, the MoE
archs (``deepseek-moe-16b``, ``dbrx-132b``), the audio and vision archs
(``musicgen-large``, ``llava-next-mistral-7b``), jamba
(``jamba-v0.1-52b``) and xLSTM (``xlstm-125m``).  An arch with a frontend
takes a stub frontend input, the first ``frontend_len`` positions of
every prompt: embeddings drawn from the seed as the training data draws
them (``SyntheticLM.frontend_for_step``).  On the card, attention runs
through the hand-written CUDA flash-attention (prefill) and
flash-decoding (decode) kernels, the Mamba prefill through the
selective-scan kernel and the mLSTM prefill through the mLSTM kernel; on
the CPU through their plain torch versions.  The sLSTM is plain torch on
both.

Run::

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --tokens 8
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --arch qwen2-1.5b-smoke
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --arch jamba-v0.1-52b-smoke --dtype float32
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --arch xlstm-125m-smoke --dtype float32
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --arch deepseek-moe-16b-smoke --dtype float32
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --arch llava-next-mistral-7b-smoke --prompt-len 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
        --batch 8 --prompt-len 2048 --tokens 32          # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m \\
        --batch 8 --prompt-len 2048 --tokens 32          # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch musicgen-large \\
        --batch 8 --prompt-len 2048 --tokens 32          # on the card
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional, Tuple

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.smoke import reduce_for_smoke
from repro_torch.data.synthetic import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.modality import frontend_shape

#: examples/serve_lm.py's model, the default
SERVE_DEMO = ModelConfig(name="serve-demo", family="dense", num_layers=4,
                         d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
                         vocab_size=2048, tie_embeddings=True)


def make_prefill_step(model: lm.LM, cache_len: Optional[int] = None):
    def prefill_step(tokens, frontend_embeds=None):
        return lm.prefill_step(model, tokens, cache_len, frontend_embeds)
    return prefill_step


def make_decode_step(model: lm.LM, write_idx: int):
    def decode_step(tokens, caches):
        return lm.decode_step(model, tokens, caches, write_idx)
    return decode_step


def shard_model(model: lm.LM, rules, dmesh) -> lm.LM:
    """Lay every weight of the serving ``model`` over ``dmesh`` by the
    reference's spec of its leaf (``sharding.param_specs`` of the stacked
    layout; layer ``i``'s weight takes its period position's spec without
    the period entry), IN PLACE: each rank keeps its block of the weight
    it holds whole.  Returns ``model``."""
    from repro_torch.launch.sharding import Sharding, param_specs
    from repro_torch.models.partitioning import P
    from repro_torch.models.transformer import block_specs
    pspecs = param_specs(lm.abstract_params(model.cfg), rules)
    n_pos = len(block_specs(model.cfg))
    for mod_name, module in model.named_modules():
        for pname, p in list(module._parameters.items()):
            parts = f"{mod_name}.{pname}".lstrip(".").split(".")
            if parts[0] == "stack":
                key = "/".join(["stack", str(int(parts[2]) % n_pos)]
                               + parts[3:])
                spec = P(*pspecs[key][1:])
            else:
                spec = pspecs["/".join(parts)]
            module._parameters[pname] = torch.nn.Parameter(
                Sharding(dmesh, spec).place(p.detach()), requires_grad=False)
    return model


def bind_stacked(model: lm.LM, leaves) -> lm.LM:
    """Make ``model``'s weights views of ``leaves``, the reference's
    stacked {path: leaf} layout (``lm.init_params``), IN PLACE: layer
    ``i`` reads period ``i // n_pos`` of its position's leaves, a DTensor
    leaf whose period dim the spec rules shard first made whole over the
    mesh (``partitioning.unshard_dim``), as the reference's scan reads its
    stacked weights.  Returns ``model``."""
    from repro_torch.models.partitioning import unshard_dim
    from repro_torch.models.transformer import block_specs
    n_pos = len(block_specs(model.cfg))
    layers_of = {}
    for mod_name, module in model.named_modules():
        for pname in list(module._parameters):
            parts = f"{mod_name}.{pname}".lstrip(".").split(".")
            if parts[0] != "stack":
                w = leaves["/".join(parts)]
            else:
                i = int(parts[2])
                key = "/".join(["stack", str(i % n_pos)] + parts[3:])
                if key not in layers_of:
                    layers_of[key] = unshard_dim(leaves[key], 0).unbind(0)
                w = layers_of[key][i // n_pos]
            module._parameters[pname] = torch.nn.Parameter(
                w, requires_grad=False)
    return model


def shard_caches(caches, cfg, rules, dmesh):
    """The per-layer decode ``caches`` laid over ``dmesh`` by
    ``cache_specs``: a cache each rank holds whole keeps its block, a
    DTensor one (a prefill's on the mesh) is redistributed."""
    from repro_torch.launch.sharding import place, shardings_from_specs
    return place(caches, shardings_from_specs(
        cache_specs(cfg, caches, rules), dmesh))


# ---------------------------------------------------------------------------
# Cache spec rules
# ---------------------------------------------------------------------------
def _cache_rule(name: str, shape) -> tuple:
    """The reference's rule for a cache leaf of ``shape`` in ITS layout,
    stacked over periods (P, ...)."""
    nd = len(shape)
    if name in ("k", "v") and nd == 5:          # attn KV (P,B,S,KH,hd)
        return (None, "dp", "sp", None, None)
    if name == "C" and nd == 5:                  # mlstm matrix memory
        return (None, "dp", None, None, "tp")
    if name == "conv" and nd == 4:               # mamba/mlstm conv window
        return (None, "dp", None, "tp")
    if name == "h" and nd == 4:
        # mamba h (P,B,di,N): tiny state dim last; slstm h (P,B,H,hd)
        if shape[-1] <= 64:
            return (None, "dp", "tp", None)
        return (None, "dp", None, "tp")
    if name in ("c", "n", "h", "m") and nd == 4:  # slstm / mlstm vectors
        return (None, "dp", None, "tp")
    if name == "m" and nd == 3:                   # mlstm stabilizer (P,B,H)
        return (None, "dp", None)
    return (None,) * nd


def cache_specs(cfg, caches_like, rules) -> List[dict]:
    """Specs for the port's caches, one dict a layer (``init_caches``;
    meta tensors do): layer i's leaf gets the reference's spec of its
    period-stacked leaf without the period entry, which is None."""
    from repro_torch.launch.sharding import resolve_spec
    return [{name: resolve_spec(
        leaf.shape, _cache_rule(name, (1,) + tuple(leaf.shape))[1:], rules)
        for name, leaf in layer.items()} for layer in caches_like]


def abstract_caches(cfg, batch: int, seq: int, dtype=torch.bfloat16):
    """``init_caches`` on the meta device: shapes and dtypes, no memory."""
    from repro_torch.models.transformer import init_caches
    return init_caches(cfg, batch, seq, dtype, device="meta")


def serve_input_specs(cfg, shape_cfg, rules):
    """(meta tensors, specs) for the serve path's inputs."""
    from repro_torch.models.modality import frontend_input_name
    from repro_torch.models.partitioning import P
    B, S = shape_cfg.global_batch, shape_cfg.seq_len
    meta = dict(device="meta")
    dp = rules.roles["dp"] or None
    if shape_cfg.kind == "prefill":
        inputs = {"tokens": torch.empty((B, S), dtype=torch.int32, **meta)}
        specs = {"tokens": P(dp, None)}
        if cfg.frontend:
            name = frontend_input_name(cfg)
            inputs[name] = torch.empty((B, cfg.frontend_len, cfg.d_model),
                                       dtype=torch.bfloat16, **meta)
            specs[name] = P(dp, None, None)
        return inputs, specs
    assert shape_cfg.kind == "decode"
    caches = abstract_caches(cfg, B, S)
    inputs = {"tokens": torch.empty((B, 1), dtype=torch.int32, **meta),
              "caches": caches}
    specs = {"tokens": P(dp, None), "caches": cache_specs(cfg, caches, rules)}
    return inputs, specs


def resolve_config(arch: str, dtype: Optional[str] = None) -> ModelConfig:
    """``serve-demo``, a registered arch, or ``NAME-smoke`` for NAME's
    reduced config (``configs.smoke.reduce_for_smoke``); ``dtype``
    overrides the compute dtype."""
    if arch == SERVE_DEMO.name:
        cfg = SERVE_DEMO
    elif arch.endswith("-smoke"):
        cfg = reduce_for_smoke(get_config(arch[:-len("-smoke")]))
    else:
        cfg = get_config(arch)
    return cfg.replace(dtype=dtype) if dtype else cfg


@dataclasses.dataclass
class ServeResult:
    seqs: torch.Tensor          # (B, tokens) generated tokens
    logits: List[torch.Tensor]  # per generated token, (B, V) float32
    prefill_ms: float           # prefill + cache allocation and copy
    decode_ms_per_token: float  # per decode step (one token per sequence)
    tokens_per_s: float         # decoded tokens (batch x steps) per second


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(model: lm.LM, prompts: torch.Tensor, tokens: int,
          frontend_embeds: Optional[torch.Tensor] = None) -> ServeResult:
    """Prefill ``prompts`` (B, P), with ``frontend_embeds`` (B,
    ``frontend_len``, d) over their first positions where the model has a
    frontend, then ``tokens - 1`` greedy decode steps; timed on the host
    clock around work that ends in a synchronize."""
    dev = prompts.device
    B, P = prompts.shape
    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = make_prefill_step(model, P + tokens)(prompts,
                                                          frontend_embeds)
    _sync(dev)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    tok = logits.argmax(dim=-1).to(torch.int32)
    outs, step_logits = [tok], [logits[:, -1]]
    t0 = time.perf_counter()
    for i in range(tokens - 1):
        tok, logits, caches = make_decode_step(model, P + i)(tok, caches)
        outs.append(tok)
        step_logits.append(logits[:, -1])
    _sync(dev)
    dt = time.perf_counter() - t0
    steps = max(tokens - 1, 1)
    return ServeResult(seqs=torch.cat(outs, dim=1), logits=step_logits,
                       prefill_ms=prefill_ms,
                       decode_ms_per_token=dt * 1e3 / steps,
                       tokens_per_s=B * (tokens - 1) / dt if dt > 0 else 0.0)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=SERVE_DEMO.name,
                    help="serve-demo (default), a registered arch, or "
                         "NAME-smoke for its reduced config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", default=None,
                    help="compute dtype (default: the config's, bfloat16)")
    return ap


def frontend_prefix(cfg, batch: int, seed: int, device
                    ) -> Optional[torch.Tensor]:
    """The stub frontend input for ``batch`` prompts, (batch,
    ``cfg.frontend_len``, d) float32 on ``device``, drawn from ``seed`` as
    the training data draws step 0's (``SyntheticLM.frontend_for_step``);
    None for a config without a frontend."""
    if not cfg.frontend:
        return None
    B, P, d = frontend_shape(cfg, batch)
    source = SyntheticLM(DataConfig(cfg.vocab_size, P, B, seed=seed))
    return torch.from_numpy(source.frontend_for_step(0, P, d)).to(device)


def build_server(args) -> Tuple[lm.LM, torch.Tensor, Optional[torch.Tensor]]:
    """The model the flags name, from ``--seed`` and cast once to the
    compute dtype, a batch of random prompts (B, prompt_len), and their
    frontend input (``frontend_prefix``; None without a frontend)."""
    dev = resolve_device(args.device)
    cfg = resolve_config(args.arch, args.dtype)
    if args.prompt_len < cfg.frontend_len:
        raise ValueError(f"--prompt-len {args.prompt_len} is shorter than "
                         f"{cfg.name}'s frontend prefix ({cfg.frontend_len})")
    model = lm.cast_params_for_compute(lm.LM(cfg, seed=args.seed, device=dev))
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=dev, dtype=torch.int32)
    return model, prompts, frontend_prefix(cfg, args.batch, args.seed, dev)


def main(argv=None):
    """Build a server from the flags, serve one batch, print the timings.
    Returns (model, prompts, frontend, ServeResult), ``frontend`` the
    input the prompts were served with (``build_server``'s)."""
    args = build_parser().parse_args(argv)
    model, prompts, frontend = build_server(args)
    cfg, dev = model.cfg, prompts.device
    res = serve(model, prompts, args.tokens, frontend)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[serve] {cfg.name} ({cfg.dtype}) on {name}"
          + (f", a {cfg.frontend} frontend prefix of {cfg.frontend_len} "
             f"positions" if cfg.frontend else ""))
    print(f"[serve] prefill {args.batch}x{args.prompt_len}: "
          f"{res.prefill_ms:.1f} ms")
    print(f"[serve] decoded {args.tokens} tokens/seq x {args.batch} seqs: "
          f"{res.decode_ms_per_token:.2f} ms/token, "
          f"{res.tokens_per_s:.1f} tokens/s")
    for b in range(min(args.batch, 2)):
        print(f"  seq{b}: {res.seqs[b].tolist()}")
    return model, prompts, frontend, res


if __name__ == "__main__":
    main()
