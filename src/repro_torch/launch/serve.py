"""Serving entry point: batched prefill, then greedy decode.

The counterpart of src/repro/launch/serve.py (its step factories) and
examples/serve_lm.py (its driver); the reference's cache sharding rules
wait for the mesh slice.  A server builds the LM from a seed, casts it to
the compute dtype once, prefills a batch of random prompts, allocates each
attention layer's KV cache to ``prompt + tokens`` positions with the
prefill's k/v in front (a Mamba layer's cache is its state, as the prompt
leaves it) and runs ``tokens - 1`` decode steps, each writing its token's
k/v or new state into the caches in place.  It serves the dense archs,
jamba (``jamba-v0.1-52b``, and ``jamba-v0.1-52b-smoke``, its reduced
8-layer config) and xLSTM (``xlstm-125m``, and ``xlstm-125m-smoke``, its
reduced 6-layer config).  On the card, attention runs through the
hand-written CUDA flash-attention (prefill) and flash-decoding (decode)
kernels, the Mamba prefill through the selective-scan kernel and the
mLSTM prefill through the mLSTM kernel; on the CPU through their plain
torch versions.  The sLSTM is plain torch on both.

Run::

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --tokens 8
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --arch qwen2-1.5b-smoke
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --arch jamba-v0.1-52b-smoke --dtype float32
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --arch xlstm-125m-smoke --dtype float32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
        --batch 8 --prompt-len 2048 --tokens 32          # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m \\
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
from repro_torch.device import resolve_device
from repro_torch.models import lm

#: examples/serve_lm.py's model, the default
SERVE_DEMO = ModelConfig(name="serve-demo", family="dense", num_layers=4,
                         d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
                         vocab_size=2048, tie_embeddings=True)


def make_prefill_step(model: lm.LM, cache_len: Optional[int] = None):
    def prefill_step(tokens):
        return lm.prefill_step(model, tokens, cache_len)
    return prefill_step


def make_decode_step(model: lm.LM, write_idx: int):
    def decode_step(tokens, caches):
        return lm.decode_step(model, tokens, caches, write_idx)
    return decode_step


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


def serve(model: lm.LM, prompts: torch.Tensor, tokens: int) -> ServeResult:
    """Prefill ``prompts`` (B, P), then ``tokens - 1`` greedy decode steps;
    timed on the host clock around work that ends in a synchronize."""
    dev = prompts.device
    B, P = prompts.shape
    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = make_prefill_step(model, P + tokens)(prompts)
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
                    help="serve-demo (default), a registered dense arch, "
                         "jamba-v0.1-52b or xlstm-125m, or NAME-smoke for "
                         "its reduced config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", default=None,
                    help="compute dtype (default: the config's, bfloat16)")
    return ap


def build_server(args) -> Tuple[lm.LM, torch.Tensor]:
    """The model the flags name, from ``--seed`` and cast once to the
    compute dtype, and a batch of random prompts (B, prompt_len)."""
    dev = resolve_device(args.device)
    cfg = resolve_config(args.arch, args.dtype)
    model = lm.cast_params_for_compute(lm.LM(cfg, seed=args.seed, device=dev))
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=dev, dtype=torch.int32)
    return model, prompts


def main(argv=None):
    """Build a server from the flags, serve one batch, print the timings.
    Returns (model, prompts, ServeResult)."""
    args = build_parser().parse_args(argv)
    model, prompts = build_server(args)
    cfg, dev = model.cfg, prompts.device
    res = serve(model, prompts, args.tokens)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[serve] {cfg.name} ({cfg.dtype}) on {name}")
    print(f"[serve] prefill {args.batch}x{args.prompt_len}: "
          f"{res.prefill_ms:.1f} ms")
    print(f"[serve] decoded {args.tokens} tokens/seq x {args.batch} seqs: "
          f"{res.decode_ms_per_token:.2f} ms/token, "
          f"{res.tokens_per_s:.1f} tokens/s")
    for b in range(min(args.batch, 2)):
        print(f"  seq{b}: {res.seqs[b].tolist()}")
    return model, prompts, res


if __name__ == "__main__":
    main()
