"""Where a training step's time goes on the card: torch.profiler over one
step of ``repro_torch.launch.train``.

    python -m repro_torch.launch.profile_train [--arch qwen2-1.5b]
        [--batch 4] [--seq 2048] [--mode 3] [--compressor topk]

Takes ``train``'s flags (with qwen2-1.5b, batch 4, seq 2048, mode 3 and
the top-k compressor as the defaults; any arch ``train`` takes), builds
the train state as ``run_training`` does (seeded float32 masters,
pod-stacked) and its batches as the ``Pipeline`` does (the frontend input
too, where the arch has one), runs two steps to warm up, then profiles
one step on the third batch and prints
one JSON line: wall ms (profiler on), CUDA kernel launches, the device's
busy ms (the sum of kernel times), the busy share of the wall time, the
kernels that take the most device time and the host-side operations that
take the most CPU time (``profile_serve._summary``), plus the peak device
memory (``profile_step``, which takes any config, a cut one too).  An
arch with sLSTM blocks (``--arch xlstm-125m``) gets a second
line from ``profile_slstm``: one sLSTM layer's share of the step, its
Python loop's launches and busy share.  Needs a CUDA device.
"""
from __future__ import annotations

import json
import time

import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils.checkpoint import checkpoint

from repro_torch.core.modes import AsyncMode
from repro_torch.data.pipeline import Pipeline
from repro_torch.data.synthetic import DataConfig
from repro_torch.launch import train
from repro_torch.launch.profile_serve import _summary
from repro_torch.models import lm, ssm, transformer
from repro_torch.optim.adamw import AdamWConfig


def profile_slstm(cfg, batch: int, seq: int, device) -> dict:
    """One sLSTM layer's work in a train step, alone: its forward, the
    recompute ``cfg.remat`` adds, and its backward, at the arch's width on
    a seeded (batch, seq, d_model) input in the compute dtype, with the
    layer's seeded float32 leaves cast as the step casts them.  Warms up
    once, then profiles one and returns ``_summary``'s record (launches,
    busy share, wall ms) plus the sLSTM layers a step runs."""
    specs = transformer.block_specs(cfg)
    pos = [i for i, (mixer, _) in enumerate(specs) if mixer == "slstm"]
    if not pos:
        raise ValueError(f"{cfg.name} has no sLSTM block")
    params = lm.cast_leaves(lm.init_params(cfg.replace(
        num_layers=len(specs)), seed=0, device=device), cfg)
    prefix = f"stack/{pos[0]}/mixer/"
    p = {k[len(prefix):]: v[0] for k, v in params.items()
         if k.startswith(prefix)}
    del params
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    x = torch.randn((batch, seq, cfg.d_model), generator=gen, device=device
                    ).to(getattr(torch, cfg.dtype))

    def run():
        xi = x.detach().requires_grad_(True)
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        fwd = (checkpoint(ssm.slstm_forward, leaves, xi, cfg,
                          use_reentrant=False)
               if cfg.remat else ssm.slstm_forward(leaves, xi, cfg))
        fwd.float().sum().backward()

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return dict(arch=cfg.name, dtype=cfg.dtype, batch=batch, seq=seq,
                slstm_layers_per_step=len(pos) * (cfg.num_layers
                                                   // len(specs)),
                device=torch.cuda.get_device_name(device),
                **_summary(prof, wall, 1, "slstm_layer_train"))


def profile_step(cfg, spec, batch: int, seq: int, n_pods: int = 1, *,
                 device, seed: int = 0) -> dict:
    """Build ``cfg``'s train state as ``run_training`` does and its
    batches as the ``Pipeline`` does, run two steps to warm up, profile
    one step on the third batch; returns the record ``main`` prints (any
    config, a cut one too: ``chip_smoke.py``'s phase 16 profiles jamba's
    one period without experts with it)."""
    pipeline = Pipeline(DataConfig(cfg.vocab_size, seq, batch, seed=seed),
                        cfg, device=device)

    def next_batch():
        return {n: v.reshape(n_pods, batch // n_pods, *v.shape[1:])
                for n, v in next(pipeline)[1].items()}

    torch.cuda.reset_peak_memory_stats(device)
    state = train.init_train_state(cfg, spec, n_pods, seed=seed,
                                   device=device)
    step = train.make_train_step(cfg, spec, n_pods)
    for _ in range(2):
        state, _ = step(state, next_batch())
    third = next_batch()
    pipeline.close()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = step(state, third)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    del state
    return dict(arch=cfg.name, dtype=cfg.dtype, batch=batch, seq=seq,
                mode=int(spec.mode), compressor=spec.compressor,
                n_pods=n_pods, device=torch.cuda.get_device_name(device),
                loss=float(metrics["loss"]),
                peak_memory_gib=(torch.cuda.max_memory_allocated(device)
                                 / 2 ** 30),
                **_summary(prof, wall, 1, "train_step"))


def main(argv=None) -> dict:
    p = train.build_parser()
    p.prog = "python -m repro_torch.launch.profile_train"
    p.set_defaults(arch="qwen2-1.5b", batch=4, seq=2048, mode=3,
                   compressor="topk")
    a = p.parse_args(argv)
    if torch.device(a.device).type != "cuda":
        p.error("profile_train profiles the card: --device cuda")
    dev = torch.device(a.device)
    cfg = train.resolve_config(a.arch)
    spec = train.TrainSpec(mode=AsyncMode(a.mode),
                           adamw=AdamWConfig(lr=a.lr, warmup_steps=20,
                                             total_steps=a.steps),
                           compressor=(None if a.compressor == "none"
                                       else a.compressor))
    rec = profile_step(cfg, spec, a.batch, a.seq, a.n_pods, device=dev,
                       seed=a.seed)
    print(json.dumps(rec))
    if any(m == "slstm" for m, _ in transformer.block_specs(cfg)):
        print(json.dumps(profile_slstm(cfg, a.batch // a.n_pods, a.seq,
                                       dev)))
    return rec

if __name__ == "__main__":
    main()
