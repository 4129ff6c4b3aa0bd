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
memory.  Needs a CUDA device.
"""
from __future__ import annotations

import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core.modes import AsyncMode
from repro_torch.data.pipeline import Pipeline
from repro_torch.data.synthetic import DataConfig
from repro_torch.launch import train
from repro_torch.launch.profile_serve import _summary
from repro_torch.optim.adamw import AdamWConfig


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
    pipeline = Pipeline(DataConfig(cfg.vocab_size, a.seq, a.batch,
                                   seed=a.seed), cfg, device=dev)

    def batch():
        return {n: v.reshape(a.n_pods, a.batch // a.n_pods, *v.shape[1:])
                for n, v in next(pipeline)[1].items()}

    torch.cuda.reset_peak_memory_stats(dev)
    state = train.init_train_state(cfg, spec, a.n_pods, seed=a.seed,
                                   device=dev)
    step = train.make_train_step(cfg, spec, a.n_pods)
    for _ in range(2):
        state, _ = step(state, batch())
    third = batch()
    pipeline.close()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = step(state, third)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rec = dict(arch=cfg.name, dtype=cfg.dtype, batch=a.batch, seq=a.seq,
               mode=a.mode, compressor=a.compressor, n_pods=a.n_pods,
               device=torch.cuda.get_device_name(dev),
               loss=float(metrics["loss"]),
               peak_memory_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
               **_summary(prof, wall, 1, "train_step"))
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
