"""Where a serving step's time goes on the card: torch.profiler over one
prefill and a few decode steps of ``repro_torch.launch.serve``.

    python -m repro_torch.launch.profile_serve [--arch qwen2-1.5b]
        [--batch 8] [--prompt-len 2048] [--steps 8] [--dtype bfloat16]

Takes ``serve``'s flags (with qwen2-1.5b, batch 8 and prompt 2048 as the
defaults) plus ``--steps``, builds the server as ``serve.main`` does
(``serve.build_server``: seeded weights cast once to the compute dtype,
random prompts), warms it up with one prefill and two
decode steps, then profiles one prefill (with the cache allocation and
copy) and ``--steps`` decode steps, and prints one JSON line for each:
wall ms per call (profiler on), CUDA kernel launches per call, the
device's busy ms per call (the sum of kernel times), the busy share of the
wall time, the kernels that take the most device time, and the host-side
operations that take the most CPU time.  Needs a CUDA device.
``profile_serving(model, prompts, steps[, frontend_embeds])`` does the
same for a model built by the caller (``chip_smoke.py`` profiles the
one-period full-width jamba and dbrx-132b's 8 layers with it).  ``--arch
xlstm-125m`` profiles xLSTM at full width and depth; an arch with a
frontend is profiled with its prefix.
"""
from __future__ import annotations

import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.launch import serve
from repro_torch.models import lm


def _summary(prof, wall: float, calls: int, label: str) -> dict:
    events = prof.key_averages()
    kern = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kern)
    host = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CPU]
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:10]
    top_host = sorted(host, key=lambda e: -e.self_cpu_time_total)[:10]
    return dict(
        phase=label, calls=calls, wall_ms_per_call=wall * 1e3 / calls,
        kernel_launches_per_call=sum(e.count for e in kern) / calls,
        device_busy_ms_per_call=busy_us / 1e3 / calls,
        device_busy_share=(busy_us / 1e6) / wall if wall > 0 else None,
        top_kernels=[dict(name=e.key[:80], launches=e.count,
                          ms_per_call=e.self_device_time_total / 1e3 / calls)
                     for e in top],
        top_host_ops=[dict(name=e.key[:60], count=e.count,
                           ms_per_call=e.self_cpu_time_total / 1e3 / calls)
                      for e in top_host])


def profile_serving(model: lm.LM, prompts: torch.Tensor, steps: int,
                    frontend_embeds=None) -> list:
    """Warm ``model`` up with one prefill of ``prompts`` (B, P) (with
    ``frontend_embeds`` over their first positions where the model has a
    frontend) and two decode steps, then profile one prefill (with the
    cache allocation and copy) and ``steps`` decode steps; returns one
    summary for each (see the module's docstring).  Works for any model
    the server serves."""
    B, P = prompts.shape

    def prefill():
        logits, caches = lm.prefill_step(model, prompts, P + steps + 2,
                                         frontend_embeds)
        return logits.argmax(dim=-1).to(torch.int32), caches

    def decode(tok, caches, n, start):
        for i in range(n):
            tok, _, caches = lm.decode_step(model, tok, caches, start + i)
        return tok

    tok, caches = prefill()
    tok = decode(tok, caches, 2, P)
    torch.cuda.synchronize()
    out = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prefill()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out.append(_summary(prof, wall, 1, "prefill"))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        decode(tok, caches, steps, P + 2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out.append(_summary(prof, wall, steps, "decode"))
    cfg = model.cfg
    for rec in out:
        print(json.dumps(dict(arch=cfg.name, dtype=cfg.dtype, batch=B,
                              prompt_len=P,
                              device=torch.cuda.get_device_name(
                                  prompts.device),
                              **rec)))
    return out


def main(argv=None) -> list:
    p = serve.build_parser()
    p.prog = "python -m repro_torch.launch.profile_serve"
    p.add_argument("--steps", type=int, default=8)
    p.set_defaults(arch="qwen2-1.5b", batch=8, prompt_len=2048)
    a = p.parse_args(argv)
    if torch.device(a.device).type != "cuda":
        p.error("profile_serve profiles the card: --device cuda")
    model, prompts, frontend = serve.build_server(a)
    return profile_serving(model, prompts, a.steps, frontend)


if __name__ == "__main__":
    main()
