"""Where a window's time goes on the card: torch.profiler over the torch
engine's lockstep windows.

    python -m repro_torch.runtime.profile_window [--procs 4096] [--windows 64]
        [--superstep-windows 1] [--simels 1]

Builds the experiments CLI's configuration (torus, buffer 64, duration
0.02, best-effort), warms the engine up for a few windows, then profiles
``--windows`` windows (whole supersteps with ``--superstep-windows W``) and
prints, as one JSON line: wall seconds per window (profiler on), CUDA
kernel launches per window, the device's busy time per window (the sum of
kernel times), the busy share of the wall time, and the kernels that take
the most device time.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.runtime import experiments
from repro_torch.runtime.config import RunConfig
from repro_torch.runtime.engine import make_engine
from repro_torch.runtime.topologies import make_topology


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="python -m "
                                "repro_torch.runtime.profile_window")
    p.add_argument("--procs", type=int, default=4096)
    p.add_argument("--simels", type=int, default=1)
    p.add_argument("--windows", type=int, default=64)
    p.add_argument("--superstep-windows", type=int, default=1)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_window needs a CUDA device")
    args = experiments.build_parser().parse_args(
        ["--topology", "torus", "--procs", str(a.procs), "--simels",
         str(a.simels), "--buffer", "64", "--duration", "0.02"])
    cfg = experiments._sim_config(args, a.procs)
    W = a.superstep_windows
    eng = make_engine(RunConfig(engine="torch", superstep_windows=W),
                      experiments.make_app("graphcolor", a.procs, a.simels,
                                           make_topology("torus", a.procs),
                                           args.seed), cfg, device="cuda")

    def step(carry):
        if W > 1:
            return eng._superstep_body(carry)
        return eng._window_body_dense(carry)

    carry = eng._init_carry(args.seed)
    for _ in range(max(1, 16 // W)):
        carry = step(carry)
    torch.cuda.synchronize()
    calls = max(1, a.windows // W)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            carry = step(carry)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    windows = calls * W
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kern)
    launches = sum(e.count for e in kern)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:10]
    out = dict(
        procs=a.procs, superstep_windows=W, windows=windows,
        wall_ms_per_window=wall * 1e3 / windows,
        kernel_launches_per_window=launches / windows,
        device_busy_ms_per_window=busy_us / 1e3 / windows,
        device_busy_share=(busy_us / 1e6) / wall if wall > 0 else None,
        top_kernels=[dict(name=e.key[:80], launches=e.count,
                          ms_per_window=e.self_device_time_total / 1e3
                          / windows) for e in top])
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
