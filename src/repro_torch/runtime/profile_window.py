"""Where a window's time goes on the card: torch.profiler over the torch
engine's lockstep windows.

    python -m repro_torch.runtime.profile_window [--procs 4096] [--windows 64]
        [--superstep-windows 1] [--simels 1] [--layout auto|dense|edge]
        [--app graphcolor|evo] [--shards 1] [--scheduler auto|pipelined]
        [--arrival-rate 0] [--replicates 1]

Builds the experiments CLI's configuration (torus, buffer 64, duration
0.02, best-effort) for the given app and duct layout (``--app evo
--simels 3600`` is the paper's digital-evolution workload; ``--layout
edge`` the edge-major window), warms the engine up for a few windows, then
profiles
``--windows`` windows (whole supersteps with ``--superstep-windows W``) and
prints, as one JSON line: wall seconds per window (profiler on), CUDA
kernel launches per window, the device's busy time per window (the sum of
kernel times), the busy share of the wall time, and the kernels that take
the most device time.  With ``--shards S`` > 1 it profiles the sharded
engine's supersteps (``--scheduler pipelined`` the double-buffered one)
and adds what the hops cost: hops per window, and the host time and the
device time of the kernels inside a ``record_function`` range around
``mesh.hop``.  ``--arrival-rate R`` > 0 feeds every process open-loop
arrivals at R a virtual second (the serve family's poisson traffic), so
the window carries the serve hook; 0 profiles the window without it.
``--replicates R`` profiles a batch of R seeds (``--seed`` onward) in one
carry, as ``run_replicates`` runs them: the launches a window should equal
R = 1's, and the output adds the duct kernels' launches a window
(``duct_launches_per_window``, counted by the kernels' wrappers).  Needs a
CUDA device.
"""
from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.kernels.duct_exchange.kernel import LAUNCHES
from repro_torch.launch import mesh
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
    p.add_argument("--layout", default="auto",
                   choices=["auto", "dense", "edge"])
    p.add_argument("--app", default="graphcolor",
                   choices=["graphcolor", "evo"])
    p.add_argument("--shards", type=int, default=1)
    p.add_argument("--scheduler", default="auto",
                   choices=["auto", "pipelined"])
    p.add_argument("--arrival-rate", type=float, default=0.0,
                   help="open-loop arrivals per process per virtual second "
                        "(0: no serve hook in the window)")
    p.add_argument("--replicates", type=int, default=1,
                   help="seeds in the batch the windows run over")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_window needs a CUDA device")
    args = experiments.build_parser().parse_args(
        ["--topology", "torus", "--procs", str(a.procs), "--simels",
         str(a.simels), "--buffer", "64", "--duration", "0.02"])
    cfg = experiments._sim_config(args, a.procs,
                                  arrival_rate=a.arrival_rate)
    W = a.superstep_windows
    sharded = a.shards > 1
    eng = make_engine(RunConfig(engine="torch", layout=a.layout,
                                superstep_windows=W, shards=a.shards,
                                scheduler=a.scheduler),
                      experiments.make_app(a.app, a.procs, a.simels,
                                           make_topology("torus", a.procs),
                                           args.seed), cfg, device="cuda")

    def step(carry):
        if sharded:
            return eng._superstep(carry)
        if W > 1:
            return eng._superstep_body(carry)
        if eng.layout == "edge":
            return eng._window_body(carry)
        return eng._window_body_dense(carry)

    carry = eng._init_batch(range(args.seed, args.seed + a.replicates))
    if sharded:
        carry = eng._to_sharded_layout(carry)
    for _ in range(max(1, 16 // W)):
        carry = step(carry)
    torch.cuda.synchronize()
    calls = max(1, a.windows // W)
    real_hop, hops = mesh.hop, [0]

    def hop(x, off, dim=0, group=None):
        hops[0] += 1
        with record_function("mesh.hop"):
            return real_hop(x, off, dim, group)

    mesh.hop = hop
    duct0 = sum(LAUNCHES.values())
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                carry = step(carry)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        mesh.hop = real_hop
    duct = sum(LAUNCHES.values()) - duct0
    windows = calls * W
    events = prof.key_averages()
    kern = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kern)
    launches = sum(e.count for e in kern)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:10]
    out = dict(
        procs=a.procs, app=a.app, simels=a.simels, layout=eng.layout,
        arrival_rate=a.arrival_rate, replicates=a.replicates,
        superstep_windows=W, windows=windows,
        wall_ms_per_window=wall * 1e3 / windows,
        kernel_launches_per_window=launches / windows,
        duct_launches_per_window=duct / windows,
        device_busy_ms_per_window=busy_us / 1e3 / windows,
        device_busy_share=(busy_us / 1e6) / wall if wall > 0 else None,
        top_kernels=[dict(name=e.key[:80], launches=e.count,
                          ms_per_window=e.self_device_time_total / 1e3
                          / windows) for e in top])
    if sharded:
        # the hops' range: its host time, and the device time of the
        # kernels launched inside it
        hop_ev = [e for e in events if e.key == "mesh.hop"]
        out.update(
            shards=a.shards, scheduler=eng.scheduler,
            hops_per_window=hops[0] / windows,
            hop_host_ms_per_window=sum(e.cpu_time_total for e in hop_ev)
            / 1e3 / windows,
            hop_device_ms_per_window=sum(e.device_time_total
                                         for e in hop_ev) / 1e3 / windows)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
