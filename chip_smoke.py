"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA GPU::

    python3 chip_smoke.py

It drives the port's main path (the vectorized best-effort engine with the
hand-written CUDA ``duct_window`` / ``duct_commit`` kernels) and fails with
a non-zero exit code if any phase fails:

  1. card      the ``nvidia-smi`` name and power limit
  2. build     both kernels from ``csrc/`` into ``build/`` (one nvcc per
               source, started together)
  3. kernels   each kernel against its plain torch version on the same
               CUDA inputs at the main path's shapes, bitwise, with median
               CUDA-event times of both
  4. oracle    dyadic 16-process scenarios: the torch engine on the card
               gives the event simulator's ``qos_signature``
  5. card=cpu  torus-1024 (64 simels, L=8) and smallworld-1024 on the card
               (kernels) and on the CPU (plain versions): equal SimResults
  6. full size torus 64x64 = 4096 processes, 1 simel, buffer 64, duration
               0.02, best-effort, per-window and --superstep-windows 8;
               launch counters are zeroed before and read after

It imports nothing of JAX or of the JAX package.  The line before the last
is a JSON object with one record per kernel; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import zlib

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "src"))

from repro_torch.apps.graphcolor import (  # noqa: E402
    GraphColorApp,
    GraphColorConfig,
)
from repro_torch.core.modes import AsyncMode  # noqa: E402
from repro_torch.core.qos import aggregate_reports, qos_signature  # noqa: E402
from repro_torch.kernels.duct_exchange import kernel as K  # noqa: E402
from repro_torch.kernels.duct_exchange.ops import (  # noqa: E402
    duct_commit,
    duct_commit_torch,
    duct_window,
    duct_window_torch,
)
from repro_torch.runtime import experiments  # noqa: E402
from repro_torch.runtime.config import RunConfig  # noqa: E402
from repro_torch.runtime.engine import make_engine  # noqa: E402
from repro_torch.runtime.faults import (  # noqa: E402
    FaultModel,
    crashed_host,
    lossy_host,
)
from repro_torch.runtime.simulator import SimConfig  # noqa: E402
from repro_torch.runtime.topologies import make_topology  # noqa: E402

#: HBM bandwidth by SKU (NVIDIA data sheets); the card's name picks the row
HBM_BYTES_PER_S = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12,
                   "H100": 3.35e12, "H200": 4.8e12}
#: float32 peak outside the tensor cores (H100 SXM data sheet); the duct
#: kernels' integer compares and copies are counted against it
PEAK_OPS_PER_S = 67e12

#: dyadic timing constants (power-of-two, no stochastic clocks): float32
#: and float64 clock arithmetic are exact, so every engine agrees bitwise
DYADIC = dict(
    duration=2.0 ** -7, base_compute=2.0 ** -16,
    per_message_cost=2.0 ** -23, per_pull_cost=2.0 ** -22,
    base_latency=2.0 ** -13, barrier_base=2.0 ** -15,
    barrier_per_log2=2.0 ** -16, rolling_quantum=2.0 ** -11,
    fixed_interval=2.0 ** -10, snapshot_warmup=2.0 ** -10,
    snapshot_interval=2.0 ** -11, jitter_sigma=0.0, stall_prob=0.0,
    latency_sigma=0.0)
QUARANTINE_TAU = 2.0 ** -10
EXACT_MAX_POPS = 64

PHASES = []


def phase(name):
    """Decorator: run a phase, print its wall time; any exception fails
    the whole script (no phase failure is turned into a pass)."""
    def wrap(fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            dt = time.perf_counter() - t0
            PHASES.append((name, dt))
            print(f"[phase {name}] ok in {dt:.1f}s", flush=True)
            return out
        return run
    return wrap


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------------------
# 1. card
# ---------------------------------------------------------------------------
@phase("card")
def card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {name} count {torch.cuda.device_count()}")
    hbm = next(v for k, v in HBM_BYTES_PER_S.items() if k in name) \
        if any(k in name for k in HBM_BYTES_PER_S) else 3.35e12
    return smi, name, hbm


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------
@phase("build")
def build():
    secs = K.build()
    for name in K.SOURCES:
        check(K.library_path(name).exists(), f"{name} library missing")
    print(f"built {sorted(K.SOURCES)} in {secs:.1f}s into {K.BUILD_DIR}")


# ---------------------------------------------------------------------------
# 3. kernels vs plain, bitwise, with times
# ---------------------------------------------------------------------------
def window_state(rng, n, d, C, L, cap, dev):
    """Random dense ring state as the tests build it (vectorized): live
    FIFO prefixes from a random head, an engine-style staged push."""
    head = rng.integers(0, C, (n, d)).astype(np.int32)
    size = rng.integers(0, cap, (n, d)).astype(np.int32)
    off = (np.arange(C)[None, None, :] - head[..., None]) % C
    live = off < size[..., None]
    qa = np.where(live, rng.random((n, d, C)) * 2, np.inf).astype(np.float32)
    qt = np.where(live, rng.integers(0, 50, (n, d, C)), 0).astype(np.int32)
    qp = np.where(live[..., None], rng.integers(0, 99, (n, d, C, L)),
                  0).astype(np.int32)
    pacc = (rng.random((n, d)) < 0.7) & (size < cap)
    ppos = ((head + size) % C).astype(np.int32)
    size = (size + pacc).astype(np.int32)
    pav = (rng.random((n, d)) * 2).astype(np.float32)
    ptch = rng.integers(0, 50, (n, d)).astype(np.int32)
    ppay = rng.integers(0, 99, (n, d, L)).astype(np.int32)
    rnow = (rng.random(n) * 2).astype(np.float32)
    ract = rng.random(n) < 0.8
    return [torch.as_tensor(a, device=dev) for a in
            (qa, qt, qp, head, size, ppos, pacc, pav, ptch, ppay, rnow, ract)]


def commit_state(rng, R, C, L, W, dev):
    qa = (rng.random((R, C)) * 2).astype(np.float32)
    qt = rng.integers(0, 50, (R, C)).astype(np.int32)
    qp = rng.integers(0, 99, (R, C, L)).astype(np.int32)
    head = rng.integers(0, C, R).astype(np.int32)
    size0 = rng.integers(0, C, R).astype(np.int32)
    cnt = np.minimum(rng.integers(0, W + 1, R), C - size0).astype(np.int32)
    pa = (rng.random((R, W)) * 2).astype(np.float32)
    pt = rng.integers(0, 50, (R, W)).astype(np.int32)
    pp = rng.integers(0, 99, (R, W, L)).astype(np.int32)
    return [torch.as_tensor(a, device=dev) for a in
            (qa, qt, qp, head, size0, cnt, pa, pt, pp)]


def median_ms(fn, runs=30, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def compare(want, got):
    """(mismatching elements, max |difference|) over every output field."""
    bad, err = 0, 0.0
    for a, b in zip(want, got):
        eq = (a == b) | ((a != a) & (b != b))
        bad += int((~eq).sum())
        if not bool(eq.all()):
            d = (a.double() - b.double()).abs()
            err = max(err, float(torch.where(eq, 0.0, d).max()))
    return bad, err


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


@phase("kernels")
def kernels(hbm):
    dev = torch.device("cuda")
    rng = np.random.default_rng(2024)
    records = {}
    # (label, n, d, C, L, max_pops): torus-4096 buckets at L = 1 (the main
    # path's shape) and L = 8, and a degree-8 bucket
    for label, n, d, C, L, pops in (("torus4096-L1", 4096, 4, 64, 1, 16),
                                    ("torus4096-L8", 4096, 4, 64, 8, 16),
                                    ("deg8-L1", 2048, 8, 64, 1, 16)):
        args = window_state(rng, n, d, C, L, 64, dev)
        want = duct_window_torch(*args, max_pops=pops)
        got = duct_window(*args, max_pops=pops)
        torch.cuda.synchronize()
        bad, err = compare(want, got)
        check(bad == 0, f"duct_window {label}: {bad} mismatching elements")
        ms = median_ms(lambda: duct_window(*args, max_pops=pops))
        plain = median_ms(lambda: duct_window_torch(*args, max_pops=pops))
        moved = nbytes(*args) + nbytes(*got)
        ops = n * d * C * (8 + 2 * L)
        bound = max(moved / hbm, ops / PEAK_OPS_PER_S) * 1e3
        print(f"duct_window {label}: 0 mismatches, kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms, bound {bound:.4f} ms "
              f"({moved / 1e6:.1f} MB moved)", flush=True)
        if label == "torus4096-L1":
            records["duct_window"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                bound_by="bytes" if moved / hbm >= ops / PEAK_OPS_PER_S
                else "operations")
    for label, R, C, L, W in (("R16384-W8", 16384, 64, 1, 8),
                              ("R16384-W8-L8", 16384, 64, 8, 8)):
        args = commit_state(rng, R, C, L, W, dev)
        want = duct_commit_torch(*args)
        got = duct_commit(*args)
        torch.cuda.synchronize()
        bad, err = compare(want, got)
        check(bad == 0, f"duct_commit {label}: {bad} mismatching elements")
        ms = median_ms(lambda: duct_commit(*args))
        plain = median_ms(lambda: duct_commit_torch(*args))
        moved = nbytes(*args) + nbytes(*got)
        ops = R * C * (6 + L)
        bound = max(moved / hbm, ops / PEAK_OPS_PER_S) * 1e3
        print(f"duct_commit {label}: 0 mismatches, kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms, bound {bound:.4f} ms "
              f"({moved / 1e6:.1f} MB moved)", flush=True)
        if label == "R16384-W8":
            records["duct_commit"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                bound_by="bytes" if moved / hbm >= ops / PEAK_OPS_PER_S
                else "operations")
    return records


# ---------------------------------------------------------------------------
# 4. oracle on the card
# ---------------------------------------------------------------------------
def case_seed(topology: str, seed: int = 0) -> int:
    return ((zlib.crc32(topology.encode("ascii")) & 0x7F) << 8) | (seed & 0xFF)


def gc_app(n, topology, seed, simels=1):
    return GraphColorApp(
        GraphColorConfig(n_processes=n, nodes_per_process=simels, seed=seed),
        topology=make_topology(topology, n))


def dyadic_cfg(**kw):
    return SimConfig(**{**DYADIC, **kw})


@phase("oracle")
def oracle():
    scenarios = [
        ("torus-best-effort", "torus", AsyncMode.BEST_EFFORT, None, 0.0),
        ("ring-barrier-victim-fault", "ring", AsyncMode.BARRIER_EVERY_STEP,
         lambda t: FaultModel(compute_slowdown={1: 8.0}), 0.0),
        ("cliques-best-effort-lossy", "cliques", AsyncMode.BEST_EFFORT,
         lambda t: lossy_host(t, 0, 0.25), 0.0),
        ("torus-fixed-crash-quarantine", "torus", AsyncMode.FIXED_BARRIER,
         lambda t: crashed_host(t, 0), QUARANTINE_TAU),
    ]
    for name, topology, mode, fault, tau in scenarios:
        seed = case_seed(topology)
        cfg = dyadic_cfg(mode=mode, seed=seed, barrier_timeout=tau)

        def faults():
            return fault(make_topology(topology, 16)) if fault else None

        want = qos_signature(make_engine(
            "event", gc_app(16, topology, seed), cfg, faults()).run())
        got = qos_signature(make_engine(
            "torch", gc_app(16, topology, seed), cfg, faults(),
            max_pops=EXACT_MAX_POPS, chunk=64, device="cuda").run())
        want.pop("quality")
        got.pop("quality")
        check(got == want, f"{name}: torch on the card != event oracle")
        check(sum(got["updates"]) > 0, f"{name}: no updates")
        print(f"{name}: qos_signature == event oracle "
              f"({sum(got['updates'])} updates, {got['sent']} sent)",
              flush=True)


# ---------------------------------------------------------------------------
# 5. end to end, card vs CPU
# ---------------------------------------------------------------------------
@phase("card_vs_cpu")
def card_vs_cpu():
    for topology, simels in (("torus", 64), ("smallworld", 1)):
        seed = case_seed(topology)
        cfg = dyadic_cfg(seed=seed)
        sig = {}
        for device in ("cuda", "cpu"):
            K.reset_launches()
            t0 = time.perf_counter()
            res = make_engine("torch", gc_app(1024, topology, seed, simels),
                              cfg, chunk=64, device=device).run()
            dt = time.perf_counter() - t0
            sig[device] = qos_signature(res)
            launched = sum(K.LAUNCHES.values())
            check((launched > 0) == (device == "cuda"),
                  f"{topology} on {device}: {launched} kernel launches")
            print(f"{topology}-1024 simels={simels} {device}: "
                  f"{sum(res.updates)} updates, quality {res.quality}, "
                  f"{dt:.1f}s wall, {launched} kernel launches", flush=True)
        check(sig["cuda"] == sig["cpu"],
              f"{topology}-1024: card and CPU SimResults differ")
        print(f"{topology}-1024: card == CPU (full SimResult incl. quality)")


# ---------------------------------------------------------------------------
# 6. full size: the paper's experiment at the headline scale
# ---------------------------------------------------------------------------
@phase("full_size")
def full_size(records):
    argv = ["--engine", "torch", "--device", "cuda", "--topology", "torus",
            "--procs", "4096", "--simels", "1", "--buffer", "64",
            "--duration", "0.02"]
    args = experiments.build_parser().parse_args(argv)
    n = 4096
    topo = make_topology("torus", n)
    cfg = experiments._sim_config(args, n)
    runs = {}
    K.reset_launches()           # zeroed just before the main path
    for label, w in (("window", 1), ("superstep8", 8)):
        before = dict(K.LAUNCHES)
        eng = make_engine(RunConfig(engine="torch", superstep_windows=w),
                          experiments.make_app("graphcolor", n, 1, topo,
                                               args.seed), cfg,
                          device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES}
        dist = aggregate_reports(res.qos)
        updates = sum(res.updates)
        runs[label] = res
        med = {m: dist[m]["median"] for m in dist}
        windows = eng.windows[-1]
        kernel_ms = sum(launches[k] * records[k]["ms"] for k in launches)
        print(f"full size {label}: {updates} updates, "
              f"{updates / wall:.0f} updates/s, {wall:.2f}s wall, "
              f"{windows} windows ({wall * 1e3 / windows:.3f} ms/window), "
              f"delivery failure rate {res.delivery_failure_rate:.4f}, "
              f"launches {launches}, duct kernels ~{kernel_ms:.1f} ms "
              f"({100 * kernel_ms / (wall * 1e3):.2f}% of wall)",
              flush=True)
        print(f"full size {label} QoS medians: {json.dumps(med)}",
              flush=True)
        # the per-window path drains through duct_window; the W-fused
        # path drains frozen rings + pushbuf and commits with duct_commit
        used = "duct_commit" if w > 1 else "duct_window"
        check(launches[used] > 0, f"{label}: {used} never launched")
    launched = dict(K.LAUNCHES)  # read just after the main path
    check(runs["window"].updates == runs["superstep8"].updates,
          "W-invariance: per-window and superstep updates differ")
    same = qos_signature(runs["window"]) == qos_signature(runs["superstep8"])
    print(f"W-invariance: updates equal; full signature equal: {same}")
    check(same, "W-invariance: per-window and superstep SimResults differ")
    for k, v in launched.items():
        check(v > 0, f"{k} was launched no time on the main path")
    return launched


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi, name, hbm = card()
    build()
    records = kernels(hbm)
    oracle()
    card_vs_cpu()
    launched = full_size(records)
    kernels_line = []
    for kname, replaces in (
            ("duct_window", "src/repro/kernels/duct_exchange/kernel.py:81"),
            ("duct_commit", "src/repro/kernels/duct_exchange/kernel.py:197")):
        rec = records[kname]
        kernels_line.append(dict(
            name=kname, route="cuda",
            source=f"src/repro_torch/kernels/duct_exchange/csrc/"
                   f"{K.SOURCES[kname]}",
            replaces=replaces, launches=launched[kname],
            max_abs_err=rec["max_abs_err"], ms=rec["ms"],
            plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], library_ms=None))
    print("phases: " + ", ".join(f"{p} {t:.1f}s" for p, t in PHASES))
    print(smi)
    print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
