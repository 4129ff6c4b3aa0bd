"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA GPU::

    python3 chip_smoke.py

It drives the port's main paths (the vectorized best-effort engine on the
dense layout with the hand-written CUDA ``duct_window`` / ``duct_commit``
kernels, on the edge-major layout with the ``duct_exchange`` kernel, with
the graph-coloring app's int32 halos and the evo app's float32 halos; and
the dense LM's serving path, prefill through the ``flash_attention`` kernel
and greedy decode through the ``decode_attention`` kernel) and fails with
a non-zero exit code if any phase fails:

  1. card      the ``nvidia-smi`` name and power limit
  2. build     the five kernels from ``csrc/`` into ``build/`` (one nvcc
               per source, started together)
  3. kernels   each kernel, and each float32 entry point, against its plain
               torch version on the same CUDA inputs at the main paths'
               shapes, with the device time of both (torch.profiler), their
               time per call with launch overhead (CUDA events) and the
               bound: the duct kernels bitwise, ``duct_exchange`` in its
               full and both degenerate (drain-only, send-only) forms; the
               attention kernels within a stated tolerance, with the time
               of the one PyTorch call that computes the same function
               (``scaled_dot_product_attention``) beside them
  4. oracle    dyadic 16-process scenarios on both duct layouts: the torch
               engine on the card gives the event simulator's
               ``qos_signature``
  5. card=cpu  torus-1024 (64 simels, L=8), smallworld-1024, torus-1024 on
               the edge layout, and evo on a 64-process torus (dense, W=4,
               edge) on the card (kernels) and on the CPU (plain
               versions): equal SimResults
  6. full size graph coloring on the torus 64x64 = 4096 processes, 1
               simel, buffer 64, duration 0.02, best-effort: per-window
               dense, --superstep-windows 8 and --layout edge (all three
               equal); evo at the paper's 3600 cells per process on the
               torus-1024, duration 0.005: per-window dense,
               --superstep-windows 8 and --layout edge (all three equal).
               Launch counters are zeroed just before each path and read
               just after it
  7. lm card=cpu  the reduced qwen2-1.5b and qwen3-0.6b (2 layers) served
               on the card (kernels) and on the CPU (plain versions) from
               the same seeded weights: logits at every step with teacher
               forcing, equal greedy tokens in float32
  8. lm full size  qwen2-1.5b at full width in bf16 through
               ``repro_torch.launch.serve``: batch 8, prompt 2048, 32 new
               tokens; 28 flash launches per prefill, 28 decode launches
               per step; prefill of the prompt plus k generated tokens
               gives decode step k's logits; a second serve gives the same
               tokens

It imports nothing of JAX or of the JAX package.  The line before the last
is a JSON object with one record per kernel and float32 entry point; the
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import copy
import json
import os
import statistics
import subprocess
import sys
import time
import zlib

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "src"))

from repro_torch.apps.graphcolor import (  # noqa: E402
    GraphColorApp,
    GraphColorConfig,
)
from repro_torch.core.modes import AsyncMode  # noqa: E402
from repro_torch.core.qos import aggregate_reports, qos_signature  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.smoke import reduce_for_smoke  # noqa: E402
from repro_torch.kernels import build as K  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_partials,
    decode_attention_partials_torch,
    decode_attention_torch,
)
from repro_torch.kernels.duct_exchange.ops import (  # noqa: E402
    duct_commit,
    duct_commit_torch,
    duct_drain,
    duct_drain_torch,
    duct_exchange,
    duct_exchange_torch,
    duct_send,
    duct_send_torch,
    duct_window,
    duct_window_torch,
)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_grouped,
    flash_attention_torch,
)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm  # noqa: E402
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
#: kernels' integer compares and copies are counted against it, and so are
#: the attention kernels' float32 entry points
PEAK_OPS_PER_S = 67e12
#: bf16 dense tensor-core peak (H100 SXM data sheet): the attention
#: kernels' bf16 bound, whatever units they run on
PEAK_BF16_FLOPS = 989e12

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
    check(len(K.SOURCES) == 5, f"expected five kernels, got {K.SOURCES}")
    print(f"built {sorted(K.SOURCES)} in {secs:.1f}s into {K.BUILD_DIR}")


# ---------------------------------------------------------------------------
# 3. kernels vs plain, bitwise, with times
# ---------------------------------------------------------------------------
def payload(rng, shape, dtype):
    """Random payloads: small ints for int32, normals for float32."""
    if dtype == np.float32:
        return rng.standard_normal(shape, dtype=np.float32)
    return rng.integers(0, 99, shape).astype(np.int32)


def window_state(rng, n, d, C, L, cap, dev, pay=np.int32):
    """Random dense ring state as the tests build it (vectorized): live
    FIFO prefixes from a random head, an engine-style staged push."""
    head = rng.integers(0, C, (n, d)).astype(np.int32)
    size = rng.integers(0, cap, (n, d)).astype(np.int32)
    off = (np.arange(C)[None, None, :] - head[..., None]) % C
    live = off < size[..., None]
    qa = np.where(live, rng.random((n, d, C)) * 2, np.inf).astype(np.float32)
    qt = np.where(live, rng.integers(0, 50, (n, d, C)), 0).astype(np.int32)
    qp = np.where(live[..., None], payload(rng, (n, d, C, L), pay),
                  0).astype(pay)
    pacc = (rng.random((n, d)) < 0.7) & (size < cap)
    ppos = ((head + size) % C).astype(np.int32)
    size = (size + pacc).astype(np.int32)
    pav = (rng.random((n, d)) * 2).astype(np.float32)
    ptch = rng.integers(0, 50, (n, d)).astype(np.int32)
    ppay = payload(rng, (n, d, L), pay)
    rnow = (rng.random(n) * 2).astype(np.float32)
    ract = rng.random(n) < 0.8
    return [torch.as_tensor(a, device=dev) for a in
            (qa, qt, qp, head, size, ppos, pacc, pav, ptch, ppay, rnow, ract)]


def commit_state(rng, R, C, L, W, dev, pay=np.int32):
    qa = (rng.random((R, C)) * 2).astype(np.float32)
    qt = rng.integers(0, 50, (R, C)).astype(np.int32)
    qp = payload(rng, (R, C, L), pay)
    head = rng.integers(0, C, R).astype(np.int32)
    size0 = rng.integers(0, C, R).astype(np.int32)
    cnt = np.minimum(rng.integers(0, W + 1, R), C - size0).astype(np.int32)
    pa = (rng.random((R, W)) * 2).astype(np.float32)
    pt = rng.integers(0, 50, (R, W)).astype(np.int32)
    pp = payload(rng, (R, W, L), pay)
    return [torch.as_tensor(a, device=dev) for a in
            (qa, qt, qp, head, size0, cnt, pa, pt, pp)]


def exchange_state(rng, E, C, dev):
    """Random edge-major rings (a quarter of them full) with random
    receiver and sender activity."""
    head = rng.integers(0, C, E).astype(np.int32)
    size = rng.integers(0, C + 1, E)
    size = np.where(rng.random(E) < 0.25, C, size).astype(np.int32)
    off = (np.arange(C)[None, :] - head[:, None]) % C
    live = off < size[:, None]
    qa = np.where(live, rng.random((E, C)) * 2, np.inf).astype(np.float32)
    qt = np.where(live, rng.integers(0, 50, (E, C)), 0).astype(np.int32)
    return [torch.as_tensor(a, device=dev) for a in (
        qa, qt, head, size, (rng.random(E) * 2).astype(np.float32),
        rng.random(E) < 0.8, (rng.random(E) * 2).astype(np.float32),
        rng.random(E) < 0.7, (rng.random(E) * 0.5).astype(np.float32),
        rng.integers(0, 50, E).astype(np.int32))]


def device_ms(fn, runs=20, warmup=3):
    """Device time per call: the CUDA kernel time torch.profiler records
    over ``runs`` calls, divided by ``runs``.  Host-side launch overhead is
    excluded, so a small kernel is not timed as its wrapper's Python."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    check(us > 0, "torch.profiler recorded no device time")
    return us / 1e3 / runs


def call_ms(fn, runs=30, warmup=3):
    """Median time per call between CUDA events around it, host launch
    overhead included (what the engine pays per call)."""
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


def compare_close(want, got, rtol, atol):
    """(elements that disagree, max |difference|) over every output field.
    An element agrees when it equals the plain one (equal infinities
    included) or when both are finite and |got - want| <= atol + rtol
    |want|.  A NaN, or an infinity on one side only, disagrees and makes
    the max |difference| NaN or infinite."""
    bad, err = 0, 0.0
    for a, b in zip(want, got):
        a, b = a.double(), b.double()
        same = a == b
        d = torch.where(same, 0.0, (a - b).abs())
        close = torch.isfinite(a) & torch.isfinite(b) & (
            d <= atol + rtol * a.abs())
        bad += int((~(same | close)).sum())
        e = float(d.max())
        err = e if (e != e or e > err) else err     # a NaN stays
    return bad, err


def fields(x):
    return x if isinstance(x, tuple) else (x,)


def measure(label, run_kernel, run_plain, inputs, ops, hbm, *,
            peak=PEAK_OPS_PER_S, tol=None, library=None):
    """Hold one kernel call against its plain version (0 mismatching
    elements, or with ``tol = (rtol, atol)`` every element within it), time
    both (device time, and per call with the launch overhead), time
    ``library`` (the one PyTorch call that computes the same function,
    where there is one), and compute the bound for the same work: each
    input read once and each output written once over the HBM rate, or
    the operations over ``peak``, whichever is longer."""
    want = fields(run_plain())
    got = fields(run_kernel())
    torch.cuda.synchronize()
    if tol is None:
        bad, err = compare(want, got)
        check(bad == 0, f"{label}: {bad} mismatching elements")
        agree = "0 mismatches"
    else:
        bad, err = compare_close(want, got, *tol)
        check(bad == 0, f"{label}: {bad} elements outside rtol, atol = "
                        f"{tol} (max |difference| {err:.3g})")
        agree = f"max |difference| {err:.3g} within rtol, atol = {tol}"
    ms = device_ms(run_kernel)
    plain = device_ms(run_plain)
    call, plain_call = call_ms(run_kernel), call_ms(run_plain)
    lib = device_ms(library) if library is not None else None
    moved = nbytes(*inputs) + nbytes(*got)
    t_bytes, t_ops = moved / hbm, ops / peak
    bound = max(t_bytes, t_ops) * 1e3
    lib_txt = f", library {lib:.4f} ms" if lib is not None else ""
    print(f"{label}: {agree}, kernel {ms:.4f} ms, plain {plain:.4f} "
          f"ms{lib_txt} (device time), bound {bound:.4f} ms, "
          f"{ms / bound:.1f}x bound ({moved / 1e6:.1f} MB moved, "
          f"{ops / 1e9:.2f} G operations); per call with launch "
          f"overhead: kernel {call:.4f} ms, plain {plain_call:.4f} ms",
          flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=lib)


#: attention tolerances (rtol, atol) against the plain versions on the
#: card.  Float32 differs only in the order of the sums (online softmax over
#: tiles and chunks).  In bf16 both sides compute in float32 and round once
#: to bf16, so they differ by at most one bf16 ulp, which is at most 2^-7
#: of the value; atol covers the float32 sums' own error where the output
#: is near 0
ATTN_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2.0 ** -7, 1e-5)}
#: max |SDPA - plain version|, which shows that the library call times the
#: same function: SDPA rounds its bf16 probabilities, the plain version
#: does not
SDPA_TOL = {torch.float32: 4e-4, torch.bfloat16: 8e-2}


def attention_kernels(hbm):
    """flash_attention at the qwen2-1.5b prefill shape (B*KH = 16, G = 6,
    S = 2048, hd = 128, bf16) plus a ragged S and a float32 case;
    decode_attention at the decode shape (B = 8, KH = 2, G = 6, hd = 128)
    over a 2080-key cache with kv_len 2049, 2080 and 1."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2025)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    records = {}
    bf16, f32 = torch.bfloat16, torch.float32
    for label, BK, G, S, hd, dtype, rec in (
            ("(16,6,2048,128) bf16", 16, 6, 2048, 128, bf16,
             "flash_attention"),
            ("(16,6,2047,128) bf16 ragged", 16, 6, 2047, 128, bf16, None),
            ("(16,6,1024,128) f32", 16, 6, 1024, 128, f32, None)):
        q = randn((BK, G, S, hd), dtype)
        k, v = randn((BK, S, hd), dtype), randn((BK, S, hd), dtype)
        flops = 4 * hd * BK * G * (S * (S + 1) // 2)
        peak = PEAK_BF16_FLOPS if dtype == bf16 else PEAK_OPS_PER_S

        def library(q=q, k=k, v=v):
            return F.scaled_dot_product_attention(
                q, k[:, None], v[:, None], is_causal=True, enable_gqa=True)
        want = flash_attention_torch(q, k, v)
        err = float((library() - want).abs().max())
        check(err <= SDPA_TOL[dtype],
              f"flash {label}: SDPA is not the same function ({err})")
        r = measure(f"flash_attention {label}",
                    lambda q=q, k=k, v=v: flash_attention_grouped(q, k, v),
                    lambda q=q, k=k, v=v: flash_attention_torch(q, k, v),
                    (q, k, v), flops, hbm, peak=peak, tol=ATTN_TOL[dtype],
                    library=library)
        if rec:
            records[rec] = r
    B, KH, G, S, hd, bc = 8, 2, 6, 2080, 128, 512
    q = randn((B, KH, G, hd), bf16)
    k, v = randn((B, S, KH, hd), bf16), randn((B, S, KH, hd), bf16)
    for kv_len in (2049, 2080, 1):
        live = (k[:, :kv_len], v[:, :kv_len])

        def library(kv_len=kv_len):
            return F.scaled_dot_product_attention(
                q.reshape(B, KH * G, 1, hd), k[:, :kv_len].transpose(1, 2),
                v[:, :kv_len].transpose(1, 2), enable_gqa=True)
        want = decode_attention_torch(q, k, v, kv_len=kv_len)
        err = float((library().reshape(B, KH, G, hd) - want).abs().max())
        check(err <= SDPA_TOL[bf16],
              f"decode kv_len={kv_len}: SDPA is not the same function "
              f"({err})")
        r = measure(
            f"decode_attention (8,2,6,128) cache 2080 kv_len={kv_len} bf16",
            lambda kv_len=kv_len: decode_attention_partials(
                q, k, v, kv_len=kv_len, bc=bc),
            lambda kv_len=kv_len: decode_attention_partials_torch(
                q, k, v, kv_len=kv_len, bc=bc),
            (q, *live), 4 * hd * B * KH * G * kv_len, hbm,
            peak=PEAK_BF16_FLOPS, tol=ATTN_TOL[f32], library=library)
        if kv_len == 2049:
            records["decode_attention"] = r
    return records


@phase("kernels")
def kernels(hbm):
    dev = torch.device("cuda")
    rng = np.random.default_rng(2024)
    records = {}
    # duct_window (label, n, d, C, L, max_pops, payload): torus-4096 buckets
    # at L = 1 (graph coloring's shape) and L = 8, a degree-8 bucket, and
    # evo's torus-1024 float32 halos (3600 cells, L = 60)
    for label, n, d, C, L, pops, pay, rec in (
            ("torus4096-L1", 4096, 4, 64, 1, 16, np.int32, "duct_window"),
            ("torus4096-L8", 4096, 4, 64, 8, 16, np.int32, None),
            ("deg8-L1", 2048, 8, 64, 1, 16, np.int32, None),
            ("evo-torus1024-L60-f32", 1024, 4, 64, 60, 16, np.float32,
             "duct_window_f32")):
        args = window_state(rng, n, d, C, L, 64, dev, pay)
        r = measure(f"duct_window {label}",
                    lambda: duct_window(*args, max_pops=pops),
                    lambda: duct_window_torch(*args, max_pops=pops),
                    args, n * d * C * (8 + 2 * L), hbm)
        if rec:
            records[rec] = r
    # duct_commit (label, R, C, L, W, payload): torus-4096 rings at W = 8,
    # L = 1 and 8, and evo's torus-1024 float32 rings
    for label, R, C, L, W, pay, rec in (
            ("R16384-W8", 16384, 64, 1, 8, np.int32, "duct_commit"),
            ("R16384-W8-L8", 16384, 64, 8, 8, np.int32, None),
            ("evo-R4096-W8-L60-f32", 4096, 64, 60, 8, np.float32,
             "duct_commit_f32")):
        args = commit_state(rng, R, C, L, W, dev, pay)
        r = measure(f"duct_commit {label}", lambda: duct_commit(*args),
                    lambda: duct_commit_torch(*args), args,
                    R * C * (6 + L), hbm)
        if rec:
            records[rec] = r
    # duct_exchange at the torus-4096 edge layout (E = 16384, C = 64): the
    # fused form, and the two forms the edge-major window launches
    E, C, pops = 16384, 64, 16
    args = exchange_state(rng, E, C, dev)
    ops = E * C * 10
    records["duct_exchange"] = measure(
        "duct_exchange E16384-C64 full",
        lambda: duct_exchange(*args, capacity=C, max_pops=pops),
        lambda: duct_exchange_torch(*args, capacity=C, max_pops=pops),
        args, ops, hbm)
    measure("duct_exchange E16384-C64 drain",
            lambda: duct_drain(*args[:6], max_pops=pops),
            lambda: duct_drain_torch(*args[:6], max_pops=pops),
            args, ops, hbm)
    measure("duct_exchange E16384-C64 send",
            lambda: duct_send(*args[:4], *args[6:], capacity=C),
            lambda: duct_send_torch(*args[:4], *args[6:], capacity=C),
            args, ops, hbm)
    records.update(attention_kernels(hbm))
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
        want.pop("quality")
        for layout in ("dense", "edge"):
            got = qos_signature(make_engine(
                RunConfig(engine="torch", layout=layout),
                gc_app(16, topology, seed), cfg, faults(),
                max_pops=EXACT_MAX_POPS, chunk=64, device="cuda").run())
            got.pop("quality")
            check(got == want,
                  f"{name}: torch {layout} on the card != event oracle")
            check(sum(got["updates"]) > 0, f"{name}: no updates")
            print(f"{name} {layout}: qos_signature == event oracle "
                  f"({sum(got['updates'])} updates, {got['sent']} sent)",
                  flush=True)


# ---------------------------------------------------------------------------
# 5. end to end, card vs CPU
# ---------------------------------------------------------------------------
@phase("card_vs_cpu")
def card_vs_cpu():
    cases = [("graphcolor", "torus", 1024, 64, {}),
             ("graphcolor", "smallworld", 1024, 1, {}),
             ("graphcolor", "torus", 1024, 1, {"layout": "edge"}),
             ("evo", "torus", 64, 64, {}),
             ("evo", "torus", 64, 64, {"superstep_windows": 4}),
             ("evo", "torus", 64, 64, {"layout": "edge"})]
    for app_name, topology, n, simels, kw in cases:
        seed = case_seed(topology)
        cfg = dyadic_cfg(seed=seed)
        label = (f"{app_name} {topology}-{n} simels={simels} "
                 f"{json.dumps(kw)}")
        sig = {}
        for device in ("cuda", "cpu"):
            K.reset_launches()
            t0 = time.perf_counter()
            res = make_engine(RunConfig(engine="torch", **kw),
                              experiments.make_app(app_name, n, simels,
                                                   make_topology(topology, n),
                                                   seed),
                              cfg, chunk=64, device=device).run()
            dt = time.perf_counter() - t0
            sig[device] = qos_signature(res)
            launched = sum(K.LAUNCHES.values())
            check((launched > 0) == (device == "cuda"),
                  f"{label} on {device}: {launched} kernel launches")
            print(f"{label} {device}: {sum(res.updates)} updates, quality "
                  f"{res.quality}, {dt:.1f}s wall, {launched} kernel "
                  f"launches", flush=True)
        check(sig["cuda"] == sig["cpu"],
              f"{label}: card and CPU SimResults differ")
        print(f"{label}: card == CPU (full SimResult incl. quality)")


# ---------------------------------------------------------------------------
# 6. full size: the paper's experiments at full width
# ---------------------------------------------------------------------------
def drive(label, app_name, n, simels, duration, kw, chunk=256):
    """One main-path run through the CLI's configuration, with the launch
    counters set to 0 just before it and read just after it."""
    argv = ["--engine", "torch", "--device", "cuda", "--topology", "torus",
            "--procs", str(n), "--simels", str(simels), "--buffer", "64",
            "--duration", str(duration)]
    args = experiments.build_parser().parse_args(argv)
    cfg = experiments._sim_config(args, n)
    eng = make_engine(RunConfig(engine="torch", **kw),
                      experiments.make_app(app_name, n, simels,
                                           make_topology("torus", n),
                                           args.seed), cfg,
                      chunk=chunk, device="cuda")
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    res = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    updates = sum(res.updates)
    windows = eng.windows[-1]
    dist = aggregate_reports(res.qos)
    med = {m: dist[m]["median"] for m in dist}
    print(f"full size {label}: {updates} updates, {updates / wall:.0f} "
          f"updates/s, {wall:.2f}s wall, {windows} windows "
          f"({wall * 1e3 / windows:.3f} ms/window), delivery failure rate "
          f"{res.delivery_failure_rate:.4f}, quality {res.quality}, "
          f"launches {launches}", flush=True)
    print(f"full size {label} QoS medians: {json.dumps(med)}", flush=True)
    return res, windows, launches


@phase("full_size")
def full_size():
    """Graph coloring at the headline scale on both layouts and both
    schedulers, then evo at the paper's 3600 cells per process.  Returns
    each kernel entry's launch count from its main path."""
    # (label, app, n, simels, duration, run kwargs, chunk, kernel the
    # path must launch)
    paths = [
        ("graphcolor torus-4096 window", "graphcolor", 4096, 1, 0.02, {},
         256, "duct_window"),
        ("graphcolor torus-4096 superstep8", "graphcolor", 4096, 1, 0.02,
         {"superstep_windows": 8}, 256, "duct_commit"),
        ("graphcolor torus-4096 edge", "graphcolor", 4096, 1, 0.02,
         {"layout": "edge"}, 256, "duct_exchange"),
        # evo cut to 0.005 virtual s (about 300 updates per process) and
        # probed every 64 windows: a window costs tens of ms here
        ("evo torus-1024 3600 cells window", "evo", 1024, 3600, 0.005, {},
         64, "duct_window"),
        ("evo torus-1024 3600 cells superstep8", "evo", 1024, 3600, 0.005,
         {"superstep_windows": 8}, 64, "duct_commit"),
        ("evo torus-1024 3600 cells edge", "evo", 1024, 3600, 0.005,
         {"layout": "edge"}, 64, "duct_exchange"),
    ]
    sigs, launched = {}, {}
    for label, app_name, n, simels, duration, kw, chunk, used in paths:
        res, windows, launches = drive(label, app_name, n, simels, duration,
                                       kw, chunk)
        check(launches[used] > 0, f"{label}: {used} never launched")
        if used == "duct_exchange":
            # the edge-major window drains and sends with one launch each
            check(launches[used] == 2 * windows,
                  f"{label}: {launches[used]} duct_exchange launches in "
                  f"{windows} windows")
        # evo's halos are float32: its launches are the f32 entry points
        entry = used + ("_f32" if app_name == "evo" and used != "duct_exchange"
                        else "")
        launched.setdefault(entry, launches[used])
        sigs[label] = qos_signature(res)
    for app_name, base in (("graphcolor", "graphcolor torus-4096"),
                           ("evo", "evo torus-1024 3600 cells")):
        want = sigs[f"{base} window"]
        for other in ("superstep8", "edge"):
            got = sigs[f"{base} {other}"]
            check(got["updates"] == want["updates"],
                  f"{base}: {other} updates differ from per-window")
            check(got == want,
                  f"{base}: {other} SimResult differs from per-window")
        print(f"{base}: per-window == superstep8 == edge (full SimResult "
              f"incl. quality)", flush=True)
    return launched


# ---------------------------------------------------------------------------
# 7. the dense LM, card vs CPU, on the reduced configs
# ---------------------------------------------------------------------------
#: float32 logits, card against CPU: only the order of the sums differs
LM_F32_TOL = 1e-4
#: bf16 logits, card against CPU, as a share of the largest logit: the
#: card's bf16 products (cuBLAS) round in other places than the CPU's
LM_BF16_REL = 5e-2


@phase("lm_card_vs_cpu")
def lm_card_vs_cpu():
    """The reduced qwen2-1.5b (QKV bias) and qwen3-0.6b (qk_norm), 2
    layers, from the same seeded weights on both devices: the CPU serves
    greedily (plain attention), the card replays the CPU's tokens (teacher
    forcing) through the kernels; logits agree at every step and, in
    float32, the card's greedy tokens are the CPU's."""
    B, P, T = 4, 64, 8
    for arch in ("qwen2-1.5b", "qwen3-0.6b"):
        for dtype in ("float32", "bfloat16"):
            cfg = reduce_for_smoke(get_config(arch)).replace(dtype=dtype)
            cpu = lm.cast_params_for_compute(lm.LM(cfg, seed=0, device="cpu"))
            card = copy.deepcopy(cpu).to("cuda")
            gen = torch.Generator().manual_seed(1)
            prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                                    dtype=torch.int32)
            K.reset_launches()
            want = serve.serve(cpu, prompts, T)
            check(sum(K.LAUNCHES.values()) == 0,
                  f"{arch}: the CPU run launched kernels")
            logits, caches = lm.prefill_step(card, prompts.cuda(), P + T)
            got = [logits[:, -1]]
            for i in range(T - 1):
                tok = want.seqs[:, i:i + 1].cuda()
                nxt, logits, caches = lm.decode_step(card, tok, caches,
                                                     P + i)
                got.append(logits[:, -1])
                if dtype == "float32":
                    check(torch.equal(nxt.cpu()[:, 0], want.seqs[:, i + 1]),
                          f"{arch}: greedy token {i + 1} differs on the card")
            torch.cuda.synchronize()
            launches = dict(K.LAUNCHES)
            check(launches["flash_attention"] == cfg.num_layers and
                  launches["decode_attention"] == cfg.num_layers * (T - 1),
                  f"{arch} {dtype}: launches {launches}")
            check(all(bool(torch.isfinite(g).all()) for g in got),
                  f"{arch} {dtype}: non-finite logits on the card")
            # stacked, so that a NaN at any step makes the max NaN
            err = float(torch.stack([(g.cpu() - w).abs().max()
                                     for g, w in zip(got, want.logits)]).max())
            scale = float(torch.stack([w.abs().max()
                                       for w in want.logits]).max())
            if dtype == "float32":
                check(err <= LM_F32_TOL,
                      f"{arch}: card logits differ by {err}")
            else:
                check(err <= LM_BF16_REL * scale,
                      f"{arch} bf16: card logits differ by {err} "
                      f"(largest logit {scale})")
            print(f"{cfg.name} {dtype}: {T} steps, card == CPU (max "
                  f"|logit difference| {err:.3g}, largest logit "
                  f"{scale:.3g}); launches flash {launches['flash_attention']}"
                  f" decode {launches['decode_attention']}", flush=True)


# ---------------------------------------------------------------------------
# 8. the dense LM at full width: qwen2-1.5b serving 8 x (2048 + 32)
# ---------------------------------------------------------------------------
#: prefill of prompt + k tokens against decode step k, bf16, as a share of
#: the largest logit: two different kernels and cuBLAS shapes round the
#: 28 layers' bf16 products in different places
CROSS_REL = 5e-2


@phase("lm_full_size")
def lm_full_size():
    """qwen2-1.5b at full width through the serving entry point, launch
    counters zeroed just before it and read just after it.  Returns each
    attention kernel's launches on that path."""
    argv = ["--arch", "qwen2-1.5b", "--batch", "8", "--prompt-len", "2048",
            "--tokens", "32", "--device", "cuda", "--seed", "0"]
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    model, prompts, res = serve.main(argv)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    cfg = model.cfg
    L, T = cfg.num_layers, res.seqs.shape[1]
    check(launches["flash_attention"] == L,
          f"qwen2-1.5b: {launches['flash_attention']} flash launches, "
          f"expected {L}")
    check(launches["decode_attention"] == L * (T - 1),
          f"qwen2-1.5b: {launches['decode_attention']} decode launches, "
          f"expected {L} x {T - 1}")
    check(all(bool(torch.isfinite(x).all()) for x in res.logits),
          "qwen2-1.5b: non-finite logits")
    check(tuple(res.seqs.shape) == (8, 32), f"seqs {tuple(res.seqs.shape)}")
    print(f"full size qwen2-1.5b bf16 serve 8x(2048+32): prefill "
          f"{res.prefill_ms:.1f} ms, decode {res.decode_ms_per_token:.3f} "
          f"ms/token, {res.tokens_per_s:.1f} tokens/s, peak memory "
          f"{peak / 2 ** 30:.2f} GiB, launches {launches}", flush=True)
    again = serve.serve(model, prompts, T)
    check(torch.equal(again.seqs, res.seqs),
          "qwen2-1.5b: a second serve gave other tokens")
    print(f"second serve: same tokens (prefill {again.prefill_ms:.1f} ms, "
          f"decode {again.decode_ms_per_token:.3f} ms/token)", flush=True)
    for k in (1, T - 1):
        full = torch.cat([prompts, res.seqs[:, :k]], dim=1)
        logits, _ = lm.prefill_step(model, full)
        want = res.logits[k]
        err = float((logits[:, -1] - want).abs().max())
        scale = float(want.abs().max())
        same = float((logits[:, -1].argmax(-1) == want.argmax(-1))
                     .float().mean())
        check(err <= CROSS_REL * scale,
              f"prefill of prompt + {k} tokens vs decode step {k}: logits "
              f"differ by {err} (largest {scale})")
        print(f"prefill {full.shape[1]} tokens vs decode step {k}: max "
              f"|logit difference| {err:.4g} of largest {scale:.4g}, greedy "
              f"tokens agree on {same:.3f} of the batch", flush=True)
    del model
    torch.cuda.empty_cache()
    return {"flash_attention": launches["flash_attention"],
            "decode_attention": launches["decode_attention"]}


#: each kernel entry point of the kernels JSON line: (name, kernel source
#: key, TPU kernel it replaces)
ENTRIES = (
    ("duct_window", "duct_window",
     "src/repro/kernels/duct_exchange/kernel.py:81"),
    ("duct_window_f32", "duct_window",
     "src/repro/kernels/duct_exchange/kernel.py:81"),
    ("duct_commit", "duct_commit",
     "src/repro/kernels/duct_exchange/kernel.py:197"),
    ("duct_commit_f32", "duct_commit",
     "src/repro/kernels/duct_exchange/kernel.py:197"),
    ("duct_exchange", "duct_exchange",
     "src/repro/kernels/duct_exchange/kernel.py:31"),
    ("flash_attention", "flash_attention",
     "src/repro/kernels/flash_attention/kernel.py:20"),
    ("decode_attention", "decode_attention",
     "src/repro/kernels/decode_attention/kernel.py:19"),
)


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
    launched = full_size()
    lm_card_vs_cpu()
    launched.update(lm_full_size())
    kernels_line = []
    for entry, kname, replaces in ENTRIES:
        rec = records[entry]
        kernels_line.append(dict(
            name=entry, route="cuda",
            source=f"src/repro_torch/kernels/{K.SOURCES[kname]}",
            replaces=replaces, launches=launched[entry],
            max_abs_err=rec["max_abs_err"], ms=rec["ms"],
            plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], library_ms=rec["library_ms"]))
    print("phases: " + ", ".join(f"{p} {t:.1f}s" for p, t in PHASES))
    print(smi)
    print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
