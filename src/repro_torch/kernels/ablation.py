"""Ablations of the redesigned kernels on the card: where a kernel's time
goes.

Two measurements, each printed as one line per variant:

* ``stages``: the current kernels through their wrappers, timed with CUDA
  events and under ``torch.profiler`` (the device time of each
  ``__global__`` kernel they launch):
  - ``topk``: ``topk_compress``, and its source built again with the
    select histograms merged by ``__match_any_sync`` before their
    shared-memory atomics, without those atomics, and without the level-0
    filter's appends (the last two time the streams alone; their outputs
    are wrong);
  - ``window``: ``duct_window_f32``;
  - ``mlstm``: ``mlstm_attention``'s tensor-core route beside its
    CUDA-core route on the same bf16 inputs, and the source built again
    with ``-DMLSTM_CUT=1`` (Q K^T alone) and ``=2`` (Q K^T, the weighting
    and the split of P, no P V; both outputs wrong), and with
    ``-DMLSTM_WAITS``: the share of the consumers' cycles spent waiting
    for k and for v, in the stabilizer's prologue, and the producer's
    waits for a free stage;
  - ``commit``: ``duct_commit`` at evo's and graph coloring's shapes;
  - ``scan``: ``mamba_scan`` on both routes (``tma``, ``simt``), each
    with the blocks resident on an SM, as built and built with
    ``-DSCAN_CUT=1`` (1 + dt A in place of expf: the special-function
    share) and ``=2`` (x and dt made in registers, not loaded: the load
    share; both outputs wrong);
  - ``exchange``: ``duct_exchange``'s drain, send and full entry points,
    beside an empty kernel on the same grids (the launch ramp) and
    ``clone()`` of both rings (a copy of the bytes the send moves);
  - ``scan_bwd``: ``mamba_scan_backward`` given the forward's saved
    states, as built and built with ``-DSCAN_BWD_CUT=1`` (1 + dt A in
    place of expf: the special-function share) and ``=2`` (no dB / dC sums
    over d: no reduce-scatter, warps' sums or partial writes; both outputs
    wrong), and the forward with and without saving the states;
  - ``mlstm_bwd``: ``mlstm_attention_backward``'s tensor-core route (each
    of its four kernels) beside its CUDA-core route on the same bf16
    inputs, each as built and built with ``-DMLSTM_BWD_CUT=1`` (the
    products alone; outputs wrong);
* ``before``: sources of the git history (``git show
  <commit>:src/repro_torch/kernels/...``), each timed with CUDA events:
  ``--topk``, the one-block-a-row top-k, built three times with early
  exits after the radix select and after the compaction; ``--window``, the
  one-thread-a-ring-row window, whole and without its payload copy;
  ``--mlstm``, the CUDA-core mLSTM at the bf16 prefill shape;
  ``--commit``, the one-thread-a-slot commit, whole and without its
  payload copy; ``--scan``, the one-step-ahead scan (entry point
  ``mamba_scan_f32``); ``--exchange``, the fused exchange kernel in the
  three forms the ops launched it in (full; drain and send with the other
  half fed zero vectors); ``--scan-backward``, the backward that ran the
  forward recurrence again in a first pass (entry point
  ``mamba_scan_backward_f32`` with the boundary scratch), as built,
  without expf (``expf(x)`` defined as 1 + x) and without its dB / dC
  partial writes.

Run on the card from the repository root::

    PYTHONPATH=src python -m repro_torch.kernels.ablation stages \\
        [--only scan exchange]
    PYTHONPATH=src python -m repro_torch.kernels.ablation before \\
        --scan build/before/mamba_scan.cu \\
        --exchange build/before/duct_exchange.cu \\
        --scan-backward build/before/mamba_scan_backward.cu

Shapes: top-k at qwen2-1.5b's stacked MLP rows, (28, 13,762,560), k =
137,625; the window at evo's torus-1024 (1024, 4, 64, 60) float32; the
mLSTM at xlstm-125m's prefill, (8, 2048, 4, 384) bf16; the commit at evo's
(R 4096, C 64, L 60, W 8) float32 and graph coloring's (16384, 64, 1, 8)
int32; the scan at jamba's prefill, (8, 2048, 8192, 16) float32; the
exchange at graph coloring's torus-4096 edge layout (E 16384, C 64); the
backward kernels at their training shapes, the scan's (4, 2048, 8192, 16)
float32 and the mLSTM's (4, 2048, 4, 384) bf16.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import build as K

TOPK_SHAPE = (28, 13_762_560, 137_625)
WINDOW_SHAPE = (1024, 4, 64, 60, 16)     # n, d, C, L, max_pops
MLSTM_SHAPE = (8, 2048, 4, 384)          # B, S, H, hd (bf16)
#: (R, C, L, W, payload dtype)
COMMIT_SHAPES = ((4096, 64, 60, 8, torch.float32),
                 (16384, 64, 1, 8, torch.int32))
SCAN_SHAPE = (8, 2048, 8192, 16)         # Bb, S, di, N (float32)
SCAN_BWD_SHAPE = (4, 2048, 8192, 16)     # the backward's (training)
MLSTM_BWD_SHAPE = (4, 2048, 4, 384)      # B, S, H, hd (bf16, training)
EXCHANGE_SHAPE = (16384, 64, 16)         # E, C, max_pops
#: grids an empty kernel is launched on beside the exchange kernels:
#: (label, blocks, threads) at E = 16384 (the fused kernel: 8 rows a
#: block; drain and send: 32 rows a block)
EMPTY_GRIDS = (("the fused kernel's grid", 2048, 256),
               ("drain's and send's grid", 512, 256))

#: cuts of the one-block-a-row top-k source: (text it follows, the early
#: exit inserted after it, under ``STOP``); the exit writes what the pass
#: found so that the compiler keeps the pass
_TOPK_CUTS = (
    ("  const uint32_t kth = prefix;\n",
     "  if (STOP == 1) { if (tid == 0) idx[row * k] = (int32_t)kth; "
     "return; }\n"),
    ("  // ---- stable LSD sort of the k survivors, descending key",
     "\n  if (STOP == 2) { if (tid == 0) idx[row * k] = ia[0]; return; }\n"
     "  //"),
)
#: the one-thread-a-ring-row window's payload copy
_WINDOW_COPY = ("    for (long long k = 0; k < (long long)C * L; ++k) "
                "p[k] = p_in[k];\n")
#: the one-thread-a-slot commit's two payload copies
_COMMIT_COPIES = (
    "    for (int l = 0; l < L; ++l) qp_out[idx * L + l] = "
    "pb_pay[src * L + l];\n",
    "    for (int l = 0; l < L; ++l) qp_out[idx * L + l] = "
    "q_pay[idx * L + l];\n")
_P, _I = ctypes.c_void_p, ctypes.c_int


def _build(src_text: str, tag: str, defines=(), include=None) -> ctypes.CDLL:
    """Compile ``src_text`` with ``-D`` ``defines`` into build/ablation/
    and load it; ``include``: a directory its ``#include "..."`` headers
    are in (a kernel's ``csrc/``)."""
    out_dir = K.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    digest = hashlib.sha256((src_text + repr(defines)).encode()).hexdigest()
    src = out_dir / f"{tag}-{digest[:12]}.cu"
    lib = src.with_suffix(".so")
    if not lib.exists():
        src.write_text(src_text)
        cmd = [K._nvcc(), *K.NVCC_FLAGS, *[f"-D{d}" for d in defines],
               *([] if include is None else ["-I", str(include)]),
               "-o", str(lib), str(src)]
        subprocess.run(cmd, check=True)
    return ctypes.CDLL(str(lib))


def _events_ms(fn, runs=10, warmup=2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(runs):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / runs


def _by_kernel(fn, runs=10):
    """Device ms per call of each CUDA kernel that ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3 / runs, e.count // runs)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    return sorted(rows, key=lambda r: -r[1])


def grad_rows(nb, block, seed=2026):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mag = 10.0 ** (torch.rand((nb, 1), generator=gen, device="cuda") * 14
                   - 12)
    return torch.randn((nb, block), generator=gen, device="cuda") * mag


def window_args(n, d, C, L, cap=64, seed=2024):
    """A random dense ring state with an engine-style staged push, float32
    payloads (the construction of ``chip_smoke.window_state``)."""
    rng = np.random.default_rng(seed)
    head = rng.integers(0, C, (n, d)).astype(np.int32)
    size = rng.integers(0, cap, (n, d)).astype(np.int32)
    off = (np.arange(C)[None, None, :] - head[..., None]) % C
    live = off < size[..., None]
    qa = np.where(live, rng.random((n, d, C)) * 2, np.inf).astype(np.float32)
    qt = np.where(live, rng.integers(0, 50, (n, d, C)), 0).astype(np.int32)
    qp = np.where(live[..., None],
                  rng.standard_normal((n, d, C, L), dtype=np.float32),
                  0).astype(np.float32)
    pacc = (rng.random((n, d)) < 0.7) & (size < cap)
    ppos = ((head + size) % C).astype(np.int32)
    size = (size + pacc).astype(np.int32)
    pav = (rng.random((n, d)) * 2).astype(np.float32)
    ptch = rng.integers(0, 50, (n, d)).astype(np.int32)
    ppay = rng.standard_normal((n, d, L), dtype=np.float32)
    rnow = (rng.random(n) * 2).astype(np.float32)
    ract = rng.random(n) < 0.8
    return [torch.as_tensor(a, device="cuda") for a in
            (qa, qt, qp, head, size, ppos, pacc, pav, ptch, ppay, rnow, ract)]


def mlstm_args(B, S, H, hd, seed=2028):
    """bf16 q, k (scaled by hd**-0.5), v and float32 F, I on the card, the
    distributions of ``chip_smoke.mlstm_inputs``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    q = randn(B, S, H, hd).bfloat16()
    k = (randn(B, S, H, hd) * hd ** -0.5).bfloat16()
    v = randn(B, S, H, hd).bfloat16()
    F = torch.cumsum(torch.nn.functional.logsigmoid(randn(B, S, H) + 3.0),
                     dim=1)
    return [q, k, v, F, randn(B, S, H) * 0.5]


def commit_args(R, C, L, W, pay, seed=2024):
    """A random commit state (``chip_smoke.commit_state``'s construction)
    with ``pay`` payloads."""
    rng = np.random.default_rng(seed)
    size0 = rng.integers(0, C, R).astype(np.int32)
    p = (lambda s: rng.standard_normal(s, dtype=np.float32)) \
        if pay == torch.float32 else \
        (lambda s: rng.integers(0, 99, s).astype(np.int32))
    arrays = ((rng.random((R, C)) * 2).astype(np.float32),
              rng.integers(0, 50, (R, C)).astype(np.int32), p((R, C, L)),
              rng.integers(0, C, R).astype(np.int32), size0,
              np.minimum(rng.integers(0, W + 1, R), C - size0).astype(
                  np.int32),
              (rng.random((R, W)) * 2).astype(np.float32),
              rng.integers(0, 50, (R, W)).astype(np.int32), p((R, W, L)))
    return [torch.as_tensor(a, device="cuda") for a in arrays]


def scan_args(Bb, S, di, N, seed=2027):
    """x, dt > 0, B, C, A < 0 float32 on the card
    (``chip_smoke.scan_inputs``'s distributions)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    return [randn(Bb, S, di) * 0.5,
            torch.nn.functional.softplus(randn(Bb, S, di) - 1),
            randn(Bb, S, N) * 0.5, randn(Bb, S, N) * 0.5,
            -torch.exp(randn(di, N) * 0.3)]


def exchange_args(E, C, seed=2024):
    """Random edge-major rings, a quarter of them full, with random
    receiver and sender activity (``chip_smoke.exchange_state``'s
    construction)."""
    rng = np.random.default_rng(seed)
    head = rng.integers(0, C, E).astype(np.int32)
    size = rng.integers(0, C + 1, E)
    size = np.where(rng.random(E) < 0.25, C, size).astype(np.int32)
    off = (np.arange(C)[None, :] - head[:, None]) % C
    live = off < size[:, None]
    qa = np.where(live, rng.random((E, C)) * 2, np.inf).astype(np.float32)
    qt = np.where(live, rng.integers(0, 50, (E, C)), 0).astype(np.int32)
    return [torch.as_tensor(a, device="cuda") for a in (
        qa, qt, head, size, (rng.random(E) * 2).astype(np.float32),
        rng.random(E) < 0.8, (rng.random(E) * 2).astype(np.float32),
        rng.random(E) < 0.7, (rng.random(E) * 0.5).astype(np.float32),
        rng.integers(0, 50, E).astype(np.int32))]


def _launcher(lib, entry, argtypes):
    fn = getattr(lib, entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream

    def call(*ptrs):
        err = fn(*ptrs, stream)
        if err != 0:
            raise RuntimeError(f"{entry} launch failed with CUDA error {err}")
    return call


#: the mLSTM launcher's C signature: q, k, v, F, I, out; B, S, H, hd; stream
_MLSTM_ARGTYPES = [_P] * 6 + [_I] * 4 + [_P]
#: the commit launcher's: 9 inputs, 3 outputs; R, C, W, L; stream
_COMMIT_ARGTYPES = [_P] * 12 + [ctypes.c_longlong] + [_I] * 3 + [_P]
#: the scan launchers': x, dt, B, C, A, y, h, saved states; Bb, S, di, N;
#: stream (an earlier source's one-step-ahead entry point: no saved states)
_SCAN_ARGTYPES = [_P] * 8 + [_I] * 4 + [_P]
_SCAN_BEFORE_ARGTYPES = [_P] * 7 + [_I] * 4 + [_P]
#: the fused exchange launcher's: 10 inputs, 9 outputs; E, C, capacity,
#: max_pops; stream
_EXCHANGE_ARGTYPES = [_P] * 19 + [_I] * 4 + [_P]
#: an empty kernel, timed on an exchange kernel's grid: the launch ramp
_EMPTY_SRC = """#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""


#: cuts of the current top-k source for ``stages``: (label, text, its
#: stand-in); the stand-in compares the value with the clock, which the
#: compiler cannot know, so the loads and the arithmetic stay and the
#: cut work almost never runs
_TOPK_STAGE_CUTS = (
    ("select histograms merged by __match_any_sync",
     "  if (ok) atomicAdd(&sh[d], 1u);\n",
     "  const unsigned peers = __match_any_sync(kFull, ok ? d : 0xffffu);\n"
     "  if (ok && (peers & ((1u << (threadIdx.x & 31)) - 1u)) == 0)\n"
     "    atomicAdd(&sh[d], (unsigned)__popc(peers));\n"),
    ("select histograms without their shared-memory atomics",
     "  if (ok) atomicAdd(&sh[d], 1u);\n",
     "  if (ok && d == (unsigned)clock64()) atomicAdd(&sh[0], 1u);\n"),
    ("level-0 filter without its appends",
     "      claim(nw, nc, wins_n, cand_n, &wpos, &cpos);\n#pragma unroll\n"
     "      for (int j = 0; j < kVec; ++j) {\n",
     "      if ((kinds ^ nw ^ (nc << 8)) == (uint64_t)clock64()) wr[0] = 0;\n"
     "      wpos = cpos = 0;\n"
     "      for (int j = 0; j < 0; ++j) {\n"),
)


def _swap_topk(lib):
    """Make the wrapper launch from ``lib``; returns the library it had."""
    from repro_torch.kernels.topk_compress import kernel as tk
    had = K.load("topk_compress", {"topk_compress": tk._ARGTYPES})
    K._LIBS["topk_compress"] = lib
    K.load("topk_compress", {"topk_compress": tk._ARGTYPES})
    return had


STAGES = ("topk", "window", "mlstm", "commit", "scan", "exchange",
          "scan_bwd", "mlstm_bwd")


def stages(only=STAGES) -> None:
    if "topk" in only:
        _topk_stages()
    if "window" in only:
        _window_stages()
    if "mlstm" in only:
        _mlstm_stages()
    if "commit" in only:
        _commit_stages()
    if "scan" in only:
        _scan_stages()
    if "exchange" in only:
        _exchange_stages()
    if "scan_bwd" in only:
        _scan_bwd_stages()
    if "mlstm_bwd" in only:
        _mlstm_bwd_stages()


def _print_kernels(rows):
    for name, ms, count in rows:
        print(f"  {name[:60]:60s} {ms:.4f} ms in {count} launches")


def _topk_stages() -> None:
    from repro_torch.kernels.topk_compress import kernel as tk
    nb, block, k = TOPK_SHAPE
    x = grad_rows(nb, block)
    run = lambda: tk.topk_compress_cuda(x, k)  # noqa: E731
    want = run()
    src = K.source_path("topk_compress").read_text()
    variants = [("as built", None)]
    for label, old, new in _TOPK_STAGE_CUTS:
        if src.count(old) != 1:
            raise SystemExit(f"topk source: cut anchor not found once: "
                             f"{old!r}")
        variants.append((label, _build(src.replace(old, new), "topk_cut")))
    for label, lib in variants:
        had = _swap_topk(lib) if lib is not None else None
        try:
            got = run()
            same = all(torch.equal(a, b) for a, b in zip(want, got))
            total = _events_ms(run)
            rows = _by_kernel(run)
        finally:
            if had is not None:
                _swap_topk(had)
        print(f"topk_compress {TOPK_SHAPE} {label}: {total:.4f} ms a call "
              f"(events), outputs equal to the build's: {same}")
        _print_kernels(rows)


def _window_stages() -> None:
    from repro_torch.kernels.duct_exchange.ops import duct_window
    args = window_args(*WINDOW_SHAPE[:4])
    pops = WINDOW_SHAPE[4]
    wrun = lambda: duct_window(*args, max_pops=pops)  # noqa: E731
    print(f"duct_window_f32 {WINDOW_SHAPE[:4]}: {_events_ms(wrun, 50):.4f} "
          f"ms a call (events)")
    _print_kernels(_by_kernel(wrun, 50))


def _mlstm_stages() -> None:
    from repro_torch.kernels.mlstm_attention import kernel as mk
    from repro_torch.kernels.mlstm_attention.ops import mlstm_attention
    B, S, H, hd = MLSTM_SHAPE
    args = mlstm_args(*MLSTM_SHAPE)
    want = mlstm_attention(*args)
    for label, run in (
            ("wgmma", lambda: mlstm_attention(*args)),
            ("simt (forced)",
             lambda: mk.mlstm_attention_cuda(*args, simt=True))):
        print(f"mlstm_attention {MLSTM_SHAPE} bf16 {label}: "
              f"{_events_ms(run, 10):.4f} ms a call (events)", flush=True)
        _print_kernels(_by_kernel(run, 5))
    path = K.source_path("mlstm_attention")
    src, inc = path.read_text(), path.parent
    out = torch.empty_like(args[0])
    ptrs = [t.data_ptr() for t in (*args, out)]
    for label, define in (("Q K^T alone", "MLSTM_CUT=1"),
                          ("Q K^T, the weighting and the split of P, no "
                           "P V", "MLSTM_CUT=2")):
        call = _launcher(_build(src, "mlstm_cut", (define,), inc),
                         "mlstm_attention_wgmma_bf16", _MLSTM_ARGTYPES)
        ms = _events_ms(lambda: call(*ptrs, B, S, H, hd), 10)
        print(f"mlstm_attention {MLSTM_SHAPE} bf16 wgmma, {label}: "
              f"{ms:.4f} ms (output wrong)", flush=True)
    lib = _build(src, "mlstm_waits", ("MLSTM_WAITS",), inc)
    call = _launcher(lib, "mlstm_attention_wgmma_bf16", _MLSTM_ARGTYPES)
    read = lib.mlstm_waits
    read.argtypes, read.restype = [_P], ctypes.c_int
    cyc = (ctypes.c_ulonglong * 6)()
    for _ in range(2):          # the first run zeroes the counters
        call(*ptrs, B, S, H, hd)
        torch.cuda.synchronize()
        if read(cyc) != 0:
            raise RuntimeError("mlstm_waits failed")
    c = list(cyc)
    run_cycles = c[4] / 2       # a block's run: two consumers counted
    print(f"mlstm_attention {MLSTM_SHAPE} bf16 wgmma, cycle counters "
          f"(output equal to the build's: {torch.equal(out, want)}): the "
          f"consumers wait for k {c[0] / c[4]:.1%} and for v "
          f"{c[1] / c[4]:.1%} of their cycles, spend {c[5] / c[4]:.1%} in "
          f"the stabilizer's prologue; the producer waits for a free k "
          f"stage {c[2] / run_cycles:.1%} and a free v stage "
          f"{c[3] / run_cycles:.1%} of a block's run", flush=True)


def _commit_stages() -> None:
    from repro_torch.kernels.duct_exchange.ops import (
        duct_commit,
        duct_commit_torch,
    )
    for R, C, L, W, pay in COMMIT_SHAPES:
        args = commit_args(R, C, L, W, pay)
        run = lambda: duct_commit(*args)  # noqa: E731
        same = all(torch.equal(a, b)
                   for a, b in zip(run(), duct_commit_torch(*args)))
        print(f"duct_commit {(R, C, L, W)} {pay}: {_events_ms(run, 50):.4f} "
              f"ms a call (events), bitwise its plain version: {same}")
        _print_kernels(_by_kernel(run, 50))


def _scan_entries(lib):
    """The scan routes ``lib`` exports: [(route, entry)]."""
    return [(r, f"mamba_scan_{r}_f32") for r in ("tma", "simt")
            if hasattr(lib, f"mamba_scan_{r}_f32")]


def _scan_stages() -> None:
    """Both routes of the scan as built, and built with -DSCAN_CUT=1 (no
    expf: 1 + dt A in its place) and =2 (no x and dt loads: made in
    registers); both cut outputs are wrong.  Plus the blocks of each
    route resident on one SM."""
    Bb, S, di, N = SCAN_SHAPE
    args = scan_args(*SCAN_SHAPE)
    y = torch.empty((Bb, S, di), dtype=torch.float32, device="cuda")
    h = torch.empty((Bb, di, N), dtype=torch.float32, device="cuda")
    ptrs = [t.data_ptr() for t in (*args, y, h)] + [None]
    src = K.source_path("mamba_scan").read_text()
    lib = _build(src, "scan")
    occ = lib.mamba_scan_blocks_per_sm
    occ.argtypes, occ.restype = [_I, _I, ctypes.POINTER(_I)], ctypes.c_int
    for route, entry in _scan_entries(lib):
        blocks = _I(-1)
        if occ(int(route == "tma"), N, ctypes.byref(blocks)) != 0:
            raise RuntimeError(f"mamba_scan_blocks_per_sm({route}) failed")
        print(f"mamba_scan {SCAN_SHAPE} {route}: {blocks.value} blocks "
              f"resident an SM", flush=True)
        for label, define in (("as built", None),
                              ("no expf (1 + dt A)", "SCAN_CUT=1"),
                              ("no x, dt loads", "SCAN_CUT=2")):
            cut = lib if define is None else \
                _build(src, "scan_cut", (define,))
            call = _launcher(cut, entry, _SCAN_ARGTYPES)
            run = lambda: call(*ptrs, Bb, S, di, N)  # noqa: E731
            run()
            torch.cuda.synchronize()
            note = "" if define is None else " (output wrong)"
            print(f"mamba_scan {SCAN_SHAPE} {route}, {label}: "
                  f"{_events_ms(run, 10):.4f} ms (events){note}",
                  flush=True)
            if define is None:
                _print_kernels(_by_kernel(run, 5))


#: the backward launchers' C signatures: the scan's x, dt, B, C, A, dy,
#: dh_final, saved states, dx, ddt, dB, dC, dA, three partials; Bb, S, di,
#: N; stream (the earlier source: the boundary scratch after dA instead of
#: the saved states after dh_final); the mLSTM's q, k, v, F, I, dh, dq, dk,
#: dv, dF, dI, m, den, dn; B, S, H, hd; stream
_SCAN_BWD_ARGTYPES = [_P] * 16 + [_I] * 4 + [_P]
_MLSTM_BWD_ARGTYPES = [_P] * 14 + [_I] * 4 + [_P]


def _scan_bwd_buffers(shape, blocks, before=False):
    """(inputs, pointers) of one backward call at ``shape`` (dh_final
    null), with partials for ``blocks`` channel blocks; the saved states
    come from the forward, or (``before``) a boundary scratch of every
    chunk."""
    from repro_torch.kernels.mamba_scan.kernel import mamba_scan_cuda
    Bb, S, di, N = shape
    args = scan_args(*shape)
    gen = torch.Generator(device="cuda").manual_seed(2029)
    dy = torch.randn((Bb, S, di), generator=gen, device="cuda")

    def empty(*s):
        return torch.empty(s, dtype=torch.float32, device="cuda")
    outs = [empty(Bb, S, di), empty(Bb, S, di), empty(Bb, S, N),
            empty(Bb, S, N), empty(di, N)]
    parts = [empty(Bb, blocks, S, N), empty(Bb, blocks, S, N),
             empty(Bb, di, N)]
    if before:
        hb = empty(Bb, -(-S // 16), di, N)
        keep = [*args, dy, *outs, hb, *parts]
        ptrs = [t.data_ptr() for t in (*args, dy)] + [None] + \
            [t.data_ptr() for t in (*outs, hb, *parts)]
    else:
        hb = mamba_scan_cuda(*args, bounds=True)[2]
        keep = [*args, dy, hb, *outs, *parts]
        ptrs = [t.data_ptr() for t in (*args, dy)] + [None, hb.data_ptr()] + \
            [t.data_ptr() for t in (*outs, *parts)]
    return keep, ptrs


def _scan_bwd_stages() -> None:
    """The backward given the forward's saved states, as built and with
    -DSCAN_BWD_CUT=1 (no expf) and =2 (no dB / dC sums over d); and the
    forward at this shape with and without saving the states."""
    from repro_torch.kernels.mamba_scan import kernel as sk
    Bb, S, di, N = SCAN_BWD_SHAPE
    _, channels = sk.backward_geometry(N)
    keep, ptrs = _scan_bwd_buffers(SCAN_BWD_SHAPE, -(-di // channels))
    path = K.source_path("mamba_scan_backward")
    src = path.read_text()
    for label, define in (("as built", None),
                          ("no expf (1 + dt A)", "SCAN_BWD_CUT=1"),
                          ("no dB / dC sums over d", "SCAN_BWD_CUT=2")):
        lib = _build(src, "scan_bwd", () if define is None else (define,))
        call = _launcher(lib, "mamba_scan_backward_f32", _SCAN_BWD_ARGTYPES)
        run = lambda: call(*ptrs, Bb, S, di, N)  # noqa: E731
        note = "" if define is None else " (output wrong)"
        print(f"mamba_scan_backward {SCAN_BWD_SHAPE} saved states, {label}: "
              f"{_events_ms(run, 10):.4f} ms (events){note}", flush=True)
        if define is None:
            _print_kernels(_by_kernel(run, 5))
    args = keep[:5]
    for label, bounds in (("without saved states", False),
                          ("saving the states", True)):
        run = lambda: sk.mamba_scan_cuda(*args, bounds=bounds)  # noqa: E731
        print(f"mamba_scan {SCAN_BWD_SHAPE} tma, {label}: "
              f"{_events_ms(run, 10):.4f} ms (events)", flush=True)


def _mlstm_bwd_stages() -> None:
    """The backward's routes on the same bf16 inputs, each kernel's device
    time, and the route built with -DMLSTM_BWD_CUT=1 (the products alone:
    q k^T and dh v^T in every kernel, no weighting, operand or
    accumulated product; outputs wrong)."""
    from repro_torch.kernels.mlstm_attention import kernel as mk
    B, S, H, hd = MLSTM_BWD_SHAPE
    args = mlstm_args(*MLSTM_BWD_SHAPE)
    gen = torch.Generator(device="cuda").manual_seed(2030)
    dh = torch.randn((B, S, H, hd), generator=gen, device="cuda").bfloat16()
    ins = [*args, dh]
    for label, simt in (("wgmma", False), ("simt (forced)", True)):
        run = lambda: mk.mlstm_attention_backward_cuda(  # noqa: E731
            *ins, simt=simt)
        print(f"mlstm_attention_backward {MLSTM_BWD_SHAPE} bf16 {label}: "
              f"{_events_ms(run, 5):.4f} ms a call (events)", flush=True)
        _print_kernels(_by_kernel(run, 10))
    path = K.source_path("mlstm_attention_backward")
    outs = [torch.empty_like(dh) for _ in range(3)] + \
        [torch.empty_like(args[3]) for _ in range(5)]
    ptrs = [t.data_ptr() for t in (*ins, *outs)]
    lib = _build(path.read_text(), "mlstm_bwd_cut", ("MLSTM_BWD_CUT=1",),
                 path.parent)
    for route in ("wgmma", "simt"):
        call = _launcher(lib, f"mlstm_attention_backward_{route}_bf16",
                         _MLSTM_BWD_ARGTYPES)
        run = lambda: call(*ptrs, B, S, H, hd)  # noqa: E731
        print(f"mlstm_attention_backward {MLSTM_BWD_SHAPE} bf16 {route}, the "
              f"products alone: {_events_ms(run, 5):.4f} ms (events; output "
              f"wrong)", flush=True)
        _print_kernels(_by_kernel(run, 10))


def _empty_launch():
    fn = _build(_EMPTY_SRC, "empty").empty_launch
    fn.argtypes, fn.restype = [_I, _I, _P], ctypes.c_int

    def call(blocks, threads):
        if fn(blocks, threads, torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("empty kernel launch failed")
    return call


def _exchange_stages() -> None:
    """The edge-major ops' kernels at graph coloring's torus-4096 edge
    layout, device time of each under the profiler, beside an empty
    kernel on the same grids and ``clone()`` of both rings (the launch
    ramp and a copy of the bytes the send moves)."""
    from repro_torch.kernels.duct_exchange.ops import (
        duct_drain,
        duct_exchange,
        duct_send,
    )
    E, C, pops = EXCHANGE_SHAPE
    a = exchange_args(E, C)
    for label, run in (
            ("drain", lambda: duct_drain(*a[:6], max_pops=pops)),
            ("send", lambda: duct_send(*a[:4], *a[6:], capacity=C)),
            ("full", lambda: duct_exchange(*a, capacity=C, max_pops=pops)),
            ("clone of q_avail and q_touch",
             lambda: (a[0].clone(), a[1].clone()))):
        print(f"duct_exchange (E {E}, C {C}) {label}: "
              f"{_events_ms(run, 50):.4f} ms a call (events)", flush=True)
        _print_kernels(_by_kernel(run, 50))
    empty = _empty_launch()
    for label, blocks, threads in EMPTY_GRIDS:
        run = lambda: empty(blocks, threads)  # noqa: E731
        print(f"empty kernel on {label} ({blocks} x {threads}): "
              f"{_events_ms(run, 50):.4f} ms a call (events)", flush=True)
        _print_kernels(_by_kernel(run, 50))


def before(topk_src: Path | None = None, window_src: Path | None = None,
           mlstm_src: Path | None = None, commit_src: Path | None = None,
           scan_src: Path | None = None,
           exchange_src: Path | None = None,
           scan_backward_src: Path | None = None) -> None:
    if topk_src is not None:
        _topk_before(topk_src)
    if window_src is not None:
        _window_before(window_src)
    if mlstm_src is not None:
        B, S, H, hd = MLSTM_SHAPE
        args = mlstm_args(*MLSTM_SHAPE)
        out = torch.empty_like(args[0])
        ptrs = [t.data_ptr() for t in (*args, out)]
        call = _launcher(_build(mlstm_src.read_text(), "mlstm_before"),
                         "mlstm_attention_bf16", _MLSTM_ARGTYPES)
        print(f"mlstm_attention before {MLSTM_SHAPE} bf16: "
              f"{_events_ms(lambda: call(*ptrs, B, S, H, hd), 10):.4f} ms",
              flush=True)
    if commit_src is not None:
        _commit_before(commit_src)
    if scan_src is not None:
        Bb, S, di, N = SCAN_SHAPE
        args = scan_args(*SCAN_SHAPE)
        outs = [torch.empty((Bb, S, di), dtype=torch.float32, device="cuda"),
                torch.empty((Bb, di, N), dtype=torch.float32, device="cuda")]
        ptrs = [t.data_ptr() for t in (*args, *outs)]
        call = _launcher(_build(scan_src.read_text(), "scan_before"),
                         "mamba_scan_f32", _SCAN_BEFORE_ARGTYPES)
        print(f"mamba_scan before {SCAN_SHAPE}: "
              f"{_events_ms(lambda: call(*ptrs, Bb, S, di, N), 10):.4f} ms",
              flush=True)
    if exchange_src is not None:
        _exchange_before(exchange_src)
    if scan_backward_src is not None:
        _scan_backward_before(scan_backward_src)


#: the earlier scan backward's dB / dC partial writes, which its cut
#: removes
_SCAN_BWD_PARTIALS = ("      part_dB[off] = vb;\n"
                      "      part_dC[off] = vc;\n")


def _scan_backward_before(src: Path) -> None:
    """The earlier backward (a first pass that ran the forward recurrence
    for the boundary scratch, then the chunks with a_t computed again, a
    thread per (b, d, n)) on ``_scan_bwd_stages``'s inputs, as built,
    without expf and without its dB / dC partial writes (both outputs
    wrong)."""
    Bb, S, di, N = SCAN_BWD_SHAPE
    text = src.read_text()
    if _SCAN_BWD_PARTIALS not in text:
        raise ValueError(f"{src}: no dB / dC partial writes to cut")
    keep, ptrs = _scan_bwd_buffers(SCAN_BWD_SHAPE, -(-di // (256 // N)),
                                   before=True)
    for label, variant in (
            ("as built", text),
            ("no expf (1 + x)", "#define expf(x) (1.f + (x))\n" + text),
            ("no dB / dC partial writes",
             text.replace(_SCAN_BWD_PARTIALS, ""))):
        call = _launcher(_build(variant, "scan_bwd_before"),
                         "mamba_scan_backward_f32", _SCAN_BWD_ARGTYPES)
        run = lambda: call(*ptrs, Bb, S, di, N)  # noqa: E731
        note = "" if variant is text else " (output wrong)"
        print(f"mamba_scan_backward before {SCAN_BWD_SHAPE}, {label}: "
              f"{_events_ms(run, 10):.4f} ms (events){note}", flush=True)
    del keep


def _exchange_before(src: Path) -> None:
    """The fused kernel (one entry point for all three forms) on the
    inputs of ``_exchange_stages``: full, drain (every sender inactive,
    zero vectors) and send (every receiver inactive, max_pops 0), as the
    ops called it."""
    E, C, pops = EXCHANGE_SHAPE
    a = exchange_args(E, C)
    zf = torch.zeros(E, dtype=torch.float32, device="cuda")
    zb = torch.zeros(E, dtype=torch.bool, device="cuda")
    zi = torch.zeros(E, dtype=torch.int32, device="cuda")
    outs = [torch.empty(s, dtype=t, device="cuda") for s, t in (
        ((E, C), torch.float32), ((E, C), torch.int32), (E, torch.int32),
        (E, torch.int32), (E, torch.int32), (E, torch.int32),
        (E, torch.int32), (E, torch.bool), (E, torch.int32))]
    call = _launcher(_build(src.read_text(), "exchange_before"),
                     "duct_exchange", _EXCHANGE_ARGTYPES)
    for label, ins, max_pops in (
            ("full", a, pops),
            ("drain", a[:6] + [zf, zb, zf, zi], pops),
            ("send", a[:4] + [zf, zb] + a[6:], 0)):
        ptrs = [t.data_ptr() for t in (*ins, *outs)]
        ms = _events_ms(lambda: call(*ptrs, E, C, C, max_pops), 50, 3)
        print(f"duct_exchange before (E {E}, C {C}) {label}: {ms:.4f} ms",
              flush=True)


def _commit_before(src: Path) -> None:
    text = src.read_text()
    cut = text
    for copy in _COMMIT_COPIES:
        if text.count(copy) != 1:
            raise SystemExit(f"{src}: payload copy not found once: "
                             f"{copy!r}")
        cut = cut.replace(copy, "")
    for R, C, L, W, pay in COMMIT_SHAPES:
        args = commit_args(R, C, L, W, pay)
        outs = [torch.empty((R, C), dtype=torch.float32, device="cuda"),
                torch.empty((R, C), dtype=torch.int32, device="cuda"),
                torch.empty((R, C, L), dtype=pay, device="cuda")]
        ptrs = [t.data_ptr() for t in (*args, *outs)]
        entry = "duct_commit_f32" if pay == torch.float32 else \
            "duct_commit_i32"
        for label, text_ in (("whole kernel", text),
                             ("no payload copy", cut)):
            call = _launcher(_build(text_, "commit_before"), entry,
                             _COMMIT_ARGTYPES)
            ms = _events_ms(lambda: call(*ptrs, R, C, W, L), 50, 3)
            print(f"duct_commit before {(R, C, L, W)} {pay} {label}: "
                  f"{ms:.4f} ms", flush=True)


def _topk_before(topk_src: Path) -> None:
    text = topk_src.read_text()
    for anchor, cut in _TOPK_CUTS:
        if text.count(anchor) != 1:
            raise SystemExit(f"{topk_src}: cut anchor not found once: "
                             f"{anchor!r}")
        text = text.replace(anchor, anchor + cut)
    nb, block, k = TOPK_SHAPE
    x = grad_rows(nb, block)
    outs = [torch.empty((nb, k), dtype=torch.float32, device="cuda"),
            torch.empty((nb, k), dtype=torch.int32, device="cuda")]
    scratch = torch.empty((4, nb, k), dtype=torch.int32, device="cuda")
    ptrs = [t.data_ptr() for t in (x, *outs, *scratch.unbind(0))]
    times = {}
    for stop, label in ((1, "select (4 radix passes)"),
                        (2, "select + compaction"), (0, "whole kernel")):
        fn = _build(text, "topk_before", (f"STOP={stop}",)).topk_compress
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int,
                                               ctypes.c_longlong,
                                               ctypes.c_int, ctypes.c_void_p]
        stream = torch.cuda.current_stream().cuda_stream

        def call(fn=fn):
            if fn(*ptrs, nb, block, k, stream) != 0:
                raise RuntimeError("launch failed")
        times[label] = _events_ms(call, 5, 1)
        print(f"topk_compress before {TOPK_SHAPE} {label}: "
              f"{times[label]:.4f} ms", flush=True)
    del x, outs, scratch


def _window_before(window_src: Path) -> None:
    wtext = window_src.read_text()
    if wtext.count(_WINDOW_COPY) != 1:
        raise SystemExit(f"{window_src}: payload copy not found once")
    args = window_args(*WINDOW_SHAPE[:4])
    n, d, C, L, pops = WINDOW_SHAPE
    outs = [torch.empty(s, dtype=t, device="cuda") for s, t in (
        ((n, d, C), torch.float32), ((n, d, C), torch.int32),
        ((n, d, C, L), torch.float32), ((n, d), torch.int32),
        ((n, d), torch.int32), ((n, d), torch.int32), ((n, d), torch.int32),
        ((n, 4, L), torch.float32), ((n, 4), torch.bool))]
    ptrs = [t.data_ptr() for t in (*args, *outs)]
    for label, src in (("whole kernel", wtext),
                       ("no payload copy", wtext.replace(_WINDOW_COPY, ""))):
        fn = _build(src, "window_before").duct_window_f32
        fn.argtypes = [ctypes.c_void_p] * 21 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        stream = torch.cuda.current_stream().cuda_stream

        def call(fn=fn):
            if fn(*ptrs, n, d, C, L, pops, stream) != 0:
                raise RuntimeError("launch failed")
        print(f"duct_window_f32 before {WINDOW_SHAPE[:4]} {label}: "
              f"{_events_ms(call, 50, 3):.4f} ms", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="what", required=True)
    st = sub.add_parser("stages")
    st.add_argument("--only", nargs="+", choices=STAGES, default=STAGES,
                    help="which kernels (default: all)")
    b = sub.add_parser("before")
    for name in ("topk", "window", "mlstm", "commit", "scan", "exchange",
                 "scan-backward"):
        b.add_argument(f"--{name}", type=Path, metavar="SRC",
                       help=f"an earlier {name} source (git show)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ablation: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    if args.what == "stages":
        stages(args.only)
    else:
        before(args.topk, args.window, args.mlstm, args.commit, args.scan,
               args.exchange, args.scan_backward)
    return 0


if __name__ == "__main__":
    sys.exit(main())
