"""Ablations of the top-k and duct-window kernels on the card: where a
kernel's time goes.

Two measurements, each printed as one line per variant:

* ``stages``: the current ``topk_compress`` and ``duct_window`` through
  their wrappers, under ``torch.profiler``, with the device time of each
  ``__global__`` kernel they launch; and the top-k source built again
  with the select histograms merged by ``__match_any_sync`` before their
  shared-memory atomics, without those atomics, and without the level-0
  filter's appends (the last two time the streams alone; their outputs
  are wrong);
* ``before SRC_TOPK SRC_WINDOW``: the one-block-a-row top-k source and the
  one-thread-a-ring-row window source of the git history
  (``git show <commit>:src/repro_torch/kernels/...``), built three times
  with early exits after the radix select and after the compaction, and
  the window built without its payload copy, each timed with CUDA events.

Run on the card from the repository root::

    PYTHONPATH=src python -m repro_torch.kernels.ablation stages
    PYTHONPATH=src python -m repro_torch.kernels.ablation before \\
        build/before/topk_compress.cu build/before/duct_window.cu

Shapes: top-k at qwen2-1.5b's stacked MLP rows, (28, 13,762,560), k =
137,625; the window at evo's torus-1024 (1024, 4, 64, 60) float32.
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


def _build(src_text: str, tag: str, defines=()) -> ctypes.CDLL:
    """Compile ``src_text`` with ``-D`` ``defines`` into build/ablation/
    and load it."""
    out_dir = K.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    digest = hashlib.sha256((src_text + repr(defines)).encode()).hexdigest()
    src = out_dir / f"{tag}-{digest[:12]}.cu"
    lib = src.with_suffix(".so")
    if not lib.exists():
        src.write_text(src_text)
        cmd = [K._nvcc(), *K.NVCC_FLAGS, *[f"-D{d}" for d in defines],
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


def stages() -> None:
    from repro_torch.kernels.duct_exchange.ops import duct_window
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
        for name, ms, count in rows:
            print(f"  {name[:60]:60s} {ms:.4f} ms in {count} launches")
    del x, want, got
    args = window_args(*WINDOW_SHAPE[:4])
    pops = WINDOW_SHAPE[4]
    wrun = lambda: duct_window(*args, max_pops=pops)  # noqa: E731
    print(f"duct_window_f32 {WINDOW_SHAPE[:4]}: {_events_ms(wrun, 50):.4f} "
          f"ms a call (events)")
    for name, ms, count in _by_kernel(wrun, 50):
        print(f"  {name[:60]:60s} {ms:.4f} ms in {count} launches")


def before(topk_src: Path, window_src: Path) -> None:
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
    sub.add_parser("stages")
    b = sub.add_parser("before")
    b.add_argument("topk_src", type=Path)
    b.add_argument("window_src", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ablation: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    if args.what == "stages":
        stages()
    else:
        before(args.topk_src, args.window_src)
    return 0


if __name__ == "__main__":
    sys.exit(main())
