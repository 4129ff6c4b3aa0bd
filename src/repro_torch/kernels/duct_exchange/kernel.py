"""Hand-written CUDA kernels for the dense duct layout, bound with ctypes.

Two kernels, each in its own source under ``csrc/`` and compiled by
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface:

  duct_window  csrc/duct_window.cu -> duct_window_i32
               replaces src/repro/kernels/duct_exchange/kernel.py
               :_window_kernel (Pallas TPU), once per window per bucket
  duct_commit  csrc/duct_commit.cu -> duct_commit_i32
               replaces src/repro/kernels/duct_exchange/kernel.py
               :_commit_kernel (Pallas TPU), once per W-window superstep

Both are bound by bytes moved (integer compares and copies over the ring
state); the headers of the two sources give the design.  The libraries are
built on first use into ``build/`` at the repository root, named by a hash
of their source so an edited source is rebuilt; ``build()`` compiles every
missing one with one ``nvcc`` per source, all started together.

The wrappers take CUDA tensors only: they check device, dtype, shape and
contiguity, allocate the outputs with ``torch.empty``, launch on the
current stream, raise if the launch reports an error, and count each
launch in ``LAUNCHES``.  There is no fallback: ``ops.py`` sends CPU tensors
to the plain torch versions before anything here is reached.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

import torch

#: kernel name -> source file under csrc/
SOURCES = {"duct_window": "duct_window.cu", "duct_commit": "duct_commit.cu"}

#: launches per kernel since the last reset_launches(); a wrapper adds one
#: exactly where it launches its kernel
LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_CSRC = Path(__file__).resolve().parent / "csrc"
#: build/ at the repository root (src/repro_torch/kernels/duct_exchange/..)
BUILD_DIR = Path(__file__).resolve().parents[4] / "build"

_LIBS: Dict[str, ctypes.CDLL] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C signature of each library's int32-payload launcher: tensor pointers,
#: then the shape ints, then the stream
_ARGTYPES = {
    "duct_window": [_P] * 21 + [_I] * 5 + [_P],
    "duct_commit": [_P] * 12 + [ctypes.c_longlong] + [_I] * 3 + [_P],
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def library_path(name: str) -> Path:
    src = _CSRC / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the "
            "CUDA duct kernels are compiled from source on first use")
    return path


def build(names: Iterable[str] = tuple(SOURCES)) -> float:
    """Compile every kernel in ``names`` whose library is missing, one
    ``nvcc`` per source, all started together.  Returns wall seconds."""
    t0 = time.perf_counter()
    todo = [(n, library_path(n)) for n in names]
    todo = [(n, out) for n, out in todo if not out.exists()]
    if not todo:
        return time.perf_counter() - t0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / SOURCES[name])]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{SOURCES[name]}:\n{err}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def _lib(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        fn = getattr(lib, f"{name}_i32")
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def _check(x: torch.Tensor, name: str, shape: Tuple[int, ...], dtype,
           device: torch.device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(fn, tensors, ints, device: torch.device, kernel: str) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*[t.data_ptr() for t in tensors], *ints, stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed with CUDA error "
                           f"{err}")
    LAUNCHES[kernel] += 1


def duct_window_cuda(q_avail, q_touch, q_pay, head, size,
                     push_pos, push_acc, push_avail, push_touch, push_pay,
                     recv_now, recv_active, *, max_pops: int):
    """Launch the fused window kernel; returns the ``ops.WindowResult``
    field tuple.  Rings are ``(n, d, C)``, payloads int32 ``(n, d, C, L)``."""
    dev = q_avail.device
    if dev.type != "cuda":
        raise ValueError(f"duct_window_cuda needs CUDA tensors, got {dev}")
    n, d, C = q_avail.shape
    L = q_pay.shape[-1]
    if q_pay.dtype != torch.int32:
        raise TypeError(f"duct_window_cuda takes int32 payloads, got "
                        f"{q_pay.dtype}")
    if d > 1024:
        raise ValueError(f"duct_window_cuda holds one receiver's {d} rows in "
                         "one block; at most 1024 rows per receiver")
    i32, f32, b8 = torch.int32, torch.float32, torch.bool
    for x, nm, shp, dt in (
            (q_avail, "q_avail", (n, d, C), f32),
            (q_touch, "q_touch", (n, d, C), i32),
            (q_pay, "q_pay", (n, d, C, L), i32),
            (head, "head", (n, d), i32), (size, "size", (n, d), i32),
            (push_pos, "push_pos", (n, d), i32),
            (push_acc, "push_acc", (n, d), b8),
            (push_avail, "push_avail", (n, d), f32),
            (push_touch, "push_touch", (n, d), i32),
            (push_pay, "push_pay", (n, d, L), i32),
            (recv_now, "recv_now", (n,), f32),
            (recv_active, "recv_active", (n,), b8)):
        _check(x, nm, shp, dt, dev)

    def out(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    outs = (out((n, d, C), f32), out((n, d, C), i32), out((n, d, C, L), i32),
            out((n, d), i32), out((n, d), i32), out((n, d), i32),
            out((n, d), i32), out((n, 4, L), i32), out((n, 4), b8))
    _launch(_lib("duct_window").duct_window_i32,
            (q_avail, q_touch, q_pay, head, size, push_pos, push_acc,
             push_avail, push_touch, push_pay, recv_now, recv_active) + outs,
            (n, d, C, L, max_pops), dev, "duct_window")
    return outs


def duct_commit_cuda(q_avail, q_touch, q_pay, head, size0, pb_cnt,
                     pb_avail, pb_touch, pb_pay):
    """Launch the superstep commit kernel; returns the
    ``ops.CommitResult`` field tuple.  Rings are ``(R, C)``, the pushbuf
    ``(R, W)``, payloads int32."""
    dev = q_avail.device
    if dev.type != "cuda":
        raise ValueError(f"duct_commit_cuda needs CUDA tensors, got {dev}")
    R, C = q_avail.shape
    W = pb_avail.shape[-1]
    L = q_pay.shape[-1]
    if q_pay.dtype != torch.int32:
        raise TypeError(f"duct_commit_cuda takes int32 payloads, got "
                        f"{q_pay.dtype}")
    i32, f32 = torch.int32, torch.float32
    for x, nm, shp, dt in (
            (q_avail, "q_avail", (R, C), f32),
            (q_touch, "q_touch", (R, C), i32),
            (q_pay, "q_pay", (R, C, L), i32),
            (head, "head", (R,), i32), (size0, "size0", (R,), i32),
            (pb_cnt, "pb_cnt", (R,), i32),
            (pb_avail, "pb_avail", (R, W), f32),
            (pb_touch, "pb_touch", (R, W), i32),
            (pb_pay, "pb_pay", (R, W, L), i32)):
        _check(x, nm, shp, dt, dev)
    outs = (torch.empty((R, C), dtype=f32, device=dev),
            torch.empty((R, C), dtype=i32, device=dev),
            torch.empty((R, C, L), dtype=i32, device=dev))
    _launch(_lib("duct_commit").duct_commit_i32,
            (q_avail, q_touch, q_pay, head, size0, pb_cnt, pb_avail,
             pb_touch, pb_pay) + outs,
            (R, C, W, L), dev, "duct_commit")
    return outs
