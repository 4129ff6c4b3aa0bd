"""Build, load and launch the port's hand-written CUDA kernels.

Every kernel package keeps its sources under its own ``csrc/``; each source
is compiled by ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface, loaded with ctypes.  The libraries are built on first use into
``build/`` at the repository root, named by the source and a hash of it
and of the headers beside it, so an edited source or header is rebuilt;
``build()`` compiles every missing one with one ``nvcc`` per source, all
started together.

``LAUNCHES`` counts the launches of each kernel since the last
``reset_launches()``; ``launch`` adds one exactly where it launches a
kernel, and nowhere else adds to it.  A kernel with more than one route
(``flash_attention`` and ``mlstm_attention``: ``wgmma`` and ``simt``;
``topk_compress``: ``row`` and ``split``; ``mamba_scan``: ``tma`` and
``simt``; ``duct_exchange``: ``drain``, ``send`` and ``full``) also counts
each launch in ``ROUTES`` under ``"<kernel>/<route>"``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from collections.abc import Mapping
from pathlib import Path
from typing import Dict, Iterable, Sequence, Tuple

import torch

_KERNELS = Path(__file__).resolve().parent

#: kernel name -> its source, relative to src/repro_torch/kernels/ (one
#: source may hold several kernels: ``quantize.cu`` holds quantize and
#: dequantize, each counted under its own name)
SOURCES = {
    "duct_window": "duct_exchange/csrc/duct_window.cu",
    "duct_commit": "duct_exchange/csrc/duct_commit.cu",
    "duct_exchange": "duct_exchange/csrc/duct_exchange.cu",
    "flash_attention": "flash_attention/csrc/flash_attention.cu",
    "decode_attention": "decode_attention/csrc/decode_attention.cu",
    "quantize": "quantize/csrc/quantize.cu",
    "dequantize": "quantize/csrc/quantize.cu",
    "topk_compress": "topk_compress/csrc/topk_compress.cu",
    "mamba_scan": "mamba_scan/csrc/mamba_scan.cu",
    "mamba_scan_backward": "mamba_scan/csrc/mamba_scan_backward.cu",
    "mlstm_attention": "mlstm_attention/csrc/mlstm_attention.cu",
    "mlstm_attention_backward":
        "mlstm_attention/csrc/mlstm_attention_backward.cu",
}

#: launches per kernel since the last reset_launches()
LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}
#: launches per "<kernel>/<route>" since the last reset_launches()
ROUTES: Dict[str, int] = {}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

#: build/ at the repository root (src/repro_torch/kernels/..)
BUILD_DIR = _KERNELS.parents[2] / "build"

_LIBS: Dict[str, ctypes.CDLL] = {}


class LaunchCounts(Mapping):
    """The launch counts of some of the kernels: a live read-only view of
    ``LAUNCHES``."""

    def __init__(self, names: Iterable[str]):
        self._names = tuple(names)

    def __getitem__(self, name: str) -> int:
        if name not in self._names:
            raise KeyError(name)
        return LAUNCHES[name]

    def __iter__(self):
        return iter(self._names)

    def __len__(self) -> int:
        return len(self._names)

    def __repr__(self) -> str:
        return repr(dict(self))


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    ROUTES.clear()


def source_path(name: str) -> Path:
    return _KERNELS / SOURCES[name]


def library_path(name: str) -> Path:
    """The library built from kernel ``name``'s source, named by the
    source's stem and a hash of its text and of the headers (``*.cuh``)
    beside it, which it may include (kernels of one source share it)."""
    src = source_path(name)
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the "
            "CUDA kernels are compiled from source on first use")
    return path


def build(names: Iterable[str] = tuple(SOURCES)) -> float:
    """Compile every kernel in ``names`` whose library is missing, one
    ``nvcc`` per source, all started together.  Returns wall seconds."""
    t0 = time.perf_counter()
    todo = {library_path(n): n for n in names}   # one build per source
    todo = [(n, out) for out, n in todo.items() if not out.exists()]
    if not todo:
        return time.perf_counter() - t0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source_path(name))]
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


def ptxas_report(names: Iterable[str] = tuple(SOURCES)) -> str:
    """Compile each source of ``names`` once more, to an object file that
    is thrown away, with ``-Xptxas -v``: what ptxas says of each kernel
    (registers, shared memory, spills)."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    obj = BUILD_DIR / f"ptxas-{os.getpid()}.o"
    flags = [f for f in NVCC_FLAGS if f not in ("-shared",)]
    report = []
    for src in sorted({SOURCES[n] for n in names}):
        proc = subprocess.run(
            [nvcc, *flags, "-Xptxas", "-v", "-c", "-o", str(obj),
             str(_KERNELS / src)], capture_output=True, text=True)
        report.append(f"== {src} (nvcc exit {proc.returncode})\n"
                      f"{proc.stdout}{proc.stderr}")
    obj.unlink(missing_ok=True)
    return "\n".join(report)


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """Kernel ``name``'s library, built if missing, with each entry point
    of ``signatures`` given its ctypes argument types and an int result
    (the CUDA error code of the launch)."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    for entry, argtypes in signatures.items():
        fn = getattr(lib, entry)
        if fn.argtypes is None:
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
    return lib


def check_tensor(x: torch.Tensor, name: str, shape: Tuple[int, ...], dtype,
                 device: torch.device) -> None:
    """Raise unless ``x`` lies on ``device`` with this dtype and shape and
    is contiguous."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch(fn, tensors, scalars, device: torch.device, kernel: str,
           route: str | None = None) -> None:
    """Call launcher ``fn`` with the tensors' pointers (``None`` passes a
    null pointer, for an output the kernel may skip), the scalars and the
    current stream; raise if it reports a CUDA error, else count the
    launch (and its ``route``, where the kernel has more than one)."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*[None if t is None else t.data_ptr() for t in tensors],
                 *scalars, stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed with CUDA error "
                           f"{err}")
    LAUNCHES[kernel] += 1
    if route is not None:
        key = f"{kernel}/{route}"
        ROUTES[key] = ROUTES.get(key, 0) + 1


def device_kind(t: torch.Tensor, what: str) -> str:
    """``"cpu"`` (the plain torch version) or ``"cuda"`` (the hand-written
    kernel) for ``t``'s device; any other device raises."""
    kind = t.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(
            f"{what} run on cpu (plain torch) or cuda (hand-written "
            f"kernel); got a tensor on {t.device}")
    return kind


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(
        description="Build the port's CUDA kernels into build/, or print "
                    "what ptxas says of each (--ptxas).")
    ap.add_argument("names", nargs="*", default=list(SOURCES),
                    help=f"kernels (default: all of {sorted(SOURCES)})")
    ap.add_argument("--ptxas", action="store_true",
                    help="compile with -Xptxas -v and print its report")
    args = ap.parse_args()
    if args.ptxas:
        print(ptxas_report(args.names))
    else:
        print(f"built in {build(args.names):.1f}s into {BUILD_DIR}")
