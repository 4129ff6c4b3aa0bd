"""Hand-written CUDA blockwise magnitude top-k, bound with ctypes.

``csrc/topk_compress.cu`` -> ``topk_compress``, float32; replaces
src/repro/kernels/topk_compress/kernel.py:_topk_kernel (Pallas TPU).  The
top-k compressor launches it once per gradient leaf per pod.  It is bound
by bytes (the source's header gives the numbers and the design).

The wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates the outputs and the kernel's scratch (two buffers of
k keys and k indices per row) with ``torch.empty``, launches on the
current stream, raises if the launch reports an error, and counts the
launch in ``build.LAUNCHES["topk_compress"]``.  There is no fallback:
``ops.py`` sends CPU tensors to the plain torch version before anything
here is reached.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import check_tensor, launch, load

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: x, vals, idx, keys_a, idx_a, keys_b, idx_b; nb, block, k; stream
_ARGTYPES = [_P] * 7 + [_I, _L, _I, _P]


def topk_compress_cuda(x: torch.Tensor, k: int):
    """x: (nb, block) float32, contiguous, on the card.  Returns (values
    (nb, k) float32, indices (nb, k) int32), per row by |x| descending,
    ties to the lower index."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"topk_compress_cuda needs a CUDA tensor, got {dev}")
    if x.ndim != 2:
        raise ValueError(f"topk_compress_cuda takes (nb, block), got "
                         f"{tuple(x.shape)}")
    nb, block = x.shape
    if not 1 <= nb < 2 ** 31 or not 1 <= block < 2 ** 31:
        raise ValueError(f"topk_compress_cuda takes nb and block in "
                         f"[1, 2^31), got {nb} and {block}")
    if not 0 < k <= block:
        raise ValueError(f"k must lie in [1, {block}], got {k}")
    check_tensor(x, "x", (nb, block), torch.float32, dev)
    lib = load("topk_compress", {"topk_compress": _ARGTYPES})
    vals = torch.empty((nb, k), dtype=torch.float32, device=dev)
    idx = torch.empty((nb, k), dtype=torch.int32, device=dev)
    # keys are uint32 in the kernel; int32 storage of the same width
    scratch = torch.empty((4, nb, k), dtype=torch.int32, device=dev)
    launch(lib.topk_compress, (x, vals, idx, *scratch.unbind(0)),
           (nb, block, k), dev, "topk_compress")
    return vals, idx
