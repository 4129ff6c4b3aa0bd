"""Hand-written CUDA blockwise magnitude top-k, bound with ctypes.

``csrc/topk_compress.cu`` -> ``topk_compress``, float32; replaces
src/repro/kernels/topk_compress/kernel.py:_topk_kernel (Pallas TPU).  The
top-k compressor launches it once per gradient leaf per pod.  It is bound
by bytes (the source's header gives the numbers and the design).

One entry point, two routes picked by ``route`` before the launch (never
after a failure), each counted in ``build.ROUTES``:

* ``"row"``: rows of at most ``ROW_MAX`` entries, one block a row, one
  device kernel;
* ``"split"``: longer rows, each cut into chunks of ``CHUNK`` entries: a
  radix select over ``select_digits(block)`` (two device kernels a level;
  a level whose row is done returns at once), a radix sort of the k
  winners over ``sort_shifts(block)`` (two a pass) and a gather that
  rebuilds the values from the sorted keys.

The helpers below are the launcher's arithmetic, written out in Python
for the CPU tests that emulate the split route.

The wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates the outputs and, on the split route, the kernel's
scratch with one ``torch.zeros`` (the select histograms, ``nb x 2048``
uint32; the select state, ``nb x 8`` int64; a ticket a row) and one
``torch.empty`` (two candidate buffers of ``capacity(block, k)`` and two
winner buffers of k split keys a row, uint64; the sort's digit counts,
``nb x ceil(k / 2048) x 256`` uint32), launches on the current
stream, raises if the launch reports an error, and counts the launch in
``build.LAUNCHES["topk_compress"]``.  There is no fallback: ``ops.py``
sends CPU tensors to the plain torch version before anything here is
reached.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import check_tensor, launch, load

#: route "row" takes rows of at most this many entries
ROW_MAX = 4096
#: entries of a row a block reads in one select pass (route "split")
CHUNK = 16384
#: digit width of the split route's select
SELECT_BITS = 11
#: the fewest candidates a row's buffer holds (route "split")
CAP_MIN = 1 << 15
#: keys a block of the split route's sort takes
SORT_TILE = 2048

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: x, vals, idx, zeroed, cand, wins, counts; nb, block, k, cap, route;
#: stream
_ARGTYPES = [_P] * 7 + [_I, _L, _I, _L, _I, _P]
_ROUTES = {"row": 0, "split": 1}


def route(block: int) -> str:
    """``"row"`` (one block a row) for rows of at most ``ROW_MAX``
    entries, else ``"split"`` (a row over many blocks)."""
    return "row" if block <= ROW_MAX else "split"


def index_bits(block: int) -> int:
    """b = ceil(log2 block): the composite key ``(bits(|x|) << b) | (block
    - 1 - i)`` keeps the index in its low b bits."""
    return (block - 1).bit_length()


def capacity(block: int, k: int) -> int:
    """Candidates a row's buffer holds on the split route: a bucket
    larger than this is refined by reading x again."""
    return min(block, max(k, CAP_MIN))


def split_key_bits(block: int) -> int:
    """Bits of the split route's key ``(composite << 1) | sign(x)``: the
    31 bits of |x|, b index bits and x's sign bit, which never decides an
    order and lets the values be rebuilt from the sorted keys."""
    return 32 + index_bits(block)


def select_digits(block: int):
    """The split route's select levels, top down: (shift, width) of each
    digit of the split key, the first over bits 30..20 of |x|, the last
    ending just above the sign bit."""
    shift, digits = split_key_bits(block) - 1, []
    while shift > 0:
        width = SELECT_BITS if not digits else min(SELECT_BITS, shift)
        shift -= width
        digits.append((shift + 1, width))
    return digits


def sort_shifts(block: int):
    """The split route's sort passes: the low bit of each 8-bit digit of
    the split key, least significant first."""
    return list(range(0, split_key_bits(block), 8))


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
    which = route(block)
    cap = 0
    zeroed = cand = wins = counts = None
    if which == "split":
        cap = capacity(block, k)
        tiles = -(-k // SORT_TILE)
        # int64 words: histograms (2048 uint32 a row), state, tickets
        zeroed = torch.zeros(nb * 1024 + nb * 8 + -(-nb // 2),
                             dtype=torch.int64, device=dev)
        words = 2 * nb * cap + 2 * nb * k
        scratch = torch.empty(words + -(-nb * 256 * tiles // 2),
                              dtype=torch.int64, device=dev)
        cand = scratch[:2 * nb * cap]
        wins = scratch[2 * nb * cap:words]
        counts = scratch[words:]
    launch(lib.topk_compress, (x, vals, idx, zeroed, cand, wins, counts),
           (nb, block, k, cap, _ROUTES[which]), dev, "topk_compress",
           route=which)
    return vals, idx
