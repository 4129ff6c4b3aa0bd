"""Hand-written CUDA Mamba-1 selective scan and its gradient, bound with
ctypes.

``csrc/mamba_scan.cu`` holds two routes, picked by ``route`` from the
channel count and the state size before the launch (never after a
failure):

* ``"tma"``: di a multiple of 4 (``mamba_scan_tma_f32``): x and dt tiles
  and the B and C rows stream through a shared-memory ring, loaded by TMA
  through tensor maps whose strides must be multiples of 16 bytes;
* ``"simt"``: any other di (``mamba_scan_simt_f32``): each thread loads
  its own x and dt from global memory, one step ahead.

Both replace src/repro/kernels/mamba_scan/kernel.py:_mamba_kernel (Pallas
TPU), once per Mamba layer per prefill or training forward
(``models.ssm.mamba_forward``; twice a train step under ``remat``), and
both count as a launch of ``mamba_scan`` (``build.LAUNCHES``);
``build.ROUTES`` counts them by route.  The scan is bound by bytes, with
the special-function units close behind (the source's header gives the
numbers and the design).

Both write the states after every ``SAVED_EVERY`` steps when asked
(``bounds=True``): ``ops._MambaScan`` asks when it saves for a backward;
the serving prefill does not, and writes nothing more.

``csrc/mamba_scan_backward.cu`` holds the gradient
(``mamba_scan_backward_f32``, any di): it replaces no Pallas kernel (the
reference differentiates its jnp scan), runs once per Mamba layer per
train step and counts as a launch of ``mamba_scan_backward``.  It
recomputes each chunk of ``SAVED_EVERY`` steps once from the forward's
saved states; a caller without them has the wrapper run the forward for
them first (a launch of ``mamba_scan``).

The wrappers take CUDA tensors only: they check device, dtype, shape,
contiguity and alignment, allocate the outputs with ``torch.empty``,
launch on the current stream, raise if the launch reports an error,
and count the launch.  There is no fallback: ``ops.py`` sends CPU tensors
to the plain torch versions before anything here is reached.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import check_tensor, launch, load
from repro_torch.kernels.mamba_scan.ops import SAVED_EVERY

_P, _I = ctypes.c_void_p, ctypes.c_int
#: x, dt, B, C, A, y, h, the saved states (null: none); Bb, S, di, N;
#: stream
_ARGTYPES = [_P] * 8 + [_I] * 4 + [_P]
_ENTRIES = ("mamba_scan_tma_f32", "mamba_scan_simt_f32")

#: the state sizes the kernel is instantiated for
STATE_SIZES = (4, 8, 16, 32)
#: TMA reads from 16-byte aligned addresses with 16-byte strides
ALIGN = 16


def saved_shape(Bb: int, S: int, di: int, N: int):
    """The saved states' shape: h after every ``SAVED_EVERY`` steps but
    the last chunk's, (Bb, ceil(S / SAVED_EVERY) - 1, di, N)."""
    return (Bb, -(-S // SAVED_EVERY) - 1, di, N)


def route(di: int, N: int) -> str:
    """The kernel that scans ``di`` channels of state size ``N``:
    ``"tma"`` where a row of x (di float32) is a multiple of 16 bytes,
    the tensor maps' stride rule, else ``"simt"``.  B and C rows (N
    float32, N in ``STATE_SIZES``) always are."""
    return "tma" if di % 4 == 0 else "simt"


def _lib():
    return load("mamba_scan", {e: _ARGTYPES for e in _ENTRIES})


def blocks_per_sm(route_name: str, N: int) -> int:
    """Blocks of ``route_name``'s kernel at state size ``N`` that fit on
    one SM of the current card, with the route's shared memory and
    registers (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    if N not in STATE_SIZES or route_name not in ("tma", "simt"):
        raise ValueError(f"no {route_name} kernel at N = {N}")
    fn = _lib().mamba_scan_blocks_per_sm
    fn.argtypes, fn.restype = [_I, _I, ctypes.POINTER(_I)], ctypes.c_int
    blocks = _I(-1)
    err = fn(int(route_name == "tma"), N, ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"mamba_scan_blocks_per_sm failed with CUDA "
                           f"error {err}")
    return blocks.value


def mamba_scan_cuda(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                    C: torch.Tensor, A: torch.Tensor, *, simt: bool = False,
                    bounds: bool = False):
    """x, dt: (Bb, S, di); B, C: (Bb, S, N); A: (di, N); all float32,
    contiguous, on the card.  Returns (y (Bb, S, di), h_final
    (Bb, di, N)), both float32, and with ``bounds=True`` also the saved
    states (``saved_shape``) for the backward.  ``simt=True`` takes the
    ``simt`` route where ``route`` would take ``tma``: the chip smoke
    test, the card tests and the ablation time both routes on the same
    inputs; the model's path never passes it."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"mamba_scan_cuda needs CUDA tensors, got {dev}")
    if x.ndim != 3 or A.ndim != 2:
        raise ValueError(f"mamba_scan_cuda takes x (Bb, S, di) and A "
                         f"(di, N), got {tuple(x.shape)} and "
                         f"{tuple(A.shape)}")
    Bb, S, di = x.shape
    N = A.shape[1]
    if N not in STATE_SIZES:
        raise ValueError(f"mamba_scan_cuda takes N in {STATE_SIZES}, got {N}")
    if not (1 <= Bb <= 65535 and 1 <= S < 2 ** 31 and 1 <= di < 2 ** 31):
        raise ValueError(f"mamba_scan_cuda takes Bb in [1, 65535] and S, di "
                         f"in [1, 2^31), got {tuple(x.shape)}")
    f32 = torch.float32
    check_tensor(x, "x", (Bb, S, di), f32, dev)
    check_tensor(dt, "dt", (Bb, S, di), f32, dev)
    check_tensor(B, "B", (Bb, S, N), f32, dev)
    check_tensor(C, "C", (Bb, S, N), f32, dev)
    check_tensor(A, "A", (di, N), f32, dev)
    name = "simt" if simt else route(di, N)
    if name == "tma" and any(t.data_ptr() % ALIGN for t in (x, dt, B, C)):
        raise ValueError(f"mamba_scan_cuda's tma route reads x, dt, B and C "
                         f"by TMA from {ALIGN}-byte aligned addresses")
    lib = _lib()
    y = torch.empty((Bb, S, di), dtype=f32, device=dev)
    h = torch.empty((Bb, di, N), dtype=f32, device=dev)
    hb = torch.empty(saved_shape(Bb, S, di, N), dtype=f32, device=dev) \
        if bounds else None
    launch(getattr(lib, f"mamba_scan_{name}_f32"),
           (x, dt, B, C, A, y, h, hb if hb is not None and hb.numel() else
            None), (Bb, S, di, N), dev, "mamba_scan", route=name)
    return (y, h) if hb is None else (y, h, hb)


#: x, dt, B, C, A, dy, dh_final, the saved states, dx, ddt, dB, dC, dA,
#: the scratch (dB / dC / dA partials); Bb, S, di, N; stream
_BACKWARD_ARGTYPES = [_P] * 16 + [_I] * 4 + [_P]


def _backward_lib():
    return load("mamba_scan_backward",
                {"mamba_scan_backward_f32": _BACKWARD_ARGTYPES})


def backward_geometry(N: int):
    """(steps a chunk, channels a block) of the backward kernel at state
    size ``N``: the channels size its scratch, and the chunk must be the
    forward's ``SAVED_EVERY`` (checked here)."""
    fn = _backward_lib().mamba_scan_backward_geometry
    fn.argtypes = [_I, ctypes.POINTER(_I), ctypes.POINTER(_I)]
    fn.restype = ctypes.c_int
    chunk, channels = _I(-1), _I(-1)
    if fn(N, ctypes.byref(chunk), ctypes.byref(channels)) != 0:
        raise ValueError(f"mamba_scan_backward has no kernel at N = {N}")
    if chunk.value != SAVED_EVERY:
        raise RuntimeError(f"mamba_scan_backward recomputes chunks of "
                           f"{chunk.value} steps; the forward saves states "
                           f"every {SAVED_EVERY}")
    return chunk.value, channels.value


def mamba_scan_backward_cuda(x: torch.Tensor, dt: torch.Tensor,
                             B: torch.Tensor, C: torch.Tensor,
                             A: torch.Tensor, dy: torch.Tensor,
                             dh_final: torch.Tensor | None = None,
                             hbound: torch.Tensor | None = None):
    """The gradient of the scan: x, dt, dy (Bb, S, di); B, C (Bb, S, N); A
    (di, N); dh_final (Bb, di, N) or None (zero); hbound, the forward's
    saved states (``saved_shape``), or None: then ``mamba_scan_cuda(...,
    bounds=True)`` runs first for them; all float32, contiguous, on the
    card.  Returns (dx, ddt, dB, dC, dA), float32, in the inputs' shapes.
    One launch of ``mamba_scan_backward_f32`` (the backward kernel, then
    the kernel that adds its partials in a fixed order), any di; the
    scratch (the partial sums) is allocated here and dropped on return."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"mamba_scan_backward_cuda needs CUDA tensors, got "
                         f"{dev}")
    if x.ndim != 3 or A.ndim != 2:
        raise ValueError(f"mamba_scan_backward_cuda takes x (Bb, S, di) and "
                         f"A (di, N), got {tuple(x.shape)} and "
                         f"{tuple(A.shape)}")
    Bb, S, di = x.shape
    N = A.shape[1]
    if N not in STATE_SIZES:
        raise ValueError(f"mamba_scan_backward_cuda takes N in "
                         f"{STATE_SIZES}, got {N}")
    if not (1 <= Bb <= 65535 and 1 <= S < 2 ** 31 and 1 <= di < 2 ** 31):
        raise ValueError(f"mamba_scan_backward_cuda takes Bb in [1, 65535] "
                         f"and S, di in [1, 2^31), got {tuple(x.shape)}")
    f32 = torch.float32
    for t, name, shape in ((x, "x", (Bb, S, di)), (dt, "dt", (Bb, S, di)),
                           (B, "B", (Bb, S, N)), (C, "C", (Bb, S, N)),
                           (A, "A", (di, N)), (dy, "dy", (Bb, S, di))):
        check_tensor(t, name, shape, f32, dev)
    if dh_final is not None:
        check_tensor(dh_final, "dh_final", (Bb, di, N), f32, dev)
    if hbound is None:
        hbound = mamba_scan_cuda(x, dt, B, C, A, bounds=True)[2]
    check_tensor(hbound, "hbound", saved_shape(Bb, S, di, N), f32, dev)
    if hbound.data_ptr() % ALIGN:
        raise ValueError(f"mamba_scan_backward_cuda reads hbound as float4 "
                         f"from {ALIGN}-byte aligned addresses")
    _, channels = backward_geometry(N)
    blocks = -(-di // channels)
    dx, ddt = torch.empty_like(x), torch.empty_like(x)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    dA = torch.empty_like(A)
    part_dB = torch.empty((Bb, blocks, S, N), dtype=f32, device=dev)
    part_dC = torch.empty_like(part_dB)
    part_dA = torch.empty((Bb, di, N), dtype=f32, device=dev)
    launch(_backward_lib().mamba_scan_backward_f32,
           (x, dt, B, C, A, dy, dh_final, hbound if hbound.numel() else None,
            dx, ddt, dB, dC, dA, part_dB, part_dC, part_dA), (Bb, S, di, N),
           dev, "mamba_scan_backward")
    return dx, ddt, dB, dC, dA
