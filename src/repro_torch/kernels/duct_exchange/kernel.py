"""Hand-written CUDA kernels for the duct ops, bound with ctypes.

Three kernels, each in its own source under ``csrc/`` and compiled by
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface:

  duct_window    csrc/duct_window.cu -> duct_window_i32 / duct_window_f32
                 replaces src/repro/kernels/duct_exchange/kernel.py
                 :_window_kernel (Pallas TPU), once per window per bucket
  duct_commit    csrc/duct_commit.cu -> duct_commit_i32 / duct_commit_f32
                 replaces src/repro/kernels/duct_exchange/kernel.py
                 :_commit_kernel (Pallas TPU), once per W-window superstep
  duct_exchange  csrc/duct_exchange.cu -> duct_drain / duct_send /
                 duct_exchange (routes ``drain``, ``send``, ``full``)
                 replaces src/repro/kernels/duct_exchange/kernel.py
                 :_duct_kernel (Pallas TPU), twice per edge-major window
                 (the drain, then the send)

The two dense kernels take int32 (graph coloring) or float32 (evo)
payloads, one entry point each, picked by the payload's dtype; the
edge-major kernel carries no payload.  All three are bound by bytes moved
(integer compares and copies over the ring state); the headers of the
sources give the design.  ``repro_torch.kernels.build`` builds the
libraries on first use, loads them and counts the launches.

The wrappers take CUDA tensors only: they check device, dtype, shape and
contiguity, allocate the outputs with ``torch.empty``, launch on the
current stream, raise if the launch reports an error, and count each
launch in ``LAUNCHES`` (the edge-major kernel's also by route in
``build.ROUTES``).  There is no fallback: ``ops.py`` sends CPU tensors
to the plain torch versions before anything here is reached.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import (  # noqa: F401
    LaunchCounts,
    build,
    check_tensor as _check,
    launch,
    load,
    reset_launches,
)

#: this package's kernels (their sources are keyed in ``build.SOURCES``)
KERNELS = ("duct_window", "duct_commit", "duct_exchange")

#: the duct kernels' launch counts: a live view of ``build.LAUNCHES``
LAUNCHES = LaunchCounts(KERNELS)

_P = ctypes.c_void_p
_I = ctypes.c_int
_WINDOW = [_P] * 21 + [_I] * 5 + [_P]
_COMMIT = [_P] * 12 + [ctypes.c_longlong] + [_I] * 3 + [_P]
#: each library's exported launchers (one per payload dtype where the kernel
#: carries a payload) and their C signatures: tensor pointers, then the
#: shape ints, then the stream
_ENTRY_POINTS = {
    "duct_window": {"duct_window_i32": _WINDOW, "duct_window_f32": _WINDOW},
    "duct_commit": {"duct_commit_i32": _COMMIT, "duct_commit_f32": _COMMIT},
    "duct_exchange": {"duct_exchange": [_P] * 19 + [_I] * 4 + [_P],
                      "duct_drain": [_P] * 12 + [_I] * 3 + [_P],
                      "duct_send": [_P] * 13 + [_I] * 3 + [_P]},
}
#: payload dtype -> entry-point suffix of the dense kernels
_PAYLOAD_SUFFIX = {torch.int32: "i32", torch.float32: "f32"}


def _lib(name: str) -> ctypes.CDLL:
    return load(name, _ENTRY_POINTS[name])


def _payload_entry(name: str, q_pay: torch.Tensor):
    """The launcher of kernel ``name`` for ``q_pay``'s dtype; any dtype
    but int32 and float32 raises."""
    suffix = _PAYLOAD_SUFFIX.get(q_pay.dtype)
    if suffix is None:
        raise TypeError(f"{name}_cuda takes int32 or float32 payloads, got "
                        f"{q_pay.dtype}")
    return getattr(_lib(name), f"{name}_{suffix}")


def duct_window_cuda(q_avail, q_touch, q_pay, head, size,
                     push_pos, push_acc, push_avail, push_touch, push_pay,
                     recv_now, recv_active, *, max_pops: int):
    """Launch the fused window kernel; returns the ``ops.WindowResult``
    field tuple.  Rings are ``(n, d, C)``, payloads ``(n, d, C, L)`` int32
    or float32.

    The halo select copies the winning row's freshest payload, where the
    reference's Pallas kernel and jnp twin (and ``duct_window_torch``) sum
    a one-hot over the ring slots.  The two agree bit for bit except on a
    float32 ``-0.0`` payload: the sum turns it into ``+0.0``, the copy
    keeps ``-0.0`` (as the reference's numpy oracle does)."""
    dev = q_avail.device
    if dev.type != "cuda":
        raise ValueError(f"duct_window_cuda needs CUDA tensors, got {dev}")
    n, d, C = q_avail.shape
    L = q_pay.shape[-1]
    fn = _payload_entry("duct_window", q_pay)
    if d > 1024:
        raise ValueError(f"duct_window_cuda holds one receiver's {d} rows in "
                         "one block; at most 1024 rows per receiver")
    i32, f32, b8 = torch.int32, torch.float32, torch.bool
    pay = q_pay.dtype
    for x, nm, shp, dt in (
            (q_avail, "q_avail", (n, d, C), f32),
            (q_touch, "q_touch", (n, d, C), i32),
            (q_pay, "q_pay", (n, d, C, L), pay),
            (head, "head", (n, d), i32), (size, "size", (n, d), i32),
            (push_pos, "push_pos", (n, d), i32),
            (push_acc, "push_acc", (n, d), b8),
            (push_avail, "push_avail", (n, d), f32),
            (push_touch, "push_touch", (n, d), i32),
            (push_pay, "push_pay", (n, d, L), pay),
            (recv_now, "recv_now", (n,), f32),
            (recv_active, "recv_active", (n,), b8)):
        _check(x, nm, shp, dt, dev)

    def out(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    outs = (out((n, d, C), f32), out((n, d, C), i32), out((n, d, C, L), pay),
            out((n, d), i32), out((n, d), i32), out((n, d), i32),
            out((n, d), i32), out((n, 4, L), pay), out((n, 4), b8))
    launch(fn,
            (q_avail, q_touch, q_pay, head, size, push_pos, push_acc,
             push_avail, push_touch, push_pay, recv_now, recv_active) + outs,
            (n, d, C, L, max_pops), dev, "duct_window")
    return outs


def duct_commit_cuda(q_avail, q_touch, q_pay, head, size0, pb_cnt,
                     pb_avail, pb_touch, pb_pay):
    """Launch the superstep commit kernel; returns the
    ``ops.CommitResult`` field tuple.  Rings are ``(R, C)``, the pushbuf
    ``(R, W)``, payloads int32 or float32 (copied, never summed, so a
    ``-0.0`` payload stays ``-0.0`` as in the reference's Pallas kernel)."""
    dev = q_avail.device
    if dev.type != "cuda":
        raise ValueError(f"duct_commit_cuda needs CUDA tensors, got {dev}")
    R, C = q_avail.shape
    W = pb_avail.shape[-1]
    L = q_pay.shape[-1]
    fn = _payload_entry("duct_commit", q_pay)
    i32, f32, pay = torch.int32, torch.float32, q_pay.dtype
    for x, nm, shp, dt in (
            (q_avail, "q_avail", (R, C), f32),
            (q_touch, "q_touch", (R, C), i32),
            (q_pay, "q_pay", (R, C, L), pay),
            (head, "head", (R,), i32), (size0, "size0", (R,), i32),
            (pb_cnt, "pb_cnt", (R,), i32),
            (pb_avail, "pb_avail", (R, W), f32),
            (pb_touch, "pb_touch", (R, W), i32),
            (pb_pay, "pb_pay", (R, W, L), pay)):
        _check(x, nm, shp, dt, dev)
    outs = (torch.empty((R, C), dtype=f32, device=dev),
            torch.empty((R, C), dtype=i32, device=dev),
            torch.empty((R, C, L), dtype=pay, device=dev))
    launch(fn,
            (q_avail, q_touch, q_pay, head, size0, pb_cnt, pb_avail,
             pb_touch, pb_pay) + outs,
            (R, C, W, L), dev, "duct_commit")
    return outs


def _edge_shape(q_avail, what: str):
    """(E, C) of edge-major rings on the card, refused where the kernel's
    32-bit indexing would overflow."""
    if q_avail.ndim != 2:
        raise ValueError(f"{what} takes rings (E, C), got "
                         f"{tuple(q_avail.shape)}")
    E, C = q_avail.shape
    if E * C >= 1 << 31:
        raise ValueError(f"{what} indexes in 32 bits; E * C = {E * C} must "
                         f"stay below 2**31")
    dev = q_avail.device
    if dev.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {dev}")
    return dev, E, C


def _check_edge(dev, E, C, named):
    """Check (tensor, name, dtype) of rings (the ``q_*``) and per-edge
    vectors against (E, C)."""
    for x, nm, dt in named:
        _check(x, nm, (E, C) if nm.startswith("q_") else (E,), dt, dev)


def _empty(dev, *specs):
    return tuple(torch.empty(shape, dtype=dt, device=dev)
                 for shape, dt in specs)


def duct_exchange_cuda(q_avail, q_touch, head, size, recv_now, recv_active,
                       send_now, send_active, send_lat, send_touch,
                       *, capacity: int, max_pops: int):
    """Launch the fused edge-major drain -> send (route ``full``); returns
    the ``ops.ExchangeResult`` field tuple.  Rings are ``(E, C)``; the
    eight per-edge inputs are ``(E,)``."""
    dev, E, C = _edge_shape(q_avail, "duct_exchange_cuda")
    i32, f32, b8 = torch.int32, torch.float32, torch.bool
    _check_edge(dev, E, C, (
        (q_avail, "q_avail", f32), (q_touch, "q_touch", i32),
        (head, "head", i32), (size, "size", i32),
        (recv_now, "recv_now", f32), (recv_active, "recv_active", b8),
        (send_now, "send_now", f32), (send_active, "send_active", b8),
        (send_lat, "send_lat", f32), (send_touch, "send_touch", i32)))
    outs = _empty(dev, ((E, C), f32), ((E, C), i32), (E, i32), (E, i32),
                  (E, i32), (E, i32), (E, i32), (E, b8), (E, i32))
    launch(_lib("duct_exchange").duct_exchange,
           (q_avail, q_touch, head, size, recv_now, recv_active, send_now,
            send_active, send_lat, send_touch) + outs,
           (E, C, capacity, max_pops), dev, "duct_exchange", route="full")
    return outs


def duct_drain_cuda(q_avail, q_touch, head, size, recv_now, recv_active,
                    *, max_pops: int):
    """Launch the edge-major drain (route ``drain``); returns the
    ``ops.DrainResult`` field tuple.  q_touch is only read (one slot a
    row): the result's q_touch is the input tensor itself, as in
    ``ops.duct_drain_torch``."""
    dev, E, C = _edge_shape(q_avail, "duct_drain_cuda")
    i32, f32, b8 = torch.int32, torch.float32, torch.bool
    _check_edge(dev, E, C, (
        (q_avail, "q_avail", f32), (q_touch, "q_touch", i32),
        (head, "head", i32), (size, "size", i32),
        (recv_now, "recv_now", f32), (recv_active, "recv_active", b8)))
    qa, *vecs = _empty(dev, ((E, C), f32), (E, i32), (E, i32), (E, i32),
                       (E, i32), (E, i32))
    launch(_lib("duct_exchange").duct_drain,
           (q_avail, q_touch, head, size, recv_now, recv_active, qa, *vecs),
           (E, C, max_pops), dev, "duct_exchange", route="drain")
    return (qa, q_touch, *vecs)


def duct_send_cuda(q_avail, q_touch, head, size, send_now, send_active,
                   send_lat, send_touch, *, capacity: int):
    """Launch the edge-major send (route ``send``); returns the
    ``ops.SendResult`` field tuple, new rings (out of place, as
    ``ops.duct_send_torch``)."""
    dev, E, C = _edge_shape(q_avail, "duct_send_cuda")
    i32, f32, b8 = torch.int32, torch.float32, torch.bool
    _check_edge(dev, E, C, (
        (q_avail, "q_avail", f32), (q_touch, "q_touch", i32),
        (head, "head", i32), (size, "size", i32),
        (send_now, "send_now", f32), (send_active, "send_active", b8),
        (send_lat, "send_lat", f32), (send_touch, "send_touch", i32)))
    outs = _empty(dev, ((E, C), f32), ((E, C), i32), (E, i32), (E, b8),
                  (E, i32))
    launch(_lib("duct_exchange").duct_send,
           (q_avail, q_touch, head, size, send_now, send_active, send_lat,
            send_touch) + outs,
           (E, C, capacity), dev, "duct_exchange", route="send")
    return outs
