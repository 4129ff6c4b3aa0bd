"""Public duct-exchange wrappers: plain torch versions and device dispatch.

Dense layout: ``duct_window`` (push-apply -> drain -> halo select, once per
window per degree bucket) and ``duct_commit`` (the W-fused superstep's ring
commit).  Edge-major layout: ``duct_drain`` and ``duct_send``, the two ring
phases the engine runs around the application step, and ``duct_exchange``,
their fused composition.  Every op dispatches on the device of the tensors
it is given, and on nothing else:

  cpu   the plain torch versions below (``*_torch``)
  cuda  the hand-written CUDA kernels in ``kernel.py`` (built from
        ``csrc/`` on first use); a kernel that cannot build or launch
        raises, it never falls back to the plain version.  The three
        edge-major ops each launch their own entry point of the
        ``duct_exchange`` kernel (routes ``drain``, ``send``, ``full``),
        which takes only that op's inputs.

Every plain version is a slot-exact twin of the numpy oracles in the
reference package (``duct_window_ref`` / ``duct_commit_ref`` /
``duct_exchange_ref``), including the ``+inf`` written into popped ring
slots.  Payloads are int32 (graph coloring) or float32 (evo).

Every op, plain or dispatched, also takes its tensors with a leading
replicate axis (the engine's batch of seeds, ``jax.vmap``'s axis in the
reference): it folds ``(R, rows, ...)`` into ``(R * rows, ...)`` as a
view, runs once over all replicates' rows, and unfolds the results.  This
is exact because all three kernels work row by row and every per-row input
is computed outside them.  A batched tensor that is not contiguous raises
rather than being copied.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels.build import device_kind


class DrainResult(NamedTuple):
    q_avail: torch.Tensor     # (E, C)
    q_touch: torch.Tensor     # (E, C)
    head: torch.Tensor        # (E,)
    size: torch.Tensor        # (E,)
    drained: torch.Tensor     # (E,) i32 messages popped
    recv_touch: torch.Tensor  # (E,) i32 touch of freshest popped (0 if none)
    pop_pos: torch.Tensor     # (E,) i32 ring slot of freshest popped


class SendResult(NamedTuple):
    q_avail: torch.Tensor     # (E, C)
    q_touch: torch.Tensor     # (E, C)
    size: torch.Tensor        # (E,)
    accepted: torch.Tensor    # (E,) bool: push accepted (False = dropped)
    push_pos: torch.Tensor    # (E,) i32 ring slot the push landed in


class ExchangeResult(NamedTuple):
    q_avail: torch.Tensor
    q_touch: torch.Tensor
    head: torch.Tensor
    size: torch.Tensor
    drained: torch.Tensor
    recv_touch: torch.Tensor
    pop_pos: torch.Tensor
    accepted: torch.Tensor
    push_pos: torch.Tensor


class WindowResult(NamedTuple):
    q_avail: torch.Tensor     # (n, d, C)
    q_touch: torch.Tensor     # (n, d, C)
    q_pay: torch.Tensor       # (n, d, C, L)
    head: torch.Tensor        # (n, d)
    size: torch.Tensor        # (n, d)
    drained: torch.Tensor     # (n, d) i32 messages popped
    recv_touch: torch.Tensor  # (n, d) i32 touch of freshest popped (0 if none)
    halo_pay: torch.Tensor    # (n, 4, L) freshest payload per halo slot
    halo_win: torch.Tensor    # (n, 4) bool: slot refreshed this window


class CommitResult(NamedTuple):
    q_avail: torch.Tensor     # (R, C)
    q_touch: torch.Tensor     # (R, C)
    q_pay: torch.Tensor       # (R, C, L)


def _fold(x: torch.Tensor) -> torch.Tensor:
    """``x`` (R, rows, ...) as ``(R * rows, ...)``, a view."""
    if not x.is_contiguous():
        raise ValueError("a replicate batch folds into the rows as a view; "
                         f"got a non-contiguous {tuple(x.shape)} tensor")
    return x.view((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


def folds_replicates(rank: int):
    """Let an op whose first tensor has ``rank`` dims take every tensor
    with one more, leading, replicate axis: fold, run once, unfold."""
    def wrap(op):
        @functools.wraps(op)
        def run(*args, **kwargs):
            if args[0].dim() == rank:
                return op(*args, **kwargs)
            R = args[0].shape[0]
            res = op(*(_fold(x) for x in args), **kwargs)
            return type(res)(*(x.view((R, x.shape[0] // R) +
                                      tuple(x.shape[1:])) for x in res))
        return run
    return wrap


def dense_halo_select(delivered, payload):
    """Per-receiver halo merge for the dense layout: slot ``s`` takes the
    payload of the highest delivering row ``j`` with ``j % 4 == s``.

    Rows are in sorted-source order, which for a fixed receiver is
    canonical-edge-id order, so "highest j wins" reproduces the edge-major
    tie-break as a d-step unrolled select.  ``delivered``: (..., n, d)
    bool; ``payload``: (..., n, d, L).  Returns ``(halo_pay (..., n, 4,
    L), halo_win (..., n, 4))``; a slot no row refreshed holds zeros and
    ``False``.
    """
    d = delivered.shape[-1]
    pay_cols, win_cols = [], []
    for s in range(4):
        pay_s = torch.zeros_like(payload[..., 0, :])
        win_s = torch.zeros_like(delivered[..., 0])
        for j in range(s, d, 4):
            pay_s = torch.where(delivered[..., j, None], payload[..., j, :],
                                pay_s)
            win_s = win_s | delivered[..., j]
        pay_cols.append(pay_s)
        win_cols.append(win_s)
    return torch.stack(pay_cols, dim=-2), torch.stack(win_cols, dim=-1)


def dense_stage(head, size, active, *, capacity: int):
    """Eager stage decision for the dense layout: drop iff the ring is
    full *now*, against post-drain occupancy, made one window early so the
    ring writes can ride into the next ``duct_window`` pass.  Returns
    ``(pos, accepted)``; the caller owns the occupancy bump."""
    accepted = active & (size < capacity)
    pos = (head + size) % capacity
    return pos, accepted


@folds_replicates(2)
def duct_drain_torch(q_avail, q_touch, head, size, recv_now, recv_active,
                     *, max_pops: int) -> DrainResult:
    """Plain torch version of the edge-major drain: pop the longest
    available FIFO prefix of every ring (head-blocking, at most
    ``max_pops``, only where ``recv_active``), in the blocked-offset
    row-min formulation of the reference's Pallas ``_duct_kernel``.

    Popped slots are always set to ``+inf``, as the kernel does.  The
    reference engine's edge drain skips that reset (``clear_popped=False``
    in its ``WindowCore.drain``); the two differ only in slots outside
    ``[head, head + size)``, which nothing reads, so a run's ``SimResult``
    is the same either way."""
    E, C = q_avail.shape
    col = torch.arange(C, dtype=torch.int32, device=q_avail.device)[None, :]
    off = (col - head[:, None]) % C              # floor-mod, as in JAX
    valid = off < size[:, None]
    blocked = valid & (q_avail > recv_now[:, None])
    blocked_off = torch.where(blocked, off, C).amin(dim=1)
    dr = torch.minimum(torch.minimum(blocked_off, size),
                       torch.full_like(size, max_pops))
    dr = torch.where(recv_active, dr, 0).to(torch.int32)
    popped = valid & (off < dr[:, None])
    recv_touch = torch.where(popped & (off == dr[:, None] - 1), q_touch,
                             0).sum(dim=1, dtype=torch.int32)
    pop_pos = torch.where(dr > 0, (head + dr - 1) % C, head)
    q_avail = torch.where(popped, torch.inf, q_avail)
    return DrainResult(q_avail, q_touch, (head + dr) % C, size - dr, dr,
                       recv_touch, pop_pos)


@folds_replicates(2)
def duct_send_torch(q_avail, q_touch, head, size,
                    send_now, send_active, send_lat, send_touch,
                    *, capacity: int) -> SendResult:
    """Plain torch version of the best-effort push: accept iff the sender
    is active and the ring holds fewer than ``capacity`` messages, then
    stamp ``send_now + send_lat`` and ``send_touch`` at the tail slot."""
    E, C = q_avail.shape
    col = torch.arange(C, dtype=torch.int32, device=q_avail.device)[None, :]
    accepted = send_active & (size < capacity)
    pos = (head + size) % C
    at = accepted[:, None] & (col == pos[:, None])
    q_avail = torch.where(at, (send_now + send_lat)[:, None], q_avail)
    q_touch = torch.where(at, send_touch[:, None], q_touch)
    push_pos = torch.where(accepted, pos, 0)
    return SendResult(q_avail, q_touch, size + accepted, accepted, push_pos)


@folds_replicates(2)
def duct_exchange_torch(q_avail, q_touch, head, size,
                        recv_now, recv_active,
                        send_now, send_active, send_lat, send_touch,
                        *, capacity: int, max_pops: int) -> ExchangeResult:
    """Fused drain -> send as the composition of the two plain phases."""
    d = duct_drain_torch(q_avail, q_touch, head, size, recv_now,
                         recv_active, max_pops=max_pops)
    s = duct_send_torch(d.q_avail, d.q_touch, d.head, d.size,
                        send_now, send_active, send_lat, send_touch,
                        capacity=capacity)
    return ExchangeResult(s.q_avail, s.q_touch, d.head, s.size, d.drained,
                          d.recv_touch, d.pop_pos, s.accepted, s.push_pos)


@folds_replicates(3)
def duct_window_torch(q_avail, q_touch, q_pay, head, size,
                      push_pos, push_acc, push_avail, push_touch, push_pay,
                      recv_now, recv_active,
                      *, max_pops: int) -> WindowResult:
    """Plain torch version of the fused window op: push-apply -> drain ->
    halo-select, in the blocked-offset row-min formulation of the
    reference's jnp twin (``duct_window_jnp``)."""
    n, d, C = q_avail.shape
    L = q_pay.shape[-1]
    R = n * d
    dev = q_avail.device
    qa = q_avail.reshape(R, C)
    qt = q_touch.reshape(R, C)
    qp = q_pay.reshape(R, C, L)
    head_f = head.reshape(R)
    size_f = size.reshape(R)
    col = torch.arange(C, dtype=torch.int32, device=dev)[None, :]
    # --- push: masked writes at the staged slots ----------------------
    at = push_acc.reshape(R)[:, None] & (col == push_pos.reshape(R)[:, None])
    qa = torch.where(at, push_avail.reshape(R)[:, None], qa)
    qt = torch.where(at, push_touch.reshape(R)[:, None], qt)
    qp = torch.where(at[:, :, None], push_pay.reshape(R, 1, L), qp)
    # --- drain: longest available FIFO prefix, head-blocking, bounded --
    off = (col - head_f[:, None]) % C            # floor-mod, as in JAX
    valid = off < size_f[:, None]
    rnow = recv_now[:, None].expand(n, d).reshape(R)
    ract = recv_active[:, None].expand(n, d).reshape(R)
    blocked = valid & (qa > rnow[:, None])
    blocked_off = torch.where(blocked, off, C).amin(dim=1)
    dr = torch.minimum(torch.minimum(blocked_off, size_f),
                       torch.full_like(size_f, max_pops))
    dr = torch.where(ract, dr, 0).to(torch.int32)
    popped = valid & (off < dr[:, None])
    fresh = popped & (off == dr[:, None] - 1)
    recv_touch = torch.where(fresh, qt, 0).sum(dim=1, dtype=torch.int32)
    fresh_pay = torch.where(fresh[:, :, None], qp,
                            torch.zeros((), dtype=qp.dtype, device=dev)
                            ).sum(dim=1, dtype=qp.dtype)
    qa = torch.where(popped, torch.inf, qa)
    head2 = (head_f + dr) % C
    size2 = size_f - dr
    halo_pay, halo_win = dense_halo_select(
        (dr > 0).reshape(n, d), fresh_pay.reshape(n, d, L))
    return WindowResult(
        qa.reshape(n, d, C), qt.reshape(n, d, C), qp.reshape(n, d, C, L),
        head2.reshape(n, d), size2.reshape(n, d), dr.reshape(n, d),
        recv_touch.reshape(n, d), halo_pay, halo_win)


@folds_replicates(2)
def duct_commit_torch(q_avail, q_touch, q_pay, head, size0, pb_cnt,
                      pb_avail, pb_touch, pb_pay) -> CommitResult:
    """Plain torch version of the superstep commit: push ``j`` of ring
    ``r`` lands at slot ``(head[r] + size0[r] + j) % C`` for ``j <
    pb_cnt[r]``; every other slot keeps its value bit for bit."""
    R, C = q_avail.shape
    W = pb_avail.shape[1]
    L = q_pay.shape[-1]
    col = torch.arange(C, dtype=torch.int32, device=q_avail.device)[None, :]
    j = (col - head[:, None] - size0[:, None]) % C
    wr = j < pb_cnt[:, None]
    src = j.clamp(max=W - 1).long()
    qa = torch.where(wr, pb_avail.gather(1, src), q_avail)
    qt = torch.where(wr, pb_touch.gather(1, src), q_touch)
    pay = pb_pay.gather(1, src[:, :, None].expand(R, C, L))
    qp = torch.where(wr[:, :, None], pay, q_pay)
    return CommitResult(qa, qt, qp)


def _device_kind(t: torch.Tensor) -> str:
    kind = device_kind(t, "duct ops")
    if kind == "fake":
        raise ValueError("the duct ops have no shape function: they run on "
                         "the cpu or the card")
    return kind


@folds_replicates(3)
def duct_window(q_avail, q_touch, q_pay, head, size,
                push_pos, push_acc, push_avail, push_touch, push_pay,
                recv_now, recv_active, *, max_pops: int) -> WindowResult:
    """Fused window op, dispatched on the rings' device: the plain torch
    version for a CPU tensor, the CUDA kernel for a CUDA tensor."""
    args = (q_avail, q_touch, q_pay, head, size, push_pos, push_acc,
            push_avail, push_touch, push_pay, recv_now, recv_active)
    if _device_kind(q_avail) == "cpu":
        return duct_window_torch(*args, max_pops=max_pops)
    from repro_torch.kernels.duct_exchange.kernel import duct_window_cuda
    return WindowResult(*duct_window_cuda(*args, max_pops=max_pops))


@folds_replicates(2)
def duct_commit(q_avail, q_touch, q_pay, head, size0, pb_cnt,
                pb_avail, pb_touch, pb_pay) -> CommitResult:
    """Superstep commit, dispatched on the rings' device: the plain torch
    version for a CPU tensor, the CUDA kernel for a CUDA tensor."""
    args = (q_avail, q_touch, q_pay, head, size0, pb_cnt,
            pb_avail, pb_touch, pb_pay)
    if _device_kind(q_avail) == "cpu":
        return duct_commit_torch(*args)
    from repro_torch.kernels.duct_exchange.kernel import duct_commit_cuda
    return CommitResult(*duct_commit_cuda(*args))


@folds_replicates(2)
def duct_exchange(q_avail, q_touch, head, size,
                  recv_now, recv_active,
                  send_now, send_active, send_lat, send_touch,
                  *, capacity: int, max_pops: int) -> ExchangeResult:
    """Fused edge-major drain -> send, dispatched on the rings' device:
    the plain torch version for a CPU tensor, the CUDA kernel for a CUDA
    tensor."""
    args = (q_avail, q_touch, head, size, recv_now, recv_active,
            send_now, send_active, send_lat, send_touch)
    if _device_kind(q_avail) == "cpu":
        return duct_exchange_torch(*args, capacity=capacity,
                                   max_pops=max_pops)
    from repro_torch.kernels.duct_exchange.kernel import duct_exchange_cuda
    return ExchangeResult(*duct_exchange_cuda(*args, capacity=capacity,
                                              max_pops=max_pops))


@folds_replicates(2)
def duct_drain(q_avail, q_touch, head, size, recv_now, recv_active,
               *, max_pops: int) -> DrainResult:
    """Edge-major drain, dispatched on the rings' device.  Both versions
    return the input ``q_touch`` tensor itself (the drain never changes
    it)."""
    if _device_kind(q_avail) == "cpu":
        return duct_drain_torch(q_avail, q_touch, head, size, recv_now,
                                recv_active, max_pops=max_pops)
    from repro_torch.kernels.duct_exchange.kernel import duct_drain_cuda
    return DrainResult(*duct_drain_cuda(q_avail, q_touch, head, size,
                                        recv_now, recv_active,
                                        max_pops=max_pops))


@folds_replicates(2)
def duct_send(q_avail, q_touch, head, size,
              send_now, send_active, send_lat, send_touch,
              *, capacity: int) -> SendResult:
    """Best-effort edge-major push, dispatched on the rings' device; both
    versions return new rings."""
    if _device_kind(q_avail) == "cpu":
        return duct_send_torch(q_avail, q_touch, head, size, send_now,
                               send_active, send_lat, send_touch,
                               capacity=capacity)
    from repro_torch.kernels.duct_exchange.kernel import duct_send_cuda
    return SendResult(*duct_send_cuda(q_avail, q_touch, head, size,
                                      send_now, send_active, send_lat,
                                      send_touch, capacity=capacity))
