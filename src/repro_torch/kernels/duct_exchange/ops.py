"""Public duct-exchange wrappers for the dense layout: plain torch versions
and device dispatch.

``duct_window`` (push-apply -> drain -> halo select, once per window per
degree bucket) and ``duct_commit`` (the W-fused superstep's ring commit)
dispatch on the device of the tensors they are given, and on nothing else:

  cpu   the plain torch versions below (``duct_window_torch`` /
        ``duct_commit_torch``)
  cuda  the hand-written CUDA kernels in ``kernel.py`` (built from
        ``csrc/`` on first use); a kernel that cannot build or launch
        raises, it never falls back to the plain version

Both plain versions are slot-exact twins of the numpy oracles in the
reference package (``duct_window_ref`` / ``duct_commit_ref``), including
the ``+inf`` written into popped ring slots.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


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


def dense_halo_select(delivered, payload):
    """Per-receiver halo merge for the dense layout: slot ``s`` takes the
    payload of the highest delivering row ``j`` with ``j % 4 == s``.

    Rows are in sorted-source order, which for a fixed receiver is
    canonical-edge-id order, so "highest j wins" reproduces the edge-major
    tie-break as a d-step unrolled select.  ``delivered``: (n, d) bool;
    ``payload``: (n, d, L).  Returns ``(halo_pay (n, 4, L), halo_win
    (n, 4))``; a slot no row refreshed holds zeros and ``False``.
    """
    n, d = delivered.shape
    L = payload.shape[-1]
    pay_cols, win_cols = [], []
    for s in range(4):
        pay_s = torch.zeros((n, L), dtype=payload.dtype,
                            device=payload.device)
        win_s = torch.zeros((n,), dtype=torch.bool, device=payload.device)
        for j in range(s, d, 4):
            pay_s = torch.where(delivered[:, j, None], payload[:, j], pay_s)
            win_s = win_s | delivered[:, j]
        pay_cols.append(pay_s)
        win_cols.append(win_s)
    return torch.stack(pay_cols, dim=1), torch.stack(win_cols, dim=1)


def dense_stage(head, size, active, *, capacity: int):
    """Eager stage decision for the dense layout: drop iff the ring is
    full *now*, against post-drain occupancy, made one window early so the
    ring writes can ride into the next ``duct_window`` pass.  Returns
    ``(pos, accepted)``; the caller owns the occupancy bump."""
    accepted = active & (size < capacity)
    pos = (head + size) % capacity
    return pos, accepted


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
    kind = t.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(
            f"duct ops run on cpu (plain torch) or cuda (hand-written "
            f"kernel); got a tensor on {t.device}")
    return kind


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
