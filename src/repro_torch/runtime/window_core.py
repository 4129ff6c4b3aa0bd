"""Window-phase core of the torch engine.

The PyTorch counterpart of the reference's ``runtime/window_core.py``.  The
torch engine (``runtime/engine_torch.py``) advances the whole process
population per lockstep window through the same phases, on either duct
layout.  Dense (receiver-major, degree-bucketed):

  drain      one fused ``duct_window`` pass per degree bucket applies the
             previous window's staged sends, pops every ring's available
             FIFO prefix and merges the freshest payloads into the
             (n, 4, L) halos, bumping the receiver-side QoS counters
  compute    the application's batched step, masked by activity
  stage      the eager send decision (drop iff the ring is full now); the
             ring writes ride into the next window's ``duct_window``
  close      QoS snapshots, termination, barriers and quarantine, and the
             virtual-time advance

Edge-major (one ring per canonical edge): ``drain`` pops every ring with
``duct_drain`` and merges the halos with a segment max over (receiver,
slot) keys; after ``compute``, ``send_edge`` pushes with ``duct_send`` and
scatters the payloads into the accepted slots.  Both layouts give the same
trajectories bitwise.

With the W-fused superstep scheduler the drain walks frozen base rings
plus a compact pushbuf (``window_dense_fused``) and ``commit_superstep``
folds the pushbuf into the rings with one ``duct_commit`` per superstep.

The sharded engine (``runtime/engine_sharded.py``) runs the edge-major
``drain`` and ``send_edge`` over all its shards at once and closes its
windows with :data:`LOCAL_RELEASE` (every shard in one process, so the
reductions over all shards are the single-device ones), with
:data:`PIPELINED_RELEASE` (decisions staged one superstep boundary), with
:class:`RankRelease` / :class:`PipelinedRankRelease` (the shards split
over ``torch.distributed`` ranks: each rank's reductions all-reduced), or
with no release check inside a superstep.

Every phase runs a batch of replicates at once: each carry leaf has a
leading replicate axis, as ``jax.vmap`` gives the reference's (per-process
leaves ``(R, n, ...)``, ring leaves ``(R, rows, ...)``, the seed and the
window counter ``(R,)``), the static topology tables are shared by every
replicate (broadcast, never copied), gathers and scatters run along the
process or row axis after the replicate axis, and the release reductions
reduce within each replicate.  Every duct kernel launches once a window
for the whole batch (``ops.folds_replicates``).

Every phase is a plain function of tensors on one device; dtypes follow
the reference (bool stays bool, int32 stays int32), and every phase
returns new tensors rather than updating its inputs.  All stochastic
draws are the reference's counter-based hashes, computed bit-exactly in
int64 masked to 32 bits, so a run is a pure function of ``(config,
seed)`` and matches the JAX engine bitwise on the same seed.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.modes import AsyncMode
from repro_torch.core.qos import QosReport
from repro_torch.kernels.duct_exchange.ops import (
    dense_halo_select,
    dense_stage,
    duct_commit,
    duct_drain,
    duct_send,
    duct_window,
)
from repro_torch.runtime.faults import STREAM_FLAP, STREAM_LOSS
from repro_torch.runtime.simulator import SimResult

#: modes whose processes stop at a barrier and wait for a global release
BARRIER_MODES = (AsyncMode.BARRIER_EVERY_STEP, AsyncMode.ROLLING_BARRIER,
                 AsyncMode.FIXED_BARRIER)

# ---------------------------------------------------------------------------
# Counter-based RNG: splitmix-style 32-bit finalizer chains, pure functions
# of their integer keys.  torch has few uint32 operations, so every value is
# an int64 holding a uint32 in [0, 2**32): shifts are then logical, and no
# product leaves the int64 range (see mul32).
# ---------------------------------------------------------------------------
M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9

# stream tags keep independent draws independent
STREAM_STEP, STREAM_STALL, STREAM_LAT, STREAM_APP, STREAM_MUT = 1, 2, 3, 4, 5


def _f32(x) -> float:
    """``x`` rounded to float32, as a Python float (exact in either
    precision, so a float32 tensor op with it computes the same value the
    reference's ``np.float32(x)`` constant gives)."""
    return float(np.float32(x))


def arrival_bin_index(t: torch.Tensor, arrival_bin: float,
                      nbins: int) -> torch.Tensor:
    """``min(int(t / arrival_bin), nbins)`` as int32, as the reference's
    serve hook computes it: XLA compiles its division by the constant bin
    into a product with the float32 reciprocal (CUDA's division by a
    scalar is the same product), so this multiplies too.  The clamp comes
    before the cast: a crashed process's clock is ``+inf``, which a
    float-to-int32 cast does not saturate on every device."""
    inv = _f32(np.float32(1) / np.float32(arrival_bin))
    return torch.clamp(t * inv, max=float(nbins)).to(torch.int32)


def mul32(x, c: int):
    """``(x * c) mod 2**32`` for ``x`` in [0, 2**32) and a 32-bit ``c``.
    A constant at or above 2**31 is replaced by ``c - 2**32`` (the same
    residue), so ``|x * c| < 2**63`` and the int64 product never
    overflows; ``& M32`` takes the two's-complement residue."""
    if c >= 1 << 31:
        c -= 1 << 32
    return (x * c) & M32


def _mix32(x):
    """32-bit splitmix-style finalizer (lowbias32 constants)."""
    x = mul32(x ^ (x >> 16), 0x7FEB352D)
    x = mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def _u32(k):
    """A key as the uint32 it wraps to (``astype(uint32)`` semantics: a
    negative int32 wraps modulo 2**32), held in int64."""
    if isinstance(k, torch.Tensor):
        return k.to(torch.int64) & M32
    return int(k) & M32


def hash_u32(*keys) -> torch.Tensor:
    """Combine integer keys (tensors broadcast) into one hashed uint32,
    returned as an int64 tensor in [0, 2**32)."""
    h = _GOLDEN
    for k in keys:
        k = _u32(k)
        h = _mix32(h ^ ((k + _GOLDEN + ((h << 6) & M32) + (h >> 2)) & M32))
    if not isinstance(h, torch.Tensor):
        h = torch.tensor(h, dtype=torch.int64)
    return h


def hash_uniform(*keys) -> torch.Tensor:
    """Deterministic float32 uniform in (0, 1) from integer keys."""
    h = hash_u32(*keys)
    return ((h >> 8).to(torch.float32) + 0.5) * _f32(1.0 / (1 << 24))


def hash_normal(*keys) -> torch.Tensor:
    u1 = hash_uniform(*keys, 101)
    u2 = hash_uniform(*keys, 202)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(
        _f32(2.0 * np.pi) * u2)


def lognormal_factor(sigma: float, *keys) -> torch.Tensor:
    """Mean-one lognormal, matching faults.Jitter's parameterization."""
    if sigma <= 0:
        tensors = [k for k in keys if isinstance(k, torch.Tensor)]
        shape = torch.broadcast_shapes(*(k.shape for k in tensors))
        dev = tensors[0].device if tensors else None
        return torch.ones(shape, dtype=torch.float32, device=dev)
    z = hash_normal(*keys)
    return torch.exp(_f32(-0.5 * sigma * sigma) + _f32(sigma) * z)


# ---------------------------------------------------------------------------
# Barrier-release strategies: where the close phase's global reductions run
# ---------------------------------------------------------------------------
class LocalRelease:
    """Single-device release reductions: plain torch reductions over the
    process axis of ``(R, n)`` tensors, one per replicate, returned as
    ``(R, 1)`` so that they broadcast over that replicate's processes; the
    window loop never waits on the device.  A reduction over the whole
    batch would couple the seeds."""

    #: staged strategies consume reductions issued one superstep boundary
    #: earlier (see :class:`PipelinedRelease`)
    staged = False

    def all_stopped(self, x: torch.Tensor) -> torch.Tensor:
        return x.all(dim=-1, keepdim=True)

    def any_waiting(self, x: torch.Tensor) -> torch.Tensor:
        return x.any(dim=-1, keepdim=True)

    def max_time(self, x: torch.Tensor) -> torch.Tensor:
        return x.amax(dim=-1, keepdim=True)

    def reduce(self, stopped=None, waiting=None, times=()):
        """The reductions one close phase issues together:
        ``(all_stopped(stopped), any_waiting(waiting), [max_time(x) for x
        in times])``, ``None`` for an argument not given."""
        return (None if stopped is None else self.all_stopped(stopped),
                None if waiting is None else self.any_waiting(waiting),
                [self.max_time(x) for x in times])


#: the default strategy (one device holds the whole population)
LOCAL_RELEASE = LocalRelease()


class PipelinedRelease(LocalRelease):
    """Release strategy for the ``pipelined`` scheduler: the release
    reductions issued at superstep boundary i are *consumed* at
    boundary i+1.

    Correctness rests on the frozen cohort: once ``all_stopped`` is
    observed true, every live process is waiting, none is active, and so
    nothing can join, leave or advance the cohort before the staged
    decision is applied one boundary later.  The release *time* is what an
    un-staged release would compute; only the lockstep window it lands on
    moves one superstep later.  ``close_window`` reads the carried
    decision from ``u["rel_ready"]`` / ``u["rel_t"]`` (and the quarantine
    front from ``u["rel_ref"]``), ``(R,)`` tensors, one value a replicate
    that every shard shares, and stores fresh post-release reductions for
    the next boundary.
    """

    staged = True


PIPELINED_RELEASE = PipelinedRelease()


class RankRelease(LocalRelease):
    """Release reductions over the ranks of a ``launch.mesh.RankGroup``,
    the counterpart of the reference's ``MeshRelease`` (pmin / pmax over
    the shard axis): each rank reduces its own processes as
    :class:`LocalRelease` does, per replicate ``(R, 1)``, then the ranks
    all-reduce the results: MIN over ``all_stopped``, MAX over
    ``any_waiting`` and ``max_time`` (exact in float32).

    :meth:`reduce` issues a phase's reductions as one all-reduce: one
    float32 buffer of ``-all_stopped``, ``any_waiting`` and the times,
    reduced by MAX (the MIN of 0/1 bits is minus the MAX of their
    negations; 0, 1 and every float32 time are exact), so a barrier
    window costs one collective, and on a staged rank one copy to host
    and back."""

    def __init__(self, group):
        self.group = group

    def all_stopped(self, x: torch.Tensor) -> torch.Tensor:
        local = super().all_stopped(x).to(torch.int32)
        return self.group.all_reduce(local, "min") > 0

    def any_waiting(self, x: torch.Tensor) -> torch.Tensor:
        local = super().any_waiting(x).to(torch.int32)
        return self.group.all_reduce(local, "max") > 0

    def max_time(self, x: torch.Tensor) -> torch.Tensor:
        return self.group.all_reduce(super().max_time(x), "max")

    def reduce(self, stopped=None, waiting=None, times=()):
        rows = []
        if stopped is not None:
            rows.append(-LocalRelease.all_stopped(self, stopped).to(
                torch.float32))
        if waiting is not None:
            rows.append(LocalRelease.any_waiting(self, waiting).to(
                torch.float32))
        rows += [LocalRelease.max_time(self, x) for x in times]
        out = list(self.group.all_reduce(torch.stack(rows), "max").unbind(0))
        all_stopped = None if stopped is None else out.pop(0) < 0
        any_waiting = None if waiting is None else out.pop(0) > 0
        return all_stopped, any_waiting, out


class PipelinedRankRelease(RankRelease):
    """:class:`RankRelease` for the ``pipelined`` scheduler: the decision
    staged one superstep boundary, as :class:`PipelinedRelease` stages
    it; the counterpart of the reference's ``PipelinedRelease``."""

    staged = True


class SendPhase(NamedTuple):
    """Result of one edge-major send attempt over a block of rings."""
    rings: Dict[str, torch.Tensor]   # q_avail / q_touch / q_size / q_pay
    accepted: torch.Tensor           # (R, rows) bool push accepted
    sums: Optional[torch.Tensor]     # (R, n, 3) attempted/ok/dropped


class BucketSlab(NamedTuple):
    """Static view of one dense degree bucket's flat row slab.

    ``members is None`` marks the identity bucket: it covers every
    receiver (member i == receiver i), which is what every degree-regular
    topology collapses to, and the per-bucket phases then skip all
    gathers and scatters.  Otherwise ``members`` maps slab block index to
    receiver id; sentinel entries (value ``n_dst``) would mark dead
    padding blocks whose scatters drop into a spare row."""

    start: int                           # first flat row of the slab
    nb: int                              # member blocks in the slab
    deg: int                             # padded rows per member block
    members: Optional[torch.Tensor]      # (nb,) int64 receiver ids, or None


class DenseSpec(NamedTuple):
    """Static dense-layout geometry the bucketed phases iterate over."""

    n_dst: int                           # receivers covered
    n_rows: int                          # total flat rows R
    buckets: tuple                       # of BucketSlab, tiling [0, R)


def make_dense_spec(plan, device) -> DenseSpec:
    """Build the phase-iteration spec from a ``topologies.LayoutPlan``,
    collapsing full-coverage single buckets to the identity fast path."""
    slabs = []
    start = 0
    for b in plan.buckets:
        nb = len(b.members)
        if int(b.start) != start:
            raise ValueError("dense buckets must tile the flat rows in order")
        start += nb * int(b.deg)
        identity = (nb == plan.row_start.shape[0] and
                    bool((np.asarray(b.members) == np.arange(nb)).all()))
        slabs.append(BucketSlab(
            start=int(b.start), nb=nb, deg=int(b.deg),
            members=None if identity else torch.as_tensor(
                np.asarray(b.members, np.int64), device=device)))
    return DenseSpec(n_dst=int(plan.row_start.shape[0]),
                     n_rows=int(plan.n_rows), buckets=tuple(slabs))


# The gathers and scatters below index axis 1 of a batch, the process or
# row axis after the replicate axis; the index tables are shared by every
# replicate.
def _gather_rows(x, members, n_dst):
    """``x[:, clip(members, 0, n_dst - 1)]``."""
    return x[:, members.clamp(0, n_dst - 1)]


def _scatter_set(x, members, vals, n_dst):
    """``x.at[:, members].set(vals, mode="drop")``: rows ``members`` take
    ``vals``; sentinel members (``== n_dst``) land in a spare row that is
    sliced off."""
    ext = torch.cat([x, x[:, :1]], dim=1)
    ext[:, members] = vals
    return ext[:, :n_dst]


def _scatter_add(x, members, vals, n_dst):
    """``x.at[:, members].add(vals, mode="drop")`` with the spare-row
    drop."""
    ext = torch.cat([x, torch.zeros_like(x[:, :1])], dim=1)
    ext.index_add_(1, members, vals)
    return ext[:, :n_dst]


def _i32_sum(x, dim):
    return x.sum(dim=dim, dtype=torch.int32)


def segment_sum(x, seg, n_seg):
    """``jax.ops.segment_sum(x, seg, num_segments=n_seg + 1)[:n_seg]`` in
    each replicate: rows of ``x`` (R, rows, ...) summed per segment id;
    sentinel ids (``== n_seg``) land in the spare segment that is sliced
    off."""
    zeros = torch.zeros((x.shape[0], n_seg) + tuple(x.shape[2:]),
                        dtype=x.dtype, device=x.device)
    return _scatter_add(zeros, seg, x, n_seg)


def batch_seed(carry) -> torch.Tensor:
    """The carry's ``(R,)`` seeds as ``(R, 1)``: the shape of a key that
    broadcasts over each replicate's processes or rows."""
    return carry["seed"][:, None]


# ---------------------------------------------------------------------------
# The core
# ---------------------------------------------------------------------------
class WindowCore:
    """Window phases of the torch engine.

    Holds only population-invariant configuration (``cfg``, the batched
    app's payload shape, snapshot slot count, barrier cost); topology
    tables are arguments to the phase methods.
    """

    def __init__(self, cfg, bapp, n: int, *, max_pops: int = 16):
        self.cfg = cfg
        self.bapp = bapp
        self.n = n
        self.max_pops = max_pops
        warmup, interval = cfg.snapshot_warmup, cfg.snapshot_interval
        #: snapshot slots per process
        self.S = max(1, int((cfg.duration - warmup) / interval) + 3)
        base_total = cfg.base_compute + cfg.work_units * cfg.work_unit_cost
        self.base_total = np.float32(base_total)
        if n <= 1:
            self.barrier_cost = 0.0
        else:
            self.barrier_cost = (cfg.barrier_base +
                                 cfg.barrier_per_log2 * math.log2(n))
        # generous lockstep-window budget: fastest plausible step is about
        # half the mean, plus slack for barrier-arrival idling
        self.default_max_windows = int(8 * cfg.duration / base_total) + 2048

    # ------------------------------------------------------------------
    # RNG phases
    # ------------------------------------------------------------------
    def step_factor(self, seed, steps, pids, cfactor) -> torch.Tensor:
        """Per-process compute-time factor; draws are keyed by original
        pid."""
        cfg = self.cfg
        f = lognormal_factor(cfg.jitter_sigma, seed, STREAM_STEP,
                             pids, steps)
        if cfg.stall_prob > 0:
            u = hash_uniform(seed, STREAM_STALL, pids, steps)
            f = torch.where(u < _f32(cfg.stall_prob),
                            f * _f32(cfg.stall_factor), f)
        return f * cfactor

    def fault_masks(self, seed, t_src, steps_src, eids, loss, flap,
                    flap_period, dead):
        """Per-edge typed-fault send masks: ``(loss_kill, dead_kill)``,
        disjoint bool masks (dead wins), keyed by canonical edge id and
        sender step count (loss) / sender-time bucket (flap).  The bucket
        multiplies by the float32 reciprocal of the period, as XLA
        compiles the reference's division by that constant (see
        :func:`arrival_bin_index`)."""
        lost = (loss > 0) & (
            hash_uniform(seed, STREAM_LOSS, eids, steps_src) < loss)
        inv = _f32(np.float32(1) / np.float32(flap_period))
        bucket = torch.floor(t_src * inv).to(torch.int32)
        flap_down = (flap > 0) & (
            hash_uniform(seed, STREAM_FLAP, eids, bucket) < flap)
        return (lost | flap_down) & ~dead, dead

    # ------------------------------------------------------------------
    # State builders
    # ------------------------------------------------------------------
    def edge_rings(self, rows: int, device) -> Dict[str, torch.Tensor]:
        """Fresh (empty) ring state for ``rows`` rings."""
        C = self.cfg.buffer_capacity
        L = self.bapp.payload_len
        z = dict(dtype=torch.int32, device=device)
        return dict(
            ptouch=torch.zeros(rows, **z),
            q_avail=torch.full((rows, C), torch.inf, dtype=torch.float32,
                               device=device),
            q_touch=torch.zeros((rows, C), **z),
            q_pay=torch.zeros((rows, C, L), dtype=self.bapp.payload_dtype,
                              device=device),
            q_head=torch.zeros(rows, **z),
            q_size=torch.zeros(rows, **z),
        )

    def dense_rings(self, rows: int, device) -> Dict[str, torch.Tensor]:
        """Fresh dense ring state: flat ``(R, C)`` rings plus the staged
        send buffers (the send decision happens at stage time, the ring
        writes ride into the next window's ``duct_window`` pass)."""
        L = self.bapp.payload_len
        u = self.edge_rings(rows, device)
        u.update(
            stage_pos=torch.zeros(rows, dtype=torch.int32, device=device),
            stage_acc=torch.zeros(rows, dtype=torch.bool, device=device),
            stage_avail=torch.zeros(rows, dtype=torch.float32,
                                    device=device),
            stage_touch=torch.zeros(rows, dtype=torch.int32, device=device),
            stage_pay=torch.zeros((rows, L), dtype=self.bapp.payload_dtype,
                                  device=device),
        )
        return u

    def superstep_rings(self, rows: int, w: int,
                        device) -> Dict[str, torch.Tensor]:
        """Extra carry for the W-fused superstep scheduler: base rings stay
        frozen across a superstep while per-window pushes append to a
        compact ``(R, W)`` pushbuf; ``duct_commit`` folds it into the rings
        once per superstep."""
        C = self.cfg.buffer_capacity
        L = self.bapp.payload_len
        u = self.dense_rings(rows, device)
        z = dict(dtype=torch.int32, device=device)
        u.update(
            size0=torch.zeros(rows, **z),     # base size at superstep start
            dr_base=torch.zeros(rows, **z),   # base pops this superstep
            pb_cnt=torch.zeros(rows, **z),    # pushbuf appends
            pb_pop=torch.zeros(rows, **z),    # pushbuf pops
            pb_avail=torch.zeros((rows, w), dtype=torch.float32,
                                 device=device),
            pb_touch=torch.zeros((rows, w), **z),
            pb_pay=torch.zeros((rows, w, L), dtype=self.bapp.payload_dtype,
                               device=device),
            # FIFO offset of every ring slot from the frozen superstep head
            # (head starts at 0); int8 when capacity permits
            base_off=torch.arange(C, dtype=self._off_dtype(),
                                  device=device).expand(rows, C).clone(),
        )
        return u

    def _off_dtype(self):
        return torch.int8 if self.cfg.buffer_capacity <= 127 else torch.int32

    # ------------------------------------------------------------------
    # Phase 1: drain
    # ------------------------------------------------------------------
    def drain(self, carry, t_rows, act_rows, *, halo_key, n_halo, dst,
              n_dst):
        """Edge-major drain: bounded FIFO pops of every ring at its
        receiver's clock, halo-winner select, and the three receiver-side
        QoS counter columns.  Returns ``(carry updates, drained_r)``.

        ``halo_key`` flattens (receiver, slot); several in-edges may share
        one halo slot, and delivery ties resolve to the highest row index
        (rows are in ascending canonical-edge order), so the merge is
        deterministic on every device.  Sentinel-padded tables (the sharded
        engine's) work unchanged: invalid rows carry key ``n_halo`` /
        segment ``n_dst``, which land in the spare segment.  Popped slots
        read ``+inf`` after the drain, where the reference leaves them (see
        ``ops.duct_drain_torch``); nothing reads them."""
        reps, rows_n = t_rows.shape
        rows = torch.arange(rows_n, dtype=torch.int32, device=t_rows.device)
        d = duct_drain(carry["q_avail"], carry["q_touch"],
                       carry["q_head"], carry["q_size"],
                       t_rows, act_rows, max_pops=self.max_pops)
        delivered = d.drained > 0
        L = carry["halo"].shape[-1]
        payload = carry["q_pay"].gather(
            2, d.pop_pos.long()[..., None, None].expand(
                reps, rows_n, 1, L))[:, :, 0]                # (R, E, L)
        new_touch = d.recv_touch + 1
        dtouch = torch.where(delivered, new_touch - carry["ptouch"], 0)
        ptouch = torch.where(delivered, new_touch, carry["ptouch"])
        recv_cols = torch.stack([d.drained, delivered.to(torch.int32),
                                 dtouch], dim=-1)
        # segment max over (receiver, slot) keys, spare segment n_halo
        winner = torch.full((reps, n_halo + 1), -1, dtype=torch.int32,
                            device=rows.device).scatter_reduce_(
            1, halo_key.expand(reps, rows_n),
            torch.where(delivered, rows, -1), "amax")[:, :n_halo]
        has_win = winner >= 0
        fresh = payload.gather(1, torch.where(has_win, winner, 0).long()[
            ..., None].expand(reps, n_halo, L))
        halo = torch.where(has_win[..., None], fresh,
                           carry["halo"].reshape(reps, n_halo, L)).reshape(
            reps, n_dst, 4, L)
        recv_sums = segment_sum(recv_cols, dst, n_dst)
        return dict(
            halo=halo, ptouch=ptouch,
            c_msgs=carry["c_msgs"] + recv_sums[..., 0],
            c_laden=carry["c_laden"] + recv_sums[..., 1],
            c_touch=carry["c_touch"] + recv_sums[..., 2],
            q_avail=d.q_avail, q_touch=d.q_touch,
            q_head=d.head, q_size=d.size), recv_sums[..., 0]

    def _merge_buckets(self, spec: DenseSpec, halo, delivered, payload,
                       recv_cols):
        """Bucket-sliced halo merge + receiver counter reduction over flat
        dense rows.  Each receiver lives in exactly one bucket."""
        reps, L = halo.shape[0], halo.shape[-1]
        cols = recv_cols.shape[-1]
        recv_sums = torch.zeros((reps, spec.n_dst, cols),
                                dtype=recv_cols.dtype,
                                device=recv_cols.device)
        for b in spec.buckets:
            sl = slice(b.start, b.start + b.nb * b.deg)
            hp, hw = dense_halo_select(
                delivered[:, sl].reshape(reps, b.nb, b.deg),
                payload[:, sl].reshape(reps, b.nb, b.deg, L))
            sums_b = _i32_sum(recv_cols[:, sl].reshape(reps, b.nb, b.deg,
                                                       cols), 2)
            if b.members is None:
                halo = torch.where(hw[..., None], hp, halo)
                recv_sums = recv_sums + sums_b
            else:
                old = _gather_rows(halo, b.members, spec.n_dst)
                halo = _scatter_set(halo, b.members,
                                    torch.where(hw[..., None], hp, old),
                                    spec.n_dst)
                recv_sums = _scatter_add(recv_sums, b.members, sums_b,
                                         spec.n_dst)
        return halo, recv_sums

    def window_dense(self, carry, t, active, *, spec: DenseSpec):
        """Dense-layout drain phase: per degree bucket, one fused
        ``duct_window`` pass over every replicate applies the previous
        window's staged sends, drains at this window's clocks, and merges
        halos.  Returns ``(carry updates, drained_r)``."""
        C = self.cfg.buffer_capacity
        L = carry["halo"].shape[-1]
        reps = t.shape[0]
        n_dst = spec.n_dst
        halo = carry["halo"]
        zeros = torch.zeros((reps, n_dst), dtype=torch.int32,
                            device=t.device)
        drained_r, laden_r, touch_r = zeros, zeros, zeros
        parts = {key: [] for key in ("q_avail", "q_touch", "q_pay", "q_head",
                                     "q_size", "ptouch")}
        for b in spec.buckets:
            sl = slice(b.start, b.start + b.nb * b.deg)
            shp = (reps, b.nb, b.deg)

            def slab(key, *tail):
                # a view when one bucket covers every row (every built-in
                # topology); a bucket of several is copied into one
                # contiguous slab, which the kernel's fold needs
                return carry[key][:, sl].reshape(shp + tail).contiguous()

            if b.members is None:
                t_b, act_b = t, active
            else:
                t_b = _gather_rows(t, b.members, n_dst)
                act_b = (_gather_rows(active, b.members, n_dst) &
                         (b.members < n_dst))
            w = duct_window(
                slab("q_avail", C), slab("q_touch", C), slab("q_pay", C, L),
                slab("q_head"), slab("q_size"),
                slab("stage_pos"), slab("stage_acc"),
                slab("stage_avail"), slab("stage_touch"),
                slab("stage_pay", L), t_b, act_b, max_pops=self.max_pops)
            delivered = w.drained > 0
            new_touch = w.recv_touch + 1
            pt_b = slab("ptouch")
            dtouch = torch.where(delivered, new_touch - pt_b, 0)
            pt_b = torch.where(delivered, new_touch, pt_b)
            dr_b = _i32_sum(w.drained, 2)
            laden_b = _i32_sum(delivered.to(torch.int32), 2)
            tch_b = _i32_sum(dtouch, 2)
            if b.members is None:
                halo = torch.where(w.halo_win[..., None], w.halo_pay, halo)
                drained_r = drained_r + dr_b
                laden_r = laden_r + laden_b
                touch_r = touch_r + tch_b
            else:
                old = _gather_rows(halo, b.members, n_dst)
                halo = _scatter_set(
                    halo, b.members,
                    torch.where(w.halo_win[..., None], w.halo_pay, old),
                    n_dst)
                drained_r = _scatter_add(drained_r, b.members, dr_b, n_dst)
                laden_r = _scatter_add(laden_r, b.members, laden_b, n_dst)
                touch_r = _scatter_add(touch_r, b.members, tch_b, n_dst)
            rows = sl.stop - sl.start
            for key, val in (("q_avail", w.q_avail), ("q_touch", w.q_touch),
                             ("q_pay", w.q_pay), ("q_head", w.head),
                             ("q_size", w.size), ("ptouch", pt_b)):
                parts[key].append(val.reshape((reps, rows) + val.shape[3:]))
        # the buckets tile the flat rows in order, so the new ring state is
        # the concatenation of the per-bucket outputs
        new = {key: (vals[0] if len(vals) == 1 else torch.cat(vals, dim=1))
               for key, vals in parts.items()}
        new.update(
            halo=halo,
            c_msgs=carry["c_msgs"] + drained_r,
            c_laden=carry["c_laden"] + laden_r,
            c_touch=carry["c_touch"] + touch_r)
        return new, drained_r

    def window_dense_fused(self, carry, t, active, *, spec: DenseSpec,
                           dst_row):
        """One window of the W-fused superstep scheduler.

        The base rings are frozen for the whole superstep: this window's
        accepted push appends to the compact ``(rows, W)`` pushbuf, and the
        drain walks the base FIFO prefix, then (once every base message is
        popped) the pushbuf prefix.  Pops, accepts and counters are bitwise
        identical to running ``window_dense`` every window.  Returns
        ``(carry updates, drained_r)``."""
        C = self.cfg.buffer_capacity
        P = self.max_pops
        reps, R = carry["q_head"].shape
        W = carry["pb_avail"].shape[-1]
        dev = t.device
        # --- append the previous window's staged send to the pushbuf ------
        wcol = torch.arange(W, dtype=torch.int32, device=dev)
        at = carry["stage_acc"][..., None] & (
            wcol == carry["pb_cnt"][..., None])
        pb_avail = torch.where(at, carry["stage_avail"][..., None],
                               carry["pb_avail"])
        pb_touch = torch.where(at, carry["stage_touch"][..., None],
                               carry["pb_touch"])
        pb_pay = torch.where(at[..., None], carry["stage_pay"][:, :, None, :],
                             carry["pb_pay"])
        pb_cnt = carry["pb_cnt"] + carry["stage_acc"]
        # --- drain: base-prefix walk, head-blocking, bounded --------------
        t_r = t[:, dst_row]
        act_r = active[:, dst_row]
        base_rem = carry["size0"] - carry["dr_base"]
        off = carry["base_off"]
        odt = off.dtype
        blocked = ((off >= carry["dr_base"].to(odt)[..., None]) &
                   (off < carry["size0"].to(odt)[..., None]) &
                   (carry["q_avail"] > t_r[..., None]))
        first_block = torch.where(
            blocked, off, torch.tensor(C, dtype=odt, device=dev)).amin(dim=-1)
        n1 = torch.minimum(first_block.to(torch.int32) - carry["dr_base"],
                           torch.clamp(base_rem, max=P))
        n1 = torch.where(act_r, n1, 0)
        # --- then the pushbuf prefix, within the same max_pops budget -----
        pb_ok = ((wcol < pb_cnt[..., None]) & (pb_avail <= t_r[..., None])) | (
            wcol < carry["pb_pop"][..., None])
        run = (_i32_sum(torch.cumprod(pb_ok.to(torch.int32), dim=-1,
                                      dtype=torch.int32), -1) -
               carry["pb_pop"])
        n2 = torch.minimum(torch.clamp(run, min=0), P - n1)
        n2 = torch.where(act_r & (n1 == base_rem), n2, 0).to(torch.int32)
        drained = (n1 + n2).to(torch.int32)
        delivered = drained > 0
        # --- freshest popped message (touch stamp + payload) --------------
        L = carry["q_pay"].shape[-1]
        last_b = ((carry["q_head"] + carry["dr_base"] + n1 - 1) % C
                  ).long()[..., None]
        tch_b = carry["q_touch"].gather(-1, last_b)[..., 0]
        pay_b = carry["q_pay"].gather(
            2, last_b[..., None].expand(reps, R, 1, L))[:, :, 0]
        last_p = torch.clamp(carry["pb_pop"] + n2 - 1, 0, W - 1
                             ).long()[..., None]
        tch_p = pb_touch.gather(-1, last_p)[..., 0]
        pay_p = pb_pay.gather(
            2, last_p[..., None].expand(reps, R, 1, L))[:, :, 0]
        has2 = n2 > 0
        recv_touch = torch.where(has2, tch_p, torch.where(n1 > 0, tch_b, 0))
        fresh_pay = torch.where(has2[..., None], pay_p, pay_b)
        # --- halo merge + receiver counters (shared bucket machinery) -----
        new_touch = recv_touch + 1
        dtouch = torch.where(delivered, new_touch - carry["ptouch"], 0)
        ptouch = torch.where(delivered, new_touch, carry["ptouch"])
        recv_cols = torch.stack([drained, delivered.to(torch.int32),
                                 dtouch], dim=-1)
        halo, recv_sums = self._merge_buckets(
            spec, carry["halo"], delivered, fresh_pay, recv_cols)
        return dict(
            halo=halo, ptouch=ptouch,
            c_msgs=carry["c_msgs"] + recv_sums[..., 0],
            c_laden=carry["c_laden"] + recv_sums[..., 1],
            c_touch=carry["c_touch"] + recv_sums[..., 2],
            q_size=carry["q_size"] - drained,
            dr_base=carry["dr_base"] + n1.to(torch.int32),
            pb_pop=carry["pb_pop"] + n2,
            pb_cnt=pb_cnt, pb_avail=pb_avail, pb_touch=pb_touch,
            pb_pay=pb_pay), recv_sums[..., 0]

    def commit_superstep(self, carry):
        """Superstep epilogue: ONE ``duct_commit`` launch over every
        replicate folds the whole superstep's accepted pushes into the base
        rings (push j of ring r lands at slot ``(head0 + size0 + j) % C``)
        and re-bases the head/size counters for the next superstep."""
        C = self.cfg.buffer_capacity
        qa, qt, qp = duct_commit(
            carry["q_avail"], carry["q_touch"], carry["q_pay"],
            carry["q_head"], carry["size0"], carry["pb_cnt"],
            carry["pb_avail"], carry["pb_touch"], carry["pb_pay"])
        z = torch.zeros_like(carry["pb_cnt"])
        # new base size counts only committed messages: the last window's
        # staged accept (already in q_size) rides into the NEXT superstep's
        # pushbuf at its first window, not into the base ring
        size0 = (carry["size0"] - carry["dr_base"] +
                 carry["pb_cnt"] - carry["pb_pop"])
        head = (carry["q_head"] + carry["dr_base"] + carry["pb_pop"]) % C
        col = torch.arange(C, dtype=torch.int32, device=head.device)
        return dict(
            q_avail=qa, q_touch=qt, q_pay=qp, q_head=head,
            size0=size0, dr_base=z, pb_cnt=z, pb_pop=z,
            base_off=((col - head[..., None]) % C).to(self._off_dtype()))

    # ------------------------------------------------------------------
    # Phase 2: compute
    # ------------------------------------------------------------------
    def compute(self, carry, active, halo, pids):
        """The application's batched compute over every replicate, masked
        by activity.  Returns ``(app_state, edges_out, steps)``."""
        new_state, edges_out = self.bapp.step(carry["app"], halo,
                                              carry["steps"],
                                              batch_seed(carry), pids=pids)
        app_state = {
            key: torch.where(
                active.reshape(active.shape +
                               (1,) * (new.dim() - active.dim())), new,
                carry["app"][key])
            for key, new in new_state.items()}
        return app_state, edges_out, carry["steps"] + active

    # ------------------------------------------------------------------
    # Phase 3: send (edge-major)
    # ------------------------------------------------------------------
    def send_edge(self, rings, now, act, lat, touch, payload, src,
                  n_src, *, want_sums: bool = True) -> SendPhase:
        """Best-effort push attempt over the edge-major rings (drop iff the
        post-drain ring is full) plus the sender-side counter columns,
        summed per source process (sentinel ``src`` values ``n_src`` land
        in the spare segment; ``want_sums=False`` skips the sums).  The
        payload is written only into the accepted rows' push slots; the
        other rows' writes go to a spare row that is sliced off."""
        reps, rows_n = rings["q_avail"].shape[:2]
        rows = torch.arange(rows_n, dtype=torch.int64, device=now.device)
        s = duct_send(rings["q_avail"], rings["q_touch"],
                      rings["q_head"], rings["q_size"],
                      now, act, lat, touch,
                      capacity=self.cfg.buffer_capacity)
        q_pay = torch.cat([rings["q_pay"], rings["q_pay"][:, :1]], dim=1)
        rep = torch.arange(reps, dtype=torch.int64, device=now.device)
        q_pay[rep[:, None], torch.where(s.accepted, rows, rows_n),
              s.push_pos.long()] = payload
        sums = None
        if want_sums:
            send_cols = torch.stack([
                act.to(torch.int32), (act & s.accepted).to(torch.int32),
                (act & ~s.accepted).to(torch.int32)], dim=-1)
            sums = segment_sum(send_cols, src, n_src)
        return SendPhase(
            rings=dict(q_avail=s.q_avail, q_touch=s.q_touch,
                       q_size=s.size, q_pay=q_pay[:, :rows_n]),
            accepted=s.accepted, sums=sums)

    # ------------------------------------------------------------------
    # Phase 3': stage (dense layout)
    # ------------------------------------------------------------------
    def stage_dense(self, carry, u, t, active, edges_out, lat,
                    *, src, rev, out_slot, live, deg, spec: DenseSpec,
                    kill_masks=None):
        """Stage this window's sends: decide drop-iff-full NOW against the
        post-drain rings (so counters land in this window) and defer only
        the ring writes to the next fused pass.  ``live`` masks the dead
        padding rows: they never accept a push."""
        reps, n = t.shape
        src_c = src.clamp(0, n - 1)     # sentinel n on dead rows
        s_avail = t[:, src_c] + lat
        s_act = live & active[:, src_c]
        if kill_masks is not None:
            # a lost / flapped / dead-bound send still counts as attempted
            # but never reaches the ring, so it folds into c_drop via
            # att - ok like a capacity drop; loss_r/dead_r attribute it
            loss_kill, dead_kill = kill_masks
            s_act = s_act & ~(loss_kill | dead_kill)
        s_touch = u["ptouch"][:, rev]
        s_pay = edges_out[:, src_c, out_slot]
        s_pos, s_acc = dense_stage(u["q_head"], u["q_size"], s_act,
                                   capacity=self.cfg.buffer_capacity)
        # acceptance of receiver p's own sends lives at its out-edge rows
        # rev[rows of p]; dead rows rev to themselves and contribute 0
        acc_out = s_acc[:, rev].to(torch.int32)
        cols = [acc_out]
        if kill_masks is not None:
            sender_act = (live & active[:, src_c]).to(torch.int32)
            cols.append((loss_kill.to(torch.int32) * sender_act)[:, rev])
            cols.append((dead_kill.to(torch.int32) * sender_act)[:, rev])
        out_cols = torch.stack(cols, dim=-1)
        sums_r = torch.zeros((reps, spec.n_dst, out_cols.shape[-1]),
                             dtype=torch.int32, device=t.device)
        for b in spec.buckets:
            sl = slice(b.start, b.start + b.nb * b.deg)
            sums_b = _i32_sum(out_cols[:, sl].reshape(reps, b.nb, b.deg, -1),
                              2)
            if b.members is None:
                sums_r = sums_r + sums_b
            else:
                sums_r = _scatter_add(sums_r, b.members, sums_b, spec.n_dst)
        ok_r = sums_r[..., 0]
        att_r = torch.where(active, deg, 0)
        out = dict(q_size=u["q_size"] + s_acc,
                   c_att=carry["c_att"] + att_r,
                   c_ok=carry["c_ok"] + ok_r,
                   c_drop=carry["c_drop"] + att_r - ok_r,
                   stage_pos=s_pos, stage_acc=s_acc, stage_avail=s_avail,
                   stage_touch=s_touch, stage_pay=s_pay)
        if kill_masks is not None:
            out["c_loss"] = carry["c_loss"] + sums_r[..., 1]
            out["c_dead"] = carry["c_dead"] + sums_r[..., 2]
        return out

    # ------------------------------------------------------------------
    # Phase 4: close window
    # ------------------------------------------------------------------
    def close_window(self, u, active, drained_r, *, pids, deg, cfactor,
                     release):
        """Shared window tail: QoS snapshot scatter, termination, barrier
        bookkeeping, and the virtual-time advance.

        ``release`` picks where the barrier-release reductions run:
        :data:`LOCAL_RELEASE`, :data:`PIPELINED_RELEASE` (decisions
        staged one superstep boundary), their rank counterparts
        (:class:`RankRelease`, :class:`PipelinedRankRelease`), or ``None``
        to skip the release
        check (the sharded engine's mid-superstep windows: waiting clocks
        do not advance, so the release *time* computed at the superstep
        boundary is the same; only the lockstep window it lands on
        moves)."""
        cfg = self.cfg
        mode = cfg.mode
        barriered = mode in BARRIER_MODES
        t, steps = u["t"], u["steps"]
        reps, n = t.shape
        done, waiting = u["done"], u["waiting"]
        # rolling barriers meter their quantum on the WORK clock: compute
        # plus the (degree-fixed) halo pull cost, so the update schedule is
        # independent of drain timing (exactly W-invariant); the
        # free-running modes keep the drain-coupled clock
        pull_cost = deg.to(torch.float32) * _f32(cfg.per_pull_cost)
        if mode == AsyncMode.ROLLING_BARRIER:
            pending = pull_cost
        else:
            pending = (drained_r.to(torch.float32) *
                       _f32(cfg.per_message_cost) + pull_cost)
        snap_idx = u["snap_idx"]
        thr = (_f32(cfg.snapshot_warmup) +
               snap_idx.to(torch.float32) * _f32(cfg.snapshot_interval))
        snap_due = active & (t >= thr) & (snap_idx < self.S)
        row = torch.stack([
            steps.to(torch.float32), u["c_touch"].to(torch.float32),
            u["c_att"].to(torch.float32), u["c_ok"].to(torch.float32),
            u["c_drop"].to(torch.float32),
            u["c_laden"].to(torch.float32),
            u["c_msgs"].to(torch.float32), t], dim=-1)
        # snapshot scatter without a host sync: rows that are not due
        # rewrite the value already at their (clamped) slot
        rr = torch.arange(reps, device=t.device)[:, None]
        ar = torch.arange(n, device=t.device)
        slot = snap_idx.clamp(max=self.S - 1).long()
        snap = u["snap"].clone()
        snap[rr, ar, slot] = torch.where(snap_due[..., None], row,
                                         snap[rr, ar, slot])
        snap_idx = snap_idx + snap_due

        # --- termination / barriers / time advance ------------------------
        duration = _f32(cfg.duration)
        newly_done = active & (t >= duration)
        done = done | newly_done

        # --- open-loop service arrivals (runtime/service.py) --------------
        # arrivals of time bin b queue up once b has fully elapsed on the
        # process's own clock (the cumulative table travels in the carry,
        # rows keyed by pid); each update serves up to service_chunk items
        # whose cost rides on the work clock with the compute.  It reads
        # only (t, served), so every scheduler, layout and shard count
        # runs it unchanged, bitwise simulator.run's serve block.
        served = u.get("served")
        if served is not None:
            arr_cum = u["arr_cum"]
            b = arrival_bin_index(t, cfg.arrival_bin, arr_cum.shape[-1] - 1)
            avail = arr_cum[rr, ar, b.long()]
            serve = torch.clamp(avail - served, 0, cfg.service_chunk)
            serve = torch.where(active & ~newly_done, serve, 0)
            pending = pending + serve.to(torch.float32) * _f32(
                cfg.per_item_cost)
            served = served + serve

        d_next = _f32(self.base_total) * self.step_factor(
            batch_seed(u), steps, pids, cfactor)
        barrier_seq = u["barrier_seq"]
        last_release = u["last_release"]
        pending_saved = u["pending"]

        if barriered:
            if mode == AsyncMode.BARRIER_EVERY_STEP:
                due = active & ~newly_done
            elif mode == AsyncMode.ROLLING_BARRIER:
                due = active & ~newly_done & (
                    (t - last_release) >= _f32(cfg.rolling_quantum))
            else:
                due = active & ~newly_done & (
                    t >= (barrier_seq + 1).to(torch.float32) *
                    _f32(cfg.fixed_interval))
            waiting = waiting | due
            pending_saved = torch.where(due, pending, pending_saved)
            t = torch.where(active & ~newly_done & ~due,
                            t + d_next + pending, t)
            quarantined = "quar" in u
            tau = _f32(cfg.barrier_timeout)
            if release is not None:
                if release.staged:
                    # pipelined: apply the decision issued one boundary
                    # earlier (frozen cohort, see PipelinedRelease)
                    release_ready = u["rel_ready"][:, None]
                    release_t = u["rel_t"][:, None]
                    if quarantined:
                        ref = u["rel_ref"][:, None]
                else:
                    # decide now, over every process (see _decide)
                    release_ready, release_t, ref = self._decide(
                        release, t, waiting, done,
                        u["quar"] if quarantined else None)
                rel = release_ready & waiting
                if quarantined:
                    # hysteresis, evaluated on the pre-release state
                    quar = u["quar"]
                    readmit = waiting & quar & (
                        t >= ref - _f32(np.float32(tau) * np.float32(0.5)))
                    newq = ~done & ~waiting & (t > ref + tau)
                    quar = torch.where(release_ready,
                                       (quar & ~readmit) | newq, quar)
                # horizon snap: a cohort released at or past the horizon
                # is done at the horizon clock
                at_horizon = release_t >= duration
                t = torch.where(
                    rel, torch.where(at_horizon, duration,
                                     release_t + d_next + pending_saved), t)
                done = done | (rel & at_horizon)
                last_release = torch.where(rel, release_t, last_release)
                barrier_seq = barrier_seq + rel
                waiting = waiting & ~release_ready
        else:
            t = torch.where(active & ~newly_done, t + d_next + pending, t)

        out = dict(u)
        out.update(k=u["k"] + 1, t=t, done=done, waiting=waiting,
                   barrier_seq=barrier_seq, last_release=last_release,
                   pending=pending_saved, snap=snap, snap_idx=snap_idx)
        if served is not None:
            out["served"] = served
        if barriered and release is not None and quarantined:
            out["quar"] = quar
        if barriered and release is not None and release.staged:
            # store fresh post-release reductions for the next boundary
            fresh_ready, fresh_t, fref = self._decide(
                release, t, waiting, done, quar if quarantined else None)
            if quarantined:
                out["rel_ref"] = fref[:, 0]
            out.update(rel_ready=fresh_ready[:, 0], rel_t=fresh_t[:, 0])
        return out

    def _decide(self, release, t, waiting, done, quar=None):
        """The barrier-release decision over the whole population:
        ``(ready, release time, cohort front)``, each ``(R, 1)``; the
        front is ``None`` without quarantine.  Without it the cohort is
        released once every process is waiting or done and one is
        waiting, at the latest waiting clock plus the barrier cost.  With
        it (``quar`` the quarantine flags), the front is the latest
        waiting clock of the non-quarantined core (of every waiting
        process where all are quarantined), a process that is neither
        stopped nor quarantined but lags the front by more than the
        timeout no longer holds the release back, and the release time is
        the front plus the barrier cost (a non-waiting, non-done
        process's clock is its next barrier arrival; crashed clocks sit at
        ``+inf``).  Each phase's reductions go to ``release.reduce``
        together."""
        cost = _f32(self.barrier_cost)
        stopped = waiting | done
        if quar is None:
            all_stopped, any_waiting, (tmax,) = release.reduce(
                stopped=stopped, waiting=waiting,
                times=(torch.where(waiting, t, -torch.inf),))
            return all_stopped & any_waiting, tmax + cost, None
        _, any_waiting, (core, full) = release.reduce(
            waiting=waiting,
            times=(torch.where(waiting & ~quar, t, -torch.inf),
                   torch.where(waiting, t, -torch.inf)))
        ref = torch.where(core == -torch.inf, full, core)
        unreachable = ~stopped & (t > ref + _f32(self.cfg.barrier_timeout))
        all_stopped, _, _ = release.reduce(
            stopped=stopped | quar | unreachable)
        return any_waiting & all_stopped, ref + cost, ref

    # ------------------------------------------------------------------
    # QoS assembly
    # ------------------------------------------------------------------
    def assemble(self, carry, r: int, deg: np.ndarray, quality: float,
                 app_state=None) -> SimResult:
        """Numpy-vectorized QoS assembly of replicate ``r`` of a batched
        carry (a dict of numpy arrays); the math mirrors
        ``core.qos.report`` exactly."""
        cfg = self.cfg
        n = deg.shape[0]
        comm = cfg.mode != AsyncMode.NO_COMM
        carry = {key: val[r] for key, val in carry.items()
                 if not isinstance(val, dict)}
        snap = np.asarray(carry["snap"], np.float64)          # (n, S, 8)
        snap_idx = np.asarray(carry["snap_idx"])
        steps = np.asarray(carry["steps"])

        nwin = np.maximum(snap_idx - 1, 0)                    # reports/proc
        d = snap[:, 1:, :] - snap[:, :-1, :]                  # (n, S-1, 8)
        dup, dtch, datt = d[..., 0], d[..., 1], d[..., 2]
        ddrop, dladen, dmsg, dwall = (d[..., 4], d[..., 5], d[..., 6],
                                      d[..., 7])
        # zero-update windows stamp the explicit inf sentinel (idle != fast)
        idle = dup <= 0
        fin_period = dwall / np.maximum(dup, 1)
        period = np.where(idle, np.inf, fin_period)
        lat = dup / np.maximum(dtch, 1)
        # product over the finite period only: 0 * inf would leak nan
        wall_lat = np.where(idle, np.inf, lat * fin_period)
        fail = np.where(datt > 0, ddrop / np.maximum(datt, 1), 0.0)
        dpull = dup * deg[:, None] if comm else np.zeros_like(dup)
        opp = np.minimum(dmsg, dpull)
        clump = np.where(
            opp > 0, 1.0 - np.minimum(dladen / np.maximum(opp, 1), 1.0),
            0.0)
        t0, t1 = snap[:, :-1, 7], snap[:, 1:, 7]

        qos_by_proc: Dict[int, List[QosReport]] = {}
        all_qos: List[QosReport] = []
        for p in range(n):
            reps = [QosReport(
                simstep_period=float(period[p, i]),
                simstep_latency=float(lat[p, i]),
                walltime_latency=float(wall_lat[p, i]),
                delivery_failure_rate=float(fail[p, i]),
                delivery_clumpiness=float(clump[p, i]),
                t_start=float(t0[p, i]), t_end=float(t1[p, i]))
                for i in range(int(nwin[p]))]
            qos_by_proc[p] = reps
            all_qos.extend(reps)

        service = None
        if "served" in carry:
            srv = np.asarray(carry["served"])
            tot = np.asarray(carry["arr_cum"])[:, -1]
            service = {
                "arrivals": [int(x) for x in tot],
                "served": [int(x) for x in srv],
                "backlog": [int(a - s) for a, s in zip(tot, srv)],
            }

        return SimResult(
            updates=[int(x) for x in steps],
            horizon=cfg.duration,
            quality=quality,
            qos=all_qos,
            qos_by_process=qos_by_proc,
            dropped=int(np.sum(carry["c_drop"])),
            dropped_loss=(int(np.sum(carry["c_loss"]))
                          if "c_loss" in carry else 0),
            dropped_dead=(int(np.sum(carry["c_dead"]))
                          if "c_dead" in carry else 0),
            sent=int(np.sum(carry["c_att"])),
            service=service,
            app_state=app_state,
        )
