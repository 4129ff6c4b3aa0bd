"""Mesh-sharded windowed-time engine on torch tensors.

The PyTorch counterpart of the reference's ``ShardedJaxEngine``
(``runtime/engine_sharded.py``).  The population is partitioned into S
contiguous process blocks (``topologies.contiguous_partition``); every duct
ring lives on its *receiver's* shard, so drains, halo merges and
receiver-side QoS counters are shard-local, and only the boundary edges
between shards are exchanged, in two hops per distinct shard offset:

  1. payload hop: for each boundary edge the sending shard packs (edge
     payload, availability stamp ``t_src + latency``, touch counter, active
     bit) into one int32 buffer that moves to the receiver's shard, which
     scatters the entries into its send rows;
  2. accept hop: after the send (drop iff the ring is full) the receiving
     shard returns the accept bits, so the sender keeps its processes'
     attempted / ok / dropped counters.

The shard axis is a tensor dimension: shard ``s``'s process ``i`` sits at
position ``s * m + i`` and its local duct row ``r`` at row ``s * ein + r``
(every shard padded to ``ein`` rows, as the reference pads its tables for
``shard_map``), so each window phase (drain, compute, stage, send, close)
runs once over all of a process's shards and each duct kernel launches
once per phase whatever S is.  The hops go through ``launch/mesh.py``,
the hops one phase has ready together in one call (``mesh.hops``).

In one process (``group=None``) all S shards live on one device, a hop is
a ``torch.roll`` and the release reductions over all shards are the
single-device ones (``window_core.LOCAL_RELEASE``).  With ``group=`` a
``launch.mesh.RankGroup`` of P ranks, the shard axis is split over them:
rank ``r`` keeps shards ``[r * S/P, (r + 1) * S/P)``, its block of the
static tables (built for all S shards as in one process, then sliced)
and its block of the carry, indexed as if its shards were all there are.
A hop sends the boundary buffers that leave the rank to its peers, the
release reductions and the done probe are all-reduced over the ranks
(``window_core.RankRelease``), so every rank runs the same windows and
chunks, and the run ends with every rank gathering the whole carry, so
each returns the one-process ``SimResult``.  P ranks compute exactly what
one process computes at the same S.

Schedulers (``scheduler=``):

  window     the exchange runs every lockstep window
  superstep  each shard runs ``superstep_windows=W`` windows shard-locally
             (boundary sends staged sender-side with their exact stamps),
             then one payload hop and one accept hop per offset move all W
             windows' boundary traffic; the receiver pushes it in
             sender-window order.  ``W=1`` is the per-window engine
             bitwise; W > 1 perturbs drop patterns within the reference's
             documented tolerance, and barrier releases land on superstep
             boundaries (release times are unchanged)
  pipelined  the superstep exchange double-buffered: the buffers staged at
             boundary k travel in ``fly_fwd_<off>`` and are pushed at
             boundary k+1, their accept bits ride ``fly_acc_<off>`` back to
             be folded at k+2, and barrier releases are consumed one
             boundary late (:class:`~repro_torch.runtime.window_core.
             PipelinedRelease`); an epilogue flush empties the buffers so
             message conservation closes exactly

The rings keep one row order whatever ``layout`` asks for: edge-major
rows in ascending canonical order per shard, the drain merging halos by
segment max.  The reference's dense order (receiver-major bucket slabs)
gives the same result bitwise, and on the card it ran slower (more
launches a window, ``PERF.md`` §6), so ``layout`` is accepted and names
no other path.  The rings go through the ``duct_exchange`` kernel's
``drain`` and ``send`` entry points, as the reference's sharded engine
runs ``duct_drain`` and ``duct_send`` on both its layouts.

Every stochastic draw stays keyed by *original* pid and *canonical* edge
id and halo ties resolve by canonical edge id, so any shard count
reproduces ``shards=1`` bitwise.  Replicates run as one batch, the
replicate axis leading and the shard axis inside it, as the reference
vmaps the replicates inside each shard: every carry leaf and every hop
buffer has the replicate axis first, so the shard axis the hops move
along is dimension 1.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.core.modes import AsyncMode
from repro_torch.launch import mesh
from repro_torch.runtime.engine import SCHEDULERS
from repro_torch.runtime.engine_torch import TorchEngine
from repro_torch.runtime.topologies import LAYOUTS, contiguous_partition
from repro_torch.runtime.window_core import (
    BARRIER_MODES,
    STREAM_LAT,
    LOCAL_RELEASE,
    PIPELINED_RELEASE,
    PipelinedRankRelease,
    RankRelease,
    _i32_sum,
    batch_seed,
    _scatter_set,
    lognormal_factor,
    segment_sum,
)

#: carry keys indexed by the process axis (permuted into shard order); the
#: service keys ("arr_cum", "served"), the fault-attribution counters and
#: the quarantine flags are present only when the config enables them
_PROC_KEYS = ("t", "steps", "done", "waiting", "barrier_seq", "last_release",
              "pending", "c_touch", "c_att", "c_ok", "c_drop", "c_laden",
              "c_msgs", "c_loss", "c_dead", "quar", "snap", "snap_idx",
              "halo", "arr_cum", "served")
#: the ring fields a push pass reads and writes
_RING_KEYS = ("q_avail", "q_touch", "q_head", "q_size", "q_pay")
#: carry keys indexed by the duct row axis
_ROW_KEYS = ("ptouch",) + _RING_KEYS


def _bits_i32(x: torch.Tensor) -> torch.Tensor:
    """Reinterpret float32 as int32 so one hop buffer carries mixed
    fields."""
    return x if x.dtype == torch.int32 else x.view(torch.int32)


def _from_bits(x: torch.Tensor, dtype) -> torch.Tensor:
    return x if dtype == torch.int32 else x.contiguous().view(dtype)


def _pad1(x: torch.Tensor) -> torch.Tensor:
    """``x`` (R, rows, ...) with one zero row appended to each replicate's
    rows: the sentinel index's gather."""
    return torch.cat([x, x.new_zeros((x.shape[0], 1) + tuple(x.shape[2:]))],
                     dim=1)


class ShardedTorchEngine(TorchEngine):
    """Windowed-time engine over S shards, on one device or split over
    the ranks of ``group``.

    Same ``Engine`` contract and same trajectories as
    :class:`~repro_torch.runtime.engine_torch.TorchEngine`; built by the
    registry when ``shards`` > 1.
    """

    def __init__(self, app, cfg, faults=None, *, shards: int,
                 superstep_windows: int = 1, scheduler: str = "auto",
                 max_pops: int = 16, chunk: int = 256, layout: str = "auto",
                 device="cuda", group=None):
        if layout not in LAYOUTS:
            raise ValueError(
                f"unknown layout {layout!r}; choose from {LAYOUTS}")
        if group is not None:
            if group.blocks != int(shards):
                raise ValueError(
                    f"the rank group splits {group.blocks} shards, the "
                    f"engine has {shards}")
            if torch.device(device).type != group.device.type:
                raise ValueError(
                    f"device {device!r} was asked for, but the rank group "
                    f"keeps its shards on {group.device}")
            device = group.device
        super().__init__(app, cfg, faults, max_pops=max_pops, chunk=chunk,
                         layout="edge", device=device)
        if self.bapp.payload_dtype not in (torch.int32, torch.float32):
            raise ValueError(
                "sharded engine payloads must be int32/float32 (32-bit hop "
                f"packing), got {self.bapp.payload_dtype}")
        W = int(superstep_windows)
        if W < 1:
            raise ValueError(
                f"superstep_windows must be >= 1, got {superstep_windows}")
        if scheduler == "auto":
            scheduler = "superstep" if W > 1 else "window"
        if scheduler not in SCHEDULERS:
            raise ValueError(
                f"unknown scheduler {scheduler!r}; choose from "
                f"{('auto',) + SCHEDULERS}")
        if scheduler == "pipelined" and W < 2:
            raise ValueError(
                "scheduler='pipelined' overlaps boundary exchange with the "
                "next superstep's interior windows; pass "
                "superstep_windows > 1 (--superstep-windows W) to choose W")
        self.scheduler = scheduler
        self.superstep_windows = W
        if cfg.mode in BARRIER_MODES:
            # releases land only on superstep boundaries, so up to W-1 idle
            # windows precede each one; the pipelined scheduler defers the
            # release and the boundary delivery one more superstep
            if scheduler == "pipelined":
                self._max_windows *= 2 * W
            elif W > 1:
                self._max_windows *= W
        self._supersteps_per_call = max(1, chunk // W)
        self._windows_per_call = self._supersteps_per_call * W
        self.shards = int(shards)
        self.plan = contiguous_partition(self.topo, self.shards)
        self._m = self.n // self.shards
        #: the ranks the shard axis is split over (None: one process)
        self.group = group
        #: this process's shards: ``_blocks`` of them from shard ``_lo``,
        #: ``_nl`` processes
        self._blocks = self.shards // (1 if group is None else group.size)
        self._lo = 0 if group is None else group.lo
        self._nl = self._blocks * self._m
        if group is None:
            self._release = (PIPELINED_RELEASE if scheduler == "pipelined"
                             else LOCAL_RELEASE)
        else:
            self._release = (PipelinedRankRelease(group)
                             if scheduler == "pipelined"
                             else RankRelease(group))
            self._stop_release = RankRelease(group)
        self._build_statics()
        self._crashed_probe = self._crashed_pos

    # ------------------------------------------------------------------
    # Static shard layout: local rows (rings on the receiver's shard) and
    # per-offset boundary tables, built per shard in numpy as the
    # reference builds them, then laid out over all shards
    # ------------------------------------------------------------------
    def _build_statics(self) -> None:
        S, m, E = self.shards, self._m, self.E
        esrc = self._esrc.cpu().numpy()
        edst = self._edst.cpu().numpy()
        slot = self._halo_key.cpu().numpy() % 4
        out_slot = self._out_slot.cpu().numpy()
        rev = self._rev.cpu().numpy()
        lat_base = self._lat_base.cpu().numpy()
        perm = np.asarray(self.plan.perm, np.int64)
        inv = np.asarray(self.plan.inv, np.int64)

        lsrc, ldst = inv[esrc], inv[edst]     # edge endpoints as positions
        src_sh, dst_sh = lsrc // m, ldst // m
        rows_by_shard = [np.where(dst_sh == s)[0] for s in range(S)]
        # canonical edge id -> its ring's local row (ascending canonical
        # order per shard, so segment-max tie-breaks match the unsharded
        # engine)
        ein = max(1, max(len(r) for r in rows_by_shard))
        row_of = np.full(E, -1, np.int64)
        for rows in rows_by_shard:
            row_of[rows] = np.arange(len(rows))
        self._ein = ein

        i64, f32 = np.int64, np.float32
        has_f = self._has_faults
        per_edge = {}
        if has_f:
            # per-canonical-edge fault parameters, laid onto the local rows
            # and the boundary send tables, so kill draws stay keyed by
            # canonical edge id
            per_edge = dict(loss=self._loss.cpu().numpy(),
                            flap=self._flap.cpu().numpy(),
                            dead=self._dead.cpu().numpy())
        row = dict(canon=np.zeros((S, ein), np.int32),
                   dst=np.full((S, ein), m, i64),
                   src=np.full((S, ein), m, i64),   # sentinel m: not interior
                   interior=np.zeros((S, ein), bool),
                   out_slot=np.zeros((S, ein), i64),
                   rev=np.full((S, ein), ein, i64),  # sentinel: not local
                   halo_key=np.full((S, ein), 4 * m, i64),
                   lat=np.zeros((S, ein), f32))
        for key, x in per_edge.items():
            row[key] = np.zeros((S, ein), x.dtype)
        for s in range(S):
            e = rows_by_shard[s]
            r = row_of[e]
            interior = src_sh[e] == s
            row["canon"][s, r] = e
            row["dst"][s, r] = ldst[e] - s * m
            row["src"][s, r] = np.where(interior, lsrc[e] - s * m, m)
            row["interior"][s, r] = interior
            row["out_slot"][s, r] = out_slot[e]
            # the reverse edge drains at the source: local iff this edge
            # is interior; boundary rows get their touch stamp by the hop
            row["rev"][s, r] = np.where(interior, row_of[rev[e]], ein)
            row["halo_key"][s, r] = (ldst[e] - s * m) * 4 + slot[e]
            row["lat"][s, r] = lat_base[e]
            for key, x in per_edge.items():
                row[key][s, r] = x[e]

        # boundary edges grouped by shard offset: one hop per offset
        bnd = np.where(src_sh != dst_sh)[0]
        offs = (dst_sh[bnd] - src_sh[bnd]) % S
        self._offsets = sorted(int(d) for d in set(offs.tolist()))
        self._bnd_bd: Dict[int, int] = {}
        tables: Dict[int, Dict[str, np.ndarray]] = {}
        for d in self._offsets:
            sel = bnd[offs == d]
            per_s = [sel[src_sh[sel] == s] for s in range(S)]  # canon order
            bd = max(1, max(len(p) for p in per_s))
            self._bnd_bd[d] = bd
            tb = dict(snd_src=np.full((S, bd), m, i64),
                      snd_oslot=np.zeros((S, bd), i64),
                      snd_rev=np.full((S, bd), ein, i64),
                      snd_canon=np.zeros((S, bd), np.int32),
                      snd_lat=np.zeros((S, bd), f32),
                      rcv_row=np.full((S, bd), ein, i64))
            for key, x in per_edge.items():
                tb["snd_" + key] = np.zeros((S, bd), x.dtype)
            for s in range(S):
                e = per_s[s]
                k = len(e)
                tb["snd_src"][s, :k] = lsrc[e] - s * m
                tb["snd_oslot"][s, :k] = out_slot[e]
                tb["snd_rev"][s, :k] = row_of[rev[e]]
                tb["snd_canon"][s, :k] = e
                tb["snd_lat"][s, :k] = lat_base[e]
                for key, x in per_edge.items():
                    tb["snd_" + key][s, :k] = x[e]
                # sender s's entry j lands at receiver (s+d)%S, entry j
                tb["rcv_row"][(s + d) % S, :k] = row_of[e]
            tables[d] = tb

        # compact boundary-row set: the union of every offset's receiver
        # rows, per shard.  The push passes before a superstep's last
        # window touch only these rows (gather, push, scatter back)
        bnd_rows = [set() for _ in range(S)]
        for d in self._offsets:
            for s in range(S):
                bnd_rows[s].update(int(r) for r in tables[d]["rcv_row"][s]
                                   if r < ein)
        eb = max(1, max((len(x) for x in bnd_rows), default=1))
        self._eb = eb
        rows_bnd = np.full((S, eb), ein, i64)   # sentinel ein: scatter-drop
        pos_of: List[Dict[int, int]] = []
        for s in range(S):
            rs = sorted(bnd_rows[s])
            rows_bnd[s, :len(rs)] = rs
            pos_of.append({r: i for i, r in enumerate(rs)})
        for d in self._offsets:
            tb = tables[d]
            rcv_pos = np.full(tb["rcv_row"].shape, eb, i64)
            for s in range(S):
                for j, r in enumerate(tb["rcv_row"][s].tolist()):
                    if r < ein:
                        rcv_pos[s, j] = pos_of[s][r]
            tb["rcv_pos"] = rcv_pos

        # --- lay this process's shards' tables out over its B shards:
        # positions s*m + i, rows s*ein + r, sub-ring entries s*eb + i; the
        # local sentinels become the process's (B*m, B*ein, B*eb, 4*B*m),
        # one spare slot each.  Every other rank's shards are left out
        dev = self.device
        B, own = self._blocks, slice(self._lo, self._lo + self._blocks)
        glob = self._to_global

        def t(x):
            return torch.as_tensor(np.ascontiguousarray(x).reshape(-1),
                                   device=dev)

        row = {key: x[own] for key, x in row.items()}
        rows_bnd = rows_bnd[own]
        tables = {d: {key: x[own] for key, x in tb.items()}
                  for d, tb in tables.items()}
        self._row_dst = t(glob(row["dst"], m))
        self._row_halo_key = t(glob(row["halo_key"], 4 * m))
        self._rows_bnd = t(glob(rows_bnd, ein))
        # the compact passes' gather reads row 0 at the pads (nothing
        # pushes into it); their scatter drops the pads
        self._rows_bnd_gather = self._rows_bnd.clamp(max=B * ein - 1)
        self._sub_src = torch.zeros(B * eb, dtype=torch.int64, device=dev)
        # the send list: every send a window makes, the local rows (only
        # interior rows send; the others carry the sentinel source), then
        # each offset's boundary entries in canonical order per shard
        self._bnd: Dict[int, Dict[str, torch.Tensor]] = {}
        parts = [dict(src=glob(row["src"], m), canon=row["canon"],
                      lat=row["lat"], oslot=row["out_slot"],
                      rev=glob(row["rev"], ein),
                      live=row["interior"],
                      **{key: row[key] for key in per_edge})]
        for d in self._offsets:
            tb = tables[d]
            snd_src = glob(tb["snd_src"], m)
            parts.append(dict(
                src=snd_src, canon=tb["snd_canon"], lat=tb["snd_lat"],
                oslot=tb["snd_oslot"], rev=glob(tb["snd_rev"], ein),
                live=np.ones(snd_src.shape, bool),
                **{key: tb["snd_" + key] for key in per_edge}))
            self._bnd[d] = dict(
                snd_src=t(snd_src),
                rcv_row=t(glob(tb["rcv_row"], ein)),
                rcv_pos=t(glob(tb["rcv_pos"], eb)))
        self._send = {key: t(np.concatenate([p[key].reshape(-1)
                                             for p in parts]))
                      for key in parts[0]}
        self._send["src_rows"] = t(parts[0]["src"])
        self._send_sizes = [p["src"].size for p in parts]
        self._perm = torch.as_tensor(perm, device=dev)
        self._inv = torch.as_tensor(inv, device=dev)
        # the original pids of this process's positions
        own_perm = self._perm[self._lo * m:(self._lo + B) * m]
        self._pids_pos = own_perm.to(torch.int32)
        self._cfactor_pos = self._cfactor[own_perm]
        self._deg_pos = self._deg[own_perm]
        self._crashed_pos = self._crashed[own_perm]

    def _to_global(self, local: np.ndarray, block: int) -> np.ndarray:
        """Shard-local indices ``local`` (B, k) of this process's B
        shards, each in ``[0, block)`` or the local sentinel ``block``, as
        indices over its shards: ``s * block + local``, the sentinel
        mapped to ``B * block``."""
        B = local.shape[0]
        base = np.arange(B, dtype=np.int64)[:, None] * block
        return np.where(local >= block, B * block, base + local)

    # ------------------------------------------------------------------
    # Carry and its layout transforms
    # ------------------------------------------------------------------
    def _edge_state(self) -> Dict[str, torch.Tensor]:
        """Empty rings of this process's shards in padded per-shard
        layout: ``B * ein`` rows, row ``s * ein + j`` = its shard s's local
        row j."""
        return self.core.edge_rings(self._blocks * self._ein, self.device)

    def _init_carry(self, seed: int) -> Dict[str, torch.Tensor]:
        carry = super()._init_carry(seed)
        if (self.scheduler == "pipelined" and
                self.cfg.mode != AsyncMode.NO_COMM):
            # the double buffers, per shard and offset:
            #   fly_fwd_<off>  buffers staged at the previous boundary, in
            #                  flight toward their receiver, pushed into
            #                  rings at the NEXT boundary
            #   fly_acc_<off>  packed (att << 1) | accept bits returning to
            #                  the sender, folded at the next boundary
            # all zero: att = 0 entries are no-ops, so the pipeline fills
            W, B, Lp = self.superstep_windows, self._blocks, \
                self.bapp.payload_len
            dev = self.device
            for off in self._offsets:
                bd = self._bnd_bd[off]
                carry[f"fly_fwd_{off}"] = torch.zeros(
                    (B, W, bd, Lp + 3), dtype=torch.int32, device=dev)
                carry[f"fly_acc_{off}"] = torch.zeros(
                    (B, W, bd), dtype=torch.int32, device=dev)
            if self.cfg.mode in BARRIER_MODES:
                # the staged release decision (PipelinedRelease): issued at
                # boundary i, consumed at i+1; every shard holds the same
                carry["rel_ready"] = torch.tensor(False, device=dev)
                carry["rel_t"] = torch.tensor(-np.inf, dtype=torch.float32,
                                              device=dev)
                if self.cfg.barrier_timeout > 0:
                    # the quarantine gate's cohort front rides the same
                    # one-boundary stage as the decision
                    carry["rel_ref"] = torch.tensor(
                        -np.inf, dtype=torch.float32, device=dev)
        return carry

    def _permuted(self, carry, index):
        out = dict(carry)
        for key in _PROC_KEYS:
            if key in carry:
                out[key] = carry[key][:, index]
        out["app"] = {k: v[:, index] for k, v in carry["app"].items()}
        return out

    def _to_sharded_layout(self, carry):
        """Process-axis entries into shard order (the rings are built in
        the per-shard layout already)."""
        return self._permuted(carry, self._perm)

    def _to_canonical_layout(self, carry):
        """Undo the process permutation on everything the result reads."""
        return self._permuted(carry, self._inv)

    def _own_block(self, carry):
        """A carry of all S shards (in shard order) cut to this process's
        shards' processes; its rings and in-flight buffers are built for
        its shards alone."""
        if self.group is None:
            return carry
        own = slice(self._lo * self._m, (self._lo + self._blocks) * self._m)
        out = dict(carry)
        for key in _PROC_KEYS:
            if key in carry:
                out[key] = carry[key][:, own]
        out["app"] = {k: v[:, own] for k, v in carry["app"].items()}
        return out

    def _gathered(self, carry):
        """Every rank's carry of its shards, all-gathered into the carry
        of all S shards in shard order: processes, rings and in-flight
        buffers concatenated in rank order (the ranks hold ascending runs
        of shards).  The seed, the window counter and the staged release
        are the same on every rank and stay as they are."""
        if self.group is None:
            return carry
        g = self.group
        out = dict(carry)
        for key, x in carry.items():
            if key in _PROC_KEYS or key in _ROW_KEYS or key.startswith(
                    "fly_"):
                out[key] = g.all_gather(x, 1)
        out["app"] = {k: g.all_gather(v, 1)
                      for k, v in carry["app"].items()}
        return out

    # ------------------------------------------------------------------
    # Window phases over all shards at once
    # ------------------------------------------------------------------
    def _drain_phase(self, carry, t_pad, act_pad):
        """Drain every ring (they live on their receiver's shard)."""
        dst = self._row_dst
        return self.core.drain(
            carry, t_pad[:, dst], act_pad[:, dst],
            halo_key=self._row_halo_key, n_halo=4 * self._nl, dst=dst,
            n_dst=self._nl)

    def _sends(self, seed, pads):
        """Every send of this window, over the send list (the local rows,
        then each offset's boundary entries), packed one ``(L+3,)`` int32
        record each: payload bits, the availability stamp ``t_src +
        latency``, the reverse-edge touch counter and the active bit.

        Boundary sends are staged sender-side: their stamps are drawn now,
        at the sender's window, so a batched exchange at the superstep
        boundary still delivers exact virtual-time metadata.  Typed fault
        kills are decided here too: a killed send keeps a zero active bit
        (a boundary one never crosses as an attempt), and its [loss, dead]
        counts come back per process ``(n, 2)`` for the caller to fold in
        this very window.  Draws are keyed by canonical edge id and sender
        step count, as in the unsharded engine; one latency draw and one
        fault draw serve the whole list.

        Returns ``(interior, staged, kills)``: the rows' records ``(R,
        B*ein, L+3)`` (only interior senders active; B the process's
        shards), per offset the ``(R, B, bd, L+3)`` buffer, and the kill
        counts (``None`` without faults)."""
        sd, n = self._send, self._nl
        src = sd["src"]
        steps = pads["steps"][:, src]
        lat = sd["lat"] * lognormal_factor(
            self.cfg.latency_sigma, seed, STREAM_LAT, sd["canon"], steps)
        t_src = pads["t"][:, src]
        act = pads["act"][:, src] & sd["live"]
        kills = None
        if self._has_faults:
            loss_kill, dead_kill = self.core.fault_masks(
                seed, t_src, steps, sd["canon"], sd["loss"], sd["flap"],
                self.faults.flap_period, sd["dead"])
            cols = torch.stack([(act & loss_kill).to(torch.int32),
                                (act & dead_kill).to(torch.int32)], dim=-1)
            kills = segment_sum(cols, src, n)
            act = act & ~(loss_kill | dead_kill)
        packed = torch.cat([
            _bits_i32(pads["eo"][:, src, sd["oslot"]]),
            _bits_i32(t_src + lat)[..., None],
            pads["ptouch"][:, sd["rev"]][..., None],
            act[..., None].to(torch.int32)], dim=-1)
        interior, *bnd = packed.split(self._send_sizes, dim=1)
        reps = packed.shape[0]
        staged = {off: b.reshape(reps, self._blocks, self._bnd_bd[off], -1)
                  for off, b in zip(self._offsets, bnd)}
        return interior, staged, kills

    def _unpack(self, x):
        """Send records ``(R, rows, L+3)`` as ``(pay, avail, touch, act)``;
        the last three, the send kernel's inputs, contiguous."""
        Lp = self.bapp.payload_len
        return (_from_bits(x[..., :Lp], self.bapp.payload_dtype),
                _from_bits(x[..., Lp], torch.float32),
                x[..., Lp + 1].contiguous(),
                x[..., Lp + 2].contiguous().bool())

    def _close_window(self, u, active, drained_r, *, release: bool):
        """Shared window tail with the release reductions over all shards
        (on one device, the single-device ones); windows
        inside a superstep (``release=False``) skip the release check:
        waiting processes stay waiting until the boundary."""
        return self.core.close_window(
            u, active, drained_r, pids=self._pids_pos, deg=self._deg_pos,
            cfactor=self._cfactor_pos,
            release=self._release if release else None)

    def _window_inputs(self, carry):
        """Drain and compute of one window, and the padded per-process
        vectors its sends gather from (index n: a dummy, inactive
        process).  Returns ``(u, active, drained_r, pads)``, ``pads`` None
        without communication."""
        comm = self.cfg.mode != AsyncMode.NO_COMM
        t = carry["t"]
        active = ~carry["done"] & ~carry["waiting"]
        if self._any_crashed:
            active = active & ~self._crashed_pos
        t_pad, act_pad = _pad1(t), _pad1(active)
        u = dict(carry)
        drained_r = torch.zeros_like(carry["steps"])
        if comm:
            dr, drained_r = self._drain_phase(carry, t_pad, act_pad)
            u.update(dr)
        app_state, edges_out, steps = self.core.compute(
            carry, active, u["halo"], self._pids_pos)
        u.update(app=app_state, steps=steps)
        pads = None
        if comm:
            pads = dict(t=t_pad, act=act_pad, eo=_pad1(edges_out),
                        ptouch=_pad1(u["ptouch"]), steps=_pad1(steps))
        return u, active, drained_r, pads

    def _fold_counters(self, u, carry, send_sums, kills):
        """Sender counters of one window; killed sends count attempted +
        dropped + their cause."""
        if kills is not None:
            killed = kills[..., 0] + kills[..., 1]
            u.update(c_att=carry["c_att"] + send_sums[..., 0] + killed,
                     c_ok=carry["c_ok"] + send_sums[..., 1],
                     c_drop=carry["c_drop"] + send_sums[..., 2] + killed,
                     c_loss=carry["c_loss"] + kills[..., 0],
                     c_dead=carry["c_dead"] + kills[..., 1])
        else:
            u.update(c_att=carry["c_att"] + send_sums[..., 0],
                     c_ok=carry["c_ok"] + send_sums[..., 1],
                     c_drop=carry["c_drop"] + send_sums[..., 2])

    # ------------------------------------------------------------------
    # Window bodies
    # ------------------------------------------------------------------
    def _local_window(self, carry):
        """One window inside a superstep, entirely shard-local.

        Interior edges exchange through their local rings as usual;
        boundary sends are packed into per-offset staging buffers and
        returned for the superstep to stack.  Nothing crosses shards, so
        each shard advances at its own pace.  Returns ``(carry,
        staged)``."""
        u, active, drained_r, pads = self._window_inputs(carry)
        staged = {}
        if pads is not None:
            interior, staged, kills = self._sends(batch_seed(carry), pads)
            pay, avail, touch, act = self._unpack(interior)
            sp = self.core.send_edge(u, avail, act, torch.zeros_like(avail),
                                     touch, pay, self._send["src_rows"],
                                     self._nl)
            u.update(sp.rings)
            self._fold_counters(u, carry, sp.sums, kills)
        return self._close_window(u, active, drained_r,
                                  release=False), staged

    def _final_window(self, carry, stage_mid):
        """The superstep's last window: the only one that talks to peers.

        All staged boundary windows (plus this window's own) move in one
        payload hop per shard offset; the receiver pushes them into its
        rings in sender-window order (drop iff full per push, FIFO
        preserved), and the accept bits return in one reverse hop per
        offset so the sender's attempted / ok / dropped counters stay
        exact.  With ``superstep_windows=1`` this is the per-window
        exchange."""
        u, active, drained_r, pads = self._window_inputs(carry)
        if pads is not None:
            Lp = self.bapp.payload_len
            interior, own, kills = self._sends(batch_seed(carry), pads)
            # --- payload hop: one per offset for all W windows ------------
            # (the sender keeps its copy: the att bits)
            staged_l = {off: self._with_own(stage_mid, own, off)
                        for off in self._offsets}
            staged_r = dict(zip(self._offsets, mesh.hops(
                [(staged_l[off], off) for off in self._offsets], dim=1,
                group=self.group)))
            rings, acc, send_sums = self._push_passes(
                {key: u[key] for key in _RING_KEYS}, staged_r, interior)
            u.update(rings)
            # --- accept hop: one reverse hop per offset -------------------
            backs = mesh.hops([(acc[off], -off) for off in self._offsets],
                              dim=1, group=self.group)
            for off, back in zip(self._offsets, backs):
                att = staged_l[off][..., Lp + 2]
                send_sums = self._fold_bits((att << 1) | back, off,
                                            send_sums)
            self._fold_counters(u, carry, send_sums, kills)
        return self._close_window(u, active, drained_r, release=True)

    def _with_own(self, stage_mid, own, off):
        """The superstep's ``(R, B, W, bd, L+3)`` buffer of one offset: the
        staged windows, then this window's own."""
        if stage_mid is None:
            return own[off][:, :, None]
        return torch.cat([stage_mid[off], own[off][:, :, None]], dim=2)

    def _push_passes(self, rings, bufs, interior, *, want_sums: bool = True):
        """W ordered push passes over the rings (FIFO per ring).

        ``bufs`` holds one receiver-side ``(R, B, W, bd, L+3)`` buffer per
        offset, ``interior`` the rows' own send records.  Boundary rows
        push buffer window j in pass j; interior rows push their current
        message in the last pass.  Rings are single-writer, so the row
        sets are disjoint and the passes compose exactly.  Passes before
        the last have no interior senders, so they run compact: the union
        of boundary receiver rows (``eb`` a shard) is gathered into
        sub-rings, pushed and scattered back.  Returns ``(rings, acc,
        sums)``: the rings, per offset the ``(R, B, W, bd)`` int32 accept
        bits, and the last pass's per-process counter sums (``None``
        without ``want_sums``)."""
        B, W = self._blocks, self.superstep_windows
        reps = interior.shape[0]
        rings = dict(rings)
        acc = {off: [] for off in self._offsets}
        sums = None
        for j in range(W):
            last = j == W - 1
            if not last and not self._offsets:
                continue
            # full-width pass: interior rows send their own message and
            # boundary rows push buffer window W-1; compact pass: only the
            # boundary rows, gathered
            x = (interior if last else
                 interior.new_zeros((reps, B * self._eb,
                                     interior.shape[-1])))
            where = "rcv_row" if last else "rcv_pos"
            for off in self._offsets:
                # sentinel rows (the pads) land in a spare row, dropped
                x = _scatter_set(x, self._bnd[off][where],
                                 bufs[off][:, :, j].reshape(
                                     reps, -1, x.shape[-1]),
                                 x.shape[1])
            pay, avail, touch, act = self._unpack(x)
            if last:
                sp = self.core.send_edge(
                    rings, avail, act, torch.zeros_like(avail), touch, pay,
                    self._send["src_rows"], self._nl, want_sums=want_sums)
                rings.update(sp.rings)
                sums = sp.sums
            else:
                # index_select keeps the gathered rows contiguous, which
                # the kernels' replicate fold needs
                sub = {key: rings[key].index_select(1, self._rows_bnd_gather)
                       for key in _RING_KEYS}
                sp = self.core.send_edge(
                    sub, avail, act, torch.zeros_like(avail), touch, pay,
                    self._sub_src, 1, want_sums=False)
                # contiguous again (a copy when R > 1): the rings pass
                # through the kernels' replicate fold
                for key, val in sp.rings.items():
                    rings[key] = _scatter_set(rings[key], self._rows_bnd,
                                              val, rings[key].shape[1]
                                              ).contiguous()
            acc_pad = _pad1(sp.accepted)
            for off in self._offsets:
                acc[off].append(acc_pad[:, self._bnd[off][where]].reshape(
                    reps, B, self._bnd_bd[off]))
        acc = {off: torch.stack(v, dim=2).to(torch.int32)
               for off, v in acc.items()}
        return rings, acc, sums

    def _fold_bits(self, bits, off, sums):
        """Fold ``(att << 1) | accept`` bits ``(R, B, W, bd)`` of one
        offset into the senders' attempted / ok / dropped sums."""
        att = (bits >> 1) & 1
        okb = bits & 1
        cols = torch.stack([_i32_sum(att, 2), _i32_sum(att & okb, 2),
                            _i32_sum(att & (1 - okb), 2)], dim=-1)
        return sums + segment_sum(cols.reshape(bits.shape[0], -1, 3),
                                  self._bnd[off]["snd_src"], self._nl)

    def _final_window_pipelined(self, carry, stage_mid):
        """Superstep-boundary window of the ``pipelined`` scheduler.

        This boundary pushes the buffers that arrived during the superstep
        (staged at the previous boundary), folds the bits that returned
        for the previous boundary's pushes, then sends this superstep's
        staged buffers forward and this boundary's accept bits back, both
        consumed only at the next boundary.  Boundary messages arrive one
        superstep later than under ``superstep``; their stamps are the
        sender's, so the shift is honest added latency."""
        u, active, drained_r, pads = self._window_inputs(carry)
        if pads is not None:
            Lp = self.bapp.payload_len
            interior, own, kills = self._sends(batch_seed(carry), pads)
            # --- push the buffers staged at the PREVIOUS boundary ---------
            bufs = {off: u[f"fly_fwd_{off}"] for off in self._offsets}
            rings, acc, send_sums = self._push_passes(
                {key: u[key] for key in _RING_KEYS}, bufs, interior)
            u.update(rings)
            # --- fold the bits that returned for the previous pushes ------
            for off in self._offsets:
                send_sums = self._fold_bits(u[f"fly_acc_{off}"], off,
                                            send_sums)
            self._fold_counters(u, carry, send_sums, kills)
            # --- dispatch the next hops, consumed at the NEXT boundary ----
            pairs = []
            for off in self._offsets:
                att_r = bufs[off][..., Lp + 2]
                pairs += [(self._with_own(stage_mid, own, off), off),
                          ((att_r << 1) | acc[off], -off)]
            moved = mesh.hops(pairs, dim=1, group=self.group)
            for k, off in enumerate(self._offsets):
                u[f"fly_fwd_{off}"] = moved[2 * k]
                u[f"fly_acc_{off}"] = moved[2 * k + 1]
        return self._close_window(u, active, drained_r, release=True)

    def _flush(self, u):
        """Epilogue flush of the pipeline's in-flight state: fold the
        carried accept bits, deliver the carried buffers, and fold the bits
        those pushes produce.  Every step is gated on att bits, so what the
        supersteps after the last update already processed is a no-op; the
        flush closes the books when the run ends with an exchange still in
        flight."""
        Lp, rows, dev = self.bapp.payload_len, self._blocks * self._ein, \
            self.device
        reps = u["t"].shape[0]
        u = dict(u)
        send_sums = torch.zeros((reps, self._nl, 3), dtype=torch.int32,
                                device=dev)
        for off in self._offsets:
            send_sums = self._fold_bits(u[f"fly_acc_{off}"], off, send_sums)
        bufs = {off: u[f"fly_fwd_{off}"] for off in self._offsets}
        rings, acc, _ = self._push_passes(
            {key: u[key] for key in _RING_KEYS}, bufs,
            torch.zeros((reps, rows, Lp + 3), dtype=torch.int32,
                        device=dev),
            want_sums=False)
        u.update(rings)
        backs = mesh.hops([((bufs[off][..., Lp + 2] << 1) | acc[off], -off)
                           for off in self._offsets], dim=1, group=self.group)
        for off, back in zip(self._offsets, backs):
            send_sums = self._fold_bits(back, off, send_sums)
            u[f"fly_fwd_{off}"] = torch.zeros_like(u[f"fly_fwd_{off}"])
            u[f"fly_acc_{off}"] = torch.zeros_like(u[f"fly_acc_{off}"])
        u.update(c_att=u["c_att"] + send_sums[..., 0],
                 c_ok=u["c_ok"] + send_sums[..., 1],
                 c_drop=u["c_drop"] + send_sums[..., 2])
        return u

    # ------------------------------------------------------------------
    def _superstep(self, carry):
        """W-1 shard-local windows, then the boundary window."""
        stage = []
        for _ in range(self.superstep_windows - 1):
            carry, staged = self._local_window(carry)
            stage.append(staged)
        stage_mid = None
        if stage and stage[0]:
            stage_mid = {off: torch.stack([s[off] for s in stage], dim=2)
                         for off in self._offsets}
        if self.scheduler == "pipelined":
            return self._final_window_pipelined(carry, stage_mid)
        return self._final_window(carry, stage_mid)

    def _run_chunk(self, carry):
        """One chunk: ``_supersteps_per_call`` whole supersteps."""
        for _ in range(self._supersteps_per_call):
            carry = self._superstep(carry)
        return carry

    def run_batch(self, seeds):
        """Run one replicate per seed, all in one chunk loop of whole
        supersteps; returns ``(carry, windows)``, the carry batched and in
        canonical process order.  The windows after a replicate has
        stopped leave the state its result is assembled from unchanged
        (pipelined buffers still in flight deliver each message once, then
        or in the flush)."""
        carry = self._own_block(
            self._to_sharded_layout(self._init_batch(seeds)))
        carry, windows, needed = self._chunks(carry)
        if (self.scheduler == "pipelined" and
                self.cfg.mode != AsyncMode.NO_COMM):
            carry = self._flush(carry)
        self.windows.extend([windows] * len(seeds))
        self.windows_needed.extend(needed)
        return self._to_canonical_layout(self._gathered(carry)), windows
