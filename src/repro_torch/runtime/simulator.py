"""Discrete-event best-effort runtime: virtual processes, real compute.

Executes an application's *actual* compute fragments (JAX/numpy) under a
virtual-time model of per-step jitter, link latency, bounded send buffers,
barrier costs, and fault injection — reproducing the paper's cluster
experiments (C1–C4, DESIGN.md §1) deterministically on a single host.

Event ordering: step completions are processed in global virtual-time order
(heap), so message availability is causally consistent.  Each simstep is
compute-phase → communication-phase, with received messages incorporated at
the *next* compute phase, matching the paper's model.

Scale: process state lives in flat numpy arrays and QoS counters are
accumulated incrementally inside the event loop (never recomputed by
scanning ducts), so the engine sustains 1024+ virtual processes.  The link
model is hierarchical (DESIGN.md §3): when the application's topology
carries a host assignment, intra-node hops use ``intra_node_latency`` while
inter-node hops pay ``base_latency``.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.modes import AsyncMode
from repro_torch.core.qos import Counters, QosReport, report
from repro_torch.runtime.channels import Duct
from repro_torch.runtime.faults import (
    STREAM_FLAP,
    STREAM_LOSS,
    FaultModel,
    Jitter,
    np_hash_uniform,
)

_BARRIER_MODES = (AsyncMode.BARRIER_EVERY_STEP, AsyncMode.ROLLING_BARRIER,
                  AsyncMode.FIXED_BARRIER)


@dataclasses.dataclass(frozen=True)
class SimConfig:
    mode: AsyncMode = AsyncMode.BEST_EFFORT
    duration: float = 1.0              # virtual seconds
    base_compute: float = 15e-6        # mean compute seconds per update
    work_units: int = 0                # added compute work (paper §III-C)
    work_unit_cost: float = 35e-9
    per_message_cost: float = 0.1e-6   # receiver-side handling per message
    per_pull_cost: float = 0.3e-6      # per pull attempt (bulk drain)
    jitter_sigma: float = 0.15
    stall_prob: float = 0.01           # occasional OS/cache stall
    stall_factor: float = 8.0
    base_latency: float = 500e-6       # internode one-way latency
    intra_node_latency: Optional[float] = None  # same-host hops (None: flat)
    latency_sigma: float = 0.5
    buffer_capacity: int = 64
    barrier_base: float = 2e-5
    barrier_per_log2: float = 1.5e-5   # sync cost grows with CPU count
    # barrier quarantine (DESIGN.md §14): > 0 releases a barrier without
    # processes whose next arrival lags the cohort front by more than this
    # many virtual seconds (a crashed process's next arrival is +inf, so any
    # finite timeout excludes it); quarantined processes rejoin after
    # catching up to within timeout/2 (hysteresis).  0 = plain barrier.
    barrier_timeout: float = 0.0
    rolling_quantum: float = 0.01      # mode 1 work chunk (10 ms, paper)
    fixed_interval: float = 0.25       # mode 2 sync timepoints
    snapshot_interval: float = 0.2     # QoS snapshot spacing
    snapshot_warmup: float = 0.2
    seed: int = 0
    # --- open-loop service arrivals (runtime/service.py) ----------------
    # rate > 0 switches the run into the live-service posture: a
    # deterministic splitmix-hashed arrival stream feeds each process's
    # work queue, and every update serves up to service_chunk queued items
    # at per_item_cost compute seconds each.  The stream is precomputed
    # per (seed, pid, time bin) so every engine injects identical load.
    arrival_rate: float = 0.0          # mean arrivals /process /vsecond
    arrival_shape: str = "poisson"     # poisson | bursty | diurnal
    arrival_bin: float = 1e-3          # arrival-draw bin width (vseconds)
    arrival_burst_prob: float = 0.05   # bursty: per-bin global surge odds
    arrival_burst_factor: float = 8.0  # bursty: surge rate multiplier
    arrival_period: float = 0.02       # diurnal: sinusoid period
    service_chunk: int = 4             # max queue items served per update
    per_item_cost: float = 2e-6        # compute seconds per served item
    # export final app state into SimResult.app_state (when the app
    # implements export_state).  Off by default: the snapshot copies the
    # whole population's state per replicate, which batch sweeps never
    # read; runtime/service.py turns it on to carry survivors' state
    # across epoch boundaries.
    carry_app_state: bool = False


@dataclasses.dataclass
class SimResult:
    updates: List[int]
    horizon: float
    quality: float
    qos: List[QosReport]               # one per (process, window)
    qos_by_process: Dict[int, List[QosReport]]
    dropped: int
    sent: int
    #: drop attribution (DESIGN.md §14): ``dropped`` is the total across all
    #: causes; these two split out lossy/flapping-link drops and sends toward
    #: a crashed destination.  Capacity drops (full duct) are the remainder.
    dropped_loss: int = 0
    dropped_dead: int = 0
    #: live-service queue accounting (``cfg.arrival_rate > 0`` only):
    #: {"arrivals": [...], "served": [...], "backlog": [...]} per process
    service: Optional[dict] = None
    #: final app state, {pid: state} — populated when the app exposes
    #: ``export_state``; lets runtime/service.py carry survivors' state
    #: across epoch boundaries instead of re-initializing every epoch
    app_state: Optional[dict] = None

    @property
    def update_rate_per_cpu(self) -> float:
        return sum(self.updates) / len(self.updates) / self.horizon

    @property
    def delivery_failure_rate(self) -> float:
        return self.dropped / max(self.sent, 1)


class Simulator:
    """Generic engine; the application provides fragments + topology.

    ``app.topology()`` may return either a plain ``{pid: [neighbors]}`` dict
    or a :class:`repro_torch.runtime.topologies.Topology`; the latter enables the
    hierarchical link model and host-level fault injection.

    Implements the :class:`repro_torch.runtime.engine.Engine` protocol (the
    reference event-ordered backend; ``runtime/engine_jax.py`` is the
    vectorized one).
    """

    name = "event"

    def __init__(self, app, cfg: SimConfig, faults: Optional[FaultModel] = None):
        self.app = app
        self.cfg = cfg
        self.faults = faults or FaultModel()
        self.n = n = app.n_processes
        topo = app.topology()
        if hasattr(topo, "as_dict"):          # Topology object
            self.topo = topo
            self.topology: Dict[int, List[int]] = topo.as_dict()
        else:
            self.topo = None
            self.topology = topo
        self.fragments = app.make_fragments()
        self.jitter = Jitter(cfg.jitter_sigma, cfg.seed,
                             cfg.stall_prob, cfg.stall_factor)
        self.lat_jitter = Jitter(cfg.latency_sigma, cfg.seed)

        # --- array-backed process state: flat per-pid arrays, no objects ---
        # (plain lists: python-int increments beat numpy scalar boxing on the
        # hot path; bulk math converts to numpy at aggregation time)
        self._clock = [0.0] * n
        self._steps = [0] * n
        self._done = [False] * n
        self._last_release = [0.0] * n
        self._barrier_seq = [0] * n
        self._pending = [0.0] * n      # message-handling cost of last step
        self._deg = [len(self.topology[pid]) for pid in range(n)]
        self._cfactor = [self.faults.compute_factor(pid) for pid in range(n)]
        # incremental per-process QoS counters (DESIGN.md §5): maintained in
        # the event loop so snapshots are O(1), never an O(degree) duct scan.
        # pull_attempt_count is exactly steps*degree (one bulk drain of every
        # in-duct per update), so it is derived, not stored.
        self._c_touch = [0] * n
        self._c_att = [0] * n
        self._c_ok = [0] * n
        self._c_drop = [0] * n
        self._c_laden = [0] * n
        self._c_msgs = [0] * n
        # drop-attribution counters (DESIGN.md §14): c_drop stays the TOTAL
        # (capacity + loss + dead), these split out the non-capacity causes
        self._c_loss = [0] * n
        self._c_dead = [0] * n
        self._crashed = [self.faults.is_crashed(pid) for pid in range(n)]

        self._touch: List[Dict[int, int]] = [
            {nb: 0 for nb in self.topology[pid]} for pid in range(n)]
        self.ducts: Dict[Tuple[int, int], Duct] = {}
        # per-out-edge fault info, hoisted so the send loop sees one tuple:
        # (duct, canonical eid, loss prob f32, flap frac f32, dst crashed)
        self._out_info: List[Dict[int, tuple]] = [{} for _ in range(n)]
        self._fault_sends = False
        duct_id = 0
        for src in range(n):
            for dst in self.topology[src]:
                duct = Duct(
                    cfg.buffer_capacity, self._latency_fn(src, dst, duct_id),
                    name=f"{src}->{dst}")
                self.ducts[(src, dst)] = duct
                loss = np.float32(self.faults.loss_prob(src, dst))
                flap = np.float32(self.faults.flap_frac(src, dst))
                dead = self._crashed[dst]
                self._out_info[src][dst] = (duct, duct_id, loss, flap, dead)
                if loss > 0 or flap > 0 or dead:
                    self._fault_sends = True
                duct_id += 1
        # pid -> [(neighbor, incoming duct)] in neighbor order, hoisted out
        # of the hot loop so events never hash (src, dst) tuples
        self._in_ducts = [[(nb, self.ducts[(nb, pid)])
                           for nb in self.topology[pid]] for pid in range(n)]
        self._snapshots: Dict[int, List[Tuple[float, Counters]]] = {
            i: [] for i in range(n)}
        self._barrier_arrivals: Dict[int, List[Tuple[int, float]]] = {}
        self._seq_active: Dict[int, int] = {0: n}  # barrier_seq -> live procs
        # barrier-quarantine state (cfg.barrier_timeout > 0, DESIGN.md §14):
        # next scheduled arrival per process (+inf for crashed — they never
        # arrive), the global waiting set, and the sticky quarantine flags
        self._arr_t = [math.inf if self._crashed[pid]
                       else self._step_duration(pid, 0) for pid in range(n)]
        self._waiting: Dict[int, float] = {}
        self._quar = [False] * n

    # ------------------------------------------------------------------
    def _link_base(self, src: int, dst: int) -> float:
        """Hierarchical link model: same-host hops are cheap (DESIGN.md §3)."""
        cfg = self.cfg
        if (cfg.intra_node_latency is not None and self.topo is not None
                and self.topo.same_node(src, dst)):
            return cfg.intra_node_latency
        return cfg.base_latency

    def _latency_fn(self, src, dst, duct_id: int):
        # fault and hierarchy factors are constant per link: hoist them so a
        # send costs one cached jitter lookup, not two dict probes
        base = self._link_base(src, dst) * self.faults.link_factor(src, dst)
        jitter = self.lat_jitter
        count = [0]

        def fn(now):
            c = count[0]
            count[0] = c + 1
            return base * jitter.latency_factor(duct_id, c)
        return fn

    def _step_duration(self, pid: int, step: int) -> float:
        cfg = self.cfg
        base = cfg.base_compute + cfg.work_units * cfg.work_unit_cost
        return base * self.jitter.factor(pid, step) * self._cfactor[pid]

    def _barrier_cost(self) -> float:
        if self.n <= 1:
            return 0.0  # a lone process has nothing to synchronize with
        return self.cfg.barrier_base + self.cfg.barrier_per_log2 * math.log2(self.n)

    # ------------------------------------------------------------------
    def _proc_counters(self, pid: int, t: Optional[float] = None) -> Counters:
        """Snapshot of a process's accumulated counters (O(1))."""
        return Counters(
            update_count=self._steps[pid],
            touch_count=self._c_touch[pid],
            attempted_send_count=self._c_att[pid],
            successful_send_count=self._c_ok[pid],
            dropped_send_count=self._c_drop[pid],
            loss_dropped_send_count=self._c_loss[pid],
            dead_dropped_send_count=self._c_dead[pid],
            laden_pull_count=self._c_laden[pid],
            message_count=self._c_msgs[pid],
            pull_attempt_count=(self._steps[pid] * self._deg[pid]
                                if self.cfg.mode != AsyncMode.NO_COMM else 0),
            wall_time=self._clock[pid] if t is None else t,
        )

    # ------------------------------------------------------------------
    def _barrier_due(self, pid: int, t: float) -> bool:
        mode = self.cfg.mode
        if mode == AsyncMode.BARRIER_EVERY_STEP:
            return True
        if mode == AsyncMode.ROLLING_BARRIER:
            return (t - self._last_release[pid]) >= self.cfg.rolling_quantum
        if mode == AsyncMode.FIXED_BARRIER:
            return t >= (self._barrier_seq[pid] + 1) * self.cfg.fixed_interval
        return False

    # ------------------------------------------------------------------
    def run(self) -> SimResult:
        cfg = self.cfg
        n = self.n
        comm = cfg.mode != AsyncMode.NO_COMM
        barriered = cfg.mode in _BARRIER_MODES
        # mode 1 meters its quantum on the WORK clock (compute + halo
        # pulls): per-message handling rides in the barrier slack, so the
        # update schedule is a function of (seed, release times) alone —
        # see window_core.close_window for the invariance argument
        rolling = cfg.mode == AsyncMode.ROLLING_BARRIER
        duration = cfg.duration
        per_msg_cost = cfg.per_message_cost
        per_pull_cost = cfg.per_pull_cost
        warmup = cfg.snapshot_warmup
        interval = cfg.snapshot_interval

        clock = self._clock
        steps = self._steps
        done = self._done
        c_touch, c_att, c_ok = self._c_touch, self._c_att, self._c_ok
        c_drop, c_laden, c_msgs = self._c_drop, self._c_laden, self._c_msgs
        touch = self._touch
        in_ducts = self._in_ducts
        ducts = self.ducts
        fragments = self.fragments
        snapshots = self._snapshots
        next_snap = [warmup] * n
        base_compute = cfg.base_compute + cfg.work_units * cfg.work_unit_cost
        cfactor = self._cfactor
        jitter_factor = self.jitter.factor
        pull_costs = [d * per_pull_cost for d in self._deg]
        heappush, heappop = heapq.heappush, heapq.heappop

        # --- open-loop service arrivals (runtime/service.py) --------------
        # the cumulative arrival table is a pure function of (cfg, seed,
        # pid, bin), precomputed host-side; the vectorized engines carry
        # the identical table, so every backend injects the same load
        arr_rows = None
        if cfg.arrival_rate > 0:
            from repro_torch.runtime.service import cum_arrivals
            arr_np = cum_arrivals(cfg, cfg.seed, n)
            arr_rows = arr_np.tolist()
            arr_bins = arr_np.shape[1] - 1
            arr_bin = cfg.arrival_bin
            serve_chunk = cfg.service_chunk
            item_cost = cfg.per_item_cost
            served = [0] * n

        # crashed processes are never scheduled: they do no compute and take
        # no snapshots, but the topology keeps their in-ducts alive so
        # neighbors' sends surface as dead-destination delivery failures
        heap: List[Tuple[float, int, int]] = [
            (self._step_duration(pid, 0), pid, pid) for pid in range(n)
            if not self._crashed[pid]]
        heapq.heapify(heap)
        seq = n

        fault_sends = self._fault_sends
        out_info = self._out_info
        c_loss, c_dead = self._c_loss, self._c_dead
        quarantined = barriered and cfg.barrier_timeout > 0
        seed = cfg.seed
        flap_period = np.float32(self.faults.flap_period)

        while heap:
            t, _, pid = heappop(heap)
            if done[pid]:
                continue
            clock[pid] = t
            ptouch = touch[pid]

            # --- communication phase: bulk-drain inboxes -------------------
            # inbox holds fresh payloads only; fragments treat missing
            # neighbors as "no news" (stale halo)
            inbox = {}
            n_msgs = 0
            if comm:
                n_laden = 0
                for nb, duct in in_ducts[pid]:
                    msg, drained = duct.latest(t)
                    if drained:
                        n_msgs += drained
                        n_laden += 1
                        new_touch = 1 + msg.touch
                        c_touch[pid] += new_touch - ptouch[nb]
                        ptouch[nb] = new_touch
                        inbox[nb] = msg.payload
                if n_msgs:
                    c_msgs[pid] += n_msgs
                    c_laden[pid] += n_laden

            # --- compute phase (the real application fragment) -------------
            outputs = fragments[pid].update(inbox)
            step = steps[pid] + 1
            steps[pid] = step

            if comm and outputs:
                n_ok = 0
                n_drop = 0
                if fault_sends:
                    # typed-fault send path: the decision order (dead, then
                    # flap, then loss, then capacity) and the draw keys
                    # mirror window_core's vectorized masks bit-for-bit
                    n_loss = 0
                    n_dead = 0
                    info = out_info[pid]
                    for nb, payload in outputs.items():
                        duct, eid, loss_p, flap_f, is_dead = info[nb]
                        if is_dead:
                            n_dead += 1
                            continue
                        if flap_f > 0:
                            bucket = int(np.float32(t) / flap_period)
                            if np_hash_uniform(seed, STREAM_FLAP, eid,
                                               bucket) < flap_f:
                                n_loss += 1
                                continue
                        if loss_p > 0 and np_hash_uniform(
                                seed, STREAM_LOSS, eid, step) < loss_p:
                            n_loss += 1
                            continue
                        if duct.try_send(payload, t, ptouch[nb]):
                            n_ok += 1
                        else:
                            n_drop += 1
                    c_loss[pid] += n_loss
                    c_dead[pid] += n_dead
                    n_drop += n_loss + n_dead
                else:
                    for nb, payload in outputs.items():
                        if ducts[(pid, nb)].try_send(payload, t, ptouch[nb]):
                            n_ok += 1
                        else:
                            n_drop += 1  # counted at the drop site, not derived
                c_att[pid] += len(outputs)
                c_ok[pid] += n_ok
                c_drop[pid] += n_drop

            pending = (pull_costs[pid] if rolling
                       else n_msgs * per_msg_cost + pull_costs[pid])

            if t >= next_snap[pid]:
                snaps = snapshots[pid]
                snaps.append((t, self._proc_counters(pid, t)))
                next_snap[pid] = warmup + len(snaps) * interval

            # --- termination ------------------------------------------------
            if t >= duration:
                done[pid] = True
                if not quarantined:
                    # cohort ledger only feeds _try_release_barriers; the
                    # quarantine gate scans arrival times directly and its
                    # releases never book processes into new sequences here
                    self._seq_active[self._barrier_seq[pid]] -= 1
                # release any barrier this process would have joined (a
                # finishing process can also unblock a quarantine gate it
                # was holding open mid-step)
                seq = (self._try_release_quarantine(heap, seq) if quarantined
                       else self._try_release_barriers(heap, seq))
                continue

            # --- serve queued arrivals (continuing processes only) ----------
            # arrivals of bin b are queued once b has fully elapsed on the
            # process's own clock; each update serves up to service_chunk
            # items, whose cost rides on the work clock with the compute —
            # same recurrence as window_core.close_window, so the update
            # schedule stays engine-, layout-, and W-invariant
            if arr_rows is not None:
                b = int(t / arr_bin)
                if b > arr_bins:
                    b = arr_bins
                backlog = arr_rows[pid][b] - served[pid]
                if backlog > 0:
                    k = backlog if backlog < serve_chunk else serve_chunk
                    served[pid] += k
                    pending += k * item_cost

            # --- scheduling / barriers --------------------------------------
            if barriered and self._barrier_due(pid, t):
                self._pending[pid] = pending
                if quarantined:
                    self._waiting[pid] = t
                    seq = self._try_release_quarantine(heap, seq)
                else:
                    b = self._barrier_seq[pid]
                    self._barrier_arrivals.setdefault(b, []).append((pid, t))
                    seq = self._try_release_barriers(heap, seq)
            else:
                d = base_compute * jitter_factor(pid, step) * cfactor[pid]
                nt = t + d + pending
                self._arr_t[pid] = nt
                heappush(heap, (nt, seq, pid))
                seq += 1
                # a reschedule can push this process's next arrival past the
                # quarantine limit — re-evaluate the gate it was holding open
                if quarantined and self._waiting:
                    seq = self._try_release_quarantine(heap, seq)

        updates = list(steps)
        qos_by_proc: Dict[int, List[QosReport]] = {}
        all_qos: List[QosReport] = []
        for pid, snaps in self._snapshots.items():
            reps = [report(c0, c1)
                    for (t0, c0), (t1, c1) in zip(snaps, snaps[1:])]
            qos_by_proc[pid] = reps
            all_qos.extend(reps)

        service = None
        if arr_rows is not None:
            totals = [int(row[-1]) for row in arr_rows]
            service = {
                "arrivals": totals,
                "served": [int(s) for s in served],
                "backlog": [int(a - s) for a, s in zip(totals, served)],
            }

        sent = sum(self._c_att)
        return SimResult(
            updates=updates,
            horizon=cfg.duration,
            quality=self.app.quality(self.fragments),
            qos=all_qos,
            qos_by_process=qos_by_proc,
            dropped=sum(self._c_drop),
            sent=sent,
            dropped_loss=sum(self._c_loss),
            dropped_dead=sum(self._c_dead),
            service=service,
            app_state=(self.app.export_state(self.fragments)
                       if cfg.carry_app_state
                       and hasattr(self.app, "export_state") else None),
        )

    # ------------------------------------------------------------------
    def _try_release_quarantine(self, heap, seq) -> int:
        """Barrier release under ``cfg.barrier_timeout`` (DESIGN.md §14).

        The cohort front is the latest arrival among non-quarantined
        waiting processes.  The barrier releases once every process is
        done, waiting, quarantined, or *unreachable*: its next scheduled
        arrival lags the front by more than the timeout.  A crashed
        process's next arrival is +inf, so any finite timeout excludes it
        — turning a crashed clique member from a full-swarm stall into a
        QoS-visible degradation.  Quarantined processes still release
        with the cohort when they do arrive (they ride along), but are
        excluded from the front until they catch up to within timeout/2
        (hysteresis, so a marginal straggler doesn't flap in and out).

        ``window_core.close_window`` implements the same rule with the
        same arithmetic for the vectorized engines.
        """
        tau = self.cfg.barrier_timeout
        done = self._done
        waiting = self._waiting
        if not waiting:
            return seq
        quar = self._quar
        arr_t = self._arr_t
        core = [t for p, t in waiting.items() if not quar[p]]
        ref = max(core) if core else max(waiting.values())
        limit = ref + tau
        for p in range(self.n):
            if done[p] or quar[p] or p in waiting:
                continue
            if arr_t[p] <= limit:
                return seq          # someone within reach: hold the barrier
        # quarantine bookkeeping (before the release moves anyone): skipped
        # processes enter quarantine; waiting quarantined processes that
        # caught up to within tau/2 of the front are re-admitted
        readmit = ref - tau / 2
        for p in range(self.n):
            if done[p]:
                continue
            if p in waiting:
                if quar[p] and waiting[p] >= readmit:
                    quar[p] = False
            elif arr_t[p] > limit:
                quar[p] = True
        release = ref + self._barrier_cost()
        members = sorted(waiting)
        if release >= self.cfg.duration:
            for p in members:
                self._barrier_seq[p] += 1
                self._last_release[p] = release
                self._clock[p] = self.cfg.duration
                self._done[p] = True
        else:
            for p in members:
                self._barrier_seq[p] += 1
                self._last_release[p] = release
                d = (self._step_duration(p, self._steps[p])
                     + self._pending[p])
                nt = release + d
                arr_t[p] = nt
                heapq.heappush(heap, (nt, seq, p))
                seq += 1
        waiting.clear()
        return seq

    # ------------------------------------------------------------------
    def _try_release_barriers(self, heap, seq) -> int:
        """Release every barrier whose full active cohort has arrived.

        ``_seq_active`` tracks how many live processes sit at each barrier
        sequence number, so cohort checks are O(1) instead of an O(n) scan.
        """
        done = self._done
        for b in sorted(self._barrier_arrivals):
            arrivals = self._barrier_arrivals[b]
            waiting_active = [a for a in arrivals if not done[a[0]]]
            needed = self._seq_active.get(b, 0)
            if needed > 0 and len(waiting_active) >= needed:
                release = max(a[1] for a in arrivals) + self._barrier_cost()
                self._seq_active[b] -= len(waiting_active)
                if self._seq_active[b] <= 0:
                    del self._seq_active[b]
                if release >= self.cfg.duration:
                    # horizon snap (matches window_core.close_window): a
                    # cohort released at or past the horizon is done at the
                    # horizon clock — no post-horizon update is scheduled
                    for pid, t_arr in waiting_active:
                        self._barrier_seq[pid] = b + 1
                        self._last_release[pid] = release
                        self._clock[pid] = self.cfg.duration
                        self._done[pid] = True
                    del self._barrier_arrivals[b]
                    continue
                self._seq_active[b + 1] = (self._seq_active.get(b + 1, 0)
                                           + len(waiting_active))
                for pid, t_arr in waiting_active:
                    self._barrier_seq[pid] = b + 1
                    self._last_release[pid] = release
                    d = (self._step_duration(pid, self._steps[pid])
                         + self._pending[pid])
                    heapq.heappush(heap, (release + d, seq, pid))
                    seq += 1
                del self._barrier_arrivals[b]
        return seq
