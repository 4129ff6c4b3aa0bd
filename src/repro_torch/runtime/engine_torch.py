"""Vectorized windowed-time best-effort engine on torch tensors.

The PyTorch counterpart of the reference's ``JaxEngine``.  The discrete-
event engine (``runtime/simulator.py``) processes one event at a time;
this engine advances the *entire process population per lockstep window*
as tensors on one device: window k is every process's k-th simstep,
executed at per-process virtual times that drift apart exactly as the
paper describes.  Per window it composes the window-phase core
(``runtime/window_core.py``) on one of two duct layouts (``layout=``).
The bucketed dense receiver-major layout (``auto`` picks it on every
built-in topology):

  1. drain      one fused ``duct_window`` pass per degree bucket
  2. compute    the application's batched step
  3. stage      the eager send decision (capacity drop, latency stamp)
  4. close      QoS snapshots, termination, barriers, time advance

and the edge-major layout (``layout="edge"``), one ring per canonical
edge: ``duct_drain``, compute, ``duct_send``, close.  Both give the same
trajectories bitwise.

With ``scheduler="superstep"`` (dense only) W windows run against frozen
base rings and one ``duct_commit`` per superstep folds their pushes into
the rings; the trajectories are bitwise those of the per-window path.

A sweep of seeds runs as one batch, as the reference's ``jax.vmap``
dispatches it: every carry leaf has a leading replicate axis, the window
phases run once over all replicates, and each duct kernel launches once a
window whatever the number of seeds.  ``run_replicates_sequential`` runs
the seeds one batch of one after another, the oracle the batched run is
held to.

On ``device="cuda"`` (the default) the duct ops run as hand-written CUDA
kernels; on ``device="cpu"`` as their plain torch versions.  A run is a
pure function of ``(config, seed)`` and reproduces the JAX engine's
``SimResult`` bitwise at the same seed.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.modes import AsyncMode
from repro_torch.device import resolve_device
from repro_torch.interop import carry_to_numpy
from repro_torch.runtime.faults import FaultModel
from repro_torch.runtime.service import cum_arrivals
from repro_torch.runtime.simulator import SimConfig, SimResult
from repro_torch.runtime.topologies import (
    OPP_IDX,
    Topology,
    canonical_edges,
    halo_slot_map,
    plan_layout,
)
from repro_torch.runtime.window_core import (
    BARRIER_MODES,
    LOCAL_RELEASE,
    STREAM_LAT,
    WindowCore,
    batch_seed,
    lognormal_factor,
    make_dense_spec,
    segment_sum,
)


def _i32(x, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.int32), device=dev)


def _i64(x, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.int64), device=dev)


def stack_carries(carries: Sequence[Dict]) -> Dict:
    """One carry per replicate -> the batch: every leaf stacked along a
    new leading replicate axis, as ``jax.vmap`` takes them."""
    first = carries[0]
    return {k: (stack_carries([c[k] for c in carries])
                if isinstance(first[k], dict)
                else torch.stack([c[k] for c in carries]))
            for k in first}


class TorchEngine:
    """Windowed-time engine over torch tensors; ``Engine`` protocol member.

    Requires an application with an injected
    :class:`~repro_torch.runtime.topologies.Topology` and a ``batched()``
    entry point whose step runs the real fragment compute over the whole
    population.
    """

    name = "torch"

    def __init__(self, app, cfg: SimConfig,
                 faults: Optional[FaultModel] = None,
                 *, max_pops: int = 16, chunk: int = 256,
                 layout: str = "auto", scheduler: str = "window",
                 superstep_windows: int = 1, device="cuda"):
        self.device = dev = resolve_device(device)
        self.app = app
        self.cfg = cfg
        self.faults = faults or FaultModel()
        self.max_pops = max_pops
        self.chunk = chunk
        self.scheduler = scheduler
        self.superstep_windows = int(superstep_windows)
        topo = getattr(app, "injected", None)
        if not isinstance(topo, Topology):
            raise ValueError(
                "TorchEngine needs an app built with an injected "
                "runtime.topologies.Topology (experiments always inject one)")
        self.topo = topo
        self.n = n = app.n_processes
        self.bapp = app.batched(dev)
        self.core = WindowCore(cfg, self.bapp, n, max_pops=max_pops)

        # --- static edge plumbing (numpy, built once) ---------------------
        esrc, edst, index = canonical_edges(topo)
        slot_maps = [halo_slot_map(topo.neighbors[p]) for p in range(n)]
        slot = [slot_maps[d][s] for s, d in zip(esrc, edst)]
        self.E = E = len(esrc)
        self._esrc = _i64(esrc, dev)
        self._edst = _i64(edst, dev)
        # flattened (dst, slot) key: several in-edges may share one halo
        # slot; delivery ties go to the highest edge index (segment max)
        self._halo_key = _i64([d * 4 + s for d, s in zip(edst, slot)], dev)
        self._out_slot = _i64([OPP_IDX[s] for s in slot], dev)
        self._rev = _i64([index[(d, s)] for s, d in zip(esrc, edst)], dev)
        self._eids = torch.arange(E, dtype=torch.int32, device=dev)
        self._pids = torch.arange(n, dtype=torch.int32, device=dev)
        lat = np.empty(E, np.float32)
        loss = np.empty(E, np.float32)
        flap = np.empty(E, np.float32)
        dead = np.empty(E, bool)
        for e, (s, d) in enumerate(zip(esrc, edst)):
            base = cfg.base_latency
            if cfg.intra_node_latency is not None and topo.same_node(s, d):
                base = cfg.intra_node_latency
            lat[e] = base * self.faults.link_factor(s, d)
            loss[e] = self.faults.loss_prob(s, d)
            flap[e] = self.faults.flap_frac(s, d)
            dead[e] = self.faults.is_crashed(d)
        # typed faults: per-edge loss/flap probabilities and dead-destination
        # flags, plus the crashed-process mask, all static per run
        crashed_np = np.asarray(
            [self.faults.is_crashed(p) for p in range(n)], bool)
        self._has_faults = bool(loss.any() or flap.any() or dead.any())
        self._any_crashed = bool(crashed_np.any())
        self._crashed = torch.as_tensor(crashed_np, device=dev)
        #: what the done probe counts as stopped besides done: the crashed
        #: processes, in the carry's process order
        self._crashed_probe = self._crashed
        #: where the done probe reduces over the processes (the sharded
        #: engine over ranks all-reduces it, so every rank runs as many
        #: chunks)
        self._stop_release = LOCAL_RELEASE
        self._deg = _i32([topo.degree(p) for p in range(n)], dev)
        self._cfactor = torch.as_tensor(np.asarray(
            [self.faults.compute_factor(p) for p in range(n)], np.float32),
            device=dev)
        self._lat_base = torch.as_tensor(lat, device=dev)
        if self._has_faults:
            self._loss = torch.as_tensor(loss, device=dev)
            self._flap = torch.as_tensor(flap, device=dev)
            self._dead = torch.as_tensor(dead, device=dev)

        # --- duct layout: bucketed dense receiver-major, or edge-major ----
        lp = plan_layout(topo, layout)
        self.layout = lp.kind
        if scheduler not in ("window", "superstep"):
            raise ValueError(f"the torch engine has no {scheduler!r} "
                             "scheduler (offers: window, superstep)")
        if self.layout == "dense":
            self._init_dense(lp, lat, loss, flap, dead)
        elif scheduler == "superstep":
            raise ValueError("scheduler='superstep' needs the dense layout "
                             "(pass layout='auto' or 'dense')")
        self.S = self.core.S
        self._max_windows = self.core.default_max_windows
        #: lockstep windows each replicate run by this engine executed, in
        #: order: a batch's replicates all execute the batch's windows
        self.windows: List[int] = []
        #: per replicate, the windows after which the done probe first
        #: found it stopped; the windows it executed past that count were
        #: state-invariant (every process inactive)
        self.windows_needed: List[int] = []
        if scheduler == "superstep":
            W = self.superstep_windows
            self._windows_per_call = max(1, self.chunk // W) * W
        else:
            self._windows_per_call = self.chunk

    def _init_dense(self, lp, lat, loss, flap, dead):
        """Row tables of the bucketed dense layout and the superstep
        scheduler's checks."""
        cfg, n, dev = self.cfg, self.n, self.device

        self._spec = make_dense_spec(lp, dev)
        self.R = R = int(lp.n_rows)
        # flat (R,) row tables; dead padding rows carry sentinel
        # src == n / eid == E and live == False
        j = np.arange(R) - lp.row_start[lp.dst]
        self._d_src = _i64(lp.src, dev)
        self._d_dst = _i64(lp.dst, dev)
        self._d_rev = _i64(lp.rev, dev)
        self._d_eid = _i32(lp.eid, dev)
        self._d_live = torch.as_tensor(lp.live, device=dev)
        # row j of a receiver block feeds halo slot j % 4, so the sender
        # writes the opposite slot
        self._d_out_slot = _i64(np.asarray(OPP_IDX, np.int64)[j % 4], dev)
        self._d_src_c = self._d_src.clamp(0, n - 1)

        def per_row(x, fill):
            return np.concatenate([x, np.full(1, fill, x.dtype)])[lp.eid]

        self._d_lat = torch.as_tensor(per_row(lat, 0), device=dev)
        if self._has_faults:
            self._d_loss = torch.as_tensor(per_row(loss, 0), device=dev)
            self._d_flap = torch.as_tensor(per_row(flap, 0), device=dev)
            self._d_dead = torch.as_tensor(per_row(dead, False), device=dev)
        if self.scheduler == "superstep":
            w = self.superstep_windows
            if w < 2:
                raise ValueError(
                    "scheduler='superstep' fuses superstep_windows >= 2 "
                    f"windows per commit (got {w})")
            if w > cfg.buffer_capacity:
                raise ValueError(
                    f"superstep_windows={w} must not exceed "
                    f"buffer_capacity={cfg.buffer_capacity}: the compact "
                    "pushbuf commits at most one slot per window into the "
                    "ring tail")

    # ------------------------------------------------------------------
    def _step_factor(self, seed, steps):
        return self.core.step_factor(seed, steps, self._pids, self._cfactor)

    def _edge_state(self) -> Dict[str, torch.Tensor]:
        """Fresh (empty-ring) duct state for the layout and scheduler."""
        if self.layout == "edge":
            return self.core.edge_rings(self.E, self.device)
        if self.scheduler == "superstep":
            return self.core.superstep_rings(self.R, self.superstep_windows,
                                             self.device)
        return self.core.dense_rings(self.R, self.device)

    def _init_batch(self, seeds: Sequence[int]) -> Dict[str, torch.Tensor]:
        """The batched carry of ``seeds``: one replicate's initial carry
        per seed, stacked."""
        return stack_carries([self._init_carry(int(s)) for s in seeds])

    def _init_carry(self, seed: int) -> Dict[str, torch.Tensor]:
        """One replicate's initial carry (no replicate axis)."""
        n, dev = self.n, self.device
        seed_t = torch.tensor(seed, dtype=torch.int32, device=dev)
        t0 = float(self.core.base_total) * self._step_factor(
            seed_t, torch.zeros(n, dtype=torch.int32, device=dev))
        state, halo = self.bapp.init(seed)
        extra: Dict[str, torch.Tensor] = {}
        if self._any_crashed:
            # a crashed process's clock IS its next barrier arrival: +inf
            # keeps it out of every snapshot/release
            t0 = torch.where(self._crashed, torch.inf, t0)
        if self._has_faults:
            extra["c_loss"] = torch.zeros(n, dtype=torch.int32, device=dev)
            extra["c_dead"] = torch.zeros(n, dtype=torch.int32, device=dev)
        if self.cfg.barrier_timeout > 0 and self.cfg.mode in BARRIER_MODES:
            extra["quar"] = torch.zeros(n, dtype=torch.bool, device=dev)
        if self.cfg.arrival_rate > 0:
            # open-loop service arrivals: the cumulative per-(pid, bin)
            # arrival table is built on the host once per replicate (a pure
            # function of (cfg, seed)) and carried, rows keyed by pid, so
            # close_window's serve hook reads the stream every engine
            # injects
            extra["arr_cum"] = torch.as_tensor(
                cum_arrivals(self.cfg, seed, n), device=dev)
            extra["served"] = torch.zeros(n, dtype=torch.int32, device=dev)

        def zeros(dtype, shape=(n,)):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return dict(
            **extra,
            seed=seed_t,
            k=torch.tensor(0, dtype=torch.int32, device=dev),
            t=t0,
            steps=zeros(torch.int32),
            done=zeros(torch.bool),
            waiting=zeros(torch.bool),
            barrier_seq=zeros(torch.int32),
            last_release=zeros(torch.float32),
            pending=zeros(torch.float32),
            c_touch=zeros(torch.int32),
            c_att=zeros(torch.int32),
            c_ok=zeros(torch.int32),
            c_drop=zeros(torch.int32),
            c_laden=zeros(torch.int32),
            c_msgs=zeros(torch.int32),
            **self._edge_state(),
            halo=halo,
            app=state,
            snap=zeros(torch.float32, (n, self.S, 8)),
            snap_idx=zeros(torch.int32),
        )

    # ------------------------------------------------------------------
    def _window_body(self, carry):
        """One lockstep window on the edge-major layout: the core's drain
        -> compute -> send phases over the full-population edge tables of
        every replicate; returns the new carry."""
        cfg, n = self.cfg, self.n
        core = self.core
        comm = cfg.mode != AsyncMode.NO_COMM
        esrc, edst = self._esrc, self._edst
        seed, t = batch_seed(carry), carry["t"]
        active = ~carry["done"] & ~carry["waiting"]
        if self._any_crashed:
            active = active & ~self._crashed
        drained_r = torch.zeros_like(carry["steps"])
        u = dict(carry)

        if comm:
            upd, drained_r = core.drain(
                carry, t[:, edst], active[:, edst], halo_key=self._halo_key,
                n_halo=n * 4, dst=edst, n_dst=n)
            u.update(upd)

        app_state, edges_out, steps = core.compute(
            carry, active, u["halo"], self._pids)
        u.update(app=app_state, steps=steps)

        if comm:
            # latency draws are keyed by (canonical edge, sender step
            # count), as on the dense layout
            lat = self._lat_base * lognormal_factor(
                cfg.latency_sigma, seed, STREAM_LAT, self._eids,
                steps[:, esrc])
            act_e = active[:, esrc]
            send_act = act_e
            if self._has_faults:
                # a lost / flapped / dead-bound send is killed before the
                # ring: it still counts attempted + dropped, and the
                # per-cause sums attribute it
                loss_kill, dead_kill = core.fault_masks(
                    seed, t[:, esrc], steps[:, esrc], self._eids,
                    self._loss, self._flap, self.faults.flap_period,
                    self._dead)
                send_act = act_e & ~(loss_kill | dead_kill)
            sp = core.send_edge(
                u, t[:, esrc], send_act, lat, u["ptouch"][:, self._rev],
                edges_out[:, esrc, self._out_slot], esrc, n)
            u.update(sp.rings)
            if self._has_faults:
                kill_cols = torch.stack(
                    [(act_e & loss_kill).to(torch.int32),
                     (act_e & dead_kill).to(torch.int32)], dim=-1)
                ks = segment_sum(kill_cols, esrc, n)
                killed = ks[..., 0] + ks[..., 1]
                u.update(c_att=carry["c_att"] + sp.sums[..., 0] + killed,
                         c_ok=carry["c_ok"] + sp.sums[..., 1],
                         c_drop=carry["c_drop"] + sp.sums[..., 2] + killed,
                         c_loss=carry["c_loss"] + ks[..., 0],
                         c_dead=carry["c_dead"] + ks[..., 1])
            else:
                u.update(c_att=carry["c_att"] + sp.sums[..., 0],
                         c_ok=carry["c_ok"] + sp.sums[..., 1],
                         c_drop=carry["c_drop"] + sp.sums[..., 2])
        return self._finish_window(u, active, drained_r)

    def _window_body_dense(self, carry, fused: bool = False):
        """One lockstep window on the dense bucketed layout over every
        replicate; returns the new carry.  With ``fused`` the drain runs
        against frozen base rings via the superstep pushbuf (same pops,
        same accepts, same counters)."""
        cfg = self.cfg
        core = self.core
        comm = cfg.mode != AsyncMode.NO_COMM
        seed, t = batch_seed(carry), carry["t"]
        active = ~carry["done"] & ~carry["waiting"]
        if self._any_crashed:
            active = active & ~self._crashed
        drained_r = torch.zeros_like(carry["steps"])
        u = dict(carry)

        if comm:
            if fused:
                upd, drained_r = core.window_dense_fused(
                    carry, t, active, spec=self._spec, dst_row=self._d_dst)
            else:
                upd, drained_r = core.window_dense(carry, t, active,
                                                   spec=self._spec)
            u.update(upd)

        app_state, edges_out, steps = core.compute(
            carry, active, u["halo"], self._pids)
        u.update(app=app_state, steps=steps)

        if comm:
            # latency draws are keyed by (canonical edge, sender step
            # count): a process's c-th send draws the same jitter under any
            # scheduler (dead rows are clipped and masked off by `live`)
            src_c = self._d_src_c
            lat = self._d_lat * lognormal_factor(
                cfg.latency_sigma, seed, STREAM_LAT, self._d_eid,
                steps[:, src_c])
            km = None
            if self._has_faults:
                km = core.fault_masks(
                    seed, t[:, src_c], steps[:, src_c], self._d_eid,
                    self._d_loss, self._d_flap, self.faults.flap_period,
                    self._d_dead)
            u.update(core.stage_dense(
                carry, u, t, active, edges_out, lat,
                src=self._d_src, rev=self._d_rev,
                out_slot=self._d_out_slot, live=self._d_live,
                deg=self._deg, spec=self._spec, kill_masks=km))
        return self._finish_window(u, active, drained_r)

    def _superstep_body(self, carry):
        """One W-fused superstep over every replicate: W windows against
        frozen base rings, then ONE ``duct_commit`` folds the superstep's
        pushes into the rings."""
        for _ in range(self.superstep_windows):
            carry = self._window_body_dense(carry, fused=True)
        carry = dict(carry)
        carry.update(self.core.commit_superstep(carry))
        return carry

    def _finish_window(self, u, active, drained_r):
        return self.core.close_window(
            u, active, drained_r, pids=self._pids, deg=self._deg,
            cfactor=self._cfactor, release=LOCAL_RELEASE)

    def _run_chunk(self, carry):
        """``_windows_per_call`` windows: whole supersteps under the
        superstep scheduler, single windows of the layout otherwise."""
        if self.scheduler == "superstep":
            for _ in range(self._windows_per_call // self.superstep_windows):
                carry = self._superstep_body(carry)
        else:
            body = (self._window_body if self.layout == "edge"
                    else self._window_body_dense)
            for _ in range(self._windows_per_call):
                carry = body(carry)
        return carry

    # ------------------------------------------------------------------
    def run(self) -> SimResult:
        return self.run_replicates([self.cfg.seed])[0]

    def _chunks(self, carry):
        """Run chunks of windows (``_run_chunk``) until the done probe
        finds every replicate stopped or the window budget is spent;
        returns ``(carry, windows, needed)``, ``needed`` per replicate.

        The probe is read once per chunk, never per window, over every
        replicate at once: the windows after all of a replicate's
        processes have stopped leave the state its result is assembled
        from unchanged, so where in a chunk, or in which later chunk, the
        batch ends does not change any replicate's result."""
        reps = carry["t"].shape[0]
        windows, needed = 0, [None] * reps
        while windows < self._max_windows:
            carry = self._run_chunk(carry)
            windows += self._windows_per_call
            # crashed processes never reach the horizon; the probe treats
            # them as terminally stopped
            stopped = self._stop_release.all_stopped(
                carry["done"] | self._crashed_probe)[:, 0]
            for r, s in enumerate(stopped.tolist()):
                if s and needed[r] is None:
                    needed[r] = windows
            if all(x is not None for x in needed):
                break
        return carry, windows, [windows if x is None else x for x in needed]

    def run_batch(self, seeds: Sequence[int]):
        """Run one replicate per seed, all in one chunk loop; returns
        ``(carry, windows)``, the carry batched (leading replicate
        axis)."""
        carry, windows, needed = self._chunks(self._init_batch(seeds))
        self.windows.extend([windows] * len(seeds))
        self.windows_needed.extend(needed)
        return carry, windows

    def run_replicates(self, seeds: Sequence[int]) -> List[SimResult]:
        """One replicate per seed, run as one batch: every window phase
        once over all replicates, each duct kernel one launch a window."""
        carry, _ = self.run_batch(seeds)
        carry = carry_to_numpy(carry)
        return [self._assemble(carry, r) for r in range(len(seeds))]

    def run_replicates_sequential(self, seeds: Sequence[int]
                                  ) -> List[SimResult]:
        """One replicate per seed, run one after another, each a batch of
        one: the oracle ``run_replicates`` is held to."""
        out = []
        for s in seeds:
            carry, _ = self.run_batch([int(s)])
            out.append(self._assemble(carry_to_numpy(carry), 0))
        return out

    def _assemble(self, carry, r: int) -> SimResult:
        """The SimResult of replicate ``r`` of a batched numpy carry."""
        app_state = {k: v[r] for k, v in carry["app"].items()}
        return self.core.assemble(
            carry, r, np.asarray(self._deg.cpu().numpy(), np.int64),
            self.bapp.quality(app_state),
            app_state=(self.bapp.export_state(app_state)
                       if self.cfg.carry_app_state
                       and hasattr(self.bapp, "export_state") else None))
