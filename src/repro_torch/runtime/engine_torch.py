"""Vectorized windowed-time best-effort engine on torch tensors.

The PyTorch counterpart of the reference's ``JaxEngine``.  The discrete-
event engine (``runtime/simulator.py``) processes one event at a time;
this engine advances the *entire process population per lockstep window*
as tensors on one device: window k is every process's k-th simstep,
executed at per-process virtual times that drift apart exactly as the
paper describes.  Per window it composes the window-phase core
(``runtime/window_core.py``) on the bucketed dense receiver-major duct
layout:

  1. drain      one fused ``duct_window`` pass per degree bucket
  2. compute    the application's batched step
  3. stage      the eager send decision (capacity drop, latency stamp)
  4. close      QoS snapshots, termination, barriers, time advance

With ``scheduler="superstep"`` W windows run against frozen base rings and
one ``duct_commit`` per superstep folds their pushes into the rings; the
trajectories are bitwise those of the per-window path.

On ``device="cuda"`` (the default) the two duct ops run as hand-written
CUDA kernels; on ``device="cpu"`` as their plain torch versions.  A run is
a pure function of ``(config, seed)`` and reproduces the JAX engine's
``SimResult`` bitwise at the same seed.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.modes import AsyncMode
from repro_torch.interop import carry_to_numpy
from repro_torch.runtime.faults import FaultModel
from repro_torch.runtime.simulator import SimConfig, SimResult
from repro_torch.runtime.topologies import (
    OPP_IDX,
    Topology,
    canonical_edges,
    plan_layout,
)
from repro_torch.runtime.window_core import (
    BARRIER_MODES,
    LOCAL_RELEASE,
    STREAM_LAT,
    WindowCore,
    lognormal_factor,
    make_dense_spec,
)


def resolve_device(device) -> torch.device:
    """The device a torch entry point runs on: CUDA unless the caller asks
    for the CPU.  Asking for CUDA where there is none raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' (--device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unknown device {device!r}; use 'cuda' or 'cpu'")
    return dev


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
        if cfg.arrival_rate > 0:
            raise ValueError(
                "open-loop service arrivals (arrival_rate > 0) are not "
                "ported to the torch engine yet; run them on the reference "
                "(python -m repro.runtime.experiments --family serve)")
        topo = getattr(app, "injected", None)
        if not isinstance(topo, Topology):
            raise ValueError(
                "TorchEngine needs an app built with an injected "
                "runtime.topologies.Topology (experiments always inject one)")
        self.topo = topo
        self.n = n = app.n_processes
        self.bapp = app.batched(dev)
        self.core = WindowCore(cfg, self.bapp, n, max_pops=max_pops)

        def i32(x):
            return torch.as_tensor(np.asarray(x, np.int32), device=dev)

        def i64(x):
            return torch.as_tensor(np.asarray(x, np.int64), device=dev)

        # --- static edge plumbing (numpy, built once) ---------------------
        esrc, edst, _ = canonical_edges(topo)
        E = len(esrc)
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
        self._deg = i32([topo.degree(p) for p in range(n)])
        self._cfactor = torch.as_tensor(np.asarray(
            [self.faults.compute_factor(p) for p in range(n)], np.float32),
            device=dev)

        # --- duct layout: the bucketed dense receiver-major layout --------
        lp = plan_layout(topo, layout)
        self.layout = lp.kind
        if self.layout != "dense":
            raise ValueError(
                "the torch engine has only the dense duct layout; the "
                "edge-major layout is not ported yet (drop --layout edge)")
        self._spec = make_dense_spec(lp, dev)
        self.R = R = int(lp.n_rows)
        # flat (R,) row tables; dead padding rows carry sentinel
        # src == n / eid == E and live == False
        j = np.arange(R) - lp.row_start[lp.dst]
        self._d_src = i64(lp.src)
        self._d_dst = i64(lp.dst)
        self._d_rev = i64(lp.rev)
        self._d_eid = i32(lp.eid)
        self._d_live = torch.as_tensor(lp.live, device=dev)
        # row j of a receiver block feeds halo slot j % 4, so the sender
        # writes the opposite slot
        self._d_out_slot = i64(np.asarray(OPP_IDX, np.int64)[j % 4])
        self._d_src_c = self._d_src.clamp(0, n - 1)

        def per_row(x, fill):
            return np.concatenate([x, np.full(1, fill, x.dtype)])[lp.eid]

        self._d_lat = torch.as_tensor(per_row(lat, 0), device=dev)
        if self._has_faults:
            self._d_loss = torch.as_tensor(per_row(loss, 0), device=dev)
            self._d_flap = torch.as_tensor(per_row(flap, 0), device=dev)
            self._d_dead = torch.as_tensor(per_row(dead, False), device=dev)
        if scheduler == "superstep":
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
        elif scheduler != "window":
            raise ValueError(f"the torch engine has no {scheduler!r} "
                             "scheduler (offers: window, superstep)")

        self.S = self.core.S
        self._max_windows = self.core.default_max_windows
        #: lockstep windows each run of this engine executed, in order
        self.windows: List[int] = []
        if scheduler == "superstep":
            W = self.superstep_windows
            self._windows_per_call = max(1, self.chunk // W) * W
        else:
            self._windows_per_call = self.chunk

    # ------------------------------------------------------------------
    def _step_factor(self, seed, steps):
        return self.core.step_factor(seed, steps, self._pids, self._cfactor)

    def _edge_state(self) -> Dict[str, torch.Tensor]:
        """Fresh (empty-ring) duct state for the scheduler."""
        if self.scheduler == "superstep":
            return self.core.superstep_rings(self.R, self.superstep_windows,
                                             self.device)
        return self.core.dense_rings(self.R, self.device)

    def _init_carry(self, seed: int) -> Dict[str, torch.Tensor]:
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
    def _window_body_dense(self, carry, fused: bool = False):
        """One lockstep window on the dense bucketed layout; returns the new
        carry.  With ``fused`` the drain runs against frozen base rings via
        the superstep pushbuf (same pops, same accepts, same counters)."""
        cfg = self.cfg
        core = self.core
        comm = cfg.mode != AsyncMode.NO_COMM
        seed, t = carry["seed"], carry["t"]
        active = ~carry["done"] & ~carry["waiting"]
        if self._any_crashed:
            active = active & ~self._crashed
        drained_r = torch.zeros(self.n, dtype=torch.int32,
                                device=self.device)
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
                steps[src_c])
            km = None
            if self._has_faults:
                km = core.fault_masks(
                    seed, t[src_c], steps[src_c], self._d_eid,
                    self._d_loss, self._d_flap, self.faults.flap_period,
                    self._d_dead)
            u.update(core.stage_dense(
                carry, u, t, active, edges_out, lat,
                src=self._d_src, rev=self._d_rev,
                out_slot=self._d_out_slot, live=self._d_live,
                deg=self._deg, spec=self._spec, kill_masks=km))
        return self._finish_window(u, active, drained_r)

    def _superstep_body(self, carry):
        """One W-fused superstep: W windows against frozen base rings, then
        ONE ``duct_commit`` folds the superstep's pushes into the rings."""
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
        superstep scheduler, single windows otherwise."""
        if self.scheduler == "superstep":
            for _ in range(self._windows_per_call // self.superstep_windows):
                carry = self._superstep_body(carry)
        else:
            for _ in range(self._windows_per_call):
                carry = self._window_body_dense(carry)
        return carry

    # ------------------------------------------------------------------
    def run(self) -> SimResult:
        return self.run_replicates([self.cfg.seed])[0]

    def run_carry(self, seed: int):
        """Run one replicate to completion; returns ``(carry, windows)``.

        The done probe is read once per chunk, never per window: the
        windows after every process has stopped leave the state the
        result is assembled from unchanged, so where in a chunk the run
        ends does not change the result."""
        carry = self._init_carry(int(seed))
        windows = 0
        while windows < self._max_windows:
            carry = self._run_chunk(carry)
            windows += self._windows_per_call
            # crashed processes never reach the horizon; the probe treats
            # them as terminally stopped
            stopped = carry["done"] | self._crashed
            if bool(stopped.all()):
                break
        return carry, windows

    def run_replicates(self, seeds: Sequence[int]) -> List[SimResult]:
        """One replicate per seed, run one after another."""
        out = []
        for s in seeds:
            carry, windows = self.run_carry(s)
            self.windows.append(windows)
            out.append(self._assemble(carry_to_numpy(carry)))
        return out

    def _assemble(self, carry) -> SimResult:
        app_state = carry["app"]
        return self.core.assemble(
            carry, np.asarray(self._deg.cpu().numpy(), np.int64),
            self.bapp.quality(app_state),
            app_state=(self.bapp.export_state(app_state)
                       if self.cfg.carry_app_state else None))
