"""Live best-effort service harness: open-loop traffic + elastic churn.

Turns a batch simulation run into a serving scenario (ROADMAP "live
service"; Conduit frames best-effort exchange as a long-running service
rather than a batch job):

  * **Open-loop arrivals** — a deterministic splitmix-hashed arrival
    stream models external users feeding each process's work queue at a
    rate that does not care how fast the system drains it.  The stream is
    precomputed as a cumulative per-(process, time-bin) table — a pure
    function of ``(cfg, seed)`` — and carried into every engine, so the
    event-ordered reference and the vectorized/sharded engines all inject
    bit-identical load (``simulator.run``'s serve block and
    ``window_core.close_window``'s serve hook implement the same
    recurrence).  Three traffic shapes: ``poisson`` (constant rate),
    ``bursty`` (hash-gated global surges, rate-normalized so the mean
    matches), ``diurnal`` (sinusoidal rate swing).
  * **Elastic churn** — a :class:`~repro_torch.runtime.faults.FaultTimeline`
    schedules hosts faulting/healing and processes leaving/rejoining.
    The run is split into epochs at event boundaries; each epoch patches
    the pristine topology (``topologies.patch_topology`` splices the duct
    rings of departed processes closed) and composes the active host
    faults, then runs on the selected engine.  Processes present on both
    sides of a membership change carry their application state across the
    boundary (``SimResult.app_state`` round-trips through the builder's
    ``initial_state`` argument); departed processes re-initialize fresh
    on rejoin.
  * **SLO verdicts** — per-epoch QoS timeseries rows are shifted onto the
    global clock, concatenated, and scored by
    :func:`repro_torch.core.slo.evaluate_timeseries`.

Arrival draws use dedicated splitmix streams disjoint from the jitter and
app streams; per bin the count is Knuth/inversion Poisson (exact, capped
exponential draws) for small means and a rounded normal approximation for
large means — both pure counter hashes, so any engine, layout, shard
count, or superstep width sees the identical table.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.qos import aggregate_reports, aggregate_timeseries
from repro_torch.core.slo import SloPolicy, evaluate_timeseries
from repro_torch.runtime.config import RunConfig
from repro_torch.runtime.faults import (FaultTimeline, TimelineEvent,
                                        _chain_prefix, _np_splitmix64,
                                        _np_uniform)
from repro_torch.runtime.simulator import SimConfig
from repro_torch.runtime.topologies import Topology, patch_topology

#: splitmix stream tags for the arrival draws (disjoint from the jitter
#: streams in faults.py and the app/window streams in window_core.py)
STREAM_ARRIVE = 0x41525256   # per-(pid, bin) count draws
STREAM_SHAPE = 0x53485045    # per-bin global shape gates (bursty)

#: capped exponential draws per (pid, bin) for the exact small-mean branch
_CAP = 32
#: per-bin mean at or above which the normal approximation takes over
#: (P[Poisson(10) > 32] ~ 1e-9, so the cap never truncates below it)
_NORMAL_CUTOFF = 10.0


# ---------------------------------------------------------------------------
# Arrival streams
# ---------------------------------------------------------------------------
def n_bins(cfg: SimConfig) -> int:
    return max(1, int(math.ceil(cfg.duration / cfg.arrival_bin - 1e-9)))


def rate_profile(cfg: SimConfig, seed: int, nbins: int) -> np.ndarray:
    """Per-bin arrival rate (arrivals /process /vsecond), shape ``(nbins,)``.

    ``poisson`` is flat; ``bursty`` gates each bin globally (one hash per
    bin) into a ``arrival_burst_factor``x surge with probability
    ``arrival_burst_prob``, normalized so the expected rate still equals
    ``arrival_rate``; ``diurnal`` swings sinusoidally (+-60%) with period
    ``arrival_period``.  All shapes conserve the configured mean rate.
    """
    rate = float(cfg.arrival_rate)
    shape = cfg.arrival_shape
    if shape == "poisson":
        return np.full(nbins, rate)
    if shape == "bursty":
        prefix = _chain_prefix(seed, STREAM_SHAPE)
        u = _np_uniform(_np_splitmix64(
            np.uint64(prefix) ^ np.arange(nbins, dtype=np.uint64)))
        p = cfg.arrival_burst_prob
        f = cfg.arrival_burst_factor
        norm = 1.0 - p + p * f
        return np.where(u < p, rate * f / norm, rate / norm)
    if shape == "diurnal":
        centers = (np.arange(nbins) + 0.5) * cfg.arrival_bin
        swing = np.sin(2.0 * np.pi * centers / cfg.arrival_period)
        return rate * (1.0 + 0.6 * swing)
    raise ValueError(
        f"unknown arrival_shape {shape!r} (poisson|bursty|diurnal)")


def arrival_table(cfg: SimConfig, seed: int, n: int) -> np.ndarray:
    """Per-(process, bin) arrival counts, shape ``(n, nbins)`` int64.

    Pure function of ``(cfg, seed)``: every count is a counter-based hash
    draw keyed by ``(seed, STREAM_ARRIVE, pid, bin)``.  Bins with mean
    below :data:`_NORMAL_CUTOFF` draw exact Poisson counts by inversion
    (count = #{k : sum of k exponentials < mean}, exponentials from the
    hash chain, cap :data:`_CAP`); heavier bins use a rounded
    mean + sqrt(mean) * z normal approximation (one Box-Muller draw per
    (pid, bin)) — unbiased to first order, so rate conservation holds per
    shape.
    """
    nbins = n_bins(cfg)
    means = rate_profile(cfg, seed, nbins) * cfg.arrival_bin
    prefixes = np.array(
        [_chain_prefix(seed, STREAM_ARRIVE, pid) for pid in range(n)],
        dtype=np.uint64)
    counts = np.zeros((n, nbins), dtype=np.int64)

    small = np.nonzero(means < _NORMAL_CUTOFF)[0]
    if small.size:
        ctr = (small.astype(np.uint64) * np.uint64(_CAP))[None, :, None] \
            + np.arange(_CAP, dtype=np.uint64)[None, None, :]
        u = _np_uniform(_np_splitmix64(prefixes[:, None, None] ^ ctr))
        s = np.cumsum(-np.log(u), axis=-1)
        counts[:, small] = (s < means[small][None, :, None]).sum(axis=-1)

    large = np.nonzero(means >= _NORMAL_CUTOFF)[0]
    if large.size:
        ctr = (large.astype(np.uint64) * np.uint64(_CAP))[None, :]
        h = _np_splitmix64(prefixes[:, None] ^ ctr)
        u1 = _np_uniform(_np_splitmix64(h ^ np.uint64(1)))
        u2 = _np_uniform(_np_splitmix64(h ^ np.uint64(2)))
        z = np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u2)
        m = means[large][None, :]
        counts[:, large] = np.maximum(
            0.0, np.rint(m + np.sqrt(m) * z)).astype(np.int64)
    return counts


def cum_arrivals(cfg: SimConfig, seed: int, n: int) -> np.ndarray:
    """Zero-prefixed cumulative arrival table, shape ``(n, nbins + 1)``.

    ``cum[pid][b]`` = arrivals queued to ``pid`` in bins strictly before
    ``b`` — i.e. everything available once bin ``b - 1`` has fully
    elapsed on the process's own clock; column ``-1`` is the run total.
    This is the exact array both ``simulator.run`` and the torch engines
    carry (int32; the total is asserted to fit).
    """
    counts = arrival_table(cfg, seed, n)
    cum = np.zeros((n, counts.shape[1] + 1), dtype=np.int64)
    np.cumsum(counts, axis=1, out=cum[:, 1:])
    if cum.max(initial=0) >= 2 ** 31:
        raise ValueError(
            "arrival totals overflow int32: lower arrival_rate or "
            "duration (max cumulative count "
            f"{int(cum.max(initial=0))})")
    return cum.astype(np.int32)


# ---------------------------------------------------------------------------
# Churn schedules
# ---------------------------------------------------------------------------
def default_timeline(topo: Topology, churn: int, duration: float,
                     compute_factor: float = 30.0,
                     link_factor: float = 50.0) -> FaultTimeline:
    """An evenly spaced churn schedule with ``churn`` incidents.

    Incident ``i`` occupies the open slot ``(2i+1 .. 2i+2) / (2*churn+1)``
    of the run, so incidents never overlap and the run starts and ends
    calm.  Even incidents degrade-then-heal a host (round-robin over the
    topology's hosts); odd incidents make a process leave then rejoin
    (spread across the pid range).  Deterministic in ``(topo, churn,
    duration)``.
    """
    if churn <= 0:
        return FaultTimeline((), compute_factor, link_factor)
    hosts = sorted(set(topo.node_of))
    events: List[TimelineEvent] = []
    slots = 2 * churn + 1
    for i in range(churn):
        on = duration * (2 * i + 1) / slots
        off = duration * (2 * i + 2) / slots
        if i % 2 == 0:
            host = hosts[(i // 2) % len(hosts)]
            events.append(TimelineEvent(t=on, kind="fault", host=host))
            events.append(TimelineEvent(t=off, kind="heal", host=host))
        else:
            pid = (topo.n // 2 + (i // 2) * 7919) % topo.n
            events.append(TimelineEvent(t=on, kind="leave", pid=pid))
            events.append(TimelineEvent(t=off, kind="join", pid=pid))
    return FaultTimeline(tuple(events), compute_factor, link_factor)


# ---------------------------------------------------------------------------
# Epoch orchestration
# ---------------------------------------------------------------------------
def _shift_reports(reps, offset: float):
    return [dataclasses.replace(r, t_start=r.t_start + offset,
                                t_end=r.t_end + offset) for r in reps]


def run_service(run: RunConfig,
                app_builder: Callable[[Topology, int], object],
                cfg: SimConfig, topo: Topology,
                timeline: Optional[FaultTimeline] = None,
                policy: Optional[SloPolicy] = None,
                percentiles: Sequence[int] = (50, 95, 99),
                **engine_kwargs) -> dict:
    """Run one live-service scenario end to end.

    Splits ``[0, cfg.duration)`` into epochs at the timeline's event
    boundaries.  Each epoch patches the pristine ``topo`` by the pids
    absent at its start, composes the active host faults, and runs
    ``run.replicates`` seeds of ``app_builder(patched_topology, seed)``
    through the registry engine via
    :func:`~repro_torch.runtime.engine.run_replicates`.  Per-epoch QoS
    windows are shifted onto the global clock and concatenated into one
    timeseries, which the SLO policy scores per interval.

    Returns a JSON-ready dict::

        {"epochs": [...], "qos": {...}, "qos_timeseries": [...],
         "slo": {"verdicts": [...], "summary": {...}},
         "service": {"arrivals": A, "served": S, "backlog": A - S}}

    ``epochs`` logs each membership/fault regime (bounds, live process
    count, absent original pids, faulty hosts).  When the app exports
    carriable state (``SimResult.app_state``) and ``app_builder`` accepts
    a third ``initial_state`` argument, processes present on both sides
    of an epoch boundary resume from their previous epoch's final state;
    departed-then-rejoined processes re-initialize fresh.  Builders with
    the legacy two-argument signature keep the old restart-every-epoch
    behavior.  ``engine_kwargs`` are backend extras passed on to every
    epoch's engine (``device="cpu"`` for the torch engine off the card).
    """
    # deferred: repro_torch.runtime.engine imports this module's consumers
    import inspect

    from repro_torch.runtime.engine import run_replicates

    timeline = timeline or FaultTimeline()
    policy = policy or SloPolicy()
    timeline.validate(topo)
    bounds = timeline.boundaries(cfg.duration)
    edges = [0.0, *bounds, cfg.duration]
    try:
        carries = len(inspect.signature(app_builder).parameters) >= 3
    except (TypeError, ValueError):
        carries = False

    epochs: List[dict] = []
    all_rows: List[dict] = []
    pooled_qos: List = []
    totals = {"arrivals": 0, "served": 0, "backlog": 0}
    interval = 0
    #: per replicate position: {original pid: app state} from the previous
    #: epoch (None before the first epoch or when the app exports nothing)
    carried: Optional[List[dict]] = None
    for ei in range(len(edges) - 1):
        t0, t1 = edges[ei], edges[ei + 1]
        absent = timeline.absent_pids(t0)
        patched, pid_map = patch_topology(topo, absent)
        faults = timeline.fault_model(patched, t0, pid_map=pid_map)
        ep_len = t1 - t0
        ep_cfg = dataclasses.replace(
            cfg, duration=ep_len,
            snapshot_warmup=min(cfg.snapshot_warmup, ep_len / 6),
            seed=cfg.seed + 7919 * ei,
            carry_app_state=carries)
        seeds = run.seeds(ep_cfg.seed)
        init_state = None
        if carries and carried is not None:
            # survivors resume: re-key each replicate's carried state from
            # original to this epoch's patched pids (departed pids fall out
            # of pid_map and so re-initialize fresh on rejoin), indexed by
            # the replicate's seed so one app serves a whole batch
            init_state = {
                seeds[i]: {pid_map[p]: st for p, st in carried[i].items()
                           if p in pid_map}
                for i in range(len(seeds))}
        build = ((lambda s: app_builder(patched, s, init_state)) if carries
                 else (lambda s: app_builder(patched, s)))
        results = run_replicates(
            run, build, ep_cfg, seeds=seeds, faults=faults, **engine_kwargs)
        inv_map = {v: k for k, v in pid_map.items()}
        if all(res.app_state is not None for res in results):
            # back to original pid numbering for the next epoch's re-key
            carried = [{inv_map[p]: st for p, st in res.app_state.items()}
                       for res in results]
        else:
            carried = None

        reps_lists = [_shift_reports(reps, t0)
                      for res in results
                      for reps in res.qos_by_process.values()]
        rows = aggregate_timeseries(reps_lists, percentiles=percentiles)
        for row in rows:
            row["interval"] = interval
            row["epoch"] = ei
            interval += 1
        all_rows.extend(rows)
        pooled_qos.extend(q for res in results for q in res.qos)
        for res in results:
            if res.service:
                for key in totals:
                    totals[key] += sum(res.service[key])
        epochs.append({
            "epoch": ei,
            "t_start": t0,
            "t_end": t1,
            "n_procs": patched.n,
            "absent_pids": sorted(absent),
            "faulty_hosts": sorted(timeline.faulty_hosts(t0)),
            "intervals": len(rows),
        })

    slo = evaluate_timeseries(all_rows, policy)
    return {
        "epochs": epochs,
        "qos": aggregate_reports(pooled_qos, percentiles=percentiles),
        "qos_timeseries": all_rows,
        "slo": slo,
        "service": totals,
    }
