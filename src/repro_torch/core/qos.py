"""Quality-of-service metric suite (paper §II-D), computed from counter
snapshots taken before/after an unimpeded observation window.

Counters mirror the paper's Inlet/Outlet instrumentation:
  update_count           simulation updates completed
  touch_count            round-trip touch counter (+2 per completed round trip)
  attempted_send_count   messages pushed toward a duct
  successful_send_count  messages accepted by the duct (buffer not full)
  dropped_send_count     messages that failed delivery, counted at the drop
                         site (never derived as attempted - successful).
                         This is the TOTAL across all three drop causes;
                         the two subset counters below attribute it:
  loss_dropped_send_count   subset dropped by a lossy or flapping link
                            (deterministic per-send hash draw)
  dead_dropped_send_count   subset sent toward a crashed (dead) process
                         capacity drops (full duct) are the remainder:
                         dropped - loss_dropped - dead_dropped
  laden_pull_count       pull attempts that retrieved >= 1 fresh message
  message_count          messages received
  pull_attempt_count     pull attempts
  wall_time              seconds
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass
class Counters:
    update_count: int = 0
    touch_count: int = 0
    attempted_send_count: int = 0
    successful_send_count: int = 0
    dropped_send_count: int = 0
    loss_dropped_send_count: int = 0
    dead_dropped_send_count: int = 0
    laden_pull_count: int = 0
    message_count: int = 0
    pull_attempt_count: int = 0
    wall_time: float = 0.0

    def copy(self) -> "Counters":
        return dataclasses.replace(self)


@dataclasses.dataclass(frozen=True)
class QosReport:
    simstep_period: float          # seconds per update (lower is better)
    simstep_latency: float         # updates per one-way delivery
    walltime_latency: float        # seconds per one-way delivery
    delivery_failure_rate: float   # fraction of sends dropped
    delivery_clumpiness: float     # 1 - steadiness
    # observation-window bounds on the process's own virtual clock; stamp
    # the report so per-interval (time-resolved) aggregation needs no side
    # channel back to the engine's snapshot buffers
    t_start: float = 0.0
    t_end: float = 0.0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def simstep_period(before: Counters, after: Counters) -> float:
    """Seconds of wall time per completed update.

    A zero-update observation window (idle, barrier-parked, or churned-out
    process) reports an explicit ``inf`` sentinel rather than ``wall / 1``:
    the old clamp made a stalled process look like one *fast* update per
    window, which inverts SLO verdicts under churn.  Aggregators filter the
    sentinel deliberately (see :func:`aggregate_reports`)."""
    updates = after.update_count - before.update_count
    wall = after.wall_time - before.wall_time
    if updates <= 0:
        return float("inf")
    return wall / updates


def simstep_latency(before: Counters, after: Counters) -> float:
    """Updates elapsed per one-way message delivery.

    The touch counter increments by two per completed round trip; if no
    touches elapsed we make the paper's best-case assumption of one.
    """
    updates = after.update_count - before.update_count
    touches = after.touch_count - before.touch_count
    return updates / max(touches, 1)


def walltime_latency(before: Counters, after: Counters) -> float:
    """Seconds per one-way delivery; ``inf`` on a zero-update window (the
    guard keeps the sentinel from collapsing to ``0 * inf = nan``)."""
    if after.update_count - before.update_count <= 0:
        return float("inf")
    return simstep_latency(before, after) * simstep_period(before, after)


def delivery_failure_rate(before: Counters, after: Counters) -> float:
    """Fraction of sends dropped, from the explicit drop counter.

    Drops are counted at the drop site (``dropped_send_count``), not derived
    as attempted - successful: the two sender-side counters are snapshotted
    independently, so the derived form can go transiently negative or miss
    drops when a window boundary falls between the increments.
    """
    attempted = after.attempted_send_count - before.attempted_send_count
    dropped = after.dropped_send_count - before.dropped_send_count
    if attempted <= 0:
        return 0.0
    return dropped / attempted


def delivery_clumpiness(before: Counters, after: Counters) -> float:
    """1 - steadiness.  Zero when messages arrive as an even stream (every
    arrival in its own pull, or every pull laden once pigeonholed)."""
    laden = after.laden_pull_count - before.laden_pull_count
    messages = after.message_count - before.message_count
    pulls = after.pull_attempt_count - before.pull_attempt_count
    opportunities = min(messages, pulls)
    if opportunities <= 0:
        return 0.0
    steadiness = laden / opportunities
    return 1.0 - min(steadiness, 1.0)


def report(before: Counters, after: Counters) -> QosReport:
    return QosReport(
        simstep_period=simstep_period(before, after),
        simstep_latency=simstep_latency(before, after),
        walltime_latency=walltime_latency(before, after),
        delivery_failure_rate=delivery_failure_rate(before, after),
        delivery_clumpiness=delivery_clumpiness(before, after),
        t_start=before.wall_time,
        t_end=after.wall_time,
    )


# ---------------------------------------------------------------------------
# Canonical result signature for engine conformance (DESIGN.md §11).
# ---------------------------------------------------------------------------
def qos_signature(result) -> dict:
    """A canonical, exactly-comparable digest of a ``SimResult``.

    Flattens every per-process counter and every per-(process, window)
    ``QosReport`` field into plain Python lists of ints/floats, keyed by
    stable names.  Two engines are *bitwise conformant* on a scenario iff
    their signatures compare equal with ``==`` — no tolerance, no metric
    subset.  ``tests/test_engine_conformance.py`` asserts exactly this for
    every registered engine against the event-ordered oracle (and for
    every sharded configuration against ``shards=1``), and serializes the
    signature into the parity-table artifact, so a semantic drift in any
    engine shows up as a field-level diff rather than a tolerance breach.
    """
    sig = {
        "updates": [int(u) for u in result.updates],
        "sent": int(result.sent),
        "dropped": int(result.dropped),
        "dropped_loss": int(result.dropped_loss),
        "dropped_dead": int(result.dropped_dead),
        "quality": float(result.quality),
        "qos": {},
    }
    fields = METRICS + ("t_start", "t_end")
    for f in fields:
        sig["qos"][f] = {
            int(pid): [float(getattr(r, f)) for r in reps]
            for pid, reps in sorted(result.qos_by_process.items())
        }
    return sig


# ---------------------------------------------------------------------------
# Distribution aggregation across processes and windows (paper §III reports
# medians + tails, not means: under best-effort QoS the distribution IS the
# result).
# ---------------------------------------------------------------------------
METRICS = ("simstep_period", "simstep_latency", "walltime_latency",
           "delivery_failure_rate", "delivery_clumpiness")


def aggregate_reports(reports, percentiles=(50, 95)):
    """Per-metric percentile summary over (process, window) samples.

    Returns ``{metric: {"median": v, "p95": v, ...}}`` — percentile 50 is
    keyed ``"median"``, every other q as ``"p{q}"``.  Empty input yields
    empty per-metric dicts.

    Zero-update windows stamp ``inf`` sentinels into the period/latency
    metrics (see :func:`simstep_period`); percentiles are taken over the
    *finite* samples only, so one idle process cannot saturate a tail
    statistic — a metric whose every sample is the sentinel reports
    ``None``, the same as no data.
    """
    out = {}
    for m in METRICS:
        vals = [v for r in reports if math.isfinite(v := getattr(r, m))]
        summary = {}
        for q in percentiles:
            key = "median" if q == 50 else f"p{int(q)}"
            summary[key] = float(np.percentile(vals, q)) if vals else None
        out[m] = summary
    return out


def median_of_process_medians(qos_by_process, metric: str):
    """The paper's headline statistic: median over processes of each
    process's median over observation windows.  None if no windows.
    Idle-window ``inf`` sentinels are excluded per process; a process with
    only sentinel windows contributes no median."""
    meds = []
    for reps in qos_by_process.values():
        vals = [v for q in reps if math.isfinite(v := getattr(q, metric))]
        if vals:
            meds.append(np.median(vals))
    return float(np.median(meds)) if meds else None


# ---------------------------------------------------------------------------
# Time-resolved QoS stream: the paper argues that "a complete picture of
# scalability under the best-effort model requires analysis of how quality
# of service fares over time" — so beyond pooled (process, window)
# distributions, expose the per-interval trajectory.
# ---------------------------------------------------------------------------
def aggregate_timeseries(process_reports, percentiles=(50, 95)):
    """Per-interval QoS distributions over processes: the time axis.

    Snapshot thresholds are global (``warmup + i * interval`` on each
    process's own clock), so the i-th observation window of every process
    covers the same virtual-time interval; pooling column-wise yields a
    time-resolved stream instead of one end-of-run aggregate.

    ``process_reports`` is an iterable of per-process report lists — e.g.
    ``result.qos_by_process.values()``, or those of several replicates
    chained.  Ragged inputs are fine: a process that produced fewer
    windows simply stops contributing.  Returns one row per interval::

        {"interval": i, "t_start": ..., "t_end": ..., "n_samples": k,
         "complete": bool, "qos": {metric: {"median": ..., "p95": ...}}}

    where the t bounds are medians over the contributing processes' own
    snapshot clocks.  ``complete`` marks intervals every process
    contributed a window to; ragged-tail rows (a process finished early,
    left the service, or never reached the interval) pool whatever samples
    exist but carry ``complete: False`` so time-sliced SLO verdicts can
    flag rather than trust them.
    """
    columns = []
    n_procs = 0
    for reps in process_reports:
        n_procs += 1
        for i, r in enumerate(reps):
            if i >= len(columns):
                columns.append([])
            columns[i].append(r)
    rows = []
    for i, bucket in enumerate(columns):
        rows.append({
            "interval": i,
            "t_start": float(np.median([r.t_start for r in bucket])),
            "t_end": float(np.median([r.t_end for r in bucket])),
            "n_samples": len(bucket),
            "complete": len(bucket) == n_procs,
            "qos": aggregate_reports(bucket, percentiles),
        })
    return rows
