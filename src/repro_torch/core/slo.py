"""Time-sliced SLO evaluation over the QoS timeseries (docs/QOS.md).

The paper characterizes quality of service instead of guaranteeing
delivery; a live serving posture turns that characterization into
budgets.  This module consumes the per-interval rows produced by
:func:`repro_torch.core.qos.aggregate_timeseries` and renders a machine-readable
verdict per time slice — p99 simstep-latency and delivery-failure-rate
against fixed budgets, plus a burn-rate window for sustained-breach
detection — rather than one end-of-run aggregate that a transient brownout
would vanish into.

Conventions:

  * a metric breaches iff its p99 is strictly *greater* than the budget —
    a slice sitting exactly on budget passes (budgets are inclusive);
  * a slice with no finite samples for either metric (every process idle,
    churned out, or past its last window) yields ``verdict: "no_data"``
    and is excluded from burn-rate accounting — absence of evidence is
    flagged, not scored;
  * ``burn_rate`` is the breach fraction over the trailing
    ``burn_window`` data-bearing slices; ``burning`` marks slices where it
    exceeds ``burn_threshold`` (sustained breach, not a single spike).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass(frozen=True)
class SloPolicy:
    """Per-slice service-level objectives for an open-loop run.

    ``latency_p99_budget`` bounds p99 ``simstep_latency`` (updates per
    one-way delivery — the price axis); ``failure_p99_budget`` bounds p99
    ``delivery_failure_rate`` (fraction of sends dropped).  Budgets are
    inclusive: equality passes.
    """

    latency_p99_budget: float = 50.0
    failure_p99_budget: float = 0.35
    burn_window: int = 5
    burn_threshold: float = 0.5

    def __post_init__(self):
        # ValueError (not assert) so the checks survive ``python -O``
        if not self.latency_p99_budget > 0:
            raise ValueError(
                f"latency_p99_budget must be > 0, got "
                f"{self.latency_p99_budget}")
        if not 0 <= self.failure_p99_budget <= 1:
            raise ValueError(
                f"failure_p99_budget must be in [0, 1], got "
                f"{self.failure_p99_budget}")
        if self.burn_window < 1:
            raise ValueError(
                f"burn_window must be >= 1, got {self.burn_window}")
        if not 0 <= self.burn_threshold <= 1:
            raise ValueError(
                f"burn_threshold must be in [0, 1], got "
                f"{self.burn_threshold}")


def _p99(row: dict, metric: str) -> Optional[float]:
    summary = row["qos"].get(metric, {})
    v = summary.get("p99")
    if v is None:
        # fall back to the widest tail the aggregation carried
        v = summary.get("p95")
    return v


def evaluate_timeseries(rows: List[dict], policy: SloPolicy) -> dict:
    """Render one SLO verdict per timeseries row.

    ``rows`` are :func:`~repro_torch.core.qos.aggregate_timeseries` rows
    (aggregated with a percentile set that includes 99; p95 is accepted as
    a fallback tail).  Returns::

        {"verdicts": [...], "summary": {...}}

    with one verdict dict per interval — ``verdict`` is ``"ok"``,
    ``"breach"`` (with the offending metrics in ``breached``), or
    ``"no_data"`` — and a run-level summary (breach/no-data counts, the
    worst burn rate, and ``ok: bool`` meaning zero breached slices).
    ``complete`` is carried through from the row so partial final
    intervals stay marked, not trusted (see ``aggregate_timeseries``).
    """
    verdicts = []
    recent: List[int] = []
    max_burn = 0.0
    for row in rows:
        lat = _p99(row, "simstep_latency")
        fail = _p99(row, "delivery_failure_rate")
        breached = []
        if lat is None and fail is None:
            verdict = "no_data"
        else:
            if lat is not None and lat > policy.latency_p99_budget:
                breached.append("simstep_latency")
            if fail is not None and fail > policy.failure_p99_budget:
                breached.append("delivery_failure_rate")
            verdict = "breach" if breached else "ok"
            recent.append(1 if breached else 0)
            if len(recent) > policy.burn_window:
                recent.pop(0)
        burn = (sum(recent) / len(recent)) if recent else 0.0
        max_burn = max(max_burn, burn)
        verdicts.append({
            "interval": row["interval"],
            "t_start": row["t_start"],
            "t_end": row["t_end"],
            "complete": row.get("complete", True),
            "metrics": {"simstep_latency_p99": lat,
                        "delivery_failure_rate_p99": fail},
            "breached": breached,
            "verdict": verdict,
            "burn_rate": burn,
            "burning": burn > policy.burn_threshold,
        })
    n_breach = sum(v["verdict"] == "breach" for v in verdicts)
    n_nodata = sum(v["verdict"] == "no_data" for v in verdicts)
    summary = {
        "intervals": len(verdicts),
        "breaches": n_breach,
        "no_data": n_nodata,
        "max_burn_rate": max_burn,
        "burning_intervals": sum(v["burning"] for v in verdicts),
        "ok": n_breach == 0,
    }
    return {"verdicts": verdicts, "summary": summary}
