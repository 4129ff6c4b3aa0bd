"""Asynchronicity modes (paper Table I), mapped to the TPU pod axis.

The paper's "CPUs" map to pods: cross-pod communication is the expensive,
jitter-exposed link (DESIGN.md §2).  Intra-pod data/model parallelism always
remains synchronous — it is inside one SPMD program.
"""
from __future__ import annotations

import enum


class AsyncMode(enum.IntEnum):
    BARRIER_EVERY_STEP = 0   # full sync every update (BSP baseline)
    ROLLING_BARRIER = 1      # work K steps, then sync (rolling local-SGD)
    FIXED_BARRIER = 2        # sync at predetermined step boundaries
    BEST_EFFORT = 3          # no barrier: staleness-1 delayed exchange
    NO_COMM = 4              # no cross-pod communication at all

    @property
    def description(self) -> str:
        return {
            0: "Barrier sync every update",
            1: "Rolling barrier sync",
            2: "Fixed barrier sync",
            3: "No barrier sync (best-effort)",
            4: "No inter-pod communication",
        }[int(self)]


def sync_due(mode: AsyncMode, step, period: int):
    """Whether an outer (cross-pod) sync fires at ``step``.

    Works on both python ints and traced values.  Mode 1 counts steps since
    the last sync (rolling); mode 2 uses absolute step boundaries — the paper
    aligns mode 2 to epoch-time boundaries, which on a lockstep SPMD runtime
    degenerates to fixed step indices (the race the paper observed between
    differently-phased workers cannot occur in-graph; see DESIGN.md).
    """
    if mode == AsyncMode.BARRIER_EVERY_STEP:
        return step == step  # always true, shaped like step
    if mode in (AsyncMode.ROLLING_BARRIER, AsyncMode.FIXED_BARRIER):
        return (step % period) == (period - 1)
    return step != step  # never
