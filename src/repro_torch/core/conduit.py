"""SPMD Conduit: best-effort neighbor exchange over mesh axes.

The torch counterpart of the reference's ``core/conduit.py``, the paper's
Inlet/Outlet ducts in their in-graph form (DESIGN.md §2): channels are
double-buffered, so under ``BEST_EFFORT`` a fragment consumes the values
its neighbors sent on the *previous* step, and the exchange leaves the
critical path at the cost of one step of staleness.  Under
``BARRIER_EVERY_STEP`` the fresh values are consumed in-step (BSP).

The reference runs inside ``shard_map`` and moves values with
``lax.ppermute``.  Here every mesh axis is a tensor dimension
(``launch/mesh.py``): a conduit's payloads carry the devices' blocks, its
axis is dimension ``dim`` of them, and the exchange is ``mesh.hop`` along
it: a roll in one process, or, for a conduit with a ``group`` (the leading
mesh axis split over ``torch.distributed`` ranks), a hop that sends the
blocks leaving this rank to their peers.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.modes import AsyncMode
from repro_torch.launch import mesh


def ring_perm(n: int, shift: int):
    return [(i, (i + shift) % n) for i in range(n)]


def axis_size(x: torch.Tensor, dim: int) -> int:
    """The size of the mesh axis that is dimension ``dim`` of ``x``."""
    return x.shape[dim]


def ring_exchange(x: torch.Tensor, dim: int = 0, shift: int = 1,
                  group: Optional[mesh.RankGroup] = None) -> torch.Tensor:
    """Rotate ``x`` around the ring along dimension ``dim``: device i
    receives device (i - shift)'s value (i.e. values travel ``shift``
    steps forward), ``torch.roll(x, shift, dim)``; over the ranks of
    ``group``, this rank's blocks of that roll."""
    return mesh.hop(x, shift, dim, group=group)


@dataclasses.dataclass(frozen=True)
class Conduit:
    """Best-effort channel over one mesh axis (ring topology).

    ``directions`` maps a name to a ring shift, e.g. {"fwd": +1, "bwd": -1};
    ``dim`` is the tensor dimension that holds the axis ``axis_name`` in
    every payload; ``group``, where given, the ranks that axis is split
    over (payloads then hold this rank's blocks).  State (the staleness
    buffers) is a dict of tensors the caller threads through its step
    loop.
    """

    axis_name: str
    directions: Dict[str, int]
    mode: AsyncMode = AsyncMode.BEST_EFFORT
    dim: int = 0
    group: Optional[mesh.RankGroup] = None

    def init_buffers(self, example: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {d: torch.zeros_like(example) for d in self.directions}

    def exchange(self, value, buffers, *, flush=None) -> Tuple[dict, dict]:
        """One communication phase.

        value: every device's payload to publish to its neighbors.
        buffers: previously received payloads (from ``init_buffers``/last call).
        flush: bool or bool tensor — modes 1/2 consume fresh values when set.

        Returns (received, new_buffers): what each fragment should consume
        now, and the buffers to carry forward.
        """
        if self.mode == AsyncMode.NO_COMM:
            return buffers, buffers

        # every direction's hop in one exchange
        fresh = dict(zip(self.directions, mesh.hops(
            [(value, s) for s in self.directions.values()], self.dim,
            self.group)))

        if self.mode == AsyncMode.BARRIER_EVERY_STEP:
            return fresh, fresh
        if self.mode == AsyncMode.BEST_EFFORT:
            # consume stale, publish fresh: the hop's consumer is the next
            # step
            return buffers, fresh
        # rolling / fixed barrier: stale between barriers, fresh at barriers
        assert flush is not None, "modes 1/2 need a flush predicate"
        flush = torch.as_tensor(flush, device=value.device)
        received = {d: torch.where(flush, fresh[d], buffers[d])
                    for d in fresh}
        return received, fresh


def torus_conduits(axis_names: Tuple[str, str], mode: AsyncMode,
                   group: Optional[mesh.RankGroup] = None):
    """N/S/E/W conduits for a 2-D toroidal fragment grid, its rows
    dimension 0 and its columns dimension 1 of every payload; ``group``
    the ranks the rows are split over (``None``: one process).

    ``received["north"]`` is the payload of the neighbor one row up
    (device i-1 along the row axis => shift +1), etc.
    """
    row = Conduit(axis_names[0], {"north": +1, "south": -1}, mode, dim=0,
                  group=group)
    col = Conduit(axis_names[1], {"west": +1, "east": -1}, mode, dim=1)
    return row, col
