"""The shard axis of the sharded engine and the one function that moves
data across it.

The torch counterpart of the reference's ``launch/mesh.py:28-48``
(``SHARD_AXIS``) with the offset hop the reference's sharded engine
calls inside ``shard_map`` (``lax.ppermute`` with ``perm = [(i, (i + off)
% S)]``).  Here every shard lives on one device: a tensor's leading
dimension of size S is the shard axis, so shard ``s``'s block is ``x[s]``.

The engine calls the hop through this module (``mesh.hop(...)``), so it
is the one seam a multi-card layout replaces with peer copies or NCCL.
The release reductions (the reference's pmin / pmax) need no seam while
every shard is on one device: they are the single-device reductions of
``runtime/window_core.py``.  The production meshes and ``rules_for``
belong to the GSPMD tools and are not ported here.
"""
from __future__ import annotations

import torch

#: name of the axis the sharded engine partitions the population over
SHARD_AXIS = "shard"


def hop(x: torch.Tensor, off: int) -> torch.Tensor:
    """Move every shard's block ``off`` shards along the axis: the result's
    block ``(i + off) % S`` is ``x[i]`` (a negative ``off`` is the reverse
    hop).  ``x``'s leading dimension is the shard axis."""
    return torch.roll(x, shifts=off, dims=0)
