"""Meshes, the logical-axis rules, and the one function that moves data
along a mesh axis.

The torch counterpart of the reference's ``launch/mesh.py``.  Every mesh
axis lives on one device here: a tensor's leading dimension of the axis's
size is the axis, so device ``i``'s block along it is ``x[i]``.  ``hop``
moves blocks along such a dimension (``torch.roll``) where the reference
calls ``lax.ppermute`` inside ``shard_map`` with ``perm = [(i, (i + off)
% S)]``: the sharded engine hops along the shard axis (dimension 0), the
conduits of ``core/conduit.py`` along a mesh axis of their own.  Callers
reach it through this module (``mesh.hop(...)``), so it is the one seam a
multi-card layout replaces with peer copies or NCCL.  The release
reductions (the reference's pmin / pmax) need no seam while every shard
is on one device: they are the single-device reductions of
``runtime/window_core.py``.

The production meshes are shapes only (``Mesh``: ``.shape``,
``.axis_names``): with every axis on one card they place nothing, and
``rules_for`` and the spec rules of ``launch/sharding.py`` read only the
axis sizes.  ``make_shard_mesh`` and the ``shard_map`` wrapper have no
one-card counterpart.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from repro_torch.models.partitioning import MeshRules


class Mesh:
    """A device mesh as its axes' sizes: ``shape`` {axis: size} in axis
    order and ``axis_names``, what ``jax.sharding.Mesh`` gives the spec
    rules."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        assert len(shape) == len(axis_names), (shape, axis_names)
        self.shape: Dict[str, int] = dict(zip(axis_names, shape))
        self.axis_names: Tuple[str, ...] = tuple(axis_names)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: (16, 16) over ("data", "model"), 256 chips.  Multi-pod:
    (2, 16, 16) over ("pod", "data", "model"), 512 chips; the "pod" axis
    is the best-effort boundary."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_debug_mesh(shape=(2, 2), axes=("data", "model")) -> Mesh:
    """A small mesh for tests."""
    return Mesh(shape, axes)


#: name of the axis the sharded engine partitions the population over
SHARD_AXIS = "shard"


def hop(x: torch.Tensor, off: int, dim: int = 0) -> torch.Tensor:
    """Move every block ``off`` places along the mesh axis that is
    dimension ``dim`` of ``x``: the result's block ``(i + off) % S`` is
    block ``i`` of ``x`` (a negative ``off`` is the reverse hop)."""
    return torch.roll(x, shifts=off, dims=dim)


def rules_for(mesh, *, long_context: bool = False,
              pod_stacked: bool = False, profile: str = "2d") -> MeshRules:
    """Logical-role mapping for a mesh.

    long_context: batch=1 decode — every axis goes to the KV-cache sequence
    dim ("sp"), nothing to batch ("dp").
    pod_stacked: train state carries an explicit leading pod dim, so the
    FSDP role must exclude "pod" (it shards the stack dim instead).
    profile: "2d" (FSDP x TP) or "dp_only" (pure DP, params replicated).
    """
    names = mesh.axis_names
    if profile == "dp_only":
        dp = tuple(n for n in names if n != "pod" or not pod_stacked)
        if pod_stacked:
            dp = tuple(n for n in names if n != "pod")
        if long_context:
            return MeshRules(mesh, dp=(), tp=None, sp=tuple(names))
        return MeshRules(mesh, dp=dp, tp=None, sp=None)
    dp = tuple(n for n in names if n in ("pod", "data"))
    if pod_stacked:
        dp = tuple(n for n in dp if n != "pod")
    tp = "model" if "model" in names else None
    if long_context:
        return MeshRules(mesh, dp=(), tp=tp, sp=tuple(names))
    return MeshRules(mesh, dp=dp, tp=tp, sp=tp)


def pod_count(mesh) -> int:
    return mesh.shape.get("pod", 1)
