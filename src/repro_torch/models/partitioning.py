"""Sharding roles and constraint helpers.

The torch counterpart of the reference's ``models/partitioning.py``.  The
model code of the reference annotates activations with *logical* axis
roles ("dp", "tp", "sp") rather than mesh axis names; a ``MeshRules``
context maps the roles to mesh axes.

Roles:
  dp  — data-parallel axes (batch dim); ("pod", "data") on the production mesh
  tp  — tensor-parallel axis (heads / ffn / experts / vocab); "model"
  sp  — sequence-parallel axis for the residual stream; aliases "model"

Outside a rules context, and for a plain tensor within one, ``constrain``
and ``constrain_spec`` return their input unchanged, so every one-process
path is bitwise what it was.  Under rules, a ``DTensor`` (a tensor laid
over a ``torch.distributed`` ``DeviceMesh``, ``launch/mesh.py``'s
``device_mesh``) is redistributed to the spec's placements, as
``with_sharding_constraint`` constrains the reference's array: a mesh dim
gets ``Shard(d)`` where tensor dim ``d`` names its axis and ``Replicate()``
elsewhere (:func:`placements`).  The rules resolve roles into specs
(``P``, a tuple of mesh axes per dimension, the reference's
``PartitionSpec`` entry for entry), which the spec rules of
``launch/sharding.py`` and ``launch/serve.py`` produce.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence, Union

import torch

_state = threading.local()


def _entry(d):
    """A spec entry as ``PartitionSpec`` normalizes it: a list is a tuple,
    a tuple of one axis is that axis, an empty one is None."""
    if isinstance(d, list):
        d = tuple(d)
    if isinstance(d, tuple) and len(d) <= 1:
        return d[0] if d else None
    return d


class P(tuple):
    """A partition spec: one entry per tensor dimension, each None (not
    sharded), a mesh axis name, or a tuple of them."""

    def __new__(cls, *dims):
        return super().__new__(cls, tuple(_entry(d) for d in dims))

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


class MeshRules:
    def __init__(self, mesh, dp: Sequence[str], tp: Optional[str],
                 sp=None):
        self.mesh = mesh
        self.roles = {
            "dp": tuple(dp),
            "tp": tp,
            "sp": sp if sp is not None else tp,
        }

    def resolve(self, dim) -> Union[None, str, tuple]:
        if dim is None:
            return None
        if isinstance(dim, tuple):  # compound role, e.g. ("dp", "sp")
            out = []
            for d in dim:
                r = self.resolve(d)
                if r is None:
                    continue
                out.extend(r if isinstance(r, tuple) else (r,))
            return tuple(out) if out else None
        return self.roles.get(dim, dim)

    def spec(self, *dims) -> P:
        return P(*[self.resolve(d) for d in dims])


def active() -> Optional[MeshRules]:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Optional[MeshRules]):
    prev = getattr(_state, "rules", None)
    _state.rules = rules
    try:
        yield rules
    finally:
        _state.rules = prev


def placements(spec, dmesh, shape=None) -> tuple:
    """The DTensor placements of spec ``spec`` (a ``P``, one entry per
    tensor dim) on ``dmesh``: mesh dim ``m`` gets ``Shard(d)`` where tensor
    dim ``d``'s entry names ``m``'s axis, ``Replicate()`` where no entry
    does.  An entry of several axes (``("pod", "data")``) shards its dim
    over each of them, major to minor in the spec's order, as XLA tiles
    it; that order must be the mesh's (DTensor shards a dim over several
    mesh dims in mesh order), and an axis the mesh lacks raises.  Given
    the tensor's ``shape``, an entry keeps only its longest leading run of
    axes whose devices divide the dim (XLA would pad the dim instead; a
    block of the port is never padded or empty)."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(dmesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec!r} names axis {a!r}, which "
                                 f"the mesh {names} lacks")
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec!r} tiles dim {d} over {axes}, "
                             f"not in the mesh's order {names}")
        ways = 1
        for m in idx:
            ways *= dmesh.size(m)
            if shape is not None and shape[d] % ways:
                break
            out[m] = Shard(d)
    return tuple(out)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``torch.distributed.tensor.DTensor`` (a plain
    tensor is told apart without importing it)."""
    if type(x) is torch.Tensor or not isinstance(x, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def redistribute(x, target: tuple):
    """``x`` redistributed to ``target`` placements on its own mesh, or
    ``x`` itself where it has them already."""
    if tuple(x.placements) == tuple(target):
        return x
    return x.redistribute(x.device_mesh, target)


def unshard_dim(x, dim: int):
    """``x`` with tensor dim ``dim`` whole on every device: a DTensor that
    shards it is redistributed (the mesh dims that split it replicated),
    anything else is returned as it is (the layer stack's period dim
    before the layers are read from it; a vocabulary before its argmax)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    dim = dim % x.ndim
    return redistribute(x, tuple(Replicate() if p.is_shard() and p.dim == dim
                                 else p for p in x.placements))


def split_dim(x, dim: int, sizes):
    """``x`` with dim ``dim`` split into ``sizes`` (a reshape).  A DTensor
    that shards the dim over more devices than the first size divides
    (12 heads over 16) has it replicated first, where XLA would pad it;
    DTensor splits a dim only along whole leading blocks."""
    dim = dim % x.ndim
    if is_dtensor(x):
        ways = 1
        for m, p in enumerate(x.placements):
            if p.is_shard() and p.dim == dim:
                ways *= x.device_mesh.size(m)
        if sizes[0] % ways:
            x = unshard_dim(x, dim)
    return x.reshape(*x.shape[:dim], *sizes, *x.shape[dim + 1:])


def merge_dims(x, start: int, shape):
    """``x`` with its dims from ``start`` on merged into one (a reshape to
    ``shape``).  A DTensor that shards any merged dim but the first has
    those dims made whole first: DTensor would carry the merge as a
    strided shard, whose redistributions it plans by a search that takes
    minutes on a 3-D mesh."""
    if is_dtensor(x):
        for d in range(start + 1, x.ndim):
            x = unshard_dim(x, d)
    return x.reshape(shape)


def fsdp_gather(w):
    """Weight ``w`` whole over every mesh dim but the active rules'
    tensor-parallel axis (the FSDP all-gather before a weight is used); a
    plain tensor, or no rules, as it is."""
    rules = active()
    if rules is None or not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate
    tp = rules.roles.get("tp")
    names = w.device_mesh.mesh_dim_names
    return redistribute(w, tuple(p if names[m] == tp else Replicate()
                                 for m, p in enumerate(w.placements)))


def settle(x):
    """``x`` with every pending reduction done: a DTensor's ``Partial``
    placements (a sum, or a gather's masked partial, not yet reduced over
    their mesh dims) become ``Replicate()``; anything else as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    return redistribute(x, tuple(Replicate() if p.is_partial() else p
                                 for p in x.placements))


def laid_like(x, ref):
    """``x`` laid out as ``ref`` is, pending sums done: a DTensor gradient
    resharded to its parameter's placements (a parameter's gradient is
    sharded as the parameter, as XLA shards it), a residual branch's
    output to the residual's; plain tensors as they are."""
    if not is_dtensor(x) or not is_dtensor(ref):
        return x
    from torch.distributed.tensor import Replicate
    return redistribute(x, tuple(Replicate() if p.is_partial() else p
                                 for p in ref.placements))


def constrain(x, *dims):
    """The reference's sharding constraint by logical roles: a DTensor is
    redistributed to the placements of ``rules.spec(*dims)`` on its mesh
    (for its shape: ``placements``); without rules, or for a plain
    tensor, ``x`` as it is."""
    rules = active()
    if rules is None or not is_dtensor(x):
        return x
    return redistribute(x, placements(rules.spec(*dims), x.device_mesh,
                                      x.shape))


def constrain_spec(x, spec):
    """The reference's constraint to an explicit spec (``None``: no
    constraint); a plain tensor, or no rules, as it is."""
    rules = active()
    if rules is None or spec is None or not is_dtensor(x):
        return x
    return redistribute(x, placements(spec, x.device_mesh, x.shape))
