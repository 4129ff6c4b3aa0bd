"""Sharding roles and constraint helpers.

The torch counterpart of the reference's ``models/partitioning.py``.  The
model code of the reference annotates activations with *logical* axis
roles ("dp", "tp", "sp") rather than mesh axis names; a ``MeshRules``
context maps the roles to mesh axes.

Roles:
  dp  — data-parallel axes (batch dim); ("pod", "data") on the production mesh
  tp  — tensor-parallel axis (heads / ffn / experts / vocab); "model"
  sp  — sequence-parallel axis for the residual stream; aliases "model"

Every mesh axis of the port lives on one card (``launch/mesh.py``), so
there is no layout to constrain: ``constrain`` and ``constrain_spec``
return their input unchanged, with rules or without.  The rules still
resolve roles into specs (``P``, a tuple of mesh axes per dimension, the
reference's ``PartitionSpec`` entry for entry), which the spec rules of
``launch/sharding.py`` and ``launch/serve.py`` produce.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence, Union

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


def constrain(x, *dims):
    """The reference's sharding constraint by logical roles.  Every mesh
    axis is on one card, so there is no layout to constrain: ``x`` is
    returned as it is."""
    return x


def constrain_spec(x, spec):
    """The reference's constraint to an explicit spec; ``x`` as it is, for
    the reason ``constrain`` gives."""
    return x
