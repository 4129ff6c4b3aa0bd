"""Parameter/state partition-spec rules: FSDP over data axes × TP/EP over
the model axis, with replication on indivisible dims.

The torch counterpart of the reference's ``launch/sharding.py``.  The
rules run over the port's ``{path: tensor}`` trees (``stack/0/mixer/wq``,
as ``lm.init_params`` and ``lm.abstract_params`` give them) and read
shapes only, so meta tensors serve as well as real ones.  A
:class:`Sharding` (a spec on a ``DeviceMesh``, ``launch/mesh.py``'s
``device_mesh``) is the counterpart of ``NamedSharding``: its placements
(``partitioning.placements``) and ``place``, which lays a whole tensor
over the mesh as a ``DTensor`` (``kernels.sharded.local_block`` gives one
device's block).
"""
from __future__ import annotations

import torch

from repro_torch.models.partitioning import P, placements

# rules keyed by parameter name: logical spec for the UNSCANNED shape.
# "dp" = fsdp axes, "tp" = model axis, None = replicated.
_RULES = {
    # embeddings
    "embed": ("tp", "dp"),
    "unembed": ("tp", "dp"),
    "final_norm": (None,),
    # attention
    "wq": ("dp", "tp"), "wk": ("dp", "tp"), "wv": ("dp", "tp"),
    "wo": ("tp", "dp"),
    "bq": ("tp",), "bk": ("tp",), "bv": ("tp",),
    "q_norm": (None,), "k_norm": (None,), "out_norm": (None,),
    "mixer_norm": (None,), "ffn_norm": (None,),
    # dense mlp / shared expert
    "gate": ("dp", "tp"), "up": ("dp", "tp"), "down": ("tp", "dp"),
    # moe (expert-stacked 3-D weights; expert dim -> EP over model axis)
    "router": ("dp", None),
    "gate3": ("tp", "dp", None), "up3": ("tp", "dp", None),
    "down3": ("tp", "dp", None),
    # mamba
    "in_proj": ("dp", "tp"), "conv_w": (None, "tp"), "conv_b": ("tp",),
    "x_proj": ("tp", None), "dt_proj": (None, "tp"), "dt_bias": ("tp",),
    "A_log": ("tp", None), "D": ("tp",), "out_proj": ("tp", "dp"),
    # xlstm
    "up_proj": ("dp", "tp"), "down_proj": ("tp", "dp"),
    "w_if": ("tp", None), "b_if": (None,),
    "w": ("dp", "tp"), "r": (None, None, None, "tp"), "b": (None,),
}


def _logical_spec(path_names, shape) -> tuple:
    name = path_names[-1]
    if name in ("gate", "up", "down") and len(shape) >= 3 and "ffn" in path_names:
        # expert-stacked MoE weight (possibly with a leading scan dim)
        base = _RULES[name + "3"]
    elif name in _RULES:
        base = _RULES[name]
    else:
        base = (None,) * len(shape)
    # leading scan (period) dim -> None
    pad = len(shape) - len(base)
    assert pad >= 0, (path_names, shape, base)
    return (None,) * pad + tuple(base)


def _divisible(dim_size: int, axes, mesh) -> bool:
    if axes is None:
        return True
    axes = axes if isinstance(axes, tuple) else (axes,)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return dim_size % n == 0


def resolve_spec(shape, logical, rules) -> P:
    """The roles of ``logical`` resolved on ``rules``' mesh, a dimension
    left unsharded where its size does not divide by its axes'."""
    resolved = []
    for dim, role in zip(shape, logical):
        axes = rules.resolve(role)
        resolved.append(axes if _divisible(dim, axes, rules.mesh) else None)
    return P(*resolved)


def param_specs(params_like, rules):
    """{path: P} for the port's ``{path: tensor}`` parameters (any
    device, meta too; only shapes are read)."""
    return {path: resolve_spec(leaf.shape,
                               _logical_spec(path.split("/"), leaf.shape),
                               rules)
            for path, leaf in params_like.items()}


def with_pod_dim(spec_tree):
    """Prepend a "pod" axis to every spec (pod-stacked train state)."""
    if isinstance(spec_tree, P):
        return P("pod", *spec_tree)
    if isinstance(spec_tree, dict):
        return {k: with_pod_dim(v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, (list, tuple)):
        return type(spec_tree)(with_pod_dim(v) for v in spec_tree)
    return spec_tree


def strip_axis(spec_tree, axis: str = "pod"):
    """Every spec of ``spec_tree`` with ``axis`` taken out (the pod dim of
    a pod-stacked leaf, which the pod group splits instead of the mesh:
    the leaf lives on the ("data", "model") submesh)."""
    def strip(entry):
        if isinstance(entry, tuple):
            rest = tuple(a for a in entry if a != axis)
            return rest or None
        return None if entry == axis else entry
    if isinstance(spec_tree, P):
        return P(*(strip(e) for e in spec_tree))
    if isinstance(spec_tree, dict):
        return {k: strip_axis(v, axis) for k, v in spec_tree.items()}
    if isinstance(spec_tree, (list, tuple)):
        return type(spec_tree)(strip_axis(v, axis) for v in spec_tree)
    return spec_tree


class Sharding:
    """A spec laid on a ``DeviceMesh``: the counterpart of
    ``NamedSharding(mesh, spec)``."""

    def __init__(self, dmesh, spec: P):
        self.mesh = dmesh
        self.spec = P(*spec)
        self.placements = placements(self.spec, dmesh)

    def __repr__(self) -> str:
        return f"Sharding({self.spec!r}, {self.placements})"

    def place(self, t: torch.Tensor):
        """``t``, which every rank holds whole (made from one seed, or a
        fake tensor), as a DTensor of these placements: each rank keeps
        its own block, no collective runs.  A DTensor is redistributed to
        them."""
        from torch.distributed.tensor import DTensor

        from repro_torch.models.partitioning import is_dtensor, redistribute
        if is_dtensor(t):
            return redistribute(t, self.placements)

        from repro_torch.kernels.sharded import local_block
        shape, offset = local_block(t.shape, self.mesh, self.placements)
        local = t
        for d, (n, o) in enumerate(zip(shape, offset)):
            if n != t.shape[d]:
                local = local.narrow(d, o, n)
        if local is not t:
            local = local.contiguous().clone()
        return DTensor.from_local(local, self.mesh, self.placements,
                                  run_check=False, shape=t.shape,
                                  stride=t.stride())


def param_shardings(params_like, rules, dmesh):
    """{path: Sharding} of ``param_specs`` on ``dmesh`` (the reference's
    ``param_shardings``, whose mesh is the rules')."""
    return shardings_from_specs(param_specs(params_like, rules), dmesh)


def shardings_from_specs(spec_tree, dmesh):
    """Every spec of ``spec_tree`` (dicts, lists, tuples of ``P``) as a
    :class:`Sharding` on ``dmesh``."""
    if isinstance(spec_tree, P):
        return Sharding(dmesh, spec_tree)
    if isinstance(spec_tree, dict):
        return {k: shardings_from_specs(v, dmesh)
                for k, v in spec_tree.items()}
    if isinstance(spec_tree, (list, tuple)):
        return type(spec_tree)(shardings_from_specs(v, dmesh)
                               for v in spec_tree)
    raise TypeError(f"not a spec tree: {spec_tree!r}")


def place(tree, shardings):
    """Every tensor of ``tree`` placed by the :class:`Sharding` at the
    same place of ``shardings`` (``Sharding.place``)."""
    if isinstance(tree, dict):
        return {k: place(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(place(v, s) for v, s in zip(tree, shardings))
    return shardings.place(tree)
