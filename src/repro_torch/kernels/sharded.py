"""The kernels on a device mesh: each model-layout wrapper's entry through
``torch.distributed.tensor.experimental.local_map``.

The reference's kernels run inside XLA's SPMD program, which partitions
them like any other op.  Here a wrapper given ``DTensor`` inputs runs its
kernel once on every device's own block: the dims that may stay sharded
(``free``: batch, heads, inner channels; never a dim the kernel reduces
over or reads by position) keep the mesh dims the inputs shard them over,
every other dim is replicated first, and the kernel (or its plain version,
or its shape function) sees local tensors forward and backward.  So each
device's block is exactly what the kernel computes for those rows.

A layout is a string of letters, one per tensor dim, shared between the
inputs and outputs of one call: flash attention is q ``"bskgd"``, k and v
``"btkd"``, out ``"bskgd"`` with ``free = "bkg"``.  A product may keep its
contraction split (``summed``), its output then a pending sum.  The
loss's reductions over a split vocabulary (``logsumexp_last``,
``gather_last``) and the cache writes (``write_at``) work blockwise too.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

from repro_torch.models.partitioning import is_dtensor, redistribute


def any_dtensor(*tensors) -> bool:
    return any(is_dtensor(t) for t in tensors)


def plan(inputs: Sequence, layouts: Sequence[str], free: str):
    """{mesh dim: letter} of the dims that stay sharded: for each mesh
    dim, the first input that shards a free letter over it decides; a
    letter whose global size does not split evenly over its mesh dims is
    replicated."""
    mesh = next(t for t in inputs if is_dtensor(t)).device_mesh
    chosen = {}
    for m in range(mesh.ndim):
        for t, lay in zip(inputs, layouts):
            if not is_dtensor(t):
                continue
            p = t.placements[m]
            if p.is_shard() and lay[p.dim] in free:
                chosen[m] = lay[p.dim]
                break
    for letter in set(chosen.values()):
        ways = math.prod(mesh.size(m) for m, L in chosen.items()
                         if L == letter)
        sizes = {t.shape[lay.index(letter)] for t, lay in zip(inputs, layouts)
                 if t is not None and letter in lay}
        if any(n % ways for n in sizes):
            chosen = {m: L for m, L in chosen.items() if L != letter}
    return mesh, chosen


def summed_plan(inputs: Sequence, layouts: Sequence[str], letters: str,
                chosen: dict, mesh) -> dict:
    """{mesh dim: letter} of the contraction letters that stay split: on a
    mesh dim of more than one device that no free letter took, a letter of
    ``letters`` that every input holding it shards over that dim (evenly);
    each device then sums over its own block, and the outputs are pending
    sums (``Partial``) over those dims (a row-parallel product)."""
    out = {}
    for m in range(mesh.ndim):
        if m in chosen or mesh.size(m) == 1:
            continue
        for L in letters:
            held = [(t, lay) for t, lay in zip(inputs, layouts)
                    if t is not None and L in lay]
            if held and all(is_dtensor(t) and t.placements[m].is_shard()
                            and t.placements[m].dim == lay.index(L)
                            for t, lay in held):
                out[m] = L
                break
    for L in set(out.values()):
        ways = math.prod(mesh.size(m) for m, x in out.items() if x == L)
        if any(t.shape[lay.index(L)] % ways for t, lay in zip(inputs, layouts)
               if t is not None and L in lay):
            out = {m: x for m, x in out.items() if x != L}
    return out


def placements_of(layout: str, chosen: dict, ndim: int) -> tuple:
    """The placements of a tensor of ``layout`` under ``chosen``."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Shard(layout.index(chosen[m]))
                 if m in chosen and chosen[m] in layout else Replicate()
                 for m in range(ndim))


def grad_placements_of(layout: str, chosen: dict, ndim: int) -> tuple:
    """The placements of the gradient of an input of ``layout`` under
    ``chosen``: sharded as the input where it has the mesh dim's letter;
    a pending sum (``Partial``) over a mesh dim that splits a letter the
    input lacks (each device's gradient covers only its block of the
    other inputs: the batch rows for a weight, the query groups for k);
    replicated where the mesh dim splits nothing."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    return tuple(Shard(layout.index(chosen[m])) if chosen.get(m, "") in
                 layout and m in chosen else
                 Partial() if m in chosen else Replicate()
                 for m in range(ndim))


class _SettleGrad(torch.autograd.Function):
    """The identity, whose backward does the pending sums of the gradient
    (``partitioning.settle``) before the gradient meets the input's own
    redistribution: DTensor's backward of a redistribution takes a
    gradient in the redistribution's output placements."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.models.partitioning import settle
        return settle(g)


def settle_grad(x):
    """``x``, its gradient settled on the way back (``_SettleGrad``)."""
    return x if x is None else _SettleGrad.apply(x)


def as_dtensor(t, mesh):
    """A plain tensor as a replicated DTensor on ``mesh`` (every device
    holds it whole)."""
    if t is None or is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def on_mesh(fn: Callable, inputs: Sequence, layouts: Sequence[str],
            out_layouts, free: str, summed: str = ""):
    """``fn(*inputs)`` on every device's block of DTensor ``inputs``
    (``None`` passes through): the free letters keep their sharding, and
    the letters in ``summed`` (a contraction) theirs where
    ``summed_plan`` allows, the outputs then pending sums; every other dim
    is replicated (a redistribution, where the inputs shard it), and
    ``fn`` runs under ``local_map`` on the local tensors.
    ``out_layouts`` is one layout, or a tuple of them for a tuple of
    outputs.  Differentiable: an input's gradient comes back sharded as
    the input, or as a pending sum over the mesh dims that split a letter
    it lacks (``grad_placements_of``)."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    mesh, chosen = plan(inputs, layouts, free)
    inputs = [as_dtensor(t, mesh) for t in inputs]
    split = summed_plan(inputs, layouts, summed, chosen, mesh)
    kept = {**chosen, **split}
    ins = tuple(None if t is None else placements_of(lay, kept, mesh.ndim)
                for t, lay in zip(inputs, layouts))
    inputs = [t if t is None else settle_grad(redistribute(t, p))
              for t, p in zip(inputs, ins)]

    def out_of(lay):
        return [Partial() if m in split else p for m, p in
                enumerate(placements_of(lay, chosen, mesh.ndim))]

    # local_map reads a list as one output's placements, a tuple as one
    # entry an output
    if isinstance(out_layouts, str):
        outs = out_of(out_layouts)
    else:
        outs = tuple(out_of(lay) for lay in out_layouts)
    grads = tuple(None if t is None else
                  list(grad_placements_of(lay, kept, mesh.ndim))
                  for t, lay in zip(inputs, layouts))
    ins = tuple(None if p is None else list(p) for p in ins)
    return local_map(fn, out_placements=outs, in_placements=ins,
                     in_grad_placements=grads, device_mesh=mesh)(*inputs)


def local_block(shape, mesh, placements):
    """(shape, offset) of this rank's block of a tensor of global
    ``shape`` laid out by ``placements`` on ``mesh``: every ``Shard(d)``,
    in mesh-dim order, cuts the block's current extent along ``d`` into
    ``mesh.size(m)`` chunks of ``ceil(n / size)`` (the last ones shorter
    or empty), as DTensor cuts it.  Plain integers, so fake tensors do."""
    coord = mesh.get_coordinate()
    size, off = list(shape), [0] * len(shape)
    for m, p in enumerate(placements):
        if not p.is_shard():
            continue
        d, k, i = p.dim, mesh.size(m), coord[m]
        c = -(-size[d] // k)
        start = min(i * c, size[d])
        off[d] += start
        size[d] = max(0, min(c, size[d] - start))
    return tuple(size), tuple(off)


def local_offset(t, dim: int) -> int:
    """The global index of this device's first row of DTensor ``t`` along
    ``dim``."""
    return local_block(t.shape, t.device_mesh, t.placements)[1][dim]


def mesh_dims_sharding(t, dim: int) -> list:
    """The mesh dims DTensor ``t`` shards tensor dim ``dim`` over."""
    return [m for m, p in enumerate(t.placements)
            if p.is_shard() and p.dim == dim]


def write_at(dst: torch.Tensor, index: int, src: torch.Tensor,
             dim: int) -> None:
    """``dst.select(dim, index).copy_(src)``, in place.  For a DTensor
    ``dst`` the write is local: ``src`` (``dst``'s shape without ``dim``)
    is laid out as ``dst``'s other dims are, and only the device whose
    block along ``dim`` holds ``index`` writes it, so a cache whose
    sequence dim is split over the mesh is never gathered."""
    if not is_dtensor(dst):
        dst.select(dim, index).copy_(src.to(dst.dtype))
        return
    from torch.distributed.tensor import Replicate, Shard
    mesh = dst.device_mesh
    target = []
    for p in dst.placements:
        if p.is_shard() and p.dim == dim:
            target.append(Replicate())
        elif p.is_shard():
            target.append(Shard(p.dim - (p.dim > dim)))
        else:
            target.append(Replicate())
    src = redistribute(as_dtensor(src.to(dst.dtype), mesh), tuple(target))
    local = dst.to_local()
    at = index - local_offset(dst, dim)
    if 0 <= at < local.shape[dim]:
        local.select(dim, at).copy_(src.to_local())


def all_reduce_over(mesh, dims, t, op: str):
    """``t`` (a local tensor) all-reduced with ``op`` ("max", "sum") over
    each of ``mesh``'s dims in ``dims`` of more than one device, through
    the functional collectives (the ops the dry run counts)."""
    from torch.distributed import _functional_collectives as funcol
    for m in dims:
        if mesh.size(m) > 1:
            t = funcol.wait_tensor(funcol.all_reduce(t, op, (mesh, m)))
    return t


class _BlockLogSumExp(torch.autograd.Function):
    """``torch.logsumexp`` over the last dim of a tensor of which ``x`` is
    one device's block along that dim: ATen's own steps (the max, infinite
    maxima taken as 0, the sum of ``exp(x - max)``, its log plus the max)
    with the max and the sum all-reduced across the blocks by
    ``reduce(t, op)``, and ATen's backward, ``grad * exp(x - result)``, on
    the block."""

    @staticmethod
    def forward(ctx, x, reduce):
        m = reduce(x.amax(-1, keepdim=True), "max")
        m.masked_fill_(m.abs() == float("inf"), 0)
        out = reduce((x - m).exp().sum(-1), "sum").log().add_(m.squeeze(-1))
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return g.unsqueeze(-1) * (x - out.unsqueeze(-1)).exp(), None


def _even(x):
    """DTensor ``x`` settled, with every dim that does not split evenly
    over the mesh dims sharding it made whole (``local_map`` takes a
    block's global shape to be its own times the mesh dims' sizes)."""
    from repro_torch.models.partitioning import settle, unshard_dim
    x = settle(x)
    for d in range(x.ndim):
        ways = math.prod(x.device_mesh.size(m)
                         for m in mesh_dims_sharding(x, d))
        if x.shape[d] % ways:
            x = unshard_dim(x, d)
    return x


def _last_dim_plan(x):
    """For DTensor ``x``: (mesh, the mesh dims that split its last dim,
    the placements of a tensor of its leading dims laid out as x's)."""
    from torch.distributed.tensor import Replicate
    last = x.ndim - 1
    split = mesh_dims_sharding(x, last)
    lead = [Replicate() if m in split else p
            for m, p in enumerate(x.placements)]
    return x.device_mesh, split, lead


def logsumexp_last(x: torch.Tensor) -> torch.Tensor:
    """``torch.logsumexp(x, dim=-1)``.  For a DTensor whose last dim is
    split (the logits' vocabulary over "model") every device reduces its
    own block and the maxima and sums are all-reduced, as XLA partitions
    the reference's reduction; ``x`` is never gathered."""
    if not is_dtensor(x):
        return torch.logsumexp(x, dim=-1)
    from torch.distributed.tensor.experimental import local_map
    x = _even(x)
    mesh, split, lead = _last_dim_plan(x)

    def reduce(t, op):
        return all_reduce_over(mesh, split, t, op)

    def block(xl):
        if all(mesh.size(m) == 1 for m in split):
            return torch.logsumexp(xl, dim=-1)      # the whole last dim
        return _BlockLogSumExp.apply(xl, reduce)

    return local_map(block, out_placements=lead,
                     in_placements=(list(x.placements),),
                     in_grad_placements=(list(x.placements),),
                     device_mesh=mesh)(x)


def gather_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x.gather(-1, idx[..., None])[..., 0]`` (``idx`` in range).  For a
    DTensor whose last dim is split, every device gathers from its own
    block (zero where the index lies outside it) and the blocks' results
    are summed (a ``Partial``, settled), so neither ``x`` nor its
    gradient is ever whole on one device."""
    if not is_dtensor(x):
        return x.gather(-1, idx[..., None])[..., 0]
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.models.partitioning import settle
    x = _even(x)
    mesh, split, lead = _last_dim_plan(x)
    idx = redistribute(as_dtensor(idx, mesh), tuple(lead))
    lo = local_offset(x, x.ndim - 1)

    def block(xl, il):
        j = il - lo
        inside = (j >= 0) & (j < xl.shape[-1])
        g = xl.gather(-1, j.clamp(0, xl.shape[-1] - 1)[..., None])[..., 0]
        return torch.where(inside, g, torch.zeros_like(g))

    out = [Partial() if m in split else p for m, p in enumerate(lead)]
    return settle(local_map(block, out_placements=out,
                            in_placements=(list(x.placements), lead),
                            in_grad_placements=(list(x.placements), lead),
                            device_mesh=mesh)(x, idx))
