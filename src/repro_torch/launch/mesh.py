"""Meshes, the logical-axis rules, and the functions that move data
along a mesh axis.

The torch counterpart of the reference's ``launch/mesh.py``.  A mesh axis
is a tensor dimension: a tensor's dimension of the axis's size holds its
blocks, so device ``i``'s block along it is ``x[i]``.  ``hop`` moves blocks
along such a dimension where the reference calls ``lax.ppermute`` inside
``shard_map`` with ``perm = [(i, (i + off) % S)]``: the sharded engine hops
along the shard axis, the conduits of ``core/conduit.py`` along a mesh
axis of their own.  Callers reach it through this module (``mesh.hop(...)``),
so it is the one seam between the layouts:

* one process (``group=None``): every block is on one device and ``hop``
  is ``torch.roll``; the release reductions (the reference's pmin / pmax)
  are the single-device ones of ``runtime/window_core.py``;
* ranks (a :class:`RankGroup`, made by :func:`make_shard_mesh`): the
  leading mesh axis is split over ``torch.distributed`` ranks, each rank
  holding a contiguous run of ``per`` blocks, and ``hop`` sends the blocks
  that leave the rank to their peers (one ``dist.batch_isend_irecv`` a hop,
  one contiguous buffer a peer; ``hops`` moves several hops in one such
  exchange).  ``RankGroup.all_reduce`` and
  ``all_gather`` are the other collectives the port issues over ranks.
  Training's pod axis splits over the ranks the same way
  (``make_shard_mesh(n_pods, backend)``): each rank holds ``per`` pods of
  the pod-stacked train state, and the cross-pod reductions of
  ``core/collectives.py`` all-gather the pods.

The backend is the caller's choice and nothing falls back: ``nccl`` puts
one rank on each card (``cuda:{local_rank}``) and moves device buffers;
``gloo`` runs on the CPU, or with several ranks sharing one card, and then
stages every CUDA buffer through pinned host memory explicitly (gloo's
send and receive take host tensors), from a pool of pinned buffers kept
by size, dtype and role, so a training step that gathers every leaf pins
no fresh memory.  A failed send, receive or reduction raises.

The production meshes are shapes (``Mesh``: ``.shape``,
``.axis_names``): ``rules_for`` and the spec rules of
``launch/sharding.py`` read only the axis sizes.  :func:`device_mesh` lays
such a mesh over the ranks of a process group as a
``torch.distributed`` ``DeviceMesh`` with its shape and axis names, the
counterpart of ``jax.sharding.Mesh`` over devices: the LM step runs on it
with every leaf a ``DTensor`` (``launch/sharding.py``), over NCCL ranks on
cards, gloo ranks on the CPU, or the ``fake`` backend, whose collectives
do nothing, for the dry run (``launch/dryrun.py``).  The reference's
``shard_map`` has its counterpart in ``local_map``
(``kernels/sharded.py``); the sharded engine's ranks run their bodies on
their own blocks and call these collectives themselves.
"""
from __future__ import annotations

import math
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

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


def device_mesh(mesh: Mesh, pg=None):
    """``mesh`` laid over the ranks of ``pg`` (``None``: the default
    process group, which the caller has initialized) as a ``DeviceMesh``
    with its shape and axis names, ranks in row-major order.  NCCL ranks
    hold CUDA tensors; gloo ranks and the ``fake`` backend's (the dry
    run's: one process standing for every rank, whose collectives move
    nothing) hold CPU ones, which the dry run's fake tensors are."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("device_mesh needs an initialized "
                           "torch.distributed process group")
    shape = tuple(mesh.shape.values())
    n = math.prod(shape)
    world = dist.get_world_size(pg)
    if world != n:
        raise ValueError(f"a mesh of {shape} over {mesh.axis_names} needs "
                         f"{n} ranks; the group has {world}")
    backend = dist.get_backend(pg)
    kind = "cuda" if backend == "nccl" else "cpu"
    ranks = torch.arange(n)
    if pg is not None:
        ranks = torch.tensor(dist.get_process_group_ranks(pg))
    return DeviceMesh(kind, ranks.reshape(shape),
                      mesh_dim_names=mesh.axis_names)


def init_fake_group(world_size: int, rank: int = 0) -> None:
    """The ``fake`` backend's default group of ``world_size`` ranks in this
    one process, as rank ``rank``: collectives return at once and move
    nothing, so a ``DeviceMesh`` of hundreds of ranks costs nothing (the
    dry run's stand-in for the reference's forced host devices).  A
    default group that is there already is destroyed first."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)


def pod_group(dmesh, n_pods: int) -> "RankGroup":
    """The pod axis of ``dmesh`` (a ``DeviceMesh`` with a ``"pod"`` dim)
    as the :class:`RankGroup` training's pods split over: this rank's
    pods stay local, and the cross-pod reductions of
    ``core/collectives.py`` run over the pod dim's subgroup (the ranks
    that share this rank's data and model coordinates)."""
    import torch.distributed as dist
    pg = dmesh["pod"].get_group()
    backend = dist.get_backend(pg)
    # the fake backend's ranks (the dry run's) hold meta tensors
    device = (torch.device("cuda", torch.cuda.current_device())
              if backend == "nccl" else
              torch.device("meta") if backend == "fake" else
              torch.device("cpu"))
    size = dist.get_world_size(pg)
    if n_pods % size:
        raise ValueError(f"{n_pods} pods do not split over the pod axis's "
                         f"{size} ranks")
    return RankGroup(pg, backend, n_pods, device, dist.get_rank(pg), size)


#: name of the axis the sharded engine partitions the population over
SHARD_AXIS = "shard"


class RankGroup:
    """The ranks that the leading mesh axis of ``blocks`` blocks is split
    over: rank ``r`` holds blocks ``[r * per, (r + 1) * per)``, every
    other axis whole.

    ``pg`` is the ``torch.distributed`` process group (``None``: the
    default group), ``backend`` its backend, ``device`` where this rank's
    blocks live.  ``stats`` counts what the collectives did: ``hops``, the
    ``exchanges`` that moved them, ``hop_bytes`` sent to peers, ``hop_s``
    of host time in them; ``all_reduces``, ``all_reduce_bytes`` this rank
    sent and ``all_reduce_s`` of host time in them; ``all_gathers``,
    ``all_gather_bytes`` this rank sent and ``all_gather_s``.  With
    ``time_device`` set on a CUDA rank, :meth:`hop_device_ms` gives the
    card's own time in the hops.
    """

    def __init__(self, pg, backend: str, blocks: int, device: torch.device,
                 rank: int, size: int):
        self.pg = pg
        self.backend = backend
        self.blocks = int(blocks)
        self.rank = int(rank)
        self.size = int(size)
        self.per = self.blocks // self.size
        #: this rank's first block
        self.lo = self.rank * self.per
        self.device = device
        self.time_device = False
        self._events: List[tuple] = []
        self._plans: Dict[tuple, tuple] = {}
        #: pinned staging buffers {(numel, dtype, role): buffer}
        self._pool: Dict[tuple, torch.Tensor] = {}
        #: {buffer's data_ptr: event after the copy to the card that reads
        #: it}: the buffer is free once the event has passed
        self._fences: Dict[int, torch.cuda.Event] = {}
        self.reset_stats()

    def reset_stats(self) -> None:
        self.stats = dict(hops=0, exchanges=0, hop_bytes=0, hop_s=0.0,
                          all_reduces=0, all_reduce_bytes=0,
                          all_reduce_s=0.0, all_gathers=0,
                          all_gather_bytes=0, all_gather_s=0.0)
        self._events = []

    @property
    def staged(self) -> bool:
        """Whether buffers cross through host memory: gloo with the
        blocks on a card."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def _peer(self, q: int) -> int:
        import torch.distributed as dist
        return q if self.pg is None else dist.get_global_rank(self.pg, q)

    # -- host staging ---------------------------------------------------
    def _pinned(self, shape, dtype, role: str) -> torch.Tensor:
        """A pinned host buffer of ``shape`` from the pool: one buffer a
        (size, dtype, role), taken again once the copy to the card that
        last read it has finished."""
        numel = math.prod(shape)
        key = (numel, dtype, role)
        buf = self._pool.get(key)
        if buf is None:
            buf = self._pool[key] = torch.empty(numel, dtype=dtype,
                                                pin_memory=True)
        fence = self._fences.pop(buf.data_ptr(), None)
        if fence is not None:
            fence.synchronize()
        return buf.view(shape)

    def _out(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as the backend sends it: bool as uint8, and on a staged
        rank in pinned host memory."""
        if x.dtype == torch.bool:
            x = x.view(torch.uint8)
        if self.staged:
            h = self._pinned(x.shape, x.dtype, "out")
            h.copy_(x)
            return h
        return x.contiguous()

    def _buffer(self, shape, dtype) -> torch.Tensor:
        if dtype == torch.bool:
            dtype = torch.uint8
        if self.staged:
            return self._pinned(shape, dtype, "in")
        return torch.empty(shape, dtype=dtype, device=self.device)

    def _back(self, h: torch.Tensor, dtype) -> torch.Tensor:
        if self.staged:
            x = h.to(self.device, non_blocking=True)
            fence = torch.cuda.Event()
            fence.record()
            self._fences[h.data_ptr()] = fence
        else:
            x = h
        return x.view(torch.bool) if dtype == torch.bool else x

    # -- the collectives ------------------------------------------------
    def _hop_plan(self, off: int, device) -> tuple:
        """Which local block goes where for a hop by ``off``: ``(local,
        sends, recvs)``.  ``local`` is (source, destination) index tensors
        of the blocks that stay on this rank; ``sends`` {peer: indices of
        the blocks it gets}, ascending; ``recvs`` {peer: destination
        indices of its blocks}, in the order it sends them (ascending
        global source block)."""
        key = (off % self.blocks, device)
        if key not in self._plans:
            S, per, lo = self.blocks, self.per, self.lo
            local: List[Tuple[int, int]] = []
            sends: Dict[int, List[int]] = {}
            recvs: Dict[int, List[Tuple[int, int]]] = {}
            for b in range(per):
                g = (lo + b + off) % S
                if g // per == self.rank:
                    local.append((b, g % per))
                else:
                    sends.setdefault(g // per, []).append(b)
            for d in range(per):
                g = (lo + d - off) % S
                if g // per != self.rank:
                    recvs.setdefault(g // per, []).append((g, d))

            def t(v):
                return torch.as_tensor(v, dtype=torch.int64, device=device)

            self._plans[key] = (
                (t([s for s, _ in local]), t([d for _, d in local]))
                if local else None,
                {q: t(v) for q, v in sorted(sends.items())},
                {q: t([d for _, d in sorted(v)])
                 for q, v in sorted(recvs.items())})
        return self._plans[key]

    def _record(self) -> Optional[torch.cuda.Event]:
        if not (self.time_device and self.device.type == "cuda"):
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def hops(self, pairs, dim: int) -> List[torch.Tensor]:
        """:func:`hop` of every ``(x, off)`` of ``pairs`` (tensors of one
        dtype) over the ranks, as one exchange: the blocks each peer gets
        from all of them packed into one buffer a peer, one
        ``batch_isend_irecv``, and on a staged rank one copy to host and
        one back, so the exchange waits on the card once."""
        import torch.distributed as dist
        if not pairs:
            return []
        dtype = pairs[0][0].dtype
        wire = torch.uint8 if dtype == torch.bool else dtype
        t0 = time.perf_counter()
        ev0 = self._record()
        outs: List[torch.Tensor] = []
        parts: Dict[int, List[torch.Tensor]] = {}
        wanted: Dict[int, List[tuple]] = {}
        for x, off in pairs:
            if x.dtype != dtype:
                raise ValueError(f"hops of one exchange share a dtype: "
                                 f"{x.dtype} beside {dtype}")
            if x.shape[dim] != self.per:
                raise ValueError(
                    f"hop over {self.size} ranks of {self.blocks} blocks: "
                    f"dimension {dim} of x has {x.shape[dim]} blocks, this "
                    f"rank holds {self.per}")
            local, sends, recvs = self._hop_plan(off, x.device)
            out = torch.empty_like(x)
            if local is not None:
                out.index_copy_(dim, local[1], x.index_select(dim, local[0]))
            for q, idx in sends.items():
                parts.setdefault(q, []).append(
                    x.index_select(dim, idx).view(wire).reshape(-1))
            for q, idx in recvs.items():
                shape = list(x.shape)
                shape[dim] = idx.numel()
                wanted.setdefault(q, []).append((len(outs), idx, shape))
            outs.append(out)
        device = pairs[0][0].device
        peers_out, peers_in = sorted(parts), sorted(wanted)
        sizes_out = [sum(p.numel() for p in parts[q]) for q in peers_out]
        sizes_in = [sum(math.prod(sh) for _, _, sh in wanted[q])
                    for q in peers_in]
        flat = (torch.cat([p for q in peers_out for p in parts[q]])
                if peers_out else torch.empty(0, dtype=wire, device=device))
        host_out = self._out(flat)
        host_in = self._buffer((sum(sizes_in),), wire)
        ev1 = self._record()
        ops = [dist.P2POp(dist.isend, b, self._peer(q), self.pg)
               for q, b in zip(peers_out, host_out.split(sizes_out))
               if b.numel()]
        ops += [dist.P2POp(dist.irecv, b, self._peer(q), self.pg)
                for q, b in zip(peers_in, host_in.split(sizes_in))
                if b.numel()]
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        ev2 = self._record()
        got = self._back(host_in, wire)
        for q, buf in zip(peers_in, got.split(sizes_in)):
            at = 0
            for i, idx, shape in wanted[q]:
                n = math.prod(shape)
                piece = buf[at:at + n].view(shape)
                at += n
                outs[i].index_copy_(
                    dim, idx, piece.view(torch.bool) if dtype == torch.bool
                    else piece)
        ev3 = self._record()
        if ev0 is not None:
            self._events.append((ev0, ev1, ev2, ev3))
        self.stats["hops"] += len(pairs)
        self.stats["exchanges"] += 1
        self.stats["hop_bytes"] += flat.numel() * flat.element_size()
        self.stats["hop_s"] += time.perf_counter() - t0
        return outs

    def hop_device_ms(self) -> float:
        """The card's time in the hops since ``reset_stats``: the packing
        and the copies to host before the transfer and the copies back
        and the unpacking after it (a staged rank); on an unstaged rank
        the transfer itself too.  Synchronizes."""
        torch.cuda.synchronize()
        total = 0.0
        for e0, e1, e2, e3 in self._events:
            if self.staged:
                total += e0.elapsed_time(e1) + e2.elapsed_time(e3)
            else:
                total += e0.elapsed_time(e3)
        return total

    def all_reduce(self, x: torch.Tensor, op: str) -> torch.Tensor:
        """``x`` reduced over the ranks, elementwise, by ``op`` ("min" or
        "max"); a new tensor on ``x``'s device."""
        import torch.distributed as dist
        red = {"min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}[op]
        t0 = time.perf_counter()
        buf = self._out(x)
        if buf.data_ptr() == x.data_ptr():
            buf = buf.clone()
        dist.all_reduce(buf, red, group=self.pg)
        out = self._back(buf, x.dtype)
        self.stats["all_reduces"] += 1
        self.stats["all_reduce_bytes"] += buf.numel() * buf.element_size()
        self.stats["all_reduce_s"] += time.perf_counter() - t0
        return out

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in rank order:
        the blocks of every rank, in the one-process order.  The ranks'
        parts land in one buffer, rank after rank, which along dimension 0
        is the concatenation itself.  A DTensor (the pod dim of a leaf
        laid over the data and model axes) gathers its local block, which
        the pod group's ranks hold at the same data and model
        coordinates, and stays laid out as it was."""
        import torch.distributed as dist

        from repro_torch.models.partitioning import is_dtensor
        if is_dtensor(x):
            from torch.distributed.tensor import DTensor
            if any(p.is_shard() and p.dim == dim for p in x.placements):
                raise ValueError(f"dim {dim} is sharded over the mesh; the "
                                 "pod group gathers an unsharded dim")
            got = self.all_gather(x.to_local(), dim)
            shape = list(x.shape)
            shape[dim] *= self.size
            stride = [1] * len(shape)
            for d in range(len(shape) - 2, -1, -1):
                stride[d] = stride[d + 1] * shape[d + 1]
            return DTensor.from_local(got, x.device_mesh, x.placements,
                                      run_check=False, shape=torch.Size(shape),
                                      stride=tuple(stride))
        t0 = time.perf_counter()
        buf = self._out(x)
        flat = self._buffer((self.size, *buf.shape), buf.dtype)
        dist.all_gather(list(flat.unbind(0)), buf, group=self.pg)
        got = self._back(flat, x.dtype)
        out = (got.reshape(-1, *x.shape[1:]) if dim == 0 else
               torch.cat(got.unbind(0), dim=dim))
        self.stats["all_gathers"] += 1
        self.stats["all_gather_bytes"] += buf.numel() * buf.element_size()
        self.stats["all_gather_s"] += time.perf_counter() - t0
        return out


BACKENDS = ("nccl", "gloo")


def make_shard_mesh(n_shards: int, backend: str, *, group=None,
                    device="cuda", local_rank: Optional[int] = None
                    ) -> RankGroup:
    """The ranks of ``group`` (``None``: the default process group, which
    the caller has initialized) as a :class:`RankGroup` over ``n_shards``
    blocks: the counterpart of the reference's ``make_shard_mesh``, which
    lays the shard axis over devices.

    ``backend`` is the caller's explicit choice and must be the group's:
    ``"nccl"`` puts rank ``local_rank`` (``LOCAL_RANK``, as
    ``torch.distributed.run`` sets it; else the rank) on
    ``cuda:{local_rank}`` and raises with more ranks than visible cards;
    ``"gloo"`` keeps ``device`` as given (the CPU, or one card that several
    ranks share).  ``n_shards`` must be a multiple of the ranks.  Training
    splits its pods the same way: ``make_shard_mesh(n_pods, backend)``."""
    import torch.distributed as dist

    from repro_torch.device import resolve_device
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; choose from "
                         f"{BACKENDS}")
    if not dist.is_initialized():
        raise RuntimeError("make_shard_mesh needs an initialized "
                           "torch.distributed process group")
    size = dist.get_world_size(group)
    rank = dist.get_rank(group)
    if backend == "nccl":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if size > cards:
            raise RuntimeError(
                f"backend 'nccl' puts one rank on each card: {size} ranks, "
                f"{cards} visible card(s); ranks that share a card need "
                "backend 'gloo'")
    if n_shards % size:
        raise ValueError(f"{n_shards} blocks (shards or pods) do not split "
                         f"evenly over {size} ranks")
    got = dist.get_backend(group)
    if got != backend:
        raise ValueError(f"backend {backend!r} was asked for, but the "
                         f"process group runs {got!r}")
    if backend == "nccl":
        if local_rank is None:
            local_rank = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local_rank)
    else:
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return RankGroup(group, backend, n_shards, dev, rank, size)


def hop(x: torch.Tensor, off: int, dim: int = 0,
        group: Optional[RankGroup] = None) -> torch.Tensor:
    """Move every block ``off`` places along the mesh axis that is
    dimension ``dim`` of ``x``: the result's block ``(i + off) % S`` is
    block ``i`` of ``x`` (a negative ``off`` is the reverse hop).  With a
    :class:`RankGroup` of more than one rank, ``x`` holds this rank's
    blocks of that axis, and the result is this rank's blocks of the
    roll of every rank's blocks."""
    if group is None or group.size == 1:
        return torch.roll(x, shifts=off, dims=dim)
    return group.hops([(x, off)], dim)[0]


def hops(pairs: Sequence[Tuple[torch.Tensor, int]], dim: int = 0,
         group: Optional[RankGroup] = None) -> List[torch.Tensor]:
    """``[hop(x, off, dim, group) for x, off in pairs]``: hops that are
    ready together.  In one process each goes through :func:`hop`; over
    ranks they move as one exchange (``RankGroup.hops``), which waits on
    the card once for all of them."""
    if group is None or group.size == 1:
        return [hop(x, off, dim) for x, off in pairs]
    return group.hops(list(pairs), dim)


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
