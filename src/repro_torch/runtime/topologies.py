"""Pluggable process topologies for the discrete-event runtime (DESIGN.md §3).

A :class:`Topology` is an immutable adjacency structure plus a host
assignment (``node_of``), so the simulator's hierarchical link model can
price intra-node and inter-node hops differently (Bienz et al.,
arXiv:1806.02030) and the fault injector can degrade a whole physical node
and its communication clique (the paper's lac-417 scenario, §III-G).

Four families cover the paper's experiments plus scaling stress shapes:

  ring          degree-2 cycle — cheapest per-process communication
  torus         near-square 2-D torus — the benchmark apps' native shape
  cliques       clique-of-cliques: full connectivity within a host, plus
                corresponding-member links to the neighboring hosts
  smallworld    ring lattice + deterministic long chords — dense, low
                diameter; stresses clumpiness under load

All builders are deterministic (counter-based splitmix64 hashing, no RNG
objects) and validated: symmetric, self-loop-free, connected.
"""
from __future__ import annotations

import dataclasses
import logging
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.runtime.faults import _splitmix64

logger = logging.getLogger(__name__)


#: Halo slot order shared by the apps and the vectorized engine.
DIRS = ("n", "s", "w", "e")
#: Opposite-slot index (n<->s, w<->e): the edge row a sender publishes for a
#: receiver whose halo slot for that sender is ``slot`` is ``OPP_IDX[slot]``.
OPP_IDX = (1, 0, 3, 2)


def halo_slot_map(neighbors) -> Dict[int, int]:
    """Round-robin halo-slot assignment for an injected topology.

    Numeric core of ``apps.graphcolor.direction_map``: sorted neighbors
    cycle over the four halo slots, so several neighbors may share a slot
    (last fresh message wins — best-effort staleness semantics).  Both the
    per-fragment apps and the vectorized engine derive their slot wiring
    from this one function.
    """
    return {nb: i % 4 for i, nb in enumerate(sorted(neighbors))}


def near_square(n: int) -> Tuple[int, int]:
    """Near-square factorization of ``n`` (rows <= cols)."""
    a = int(math.sqrt(n))
    while n % a:
        a -= 1
    return a, n // a


@dataclasses.dataclass(frozen=True)
class Topology:
    """Immutable communication graph with a physical-host assignment."""

    name: str
    n: int
    neighbors: Tuple[Tuple[int, ...], ...]   # adjacency, index = pid
    node_of: Tuple[int, ...]                 # pid -> physical host id

    def as_dict(self) -> Dict[int, List[int]]:
        return {i: list(nbs) for i, nbs in enumerate(self.neighbors)}

    def degree(self, pid: int) -> int:
        return len(self.neighbors[pid])

    @property
    def n_edges(self) -> int:
        return sum(len(nbs) for nbs in self.neighbors) // 2

    @property
    def n_nodes(self) -> int:
        return len(set(self.node_of))

    def same_node(self, a: int, b: int) -> bool:
        return self.node_of[a] == self.node_of[b]

    def host_pids(self, host: int) -> List[int]:
        return [p for p in range(self.n) if self.node_of[p] == host]

    def clique_of(self, pid: int) -> List[int]:
        """The pid's communication clique: itself plus direct neighbors."""
        return sorted({pid, *self.neighbors[pid]})

    def validate(self) -> "Topology":
        for i, nbs in enumerate(self.neighbors):
            assert i not in nbs, f"self-loop at {i}"
            assert len(set(nbs)) == len(nbs), f"duplicate edge at {i}"
            for j in nbs:
                assert i in self.neighbors[j], f"asymmetric edge {i}->{j}"
        if self.n > 1:
            seen = {0}
            frontier = [0]
            while frontier:
                nxt = []
                for p in frontier:
                    for q in self.neighbors[p]:
                        if q not in seen:
                            seen.add(q)
                            nxt.append(q)
                frontier = nxt
            assert len(seen) == self.n, "topology is disconnected"
        return self


def _freeze(adj: Sequence[Sequence[int]], name: str,
            node_of: Sequence[int]) -> Topology:
    neighbors = tuple(tuple(sorted(set(nbs))) for nbs in adj)
    return Topology(name, len(neighbors), neighbors,
                    tuple(node_of)).validate()


def _default_nodes(n: int, procs_per_node: int) -> List[int]:
    return [p // max(procs_per_node, 1) for p in range(n)]


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------
def ring(n: int, procs_per_node: int = 4) -> Topology:
    assert n >= 2, "ring needs >= 2 processes"
    adj = [[(i - 1) % n, (i + 1) % n] for i in range(n)]
    return _freeze(adj, f"ring{n}", _default_nodes(n, procs_per_node))


def torus(n: int, procs_per_node: int = 4) -> Topology:
    """Near-square 2-D torus — matches the apps' native halo structure."""
    assert n >= 2, "torus needs >= 2 processes"
    gh, gw = near_square(n)
    adj: List[List[int]] = [[] for _ in range(n)]
    for p in range(n):
        r, c = divmod(p, gw)
        for q in (((r - 1) % gh) * gw + c, ((r + 1) % gh) * gw + c,
                  r * gw + (c - 1) % gw, r * gw + (c + 1) % gw):
            if q != p:
                adj[p].append(q)
    return _freeze(adj, f"torus{gh}x{gw}", _default_nodes(n, procs_per_node))


def cliques(n: int, clique_size: int = 8) -> Topology:
    """Clique-of-cliques: each host's processes are fully connected, and
    member k of each clique links to member k of the two adjacent cliques
    (a ring over hosts).  ``node_of`` is the clique index, so the faulty-node
    experiment degrades exactly one clique."""
    assert n >= 2
    assert clique_size >= 1
    assert n % clique_size == 0, "n must be a multiple of clique_size"
    n_cliques = n // clique_size
    adj: List[List[int]] = [[] for _ in range(n)]
    for p in range(n):
        cq, k = divmod(p, clique_size)
        for k2 in range(clique_size):
            if k2 != k:
                adj[p].append(cq * clique_size + k2)
        if n_cliques > 1:
            for d in (-1, +1):
                q = ((cq + d) % n_cliques) * clique_size + k
                if q != p:
                    adj[p].append(q)
    return _freeze(adj, f"cliques{n_cliques}x{clique_size}",
                   [p // clique_size for p in range(n)])


def smallworld(n: int, k: int = 4, chords: int = 2, seed: int = 0,
               procs_per_node: int = 4) -> Topology:
    """Dense small-world: ring lattice (k nearest, k/2 each side) plus
    ``chords`` deterministic long-range links per process.  Chord endpoints
    come from splitmix64 hashing, so the graph is a pure function of
    (n, k, chords, seed)."""
    assert n >= 4, "smallworld needs >= 4 processes"
    k = max(2, min(k, n - 1)) // 2 * 2
    adj: List[set] = [set() for _ in range(n)]
    for p in range(n):
        for d in range(1, k // 2 + 1):
            adj[p].add((p + d) % n)
            adj[p].add((p - d) % n)
    for p in range(n):
        for c in range(chords):
            h = _splitmix64(_splitmix64(seed * 1_000_003 + p) ^ (c + 1))
            # offset in [k//2 + 1, n - k//2 - 1]: always a non-lattice edge
            span = n - k - 1
            if span <= 0:
                break
            q = (p + k // 2 + 1 + h % span) % n
            if q != p:
                adj[p].add(q)
                adj[q].add(p)
    return _freeze([sorted(s) for s in adj], f"smallworld{n}k{k}",
                   _default_nodes(n, procs_per_node))


# ---------------------------------------------------------------------------
# Shard partitioning (DESIGN.md §8)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Contiguous-block partition of a topology's processes over shards.

    ``perm`` is the reordering: position ``pos`` in the flat sharded layout
    holds original process ``perm[pos]``, and shard ``s`` owns positions
    ``[s*m, (s+1)*m)`` with ``m = n // n_shards``.  ``cut`` counts directed
    cross-shard edges — the boundary traffic the sharded engine exchanges
    per window; everything else stays shard-local.
    """

    n_shards: int
    perm: Tuple[int, ...]      # position -> original pid
    inv: Tuple[int, ...]       # original pid -> position
    shard_of: Tuple[int, ...]  # original pid -> shard
    cut: int                   # directed cross-shard edge count

    @property
    def procs_per_shard(self) -> int:
        return len(self.perm) // self.n_shards


def _cut_size(topo: Topology, order: Sequence[int], m: int) -> int:
    pos = [0] * topo.n
    for p_at, pid in enumerate(order):
        pos[pid] = p_at
    return sum(1 for src in range(topo.n) for dst in topo.neighbors[src]
               if pos[src] // m != pos[dst] // m)


def _bfs_order(topo: Topology) -> List[int]:
    """BFS ordering (sorted-neighbor tie-break) — clusters graph
    neighborhoods into consecutive positions for irregular topologies."""
    seen = [False] * topo.n
    order: List[int] = []
    for root in range(topo.n):
        if seen[root]:
            continue
        seen[root] = True
        frontier = [root]
        while frontier:
            order.extend(frontier)
            nxt = []
            for p in frontier:
                for q in topo.neighbors[p]:
                    if not seen[q]:
                        seen[q] = True
                        nxt.append(q)
            frontier = nxt
    return order


def contiguous_partition(topo: Topology, n_shards: int) -> ShardPlan:
    """Partition processes into ``n_shards`` contiguous equal blocks.

    Candidate orderings — identity (the builders' native row-major/clique
    order, already block-local for ring/torus/cliques) and BFS (clusters
    irregular graphs) — are scored by directed cross-shard edge count and
    the thinner cut wins (identity on ties, keeping the sharded layout
    aligned with the unsharded engine wherever possible).

    Reordering changes nothing about the simulated system — RNG streams
    and halo-scatter tie-breaks stay keyed by *original* pid / canonical
    edge id (DESIGN.md §8) — only about which shard owns which process.
    """
    n = topo.n
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if n % n_shards:
        raise ValueError(
            f"n_shards={n_shards} must divide the process count n={n}")
    m = n // n_shards
    identity = list(range(n))
    order = identity
    if n_shards > 1:
        bfs = _bfs_order(topo)
        if _cut_size(topo, bfs, m) < _cut_size(topo, identity, m):
            order = bfs
    inv = [0] * n
    for p_at, pid in enumerate(order):
        inv[pid] = p_at
    shard_of = tuple(inv[pid] // m for pid in range(n))
    return ShardPlan(n_shards=n_shards, perm=tuple(order), inv=tuple(inv),
                     shard_of=shard_of, cut=_cut_size(topo, order, m))


# ---------------------------------------------------------------------------
# Duct layout planning (DESIGN.md §10)
# ---------------------------------------------------------------------------
#: layouts a caller may request; "auto" resolves to dense on every topology
#: (the bucketed plan below covers irregular degrees); "edge" keeps the
#: fully general edge-major layout for comparison runs and parity tests
LAYOUTS = ("auto", "dense", "edge")


def regular_degree(topo: Topology) -> Optional[int]:
    """The common in-degree if every process has the same one, else None."""
    degs = {len(nbs) for nbs in topo.neighbors}
    return degs.pop() if len(degs) == 1 else None


def next_pow2(k: int) -> int:
    """Smallest power of two >= k (k >= 1)."""
    return 1 << (int(k) - 1).bit_length()


def canonical_edges(topo: Topology):
    """Source-major enumeration of directed edges — THE canonical edge id
    order every engine keys per-edge RNG streams and halo tie-breaks by
    (DESIGN.md §7/§8/§10).  Returns ``(esrc, edst, index)`` lists/dict with
    ``index[(src, dst)]`` the canonical id.  Single definition so the
    engines and the dense layout plan can never drift apart."""
    esrc: List[int] = []
    edst: List[int] = []
    index: Dict[Tuple[int, int], int] = {}
    for src in range(topo.n):
        for dst in topo.neighbors[src]:
            index[(src, dst)] = len(esrc)
            esrc.append(src)
            edst.append(dst)
    return esrc, edst, index


@dataclasses.dataclass(frozen=True, eq=False)
class DenseBucket:
    """One degree bucket of the dense plan: a contiguous slab of padded
    receiver row blocks.  Member ``i`` (ascending pid) owns flat rows
    ``start + i*deg .. start + (i+1)*deg - 1``."""

    deg: int                 # padded rows per member receiver
    start: int               # first flat row of this bucket's slab
    members: np.ndarray      # (nb,) member pids, ascending


@dataclasses.dataclass(frozen=True, eq=False)
class LayoutPlan:
    """How the vectorized engines lay duct rings out in memory.

    ``edge`` is the fully general edge-major layout: one ring per directed
    edge in canonical enumeration order, receiver bookkeeping via
    segment_sum/segment_max over edge rows.  ``dense`` is the
    degree-bucketed receiver-major layout (DESIGN.md §13): receivers are
    grouped by in-degree bucket — the smallest power of two >= their
    in-degree, clamped to the topology's max in-degree, so degree-regular
    topologies collapse to a single zero-padding bucket of exactly ``d``
    rows — and each receiver's row block is padded to its bucket degree
    with masked *dead* rows.  Live rows keep sorted-source order, which per
    receiver is canonical-edge-id order (canonical ids are source-major),
    so the edge-major halo tie-break "highest canonical edge id wins"
    stays "highest row ``j`` wins" and every receiver counter is a row
    reduction over the bucket's ``deg`` axis; no segment/scatter op
    survives on the regular fast path.

    Dense tables (``None`` for the edge layout), flat over the ``n_rows``
    padded rows:

      src        sender pid of the in-edge at flat row ``r``; sentinel
                 ``n`` on dead rows (gathers clamp, masks kill the value)
      dst        owner (receiver) pid of row ``r`` — defined on dead rows
      rev        flat row of the reverse edge; a self-involution that
                 doubles as the *out-edge table* (sender ``p``'s outgoing
                 rings are ``rev[rows of p]``); dead rows map to themselves
      eid        canonical edge id (keys the per-edge latency RNG stream
                 identically to edge-major); sentinel ``E`` on dead rows
      live       bool mask — False exactly on dead padding rows
      row_start  (n,) first flat row of each receiver's block
      bdeg       (n,) bucket degree of each receiver's block

    The halo slot of flat row ``r`` is ``(r - row_start[dst[r]]) % 4``
    (halo_slot_map round-robins sorted neighbors) and needs no table.
    Dead rows' rings are never staged into (the ``live`` mask gates the
    accept), so they stay empty forever and drain as no-ops.
    """

    kind: str
    degree: int                       # max bucket degree (0 for edge)
    n_rows: int = 0                   # total flat padded rows R
    buckets: Tuple[DenseBucket, ...] = ()
    src: Optional[np.ndarray] = None
    dst: Optional[np.ndarray] = None
    rev: Optional[np.ndarray] = None
    eid: Optional[np.ndarray] = None
    live: Optional[np.ndarray] = None
    row_start: Optional[np.ndarray] = None
    bdeg: Optional[np.ndarray] = None


def _dense_plan(topo: Topology) -> LayoutPlan:
    n = topo.n
    degs = [len(nbs) for nbs in topo.neighbors]
    dmax = max(degs)
    _, _, eindex = canonical_edges(topo)
    E = len(eindex)
    # bucket degree per receiver: next power of two, clamped to the max
    # in-degree (degree-regular topologies collapse to one exact-d bucket)
    bdeg = np.array([min(next_pow2(k), dmax) if k else 0 for k in degs],
                    np.int32)
    buckets: List[DenseBucket] = []
    row_start = np.zeros(n, np.int64)
    start = 0
    for bd in sorted(set(int(b) for b in bdeg if b)):
        members = np.where(bdeg == bd)[0]
        buckets.append(DenseBucket(deg=bd, start=start, members=members))
        row_start[members] = start + np.arange(len(members)) * bd
        start += len(members) * bd
    R = start
    src = np.full(R, n, np.int32)
    dst = np.empty(R, np.int32)
    eid = np.full(R, E, np.int32)
    rev = np.arange(R, dtype=np.int32)     # dead rows: self-involution
    live = np.zeros(R, bool)
    jindex: Dict[Tuple[int, int], int] = {}
    for b in buckets:
        for p in b.members.tolist():
            r0 = int(row_start[p])
            dst[r0:r0 + b.deg] = p
            for j, s in enumerate(sorted(topo.neighbors[p])):
                src[r0 + j] = s
                eid[r0 + j] = eindex[(s, p)]
                live[r0 + j] = True
                jindex[(s, p)] = j
    rows_live = np.where(live)[0]
    rev[rows_live] = (row_start[src[rows_live]]
                      + np.array([jindex[(int(dst[r]), int(src[r]))]
                                  for r in rows_live], np.int64))
    return LayoutPlan(kind="dense", degree=dmax, n_rows=R,
                      buckets=tuple(buckets), src=src, dst=dst, rev=rev,
                      eid=eid, live=live,
                      row_start=row_start.astype(np.int32), bdeg=bdeg)


def plan_layout(topo: Topology, layout: str = "auto") -> LayoutPlan:
    """Resolve a requested layout against a topology.

    ``auto`` resolves to the bucketed dense layout on every topology —
    irregular in-degrees land in power-of-two buckets with masked dead
    padding rows, degree-regular ones get a single exact-``d`` bucket —
    so only an explicit ``edge`` keeps the general edge-major path
    (comparison runs, parity tests).
    """
    if layout not in LAYOUTS:
        raise ValueError(
            f"unknown layout {layout!r}; choose from {LAYOUTS}")
    if layout == "edge":
        return LayoutPlan(kind="edge", degree=0)
    return _dense_plan(topo)


def patch_topology(topo: Topology,
                   absent: Sequence[int]) -> Tuple[Topology, Dict[int, int]]:
    """Remove ``absent`` pids and splice their duct rings closed.

    The elastic-churn patch-up (runtime/service.py): each absent process
    is excised one at a time, and its live neighbors are stitched into a
    cycle (consecutive members of its adjacency ring gain an edge), so the
    survivors keep a connected, symmetric graph without the departed hop.
    Sequential excision handles adjacent departures naturally — by the
    time the second of two neighboring processes leaves, it has already
    inherited splice edges from the first.

    Surviving pids are renumbered contiguously (host assignment carries
    over).  Returns the validated patched topology plus the
    ``original pid -> patched pid`` mapping.  Always patches from the
    pristine base, so a later rejoin is just a patch with a smaller
    absent set — rejoining every process reproduces ``topo`` exactly.
    """
    absent_set = set(absent)
    bad = sorted(p for p in absent_set if not 0 <= p < topo.n)
    if bad:
        raise ValueError(f"absent pids {bad} out of range for n={topo.n}")
    if len(absent_set) >= topo.n - 1:
        raise ValueError(
            f"cannot remove {len(absent_set)} of {topo.n} processes; "
            "at least 2 must survive")
    nbrs = [list(ns) for ns in topo.neighbors]
    alive = [True] * topo.n
    for a in sorted(absent_set):
        ring_members = [v for v in nbrs[a] if alive[v]]
        alive[a] = False
        for u in ring_members:
            nbrs[u] = [v for v in nbrs[u] if v != a]
        for i in range(len(ring_members)):
            u = ring_members[i]
            v = ring_members[(i + 1) % len(ring_members)]
            if u != v and v not in nbrs[u]:
                nbrs[u].append(v)
                nbrs[v].append(u)
    keep = [p for p in range(topo.n) if alive[p]]
    newid = {p: i for i, p in enumerate(keep)}
    adj = [sorted(newid[v] for v in nbrs[p]) for p in keep]
    node_of = [topo.node_of[p] for p in keep]
    name = (f"{topo.name}-{len(keep)}live" if absent_set else topo.name)
    return _freeze(adj, name, node_of), newid


TOPOLOGIES = {
    "ring": ring,
    "torus": torus,
    "cliques": cliques,
    "smallworld": smallworld,
}


def make_topology(name: str, n: int, **kwargs) -> Topology:
    """Build a registered topology by name for ``n`` processes."""
    try:
        builder = TOPOLOGIES[name]
    except KeyError:
        raise ValueError(
            f"unknown topology {name!r}; choose from {sorted(TOPOLOGIES)}")
    if name == "cliques":
        size = kwargs.pop("clique_size", None)
        if size is None:
            size = next(s for s in (8, 4, 2, 1) if n % s == 0)
        return builder(n, clique_size=size, **kwargs)
    return builder(n, **kwargs)
