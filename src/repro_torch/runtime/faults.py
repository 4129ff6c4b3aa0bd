"""Fault and heterogeneity injection for the discrete-event runtime.

Models the paper's observed conditions: per-step lognormal jitter with
occasional stalls, a faulty node (lac-417 analogue: extreme slowdown +
degraded links for the node and its clique), and transient stragglers.

Randomness is a counter-based splitmix64 hash — deterministic and
generator-free.  The hot path samples it through :class:`Jitter`, which
evaluates the hash chain vectorized (numpy uint64, wrapping arithmetic)
in blocks of 512 counters per process, so the amortized per-sample cost
is O(ns) even with millions of events.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np

_MASK = (1 << 64) - 1
_BLOCK = 512          # vectorized sample block (power of two)
_BMASK = _BLOCK - 1
_BSHIFT = _BLOCK.bit_length() - 1

#: stream tags for the 32-bit lowbias chain shared with ``window_core``
#: (values continue window_core's STREAM_* numbering, which ends at 5)
STREAM_LOSS, STREAM_FLAP = 6, 7


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK
    z = x
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return z ^ (z >> 31)


def _hash_uniform(*ints: int) -> float:
    """Deterministic uniform in (0, 1) from integer keys."""
    h = 0
    for v in ints:
        h = _splitmix64(h ^ (v & _MASK))
    return (h >> 11) / float(1 << 53) + 1e-16


def _hash_normal(*ints: int) -> float:
    u1 = _hash_uniform(*ints, 1)
    u2 = _hash_uniform(*ints, 2)
    return math.sqrt(-2.0 * math.log(u1)) * math.cos(2 * math.pi * u2)


# -- vectorized twins (numpy uint64: multiplication/addition wrap mod 2^64,
#    reproducing the scalar chain bit-for-bit) -------------------------------
def _np_splitmix64(x: np.ndarray) -> np.ndarray:
    x = x + np.uint64(0x9E3779B97F4A7C15)
    z = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def _np_chain(prefix: int, tail: np.ndarray) -> np.ndarray:
    """Continue a scalar splitmix chain ``prefix`` over a counter array."""
    return _np_splitmix64(np.uint64(prefix) ^ tail)


def _np_uniform(h: np.ndarray) -> np.ndarray:
    return (h >> np.uint64(11)).astype(np.float64) / float(1 << 53) + 1e-16


def _chain_prefix(*ints: int) -> int:
    h = 0
    for v in ints:
        h = _splitmix64(h ^ (v & _MASK))
    return h


# -- host-side twins of window_core's in-graph 32-bit lowbias chain ----------
# The vectorized engines draw per-message loss/flap decisions in-graph with
# ``window_core.hash_uniform`` (a lowbias32 finalizer chain producing an
# exact float32 in (0, 1)).  The event engine must make the *same* decisions
# bit-for-bit, so these numpy twins reproduce that chain exactly: uint32
# wrapping arithmetic, identical constants, identical float32 construction.
_GOLDEN32 = np.uint32(0x9E3779B9)


def _np_mix32(x: np.ndarray) -> np.ndarray:
    x = (x ^ (x >> np.uint32(16))) * np.uint32(0x7FEB352D)
    x = (x ^ (x >> np.uint32(15))) * np.uint32(0x846CA68B)
    return x ^ (x >> np.uint32(16))


def np_hash_u32(*keys) -> np.ndarray:
    """Host-side twin of ``window_core.hash_u32`` (bitwise identical)."""
    with np.errstate(over="ignore"):
        h = _GOLDEN32
        for k in keys:
            k = np.asarray(k).astype(np.uint32)
            h = _np_mix32(h ^ (k + _GOLDEN32 + (h << np.uint32(6)) +
                               (h >> np.uint32(2))))
    return h


def np_hash_uniform(*keys) -> np.ndarray:
    """Host-side twin of ``window_core.hash_uniform`` — same float32 bits."""
    h = np_hash_u32(*keys)
    return ((h >> np.uint32(8)).astype(np.float32) +
            np.float32(0.5)) * np.float32(1.0 / (1 << 24))


#: default period (seconds of virtual time) of one flap schedule bucket.
#: A power of two, so the bucket index ``floor(t / period)`` is exact in
#: float32 on dyadic configs — the conformance suite relies on that.
FLAP_PERIOD = 2.0 ** -12


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """Typed fault taxonomy for one run (piecewise-constant per epoch).

    ``compute_slowdown``/``link_slowdown`` are the paper's apparently-faulty
    node (everything still works, just slowly).  The remaining fields model
    degraded hardware that best-effort communication must *absorb*:

      crashed     processes that are dead for the whole run: they never
                  compute, send, or snapshot, but — unlike churn ``leave`` —
                  the topology is untouched, so neighbors keep sending into
                  the dead duct and those sends surface as dead-destination
                  delivery failures.
      link_loss   per-directed-link message loss probability: each send is
                  dropped by a deterministic lowbias32 draw keyed by
                  (seed, STREAM_LOSS, canonical edge id, sender step count).
      link_flap   per-directed-link down-fraction: the link is deterministically
                  down for a hash-chosen subset of ``flap_period`` time
                  buckets — (seed, STREAM_FLAP, edge id, bucket) < fraction.
    """

    compute_slowdown: Dict[int, float] = dataclasses.field(default_factory=dict)
    link_slowdown: Dict[Tuple[int, int], float] = dataclasses.field(default_factory=dict)
    crashed: frozenset = frozenset()
    link_loss: Dict[Tuple[int, int], float] = dataclasses.field(default_factory=dict)
    link_flap: Dict[Tuple[int, int], float] = dataclasses.field(default_factory=dict)
    flap_period: float = FLAP_PERIOD

    def compute_factor(self, pid: int) -> float:
        return self.compute_slowdown.get(pid, 1.0)

    def link_factor(self, src: int, dst: int) -> float:
        return self.link_slowdown.get((src, dst), 1.0)

    def loss_prob(self, src: int, dst: int) -> float:
        return self.link_loss.get((src, dst), 0.0)

    def flap_frac(self, src: int, dst: int) -> float:
        return self.link_flap.get((src, dst), 0.0)

    def is_crashed(self, pid: int) -> bool:
        return pid in self.crashed


def merge_fault_models(*models: FaultModel) -> FaultModel:
    """Compose several fault models; later models win on conflicting keys."""
    compute: Dict[int, float] = {}
    links: Dict[Tuple[int, int], float] = {}
    loss: Dict[Tuple[int, int], float] = {}
    flap: Dict[Tuple[int, int], float] = {}
    crashed: set = set()
    period = FLAP_PERIOD
    for m in models:
        if m is None:
            continue
        compute.update(m.compute_slowdown)
        links.update(m.link_slowdown)
        loss.update(m.link_loss)
        flap.update(m.link_flap)
        crashed |= set(m.crashed)
        period = m.flap_period
    return FaultModel(compute, links, frozenset(crashed), loss, flap, period)


def _clique_links(topology, host: int, value: float) -> Dict[Tuple[int, int], float]:
    links: Dict[Tuple[int, int], float] = {}
    for p in topology.host_pids(host):
        for nb in topology.neighbors[p]:
            links[(p, nb)] = value
            links[(nb, p)] = value
    return links


def faulty_node(pid: int, neighbors, compute_factor: float = 30.0,
                link_factor: float = 50.0) -> FaultModel:
    """A single apparently-faulty node: slow compute and slow links to/from
    its clique (the paper's lac-417 scenario)."""
    links = {}
    for nb in neighbors:
        links[(pid, nb)] = link_factor
        links[(nb, pid)] = link_factor
    return FaultModel({pid: compute_factor}, links)


def _host_pids(topology, host: int, caller: str):
    pids = topology.host_pids(host)
    if not pids:
        raise ValueError(
            f"{caller}: host {host} has no processes "
            f"(topology {topology.name!r} has hosts 0..{topology.n_nodes - 1})")
    return pids


def faulty_host(topology, host: int, compute_factor: float = 30.0,
                link_factor: float = 50.0) -> FaultModel:
    """Degrade a whole physical host: every process placed on ``host``
    (per ``topology.node_of``) runs slow, and every link touching one of
    those processes is slow in both directions — the paper's faulty node
    dragging its entire communication clique (§III-G)."""
    pids = _host_pids(topology, host, "faulty_host")
    links = {}
    for p in pids:
        for nb in topology.neighbors[p]:
            links[(p, nb)] = link_factor
            links[(nb, p)] = link_factor
    return FaultModel({p: compute_factor for p in pids}, links)


def crashed_host(topology, host: int) -> FaultModel:
    """Every process on ``host`` is dead: no compute, no sends, no
    snapshots — but the topology is untouched, so the clique's neighbors
    keep attempting delivery into the dead ducts."""
    pids = _host_pids(topology, host, "crashed_host")
    return FaultModel(crashed=frozenset(pids))


def lossy_host(topology, host: int, loss_prob: float = 0.05) -> FaultModel:
    """Every link touching a process on ``host`` silently drops each
    message with probability ``loss_prob`` (deterministic per-send draw)."""
    _host_pids(topology, host, "lossy_host")
    return FaultModel(link_loss=_clique_links(topology, host, loss_prob))


def flapping_host(topology, host: int, down_frac: float = 0.5,
                  flap_period: float = FLAP_PERIOD) -> FaultModel:
    """Every link touching a process on ``host`` flaps: down for a
    hash-chosen ``down_frac`` of ``flap_period`` time buckets."""
    _host_pids(topology, host, "flapping_host")
    return FaultModel(link_flap=_clique_links(topology, host, down_frac),
                      flap_period=flap_period)


#: kinds keyed by host (heal clears fault, lossy, and flap on that host)
_HOST_KINDS = ("fault", "heal", "lossy", "flap")
#: kinds keyed by original pid
_PID_KINDS = ("leave", "join", "crash")
TIMELINE_KINDS = _HOST_KINDS + _PID_KINDS


@dataclasses.dataclass(frozen=True)
class TimelineEvent:
    """One scheduled churn event on the service timeline.

    ``kind`` is one of:

      fault   host ``host`` degrades (compute + clique links slow down)
      heal    host ``host`` recovers (clears fault, lossy, and flap)
      lossy   host ``host``'s clique links start dropping messages
      flap    host ``host``'s clique links start flapping down/up
      leave   process ``pid`` (original numbering) departs; its duct ring
              is spliced closed by ``topologies.patch_topology``
      join    process ``pid`` returns; the pristine ring segment reappears
      crash   process ``pid`` dies without churn splicing: the topology is
              untouched, neighbors keep sending into the dead duct, and a
              crash is permanent (no heal/join re-admits the process)
    """

    t: float
    kind: str
    host: int = -1
    pid: int = -1

    def __post_init__(self):
        if self.kind not in TIMELINE_KINDS:
            raise ValueError(
                f"unknown timeline event kind {self.kind!r}; "
                f"expected one of {TIMELINE_KINDS}")
        if not self.t > 0:
            raise ValueError(
                f"timeline events must be strictly inside the run, got t={self.t}")
        if self.kind in _HOST_KINDS and self.host < 0:
            raise ValueError(f"{self.kind!r} event needs host >= 0, got {self.host}")
        if self.kind in _PID_KINDS and self.pid < 0:
            raise ValueError(f"{self.kind!r} event needs pid >= 0, got {self.pid}")


@dataclasses.dataclass(frozen=True)
class FaultTimeline:
    """A schedule of churn events extending the static :class:`FaultModel`.

    The static model answers "which processes/links are slow"; the
    timeline answers "when does that change".  ``runtime/service.py``
    splits the run into epochs at :meth:`boundaries` and rebuilds the
    epoch's topology (from :meth:`absent_pids`) and fault model (from
    :meth:`fault_model`) at each boundary — churn state is piecewise
    constant, never mid-epoch.
    """

    events: Tuple[TimelineEvent, ...] = ()
    compute_factor: float = 30.0
    link_factor: float = 50.0
    loss_prob: float = 0.05
    flap_down: float = 0.5
    flap_period: float = FLAP_PERIOD

    def boundaries(self, duration: float) -> List[float]:
        """Distinct event times strictly inside ``(0, duration)``."""
        return sorted({e.t for e in self.events if 0 < e.t < duration})

    def validate(self, topology) -> None:
        """Raise an actionable ``ValueError`` for events that can never take
        effect on ``topology`` (unknown host or pid) instead of letting them
        silently contribute nothing to any epoch's fault model."""
        for e in self.events:
            if e.kind in _HOST_KINDS and not (0 <= e.host < topology.n_nodes):
                raise ValueError(
                    f"timeline event {e.kind!r} at t={e.t} names host "
                    f"{e.host}, but topology {topology.name!r} only has "
                    f"hosts 0..{topology.n_nodes - 1}")
            if e.kind in _PID_KINDS and not (0 <= e.pid < topology.n):
                raise ValueError(
                    f"timeline event {e.kind!r} at t={e.t} names pid "
                    f"{e.pid}, but topology {topology.name!r} only has "
                    f"pids 0..{topology.n - 1}")

    def absent_pids(self, t: float) -> frozenset:
        """Original pids that have left (and not rejoined) by time ``t``.

        An event at exactly ``t`` has taken effect (epochs are closed on
        the left: the epoch starting at a boundary sees its events).
        """
        absent = set()
        for e in sorted(self.events, key=lambda e: e.t):
            if e.t > t:
                break
            if e.kind == "leave":
                absent.add(e.pid)
            elif e.kind == "join":
                absent.discard(e.pid)
        return frozenset(absent)

    def _active_hosts(self, t: float, on_kind: str) -> frozenset:
        """Hosts where ``on_kind`` is active (not yet healed) at time ``t``."""
        hosts = set()
        for e in sorted(self.events, key=lambda e: e.t):
            if e.t > t:
                break
            if e.kind == on_kind:
                hosts.add(e.host)
            elif e.kind == "heal":
                hosts.discard(e.host)
        return frozenset(hosts)

    def faulty_hosts(self, t: float) -> frozenset:
        """Hosts degraded (faulted, not yet healed) at time ``t``."""
        return self._active_hosts(t, "fault")

    def lossy_hosts(self, t: float) -> frozenset:
        """Hosts whose clique links are lossy at time ``t``."""
        return self._active_hosts(t, "lossy")

    def flapping_hosts(self, t: float) -> frozenset:
        """Hosts whose clique links are flapping at time ``t``."""
        return self._active_hosts(t, "flap")

    def crashed_pids(self, t: float) -> frozenset:
        """Original pids crashed by time ``t`` (crashes are permanent)."""
        return frozenset(e.pid for e in self.events
                         if e.kind == "crash" and e.t <= t)

    def fault_model(self, topology, t: float, pid_map=None):
        """Compose the active faults at ``t`` into one FaultModel.

        ``topology`` is the *patched* epoch topology (post-churn pid
        numbering), so the composed dicts speak the numbering the engine
        actually runs with; ``pid_map`` (original pid → patched pid, from
        ``topologies.patch_topology``) translates pid-keyed crash events.
        A faulted host whose processes have all left, or a crashed pid
        that has also left, contributes nothing.
        """
        compute: Dict[int, float] = {}
        links: Dict[Tuple[int, int], float] = {}
        loss: Dict[Tuple[int, int], float] = {}
        flap: Dict[Tuple[int, int], float] = {}
        for host in sorted(self.faulty_hosts(t)):
            if not topology.host_pids(host):
                continue
            fm = faulty_host(topology, host, self.compute_factor,
                             self.link_factor)
            compute.update(fm.compute_slowdown)
            links.update(fm.link_slowdown)
        for host in sorted(self.lossy_hosts(t)):
            if topology.host_pids(host):
                loss.update(_clique_links(topology, host, self.loss_prob))
        for host in sorted(self.flapping_hosts(t)):
            if topology.host_pids(host):
                flap.update(_clique_links(topology, host, self.flap_down))
        crashed = set()
        for pid in sorted(self.crashed_pids(t)):
            mapped = pid_map.get(pid) if pid_map is not None else pid
            if mapped is not None and 0 <= mapped < topology.n:
                crashed.add(mapped)
        if not compute and not links and not loss and not flap and not crashed:
            return None
        return FaultModel(compute, links, frozenset(crashed), loss, flap,
                          self.flap_period)


class Jitter:
    """Deterministic per-(process, step) multiplicative jitter.

    Samples are pure functions of (seed, key, counter).  Because consumers
    walk counters sequentially, samples are produced vectorized in blocks of
    ``_BLOCK`` and cached (latest block per key), making the common-case
    lookup an array index instead of ~10 python big-int hash rounds.
    """

    def __init__(self, sigma: float, seed: int,
                 stall_prob: float = 0.0, stall_factor: float = 1.0):
        self.sigma = sigma
        self.seed = seed
        self.stall_prob = stall_prob
        self.stall_factor = stall_factor
        self._arange = np.arange(_BLOCK, dtype=np.uint64)
        self._fcache: Dict[int, Tuple[int, list]] = {}
        self._lcache: Dict[int, Tuple[int, list]] = {}

    # -- block generation ----------------------------------------------------
    def _normal_block(self, prefix: int, start: int) -> np.ndarray:
        h = _np_chain(prefix, np.uint64(start) + self._arange)
        u1 = _np_uniform(_np_splitmix64(h ^ np.uint64(1)))
        u2 = _np_uniform(_np_splitmix64(h ^ np.uint64(2)))
        return np.sqrt(-2.0 * np.log(u1)) * np.cos(2 * np.pi * u2)

    def _lognormal_block(self, prefix: int, start: int) -> np.ndarray:
        z = self._normal_block(prefix, start)
        return np.exp(-0.5 * self.sigma ** 2 + self.sigma * z)

    def _factor_block(self, pid: int, start: int) -> np.ndarray:
        if self.sigma > 0:
            f = self._lognormal_block(_chain_prefix(self.seed, pid), start)
        else:
            f = np.ones(_BLOCK)
        if self.stall_prob > 0:
            u = _np_uniform(_np_chain(_chain_prefix(self.seed, 13, pid),
                                      np.uint64(start) + self._arange))
            f = np.where(u < self.stall_prob, f * self.stall_factor, f)
        return f

    # -- sample access -------------------------------------------------------
    def factor(self, pid: int, step: int) -> float:
        if self.sigma <= 0 and self.stall_prob <= 0:
            return 1.0
        block = step >> _BSHIFT
        cached = self._fcache.get(pid)
        if cached is None or cached[0] != block:
            # .tolist() so lookups hand back python floats (fast arithmetic)
            cached = (block, self._factor_block(pid, block << _BSHIFT).tolist())
            self._fcache[pid] = cached
        return cached[1][step & _BMASK]

    def latency_factor(self, key: int, count: int) -> float:
        """Link-latency jitter for duct ``key`` at its ``count``-th send."""
        if self.sigma <= 0:
            return 1.0
        block = count >> _BSHIFT
        cached = self._lcache.get(key)
        if cached is None or cached[0] != block:
            cached = (block, self._lognormal_block(
                _chain_prefix(self.seed, 7919, key), block << _BSHIFT).tolist())
            self._lcache[key] = cached
        return cached[1][count & _BMASK]
