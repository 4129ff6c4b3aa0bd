"""Distributed graph coloring (Leith et al. 2012 WLAN channel selection) —
the paper's communication-intensive benchmark (§II-B).

Nodes live on a global toroidal grid, 4 neighbors, C colors.  Each update a
node in conflict with any neighbor multiplicatively decays the probability of
its current color (factor b), renormalizes, and resamples; conflict-free
nodes keep their color.  Colors are exchanged with neighboring fragments via
best-effort channels (halo rows/cols) — stale halos are simply used as-is.

Two implementations share the same math:
  - numpy fragments for the discrete-event runtime (fast on CPU);
  - ``BatchedGraphColor``, the whole population's step on torch tensors,
    which the vectorized torch engine runs every lockstep window.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np
import torch


def proc_grid(n: int):
    """Near-square factorization of the process count."""
    a = int(math.sqrt(n))
    while n % a:
        a -= 1
    return a, n // a


def block_shape(nodes_per_proc: int):
    a = int(math.sqrt(nodes_per_proc))
    while nodes_per_proc % a:
        a -= 1
    return a, nodes_per_proc // a


def direction_map(neighbors) -> Dict[int, str]:
    """Assign each injected-topology neighbor a halo direction slot.

    Arbitrary topologies (ring, cliques, small-world — runtime/topologies)
    don't carry grid directions, so neighbors round-robin over the four halo
    slots; several neighbors may feed one slot (last fresh message wins,
    which is exactly the best-effort staleness semantics).  The numeric slot
    assignment lives in ``runtime.topologies.halo_slot_map`` so the
    vectorized engine wires edges identically.
    """
    from repro_torch.runtime.topologies import DIRS, halo_slot_map
    return {nb: DIRS[s] for nb, s in halo_slot_map(neighbors).items()}


@dataclasses.dataclass(frozen=True)
class GraphColorConfig:
    n_processes: int = 4
    nodes_per_process: int = 2048
    n_colors: int = 3
    b: float = 0.1
    seed: int = 0


def _update_block(colors, probs, halo, b, rng):
    """One CFL update (Leith et al.) on a (H,W) block given halo arrays.

    Success (no conflicting neighbor): probability concentrates on the
    current color.  Failure: the current color's probability decays and a
    b-fraction of mass is redistributed over the other colors, then the node
    resamples.  halo: {"n": (W,), "s": (W,), "w": (H,), "e": (H,)}.
    Returns (colors, probs, conflict_mask).
    """
    C = probs.shape[-1]
    up = np.vstack([halo["n"][None, :], colors[:-1]])
    down = np.vstack([colors[1:], halo["s"][None, :]])
    left = np.hstack([halo["w"][:, None], colors[:, :-1]])
    right = np.hstack([colors[:, 1:], halo["e"][:, None]])
    conflict = ((colors == up) | (colors == down)
                | (colors == left) | (colors == right))

    ok = ~conflict
    probs[ok] = 0.0
    probs[ok, colors[ok]] = 1.0

    if conflict.any():
        idx = np.where(conflict)
        cur = colors[idx]
        p = probs[idx]  # (k, C)
        onehot = np.zeros_like(p)
        onehot[np.arange(len(cur)), cur] = 1.0
        p = (1 - b) * p + b * (1 - onehot) / (C - 1)
        probs[idx] = p
        # resample
        u = rng.random(len(cur))
        cdf = np.cumsum(p, axis=1)
        new = (u[:, None] > cdf).sum(axis=1)
        colors[idx] = new
    return colors, probs, conflict


class _Fragment:
    def __init__(self, pid, cfg: GraphColorConfig, grid, block, self_wrap,
                 nbr_dirs: Optional[Dict[int, str]] = None):
        self.pid = pid
        self.cfg = cfg
        self.grid = grid
        H, W = block
        self.rng = np.random.default_rng((cfg.seed, pid))
        self.colors = self.rng.integers(0, cfg.n_colors, size=(H, W))
        self.probs = np.full((H, W, cfg.n_colors), 1.0 / cfg.n_colors)
        self.self_wrap = self_wrap  # {"ns": bool, "ew": bool}
        self.nbr_dirs = nbr_dirs    # injected topology: neighbor -> halo slot
        self.scalar = H == W == 1   # 1 simel/process: pure-python fast path
        # last-known halos (best-effort: start with own edges).  The scalar
        # path trades arrays for plain ints end-to-end: halos, payloads, and
        # probabilities stay python scalars, ~10x cheaper per update.
        if self.scalar:
            c = int(self.colors[0, 0])
            self.halo = {"n": c, "s": c, "w": c, "e": c}
            self._c = c
            self._p = self.probs[0, 0].tolist()
            self._onehot = False
        else:
            self.halo = {"n": self.colors[0].copy(), "s": self.colors[-1].copy(),
                         "w": self.colors[:, 0].copy(), "e": self.colors[:, -1].copy()}
        if nbr_dirs is not None:
            # slots no injected neighbor feeds (degree < 4, e.g. a ring)
            # would stay frozen at the initial self-copy and register phantom
            # conflicts forever; -1 is a color no node ever holds
            for d in set("nswe") - set(nbr_dirs.values()):
                self.halo[d] = -1 if self.scalar \
                    else np.full_like(self.halo[d], -1)

    def neighbors(self) -> Dict[str, int]:
        gh, gw = self.grid
        r, c = divmod(self.pid, gw)
        out = {}
        if not self.self_wrap["ns"]:
            out["n"] = ((r - 1) % gh) * gw + c
            out["s"] = ((r + 1) % gh) * gw + c
        if not self.self_wrap["ew"]:
            out["w"] = r * gw + (c - 1) % gw
            out["e"] = r * gw + (c + 1) % gw
        return out

    def update(self, inbox: Dict[int, Optional[np.ndarray]]):
        scalar = self.scalar
        halo = self.halo
        if self.nbr_dirs is not None:
            # injected topology: any neighbor can feed any halo slot
            nbr_dirs = self.nbr_dirs
            if scalar:
                for nb, payload in inbox.items():
                    if payload is not None:
                        halo[nbr_dirs[nb]] = payload
                self._update_scalar()
                c = self._c
                return {nb: c for nb in nbr_dirs}
            for nb, payload in inbox.items():
                if payload is not None:
                    d = nbr_dirs[nb]
                    halo[d] = payload[_OPP[d]]
            self.colors, self.probs, _ = _update_block(
                self.colors, self.probs, halo, self.cfg.b, self.rng)
            edges = self._edges()
            return {nb: edges for nb in nbr_dirs}

        nbs = self.neighbors()
        # refresh halos from any fresh messages (stale otherwise)
        if scalar:
            for d, nb in nbs.items():
                payload = inbox.get(nb)
                if payload is not None:
                    halo[d] = payload
            if self.self_wrap["ns"]:
                halo["n"] = halo["s"] = self._c
            if self.self_wrap["ew"]:
                halo["w"] = halo["e"] = self._c
            self._update_scalar()
            c = self._c
            return {nb: c for nb in set(nbs.values())}

        for d, nb in nbs.items():
            payload = inbox.get(nb)
            if payload is not None:
                halo[d] = payload[_OPP[d]]
        if self.self_wrap["ns"]:
            halo["n"] = self.colors[-1]
            halo["s"] = self.colors[0]
        if self.self_wrap["ew"]:
            halo["w"] = self.colors[:, -1]
            halo["e"] = self.colors[:, 0]

        self.colors, self.probs, _ = _update_block(
            self.colors, self.probs, halo, self.cfg.b, self.rng)

        edges = self._edges()
        return {nb: edges for nb in set(nbs.values())}

    def adopt(self, state):
        """Resume from a carried ``(colors, probs)`` snapshot (service
        epochs, runtime/service.py).  Halos restart from own edges exactly
        like a fresh init — with the -1 sentinel on unfed slots — so a
        survivor's first window is a pure function of the carried block
        state, identical across engines."""
        self.colors = np.array(state["colors"], dtype=self.colors.dtype)
        self.probs = np.array(state["probs"], dtype=self.probs.dtype)
        if self.scalar:
            c = int(self.colors[0, 0])
            self._c = c
            self._p = self.probs[0, 0].tolist()
            self._onehot = max(self._p) >= 1.0
            self.halo = {"n": c, "s": c, "w": c, "e": c}
        else:
            self.halo = {"n": self.colors[0].copy(),
                         "s": self.colors[-1].copy(),
                         "w": self.colors[:, 0].copy(),
                         "e": self.colors[:, -1].copy()}
        if self.nbr_dirs is not None:
            for d in set("nswe") - set(self.nbr_dirs.values()):
                self.halo[d] = -1 if self.scalar \
                    else np.full_like(self.halo[d], -1)

    def _edges(self):
        return {"n": self.colors[0].copy(), "s": self.colors[-1].copy(),
                "w": self.colors[:, 0].copy(), "e": self.colors[:, -1].copy()}

    def _update_scalar(self):
        """1x1-block CFL update on plain python scalars — what lets a
        1024-process maximal-intensity sweep finish in interactive time.
        Payloads are bare color ints; ``colors``/``probs`` arrays are kept
        in sync so ``quality()`` and inspection still work."""
        halo = self.halo
        c = self._c
        if (c != halo["n"] and c != halo["s"]
                and c != halo["w"] and c != halo["e"]):
            if not self._onehot:
                p = [0.0] * self.cfg.n_colors
                p[c] = 1.0
                self._p = p
                self._onehot = True
                self.probs[0, 0] = p
            return
        b = self.cfg.b
        C = self.cfg.n_colors
        spread = b / (C - 1)
        p = [(1.0 - b) * v + (0.0 if k == c else spread)
             for k, v in enumerate(self._p)]
        u = self.rng.random()
        acc = 0.0
        new = C - 1
        for k, v in enumerate(p):
            acc += v
            if u <= acc:
                new = k
                break
        self._p = p
        self._onehot = False
        self.probs[0, 0] = p
        if new != c:
            self._c = new
            self.colors[0, 0] = new


_OPP = {"n": "s", "s": "n", "w": "e", "e": "w"}


class GraphColorApp:
    def __init__(self, cfg: GraphColorConfig, topology=None,
                 initial_state=None):
        self.cfg = cfg
        self.n_processes = cfg.n_processes
        self.grid = proc_grid(cfg.n_processes)
        self.block = block_shape(cfg.nodes_per_process)
        self.self_wrap = {"ns": self.grid[0] == 1, "ew": self.grid[1] == 1}
        if topology is not None:
            assert topology.n == cfg.n_processes, \
                f"topology is for {topology.n} processes, app has {cfg.n_processes}"
        self.injected = topology  # runtime.topologies.Topology or None
        # {seed: {pid: {"colors","probs"}}} — carried state for service
        # epochs (runtime/service.py).  Keyed by replicate seed so one app
        # instance serves the vectorized engine's whole replicate batch;
        # pids absent from the dict initialize fresh (rejoin semantics).
        self.initial_state = initial_state

    def make_fragments(self) -> List[_Fragment]:
        if self.injected is not None:
            no_wrap = {"ns": False, "ew": False}
            frags = [_Fragment(i, self.cfg, self.grid, self.block, no_wrap,
                               nbr_dirs=direction_map(self.injected.neighbors[i]))
                     for i in range(self.cfg.n_processes)]
        else:
            frags = [_Fragment(i, self.cfg, self.grid, self.block,
                               self.self_wrap)
                     for i in range(self.cfg.n_processes)]
        carried = (self.initial_state or {}).get(self.cfg.seed) or {}
        for f in frags:
            state = carried.get(f.pid)
            if state is not None:
                f.adopt(state)
        return frags

    def export_state(self, fragments) -> Dict[int, dict]:
        """Snapshot each fragment's carriable state (service epoch carry)."""
        return {f.pid: {"colors": np.asarray(f.colors).copy(),
                        "probs": np.asarray(f.probs).copy()}
                for f in fragments}

    def topology(self):
        if self.injected is not None:
            return self.injected
        out = {}
        for i in range(self.cfg.n_processes):
            f = _Fragment.__new__(_Fragment)
            f.pid, f.grid, f.self_wrap = i, self.grid, self.self_wrap
            out[i] = sorted(set(f.neighbors().values()) - {i})
        return out

    def batched(self, device="cuda") -> "BatchedGraphColor":
        """Population-batched entry point for the vectorized torch engine,
        holding its state on ``device``."""
        return BatchedGraphColor(self, device)

    def quality(self, fragments) -> float:
        """Exact remaining conflict count on the assembled global grid."""
        gh, gw = self.grid
        H, W = self.block
        full = np.zeros((gh * H, gw * W), dtype=int)
        for f in fragments:
            r, c = divmod(f.pid, gw)
            full[r * H:(r + 1) * H, c * W:(c + 1) * W] = f.colors
        conflicts = ((full == np.roll(full, 1, 0)).sum()
                     + (full == np.roll(full, 1, 1)).sum())
        return float(conflicts)


# ---------------------------------------------------------------------------
# Population-batched form — what the vectorized torch engine steps
# ---------------------------------------------------------------------------
def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class BatchedGraphColor:
    """All fragments' CFL updates as one step over population tensors.

    The same math as ``_update_block``, executed for the whole process
    population inside the vectorized engine's lockstep window.  Halo state
    lives in an ``(n, 4, L)`` int32 tensor the engine merges delivered edge
    payloads into; slots no injected neighbor feeds stay at the -1 sentinel
    (a color no node holds), matching ``_Fragment``.
    """

    def __init__(self, app: "GraphColorApp", device="cuda"):
        from repro_torch.runtime.topologies import halo_slot_map
        assert app.injected is not None, \
            "batched graphcolor needs an injected Topology"
        self.cfg = app.cfg
        self.app = app
        self.device = torch.device(device)
        self.n = app.cfg.n_processes
        self.H, self.W = app.block
        self.L = max(self.H, self.W)
        self.payload_len = self.L
        self.payload_dtype = torch.int32
        fed = np.zeros((self.n, 4), dtype=bool)
        for p in range(self.n):
            for s in halo_slot_map(app.injected.neighbors[p]).values():
                fed[p, s] = True
        self.fed = fed

    def _edges_np(self, colors: np.ndarray) -> np.ndarray:
        """(n, H, W) block colors -> (n, 4, L) n/s/w/e edge rows (0-padded)."""
        n, H, W = colors.shape
        out = np.zeros((n, 4, self.L), dtype=np.int32)
        out[:, 0, :W] = colors[:, 0, :]
        out[:, 1, :W] = colors[:, -1, :]
        out[:, 2, :H] = colors[:, :, 0]
        out[:, 3, :H] = colors[:, :, -1]
        return out

    def init(self, seed: int):
        """Initial ``(state, halo)``: the per-pid numpy RNG draws of the
        reference, moved to this app's device."""
        cfg, n, H, W = self.cfg, self.n, self.H, self.W
        colors = np.empty((n, H, W), np.int32)
        for p in range(n):
            rng = np.random.default_rng((seed, p))
            colors[p] = rng.integers(0, cfg.n_colors, size=(H, W))
        probs = np.full((n, H, W, cfg.n_colors), 1.0 / cfg.n_colors,
                        np.float32)
        carried = (self.app.initial_state or {}).get(int(seed)) or {}
        for p, state in carried.items():
            colors[p] = state["colors"]
            probs[p] = state["probs"]
        halo = np.where(self.fed[:, :, None], self._edges_np(colors),
                        np.int32(-1))
        state = dict(colors=torch.as_tensor(colors, device=self.device),
                     probs=torch.as_tensor(probs, device=self.device))
        return state, torch.as_tensor(halo, device=self.device)

    def export_state(self, state) -> Dict[int, dict]:
        """Per-pid numpy snapshot of one replicate's final app state, in the
        layout :meth:`GraphColorApp.export_state` produces."""
        colors = _np(state["colors"])
        probs = _np(state["probs"])
        return {p: {"colors": colors[p].copy(), "probs": probs[p].copy()}
                for p in range(self.n)}

    def step(self, state, halo, steps, seed, pids=None):
        """One population step.  ``pids`` are the original process ids of
        the rows in ``state`` (``None``: rows 0..n-1); the resample draws
        are keyed by them."""
        from repro_torch.runtime.window_core import STREAM_APP, hash_uniform
        H, W, L = self.H, self.W, self.L
        b, C = self.cfg.b, self.cfg.n_colors
        colors, probs = state["colors"], state["probs"]
        hn, hs = halo[:, 0, :W], halo[:, 1, :W]
        hw, he = halo[:, 2, :H], halo[:, 3, :H]

        up = torch.cat([hn[:, None, :], colors[:, :-1]], dim=1)
        down = torch.cat([colors[:, 1:], hs[:, None, :]], dim=1)
        left = torch.cat([hw[:, :, None], colors[:, :, :-1]], dim=2)
        right = torch.cat([colors[:, :, 1:], he[:, :, None]], dim=2)
        conflict = ((colors == up) | (colors == down)
                    | (colors == left) | (colors == right))
        onehot = torch.nn.functional.one_hot(colors.long(), C).to(
            torch.float32)
        fail_p = (1 - b) * probs + b * (1 - onehot) / (C - 1)
        new_probs = torch.where(conflict[..., None], fail_p, onehot)
        # counter-hash resample draw keyed by original pid and cell
        if pids is None:
            pids = torch.arange(colors.shape[0], dtype=torch.int32,
                                device=colors.device)
        cell = (pids[:, None, None] * (H * W)
                + torch.arange(H * W, dtype=torch.int32,
                               device=colors.device).reshape(H, W))
        u = hash_uniform(seed, STREAM_APP, steps[:, None, None], cell)
        # cumulative sum over the colour axis as explicit sequential adds,
        # so the summation order is pinned on every device
        acc = new_probs[..., 0]
        below = (u > acc).to(torch.int32)
        for k in range(1, C):
            acc = acc + new_probs[..., k]
            below = below + (u > acc).to(torch.int32)
        # clip: the float32 running sum can end a few ulps below 1
        sampled = torch.clamp(below, max=C - 1)
        new_colors = torch.where(conflict, sampled, colors)

        pad = torch.nn.functional.pad
        edges = torch.stack([
            pad(new_colors[:, 0, :], (0, L - W)),
            pad(new_colors[:, -1, :], (0, L - W)),
            pad(new_colors[:, :, 0], (0, L - H)),
            pad(new_colors[:, :, -1], (0, L - H))], dim=1)
        return dict(colors=new_colors, probs=new_probs), edges

    def quality(self, state) -> float:
        """Same global-conflict count as ``GraphColorApp.quality``."""
        colors = _np(state["colors"])
        gh, gw = self.app.grid
        H, W = self.H, self.W
        full = np.zeros((gh * H, gw * W), dtype=int)
        for p in range(self.n):
            r, c = divmod(p, gw)
            full[r * H:(r + 1) * H, c * W:(c + 1) * W] = colors[p]
        return float((full == np.roll(full, 1, 0)).sum()
                     + (full == np.roll(full, 1, 1)).sum())
