"""Digital-evolution benchmark analogue (paper §II-A, DISHTINY-flavored).

A compute-heavy artificial-life workload: each fragment hosts a toroidal
grid of cells with genomes (fixed-length integer programs), resource levels,
and neighbor interactions.  Per update every cell "executes" its genome for
several rounds (vectorized integer arithmetic standing in for SignalGP
interpretation — the compute-heavy part), collects resource, shares resource
across fragment boundaries via best-effort channels, and reproduces into the
weakest neighboring cell when its resource exceeds a threshold.

Quality (the paper leaves open-ended-evolution quality undefined) is the mean
genome fitness toward a fixed target pattern — monotone-improving, so
fixed-time-budget comparisons across asynchronicity modes are meaningful.

Two implementations share the same math:
  - numpy fragments for the discrete-event runtime;
  - ``BatchedEvo``, the whole population's step on torch tensors, which
    the vectorized torch engine runs every lockstep window.  Its halos are
    float32 rows, so it is the workload that drives the duct kernels'
    float32 payloads.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.apps.graphcolor import (
    _OPP,
    _np,
    block_shape,
    direction_map,
    proc_grid,
)


@dataclasses.dataclass(frozen=True)
class EvoConfig:
    n_processes: int = 4
    cells_per_process: int = 3600      # paper: 3600 cells per process
    genome_len: int = 16
    exec_rounds: int = 8               # genome interpretation rounds/update
    resource_inflow: float = 0.25
    spawn_threshold: float = 1.0
    share_frac: float = 0.1            # resource shared to each neighbor side
    mutation_rate: float = 0.05
    seed: int = 0


class _Fragment:
    def __init__(self, pid, cfg: EvoConfig, grid, block, self_wrap,
                 nbr_dirs: Optional[Dict[int, str]] = None):
        self.pid = pid
        self.cfg = cfg
        self.grid = grid
        self.self_wrap = self_wrap
        self.nbr_dirs = nbr_dirs  # injected topology: neighbor -> halo slot
        # halo slots no injected neighbor feeds behave reflectively (mirror
        # our own edge) instead of draining resource into phantom zeros
        self._unfed = (set("nswe") - set(nbr_dirs.values())
                       if nbr_dirs is not None else set())
        H, W = block
        self.rng = np.random.default_rng((cfg.seed, pid))
        self.genomes = self.rng.integers(0, 256, size=(H, W, cfg.genome_len),
                                         dtype=np.int64)
        self.resource = np.zeros((H, W))
        self.target = np.arange(cfg.genome_len, dtype=np.int64) * 16 % 256
        self.halo_res = {"n": np.zeros(W), "s": np.zeros(W),
                         "w": np.zeros(H), "e": np.zeros(H)}

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

    # -- the compute-heavy part ---------------------------------------------
    def _execute_genomes(self):
        """Vectorized 'interpretation': repeated integer mixing rounds."""
        g = self.genomes
        acc = np.zeros(g.shape[:2], dtype=np.int64)
        state = g.sum(axis=-1)
        for r in range(self.cfg.exec_rounds):
            instr = g[..., r % self.cfg.genome_len]
            state = (state * 6364136223846793005 + instr * 1442695040888963407
                     ) & 0x7FFFFFFFFFFFFFFF
            acc ^= state >> 17
        return acc

    def fitness(self) -> np.ndarray:
        """Per-cell fitness in [0,1]: genome proximity to the target."""
        diff = np.abs(self.genomes - self.target[None, None, :])
        return 1.0 - diff.mean(axis=-1) / 128.0

    def update(self, inbox: Dict[int, Optional[dict]]):
        cfg = self.cfg
        if self.nbr_dirs is not None:
            for nb, payload in inbox.items():
                if payload is not None:
                    d = self.nbr_dirs[nb]
                    self.halo_res[d] = payload[_OPP[d]]
            r = self.resource
            own_edge = {"n": r[0], "s": r[-1], "w": r[:, 0], "e": r[:, -1]}
            for d in self._unfed:
                self.halo_res[d] = own_edge[d]
        else:
            nbs = self.neighbors()
            for d, nb in nbs.items():
                payload = inbox.get(nb)
                if payload is not None:
                    self.halo_res[d] = payload[_OPP[d]]

        self._execute_genomes()  # compute-heavy interpretation step

        fit = self.fitness()
        self.resource += cfg.resource_inflow * fit

        # resource sharing: diffuse with 4 neighbors (internal + halo)
        r = self.resource
        up = np.vstack([self.halo_res["n"][None], r[:-1]]) if not self.self_wrap["ns"] \
            else np.vstack([r[-1:], r[:-1]])
        down = np.vstack([r[1:], self.halo_res["s"][None]]) if not self.self_wrap["ns"] \
            else np.vstack([r[1:], r[:1]])
        left = np.hstack([self.halo_res["w"][:, None], r[:, :-1]]) if not self.self_wrap["ew"] \
            else np.hstack([r[:, -1:], r[:, :-1]])
        right = np.hstack([r[:, 1:], self.halo_res["e"][:, None]]) if not self.self_wrap["ew"] \
            else np.hstack([r[:, 1:], r[:, :1]])
        mean_nb = (up + down + left + right) / 4.0
        self.resource = (1 - cfg.share_frac) * r + cfg.share_frac * mean_nb

        # reproduction: spawners overwrite their weakest rolled neighbor
        spawners = self.resource > cfg.spawn_threshold
        if spawners.any():
            fit_rolled = np.stack([np.roll(fit, s, axis=a)
                                   for s, a in ((1, 0), (-1, 0), (1, 1), (-1, 1))])
            weakest_dir = fit_rolled.argmin(axis=0)
            shifts = [(1, 0), (-1, 0), (1, 1), (-1, 1)]
            new_genomes = self.genomes.copy()
            new_resource = self.resource.copy()
            ys, xs = np.where(spawners)
            H, W = fit.shape
            for y, x in zip(ys, xs):
                s, a = shifts[weakest_dir[y, x]]
                # np.roll(fit, s, a)[y, x] == fit[y-s, x] — the weakest
                # neighbor sits at the NEGATIVE offset
                ty = (y - (s if a == 0 else 0)) % H
                tx = (x - (s if a == 1 else 0)) % W
                child = self.genomes[y, x].copy()
                mut = self.rng.random(cfg.genome_len) < cfg.mutation_rate
                child[mut] = np.clip(
                    child[mut] + self.rng.integers(-16, 17, mut.sum()), 0, 255)
                # nudge toward target occasionally (selection pressure proxy)
                new_genomes[ty, tx] = child
                new_resource[y, x] *= 0.5
            self.genomes = new_genomes
            self.resource = new_resource

        edges = {"n": self.resource[0].copy(), "s": self.resource[-1].copy(),
                 "w": self.resource[:, 0].copy(), "e": self.resource[:, -1].copy()}
        if self.nbr_dirs is not None:
            return {nb: edges for nb in self.nbr_dirs}
        return {nb: edges for nb in set(nbs.values())}


# ---------------------------------------------------------------------------
# Population-batched form — what the vectorized torch engine steps
# ---------------------------------------------------------------------------
class BatchedEvo:
    """All fragments' evolution updates as one step over population tensors.

    Mirrors ``_Fragment.update``: genome interpretation (uint32 mixing
    rounds; the accumulator is carried in the state), resource inflow and
    diffusion over halo rows, and reproduction into the weakest rolled
    neighbor (conflicting spawners resolve last-direction-wins).  Halo
    slots no injected neighbor feeds behave reflectively, as in the
    event-engine fragment.

    torch has few uint32 operations, so the mixing state and ``acc`` are
    int64 tensors holding uint32 values in [0, 2**32) (``interop`` turns
    ``acc`` back into uint32).  The float32 operations run in the
    reference's order, so a run whose inputs are exact reproduces the
    reference bit for bit.
    """

    _SHIFTS = ((1, 0), (-1, 0), (1, 1), (-1, 1))

    def __init__(self, app: "EvoApp", device="cuda"):
        from repro_torch.runtime.topologies import halo_slot_map
        assert app.injected is not None, \
            "batched evo needs an injected Topology"
        self.cfg = app.cfg
        self.device = torch.device(device)
        self.n = app.cfg.n_processes
        self.H, self.W = app.block
        self.L = max(self.H, self.W)
        self.payload_len = self.L
        self.payload_dtype = torch.float32
        self.target = (np.arange(app.cfg.genome_len, dtype=np.int32)
                       * 16 % 256)
        self._target = torch.as_tensor(self.target, device=self.device)
        fed = np.zeros((self.n, 4), dtype=bool)
        for p in range(self.n):
            for s in halo_slot_map(app.injected.neighbors[p]).values():
                fed[p, s] = True
        self.fed = torch.as_tensor(fed, device=self.device)

    def init(self, seed: int):
        """Initial ``(state, halo)``: the per-pid numpy RNG draws of the
        reference, moved to this app's device."""
        cfg, n, H, W = self.cfg, self.n, self.H, self.W
        genomes = np.empty((n, H, W, cfg.genome_len), np.int32)
        for p in range(n):
            rng = np.random.default_rng((seed, p))
            genomes[p] = rng.integers(0, 256, size=(H, W, cfg.genome_len))
        dev = self.device
        state = dict(genomes=torch.as_tensor(genomes, device=dev),
                     resource=torch.zeros((n, H, W), dtype=torch.float32,
                                          device=dev),
                     acc=torch.zeros((n, H, W), dtype=torch.int64,
                                     device=dev))
        return state, torch.zeros((n, 4, self.L), dtype=torch.float32,
                                  device=dev)

    def _own_edges(self, r):
        """(..., n, H, W) resource -> (..., n, 4, L) n/s/w/e edge rows
        (0-padded)."""
        L, H, W = self.L, self.H, self.W
        pad = torch.nn.functional.pad
        return torch.stack([
            pad(r[..., 0, :], (0, L - W)), pad(r[..., -1, :], (0, L - W)),
            pad(r[..., 0], (0, L - H)), pad(r[..., -1], (0, L - H))],
            dim=-2)

    def step(self, state, halo, steps, seed, pids=None):
        """One population step over ``(..., n, H, W)`` blocks: any leading
        dims (the engine's replicate axis) are batch, ``steps`` and
        ``seed`` are shaped like the leading dims and the process axis
        (``seed`` may be 0-dim, or ``(R, 1)``).  ``pids`` are the original
        process ids of the rows in ``state`` (``None``: rows 0..n-1); the
        mutation draws are keyed by them."""
        from repro_torch.runtime.window_core import (M32, STREAM_MUT,
                                                     hash_uniform, mul32)
        cfg, H, W = self.cfg, self.H, self.W
        g, r = state["genomes"], state["resource"]
        G = cfg.genome_len
        dev = g.device

        # reflective unfed slots: mirror our own edge, never drain resource
        fed = self.fed if pids is None else self.fed[pids.long()]
        halo_eff = torch.where(fed[..., None], halo, self._own_edges(r))
        hn, hs = halo_eff[..., 0, :W], halo_eff[..., 1, :W]
        hw, he = halo_eff[..., 2, :H], halo_eff[..., 3, :H]

        # genome "interpretation": uint32 mixing rounds (compute-heavy),
        # each value an int64 in [0, 2**32)
        st = g.sum(dim=-1, dtype=torch.int32).to(torch.int64) & M32
        acc = state["acc"]
        for rr in range(cfg.exec_rounds):
            instr = g[..., rr % G].to(torch.int64) & M32
            st = (mul32(st, 2654435761) + mul32(instr, 2246822519)) & M32
            acc = acc ^ (st >> 17)

        # the mean of integer distances in float32, as jnp.mean computes it
        dist = (g - self._target).abs().to(torch.float32).sum(dim=-1)
        fit = 1.0 - dist / float(G) / 128.0
        r = r + cfg.resource_inflow * fit

        # resource diffusion over internal cells + halo rows (no wrap)
        up = torch.cat([hn[..., None, :], r[..., :-1, :]], dim=-2)
        down = torch.cat([r[..., 1:, :], hs[..., None, :]], dim=-2)
        left = torch.cat([hw[..., None], r[..., :-1]], dim=-1)
        right = torch.cat([r[..., 1:], he[..., None]], dim=-1)
        mean_nb = (up + down + left + right) / 4.0
        r = (1 - cfg.share_frac) * r + cfg.share_frac * mean_nb

        # reproduction: spawners overwrite their weakest rolled neighbor
        spawn = r > cfg.spawn_threshold
        fit_rolled = torch.stack([torch.roll(fit, s, dims=a - 2)
                                  for s, a in self._SHIFTS])
        weakest = fit_rolled.argmin(dim=0)     # the first minimum, as jnp
        # cells keyed by original pid
        if pids is None:
            pids = torch.arange(g.shape[-4], dtype=torch.int32, device=dev)
        cell = (pids.to(torch.int64)[:, None, None, None] * (H * W * G)
                + torch.arange(H * W * G, dtype=torch.int64,
                               device=dev).reshape(H, W, G))
        step_k = steps[..., None, None, None]
        seed_k = seed[..., None, None, None]
        mut = hash_uniform(seed_k, STREAM_MUT, step_k, cell) < float(
            np.float32(cfg.mutation_rate))
        delta = torch.floor(
            hash_uniform(seed_k, STREAM_MUT, step_k, cell, 7) * 33
        ).to(torch.int32) - 16
        child = torch.clamp(g + torch.where(mut, delta, 0), 0, 255)
        new_g = g
        for d, (s, a) in enumerate(self._SHIFTS):
            lands = torch.roll(spawn & (weakest == d), -s, dims=a - 2)
            new_g = torch.where(lands[..., None],
                                torch.roll(child, -s, dims=a - 3), new_g)
        r = torch.where(spawn, r * 0.5, r)

        state = dict(genomes=new_g, resource=r, acc=acc)
        return state, self._own_edges(r)

    def quality(self, state) -> float:
        """Mean genome fitness toward the target, as ``EvoApp.quality``."""
        g = _np(state["genomes"])
        diff = np.abs(g - self.target[None, None, None, :])
        return float((1.0 - diff.mean(axis=-1) / 128.0).mean())


class EvoApp:
    def __init__(self, cfg: EvoConfig, topology=None):
        self.cfg = cfg
        self.n_processes = cfg.n_processes
        self.grid = proc_grid(cfg.n_processes)
        self.block = block_shape(cfg.cells_per_process)
        self.self_wrap = {"ns": self.grid[0] == 1, "ew": self.grid[1] == 1}
        if topology is not None:
            assert topology.n == cfg.n_processes, \
                f"topology is for {topology.n} processes, app has {cfg.n_processes}"
        self.injected = topology  # runtime.topologies.Topology or None

    def make_fragments(self) -> List[_Fragment]:
        if self.injected is not None:
            no_wrap = {"ns": False, "ew": False}
            return [_Fragment(i, self.cfg, self.grid, self.block, no_wrap,
                              nbr_dirs=direction_map(self.injected.neighbors[i]))
                    for i in range(self.cfg.n_processes)]
        return [_Fragment(i, self.cfg, self.grid, self.block, self.self_wrap)
                for i in range(self.cfg.n_processes)]

    def topology(self):
        if self.injected is not None:
            return self.injected
        out = {}
        for i in range(self.cfg.n_processes):
            f = _Fragment.__new__(_Fragment)
            f.pid, f.grid, f.self_wrap = i, self.grid, self.self_wrap
            out[i] = sorted(set(f.neighbors().values()) - {i})
        return out

    def batched(self, device="cuda") -> "BatchedEvo":
        """Population-batched entry point for the vectorized torch engine,
        holding its state on ``device``."""
        return BatchedEvo(self, device)

    def quality(self, fragments) -> float:
        return float(np.mean([f.fitness().mean() for f in fragments]))
