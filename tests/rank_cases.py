"""Gloo ranks on the CPU for the port's rank tests, and the cases they run.

``start(world, tmp_path, target, payload)`` spawns ``world`` processes
(``torch.multiprocessing``, the spawn start method) that join one gloo
process group through a ``file://`` store under ``tmp_path`` (no TCP
port is asked for; gloo's pairs use the loopback device), run
``target(rank, world, payload)`` (a function of this module) with one
torch thread each, and write what it returns to ``tmp_path``;
``Ranks.results()`` waits for them and reads it back, one entry a rank.
A rank that raises fails the wait with its traceback; a rank that hangs
fails it at ``TIMEOUT``.  A test module spawns once for a group of cases
and its parametrised asserts read the results.

The cases import no JAX: the test process builds the port's configs and
fault models (picklable) and passes them in the payload.
"""
from __future__ import annotations

import datetime
import os
import pickle
import time

import numpy as np
import torch
import torch.multiprocessing as mp

import torch_cases
from repro_torch.launch import mesh
from repro_torch.runtime.window_core import (LOCAL_RELEASE,
                                             PipelinedRankRelease,
                                             RankRelease)

#: seconds a spawn may take, and a collective may wait for a peer
TIMEOUT = 240


def _entry(rank, world, store, out_dir, target, payload):
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.set_num_threads(1)
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", init_method="file://" + store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT))
    try:
        out = globals()[target](rank, world, payload)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


class Ranks:
    """``world`` spawned gloo ranks running ``target``."""

    def __init__(self, world, tmp_path, target, payload):
        self.world = world
        self.out_dir = os.path.join(str(tmp_path), f"{target}-{world}")
        os.makedirs(self.out_dir, exist_ok=True)
        store = os.path.join(self.out_dir, "store")
        self.deadline = time.monotonic() + TIMEOUT
        self.ctx = mp.start_processes(
            _entry, args=(world, store, self.out_dir, target, payload),
            nprocs=world, join=False, start_method="spawn")

    def results(self):
        while not self.ctx.join(timeout=1):
            if time.monotonic() > self.deadline:
                for p in self.ctx.processes:
                    p.kill()
                raise TimeoutError(f"{self.world} ranks did not finish in "
                                   f"{TIMEOUT} s")
        out = []
        for r in range(self.world):
            with open(os.path.join(self.out_dir, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def start(world, tmp_path, target, payload=None) -> Ranks:
    return Ranks(world, tmp_path, target, payload)


def block(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's blocks of ``x`` along ``dim``."""
    return x.narrow(dim, group.lo, group.per).clone()


# ---------------------------------------------------------------------------
# mesh.hop and the release reductions
# ---------------------------------------------------------------------------
#: (blocks a rank, dim, offset, dtype) of the hop cases
HOP_CASES = [(per, dim, off, dtype)
             for per in (1, 2) for dim in (0, 1) for off in (1, -1, 3, -3)
             for dtype in ("int32",)] + [
    (2, 1, 3, "float32"), (2, 0, -1, "bool"), (1, 1, 5, "float32")]


def hop_input(world, per, dim, dtype):
    """The gathered tensor of a hop case: ``world * per`` blocks along
    ``dim``."""
    S = world * per
    shape = (S, 3, 2) if dim == 0 else (2, S, 3)
    x = torch.arange(int(np.prod(shape)), dtype=torch.int32).reshape(shape)
    if dtype == "float32":
        return x.to(torch.float32) * 0.5 - 7
    if dtype == "bool":
        return (x % 3) == 0
    return x * 7 - 11


def hop_cases(rank, world, payload):
    out = {}
    for case in HOP_CASES:
        per, dim, off, dtype = case
        group = mesh.make_shard_mesh(world * per, "gloo", device="cpu")
        x = hop_input(world, per, dim, dtype)
        out[case] = mesh.hop(block(x, dim, group), off, dim, group=group)
    return out


#: replicates and processes a rank of the release cases
RELEASE_R, RELEASE_N = 3, 5


def release_inputs(world, seed):
    """``(stopped, waiting, times, times2)`` over every rank's processes:
    replicate 0 all stopped and none waiting, replicate 1 all stopped but
    one, replicate 2 drawn; times with -inf (not waiting) and +inf (a
    crashed clock)."""
    rng = np.random.default_rng(seed)
    n = world * RELEASE_N
    stopped = rng.random((RELEASE_R, n)) < 0.8
    stopped[0] = True
    stopped[1] = True
    stopped[1, rng.integers(n)] = False
    waiting = rng.random((RELEASE_R, n)) < 0.3
    waiting[0] = False
    times = rng.standard_normal((RELEASE_R, n)).astype(np.float32)
    times[~waiting] = -np.inf
    times2 = rng.standard_normal((RELEASE_R, n)).astype(np.float32)
    times2[2, 0] = np.inf
    return tuple(torch.as_tensor(a) for a in (stopped, waiting, times,
                                              times2))


def releases(release, stopped, waiting, times, times2):
    """What a close phase asks of a release strategy, every way it asks."""
    return dict(
        all_stopped=release.all_stopped(stopped),
        any_waiting=release.any_waiting(waiting),
        max_time=release.max_time(times),
        reduce_all=release.reduce(stopped=stopped, waiting=waiting,
                                  times=(times, times2)),
        reduce_front=release.reduce(waiting=waiting, times=(times, times2)),
        reduce_stopped=release.reduce(stopped=stopped))


def release_cases(rank, world, payload):
    # the processes are the blocks: RELEASE_N a rank
    group = mesh.make_shard_mesh(world * RELEASE_N, "gloo", device="cpu")
    out = {}
    for seed in (0, 1, 2):
        local = [block(x, 1, group) for x in release_inputs(world, seed)]
        out[("rank", seed)] = releases(RankRelease(group), *local)
        out[("pipelined", seed)] = releases(PipelinedRankRelease(group),
                                            *local)
    return out


def local_releases(world, seed):
    return releases(LOCAL_RELEASE, *release_inputs(world, seed))


# ---------------------------------------------------------------------------
# the sharded engine
# ---------------------------------------------------------------------------
def engine_result(spec, group=None):
    """One engine run of ``spec`` (n, topology, seed, cfg, faults, RunConfig
    fields, seeds or None): ``(results, windows, windows_needed)``."""
    from repro_torch.runtime.config import RunConfig
    from repro_torch.runtime.engine import make_engine
    n, topology, seed, cfg, faults, run_kw, seeds = spec
    extra = {} if group is None else {"group": group}
    eng = make_engine(RunConfig(engine="torch", **run_kw),
                      torch_cases.torch_app(n, topology, seed), cfg, faults,
                      max_pops=64, chunk=64, device="cpu", **extra)
    res = ([eng.run()] if seeds is None else
           eng.run_replicates(list(seeds)))
    return res, list(eng.windows), list(eng.windows_needed)


def engine_cases(rank, world, payload):
    """The hop and release cases, every engine case of ``payload`` ({key:
    spec}) over the ranks with the stats of the collectives each issued,
    and the refusals."""
    out, stats = {}, {}
    for key, spec in payload.items():
        group = mesh.make_shard_mesh(spec[5]["shards"], "gloo",
                                     device="cpu")
        out[key] = engine_result(spec, group)
        stats[key] = dict(group.stats)
    return dict(hop=hop_cases(rank, world, None),
                release=release_cases(rank, world, None), results=out,
                stats=stats, negative=negative_cases(world))


def negative_cases(world):
    """Each call the rank path must refuse: ``{case: (exception type,
    message)}``, ``None`` where nothing was raised."""
    from repro_torch.runtime.config import RunConfig
    from repro_torch.runtime.engine import make_engine
    from repro_torch.runtime.simulator import SimConfig

    def app():
        return torch_cases.torch_app(16, "ring", 0)

    group = mesh.make_shard_mesh(2 * world, "gloo", device="cpu")
    calls = {
        "nccl_more_ranks_than_cards": lambda: mesh.make_shard_mesh(
            2 * world, "nccl", device="cpu"),
        "shards_not_a_multiple_of_ranks": lambda: mesh.make_shard_mesh(
            2 * world + 1, "gloo", device="cpu"),
        "backend_not_the_groups": lambda: mesh.make_shard_mesh(
            2 * world, "mpi", device="cpu"),
        "engine_shards_not_the_groups": lambda: make_engine(
            RunConfig(engine="torch", shards=4 * world), app(),
            SimConfig(duration=1e-3), device="cpu", group=group),
        "group_without_shards": lambda: make_engine(
            RunConfig(engine="torch"), app(), SimConfig(duration=1e-3),
            device="cpu", group=group),
        "hop_of_the_wrong_blocks": lambda: mesh.hop(
            torch.zeros(3, 2), 1, 0, group=group),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except Exception as e:  # the test reads the type and message
            out[name] = (type(e).__name__, str(e))
    return out


# ---------------------------------------------------------------------------
# the SPMD tools
# ---------------------------------------------------------------------------
def grad_like(gen, shape):
    x = torch.randn(shape, generator=gen)
    return x * 10.0 ** (-6 * torch.rand(shape[:-1] + (1,), generator=gen))


#: pods of the collective cases and the leaves of their trees
PODS = 4
LEAVES = {"w": (PODS, 6, 40), "b": (PODS, 96)}


def collective_inputs():
    gen = torch.Generator().manual_seed(3)
    return {tag: {k: grad_like(gen, s) * (1e-3 if tag == "res" else 1)
                  for k, s in LEAVES.items()}
            for tag in ("g1", "g2", "res", "params")}


def compressors():
    from repro_torch.optim.compression import Int8Compressor, TopKCompressor
    return {"plain": None, "int8": Int8Compressor(block=64),
            "topk": TopKCompressor(ratio=0.25)}


def collective_results(inputs, group=None):
    """Every collective over the trees of ``inputs`` (each leaf's pods
    this rank's, over ``group``)."""
    from repro_torch.core import collectives
    from repro_torch.core.modes import AsyncMode

    def copy(tree):
        return {k: v.clone() for k, v in tree.items()}

    out = {}
    for name, comp in compressors().items():
        res = copy(inputs["res"])
        total, _ = collectives.cross_pod_sum(inputs["g1"], 0, comp, res,
                                             group=group)
        out[("cross_pod_sum", name)] = (total, res)
        if comp is not None:
            out[("cross_pod_sum_zero_residuals", name)] = \
                collectives.cross_pod_sum(inputs["g1"], 0, comp,
                                          group=group)
    for mode in AsyncMode:
        for name, comp in compressors().items():
            if comp is not None and mode != AsyncMode.BEST_EFFORT:
                continue
            st = collectives.init_exchange_state(inputs["g1"], mode, comp)
            e1, st = collectives.exchange_gradients(
                inputs["g1"], st, mode, 0, comp, group=group)
            e2, st = collectives.exchange_gradients(
                inputs["g2"], st, mode, 0, comp, group=group)
            out[("exchange_gradients", int(mode), name)] = (e1, e2, st)
    out["pod_mean"] = collectives.pod_mean(inputs["params"], 0, group=group)
    for sync in (False, True):
        out[("maybe_param_sync", sync)] = collectives.maybe_param_sync(
            inputs["params"], torch.tensor(sync), 0, group=group)
    return out


#: the SPMD mesh (rows split over the ranks), its blocks and steps
SPMD_MESH, SPMD_BLOCK, SPMD_STEPS = (4, 2), (8, 8), 20
#: (mode, flush every k steps or None) of the spmd_step runs
SPMD_MODES = (("best_effort", None), ("barrier", None), ("rolling", 4),
              ("no_comm", None))


def spmd_results(group=None):
    """``SPMD_STEPS`` steps of ``spmd_step`` in each mode: the final state
    and the conflicts of every step."""
    from repro_torch.apps import graphcolor
    from repro_torch.core.conduit import torus_conduits
    from repro_torch.core.modes import AsyncMode
    modes = {"best_effort": AsyncMode.BEST_EFFORT,
             "barrier": AsyncMode.BARRIER_EVERY_STEP,
             "rolling": AsyncMode.ROLLING_BARRIER,
             "no_comm": AsyncMode.NO_COMM}
    out = {}
    for label, every in SPMD_MODES:
        rowc, colc = torus_conduits(("row", "col"), modes[label], group)
        state = graphcolor.init_spmd_state(SPMD_MESH, SPMD_BLOCK, 3, rowc,
                                           colc, seed=5, device="cpu")
        confs = []
        for _ in range(SPMD_STEPS):
            flush = (None if every is None else
                     (state["step"] % every) == every - 1)
            state, conf = graphcolor.spmd_step(state, rowc, colc, 0.1,
                                               flush=flush)
            confs.append(conf)
        out[label] = (state, torch.stack(confs))
    return out


#: (blocks, dim, shift) of the ring exchanges
RING_CASES = ((PODS, 0, 1), (PODS, 0, -1), (PODS, 0, 3), (2 * PODS, 1, -3))


def ring_input(blocks, dim):
    shape = (blocks, 5) if dim == 0 else (3, blocks, 2)
    return torch.arange(int(np.prod(shape)), dtype=torch.float32
                        ).reshape(shape) * 0.25


def spmd_cases(rank, world, payload):
    from repro_torch.core.conduit import ring_exchange
    pods = mesh.make_shard_mesh(PODS, "gloo", device="cpu")
    inputs = {tag: {k: block(v, 0, pods) for k, v in tree.items()}
              for tag, tree in collective_inputs().items()}
    rows = mesh.make_shard_mesh(SPMD_MESH[0], "gloo", device="cpu")
    rings = {}
    for case in RING_CASES:
        blocks, dim, shift = case
        g = mesh.make_shard_mesh(blocks, "gloo", device="cpu")
        rings[case] = ring_exchange(block(ring_input(blocks, dim), dim, g),
                                    dim, shift, group=g)
    return dict(ring=rings, collectives=collective_results(inputs, pods),
                spmd=spmd_results(rows))


# ---------------------------------------------------------------------------
# training's pod axis
# ---------------------------------------------------------------------------
#: the reduced archs, (mode, compressor) cases, batch, sequence and steps
#: of the training cases
TRAIN_ARCHS = ("qwen2-1.5b", "qwen3-0.6b")
TRAIN_MODES = ((0, None), (1, None), (2, None), (3, None), (3, "int8"),
               (3, "topk"), (4, None))
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 32, 3
#: (ranks, pods a rank) of the training layouts
TRAIN_LAYOUTS = ((2, 1), (2, 2), (4, 1))


def train_cfg(arch):
    from repro_torch.configs import get_config
    from repro_torch.configs.smoke import reduce_for_smoke
    return reduce_for_smoke(get_config(arch)).replace(dtype="float32")


def train_spec(mode, compressor):
    from repro_torch.core.modes import AsyncMode
    from repro_torch.launch import train
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.outer import OuterConfig
    return train.TrainSpec(
        mode=AsyncMode(mode), compressor=compressor,
        adamw=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20),
        outer=OuterConfig(sync_period=2))


def train_batches(cfg, n_pods, steps=TRAIN_STEPS):
    """Each step's batch, (n_pods, B / n_pods, S), from one stream."""
    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    src = SyntheticLM(DataConfig(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=2))
    return [{k: torch.as_tensor(v).reshape(n_pods, -1, TRAIN_S)
             for k, v in src.batch_for_step(k).items()}
            for k in range(steps)]


def train_result(arch, mode, compressor, n_pods, group=None):
    """``TRAIN_STEPS`` steps from the seed-0 state at ``n_pods`` (over
    ``group``, this rank's pods of each batch): (final state, every
    step's metrics)."""
    from repro_torch.launch import train
    cfg, spec = train_cfg(arch), train_spec(mode, compressor)
    state = train.init_train_state(cfg, spec, n_pods, device="cpu",
                                   group=group)
    step = train.make_train_step(cfg, spec, n_pods, group)
    lo, per = (0, n_pods) if group is None else (group.lo, group.per)
    metrics = []
    for b in train_batches(cfg, n_pods):
        state, m = step(state, {k: v[lo:lo + per] for k, v in b.items()})
        metrics.append(m)
    return state, metrics


#: the checkpoint runs: arch, mode, compressor, pods
CKPT_CASE = ("qwen2-1.5b", 3, "topk", 2)


def ckpt_run(ckpt_dir, steps, ckpt_every, group=None, log=None):
    """``run_training`` of ``CKPT_CASE`` with checkpoints in ``ckpt_dir``:
    the history."""
    from repro_torch.data.synthetic import DataConfig
    from repro_torch.launch import train
    arch, mode, comp, n_pods = CKPT_CASE
    cfg = train_cfg(arch)
    _, history = train.run_training(
        cfg, train_spec(mode, comp),
        DataConfig(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=2), steps=steps,
        ckpt_dir=ckpt_dir, ckpt_every=ckpt_every, n_pods=n_pods,
        log_every=1, log=log or (lambda _: None), device="cpu", group=group)
    return history


def train_negative_cases(world):
    """Each call the pod path over ranks must refuse: ``{case: (exception
    type, message)}``, ``None`` where nothing was raised."""
    from unittest import mock

    from repro_torch.launch import train
    cfg, spec = train_cfg("qwen2-1.5b"), train_spec(3, "int8")
    group = mesh.make_shard_mesh(world, "gloo", device="cpu")

    def cards(n):
        return mock.patch.multiple(torch.cuda, is_available=lambda: True,
                                   device_count=lambda: n)

    def nccl_on_a_gloo_group():
        with cards(world):
            mesh.make_shard_mesh(world, "nccl", device="cpu")

    def wrong_batch():
        step = train.make_train_step(cfg, spec, world, group)
        state = train.init_train_state(cfg, spec, world, device="cpu",
                                       group=group)
        step(state, {k: v[:2] for k, v in
                     train_batches(cfg, world, 1)[0].items()})

    calls = {
        "pods_not_a_multiple_of_ranks": lambda: mesh.make_shard_mesh(
            2 * world + 1, "gloo", device="cpu"),
        "nccl_more_ranks_than_cards": lambda: mesh.make_shard_mesh(
            world, "nccl", device="cpu"),
        "backend_not_the_groups": nccl_on_a_gloo_group,
        "state_of_other_pods": lambda: train.init_train_state(
            cfg, spec, 2 * world, device="cpu", group=group),
        "step_of_other_pods": lambda: train.make_train_step(
            cfg, spec, 2 * world, group),
        "batch_of_other_pods": wrong_batch,
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except Exception as e:  # the test reads the type and message
            out[name] = (type(e).__name__, str(e))
    return out


def train_cases(rank, world, payload):
    """Every training case of ``payload`` ({"cases": [(arch, mode,
    compressor, pods a rank)], "ckpt": dirs or None}) over the ranks, each
    with its group's stats, then the checkpoint runs and the refusals."""
    out, stats = {}, {}
    for case in payload["cases"]:
        arch, mode, comp, per = case
        group = mesh.make_shard_mesh(world * per, "gloo", device="cpu")
        out[case] = train_result(arch, mode, comp, world * per, group)
        stats[case] = dict(group.stats)
    ckpt = {}
    if payload.get("ckpt"):
        group = mesh.make_shard_mesh(CKPT_CASE[3], "gloo", device="cpu")
        written, restored = payload["ckpt"]
        logs = []
        ckpt["written"] = ckpt_run(written, 2, 2, group)
        ckpt["restored"] = ckpt_run(restored, 3, 1, group, logs.append)
        ckpt["logs"] = logs
    return dict(results=out, stats=stats, ckpt=ckpt,
                negative=train_negative_cases(world))
