"""Driver for the paper's experiment families on the torch port.

  modes          asynchronicity-mode sweep: update rate + solution quality
                 under barrier / rolling / fixed / best-effort / no-comm
                 (paper §III-A/B)
  weak_scaling   QoS distributions while scaling the process count at fixed
                 work per process (paper §III-F)
  intensivity    communication-intensivity sweep: simels per process from
                 maximal (1) down to the benchmark parameterization (2048)
                 (paper §III-C/E)
  faults         an apparently-faulty host: extreme degradation inside its
                 clique, stable global medians (paper §III-G)
  serve          a live service: open-loop arrivals feed every process's
                 work queue, churn incidents split the run into epochs on
                 patched topologies, SLO verdicts score the QoS stream

Every family reports per-process QoS *distributions* — median + tail
percentiles over (process, window) samples — because under best-effort
communication the distribution, not a scalar, is the result.

Every family runs on either backend of the port's registry: ``--engine
torch`` (the vectorized windowed-time engine, the default) or ``--engine
event`` (the discrete-event reference).  ``--device`` picks where the torch
engine runs: ``cuda`` (the default; the duct phases run as hand-written
CUDA kernels) or ``cpu`` (their plain torch versions); asking for ``cuda``
without a card raises.  ``--superstep-windows W`` fuses W windows per ring
commit (bitwise-identical trajectories), ``--layout edge`` runs the
edge-major duct layout (one ring per edge), ``--replicates R`` sweeps R
seeds (one batch: every window runs once over all R replicates, each duct
kernel one launch a window), and ``--qos-interval`` pins the snapshot
spacing of the time-resolved ``qos_timeseries`` every row carries.
``--shards S`` partitions the population into S shards on the one device
(the sharded engine: boundary hops per shard offset), or, launched through
``python -m torch.distributed.run`` with ``--dist-backend nccl|gloo``
(and ``--dist-init``), over the ranks, each holding S / ranks of them and
computing exactly what one process computes (rank 0 prints); with it,
``--superstep-windows W`` runs W shard-local windows per exchange and
``--scheduler pipelined`` double-buffers that exchange.  ``--app`` picks
graph coloring or digital evolution (``evo``, float32 halos).  The
``serve`` family takes ``--traffic``, ``--arrival-rate``, ``--churn`` and
the ``--slo-*`` / ``--burn-*`` budgets (``runtime/service.py``).

CLI::

    python -m repro_torch.runtime.experiments \\
        --topology torus --procs 64 256 --engine torch

runs weak scaling on a torus at 64 and 256 processes on the card;
``--family all`` runs every family.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import time
from typing import Dict, List, Optional, Sequence

from repro_torch.core.modes import AsyncMode
from repro_torch.core.qos import METRICS, aggregate_reports, aggregate_timeseries
from repro_torch.core.slo import SloPolicy
from repro_torch.runtime.config import RunConfig
from repro_torch.runtime.engine import (ENGINES, make_engine, run_replicates,
                                        validate_run_config)
from repro_torch.runtime.faults import (crashed_host, faulty_host,
                                        flapping_host, lossy_host)
from repro_torch.runtime.service import default_timeline, run_service
from repro_torch.runtime.simulator import SimConfig
from repro_torch.runtime.topologies import TOPOLOGIES, Topology, make_topology

PERCENTILES = (50, 95)

_UNITS = {"simstep_period": ("us", 1e6), "simstep_latency": ("steps", 1.0),
          "walltime_latency": ("us", 1e6), "delivery_failure_rate": ("", 1.0),
          "delivery_clumpiness": ("", 1.0)}


def make_app(name: str, n: int, simels: int, topology: Optional[Topology],
             seed: int = 0, initial_state=None):
    if name == "graphcolor":
        from repro_torch.apps.graphcolor import GraphColorApp, GraphColorConfig
        return GraphColorApp(
            GraphColorConfig(n_processes=n, nodes_per_process=simels,
                             seed=seed), topology=topology,
            initial_state=initial_state)
    if name == "evo":
        # evo carries no state across service epochs; it restarts fresh
        from repro_torch.apps.evo import EvoApp, EvoConfig
        return EvoApp(EvoConfig(n_processes=n, cells_per_process=simels,
                                seed=seed), topology=topology)
    raise ValueError(f"unknown app {name!r} (graphcolor|evo)")


def _sim_config(args, n: int, mode: AsyncMode = AsyncMode.BEST_EFFORT,
                **overrides) -> SimConfig:
    # windows shrink with the horizon so every scale yields >= ~6 windows;
    # --qos-interval pins the snapshot spacing instead (time-resolved QoS)
    warmup = args.duration / 6
    interval = (args.qos_interval if args.qos_interval
                else args.duration / 12)
    base = dict(mode=mode, duration=args.duration,
                base_compute=args.base_compute,
                base_latency=args.base_latency,
                intra_node_latency=args.intra_latency,
                snapshot_warmup=warmup, snapshot_interval=interval,
                buffer_capacity=args.buffer, seed=args.seed,
                barrier_timeout=args.barrier_timeout)
    base.update(overrides)
    return SimConfig(**base)


def _engine_kwargs(args) -> dict:
    """The backend extras every engine of a run gets: the device, and
    under ranks the rank group the shards are split over."""
    group = getattr(args, "group", None)
    if group is None:
        return {"device": args.device}
    return {"device": args.device, "group": group}


def _engine(args, app, cfg, faults=None):
    return make_engine(args.run, app, cfg, faults, **_engine_kwargs(args))


def _distributions(res) -> Dict[str, Dict[str, float]]:
    return aggregate_reports(res.qos, percentiles=PERCENTILES)


def _print_distributions(dist, indent: str = "    "):
    for m in METRICS:
        unit, scale = _UNITS[m]
        parts = []
        for key, v in dist[m].items():
            if v is None:
                parts.append(f"{key}=n/a")
            else:
                parts.append(f"{key}={v * scale:.3f}{unit}")
        print(f"{indent}{m:<24} " + "  ".join(parts))


def _topology_for(args, n: int) -> Topology:
    kw = {}
    if args.topology == "cliques" and args.clique_size:
        kw["clique_size"] = args.clique_size
    return make_topology(args.topology, n, **kw)


# ---------------------------------------------------------------------------
# Families
# ---------------------------------------------------------------------------
def run_modes(args) -> List[dict]:
    n = args.procs[0]
    topo = _topology_for(args, n)
    print(f"[modes] app={args.app} topology={topo.name} n={n} "
          f"simels={args.simels} engine={args.engine} device={args.device}")
    rows = []
    for mode in AsyncMode:
        app = make_app(args.app, n, args.simels, topo, args.seed)
        res = _engine(args, app, _sim_config(args, n, mode=mode)).run()
        dist = _distributions(res)
        rows.append(dict(family="modes", mode=int(mode), n=n,
                         topology=topo.name, engine=args.engine,
                         device=args.device, run=args.run.to_dict(),
                         rate_per_cpu=res.update_rate_per_cpu,
                         quality=res.quality,
                         delivery_failure_rate=res.delivery_failure_rate,
                         qos=dist))
        print(f"  mode {int(mode)} ({mode.description}): "
              f"{res.update_rate_per_cpu:9.0f} upd/s/cpu  "
              f"quality={res.quality:.3f}  fail={res.delivery_failure_rate:.3f}")
    return rows


def run_weak_scaling(args) -> List[dict]:
    print(f"[weak_scaling] app={args.app} topology={args.topology} "
          f"simels={args.simels} duration={args.duration}s "
          f"engine={args.engine} device={args.device} "
          f"replicates={args.replicates} "
          f"superstep={args.superstep_windows} scheduler={args.scheduler}")
    rows = []
    for n in args.procs:
        topo = _topology_for(args, n)
        cfg = _sim_config(args, n)
        t0 = time.perf_counter()
        results = run_replicates(
            args.run,
            lambda s: make_app(args.app, n, args.simels, topo, s), cfg,
            **_engine_kwargs(args))
        wall = time.perf_counter() - t0
        # QoS distribution pools (process, window) samples over replicates
        all_qos = [q for res in results for q in res.qos]
        dist = aggregate_reports(all_qos, percentiles=PERCENTILES)
        series = aggregate_timeseries(
            [reps for res in results for reps in res.qos_by_process.values()],
            percentiles=PERCENTILES)
        rate = sum(r.update_rate_per_cpu for r in results) / len(results)
        updates = sum(sum(r.updates) for r in results)
        rows.append(dict(family="weak_scaling", n=n, topology=topo.name,
                         simels=args.simels, engine=args.engine,
                         device=args.device, run=args.run.to_dict(),
                         superstep_windows=args.superstep_windows,
                         scheduler=args.scheduler,
                         replicates=args.replicates, rate_per_cpu=rate,
                         updates=updates, wall_seconds=wall, qos=dist,
                         qos_timeseries=series))
        print(f"  n={n:<5} ({topo.name}, {updates} updates "
              f"in {wall:.1f}s wall, {len(series)} QoS intervals)")
        _print_distributions(dist)
    return rows


def run_intensivity(args) -> List[dict]:
    n = args.procs[0]
    topo = _topology_for(args, n)
    sweep = args.intensivity_simels
    print(f"[intensivity] app={args.app} topology={topo.name} n={n} "
          f"simels sweep={sweep} engine={args.engine} device={args.device}")
    rows = []
    for simels in sweep:
        # heavier blocks cost more virtual compute per update (2048 simels
        # ~ 200us, matching the benchmark parameterization)
        base = args.base_compute * (1 + simels / 160)
        app = make_app(args.app, n, simels, topo, args.seed)
        res = _engine(args, app, _sim_config(args, n, base_compute=base)).run()
        dist = _distributions(res)
        rows.append(dict(family="intensivity", n=n, simels=simels,
                         topology=topo.name, engine=args.engine,
                         device=args.device, run=args.run.to_dict(),
                         rate_per_cpu=res.update_rate_per_cpu, qos=dist))
        print(f"  simels/process={simels}")
        _print_distributions(dist)
    return rows


def _fault_model(args, topo, host):
    """Build the --fault-kind model for the faults family: slowdown = the
    paper's degraded host, crash = the host's processes die, lossy = clique
    links drop each message with probability --loss-prob, flap = clique
    links cycle down/up with down fraction --loss-prob."""
    if args.fault_kind == "crash":
        return crashed_host(topo, host)
    if args.fault_kind == "lossy":
        return lossy_host(topo, host, args.loss_prob)
    if args.fault_kind == "flap":
        return flapping_host(topo, host, args.loss_prob)
    return faulty_host(topo, host, args.fault_compute, args.fault_link)


def run_faults(args) -> List[dict]:
    n = args.procs[0]
    topo = _topology_for(args, n)
    host = args.faulty_host if args.faulty_host is not None else topo.n_nodes // 2
    victims = set(topo.host_pids(host))
    clique = set()
    for p in victims:
        clique.update(topo.clique_of(p))
    print(f"[faults] app={args.app} topology={topo.name} n={n} "
          f"faulty host={host} kind={args.fault_kind} ({len(victims)} "
          f"procs, clique of {len(clique)}) engine={args.engine} "
          f"device={args.device}")

    rows = []
    for label, faults in (("without_fault", None),
                          ("with_fault", _fault_model(args, topo, host))):
        app = make_app(args.app, n, args.simels, topo, args.seed)
        res = _engine(args, app, _sim_config(args, n), faults).run()
        groups = {
            "global": res.qos,
            "clique": [q for p in clique for q in res.qos_by_process[p]],
            "rest": [q for p in range(n) if p not in clique
                     for q in res.qos_by_process[p]],
        }
        by_proc = {
            "global": list(res.qos_by_process.values()),
            "clique": [res.qos_by_process[p] for p in sorted(clique)],
            "rest": [res.qos_by_process[p] for p in range(n)
                     if p not in clique],
        }
        row = dict(family="faults", label=label, n=n, topology=topo.name,
                   faulty_host=host, fault_kind=args.fault_kind,
                   engine=args.engine, device=args.device,
                   run=args.run.to_dict(),
                   qos={g: aggregate_reports(reps, PERCENTILES)
                        for g, reps in groups.items()},
                   qos_timeseries={
                       g: aggregate_timeseries(reps, PERCENTILES)
                       for g, reps in by_proc.items()})
        rows.append(row)
        print(f"  {label}:")
        for g in ("global", "clique", "rest"):
            print(f"   {g}:")
            _print_distributions(row["qos"][g], indent="      ")
    return rows


def run_serve(args) -> List[dict]:
    """Live-service scenario: open-loop traffic + churn + SLO verdicts.

    One long-running serve on the first ``--procs`` count: the
    ``--traffic`` arrival shape feeds every process's work queue at
    ``--arrival-rate``, ``--churn`` incidents (host fault/heal, process
    leave/join) split the run into epochs with patched topologies, and
    the per-interval QoS stream is scored against the ``--slo-*`` budgets
    (``runtime/service.py`` / ``core/slo.py``).
    """
    n = args.procs[0]
    topo = _topology_for(args, n)
    timeline = default_timeline(topo, args.churn, args.duration,
                                args.fault_compute, args.fault_link)
    policy = SloPolicy(latency_p99_budget=args.slo_latency,
                       failure_p99_budget=args.slo_failure,
                       burn_window=args.burn_window,
                       burn_threshold=args.burn_threshold)
    cfg = _sim_config(args, n, arrival_rate=args.arrival_rate,
                      arrival_shape=args.traffic)
    print(f"[serve] app={args.app} topology={topo.name} n={n} "
          f"traffic={args.traffic}@{args.arrival_rate:g}/s churn={args.churn} "
          f"engine={args.engine} device={args.device} "
          f"slo=(lat_p99<={policy.latency_p99_budget}, "
          f"fail_p99<={policy.failure_p99_budget})")
    out = run_service(
        args.run,
        lambda topology, s, init_state=None: make_app(
            args.app, topology.n, args.simels, topology, s,
            initial_state=init_state),
        cfg, topo, timeline, policy, **_engine_kwargs(args))
    for ep in out["epochs"]:
        print(f"  epoch {ep['epoch']}: t=[{ep['t_start']:.4f}, "
              f"{ep['t_end']:.4f}) procs={ep['n_procs']} "
              f"absent={ep['absent_pids']} faulty={ep['faulty_hosts']} "
              f"({ep['intervals']} intervals)")
    s = out["slo"]["summary"]
    svc = out["service"]
    print(f"  slo: {s['intervals']} intervals, {s['breaches']} breaches, "
          f"{s['no_data']} no-data, max_burn={s['max_burn_rate']:.2f} "
          f"-> {'OK' if s['ok'] else 'BREACH'}")
    print(f"  service: {svc['arrivals']} arrivals, {svc['served']} served, "
          f"{svc['backlog']} backlogged")
    _print_distributions(out["qos"])
    row = dict(family="serve", n=n, topology=topo.name, engine=args.engine,
               device=args.device, run=args.run.to_dict(),
               traffic=args.traffic, arrival_rate=args.arrival_rate,
               churn=args.churn, policy=dataclasses.asdict(policy), **out)
    return [row]


FAMILIES = {
    "modes": run_modes,
    "weak_scaling": run_weak_scaling,
    "intensivity": run_intensivity,
    "faults": run_faults,
    "serve": run_serve,
}


# ---------------------------------------------------------------------------
def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.runtime.experiments",
        description="Run the paper's experiment families on the torch port "
                    "of the best-effort runtime.")
    p.add_argument("--family", default="weak_scaling",
                   choices=[*FAMILIES, "all"])
    p.add_argument("--engine", default="torch", choices=sorted(ENGINES),
                   help="simulation backend: torch (vectorized windowed-time "
                        "engine) or event (discrete-event reference)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the torch engine runs: cuda (hand-written "
                        "CUDA duct kernels; raises without a card) or cpu "
                        "(plain torch versions)")
    p.add_argument("--replicates", type=int, default=1,
                   help="seeds per weak-scaling point (the torch engine "
                        "runs them as one batch)")
    p.add_argument("--superstep-windows", type=int, default=1,
                   help="windows per superstep: unsharded, fused per ring "
                        "commit (bitwise-identical trajectories); with "
                        "--shards, run shard-locally per boundary "
                        "exchange.  1 = per-window exchange")
    p.add_argument("--scheduler", default="auto",
                   choices=["auto", "window", "superstep", "pipelined"],
                   help="exchange cadence: window = every lockstep window, "
                        "superstep = W windows per exchange (needs "
                        "--superstep-windows > 1), pipelined = the sharded "
                        "superstep exchange double-buffered (needs "
                        "--shards > 1 and --superstep-windows > 1); auto "
                        "follows --superstep-windows")
    p.add_argument("--layout", default="auto",
                   choices=["auto", "dense", "edge"],
                   help="duct ring layout for --engine torch: dense = the "
                        "degree-bucketed receiver-major layout (auto "
                        "resolves to it on every built-in topology), edge "
                        "= one ring per canonical edge (unsharded: "
                        "per-window scheduler only)")
    p.add_argument("--shards", type=int, default=1,
                   help="contiguous process blocks the population is "
                        "partitioned into, all on the one device (must "
                        "divide --procs); 1 = the unsharded engine")
    p.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                   help="under torch.distributed.run (RANK, WORLD_SIZE and "
                        "LOCAL_RANK set), the backend the --shards are "
                        "split over the ranks with: nccl = one card a rank; "
                        "gloo = the CPU, or ranks sharing one card; no "
                        "default")
    p.add_argument("--dist-init", default=None,
                   help="the process group's init method under ranks, e.g. "
                        "file:///tmp/store (default env://, the launcher's "
                        "store)")
    p.add_argument("--qos-interval", type=float, default=None,
                   help="QoS snapshot spacing in virtual seconds for the "
                        "time-resolved stream (default: duration/12)")
    p.add_argument("--topology", default="torus", choices=sorted(TOPOLOGIES))
    p.add_argument("--procs", type=int, nargs="+", default=[64, 256],
                   help="process counts (weak_scaling sweeps them; other "
                        "families use the first)")
    p.add_argument("--app", default="graphcolor",
                   choices=["graphcolor", "evo"],
                   help="application: graphcolor (int32 halos) or evo "
                        "(digital evolution, float32 halos)")
    p.add_argument("--simels", type=int, default=1,
                   help="simulation elements per process (1 = maximal "
                        "communication intensivity)")
    p.add_argument("--duration", type=float, default=0.05,
                   help="virtual seconds per run")
    p.add_argument("--base-compute", type=float, default=15e-6)
    p.add_argument("--base-latency", type=float, default=550e-6)
    p.add_argument("--intra-latency", type=float, default=None,
                   help="same-host link latency (enables the hierarchical "
                        "link model; default: flat)")
    p.add_argument("--buffer", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--clique-size", type=int, default=None)
    p.add_argument("--intensivity-simels", type=int, nargs="+",
                   default=[1, 64, 2048])
    p.add_argument("--faulty-host", type=int, default=None)
    p.add_argument("--fault-compute", type=float, default=30.0)
    p.add_argument("--fault-link", type=float, default=30.0)
    p.add_argument("--fault-kind", default="slowdown",
                   choices=["slowdown", "crash", "lossy", "flap"],
                   help="faults-family fault type: slowdown = the paper's "
                        "degraded host (--fault-compute/--fault-link "
                        "factors), crash = the host's processes die, lossy "
                        "= clique links drop messages with probability "
                        "--loss-prob, flap = clique links cycle down/up "
                        "with down fraction --loss-prob")
    p.add_argument("--loss-prob", type=float, default=0.05,
                   help="per-send drop probability for --fault-kind lossy "
                        "(and the down fraction for flap)")
    p.add_argument("--barrier-timeout", type=float, default=0.0,
                   help="quarantine threshold tau in virtual seconds for "
                        "barrier modes: a process whose next barrier "
                        "arrival lags the cohort front by more than tau is "
                        "excluded from the release.  0 = plain barriers")
    # --- live-service family (--family serve) ---------------------------
    p.add_argument("--traffic", default="poisson",
                   choices=["poisson", "bursty", "diurnal"],
                   help="open-loop arrival shape feeding each process's "
                        "work queue (runtime/service.py)")
    p.add_argument("--arrival-rate", type=float, default=1e5,
                   help="mean arrivals per process per virtual second")
    p.add_argument("--churn", type=int, default=0,
                   help="churn incidents spread over the run: even "
                        "incidents fault+heal a host, odd ones make a "
                        "process leave+rejoin (duct rings spliced via "
                        "patch_topology)")
    p.add_argument("--slo-latency", type=float, default=50.0,
                   help="per-interval p99 simstep-latency budget (updates "
                        "per one-way delivery)")
    p.add_argument("--slo-failure", type=float, default=0.35,
                   help="per-interval p99 delivery-failure-rate budget")
    p.add_argument("--burn-window", type=int, default=5,
                   help="trailing data-bearing intervals in the burn-rate "
                        "window")
    p.add_argument("--burn-threshold", type=float, default=0.5,
                   help="burn rate above which an interval is marked "
                        "burning (sustained breach)")
    p.add_argument("--json", default=None, help="write rows to this path")
    return p


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    parser = build_parser()
    args = parser.parse_args(argv)
    # one frozen strategy carrier for every family, checked once against
    # the engine registry before any app or tensor is built
    try:
        args.run = RunConfig.from_args(args)
        validate_run_config(args.run)
    except ValueError as e:
        parser.error(str(e))
    undivided = [n for n in args.procs if n % args.shards]
    if undivided:
        parser.error(f"--shards {args.shards} must divide every --procs "
                     f"value; it does not divide {undivided}")
    if args.engine == "torch":
        # fail before any work when the card is asked for and missing
        from repro_torch.device import resolve_device
        resolve_device(args.device)
    rank = _init_ranks(args, parser)
    families = list(FAMILIES) if args.family == "all" else [args.family]
    rows: List[dict] = []
    # every rank runs every engine; rank 0 alone reports
    report = (contextlib.nullcontext() if rank == 0 else
              contextlib.redirect_stdout(io.StringIO()))
    try:
        with report:
            t0 = time.perf_counter()
            for fam in families:
                rows.extend(FAMILIES[fam](args))
            print(f"done in {time.perf_counter() - t0:.1f}s wall")
            if args.json and rank == 0:
                with open(args.json, "w") as f:
                    json.dump(rows, f, indent=1, default=float)
                print(f"wrote {args.json}")
    finally:
        if args.group is not None:
            import torch.distributed as dist
            dist.destroy_process_group()
    return rows


def _init_ranks(args, parser) -> int:
    """Join the ranks ``torch.distributed.run`` started (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK`` in the environment) and set
    ``args.group``, the rank group the ``--shards`` are split over; without
    those variables the run is one process (``args.group`` None).  Returns
    this process's rank."""
    args.group = None
    if "WORLD_SIZE" not in os.environ:
        if args.dist_backend or args.dist_init:
            parser.error("--dist-backend / --dist-init split the shards "
                         "over ranks; launch through python -m "
                         "torch.distributed.run (it sets RANK, WORLD_SIZE "
                         "and LOCAL_RANK)")
        return 0
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    if args.dist_backend is None:
        parser.error(f"rank {rank} of {world}: pass --dist-backend nccl (one "
                     "card a rank) or gloo (the CPU, or ranks sharing a "
                     "card)")
    if args.engine != "torch" or args.shards <= 1:
        parser.error("ranks split the torch engine's --shards; pass "
                     "--engine torch and --shards > 1")
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_shard_mesh
    if args.dist_backend == "nccl":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if world > cards or args.device != "cuda":
            parser.error(f"--dist-backend nccl puts one rank on each card: "
                         f"{world} ranks, {cards} visible card(s), device "
                         f"{args.device}; ranks sharing a card or the CPU "
                         "need --dist-backend gloo")
        torch.cuda.set_device(local)
    dist.init_process_group(args.dist_backend,
                            init_method=args.dist_init or "env://",
                            rank=rank, world_size=world)
    try:
        args.group = make_shard_mesh(args.shards, args.dist_backend,
                                     device=args.device, local_rank=local)
    except ValueError as e:
        dist.destroy_process_group()
        parser.error(str(e))
    return rank


if __name__ == "__main__":
    main()
