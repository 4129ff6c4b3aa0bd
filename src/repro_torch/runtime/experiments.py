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

Every family reports per-process QoS *distributions* — median + tail
percentiles over (process, window) samples — because under best-effort
communication the distribution, not a scalar, is the result.

Every family runs on either backend of the port's registry: ``--engine
torch`` (the vectorized windowed-time engine, the default) or ``--engine
event`` (the discrete-event reference).  ``--device`` picks where the torch
engine runs: ``cuda`` (the default; the duct phases run as hand-written
CUDA kernels) or ``cpu`` (their plain torch versions); asking for ``cuda``
without a card raises.  ``--superstep-windows W`` fuses W windows per ring
commit (bitwise-identical trajectories), ``--replicates R`` sweeps R seeds
(run one after another), and ``--qos-interval`` pins the snapshot spacing
of the time-resolved ``qos_timeseries`` every row carries.  The ``serve``
family and the ``evo`` app are not ported yet and are refused with a
pointer to the reference.

CLI::

    python -m repro_torch.runtime.experiments \\
        --topology torus --procs 64 256 --engine torch

runs weak scaling on a torus at 64 and 256 processes on the card;
``--family all`` runs every ported family.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional, Sequence

from repro_torch.core.modes import AsyncMode
from repro_torch.core.qos import METRICS, aggregate_reports, aggregate_timeseries
from repro_torch.runtime.config import RunConfig
from repro_torch.runtime.engine import (ENGINES, make_engine, run_replicates,
                                        validate_run_config)
from repro_torch.runtime.faults import (crashed_host, faulty_host,
                                        flapping_host, lossy_host)
from repro_torch.runtime.simulator import SimConfig
from repro_torch.runtime.topologies import TOPOLOGIES, Topology, make_topology

PERCENTILES = (50, 95)

_UNITS = {"simstep_period": ("us", 1e6), "simstep_latency": ("steps", 1.0),
          "walltime_latency": ("us", 1e6), "delivery_failure_rate": ("", 1.0),
          "delivery_clumpiness": ("", 1.0)}

#: what the reference offers and the port does not yet, with the reason
NOT_PORTED = {
    "serve": "--family serve needs the service slice (open-loop arrivals, "
             "churn epochs, SLO verdicts), which is not ported to repro_torch "
             "yet; run it on the reference: python -m "
             "repro.runtime.experiments --family serve",
    "evo": "--app evo (float32 payloads) is not ported to repro_torch yet; "
           "use --app graphcolor, or run evo on the reference: python -m "
           "repro.runtime.experiments --app evo",
}


def make_app(name: str, n: int, simels: int, topology: Optional[Topology],
             seed: int = 0, initial_state=None):
    if name == "graphcolor":
        from repro_torch.apps.graphcolor import GraphColorApp, GraphColorConfig
        return GraphColorApp(
            GraphColorConfig(n_processes=n, nodes_per_process=simels,
                             seed=seed), topology=topology,
            initial_state=initial_state)
    raise ValueError(f"unknown app {name!r} (graphcolor)")


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


def _engine(args, app, cfg, faults=None):
    return make_engine(args.run, app, cfg, faults, device=args.device)


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
            device=args.device)
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


FAMILIES = {
    "modes": run_modes,
    "weak_scaling": run_weak_scaling,
    "intensivity": run_intensivity,
    "faults": run_faults,
}


# ---------------------------------------------------------------------------
def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.runtime.experiments",
        description="Run the paper's experiment families on the torch port "
                    "of the best-effort runtime.")
    p.add_argument("--family", default="weak_scaling",
                   choices=[*FAMILIES, "serve", "all"],
                   help="experiment family (serve is not ported yet)")
    p.add_argument("--engine", default="torch", choices=sorted(ENGINES),
                   help="simulation backend: torch (vectorized windowed-time "
                        "engine) or event (discrete-event reference)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the torch engine runs: cuda (hand-written "
                        "CUDA duct kernels; raises without a card) or cpu "
                        "(plain torch versions)")
    p.add_argument("--replicates", type=int, default=1,
                   help="seeds per weak-scaling point (run one after "
                        "another)")
    p.add_argument("--superstep-windows", type=int, default=1,
                   help="windows fused per ring commit (the W-fused "
                        "superstep scheduler; bitwise-identical "
                        "trajectories).  1 = per-window exchange")
    p.add_argument("--scheduler", default="auto",
                   choices=["auto", "window", "superstep"],
                   help="exchange cadence: window = every lockstep window, "
                        "superstep = W-fused (needs --superstep-windows > "
                        "1); auto follows --superstep-windows")
    p.add_argument("--layout", default="auto",
                   choices=["auto", "dense", "edge"],
                   help="duct ring layout for --engine torch: dense = the "
                        "degree-bucketed receiver-major layout (auto "
                        "resolves to it on every built-in topology); the "
                        "edge-major layout is not ported yet")
    p.add_argument("--qos-interval", type=float, default=None,
                   help="QoS snapshot spacing in virtual seconds for the "
                        "time-resolved stream (default: duration/12)")
    p.add_argument("--topology", default="torus", choices=sorted(TOPOLOGIES))
    p.add_argument("--procs", type=int, nargs="+", default=[64, 256],
                   help="process counts (weak_scaling sweeps them; other "
                        "families use the first)")
    p.add_argument("--app", default="graphcolor",
                   choices=["graphcolor", "evo"],
                   help="application (evo is not ported yet)")
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
    p.add_argument("--json", default=None, help="write rows to this path")
    return p


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.family == "serve":
        parser.error(NOT_PORTED["serve"])
    if args.app == "evo":
        parser.error(NOT_PORTED["evo"])
    # one frozen strategy carrier for every family, checked once against
    # the engine registry before any app or tensor is built
    try:
        args.run = RunConfig.from_args(args)
        validate_run_config(args.run)
    except ValueError as e:
        parser.error(str(e))
    if args.engine == "torch":
        # fail before any work when the card is asked for and missing
        from repro_torch.runtime.engine_torch import resolve_device
        resolve_device(args.device)
    families = list(FAMILIES) if args.family == "all" else [args.family]
    rows: List[dict] = []
    t0 = time.perf_counter()
    for fam in families:
        rows.extend(FAMILIES[fam](args))
    print(f"done in {time.perf_counter() - t0:.1f}s wall")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1, default=float)
        print(f"wrote {args.json}")
    return rows


if __name__ == "__main__":
    main()
