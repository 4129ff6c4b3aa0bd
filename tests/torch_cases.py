"""Build the repro_torch side of an ``engine_cases.Scenario``.

The port keeps its own copies of the app, config, topology and fault
modules, so a parity pair needs the same scenario built twice: once from
``repro`` (``Scenario.app/config/fault_model``) and once from
``repro_torch`` here, with the same topology, seed and parameters.
"""
from __future__ import annotations

import dataclasses

from repro_torch.apps.graphcolor import GraphColorApp, GraphColorConfig
from repro_torch.core.modes import AsyncMode
from repro_torch.runtime.faults import (FaultModel, crashed_host,
                                        flapping_host, lossy_host)
from repro_torch.runtime.simulator import SimConfig
from repro_torch.runtime.topologies import make_topology


def torch_app(n: int, topology: str, seed: int, simels: int = 1):
    return GraphColorApp(
        GraphColorConfig(n_processes=n, nodes_per_process=simels, seed=seed),
        topology=make_topology(topology, n))


def torch_cfg(cfg) -> SimConfig:
    """A reference ``SimConfig`` rebuilt as the port's, field for field."""
    fields = dataclasses.asdict(cfg)
    fields["mode"] = AsyncMode(int(cfg.mode))
    return SimConfig(**fields)


def torch_faults(scenario):
    n, tag = scenario.n, scenario.faults
    if tag == "none":
        return None
    if tag == "uniform2":
        return FaultModel(compute_slowdown={p: 2.0 for p in range(n)})
    if tag == "victim8":
        return FaultModel(compute_slowdown={1: 8.0})
    topo = make_topology(scenario.topology, n)
    if tag == "crash0":
        return crashed_host(topo, 0)
    if tag == "lossy25":
        return lossy_host(topo, 0, 0.25)
    if tag == "flap50":
        return flapping_host(topo, 0, 0.5)
    raise ValueError(f"unknown fault tag {tag!r}")


def torch_scenario(scenario):
    """``(app, cfg, faults)`` of ``scenario`` built from repro_torch."""
    return (torch_app(scenario.n, scenario.topology, scenario.seed()),
            torch_cfg(scenario.config()), torch_faults(scenario))
