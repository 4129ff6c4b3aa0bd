"""Build the repro_torch side of an ``engine_cases.Scenario``.

The port keeps its own copies of the app, config, topology and fault
modules, so a parity pair needs the same scenario built twice: once from
``repro`` (``Scenario.app/config/fault_model``) and once from
``repro_torch`` here, with the same topology, seed and parameters.  It
also holds the bitwise comparisons of op results and of whole results
(``assert_same``) the tests share, the relative closeness and the
perturbed reference weights the LM tests share, and the cap on torch's
CPU threads that every port test file takes by importing it; it imports
no JAX, so the card-side tests and the ranks the rank tests spawn can use
it.
"""
from __future__ import annotations

import dataclasses
import struct

import numpy as np
import torch

from repro_torch.apps.evo import EvoApp, EvoConfig
from repro_torch.apps.graphcolor import GraphColorApp, GraphColorConfig
from repro_torch.core.modes import AsyncMode
from repro_torch.runtime.faults import (FaultModel, crashed_host,
                                        flapping_host, lossy_host)
from repro_torch.runtime.simulator import SimConfig
from repro_torch.runtime.topologies import make_topology

#: torch's intra-op CPU threads in a test process.  A tier-1 run puts six
#: xdist workers on one 8-core host, and torch's default of one thread per
#: core in each of them oversubscribes it; of 1 and 2 threads, 2 gave the
#: shorter run.  Every ``tests/test_torch_*.py`` imports this module, so
#: the cap holds in any process that runs one.
TORCH_THREADS = 2
torch.set_num_threads(TORCH_THREADS)


def as_one_replicate(body, carry):
    """Run a window body, which takes a batch of replicates, on one
    replicate's carry (no replicate axis), as the reference's body runs
    under vmap: a batch of one, handed back without the axis."""
    def tree(fn, c):
        return {k: tree(fn, v) if isinstance(v, dict) else fn(v)
                for k, v in c.items()}
    return tree(lambda x: x[0], body(tree(lambda x: x[None], carry)))


def torch_app(n: int, topology: str, seed: int, simels: int = 1):
    return GraphColorApp(
        GraphColorConfig(n_processes=n, nodes_per_process=simels, seed=seed),
        topology=make_topology(topology, n))


def torch_evo_app(n: int, topology: str, seed: int, simels: int = 16):
    return EvoApp(EvoConfig(n_processes=n, cells_per_process=simels,
                            seed=seed), topology=make_topology(topology, n))


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


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_bits_equal(want, got, label):
    """Two result tuples field by field, tensors (on any device) or numpy
    arrays; float fields are compared as raw bits (``+inf``, and ``-0.0``
    against ``+0.0``)."""
    for name, a, b in zip(want._fields, want, got):
        a, b = _np(a), _np(b)
        assert a.dtype == b.dtype, (label, name, a.dtype, b.dtype)
        if a.dtype == np.float32:
            a, b = a.view(np.uint32), b.view(np.uint32)
        np.testing.assert_array_equal(b, a, err_msg=f"{label}: field {name}")


def close(got, want, tol):
    """(|got - want| <= tol x max|want| over the array, max |got - want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() if want.size else 0.0
    return err <= tol * max(np.abs(want).max(), 1e-30), err


def perturbed_params(ref, ref_cfg, seed):
    """The reference's initial LM leaves for ``ref_cfg`` (numpy), each
    plus seeded noise of scale 0.05, so that norm scales and biases are
    not zero.  ``ref`` holds the reference's ``jax`` and ``lm``."""
    params = ref.jax.tree.map(np.asarray, ref.lm.init_params(
        ref.jax.random.PRNGKey(seed), ref_cfg))
    rng = np.random.default_rng(seed)
    return ref.jax.tree.map(
        lambda a: (a + rng.standard_normal(a.shape) * 0.05).astype(a.dtype),
        params)


def assert_same(want, got, path="result"):
    """Two results (dataclasses, dicts, lists, arrays, numbers) equal bit
    for bit; floats compared as their IEEE bits, so ``inf`` and ``nan``
    compare exactly.  Classes may differ (the reference's and the port's
    ``QosReport``); their fields may not."""
    if dataclasses.is_dataclass(want):
        assert dataclasses.is_dataclass(got), path
        names = [f.name for f in dataclasses.fields(want)]
        assert names == [f.name for f in dataclasses.fields(got)], path
        for name in names:
            assert_same(getattr(want, name), getattr(got, name),
                        f"{path}.{name}")
    elif isinstance(want, dict):
        assert isinstance(got, dict) and list(want) == list(got), path
        for key in want:
            assert_same(want[key], got[key], f"{path}[{key!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(want) == len(got), (path, len(want), len(got))
        for i, (a, b) in enumerate(zip(want, got)):
            assert_same(a, b, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        got = np.asarray(got)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.tobytes() == want.tobytes(), path
    elif isinstance(want, float):
        assert struct.pack("<d", want) == struct.pack("<d", float(got)), (
            path, want, got)
    else:
        assert want == got, (path, want, got)
