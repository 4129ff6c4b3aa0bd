"""The repro_torch engine, its scheduler and CLI, and the port's imports.

* Carry across: the reference's ``JaxEngine`` runs k windows (or W-fused
  supersteps) from its initial carry; ``interop.carry_from_numpy`` turns
  that carry into the torch engine's, and one more window (superstep) on
  each side must leave every carry key bitwise equal.
* Scheduler: the torch engine's W-fused superstep path reproduces its
  per-window path bitwise.
* CLI: ``python -m repro_torch.runtime.experiments`` runs on the CPU, on
  both duct layouts and with both apps, and refuses a shard count that
  does not divide the population with an actionable message.
* Imports: no module of the port (nor ``chip_smoke.py``) imports ``jax``
  or ``repro``, checked on the parsed import statements.

Everything here runs with ``device="cpu"``; the event-oracle and
JAX-engine result comparisons live in ``test_torch_conformance.py``.
"""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from engine_cases import (  # noqa: E402
    EXACT_MAX_POPS,
    REPO,
    Scenario,
    case_seed,
    jittered_cfg,
)
from repro.core.modes import AsyncMode  # noqa: E402
from repro.core.qos import qos_signature  # noqa: E402
from repro.runtime.engine_jax import JaxEngine  # noqa: E402
from repro_torch.interop import carry_from_numpy, carry_to_numpy  # noqa: E402
from repro_torch.runtime.config import RunConfig  # noqa: E402
from repro_torch.runtime.engine import make_engine  # noqa: E402
from repro_torch.runtime.engine_torch import TorchEngine  # noqa: E402
from repro_torch.runtime.experiments import main as cli_main  # noqa: E402
from torch_cases import (  # noqa: E402
    as_one_replicate,
    torch_app,
    torch_cfg,
    torch_scenario,
)


# ---------------------------------------------------------------------------
# Carry across: one window / one superstep from the identical JAX state
# ---------------------------------------------------------------------------
def _assert_carry_equal(got, want, path=""):
    assert sorted(got) == sorted(want), (path, sorted(got), sorted(want))
    for key in want:
        a, b = want[key], got[key]
        if isinstance(a, dict):
            _assert_carry_equal(b, a, f"{path}{key}.")
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert b.dtype == a.dtype, (f"{path}{key}", b.dtype, a.dtype)
        assert b.shape == a.shape, (f"{path}{key}", b.shape, a.shape)
        if a.dtype.kind == "f":
            # raw bits: +inf ring slots and -0.0 compare exactly
            a, b = a.view(np.uint32), b.view(np.uint32)
        np.testing.assert_array_equal(b, a, err_msg=f"{path}{key}")


CARRY_SCENARIOS = [
    Scenario("torus-best-effort", "torus"),
    Scenario("smallworld-best-effort", "smallworld"),
    Scenario("cliques-rolling-crash-quarantine", "cliques",
             mode=AsyncMode.ROLLING_BARRIER, faults="crash0",
             barrier_timeout=2.0 ** -10),
]


def _engines(scenario, **kw):
    jeng = JaxEngine(scenario.app(), scenario.config(),
                     scenario.fault_model(), max_pops=EXACT_MAX_POPS, **kw)
    app, cfg, faults = torch_scenario(scenario)
    teng = TorchEngine(app, cfg, faults, max_pops=EXACT_MAX_POPS,
                       device="cpu", **kw)
    return jeng, teng


@pytest.mark.parametrize("scenario", CARRY_SCENARIOS, ids=lambda s: s.name)
def test_carry_across_one_window(scenario):
    jeng, teng = _engines(scenario)
    # torus: the identity bucket; smallworld: padded buckets whose gathers
    # and scatters run
    identity = [b.members is None for b in teng._spec.buckets]
    if scenario.topology == "torus":
        assert identity == [True]
    if scenario.topology == "smallworld":
        assert len(identity) > 1 and not any(identity)
    body = jax.jit(lambda c: jeng._window_body_dense(c, None)[0])
    carry = jeng._init_carry(scenario.seed())
    # the initial carries already agree key for key
    _assert_carry_equal(carry_to_numpy(teng._init_carry(scenario.seed())),
                        jax.device_get(carry))
    for _ in range(24):
        carry = body(carry)
    start = jax.device_get(carry)
    assert int(np.sum(start["q_size"])) > 0, "rings hold traffic"
    want = jax.device_get(body(carry))
    got = carry_to_numpy(as_one_replicate(
        teng._window_body_dense, carry_from_numpy(start, "cpu")))
    _assert_carry_equal(got, want)


@pytest.mark.parametrize("topology", ["torus", "smallworld"])
def test_carry_across_one_superstep(topology):
    scenario = Scenario(f"{topology}-best-effort", topology)
    jeng, teng = _engines(scenario, scheduler="superstep",
                          superstep_windows=4)
    body = jax.jit(lambda c: jeng._superstep_body(c, None)[0])
    carry = jeng._init_carry(scenario.seed())
    for _ in range(6):
        carry = body(carry)
    start = jax.device_get(carry)
    assert start["base_off"].dtype == np.int8
    want = jax.device_get(body(carry))
    got = carry_to_numpy(as_one_replicate(
        teng._superstep_body, carry_from_numpy(start, "cpu")))
    _assert_carry_equal(got, want)


def test_carry_from_numpy_keeps_keys_and_dtypes():
    carry = {"a": np.zeros(3, np.int8), "b": np.ones((2, 2), bool),
             "app": {"colors": np.arange(4, dtype=np.int32)},
             "k": np.int32(5)}
    got = carry_from_numpy(carry, "cpu")
    assert got["a"].dtype == torch.int8 and got["b"].dtype == torch.bool
    assert got["app"]["colors"].dtype == torch.int32
    assert got["k"].dim() == 0 and int(got["k"]) == 5
    _assert_carry_equal(carry_to_numpy(got), carry)


# ---------------------------------------------------------------------------
# Scheduler: W-fused supersteps reproduce per-window dense bitwise
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("topology", ["torus", "smallworld"])
def test_superstep_bitwise_vs_per_window(topology):
    seed = case_seed(topology)
    cfg = torch_cfg(jittered_cfg(0.005, seed=seed))
    base = make_engine("torch", torch_app(16, topology, seed), cfg,
                       chunk=64, device="cpu").run()
    assert sum(base.updates) > 0 and base.sent > 0
    for w in (2, 4):
        eng = make_engine(RunConfig(engine="torch", superstep_windows=w),
                          torch_app(16, topology, seed), cfg, chunk=64,
                          device="cpu")
        assert eng.scheduler == "superstep" and eng._windows_per_call % w == 0
        fused = eng.run()
        assert qos_signature(fused) == qos_signature(base), \
            f"{topology}: W={w} diverged from per-window"


def test_engine_validation_errors():
    cfg = torch_cfg(jittered_cfg(0.01))
    app = torch_app(8, "ring", 0)
    assert make_engine("torch", app, cfg, layout="edge",
                       device="cpu").layout == "edge"
    with pytest.raises(ValueError, match="superstep_windows > 1"):
        make_engine("torch", app, cfg, scheduler="superstep", device="cpu")
    with pytest.raises(ValueError, match="must not exceed"):
        make_engine("torch", app, torch_cfg(jittered_cfg(
            0.01, buffer_capacity=2)), superstep_windows=4, device="cpu")
    # shards > 1 builds the sharded engine; a count that does not divide
    # the population is refused
    assert type(make_engine("torch", app, cfg, shards=2,
                            device="cpu")).__name__ == "ShardedTorchEngine"
    with pytest.raises(ValueError, match="must divide"):
        make_engine("torch", app, cfg, shards=3, device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        make_engine("jax", app, cfg)


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the no-card path is not reachable")
    cfg = torch_cfg(jittered_cfg(0.01))
    with pytest.raises(RuntimeError, match="cuda"):
        make_engine("torch", torch_app(8, "ring", 0), cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        cli_main(["--engine", "torch", "--procs", "16",
                  "--duration", "0.01"])


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------
def test_cli_runs_on_cpu_and_prints_the_metrics():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.runtime.experiments",
         "--device", "cpu", "--engine", "torch", "--procs", "16",
         "--duration", "0.01"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr
    for metric in ("simstep_period", "simstep_latency", "walltime_latency",
                   "delivery_failure_rate", "delivery_clumpiness"):
        assert metric in r.stdout, metric
    assert "engine=torch device=cpu" in r.stdout


@pytest.mark.parametrize("argv,needle", [
    (["--shards", "3"], "--shards 3 must divide every --procs value"),
])
def test_cli_refuses_unported_paths(argv, needle, capsys):
    with pytest.raises(SystemExit) as exc:
        cli_main(["--device", "cpu", "--procs", "16", "--duration", "0.01",
                  *argv])
    assert exc.value.code == 2
    assert needle in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["--layout", "edge"],
    ["--app", "evo", "--simels", "16"],
    ["--app", "evo", "--simels", "16", "--layout", "edge"],
], ids=["edge", "evo", "evo-edge"])
def test_cli_runs_edge_and_evo_on_cpu(argv, capsys):
    rows = cli_main(["--device", "cpu", "--procs", "16", "--duration",
                     "0.004", *argv])
    assert rows[0]["updates"] > 0
    assert rows[0]["run"]["layout"] == ("edge" if "edge" in argv else "auto")
    out = capsys.readouterr().out
    assert "delivery_failure_rate" in out
    assert f"app={'evo' if 'evo' in argv else 'graphcolor'}" in out


def test_cli_families_run_on_cpu(capsys):
    rows = cli_main(["--device", "cpu", "--family", "faults", "--procs",
                     "16", "--duration", "0.004", "--fault-kind", "lossy"])
    assert [r["label"] for r in rows] == ["without_fault", "with_fault"]
    rows = cli_main(["--device", "cpu", "--procs", "16", "--duration",
                     "0.004", "--superstep-windows", "4", "--replicates",
                     "2"])
    assert rows[0]["replicates"] == 2 and rows[0]["updates"] > 0
    assert "delivery_clumpiness" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# The port imports neither jax nor the reference package
# ---------------------------------------------------------------------------
def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_repro():
    root = os.path.join(REPO, "src", "repro_torch")
    paths = [os.path.join(d, f) for d, _, files in os.walk(root)
             for f in files if f.endswith(".py")]
    paths.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(paths) > 15
    for module in ("launch/mesh.py", "runtime/engine_sharded.py",
                   "launch/dryrun.py", "launch/sharding.py",
                   "kernels/sharded.py"):
        assert os.path.join(root, module) in paths, module
    bad = []
    for path in paths:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append((os.path.relpath(path, REPO), mod))
    assert not bad, bad
