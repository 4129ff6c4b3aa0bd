"""repro_torch's engine against the reference's oracles (``device="cpu"``).

* Oracle: on dyadic scenarios (power-of-two time constants, no stochastic
  clocks) the torch engine's ``qos_signature`` equals the event oracle's
  bitwise, quality excluded as the reference's own conformance suite does
  (the event engine's fragments draw colors from another RNG stream).
* JAX engine: on the same scenarios the full ``SimResult`` signature,
  quality included, equals the reference's ``jax`` engine at the same seed.
* Scheduler: the torch W-fused superstep path equals ``jax
  --superstep-windows W`` bitwise.
* Jittered: on the 16-ring with the realistic lognormal clocks, QoS
  medians stay within the reference's documented ``PARITY_RTOL`` of the
  event oracle.

The scenario subset covers every topology (ring, torus, cliques,
smallworld), the best-effort, barrier, rolling and fixed modes, and the
uniform2, victim8, lossy25, flap50 and crash0-with-quarantine faults.
"""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from engine_cases import (  # noqa: E402
    EXACT_MAX_POPS,
    EXACT_SCENARIOS,
    PARITY_RTOL,
    SCENARIOS_BY_NAME,
    case_seed,
    gc_app,
    jittered_cfg,
    oracle,
    run_case,
)
from repro.core.qos import aggregate_reports  # noqa: E402
from repro.core.qos import qos_signature as ref_signature  # noqa: E402
from repro.runtime.engine import make_engine as ref_make_engine  # noqa: E402
from repro_torch.core.qos import qos_signature  # noqa: E402
from repro_torch.runtime.config import RunConfig  # noqa: E402
from repro_torch.runtime.engine import make_engine  # noqa: E402
from torch_cases import torch_app, torch_cfg, torch_scenario  # noqa: E402

SUBSET = [
    "torus-best-effort-uniform-fault",       # torus, best-effort, uniform2
    "smallworld-barrier-victim-fault",       # smallworld, barrier, victim8
    "ring-rolling-barrier",                  # ring, rolling
    "cliques-best-effort-lossy",             # cliques, lossy25
    "torus-barrier-flap",                    # flap50
    "cliques-rolling-crash-quarantine",      # crash0 + quarantine, rolling
    "torus-fixed-crash-quarantine",          # fixed, crash0 + quarantine
]


def test_subset_covers_the_matrix():
    scen = [SCENARIOS_BY_NAME[name] for name in SUBSET]
    assert {s.topology for s in scen} == {"ring", "torus", "cliques",
                                          "smallworld"}
    assert {s.mode.name for s in scen} >= {
        "BEST_EFFORT", "BARRIER_EVERY_STEP", "ROLLING_BARRIER",
        "FIXED_BARRIER"}
    assert {s.faults for s in scen} >= {"uniform2", "victim8", "lossy25",
                                        "flap50", "crash0"}
    assert any(s.faults == "crash0" and s.barrier_timeout > 0 for s in scen)
    assert set(SUBSET) <= {s.name for s in EXACT_SCENARIOS}


def _torch_run(scenario, **kw):
    app, cfg, faults = torch_scenario(scenario)
    return make_engine(RunConfig(engine="torch", **kw), app, cfg, faults,
                       max_pops=EXACT_MAX_POPS, chunk=64,
                       device="cpu").run()


@pytest.mark.parametrize("name", SUBSET)
def test_bitwise_vs_event_oracle_and_jax_engine(name):
    scenario = SCENARIOS_BY_NAME[name]
    got = qos_signature(_torch_run(scenario))
    assert sum(got["updates"]) > 0
    # event oracle: every counter and QoS field, quality excluded
    want = ref_signature(oracle(scenario))
    want.pop("quality")
    quality = got.pop("quality")
    assert got == want, f"torch diverged from the event oracle on {name}"
    # jax engine: the full SimResult signature, quality included
    got["quality"] = quality
    assert got == ref_signature(run_case("jax", scenario)), \
        f"torch diverged from the jax engine on {name}"


@pytest.mark.parametrize("name", ["torus-best-effort",
                                  "smallworld-barrier-lossy"])
def test_superstep_bitwise_vs_jax_superstep(name):
    # dyadic clocks: no transcendental enters them, so the two frameworks'
    # libm ulps cannot move a trajectory and the comparison is bitwise
    scenario = SCENARIOS_BY_NAME[name]
    for w in (2, 4):
        want = ref_signature(run_case("jax", scenario, superstep_windows=w))
        got = qos_signature(_torch_run(scenario, superstep_windows=w))
        assert got == want, f"{name}: torch W={w} vs jax W={w}"


def test_median_qos_parity_16_ring():
    seed = case_seed("ring")
    cfg = jittered_cfg(0.03, seed=seed)
    res_e = ref_make_engine("event", gc_app(16, "ring"), cfg).run()
    res_t = make_engine("torch", torch_app(16, "ring", seed),
                        torch_cfg(cfg), chunk=64, device="cpu").run()
    med_e = aggregate_reports(res_e.qos)
    med_t = aggregate_reports(res_t.qos)
    for metric, rtol in PARITY_RTOL.items():
        a, b = med_e[metric]["median"], med_t[metric]["median"]
        assert a is not None and b is not None
        assert abs(b - a) <= rtol * max(abs(a), 1e-12), \
            f"{metric}: event={a} torch={b} rtol={rtol}"
    du = abs(sum(res_t.updates) - sum(res_e.updates))
    assert du <= 0.02 * sum(res_e.updates)
