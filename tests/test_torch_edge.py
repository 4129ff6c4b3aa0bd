"""The torch engine's edge-major layout (``layout="edge"``) on the CPU.

* Oracle: on dyadic scenarios the torch edge engine's ``qos_signature``
  equals the event oracle's, quality excluded as the reference's own
  conformance suite does.
* Dense: on the same scenarios the edge and dense layouts of the torch
  engine give the same full ``SimResult``, quality included (ROADMAP's
  gate for the layout).
* JAX engine: the torch edge engine equals the reference's ``jax`` engine
  on ``layout="edge"`` over the full ``SimResult``, quality included.
* Carry across: from the identical mid-run JAX carry, one edge-major
  window on each side leaves every carry key bitwise equal, except that
  the torch drain writes ``+inf`` into the slots it pops where the
  reference leaves their old values; those slots lie outside ``[head,
  head + size)`` and are compared there only.

The scenarios cover the regular torus, the irregular-degree smallworld, a
lossy and a crashed host (with quarantine), and the rolling barrier.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from engine_cases import (  # noqa: E402
    EXACT_MAX_POPS,
    SCENARIOS_BY_NAME,
    oracle,
    run_case,
)
from repro.core.qos import qos_signature as ref_signature  # noqa: E402
from repro.runtime.engine_jax import JaxEngine  # noqa: E402
from repro_torch.core.qos import qos_signature  # noqa: E402
from repro_torch.interop import carry_from_numpy, carry_to_numpy  # noqa: E402
from repro_torch.runtime.config import RunConfig  # noqa: E402
from repro_torch.runtime.engine import make_engine  # noqa: E402
from repro_torch.runtime.engine_torch import TorchEngine  # noqa: E402
from torch_cases import as_one_replicate, torch_scenario  # noqa: E402

SUBSET = [
    "torus-best-effort",                     # regular degree 4
    "smallworld-barrier-victim-fault",       # irregular degree, barrier
    "cliques-best-effort-lossy",             # lossy25
    "torus-fixed-crash-quarantine",          # crash0 + quarantine
    "ring-rolling-barrier",                  # rolling barrier, degree 2
]


@functools.lru_cache(maxsize=None)
def _torch_signature(name, layout):
    app, cfg, faults = torch_scenario(SCENARIOS_BY_NAME[name])
    eng = make_engine(RunConfig(engine="torch", layout=layout), app, cfg,
                      faults, max_pops=EXACT_MAX_POPS, chunk=64,
                      device="cpu")
    assert eng.layout == layout
    return qos_signature(eng.run())


@pytest.mark.parametrize("name", SUBSET)
def test_edge_matches_event_oracle(name):
    got = dict(_torch_signature(name, "edge"))
    assert sum(got["updates"]) > 0 and got["sent"] > 0
    want = ref_signature(oracle(SCENARIOS_BY_NAME[name]))
    want.pop("quality")
    got.pop("quality")
    assert got == want, f"torch edge diverged from the event oracle on {name}"


@pytest.mark.parametrize("name", SUBSET)
def test_edge_matches_torch_dense(name):
    assert _torch_signature(name, "edge") == _torch_signature(name, "dense"), \
        f"torch edge and dense layouts diverged on {name}"


@pytest.mark.parametrize("name", SUBSET)
def test_edge_matches_jax_edge(name):
    want = ref_signature(run_case("jax", SCENARIOS_BY_NAME[name],
                                  layout="edge"))
    assert _torch_signature(name, "edge") == want, \
        f"torch edge diverged from jax edge on {name}"


def _live(carry):
    """(E, C) mask of ring slots inside [head, head + size)."""
    C = carry["q_avail"].shape[1]
    off = (np.arange(C)[None, :] - carry["q_head"][:, None]) % C
    return off < carry["q_size"][:, None]


@pytest.mark.parametrize("name", ["torus-best-effort",
                                  "smallworld-barrier-victim-fault",
                                  "cliques-best-effort-lossy"])
def test_carry_across_one_edge_window(name):
    scenario = SCENARIOS_BY_NAME[name]
    jeng = JaxEngine(scenario.app(), scenario.config(),
                     scenario.fault_model(), max_pops=EXACT_MAX_POPS,
                     layout="edge")
    app, cfg, faults = torch_scenario(scenario)
    teng = TorchEngine(app, cfg, faults, max_pops=EXACT_MAX_POPS,
                       layout="edge", device="cpu")
    body = jax.jit(lambda c: jeng._window_body(c, None)[0])
    carry = jeng._init_carry(scenario.seed())
    for _ in range(24):
        carry = body(carry)
    start = jax.device_get(carry)
    assert int(np.sum(start["q_size"])) > 0, "rings hold traffic"
    want = jax.device_get(body(carry))
    got = carry_to_numpy(as_one_replicate(
        teng._window_body, carry_from_numpy(start, "cpu")))
    assert sorted(got) == sorted(want)
    live = _live(want)
    for key in want:
        a, b = want[key], got[key]
        if isinstance(a, dict):
            for k in a:
                np.testing.assert_array_equal(b[k], a[k], err_msg=key + k)
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, key
        if key == "q_avail":
            # outside [head, head + size) the two differ only where the
            # torch drain wrote +inf into a slot it popped
            differ = a[~live] != b[~live]
            assert np.isinf(b[~live][differ]).all()
            a, b = a[live], b[live]
        if a.dtype.kind == "f":
            a, b = a.view(np.uint32), b.view(np.uint32)
        np.testing.assert_array_equal(b, a, err_msg=key)


def test_edge_layout_refuses_the_superstep_scheduler():
    app, cfg, faults = torch_scenario(SCENARIOS_BY_NAME["torus-best-effort"])
    with pytest.raises(ValueError, match="needs the dense layout"):
        make_engine(RunConfig(engine="torch", layout="edge",
                              superstep_windows=4), app, cfg, faults,
                    device="cpu")
