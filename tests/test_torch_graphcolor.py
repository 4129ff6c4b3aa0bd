"""repro_torch's batched graph-coloring step against the reference's.

``init`` copies the reference's per-pid numpy RNG draws, so colors, probs
and halos are equal.  One ``step`` on identical ``(state, halo, steps,
seed, pids)`` inputs, made with numpy, must give identical colors, edges
and probabilities, bit for bit: the probability update is the same float32
operation sequence, the resample draw is the counter hash, and the
cumulative sum over the colour axis is summed in the same order.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import torch_cases  # noqa: E402,F401  (caps torch's CPU threads)
import jax.numpy as jnp  # noqa: E402

from repro.apps.graphcolor import GraphColorApp, GraphColorConfig  # noqa: E402
from repro.runtime.topologies import make_topology  # noqa: E402
from repro_torch.apps.graphcolor import (  # noqa: E402
    BatchedGraphColor,
    GraphColorApp as TGraphColorApp,
    GraphColorConfig as TGraphColorConfig,
)
from repro_torch.runtime.topologies import (  # noqa: E402
    make_topology as t_make_topology,
)

CASES = [("torus", 16, 1), ("ring", 8, 1), ("smallworld", 16, 4),
         ("torus", 16, 9), ("cliques", 16, 6)]


def _apps(topology, n, simels, seed=3):
    japp = GraphColorApp(GraphColorConfig(n_processes=n,
                                          nodes_per_process=simels,
                                          seed=seed),
                         topology=make_topology(topology, n))
    tapp = TGraphColorApp(TGraphColorConfig(n_processes=n,
                                            nodes_per_process=simels,
                                            seed=seed),
                          topology=t_make_topology(topology, n))
    return japp.batched(), tapp.batched("cpu")


@pytest.mark.parametrize("topology,n,simels", CASES)
def test_init_matches_reference(topology, n, simels):
    jb, tb = _apps(topology, n, simels)
    assert isinstance(tb, BatchedGraphColor)
    assert tb.payload_dtype == torch.int32 and tb.payload_len == jb.payload_len
    for seed in (0, 7):
        (js, jh), (ts, th) = jb.init(seed), tb.init(seed)
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        for key in ("colors", "probs"):
            assert ts[key].dtype == {"colors": torch.int32,
                                     "probs": torch.float32}[key]
            np.testing.assert_array_equal(ts[key].numpy(),
                                          np.asarray(js[key]))


def _random_inputs(tb, rng):
    n, H, W, C = tb.n, tb.H, tb.W, tb.cfg.n_colors
    colors = rng.integers(0, C, (n, H, W)).astype(np.int32)
    raw = rng.random((n, H, W, C)).astype(np.float32) + np.float32(0.05)
    probs = (raw / raw.sum(-1, keepdims=True)).astype(np.float32)
    halo = rng.integers(-1, C, (n, 4, tb.L)).astype(np.int32)
    steps = rng.integers(0, 500, n).astype(np.int32)
    pids = rng.permutation(n).astype(np.int32)
    return colors, probs, halo, steps, pids


@pytest.mark.parametrize("topology,n,simels", CASES)
@pytest.mark.parametrize("with_pids", [False, True])
def test_step_bitwise_vs_reference(topology, n, simels, with_pids):
    jb, tb = _apps(topology, n, simels)
    rng = np.random.default_rng(100 + n + simels)
    for seed in (0, 12345, -3):
        colors, probs, halo, steps, pids = _random_inputs(tb, rng)
        jstate, jedges = jb.step(
            dict(colors=jnp.asarray(colors), probs=jnp.asarray(probs)),
            jnp.asarray(halo), jnp.asarray(steps), jnp.int32(seed),
            pids=jnp.asarray(pids) if with_pids else None)
        tstate, tedges = tb.step(
            dict(colors=torch.as_tensor(colors),
                 probs=torch.as_tensor(probs)),
            torch.as_tensor(halo), torch.as_tensor(steps),
            torch.tensor(seed, dtype=torch.int32),
            pids=torch.as_tensor(pids) if with_pids else None)
        assert tedges.dtype == torch.int32
        np.testing.assert_array_equal(tedges.numpy(), np.asarray(jedges))
        np.testing.assert_array_equal(tstate["colors"].numpy(),
                                      np.asarray(jstate["colors"]))
        # probs: bit for bit, compared as raw float32 bits
        np.testing.assert_array_equal(
            tstate["probs"].numpy().view(np.uint32),
            np.asarray(jstate["probs"]).view(np.uint32))
        # the draws really resample: some conflicting cells change color
        assert (tstate["colors"].numpy() != colors).any()


def test_quality_and_export_match_reference():
    jb, tb = _apps("torus", 16, 4)
    js, _ = jb.init(5)
    ts, _ = tb.init(5)
    assert tb.quality(ts) == jb.quality(js)
    je, te = jb.export_state(js), tb.export_state(ts)
    assert je.keys() == te.keys()
    for p in je:
        for key in ("colors", "probs"):
            np.testing.assert_array_equal(te[p][key], je[p][key])
