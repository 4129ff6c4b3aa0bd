"""repro_torch's evo app (digital evolution, float32 halos) against the
reference's.

* ``BatchedEvo``: ``init`` copies the reference's per-pid numpy draws, and
  a few chained ``step`` calls on identical seeded inputs (with spawns and
  mutations) give identical genomes, resource bits, uint32 accumulators
  and edge rows: the mixing rounds are the reference's uint32 arithmetic
  held in int64, the float32 operations run in the reference's order, and
  the mutation draws are the counter hash.
* Engine: on a dyadic 16-process torus with 16 cells per process, the
  torch engine equals the reference's ``jax`` engine over the full
  ``SimResult``, quality included, on the dense layout per window, with
  W = 4 fused windows, and on the edge-major layout.
* Carry across: from the identical mid-run JAX carry, one dense window on
  each side leaves every carry key bitwise equal but the resource and the
  edge rows staged from it, which stay within 1 ulp: under ``jit`` XLA:CPU contracts the diffusion's
  ``(1 - share) * r + share * mean`` into one fused multiply-add, while
  torch (like the reference's own eager ``step``, checked bitwise above)
  rounds the product first.  The uint32 ``acc`` crosses through
  ``interop`` as int64 and comes back as uint32.
* ``export_state``: evo has none, so ``carry_app_state`` gives
  ``app_state=None`` as in the reference instead of raising.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from engine_cases import EXACT_MAX_POPS, case_seed, dyadic_cfg  # noqa: E402
from repro.apps.evo import EvoApp, EvoConfig  # noqa: E402
from repro.core.qos import qos_signature as ref_signature  # noqa: E402
from repro.runtime.engine import make_engine as ref_make_engine  # noqa: E402
from repro.runtime.engine_jax import JaxEngine  # noqa: E402
from repro.runtime.topologies import make_topology  # noqa: E402
from repro_torch.apps.evo import BatchedEvo  # noqa: E402
from repro_torch.core.qos import qos_signature  # noqa: E402
from repro_torch.interop import carry_from_numpy, carry_to_numpy  # noqa: E402
from repro_torch.runtime.config import RunConfig  # noqa: E402
from repro_torch.runtime.engine import make_engine  # noqa: E402
from repro_torch.runtime.engine_torch import TorchEngine  # noqa: E402
from torch_cases import (  # noqa: E402
    as_one_replicate,
    torch_cfg,
    torch_evo_app,
)

#: (topology, n, cells per process): a square block, a ring (degree 2, so
#: two halo slots are reflective), an irregular smallworld, and a
#: non-square 6-cell block
CASES = [("torus", 16, 16), ("ring", 8, 6), ("smallworld", 16, 9),
         ("torus", 4, 25)]


def _apps(topology, n, simels, seed=3):
    japp = EvoApp(EvoConfig(n_processes=n, cells_per_process=simels,
                            seed=seed), topology=make_topology(topology, n))
    return japp.batched(), torch_evo_app(n, topology, seed,
                                         simels).batched("cpu")


def _bits(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.float32 else x


@pytest.mark.parametrize("topology,n,simels", CASES)
def test_init_matches_reference(topology, n, simels):
    jb, tb = _apps(topology, n, simels)
    assert isinstance(tb, BatchedEvo)
    assert tb.payload_dtype == torch.float32
    assert tb.payload_len == jb.payload_len
    (js, jh), (ts, th) = jb.init(7), tb.init(7)
    np.testing.assert_array_equal(_bits(th), _bits(jh))
    assert ts["acc"].dtype == torch.int64 and js["acc"].dtype == jnp.uint32
    for key in ("genomes", "resource", "acc"):
        np.testing.assert_array_equal(ts[key].numpy(), np.asarray(js[key]),
                                      err_msg=key)
    np.testing.assert_array_equal(tb.fed.numpy(), jb.fed)
    assert tb.quality(ts) == jb.quality(js)


def _random_inputs(tb, rng):
    n, H, W, G = tb.n, tb.H, tb.W, tb.cfg.genome_len
    genomes = rng.integers(0, 256, (n, H, W, G)).astype(np.int32)
    # resource around the spawn threshold, so some cells reproduce
    resource = (rng.random((n, H, W)) * 1.2 + 0.3).astype(np.float32)
    acc = rng.integers(0, 2 ** 32, (n, H, W), dtype=np.uint64).astype(
        np.uint32)
    halo = (rng.random((n, 4, tb.L)) * 1.5).astype(np.float32)
    steps = rng.integers(0, 500, n).astype(np.int32)
    pids = rng.permutation(n).astype(np.int32)
    return genomes, resource, acc, halo, steps, pids


@pytest.mark.parametrize("topology,n,simels", CASES)
@pytest.mark.parametrize("with_pids", [False, True])
def test_step_bitwise_vs_reference(topology, n, simels, with_pids):
    jb, tb = _apps(topology, n, simels)
    rng = np.random.default_rng(200 + n + simels)
    genomes, resource, acc, halo, steps, pids = _random_inputs(tb, rng)
    jstate = dict(genomes=jnp.asarray(genomes), resource=jnp.asarray(resource),
                  acc=jnp.asarray(acc))
    tstate = carry_from_numpy(dict(genomes=genomes, resource=resource,
                                   acc=acc), "cpu")
    spawned = mutated = 0
    for k, seed in enumerate((0, 12345, -3)):
        jp = jnp.asarray(pids) if with_pids else None
        tp = torch.as_tensor(pids) if with_pids else None
        before = tstate
        jstate, jedges = jb.step(jstate, jnp.asarray(halo),
                                 jnp.asarray(steps + k), jnp.int32(seed),
                                 pids=jp)
        tstate, tedges = tb.step(tstate, torch.as_tensor(halo),
                                 torch.as_tensor(steps + k),
                                 torch.tensor(seed, dtype=torch.int32),
                                 pids=tp)
        assert tedges.dtype == torch.float32
        np.testing.assert_array_equal(_bits(tedges), _bits(jedges))
        got = carry_to_numpy(tstate)
        for key in ("genomes", "resource", "acc"):
            want = np.asarray(jstate[key])
            assert got[key].dtype == want.dtype, key
            np.testing.assert_array_equal(_bits(got[key]), _bits(want),
                                          err_msg=key)
        spawned += int((tstate["resource"] < before["resource"]).sum())
        mutated += int((tstate["genomes"] != before["genomes"]).sum())
    # the steps really spawn (resource halves) and overwrite genomes
    assert spawned > 0 and mutated > 0


def test_quality_matches_reference():
    jb, tb = _apps("torus", 16, 16)
    rng = np.random.default_rng(11)
    g = rng.integers(0, 256, (16, 4, 4, 16)).astype(np.int32)
    assert tb.quality(dict(genomes=torch.as_tensor(g))) == \
        jb.quality(dict(genomes=jnp.asarray(g)))


def _evo_pair(seed, cfg, **kw):
    """The same dyadic evo run on the jax engine and the torch engine."""
    from repro.runtime.config import RunConfig as RefRunConfig
    jres = ref_make_engine(RefRunConfig(engine="jax", **kw), EvoApp(EvoConfig(
        n_processes=16, cells_per_process=16, seed=seed),
        topology=make_topology("torus", 16)), cfg,
        max_pops=EXACT_MAX_POPS).run()
    tres = make_engine(RunConfig(engine="torch", **kw),
                       torch_evo_app(16, "torus", seed), torch_cfg(cfg),
                       max_pops=EXACT_MAX_POPS, chunk=64, device="cpu").run()
    return jres, tres


@pytest.mark.parametrize("kw", [{}, {"superstep_windows": 4},
                                {"layout": "edge"}],
                         ids=["dense-window", "dense-W4", "edge"])
def test_engine_bitwise_vs_jax(kw):
    seed = case_seed("torus")
    jres, tres = _evo_pair(seed, dyadic_cfg(seed=seed), **kw)
    got, want = qos_signature(tres), ref_signature(jres)
    assert sum(got["updates"]) > 0 and got["sent"] > 0
    assert got == want, f"torch evo diverged from jax evo ({kw})"


def test_carry_across_one_dense_window():
    seed = case_seed("torus")
    cfg = dyadic_cfg(seed=seed)
    jeng = JaxEngine(EvoApp(EvoConfig(n_processes=16, cells_per_process=16,
                                      seed=seed),
                            topology=make_topology("torus", 16)), cfg,
                     max_pops=EXACT_MAX_POPS)
    teng = TorchEngine(torch_evo_app(16, "torus", seed), torch_cfg(cfg),
                       max_pops=EXACT_MAX_POPS, device="cpu")
    body = jax.jit(lambda c: jeng._window_body_dense(c, None)[0])
    carry = jeng._init_carry(seed)
    for _ in range(40):
        carry = body(carry)
    start = jax.device_get(carry)
    assert start["app"]["acc"].dtype == np.uint32
    assert int(start["app"]["acc"].max()) > 0
    tstart = carry_from_numpy(start, "cpu")
    assert tstart["app"]["acc"].dtype == torch.int64
    want = jax.device_get(body(carry))
    got = carry_to_numpy(as_one_replicate(teng._window_body_dense, tstart))
    assert sorted(got) == sorted(want)
    for key in want:
        a, b = want[key], got[key]
        pairs = ([(f"app.{k}", a[k], b[k]) for k in a]
                 if isinstance(a, dict) else [(key, a, b)])
        for name, x, y in pairs:
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape, name
            if name in ("app.resource", "stage_pay"):
                # one fused multiply-add per cell on the XLA side
                np.testing.assert_array_max_ulp(y, x, maxulp=1)
                continue
            np.testing.assert_array_equal(_bits(y), _bits(x), err_msg=name)


def test_interop_keeps_uint32():
    acc = np.array([0, 1, 2 ** 31, 2 ** 32 - 1], np.uint32)
    got = carry_from_numpy({"app": {"acc": acc}, "k": np.int32(3)}, "cpu")
    assert got["app"]["acc"].dtype == torch.int64
    assert got["app"]["acc"].tolist() == [0, 1, 2 ** 31, 2 ** 32 - 1]
    back = carry_to_numpy(got)
    assert back["app"]["acc"].dtype == np.uint32
    np.testing.assert_array_equal(back["app"]["acc"], acc)
    assert back["k"].dtype == np.int32
    with pytest.raises(ValueError, match="uint32"):
        carry_to_numpy({"x": torch.tensor([-1], dtype=torch.int64)})


def test_export_state_guard():
    """``carry_app_state`` on an app without ``export_state`` (evo) gives
    ``app_state=None``, as the reference does; graph coloring exports."""
    seed = case_seed("torus")
    cfg = dataclasses.replace(dyadic_cfg(seed=seed, duration=2.0 ** -9),
                              carry_app_state=True)
    jres, tres = _evo_pair(seed, cfg)
    assert jres.app_state is None and tres.app_state is None
    from torch_cases import torch_app
    res = make_engine("torch", torch_app(16, "torus", seed), torch_cfg(cfg),
                      device="cpu").run()
    assert sorted(res.app_state) == list(range(16))
