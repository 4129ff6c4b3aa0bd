"""repro_torch's SPMD tools against the reference's: the conduits
(``core/conduit.py``) and graph coloring's in-graph step
(``apps/graphcolor.update_block`` / ``spmd_step``), with the flap bucket
of ``WindowCore.fault_masks``.

- The flap bucket: the port's ``fault_masks`` against the reference's
  jitted one at the non-dyadic periods 3e-4 and 7e-5, on the clocks near
  bucket boundaries where ``floor(t / period)`` and ``floor(t * (1 /
  period))`` differ in float32 (XLA compiles the division into the
  product), with 64 edges at flap probability 0.5 each.
- The conduits, single rings (shifts ±1 and ±3 on an 8-long ring) and
  ``torus_conduits`` on a (2, 4) mesh, in modes 0-4 over three exchanges
  (modes 1/2 flushing on the second), against the reference's ``Conduit``
  under ``shard_map`` on 8 forced host devices (one subprocess, as
  ``tests/test_core_multidevice.py`` runs them): received values and
  buffers bitwise.
- ``update_block`` bitwise against ``jnp_update_block`` fed the same
  draws; 50 steps of ``spmd_step`` on a 2 × 2 mesh of 16 × 16 blocks fed
  the reference's per-device uniforms (its key chain replayed) bitwise
  against the reference's ``shard_map`` run, modes 0, 1 (flush every 8
  steps), 3 and 4: colors, probabilities and every step's per-device
  conflicts.
- On the port's own draws (the counter hash), the reference's criterion
  of ``tests/test_apps.py::test_spmd_graphcolor_multidevice``: best effort
  on the 2 × 2 mesh of 16 × 16 blocks ends (mean of the last 10 of 400
  steps) below 0.3 × its start (the first 10).
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cases  # noqa: E402,F401  (caps torch's CPU threads)

from repro_torch.apps import graphcolor  # noqa: E402
from repro_torch.core import conduit  # noqa: E402
from repro_torch.core.modes import AsyncMode  # noqa: E402
from repro_torch.runtime.window_core import WindowCore  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def t(a):
    return torch.as_tensor(np.array(a, copy=True))


def assert_bitwise(got, want, where=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (where, got.shape, got.dtype, want.shape, want.dtype)
    bad = got.view(np.uint8).reshape(got.size, -1) != \
        want.view(np.uint8).reshape(want.size, -1)
    assert not bad.any(), f"{where}: {int(bad.any(-1).sum())} of {got.size} differ"


# ---------------------------------------------------------------------------
# The flap bucket
# ---------------------------------------------------------------------------
def boundary_clocks(period: float) -> np.ndarray:
    """float32 clocks in [0, 0.02) within 8 ulps of a bucket boundary
    where dividing by the period and multiplying by its float32
    reciprocal give different buckets."""
    p = np.float32(period)
    base = (np.arange(int(0.02 / period) + 2) * np.float64(period)
            ).astype(np.float32)
    t_all = np.concatenate([(base.view(np.int32) + d).view(np.float32)
                            for d in range(-8, 9)])
    t_all = t_all[(t_all >= 0) & (t_all < np.float32(0.02))]
    differ = (np.floor(t_all / p)
              != np.floor(t_all * (np.float32(1) / p)))
    return t_all[differ]


@pytest.mark.parametrize("period", [3e-4, 7e-5])
def test_flap_bucket_is_the_references_jitted(period):
    jax = pytest.importorskip("jax")
    from repro.runtime.window_core import WindowCore as RefCore
    clocks = boundary_clocks(period)
    assert clocks.size >= 5, clocks
    n_e = 64
    t_src = np.repeat(clocks[:, None], n_e, 1)
    eids = np.broadcast_to(np.arange(n_e, dtype=np.int32), t_src.shape)
    steps = np.zeros(t_src.shape, np.int32)
    loss = np.zeros(t_src.shape, np.float32)
    flap = np.full(t_src.shape, 0.5, np.float32)
    dead = np.zeros(t_src.shape, bool)
    want = jax.jit(lambda ts, e, s, lo, fl, d: RefCore.fault_masks(
        None, 7, ts, s, e, lo, fl, period, d))(
        t_src, eids, steps, loss, flap, dead)
    got = WindowCore.fault_masks(None, 7, t(t_src), t(steps), t(eids),
                                 t(loss), t(flap), period, t(dead))
    for g, w in zip(got, want):
        assert_bitwise(g, w, f"period {period}")
    # the check sees the bucket: the masks are not all alike
    assert 0 < int(got[0].sum()) < got[0].numel()


# ---------------------------------------------------------------------------
# The reference under shard_map, in one subprocess
# ---------------------------------------------------------------------------
RING_DIRS = {"p1": 1, "m1": -1, "p3": 3, "m3": -3}
FLUSH = (False, True, False)
H = W = 16
STEPS = 50
GC_MODES = (0, 1, 3, 4)

REF_SCRIPT = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.apps.graphcolor import spmd_step
from repro.core.conduit import Conduit, torus_conduits
from repro.core.modes import AsyncMode
from repro.launch.mesh import shard_map  # version-compat wrapper

out = {}
devs = np.array(jax.devices())
rng = np.random.default_rng(0)
out["ring_values"] = rng.standard_normal((8, 5)).astype(np.float32)
out["torus_values"] = rng.integers(0, 99, (2, 4, 3)).astype(np.int32)


def exchanges(conds, v, mode):
    bufs = [c.init_buffers(v) for c in conds]
    res = []
    for s in range(3):
        kw = {"flush": jnp.asarray(FLUSH[s])} if mode in (1, 2) else {}
        for i, c in enumerate(conds):
            rec, bufs[i] = c.exchange(v + 100 * s, bufs[i], **kw)
            res.append(rec)
            res.append(bufs[i])
    return res


ring = Mesh(devs, ("x",))
torus = Mesh(devs.reshape(2, 4), ("row", "col"))
for mode in range(5):
    cond = Conduit("x", RING_DIRS, AsyncMode(mode))
    f = jax.jit(shard_map(lambda v: exchanges([cond], v, mode), ring,
                          in_specs=P("x"), out_specs=P("x")))
    for i, d in enumerate(f(out["ring_values"])):
        for name, x in d.items():
            out[f"ring/{mode}/{i}/{name}"] = np.asarray(x)
    conds = torus_conduits(("row", "col"), AsyncMode(mode))
    f = jax.jit(shard_map(lambda v: exchanges(list(conds), v, mode), torus,
                          in_specs=P("row", "col"),
                          out_specs=P("row", "col")))
    for i, d in enumerate(f(out["torus_values"])):
        for name, x in d.items():
            out[f"torus/{mode}/{i}/{name}"] = np.asarray(x)

# graph coloring: tests/test_apps.py's body for STEPS steps, every mode
mesh = Mesh(devs[:4].reshape(2, 2), ("row", "col"))
keys = jax.random.split(jax.random.PRNGKey(0), 4).reshape(2, 2, 2)


def chain(key):
    def f(k, _):
        k, sub = jax.random.split(k)
        return k, jax.random.uniform(sub, (H, W, 1))[..., 0]
    return jax.lax.scan(f, key, None, length=STEPS)[1]


out["u"] = np.asarray(jax.jit(jax.vmap(chain))(keys.reshape(4, 2))
                      ).reshape(2, 2, STEPS, H, W).transpose(2, 0, 1, 3, 4)
out["colors0"] = np.stack([np.asarray(jax.random.randint(k, (H, W), 0, 3))
                           for k in keys.reshape(4, 2)]).reshape(2, 2, H, W)


def _vary(x):
    if not hasattr(jax, "typeof"):
        return x
    missing = tuple(a for a in ("row", "col") if a not in jax.typeof(x).vma)
    return jax.lax.pvary(x, missing) if missing else x


for mode in GC_MODES:
    rowc, colc = torus_conduits(("row", "col"), AsyncMode(mode))

    def body(keys):
        key = keys[0][0]
        colors = jax.random.randint(key, (H, W), 0, 3)
        state = {
            "colors": colors, "probs": jnp.full((H, W, 3), 1 / 3.),
            "bufs_row": rowc.init_buffers(jnp.zeros((2, W), colors.dtype)),
            "bufs_col": colc.init_buffers(jnp.zeros((2, H), colors.dtype)),
            "key": key, "step": jnp.zeros((), jnp.int32),
        }
        state = jax.tree.map(_vary, state)

        def step(state, _):
            flush = (state["step"] % 8) == 7 if mode in (1, 2) else None
            return spmd_step(state, rowc, colc, 0.1, flush=flush)
        state, confs = jax.lax.scan(step, state, None, length=STEPS)
        return (state["colors"][None, None], state["probs"][None, None],
                confs[None, None])

    f = jax.jit(shard_map(body, mesh, in_specs=P("row", "col"),
                          out_specs=P("row", "col")))
    colors, probs, confs = f(keys)
    out[f"gc/{mode}/colors"] = np.asarray(colors)
    out[f"gc/{mode}/probs"] = np.asarray(probs)
    out[f"gc/{mode}/confs"] = np.asarray(confs)
np.savez(OUT, **out)
print("REF-SPMD-OK")
"""


@pytest.fixture(scope="module")
def ref_run(tmp_path_factory):
    pytest.importorskip("jax")
    path = str(tmp_path_factory.mktemp("spmd") / "ref.npz")
    head = (f"RING_DIRS = {RING_DIRS!r}\nFLUSH = {FLUSH!r}\nH = W = {H}\n"
            f"STEPS = {STEPS}\nGC_MODES = {GC_MODES!r}\nOUT = {path!r}\n")
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c",
                        head + textwrap.dedent(REF_SCRIPT)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0 and "REF-SPMD-OK" in r.stdout, \
        f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    return dict(np.load(path))


def port_exchanges(conds, v, mode, flush_tensor):
    bufs = [c.init_buffers(v) for c in conds]
    res = []
    for s in range(3):
        kw = {}
        if mode in (1, 2):
            kw["flush"] = torch.tensor(FLUSH[s]) if flush_tensor else FLUSH[s]
        for i, c in enumerate(conds):
            rec, bufs[i] = c.exchange(v + 100 * s, bufs[i], **kw)
            res.append(rec)
            res.append(bufs[i])
    return res


@pytest.mark.parametrize("mode", range(5))
def test_ring_conduit_is_the_references(ref_run, mode):
    v = t(ref_run["ring_values"])
    for flush_tensor in (False, True):
        cond = conduit.Conduit("x", RING_DIRS, AsyncMode(mode))
        for i, d in enumerate(port_exchanges([cond], v, mode, flush_tensor)):
            for name, x in d.items():
                assert_bitwise(x, ref_run[f"ring/{mode}/{i}/{name}"],
                               f"mode {mode} #{i} {name}")


@pytest.mark.parametrize("mode", range(5))
def test_torus_conduits_are_the_references(ref_run, mode):
    v = t(ref_run["torus_values"])
    rowc, colc = conduit.torus_conduits(("row", "col"), AsyncMode(mode))
    assert (rowc.dim, colc.dim) == (0, 1)
    assert rowc.directions == {"north": 1, "south": -1}
    assert colc.directions == {"west": 1, "east": -1}
    for flush_tensor in (False, True):
        out = port_exchanges([rowc, colc], v, mode, flush_tensor)
        for i, d in enumerate(out):
            for name, x in d.items():
                assert_bitwise(x, ref_run[f"torus/{mode}/{i}/{name}"],
                               f"mode {mode} #{i} {name}")


def test_ring_exchange_and_perm():
    x = torch.arange(8)
    assert conduit.ring_perm(8, 3)[:2] == [(0, 3), (1, 4)]
    # device i receives device (i - shift)'s value
    assert conduit.ring_exchange(x, 0, 3).tolist() == \
        [(i - 3) % 8 for i in range(8)]
    y = torch.arange(12).reshape(3, 4)
    assert torch.equal(conduit.ring_exchange(y, 1, -1), y.roll(-1, 1))
    assert conduit.axis_size(y, 1) == 4
    for mode in (AsyncMode.ROLLING_BARRIER, AsyncMode.FIXED_BARRIER):
        c = conduit.Conduit("x", {"fwd": 1}, mode)
        with pytest.raises(AssertionError):
            c.exchange(x, c.init_buffers(x))


@pytest.mark.parametrize("C", [3, 4])
def test_update_block_is_jnp_update_block(C):
    jax = pytest.importorskip("jax")
    from repro.apps.graphcolor import jnp_update_block
    rng = np.random.default_rng(C)
    Hb, Wb = 24, 20
    colors = rng.integers(0, C, (Hb, Wb)).astype(np.int32)
    probs = rng.random((Hb, Wb, C)).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    halo = {k: rng.integers(0, C, (Wb if k in "ns" else Hb,)
                            ).astype(np.int32) for k in "nswe"}
    key = jax.random.PRNGKey(C)
    want = jax.jit(lambda c, p, h, k: jnp_update_block(c, p, h, 0.1, k))(
        colors, probs, halo, key)
    u = np.asarray(jax.random.uniform(key, (Hb, Wb, 1)))[..., 0]
    got = graphcolor.update_block(t(colors), t(probs),
                                  {k: t(v) for k, v in halo.items()}, 0.1,
                                  t(u))
    for g, w, name in zip(got, want, ("colors", "probs", "conflict")):
        assert_bitwise(g, w, name)
    # batched over leading (mesh) dims: the same per block
    stack = graphcolor.update_block(
        t(colors).expand(2, 3, Hb, Wb), t(probs).expand(2, 3, Hb, Wb, C),
        {k: t(v).expand(2, 3, -1) for k, v in halo.items()}, 0.1,
        t(u).expand(2, 3, Hb, Wb))
    for g, w in zip(stack, got):
        assert torch.equal(g[1, 2], w)


@pytest.mark.parametrize("mode", GC_MODES)
def test_spmd_step_is_the_references(ref_run, mode):
    rowc, colc = conduit.torus_conduits(("row", "col"), AsyncMode(mode))
    z = dict(dtype=torch.int32)
    state = {"colors": t(ref_run["colors0"]),
             "probs": torch.full((2, 2, H, W, 3), 1 / 3.),
             "bufs_row": rowc.init_buffers(torch.zeros((2, 2, 2, W), **z)),
             "bufs_col": colc.init_buffers(torch.zeros((2, 2, 2, H), **z)),
             "key": 0, "step": torch.zeros((), **z)}
    confs = []
    for s in range(STEPS):
        flush = (state["step"] % 8) == 7 if mode in (1, 2) else None
        state, conf = graphcolor.spmd_step(state, rowc, colc, 0.1,
                                           flush=flush,
                                           u=t(ref_run["u"][s]))
        confs.append(conf)
    assert int(state["step"]) == STEPS
    assert_bitwise(state["colors"], ref_run[f"gc/{mode}/colors"], "colors")
    assert_bitwise(state["probs"], ref_run[f"gc/{mode}/probs"], "probs")
    assert_bitwise(torch.stack(confs, -1), ref_run[f"gc/{mode}/confs"],
                   "conflicts")


def run_own_draws(mode, steps, seed=0, flush_every=None):
    rowc, colc = conduit.torus_conduits(("row", "col"), AsyncMode(mode))
    state = graphcolor.init_spmd_state((2, 2), (16, 16), 3, rowc, colc,
                                       seed=seed, device="cpu")
    confs = []
    for _ in range(steps):
        flush = None if flush_every is None else \
            (state["step"] % flush_every) == flush_every - 1
        state, conf = graphcolor.spmd_step(state, rowc, colc, 0.1,
                                           flush=flush)
        confs.append(conf)
    return state, torch.stack(confs).double()


@pytest.mark.parametrize("seed", [0, 1])
def test_spmd_best_effort_converges_on_own_draws(seed):
    """The reference's criterion on the port's counter-hash draws."""
    state, confs = run_own_draws(AsyncMode.BEST_EFFORT, 400, seed)
    start, end = float(confs[:10].mean()), float(confs[-10:].mean())
    assert end < 0.3 * start, (start, end)
    assert state["key"] == seed and int(state["step"]) == 400


def test_spmd_own_draws_are_the_counter_hash():
    """Without ``u`` the step draws ``spmd_uniforms(key, step)``; the
    initial colors are step -1's draws; a run is a function of the seed."""
    rowc, colc = conduit.torus_conduits(("row", "col"),
                                        AsyncMode.BEST_EFFORT)
    s0 = graphcolor.init_spmd_state((2, 2), (16, 16), 3, rowc, colc,
                                    seed=5, device="cpu")
    u0 = graphcolor.spmd_uniforms(5, -1, (2, 2, 16, 16), "cpu")
    assert torch.equal(s0["colors"], (u0 * 3).to(torch.int32))
    a, ca = graphcolor.spmd_step(s0, rowc, colc, 0.1)
    u1 = graphcolor.spmd_uniforms(5, s0["step"], (2, 2, 16, 16), "cpu")
    b, cb = graphcolor.spmd_step(s0, rowc, colc, 0.1, u=u1)
    assert torch.equal(a["colors"], b["colors"]) and torch.equal(ca, cb)
    _, c1 = run_own_draws(AsyncMode.ROLLING_BARRIER, 20, 3, flush_every=8)
    _, c2 = run_own_draws(AsyncMode.ROLLING_BARRIER, 20, 3, flush_every=8)
    assert torch.equal(c1, c2)
    _, c3 = run_own_draws(AsyncMode.ROLLING_BARRIER, 20, 4, flush_every=8)
    assert not torch.equal(c1, c3)
