"""repro_torch's compressors, AdamW, outer step, training data and
cross-pod exchange against the reference's.

- The compressors' ``encode`` / ``decode_sum`` and the train step's
  compressed cross-pod sum equal the reference's jitted ones BITWISE, on
  leaves of every shape class of the reference's train state (1-D, a 2-D
  stacked norm scale, a 3-D stacked weight) with 1 to 3 pods: payloads,
  residuals and totals.
- AdamW and the outer step, one step from the same carried-across state,
  agree within 1e-6 relative to each leaf's largest magnitude, not
  bitwise: torch and XLA sum the global norm in other orders, XLA fuses
  some multiply-adds, and ``b1 ** step`` and ``cos`` are different
  implementations.
- ``SyntheticLM`` batches are bitwise the reference's.
- The whole exchange and optimizer step (``make_update``) fed the
  reference's own gradients, for every mode, against the reference's step
  on the same gradients: compressor state bitwise, the rest within the
  AdamW bound above (the outer momentum, a pod mean of ``anchor -
  params``, relative to the params' largest magnitude; the second moment,
  quadratic in the clipped gradient, within twice the bound: the clip
  factor comes from the global norm, which differs by float32 rounding).
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cases  # noqa: E402,F401  (caps torch's CPU threads)

from repro_torch import interop  # noqa: E402
from repro_torch.core.modes import AsyncMode  # noqa: E402
from repro_torch.data.synthetic import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.optim import adamw, compression, outer  # noqa: E402
from repro_torch.pytree import flatten  # noqa: E402

RTOL = 1e-6


@pytest.fixture(scope="module")
def ref():
    """The reference (JAX); the card machine has no JAX."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.configs.smoke import reduce_for_smoke
    from repro.data.synthetic import DataConfig as RefDataConfig
    from repro.data.synthetic import SyntheticLM as RefSyntheticLM
    from repro.launch import train as ref_train
    from repro.models import lm as ref_lm
    from repro.optim import adamw as ref_adamw
    from repro.optim import compression as ref_comp
    from repro.optim import outer as ref_outer
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, get_config=get_config, reduce=reduce_for_smoke,
        train=ref_train, lm=ref_lm, adamw=ref_adamw, comp=ref_comp,
        outer=ref_outer, DataConfig=RefDataConfig,
        SyntheticLM=RefSyntheticLM)


def t(a):
    return torch.as_tensor(np.array(a, copy=True))


def assert_bitwise(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, got.dtype, want.shape, want.dtype)
    bad = got.view(np.uint8).reshape(got.size, -1) != \
        want.view(np.uint8).reshape(want.size, -1)
    assert not bad.any(), f"{int(bad.any(-1).sum())} of {got.size} differ"


def assert_close(got, want, rtol=RTOL, scale=None):
    """|got - want| <= rtol x max|scale| over the leaf (``scale`` defaults
    to ``want``): an update ``p - lr u`` or a delta ``anchor - p`` that
    nearly cancels keeps the absolute error of its operands."""
    want = np.asarray(want, np.float64)
    scale = np.abs(want if scale is None else np.asarray(scale)).max()
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=rtol * max(scale, 1e-30))


#: one leaf of each shape class of the reference's train state, as in the
#: reduced configs: a stacked weight (2, 64, 128), a stacked norm scale
#: (2, 64), a stacked bias whose top-k row is short (2, 32), final_norm
#: (64,), and a 1-D leaf that spans blocks with a ragged end (2500,)
LEAF_SHAPES = [(2, 64, 128), (2, 64), (2, 32), (64,), (2500,)]


def grad_like(seed, shape, pods):
    """Gradient-like values, magnitudes spanning many decades by row,
    with repeated magnitudes (ties) and zeros."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((pods,) + shape)
    rows = x.reshape(pods, -1, shape[-1])
    rows *= 10.0 ** rng.uniform(-9, 0, size=rows.shape[:-1] + (1,))
    flat = rows.reshape(-1)
    flat[1::7] = -flat[0::7][:len(flat[1::7])]      # equal magnitudes
    flat[::11] = 0.0
    return flat.reshape(x.shape).astype(np.float32)


@pytest.mark.parametrize("name", ["int8", "topk"])
@pytest.mark.parametrize("shape", LEAF_SHAPES)
@pytest.mark.parametrize("pods", [1, 2, 3])
def test_compressor_encode_and_decode_sum_bitwise(ref, name, shape, pods):
    rc = ref.comp.get_compressor(name)
    pc = compression.get_compressor(name)
    x = grad_like(1, shape, pods)
    payload, res = ref.jax.jit(ref.jax.vmap(rc.encode))(x)
    total = ref.jax.jit(lambda p: rc.decode_sum(
        p, shape, ref.jnp.float32))(payload)
    got = [pc.encode(t(x[p])) for p in range(pods)]
    for key in payload:
        assert_bitwise(torch.stack([g[0][key] for g in got]), payload[key])
    assert_bitwise(torch.stack([g[1] for g in got]), res)
    gathered = {k: t(v) for k, v in payload.items()}
    assert_bitwise(pc.decode_sum(gathered, shape, torch.float32), total)


@pytest.mark.parametrize("name", ["int8", "topk"])
def test_compressed_total_bitwise(ref, name):
    """The train step's cross-pod sum with error feedback: one call of the
    reference's ``_compressed_total`` over a tree of every shape class,
    against the port's leaf by leaf; totals and new residuals bitwise."""
    spec = ref.train.TrainSpec(compressor=name)
    pods = 2
    grads = {f"l{i}": grad_like(10 + i, s, pods)
             for i, s in enumerate(LEAF_SHAPES)}
    res = {k: grad_like(20 + i, v.shape[1:], pods) * np.float32(1e-3)
           for i, (k, v) in enumerate(grads.items())}
    want_total, want_res = ref.jax.jit(
        lambda g, r: ref.train._compressed_total(g, r, spec))(grads, res)
    comp = train.make_compressor(train.TrainSpec(compressor=name))
    for k in grads:
        r = t(res[k])
        total = train._compressed_total(t(grads[k]), r, comp)
        assert_bitwise(total, want_total[k])
        assert_bitwise(r, want_res[k])


def test_get_compressor():
    assert compression.get_compressor(None) is None
    assert compression.get_compressor("none") is None
    assert compression.get_compressor("topk", ratio=0.1).k_for(55) == 5
    with pytest.raises(ValueError):
        compression.get_compressor("fp8")


def random_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in (("embed", (50, 16)), ("final_norm", (16,)),
                         ("stack/0/ffn/down", (2, 32, 16)),
                         ("stack/0/mixer_norm", (2, 16)))}


def test_adamw_one_step(ref):
    """One AdamW step from carried-across moments at step 6 (inside the
    warmup) and step 150 (cosine decay); decay on every leaf of 2+
    dims."""
    for step, clip in ((6, 1.0), (150, 0.05)):
        cfg = dict(lr=1e-3, warmup_steps=20, total_steps=300,
                   grad_clip=clip)
        params, grads = random_tree(1, 0.05), random_tree(2, 0.3)
        m = random_tree(3, 0.01)
        v = {k: np.abs(a) for k, a in random_tree(4, 1e-3).items()}
        rstate = {"m": m, "v": v, "step": np.int32(step)}
        want_p, want_s, want_m = ref.jax.jit(
            lambda p, g, s: ref.adamw.apply_updates(
                p, g, s, ref.adamw.AdamWConfig(**cfg)))(params, grads, rstate)
        tp = {k: t(a) for k, a in params.items()}
        ts = {"m": {k: t(a) for k, a in m.items()},
              "v": {k: t(a) for k, a in v.items()},
              "step": torch.tensor(step, dtype=torch.int32)}
        _, _, got_m = adamw.apply_updates(
            tp, {k: t(a) for k, a in grads.items()}, ts,
            adamw.AdamWConfig(**cfg))
        assert int(ts["step"]) == step + 1
        assert_close(got_m["grad_norm"], want_m["grad_norm"])
        assert_close(got_m["lr"], want_m["lr"])
        for k in params:
            assert_close(tp[k], want_p[k])
            assert_close(ts["m"][k], want_s["m"][k])
            assert_close(ts["v"][k], want_s["v"][k])
        # decoupled decay touches the 2+-dim leaves only
        assert not np.allclose(np.asarray(want_p["stack/0/mixer_norm"]),
                               params["stack/0/mixer_norm"])


def test_schedule_and_global_norm(ref):
    cfg = dict(lr=2e-3, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    for step in (0, 1, 5, 10, 11, 55, 100, 130):
        assert_close(adamw.schedule(adamw.AdamWConfig(**cfg),
                                    torch.tensor(step)),
                     ref.adamw.schedule(ref.adamw.AdamWConfig(**cfg),
                                        ref.jnp.asarray(step)))
    tree = random_tree(5)
    assert_close(adamw.global_norm({k: t(a) for k, a in tree.items()}),
                 ref.adamw.global_norm(tree))


def test_outer_step(ref):
    params, anchor = random_tree(6, 0.05), random_tree(7, 0.05)
    mom, delta = random_tree(8, 0.01), random_tree(9, 0.01)
    for nesterov in (True, False):
        cfg = dict(outer_lr=0.7, outer_momentum=0.9, nesterov=nesterov)
        want_p, want_o = ref.jax.jit(lambda p, o, d: ref.outer.outer_step(
            p, o, d, ref.outer.OuterConfig(**cfg)))(
            params, {"anchor": anchor, "momentum": mom}, delta)
        got_p, got_o = outer.outer_step(
            {k: t(a) for k, a in params.items()},
            {"anchor": {k: t(a) for k, a in anchor.items()},
             "momentum": {k: t(a) for k, a in mom.items()}},
            {k: t(a) for k, a in delta.items()}, outer.OuterConfig(**cfg))
        for k in params:
            assert_close(got_p[k], want_p[k])
            assert_close(got_o["anchor"][k], want_o["anchor"][k])
            assert_close(got_o["momentum"][k], want_o["momentum"][k])
    st = outer.init_outer_state({k: t(a) for k, a in params.items()})
    assert torch.equal(st["anchor"]["embed"], t(params["embed"]))
    assert not st["momentum"]["embed"].any()


def test_synthetic_batches_bitwise(ref):
    kw = dict(vocab_size=503, seq_len=33, global_batch=4, seed=3)
    mine, theirs = SyntheticLM(DataConfig(**kw)), \
        ref.SyntheticLM(ref.DataConfig(**kw))
    for step in (0, 1, 17):
        a, b = mine.batch_for_step(step), theirs.batch_for_step(step)
        for k in ("tokens", "labels"):
            assert_bitwise(a[k], b[k])
        assert_bitwise(mine.frontend_for_step(step, 4, 8),
                       theirs.frontend_for_step(step, 4, 8))


# ---------------------------------------------------------------------------
# The exchange and optimizer step on the reference's own gradients
# ---------------------------------------------------------------------------
def ref_update(ref, spec, n_pods):
    """The reference's train step after its gradients
    (src/repro/launch/train.py, ``train_step`` from the exchange on),
    built from the reference's own functions, taking the gradients as an
    argument."""
    jax, jnp = ref.jax, ref.jnp
    mode = spec.mode

    def update(state, grads):
        step = state["step"]
        new_state = dict(state)
        if mode == AsyncMode.BARRIER_EVERY_STEP:
            eff = jax.tree.map(lambda g: jnp.broadcast_to(
                jnp.mean(g, 0, keepdims=True), g.shape), grads)
        elif mode == AsyncMode.BEST_EFFORT:
            if spec.compressor is None:
                total = jax.tree.map(lambda g: jnp.sum(g, 0, keepdims=True),
                                     grads)
            else:
                total, new_state["residuals"] = ref.train._compressed_total(
                    grads, state["residuals"], spec)
            eff = jax.tree.map(lambda g, o: (g + o) / n_pods, grads,
                               state["others"])
            new_state["others"] = jax.tree.map(lambda a, g: a - g, total,
                                               grads)
        else:
            eff = grads
        params, opt, om = jax.vmap(lambda p, g, o: ref.adamw.apply_updates(
            p, g, o, spec.adamw))(state["params"], eff, state["opt"])
        if mode in (AsyncMode.ROLLING_BARRIER, AsyncMode.FIXED_BARRIER):
            period = spec.outer.sync_period
            do_sync = (step % period) == (period - 1)
            delta = jax.tree.map(lambda a, p: a - p, state["outer"]["anchor"],
                                 params)
            mean_delta = jax.tree.map(lambda d: jnp.broadcast_to(
                jnp.mean(d, 0, keepdims=True), d.shape), delta)
            sp, so = jax.vmap(lambda p, o, d: ref.outer.outer_step(
                p, o, d, spec.outer))(params, state["outer"], mean_delta)
            sel = lambda a, b: jax.tree.map(
                lambda x, y: jnp.where(do_sync, x, y), a, b)
            params = sel(sp, params)
            new_state["outer"] = sel(so, state["outer"])
        new_state.update(params=params, opt=opt, step=step + 1)
        return new_state, jnp.mean(om["grad_norm"])

    return jax.jit(update)


UPDATE_CASES = [(0, None), (1, None), (2, None), (3, None), (3, "int8"),
                (3, "topk"), (4, None)]


@pytest.mark.parametrize("mode,compressor", UPDATE_CASES)
def test_update_on_reference_gradients(ref, mode, compressor):
    """Two steps (the second from the first's state; the outer sync falls
    on the second, sync_period 2) of the exchange and AdamW on the same
    reference-made gradients."""
    n_pods = 2
    kw = dict(mode=AsyncMode(mode), compressor=compressor,
              adamw=ref.adamw.AdamWConfig(lr=1e-3, warmup_steps=2,
                                          total_steps=10),
              outer=ref.outer.OuterConfig(sync_period=2))
    spec_ref = ref.train.TrainSpec(**kw)
    cfg = ref.reduce(ref.get_config("qwen2-1.5b")).replace(dtype="float32")
    state = ref.train.init_train_state(ref.jax.random.PRNGKey(0), cfg,
                                       spec_ref, n_pods)
    mine = interop.train_state_from_numpy(
        ref.jax.tree.map(np.asarray, state), "cpu")
    spec = train.TrainSpec(
        mode=AsyncMode(mode), compressor=compressor,
        adamw=adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10),
        outer=outer.OuterConfig(sync_period=2))
    update, want_update = train.make_update(spec, n_pods), \
        ref_update(ref, spec_ref, n_pods)
    for step in range(2):
        grads = ref.jax.tree.map(
            lambda a, s=step: grad_like(30 + s, a.shape[1:], n_pods),
            state["params"])
        state, want_norm = want_update(state, grads)
        flat_g = {k: t(v) for k, v in flatten(grads).items()}
        mine, got = update(mine, flat_g, {"ce": torch.zeros(n_pods),
                                          "aux": torch.zeros(n_pods)})
        assert_close(got["grad_norm"], want_norm, rtol=1e-5)
    want = flatten(ref.jax.tree.map(np.asarray, state))
    for k, v in flatten(mine).items():
        if k.startswith(("others", "residuals")):
            # the exchange is exact; params moved by AdamW feed it nothing
            assert_bitwise(v, want[k])
        elif k.startswith("outer/momentum/"):
            # the pod-mean of anchor - params: the params' rounding
            assert_close(v.numpy(), want[k],
                         scale=want["params/" + k[len("outer/momentum/"):]])
        elif k.startswith("opt/v/"):
            # quadratic in the clipped gradient: twice the clip's error
            assert_close(v.numpy(), want[k], rtol=2 * RTOL)
        else:
            assert_close(v.numpy(), want[k])
