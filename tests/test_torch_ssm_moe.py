"""repro_torch's Mamba mixer and MoE FFN against the reference's.

The reference's initial leaves (``ssm.init_mamba``, ``moe.init_moe``),
carried across as numpy arrays, and numpy-made inputs go through both
packages' functions in float32:

- ``mamba_forward(return_state=True)`` (the port's scan is ``mamba_scan``'s
  plain version on the CPU, the reference's a chunked associative scan)
  and ``mamba_decode`` agree within 1e-5 (float32 sums in another order);
- ``apply_moe`` over a sequence (grouped, capacity drops) and over one
  token (dense) agree within 1e-5, with the same dropped pairs, in a case
  where the capacity binds, and with a shared expert;
- with nothing dropped (capacity_factor = E / k) the grouped path equals
  the dense decode path token by token, within 1e-5.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cases  # noqa: E402,F401  (caps torch's CPU threads)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.configs.smoke import reduce_for_smoke  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.models import moe, ssm  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def ref():
    """The reference (JAX); the card machine has no JAX."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as ref_get_config
    from repro.configs.smoke import reduce_for_smoke as ref_reduce
    from repro.models import moe as ref_moe
    from repro.models import ssm as ref_ssm
    return types.SimpleNamespace(jax=jax, jnp=jnp, get_config=ref_get_config,
                                 reduce=ref_reduce, moe=ref_moe, ssm=ref_ssm)


def jamba_smoke(ref):
    cfg = reduce_for_smoke(get_config("jamba-v0.1-52b")).replace(
        dtype="float32")
    return ref.reduce(ref.get_config("jamba-v0.1-52b")).replace(
        dtype="float32"), cfg


def to_torch(tree):
    return {k: to_torch(v) if isinstance(v, dict)
            else torch.as_tensor(np.array(v)) for k, v in tree.items()}


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def activations(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------
def mamba_leaves(ref, ref_cfg, seed):
    """The reference's initial leaves with D, dt_bias and conv_b moved off
    their constant initial values, so that every leaf shows."""
    p = ref.jax.tree.map(np.asarray, ref.ssm.init_mamba(
        ref.jax.random.PRNGKey(seed), ref_cfg, ref.jnp.float32))
    rng = np.random.default_rng(seed)
    for name in ("D", "conv_b"):
        p[name] = (p[name] + rng.standard_normal(p[name].shape) * 0.3
                   ).astype(np.float32)
    return p


@pytest.mark.parametrize("B,S", [(2, 32), (1, 512), (2, 2)])
def test_mamba_forward_and_state_match_reference(B, S, ref):
    """S = 512 runs two of the reference's scan chunks; S = 2 is shorter
    than the conv window (the reference's state needs S >= 3: the port
    pads the conv state with zeros, which is what the window holds)."""
    ref_cfg, cfg = jamba_smoke(ref)
    p = mamba_leaves(ref, ref_cfg, seed=S)
    x = activations(S, B, S, cfg.d_model)
    kbuild.reset_launches()
    out, state = ssm.mamba_forward(to_torch(p), torch.as_tensor(x), cfg,
                                   return_state=True)
    assert kbuild.LAUNCHES["mamba_scan"] == 0
    if S >= cfg.mamba_d_conv - 1:
        want, wstate = ref.ssm.mamba_forward(p, ref.jnp.asarray(x), ref_cfg,
                                             return_state=True)
        np.testing.assert_allclose(f32(state["conv"]), f32(wstate["conv"]),
                                   **TOL)
    else:
        want = ref.ssm.mamba_forward(p, ref.jnp.asarray(x), ref_cfg)
        xin = x @ p["in_proj"]
        np.testing.assert_array_equal(f32(state["conv"])[:, :-S], 0.0)
        np.testing.assert_allclose(f32(state["conv"])[:, -S:],
                                   xin[..., :xin.shape[-1] // 2], **TOL)
    np.testing.assert_allclose(f32(out), f32(want), **TOL)
    if S >= cfg.mamba_d_conv - 1:
        np.testing.assert_allclose(f32(state["h"]), f32(wstate["h"]), **TOL)
    assert state["h"].dtype == torch.float32
    assert tuple(state["conv"].shape) == (B, cfg.mamba_d_conv - 1,
                                          cfg.mamba_expand * cfg.d_model)


def test_mamba_decode_matches_reference_and_writes_state_in_place(ref):
    ref_cfg, cfg = jamba_smoke(ref)
    p = mamba_leaves(ref, ref_cfg, seed=7)
    x = activations(7, 2, 24 + 5, cfg.d_model)
    _, wstate = ref.ssm.mamba_forward(p, ref.jnp.asarray(x[:, :24]), ref_cfg,
                                      return_state=True)
    state = {k: torch.as_tensor(np.array(v)) for k, v in wstate.items()}
    h_buf, conv_buf = state["h"], state["conv"]
    tp = to_torch(p)
    for t in range(24, 29):
        want, wstate = ref.ssm.mamba_decode(p, ref.jnp.asarray(x[:, t:t + 1]),
                                            wstate, ref_cfg)
        got = ssm.mamba_decode(tp, torch.as_tensor(x[:, t:t + 1]), state, cfg)
        np.testing.assert_allclose(f32(got), f32(want), **TOL)
        np.testing.assert_allclose(f32(state["h"]), f32(wstate["h"]), **TOL)
        np.testing.assert_allclose(f32(state["conv"]), f32(wstate["conv"]),
                                   **TOL)
    assert state["h"] is h_buf and state["conv"] is conv_buf


def test_mamba_module_init_follows_reference_distributions():
    cfg = reduce_for_smoke(get_config("jamba-v0.1-52b"))
    gen = torch.Generator().manual_seed(0)
    m = ssm.Mamba(gen, cfg, torch.float32)
    d, di, N, dconv, dt_rank = ssm._mamba_dims(cfg)
    shapes = {k: tuple(v.shape) for k, v in m.named_parameters()}
    assert shapes == {"in_proj": (d, 2 * di), "conv_w": (dconv, di),
                      "conv_b": (di,), "x_proj": (di, dt_rank + 2 * N),
                      "dt_proj": (dt_rank, di), "dt_bias": (di,),
                      "A_log": (di, N), "D": (di,), "out_proj": (di, d)}
    np.testing.assert_allclose(
        m.A_log.numpy(), np.log(np.tile(np.arange(1, N + 1), (di, 1))),
        rtol=1e-7)
    np.testing.assert_array_equal(m.D.numpy(), 1.0)
    dt = np.log1p(np.exp(m.dt_bias.numpy()))       # softplus: dt itself
    assert dt.min() >= 1e-3 * (1 - 1e-5) and dt.max() <= 1e-1 * (1 + 1e-5)
    assert abs(m.in_proj.numpy()).max() <= 2 * d ** -0.5


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------
def moe_cfgs(ref, **kw):
    ref_cfg, cfg = jamba_smoke(ref)
    return ref_cfg.replace(**kw), cfg.replace(**kw)


def moe_leaves(ref, ref_cfg, seed):
    return ref.jax.tree.map(np.asarray, ref.moe.init_moe(
        ref.jax.random.PRNGKey(seed), ref_cfg, ref.jnp.float32))


def drops(p, x, cfg, capacity):
    _, _, idx = moe._route(p, x, cfg)
    pos = moe._positions_in_expert(idx, cfg.num_experts)
    return int((pos >= capacity).sum())


@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("S,factor", [(16, 1.25), (40, 1.0), (12, 0.5)])
def test_grouped_moe_matches_reference(S, factor, shared, ref):
    ref_cfg, cfg = moe_cfgs(ref, num_shared_experts=shared)
    p = moe_leaves(ref, ref_cfg, seed=S + shared)
    x = activations(S, 3, S, cfg.d_model)
    tp = to_torch(p)
    want, waux = ref.moe.apply_moe(p, ref.jnp.asarray(x), ref_cfg,
                                   capacity_factor=factor)
    got, aux = moe.apply_moe(tp, torch.as_tensor(x), cfg,
                             capacity_factor=factor)
    np.testing.assert_allclose(f32(got), f32(want), **TOL)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-5)
    capacity = int(max(1, round(S * cfg.experts_per_tok / cfg.num_experts
                                * factor)))
    if factor < 1.25:
        assert drops(tp, torch.as_tensor(x), cfg, capacity) > 0


def test_bf16_aux_rounds_counts_as_the_reference(ref):
    """The reference counts each expert's routed pairs by summing a
    one-hot in the compute dtype, so in bf16 a count above 256 is rounded
    (513 -> 512) before the division.  At 2 groups x 2048 tokens, top-2
    over 8 experts, every count exceeds 256: the port's aux equals the
    jitted reference's bitwise, and differs from the exact-count aux."""
    ref_cfg, cfg = moe_cfgs(ref)
    ref_cfg, cfg = ref_cfg.replace(dtype="bfloat16"), cfg.replace(
        dtype="bfloat16")
    p = moe_leaves(ref, ref_cfg, seed=17)
    jnp = ref.jnp
    jp = {k: v if k == "router" else jnp.asarray(v).astype(jnp.bfloat16)
          for k, v in p.items()}
    tp = {k: v if k == "router" else v.to(torch.bfloat16)
          for k, v in to_torch(p).items()}
    x = activations(17, 2, 2048, cfg.d_model)
    _, waux = ref.jax.jit(lambda p, x: ref.moe.apply_moe(p, x, ref_cfg))(
        jp, jnp.asarray(x).astype(jnp.bfloat16))
    xt = torch.as_tensor(x).to(torch.bfloat16)
    _, aux = moe.apply_moe(tp, xt, cfg)
    probs, _, idx = moe._route(tp, xt, cfg)
    counts = torch.nn.functional.one_hot(idx, cfg.num_experts).sum((1, 2))
    assert int(counts.min()) > 256
    assert not torch.equal(counts.to(torch.bfloat16).long(), counts)
    assert aux.dtype == torch.float32
    assert float(aux) == float(np.float32(waux))
    E, k = cfg.num_experts, cfg.experts_per_tok
    exact = (E * (probs.mean(1) * counts / (2048 * k)).sum(-1)).mean() \
        * moe.ROUTER_AUX_WEIGHT
    assert float(exact) != float(aux)


def test_positions_in_expert_match_reference(ref):
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 8, (4, 50, 2)).astype(np.int32)
    got = moe._positions_in_expert(torch.as_tensor(idx), 8)
    for g in range(4):
        want = ref.moe._positions_in_expert(ref.jnp.asarray(idx[g]), 8)
        np.testing.assert_array_equal(got[g].numpy(), np.asarray(want))


def test_dropped_pairs_are_the_references(ref):
    """The capacity binds: the port routes each token to the reference's
    experts and drops exactly the pairs the reference ranks at or beyond
    the capacity."""
    ref_cfg, cfg = moe_cfgs(ref)
    p = moe_leaves(ref, ref_cfg, seed=11)
    x = activations(11, 2, 24, cfg.d_model)
    E, k = cfg.num_experts, cfg.experts_per_tok
    capacity = round(24 * k / E * 0.75)
    _, _, idx = moe._route(to_torch(p), torch.as_tensor(x), cfg)
    kept = moe._positions_in_expert(idx, E) < capacity
    assert int((~kept).sum()) > 0
    jnp = ref.jnp
    for g in range(2):
        probs = ref.jax.nn.softmax(jnp.asarray(x[g]) @ p["router"], axis=-1)
        _, widx = ref.jax.lax.top_k(probs, k)
        wkeep = ref.moe._positions_in_expert(widx, E) < capacity
        np.testing.assert_array_equal(idx[g].numpy(), np.asarray(widx))
        np.testing.assert_array_equal(kept[g].numpy(), np.asarray(wkeep))


@pytest.mark.parametrize("shared", [0, 1])
def test_dense_decode_moe_matches_reference(shared, ref):
    ref_cfg, cfg = moe_cfgs(ref, num_shared_experts=shared)
    p = moe_leaves(ref, ref_cfg, seed=5 + shared)
    x = activations(5, 6, 1, cfg.d_model)
    want, _ = ref.moe.apply_moe(p, ref.jnp.asarray(x), ref_cfg)
    got, aux = moe.apply_moe(to_torch(p), torch.as_tensor(x), cfg)
    np.testing.assert_allclose(f32(got), f32(want), **TOL)
    assert float(aux) == 0.0


@pytest.mark.parametrize("S", [1, 24])
def test_bf16_moe_matches_reference(S, ref):
    """bf16 weights (the router stays float32, as the compute cast keeps
    it) and bf16 inputs: the same experts for every token (the routing is
    float32 on the same bf16 values), and outputs within four bf16 ulps
    of the largest magnitude: the expert products round once in bf16 on
    both sides, but the reference's ``jax.nn.silu`` uses XLA's bf16
    sigmoid, one bf16 ulp from torch's on many of the hidden elements
    (ROADMAP Queue 3)."""
    ref_cfg, cfg = moe_cfgs(ref, num_shared_experts=1)
    ref_cfg, cfg = ref_cfg.replace(dtype="bfloat16"), cfg.replace(
        dtype="bfloat16")
    p = moe_leaves(ref, ref_cfg, seed=13)
    jnp = ref.jnp
    jp = {k: (v if k == "router" else
              ref.jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16),
                               v))
          for k, v in p.items()}
    tp = {k: v if k == "router" else
          {kk: vv.to(torch.bfloat16) for kk, vv in v.items()}
          if isinstance(v, dict) else v.to(torch.bfloat16)
          for k, v in to_torch(p).items()}
    x = activations(13, 3, S, cfg.d_model)
    want, _ = ref.moe.apply_moe(jp, jnp.asarray(x).astype(jnp.bfloat16),
                                ref_cfg, capacity_factor=0.75)
    got, _ = moe.apply_moe(tp, torch.as_tensor(x).to(torch.bfloat16), cfg,
                           capacity_factor=0.75)
    assert got.dtype == torch.bfloat16
    want = f32(want)
    np.testing.assert_allclose(f32(got), want, rtol=0,
                               atol=4 * 2.0 ** -8 * np.abs(want).max())


def test_no_drops_equals_dense_decode_token_by_token(ref):
    """With capacity_factor = E / k every expert can take every token: the
    grouped path is then the dense path's function."""
    _, cfg = moe_cfgs(ref)
    p = to_torch(moe_leaves(ref, ref.reduce(ref.get_config(
        "jamba-v0.1-52b")).replace(dtype="float32"), seed=9))
    x = torch.as_tensor(activations(9, 2, 20, cfg.d_model))
    factor = cfg.num_experts / cfg.experts_per_tok
    grouped, _ = moe.apply_moe(p, x, cfg, capacity_factor=factor)
    assert drops(p, x, cfg, 20) == 0
    for t in range(20):
        dense, _ = moe.apply_moe(p, x[:, t:t + 1], cfg)
        np.testing.assert_allclose(f32(grouped[:, t:t + 1]), f32(dense),
                                   **TOL)


def test_top_k_ties_go_to_the_lower_index():
    cfg = ModelConfig(name="t", family="moe", num_layers=2, d_model=4,
                      num_heads=1, num_kv_heads=1, d_ff=8, vocab_size=8,
                      num_experts=4, experts_per_tok=2, moe_d_ff=8,
                      dtype="float32")
    router = torch.zeros((4, 4))
    router[0, 3] = 1.0                          # expert 3 first, then a tie
    probs, w, idx = moe._route({"router": router}, torch.eye(4)[:1], cfg)
    assert idx.tolist() == [[3, 0]]
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_moe_module_leaves_follow_reference_names(ref):
    ref_cfg, cfg = moe_cfgs(ref, num_shared_experts=1)
    m = moe.MoE(torch.Generator().manual_seed(0), cfg, torch.float32)
    want = moe_leaves(ref, ref_cfg, seed=0)
    flat = {**{k: v for k, v in want.items() if k != "shared"},
            **{f"shared.{k}": v for k, v in want["shared"].items()}}
    assert {k: tuple(v.shape) for k, v in m.named_parameters()} == \
        {k: v.shape for k, v in flat.items()}
    assert m.router.dtype == torch.float32
