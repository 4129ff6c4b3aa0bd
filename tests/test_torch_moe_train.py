"""repro_torch's MoE training path against the reference's.

- ``lm.loss_fn`` on the reduced deepseek-moe-16b (2 shared experts) and
  dbrx-132b (8 experts top-2 after the cut), float32, from the same
  carried-across weights (perturbed, so the norm scales are not zero): ce
  and the aux loss within 1e-5 relative of the reference's, and every
  gradient leaf within 1e-4 of its largest magnitude of ``jax.grad``'s
  (the same tolerance as the dense model's, ``test_torch_train.py``:
  float32 sums in other orders through two layers, the router's softmax
  and a 503-way softmax; measured, the worst leaf is 2.3e-6 of its
  largest magnitude).  Once with the capacity that drops pairs (the
  router's default factor 1.25; the test counts the drops) and once with
  a capacity no expert can overflow; ``remat`` on (the configs' default)
  and off give the same gradients.
- ``_moe_groups`` under autograd against ``jax.grad`` of the reference's
  one-hot dispatch, with drops: a dropped pair reads slot 0 with weight
  0 and sends it an exact zero, the top-k weights pass their gradient to
  the k kept probabilities only, the expert counts carry none.
- One ``make_train_step`` step in mode 3 with the top-k compressor, two
  pods, against the reference's jitted step.
- The four configs this slice adds count the reference's parameters.
- The CLI trains the reduced deepseek-moe-16b on the CPU.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch_cases import close, perturbed_params  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.smoke import reduce_for_smoke  # noqa: E402
from repro_torch.core.modes import AsyncMode  # noqa: E402
from repro_torch.data.synthetic import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import lm, moe, transformer  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.pytree import flatten  # noqa: E402

ARCHS = ["deepseek-moe-16b", "dbrx-132b"]
NEW_ARCHS = ARCHS + ["musicgen-large", "llava-next-mistral-7b"]
LOSS_RTOL, GRAD_TOL, NORM_RTOL, MOVE_TOL = 1e-5, 1e-4, 1e-4, 0.05
B, S = 3, 64
ADAMW = dict(lr=1e-3, warmup_steps=2, total_steps=20)


@pytest.fixture(scope="module")
def ref():
    """The reference (JAX); the card machine has no JAX."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as ref_get_config
    from repro.configs.smoke import reduce_for_smoke as ref_reduce
    from repro.launch import train as ref_train
    from repro.models import lm as ref_lm
    from repro.models import moe as ref_moe
    from repro.optim.adamw import AdamWConfig as RefAdamW
    return types.SimpleNamespace(jax=jax, jnp=jnp, get_config=ref_get_config,
                                 reduce=ref_reduce, train=ref_train,
                                 lm=ref_lm, moe=ref_moe, AdamW=RefAdamW)


def configs(ref, arch, **kw):
    return (ref.reduce(ref.get_config(arch)).replace(dtype="float32", **kw),
            reduce_for_smoke(get_config(arch)).replace(dtype="float32", **kw))


def batch_of(cfg, seed=1):
    return SyntheticLM(DataConfig(cfg.vocab_size, S, B, seed=seed)
                       ).batch_for_step(0)


def set_capacity(monkeypatch, ref, cfg, factor):
    """Both packages' MoE layers at ``capacity_factor`` = ``factor``; the
    port's counts the pairs each call drops.  Returns that list."""
    dropped = []
    real, ref_real = moe.apply_moe, ref.moe.apply_moe

    def port(p, x, cfg_, capacity_factor=factor):
        G, T, _ = x.shape
        if T > 1:
            E, k = cfg_.num_experts, cfg_.experts_per_tok
            cap = int(max(1, round(T * k / E * capacity_factor)))
            _, _, idx = moe._route(p, x, cfg_)
            pos = moe._positions_in_expert(idx, E)
            dropped.append(int((pos >= cap).sum()))
        return real(p, x, cfg_, capacity_factor=capacity_factor)

    monkeypatch.setattr(transformer, "apply_moe", port)
    monkeypatch.setattr(ref.moe, "apply_moe",
                        lambda p, x, c: ref_real(p, x, c, factor))
    return dropped


def port_loss_and_grads(params, batch, cfg):
    leaves = {k: torch.as_tensor(np.array(v)).requires_grad_(True)
              for k, v in flatten(params).items()}
    loss, m = lm.loss_fn(leaves, {k: torch.as_tensor(v)
                                  for k, v in batch.items()}, cfg)
    loss.backward()
    return (loss.detach(), {k: v.detach() for k, v in m.items()},
            {k: v.grad for k, v in leaves.items()})


# ---------------------------------------------------------------------------
# Loss, aux and gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("drops", [True, False], ids=["drops", "no_drops"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax_grad(ref, arch, drops, monkeypatch):
    ref_cfg, cfg = configs(ref, arch)
    assert cfg.remat and transformer.block_specs(cfg) == [("attn", "moe")]
    factor = 1.25 if drops else cfg.num_experts / cfg.experts_per_tok
    dropped = set_capacity(monkeypatch, ref, cfg, factor)
    params = perturbed_params(ref, ref_cfg, seed=1)
    batch = batch_of(cfg)
    (want_loss, want_m), want_g = ref.jax.jit(ref.jax.value_and_grad(
        lambda p: ref.lm.loss_fn(p, batch, ref_cfg), has_aux=True))(params)
    kbuild.reset_launches()
    loss, m, grads = port_loss_and_grads(params, batch, cfg)
    assert sum(kbuild.LAUNCHES.values()) == 0      # plain versions on CPU
    # forward and remat's recompute, each of the two layers
    assert len(dropped) == 2 * cfg.num_layers
    assert (sum(dropped) > 0) == drops, dropped
    assert abs(float(loss) / float(want_loss) - 1) <= LOSS_RTOL
    assert abs(float(m["ce"]) / float(want_m["ce"]) - 1) <= LOSS_RTOL
    assert float(m["aux"]) > 0
    assert abs(float(m["aux"]) / float(want_m["aux"]) - 1) <= LOSS_RTOL
    want_g = flatten(ref.jax.tree.map(np.asarray, want_g))
    assert list(want_g) == list(grads)              # the reference's order
    for k, g in grads.items():
        ok, err = close(g.numpy(), want_g[k], GRAD_TOL)
        assert ok, (k, err, np.abs(want_g[k]).max())
    assert np.abs(want_g["stack/0/ffn/router"]).max() > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_gradients(ref, arch):
    """``torch.utils.checkpoint`` recomputes each block, routing included,
    in the backward pass: the same loss, aux and gradients, bit for bit,
    as keeping the activations."""
    ref_cfg, cfg = configs(ref, arch)
    params = perturbed_params(ref, ref_cfg, seed=2)
    batch = batch_of(cfg, seed=2)
    loss, m, grads = port_loss_and_grads(params, batch, cfg)
    loss_n, m_n, grads_n = port_loss_and_grads(params, batch,
                                               cfg.replace(remat=False))
    assert float(loss) == float(loss_n) and float(m["aux"]) == float(
        m_n["aux"])
    for k, g in grads.items():
        assert torch.equal(g, grads_n[k]), k


def test_stack_aux_is_the_layers_sum():
    """``stack_forward``'s aux is the MoE layers' aux added in layer order
    (each layer's own, from its own input); the dense block adds a float32
    zero."""
    cfg = reduce_for_smoke(get_config("deepseek-moe-16b")).replace(
        dtype="float32", num_layers=3)
    params = lm.init_params(cfg, seed=3, device="cpu")
    toks = torch.as_tensor(batch_of(cfg, seed=3)["tokens"])
    seen = []
    real = moe.apply_moe

    def spy(p, x, cfg_):
        y, aux = real(p, x, cfg_)
        seen.append(aux)
        return y, aux

    transformer_apply = transformer.apply_moe
    transformer.apply_moe = spy
    try:
        _, aux = lm.forward(params, toks, cfg.replace(remat=False))
    finally:
        transformer.apply_moe = transformer_apply
    assert len(seen) == 3 and aux.dtype == torch.float32
    want = torch.zeros((), dtype=torch.float32)
    for a in seen:
        want = want + a
    assert float(aux) == float(want) > 0
    dense = cfg.replace(num_experts=0, experts_per_tok=0, moe_d_ff=0,
                        num_shared_experts=0)
    _, aux = lm.forward(lm.init_params(dense, seed=3, device="cpu"), toks,
                        dense)
    assert aux.dtype == torch.float32 and float(aux) == 0.0


def test_moe_gradients_match_jax_grad_with_drops(ref):
    """The grouped MoE alone (capacity drops, shared experts) under
    autograd: the gradients of a random projection of its output plus its
    aux, with respect to x and every leaf, are ``jax.grad``'s of the
    reference's one-hot dispatch; a dropped pair's read of slot 0 sends it
    nothing (the gradient with every dropped pair's weight forced to 0
    first is bitwise the same)."""
    ref_cfg, cfg = configs(ref, "deepseek-moe-16b")
    p = ref.jax.tree.map(np.asarray, ref.moe.init_moe(
        ref.jax.random.PRNGKey(4), ref_cfg, ref.jnp.float32))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 40, cfg.d_model)).astype(np.float32)
    proj = rng.standard_normal((3, 40, cfg.d_model)).astype(np.float32)

    def ref_obj(p, x):
        y, aux = ref.moe.apply_moe(p, x, ref_cfg)
        return (y * proj).sum() + aux

    want_gp, want_gx = ref.jax.jit(ref.jax.grad(ref_obj, argnums=(0, 1)))(
        p, x)
    tp = {k: torch.as_tensor(np.array(v)).requires_grad_(True)
          for k, v in flatten(p).items()}
    tx = torch.as_tensor(x).requires_grad_(True)
    _, _, idx = moe._route(tp, tx, cfg)
    cap = int(round(40 * cfg.experts_per_tok / cfg.num_experts * 1.25))
    assert int((moe._positions_in_expert(idx, cfg.num_experts) >= cap
                ).sum()) > 0
    y, aux = moe.apply_moe(
        {**{k: v for k, v in tp.items() if "/" not in k},
         "shared": {n: tp[f"shared/{n}"] for n in ("gate", "up", "down")}},
        tx, cfg)
    ((y * torch.as_tensor(proj)).sum() + aux).backward()
    want_gp = flatten(ref.jax.tree.map(np.asarray, want_gp))
    for k, v in tp.items():
        ok, err = close(v.grad.numpy(), want_gp[k], GRAD_TOL)
        assert ok, (k, err)
    ok, err = close(tx.grad.numpy(), np.asarray(want_gx), GRAD_TOL)
    assert ok, err


def test_dropped_pairs_send_slot_zero_nothing(monkeypatch):
    """``ye[where(keep, slot, 0)]``: each dropped pair reads row 0 of the
    expert batch's output with weight 0.  The gradient that reaches row 0
    is exactly its kept pair's weight times the token's output gradient,
    and a row no kept pair reads gets exactly zero."""
    cfg = reduce_for_smoke(get_config("dbrx-132b")).replace(dtype="float32")
    params = lm.init_params(cfg, seed=5, device="cpu")
    p = {k.split("/")[-1]: v[0].clone().requires_grad_(True)
         for k, v in params.items() if k.startswith("stack/0/ffn/")}
    gen = torch.Generator().manual_seed(5)
    G, T, E = 2, 48, cfg.num_experts
    x = torch.randn((G, T, cfg.d_model), generator=gen)
    cap = int(round(T * cfg.experts_per_tok / E * 1.25))
    _, w, idx = moe._route(p, x, cfg)
    pos = moe._positions_in_expert(idx, E)
    keep = pos < cap
    slot = (idx * G + torch.arange(G)[:, None, None]) * cap + pos
    assert int((~keep).sum()) > 0 and bool((keep & (slot == 0)).any())
    outs = []
    real_bmm = torch.bmm
    monkeypatch.setattr(torch, "bmm",
                        lambda a, b: outs.append(real_bmm(a, b)) or outs[-1])
    y, _ = moe._moe_groups(p, x.requires_grad_(True), cfg, cap)
    monkeypatch.undo()
    ye = outs[2]                    # gate, up, then the down product
    ye.retain_grad()
    gy = torch.randn(y.shape, generator=gen)
    y.backward(gy)
    rows = ye.grad.reshape(-1, cfg.d_model)
    comb = (w * keep).float()
    g, t, j = [int(i) for i in torch.nonzero(keep & (slot == 0))[0]]
    assert torch.equal(rows[0], comb[g, t, j] * gy[g, t])
    read = torch.zeros(rows.shape[0], dtype=torch.bool)
    read[slot[keep]] = True
    assert not bool(rows[~read].any())


# ---------------------------------------------------------------------------
# The train step against the reference's
# ---------------------------------------------------------------------------
def test_train_step_mode3_topk_matches_reference(ref):
    arch, n_pods = "deepseek-moe-16b", 2
    ref_cfg, cfg = configs(ref, arch)
    kw = dict(mode=AsyncMode.BEST_EFFORT, compressor="topk")
    ref_spec = ref.train.TrainSpec(adamw=ref.AdamW(**ADAMW), **kw)
    spec = train.TrainSpec(adamw=AdamWConfig(**ADAMW), **kw)
    state_ref = ref.train.init_train_state(ref.jax.random.PRNGKey(3),
                                           ref_cfg, ref_spec, n_pods)
    state = interop.train_state_from_numpy(
        ref.jax.tree.map(np.asarray, state_ref), "cpu")
    b = {n: v.reshape(n_pods, 2, S)
         for n, v in SyntheticLM(DataConfig(cfg.vocab_size, S, 4, seed=2)
                                 ).batch_for_step(0).items()}
    state_ref, want = ref.jax.jit(ref.train.make_train_step(
        ref_cfg, ref_spec, n_pods))(state_ref, b)
    state, got = train.make_train_step(cfg, spec, n_pods)(
        state, {k: torch.as_tensor(v) for k, v in b.items()})
    assert abs(float(got["loss"]) / float(want["loss"]) - 1) <= LOSS_RTOL
    assert float(got["aux"]) > 0
    assert abs(float(got["aux"]) / float(want["aux"]) - 1) <= LOSS_RTOL
    assert abs(float(got["grad_norm"]) / float(want["grad_norm"]) - 1
               ) <= NORM_RTOL
    want_s = flatten(ref.jax.tree.map(np.asarray, state_ref))
    lr = float(want["lr"])
    for k, v in flatten(state).items():
        if k.startswith("params/"):
            err = np.abs(v.numpy().astype(np.float64) - want_s[k]).max()
            assert err <= MOVE_TOL * lr, (k, err, lr)


# ---------------------------------------------------------------------------
# Parameter counts and the CLI
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_full_size_param_count_matches_reference(ref, arch):
    """Counted from shapes on both sides (an ``LM`` built under
    ``FakeTensorMode``, ``jax.eval_shape``): nothing is allocated."""
    with FakeTensorMode():
        model = lm.LM(get_config(arch), device="cpu")
        n = sum(p.numel() for p in model.parameters())
    assert n == ref.lm.param_count(ref.get_config(arch))
    assert get_config(arch) == ref_fields(ref, arch)


def ref_fields(ref, arch):
    """The reference's config, field for field, as the port's type: the
    copy changed only its imports."""
    import dataclasses
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(**dataclasses.asdict(ref.get_config(arch)))


def test_train_main_trains_moe_on_cpu(capsys):
    state, history = train.main(
        ["--device", "cpu", "--arch", "deepseek-moe-16b-smoke", "--steps",
         "8", "--batch", "4", "--seq", "32", "--lr", "1e-2",
         "--log-every", "1"])
    assert len(history) == 8
    assert history[-1]["loss"] < history[0]["loss"]
    assert all(0 < h["aux"] < 1 for h in history)
    assert "aux=" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# On the card: the MoE training forward and backward against the CPU
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_card_matches_cpu(arch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA attention kernels have no "
                    "CPU mode)")
    cfg = reduce_for_smoke(get_config(arch)).replace(dtype="float32")
    params = lm.init_params(cfg, seed=6, device="cpu")
    batch = {k: torch.as_tensor(v)
             for k, v in batch_of(cfg, seed=6).items()}
    want, wm = train.pod_grads(params, batch, cfg)
    kbuild.reset_launches()
    got, gm = train.pod_grads({k: v.cuda() for k, v in params.items()},
                              {k: v.cuda() for k, v in batch.items()}, cfg)
    torch.cuda.synchronize()
    # forward, and its recompute under remat, per layer
    assert kbuild.LAUNCHES["flash_attention"] == 2 * cfg.num_layers
    assert abs(float(gm["ce"]) / float(wm["ce"]) - 1) <= LOSS_RTOL
    assert abs(float(gm["aux"]) / float(wm["aux"]) - 1) <= LOSS_RTOL
    for k, g in want.items():
        ok, err = close(got[k].cpu().numpy(), g.numpy(), GRAD_TOL)
        assert ok, (k, err)
