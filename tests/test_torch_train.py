"""repro_torch's dense training path against the reference's.

- ``lm.loss_fn`` and its gradients (autograd through the port's
  differentiable forward, with ``flash_attention``'s backward) against
  ``jax.grad(repro.models.lm.loss_fn)`` on the reduced qwen2-1.5b (QKV
  bias) and qwen3-0.6b (qk_norm), float32, from the same carried-across
  weights (perturbed, so norm scales and biases are not zero): the loss
  within 1e-5 relative, each gradient leaf within 1e-4 of its largest
  magnitude (float32 sums in other orders through two layers and a
  503-way softmax).
- ``make_train_step``, 3 steps from the same state (``interop``) on the
  same ``SyntheticLM`` batches, against the reference's jitted step: every
  mode at n_pods = 2 (modes 1/2 with an outer sync on step 2), mode 3 with
  each compressor, and mode 3 int8 on qwen3-0.6b too.  Loss within 1e-5
  relative and grad norm within 1e-4 at every step.  Every parameter
  within 5% of the sum of the steps' learning rates (the most AdamW moves
  an entry): AdamW divides each entry's update by its own gradient's
  size, so where a gradient is at the float32 noise level (the key
  bias's, which nearly cancels over positions because RoPE at theta 1e6
  barely turns most of its dims) the last bits of the gradient decide
  the update; measured, the worst entry is 2.4% of that sum, the typical
  one 1e-4 of it.  Without a compressor the moments and ``others`` within
  1e-4 of each leaf's largest magnitude; with one they follow the
  decoded sums, where a gradient that differs in its last bits can flip
  a quantization level or a top-k choice, so they are held bitwise only
  on given gradients (``test_torch_optim.py``).
- Checkpoints cross between the packages both ways and training
  continues as the other package continues.
- The CLI trains a smoke config on the CPU, the loss falls, and a run
  restarted from its checkpoint ends where an uninterrupted run ends.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cases  # noqa: E402,F401  (caps torch's CPU threads)

from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.smoke import reduce_for_smoke  # noqa: E402
from repro_torch.core.modes import AsyncMode  # noqa: E402
from repro_torch.data.synthetic import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.optim.outer import OuterConfig  # noqa: E402
from repro_torch.pytree import flatten  # noqa: E402

LOSS_RTOL, NORM_RTOL, STATE_TOL, GRAD_TOL, MOVE_TOL = (1e-5, 1e-4, 1e-4,
                                                       1e-4, 0.05)
N_PODS, B, S = 2, 4, 32
ADAMW = dict(lr=1e-3, warmup_steps=2, total_steps=20)


@pytest.fixture(scope="module")
def ref():
    """The reference (JAX), with a cache of its jitted train steps; the
    card machine has no JAX."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro import checkpoint as ref_ckpt
    from repro.configs import get_config as ref_get_config
    from repro.configs.smoke import reduce_for_smoke as ref_reduce
    from repro.launch import train as ref_train
    from repro.models import lm as ref_lm
    from repro.optim.adamw import AdamWConfig as RefAdamW
    from repro.optim.outer import OuterConfig as RefOuter
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, ckpt=ref_ckpt, get_config=ref_get_config,
        reduce=ref_reduce, train=ref_train, lm=ref_lm, AdamW=RefAdamW,
        Outer=RefOuter, steps={})


def configs(ref, arch):
    return (ref.reduce(ref.get_config(arch)).replace(dtype="float32"),
            reduce_for_smoke(get_config(arch)).replace(dtype="float32"))


def close(got, want, tol):
    """|got - want| <= tol x max|want| over the array."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() if want.size else 0.0
    return err <= tol * max(np.abs(want).max(), 1e-30), err


# ---------------------------------------------------------------------------
# Loss and gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen3-0.6b"])
def test_loss_and_gradients_match_jax_grad(ref, arch):
    ref_cfg, cfg = configs(ref, arch)
    params = ref.jax.tree.map(np.asarray, ref.lm.init_params(
        ref.jax.random.PRNGKey(1), ref_cfg))
    rng = np.random.default_rng(1)
    params = ref.jax.tree.map(
        lambda a: (a + rng.standard_normal(a.shape) * 0.05).astype(a.dtype),
        params)
    batch = SyntheticLM(DataConfig(cfg.vocab_size, 64, 3, seed=1)
                        ).batch_for_step(0)
    (want_loss, want_m), want_g = ref.jax.jit(ref.jax.value_and_grad(
        lambda p: ref.lm.loss_fn(p, batch, ref_cfg), has_aux=True))(params)
    leaves = {k: torch.as_tensor(np.array(v)).requires_grad_(True)
              for k, v in flatten(params).items()}
    kbuild.reset_launches()
    loss, m = lm.loss_fn(leaves, {k: torch.as_tensor(v)
                                  for k, v in batch.items()}, cfg)
    loss.backward()
    assert sum(kbuild.LAUNCHES.values()) == 0      # plain versions on CPU
    assert abs(float(loss.detach()) / float(want_loss) - 1) <= LOSS_RTOL
    assert abs(float(m["ce"]) / float(want_m["ce"]) - 1) <= LOSS_RTOL
    assert float(m["aux"]) == float(want_m["aux"]) == 0.0
    want_g = flatten(ref.jax.tree.map(np.asarray, want_g))
    assert list(want_g) == list(leaves)              # the reference's order
    for k, v in leaves.items():
        ok, err = close(v.grad.numpy(), want_g[k], GRAD_TOL)
        assert ok, (k, err, np.abs(want_g[k]).max())


def test_grad_accum_matches_the_whole_batch():
    """Two microbatches of equal size, averaged as the reference's scan
    averages them, give the whole batch's loss and gradients (every label
    counts, so each microbatch's mean has the same weight)."""
    cfg = reduce_for_smoke(get_config("qwen2-1.5b")).replace(dtype="float32")
    params = lm.init_params(cfg, seed=5, device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in SyntheticLM(
        DataConfig(cfg.vocab_size, 32, 4, seed=5)).batch_for_step(0).items()}
    whole, m1 = train.pod_grads(params, batch, cfg)
    micro, m2 = train.pod_grads(params, batch, cfg.replace(grad_accum=2))
    assert abs(float(m2["ce"]) / float(m1["ce"]) - 1) <= LOSS_RTOL
    for k, g in whole.items():
        ok, err = close(micro[k].numpy(), g.numpy(), GRAD_TOL)
        assert ok, (k, err)


def test_cast_leaves_follows_the_reference_rule(ref):
    """bf16 compute: every stacked leaf and the table are cast, only
    final_norm stays float32, as the reference's cast does."""
    ref_cfg, cfg = configs(ref, "qwen2-1.5b")
    ref_cfg, cfg = ref_cfg.replace(dtype="bfloat16"), cfg.replace(
        dtype="bfloat16")
    params = ref.lm.init_params(ref.jax.random.PRNGKey(0), ref_cfg)
    want = flatten(ref.jax.tree.map(
        lambda a: str(a.dtype), ref.lm.cast_params_for_compute(params,
                                                               ref_cfg)))
    got = lm.cast_leaves({k: torch.as_tensor(np.array(v)) for k, v in
                          flatten(ref.jax.tree.map(np.asarray,
                                                   params)).items()}, cfg)
    assert {k: str(v.dtype).removeprefix("torch.")
            for k, v in got.items()} == want
    assert want["final_norm"] == "float32"
    assert want["stack/0/mixer_norm"] == "bfloat16"


# ---------------------------------------------------------------------------
# The train step, 3 steps against the reference's
# ---------------------------------------------------------------------------
def specs(ref, mode, compressor):
    kw = dict(mode=AsyncMode(mode), compressor=compressor)
    return (ref.train.TrainSpec(adamw=ref.AdamW(**ADAMW),
                                outer=ref.Outer(sync_period=2), **kw),
            train.TrainSpec(adamw=AdamWConfig(**ADAMW),
                            outer=OuterConfig(sync_period=2), **kw))


def ref_step(ref, arch, mode, compressor):
    key = (arch, mode, compressor)
    if key not in ref.steps:
        ref_cfg, _ = configs(ref, arch)
        spec, _ = specs(ref, mode, compressor)
        ref.steps[key] = ref.jax.jit(ref.train.make_train_step(
            ref_cfg, spec, N_PODS))
    return ref.steps[key]


def batches(cfg, steps, start=0):
    src = SyntheticLM(DataConfig(cfg.vocab_size, S, B, seed=2))
    out = []
    for k in range(start, start + steps):
        b = src.batch_for_step(k)
        out.append({n: v.reshape(N_PODS, B // N_PODS, S)
                    for n, v in b.items()})
    return out


def check_states(got, want, lr_sum, compressed):
    """Params (and the outer anchor and momentum, which follow them)
    within MOVE_TOL x ``lr_sum`` per entry; without a compressor the
    moments and ``others`` within STATE_TOL of each leaf's largest
    magnitude.  With one they follow the decoded sums, where one
    quantization flip moves an entry by a whole step (1/127 of its row's
    largest magnitude) and one top-k swap moves two entries by their
    values; ``test_torch_optim.py`` holds that exchange bitwise."""
    want = flatten(ref_np(want))
    got = flatten(got)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        if k.startswith(("params/", "outer/")):
            err = np.abs(v.numpy().astype(np.float64) - want[k]).max()
            assert err <= MOVE_TOL * lr_sum, (k, err, lr_sum)
        elif not compressed or k in ("step", "opt/step"):
            ok, err = close(v.numpy(), want[k], STATE_TOL)
            assert ok, (k, err, np.abs(want[k]).max())


def ref_np(state):
    import jax
    return jax.tree.map(np.asarray, state)


def run_both(ref, arch, mode, compressor, state_ref, state, steps,
             start=0):
    """``steps`` steps of both packages from their states; returns the
    states, after checking the metrics of every step."""
    _, cfg = configs(ref, arch)
    _, spec = specs(ref, mode, compressor)
    want_step = ref_step(ref, arch, mode, compressor)
    step = train.make_train_step(cfg, spec, N_PODS)
    lr_sum = 0.0
    for b in batches(cfg, steps, start):
        state_ref, want = want_step(state_ref, b)
        lr_sum += float(want["lr"])
        state, got = step(state, {k: torch.as_tensor(v)
                                  for k, v in b.items()})
        assert abs(float(got["loss"]) / float(want["loss"]) - 1) <= LOSS_RTOL
        assert abs(float(got["grad_norm"]) / float(want["grad_norm"])
                   - 1) <= NORM_RTOL
        assert float(got["lr"]) == pytest.approx(float(want["lr"]),
                                                 rel=1e-6)
    return state_ref, state, lr_sum


def init_both(ref, arch, mode, compressor):
    ref_cfg, _ = configs(ref, arch)
    spec, _ = specs(ref, mode, compressor)
    state_ref = ref.train.init_train_state(ref.jax.random.PRNGKey(3),
                                           ref_cfg, spec, N_PODS)
    return state_ref, interop.train_state_from_numpy(ref_np(state_ref),
                                                     "cpu")


STEP_CASES = [("qwen2-1.5b", 0, None), ("qwen2-1.5b", 1, None),
              ("qwen2-1.5b", 2, None), ("qwen2-1.5b", 3, None),
              ("qwen2-1.5b", 3, "int8"), ("qwen2-1.5b", 3, "topk"),
              ("qwen2-1.5b", 4, None), ("qwen3-0.6b", 3, "int8")]


@pytest.mark.parametrize("arch,mode,compressor", STEP_CASES)
def test_train_step_matches_reference(ref, arch, mode, compressor):
    state_ref, state = init_both(ref, arch, mode, compressor)
    state_ref, state, lr_sum = run_both(ref, arch, mode, compressor,
                                        state_ref, state, 3)
    assert int(state["step"]) == 3
    check_states(state, state_ref, lr_sum, compressor is not None)
    if mode == 0:   # the barrier keeps the pods' params identical
        for v in state["params"].values():
            assert torch.equal(v[0], v[1])


def test_state_layout_is_the_references(ref):
    """Leaf paths, shapes and dtypes of a fresh state are the reference's,
    pod dim included."""
    ref_cfg, cfg = configs(ref, "qwen2-1.5b")
    for mode, comp in ((3, "topk"), (1, None)):
        spec_ref, spec = specs(ref, mode, comp)
        want = ref.jax.eval_shape(lambda k: ref.train.init_train_state(
            k, ref_cfg, spec_ref, N_PODS), ref.jax.random.PRNGKey(0))
        want = {k: (tuple(v.shape), str(v.dtype))
                for k, v in flatten(want).items()}
        state = train.init_train_state(cfg, spec, N_PODS, device="cpu")
        got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
               for k, v in flatten(state).items()}
        assert got == want
        back = interop.train_state_to_numpy(state)    # the reference's tree
        assert ref.jax.tree.structure(back) == ref.jax.tree.structure(
            ref.jax.eval_shape(lambda k: ref.train.init_train_state(
                k, ref_cfg, spec_ref, N_PODS), ref.jax.random.PRNGKey(0)))


# ---------------------------------------------------------------------------
# Checkpoints across the packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_checkpoint_crosses_packages(ref, tmp_path, direction):
    """2 steps in one package, a checkpoint, then the other package
    restores it and both continue for 1 step (mode 3, top-k: the state
    holds others and residuals)."""
    arch, mode, comp = "qwen2-1.5b", 3, "topk"
    state_ref, state = init_both(ref, arch, mode, comp)
    state_ref, state, _ = run_both(ref, arch, mode, comp, state_ref, state,
                                   2)
    d = str(tmp_path)
    if direction == "jax_to_torch":
        ref.ckpt.save(d, state_ref, 2)
        like = interop.train_state_from_numpy(ref_np(state_ref), "cpu")
        assert ckpt.latest_step(d) == 2
        restored = ckpt.restore(d, 2, like)
        for k, v in flatten(restored).items():
            assert np.array_equal(v.numpy(), flatten(ref_np(state_ref))[k])
        state = restored
    else:
        ckpt.save(d, state, 2)
        state_ref = ref.ckpt.restore(d, 2, ref.jax.eval_shape(
            lambda: state_ref))
        for k, v in flatten(ref_np(state_ref)).items():
            assert np.array_equal(v, flatten(state)[k].numpy())
    state_ref, state, lr_sum = run_both(ref, arch, mode, comp, state_ref,
                                        state, 1, start=2)
    check_states(state, state_ref, lr_sum, True)


def test_checkpoint_bf16_roundtrip_and_prune(tmp_path):
    state = {"a": {"x/y": torch.arange(6, dtype=torch.float32).reshape(2, 3)
                   .to(torch.bfloat16)},
             "step": torch.tensor(7, dtype=torch.int32)}
    for s in (1, 2, 3):
        ckpt.save(str(tmp_path), state, s)
    ckpt.save(str(tmp_path), state, 4, blocking=False).join(timeout=60)
    ckpt.prune(str(tmp_path), keep=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000003", "step_00000004"]
    back = ckpt.restore(str(tmp_path), 4, state)
    assert back["a"]["x/y"].dtype == torch.bfloat16
    assert torch.equal(back["a"]["x/y"], state["a"]["x/y"])
    assert int(back["step"]) == 7


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------
ARGS = ["--device", "cpu", "--arch", "qwen2-1.5b-smoke", "--batch", "8",
        "--seq", "64", "--log-every", "10"]


def test_cli_trains_on_cpu_and_restarts(tmp_path, capsys):
    """30 steps through the CLI: the loss falls.  Then ``run_training``
    with the same flags' spec, checkpointing every 10 steps: stopped at
    step 20 and restarted, it ends where the uninterrupted run ended."""
    kbuild.reset_launches()
    state, history = train.main(ARGS + ["--steps", "30"])
    assert sum(kbuild.LAUNCHES.values()) == 0
    losses = [h["loss"] for h in history]
    assert [h["step"] for h in history] == [10, 20, 30]
    assert losses[-1] < losses[0] - 0.5, losses
    out = capsys.readouterr().out
    assert "qwen2-1.5b-smoke" in out and "improved" in out
    cfg = train.resolve_config("qwen2-1.5b-smoke")
    spec = train.TrainSpec(adamw=AdamWConfig(lr=3e-3, warmup_steps=20,
                                             total_steps=30))
    data = DataConfig(cfg.vocab_size, 64, 8)
    kw = dict(ckpt_dir=str(tmp_path), ckpt_every=10, device="cpu")
    train.run_training(cfg, spec, data, steps=20, **kw)
    assert ckpt.latest_step(str(tmp_path)) == 20
    logs = []
    again, hist2 = train.run_training(cfg, spec, data, steps=30,
                                      log=logs.append, **kw)
    assert logs[0] == "[train] restored checkpoint at step 20"
    assert hist2[-1]["loss"] == history[-1]["loss"]
    for k, v in flatten(again).items():
        assert torch.equal(v, flatten(state)[k]), k


def test_cli_modes_and_compressors_on_cpu():
    for extra in (["--mode", "3", "--n-pods", "2", "--compressor", "int8"],
                  ["--mode", "1", "--n-pods", "2", "--arch",
                   "qwen3-0.6b-smoke"]):
        _, history = train.main(ARGS + ["--steps", "2"] + extra)
        assert np.isfinite(history[-1]["loss"])
    with pytest.raises(ValueError, match="n-pods"):
        train.main(ARGS + ["--n-pods", "3"])


def test_train_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        train.main(["--steps", "1"])
