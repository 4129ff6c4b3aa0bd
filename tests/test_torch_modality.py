"""repro_torch's modality frontends and data pipeline against the
reference's.

- ``splice_frontend`` equals the reference's bitwise, in float32 and
  bf16, and aliases neither input.
- The reduced musicgen-large (audio, MHA) and llava-next-mistral-7b
  (vision, GQA) with their stub frontend input spliced, float32, from the
  same carried-across weights: the training forward's logits within 1e-4,
  ``loss_fn``'s ce within 1e-5 relative, and every gradient leaf, the
  frontend input's too, within 1e-4 of its largest magnitude of
  ``jax.grad``'s (the dense model's tolerances, ``test_torch_train.py``);
  prefill's logits and caches within 1e-4 of the reference's.
- Prefill of a frontend prompt plus k tokens gives decode step k's logits
  (float32, 1e-4).
- The port's ``Pipeline`` yields the reference's batches bitwise, the
  frontend input included, and ``close()`` ends its thread;
  ``run_training`` trains on them.
- ``serve.main`` serves both archs on the CPU with the frontend prefix.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_cases import close, perturbed_params  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.smoke import reduce_for_smoke  # noqa: E402
from repro_torch.data.pipeline import Pipeline  # noqa: E402
from repro_torch.data.synthetic import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import lm, modality  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.pytree import flatten  # noqa: E402

ARCHS = ["musicgen-large", "llava-next-mistral-7b"]
LOGIT_TOL, LOSS_RTOL, GRAD_TOL = 1e-4, 1e-5, 1e-4
B, S, P, T = 2, 24, 16, 4


@pytest.fixture(scope="module")
def ref():
    """The reference (JAX); the card machine has no JAX."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as ref_get_config
    from repro.configs.smoke import reduce_for_smoke as ref_reduce
    from repro.data import pipeline as ref_pipeline
    from repro.models import lm as ref_lm
    from repro.models import modality as ref_modality
    return types.SimpleNamespace(jax=jax, jnp=jnp, get_config=ref_get_config,
                                 reduce=ref_reduce, lm=ref_lm,
                                 modality=ref_modality,
                                 pipeline=ref_pipeline)


def configs(ref, arch):
    return (ref.reduce(ref.get_config(arch)).replace(dtype="float32"),
            reduce_for_smoke(get_config(arch)).replace(dtype="float32"))


def batch_of(cfg, seq, seed):
    """A batch with its frontend input, as the training data makes it."""
    src = SyntheticLM(DataConfig(cfg.vocab_size, seq, B, seed=seed))
    batch = src.batch_for_step(0)
    batch[modality.frontend_input_name(cfg)] = src.frontend_for_step(
        0, cfg.frontend_len, cfg.d_model)
    return batch


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# The splice
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_splice_frontend_matches_reference_bitwise(ref, dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 12, 16)).astype(np.float32)
    fe = rng.standard_normal((2, 5, 16)).astype(np.float32)
    want = ref.modality.splice_frontend(
        ref.jnp.asarray(x).astype(dtype), ref.jnp.asarray(fe))
    tx = torch.as_tensor(x).to(getattr(torch, dtype))
    tf = torch.as_tensor(fe)
    got = modality.splice_frontend(tx, tf)
    assert got.dtype == tx.dtype and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy() if dtype == "bfloat16"
        else got.numpy(),
        np.asarray(want).view(np.int16) if dtype == "bfloat16"
        else np.asarray(want))
    assert got.data_ptr() not in (tx.data_ptr(), tf.data_ptr())
    got[:] = 0                              # out of place: inputs intact
    assert bool(tx.any()) and bool(tf.any())


def test_frontend_names_and_shapes():
    for arch, name in zip(ARCHS, ["frame_embeds", "patch_embeds"]):
        cfg = get_config(arch)
        assert modality.frontend_input_name(cfg) == name
        assert modality.frontend_shape(cfg, 3) == (3, cfg.frontend_len,
                                                   cfg.d_model)


# ---------------------------------------------------------------------------
# Training forward, loss and gradients; prefill
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_gradients_match_jax_grad(ref, arch):
    ref_cfg, cfg = configs(ref, arch)
    name = modality.frontend_input_name(cfg)
    params = perturbed_params(ref, ref_cfg, seed=1)
    batch = batch_of(cfg, S, seed=1)
    want_logits, want_aux = ref.jax.jit(
        lambda p, t, f: ref.lm.forward(p, t, ref_cfg, f))(
        params, batch["tokens"], batch[name])

    def ref_loss(p, fe):
        return ref.lm.loss_fn(p, {**batch, name: fe}, ref_cfg)
    (want_loss, want_m), (want_g, want_gf) = ref.jax.jit(
        ref.jax.value_and_grad(ref_loss, argnums=(0, 1), has_aux=True))(
        params, batch[name])
    leaves = {k: torch.as_tensor(np.array(v)).requires_grad_(True)
              for k, v in flatten(params).items()}
    fe = torch.as_tensor(batch[name]).requires_grad_(True)
    tb = {k: torch.as_tensor(v) for k, v in batch.items() if k != name}
    logits, aux = lm.forward(leaves, tb["tokens"], cfg, fe)
    ok, err = close(f32(logits.detach()), f32(want_logits), LOGIT_TOL)
    assert ok, err
    assert float(aux) == float(want_aux) == 0.0
    kbuild.reset_launches()
    loss, m = lm.loss_fn(leaves, {**tb, name: fe}, cfg)
    loss.backward()
    assert sum(kbuild.LAUNCHES.values()) == 0      # plain versions on CPU
    ce = float(m["ce"].detach())
    assert abs(ce / float(want_m["ce"]) - 1) <= LOSS_RTOL
    want_g = flatten(ref.jax.tree.map(np.asarray, want_g))
    assert list(want_g) == list(leaves)
    for k, v in leaves.items():
        ok, err = close(v.grad.numpy(), want_g[k], GRAD_TOL)
        assert ok, (k, err)
    ok, err = close(fe.grad.numpy(), np.asarray(want_gf), GRAD_TOL)
    assert ok, err
    assert np.abs(np.asarray(want_gf)).max() > 0
    # without its frontend input the model reads the prefix's tokens
    plain, _ = lm.forward(leaves, tb["tokens"], cfg)
    assert not torch.allclose(plain[:, cfg.frontend_len:],
                              logits[:, cfg.frontend_len:])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(ref, arch):
    ref_cfg, cfg = configs(ref, arch)
    name = modality.frontend_input_name(cfg)
    params = perturbed_params(ref, ref_cfg, seed=2)
    model = interop.params_from_numpy(params, cfg, "cpu")
    batch = batch_of(cfg, P, seed=2)
    want, ref_caches = ref.lm.prefill_step(
        params, ref.jnp.asarray(batch["tokens"]), ref_cfg,
        ref.jnp.asarray(batch[name]))
    got, caches = lm.prefill_step(model, torch.as_tensor(batch["tokens"]),
                                  frontend_embeds=torch.as_tensor(
                                      batch[name]))
    np.testing.assert_allclose(f32(got), f32(want), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    for ref_c, c in zip(ref_caches, interop.caches_to_numpy(caches, cfg)):
        for n in ("k", "v"):
            np.testing.assert_allclose(c[n], f32(ref_c[n]), rtol=LOGIT_TOL,
                                       atol=LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_of_prompt_and_k_tokens_gives_decode_step_k(arch):
    """No MoE, so prefill and decode are one function: the logits of a
    prefill of the frontend prompt plus k generated tokens are decode step
    k's (float32)."""
    cfg = reduce_for_smoke(get_config(arch)).replace(dtype="float32")
    model = lm.LM(cfg, seed=3, device="cpu")
    fe = serve.frontend_prefix(cfg, B, 3, "cpu")
    prompts = torch.as_tensor(batch_of(cfg, P, seed=3)["tokens"])
    res = serve.serve(model, prompts, T, fe)
    for k in range(1, T):
        full = torch.cat([prompts, res.seqs[:, :k]], dim=1)
        logits, _ = lm.prefill_step(model, full, frontend_embeds=fe)
        np.testing.assert_allclose(f32(logits[:, -1]), f32(res.logits[k]),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
    # the prefix is spliced: another prefix gives other logits
    other, _ = lm.prefill_step(model, prompts, frontend_embeds=fe + 0.5)
    assert not torch.allclose(other[:, -1], res.logits[0])


# ---------------------------------------------------------------------------
# The data pipeline
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["musicgen-large", "qwen2-1.5b"])
def test_pipeline_yields_reference_batches_bitwise(ref, arch):
    ref_cfg, cfg = configs(ref, arch)
    data = DataConfig(cfg.vocab_size, 16, 4, seed=7)
    want = ref.pipeline.Pipeline(data, ref_cfg, start_step=3)
    got = Pipeline(data, cfg, start_step=3, device="cpu")
    for _ in range(3):
        (ws, wb), (gs, gb) = next(want), next(got)
        assert gs == ws
        assert sorted(gb) == sorted(wb)
        for k, v in gb.items():
            assert v.device.type == "cpu"
            assert v.numpy().dtype == wb[k].dtype
            np.testing.assert_array_equal(v.numpy(), wb[k])
    assert ("frame_embeds" in gb) == (cfg.frontend is not None)
    want.close()
    got.close()
    assert not got._thread.is_alive()


def test_pipeline_raises_what_its_thread_raised():
    """A batch the producer thread fails to make is not waited for forever:
    ``next`` raises the thread's exception; ``close()`` still ends it."""
    cfg = reduce_for_smoke(get_config("qwen2-1.5b"))
    pipe = Pipeline(DataConfig(cfg.vocab_size, 8, 2, seed=0),
                    cfg.replace(frontend="smell", frontend_len=2),
                    device="cpu")
    with pytest.raises(KeyError, match="smell"):
        next(pipe)
    pipe.close()
    assert not pipe._thread.is_alive()


def test_run_training_trains_on_pipeline_batches():
    """``run_training`` takes each step's batch from the ``Pipeline``
    (frontend input included) and stops its thread when it returns; the
    loss falls."""
    cfg = reduce_for_smoke(get_config("musicgen-large"))
    spec = train.TrainSpec(adamw=AdamWConfig(
        lr=1e-2, warmup_steps=2, total_steps=8))
    made = []
    real = Pipeline.make_batch

    def spy(self, step):
        batch = real(self, step)
        made.append((step, sorted(batch)))
        return batch
    Pipeline.make_batch = spy
    try:
        _, history = train.run_training(
            cfg, spec, DataConfig(cfg.vocab_size, 32, 4, seed=1), steps=8,
            log_every=1, log=lambda *_: None, device="cpu")
    finally:
        Pipeline.make_batch = real
    assert [s for s, _ in made[:8]] == list(range(8))
    assert made[0][1] == ["frame_embeds", "labels", "tokens"]
    assert history[-1]["loss"] < history[0]["loss"]


# ---------------------------------------------------------------------------
# The server
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_runs_on_cpu_with_the_frontend_prefix(arch, capsys):
    model, prompts, frontend, res = serve.main(
        ["--device", "cpu", "--arch", f"{arch}-smoke", "--batch", "2",
         "--prompt-len", "12", "--tokens", "4", "--dtype", "float32"])
    cfg = model.cfg
    assert tuple(res.seqs.shape) == (2, 4)
    assert tuple(frontend.shape) == (2, cfg.frontend_len, cfg.d_model)
    want = SyntheticLM(DataConfig(cfg.vocab_size, cfg.frontend_len, 2,
                                  seed=0)).frontend_for_step(
        0, cfg.frontend_len, cfg.d_model)
    np.testing.assert_array_equal(frontend.numpy(), want)
    assert f"{cfg.frontend} frontend prefix" in capsys.readouterr().out
    again = serve.serve(model, prompts, 4, frontend)
    assert torch.equal(again.seqs, res.seqs)
    with pytest.raises(ValueError, match="frontend prefix"):
        serve.main(["--device", "cpu", "--arch", f"{arch}-smoke",
                    "--prompt-len", str(cfg.frontend_len - 1)])


# ---------------------------------------------------------------------------
# On the card: the frontend path through the kernels against the CPU
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_card_matches_cpu(arch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA attention kernels have no "
                    "CPU mode)")
    cfg = reduce_for_smoke(get_config(arch)).replace(dtype="float32")
    cpu = lm.LM(cfg, seed=0, device="cpu")
    card = lm.LM(cfg, seed=0, device="cpu").to("cuda")
    fe = serve.frontend_prefix(cfg, B, 0, "cpu")
    prompts = torch.as_tensor(batch_of(cfg, P, seed=0)["tokens"])
    want = serve.serve(cpu, prompts, T, fe)
    kbuild.reset_launches()
    got = serve.serve(card, prompts.cuda(), T, fe.cuda())
    assert kbuild.LAUNCHES["flash_attention"] == cfg.num_layers
    assert kbuild.LAUNCHES["decode_attention"] == cfg.num_layers * (T - 1)
    assert torch.equal(got.seqs.cpu(), want.seqs)
    for g, w in zip(got.logits, want.logits):
        np.testing.assert_allclose(f32(g.cpu()), f32(w), rtol=1e-4,
                                   atol=1e-4)
