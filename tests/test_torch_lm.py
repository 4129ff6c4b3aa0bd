"""repro_torch's dense LM serving path against the reference's.

The reference's ``lm.init_params`` weights, carried across with
``interop.params_from_numpy``, go through the port's ``prefill_step`` and
``decode_step`` and the reference's, on the reduced (``reduce_for_smoke``)
qwen2-1.5b (QKV bias, GQA) and qwen3-0.6b (qk_norm) configs, with the same
numpy-made tokens.  Decode is teacher-forced for 4 steps.  In float32 the
logits and caches agree within 1e-4 and the greedy tokens are equal.  In
bfloat16 the reference model rounds the scores and the probabilities to
bf16 where the port's attention (the kernels' semantics) keeps them in
float32 (ROADMAP Queue 3, known differences), so logits agree within 3e-2
(about 5% of the largest logit, a few bf16 ulps through two layers) and
the caches within 6.25e-2 (two bf16 ulps at |x| < 8).  On the CPU the
port's attention takes the plain torch versions of the kernels.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cases  # noqa: E402,F401  (caps torch's CPU threads)

from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.smoke import reduce_for_smoke  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm, transformer  # noqa: E402

ARCHS = ["qwen2-1.5b", "qwen3-0.6b"]
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
CACHE_TOL = {"float32": 1e-4, "bfloat16": 6.25e-2}
B, P, T = 2, 16, 4


@pytest.fixture
def ref():
    """The reference (JAX); the card machine has no JAX, so only the
    comparisons with the reference need it."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as ref_get_config
    from repro.configs.smoke import reduce_for_smoke
    from repro.models import lm as ref_lm
    return types.SimpleNamespace(jax=jax, jnp=jnp, get_config=ref_get_config,
                                 reduce=reduce_for_smoke, lm=ref_lm)


def configs(ref, arch, dtype):
    return (ref.reduce(ref.get_config(arch)).replace(dtype=dtype),
            reduce_for_smoke(get_config(arch)).replace(dtype=dtype))


def carried(ref, arch, dtype, seed=0):
    """(reference cfg, reference params, port cfg, port LM cast for
    compute) from the same reference weights."""
    ref_cfg, cfg = configs(ref, arch, dtype)
    params = ref.lm.init_params(ref.jax.random.PRNGKey(seed), ref_cfg)
    model = interop.params_from_numpy(
        ref.jax.tree.map(np.asarray, params), cfg, "cpu")
    return ref_cfg, params, cfg, lm.cast_params_for_compute(model)


def tokens(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, P + T)).astype(np.int32)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def ref_grow(ref, caches, extra):
    return ref.jax.tree.map(
        lambda a: ref.jnp.pad(a, [(0, 0)] * 2 + [(0, extra)]
                              + [(0, 0)] * 2),
        caches)


def test_params_carry_across_every_weight(ref):
    ref_cfg, params, cfg, model = carried(ref, "qwen2-1.5b", "float32")
    n = sum(p.numel() for p in model.parameters())
    assert n == ref.lm.param_count(ref_cfg)
    stacked = params["stack"][0]["mixer"]["bq"]
    np.testing.assert_array_equal(
        model.stack.blocks[1].mixer.bq.numpy(), np.asarray(stacked[1]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, dtype, ref):
    ref_cfg, params, cfg, model = carried(ref, arch, dtype)
    toks = tokens(cfg)
    tol = LOGIT_TOL[dtype]
    want, ref_caches = ref.lm.prefill_step(
        params, ref.jnp.asarray(toks[:, :P]), ref_cfg)
    got, caches = lm.prefill_step(model, torch.as_tensor(toks[:, :P]),
                                  cache_len=P + T)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert caches[0]["k"].dtype == getattr(torch, dtype)
    np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol)
    for ref_c, c in zip(ref_caches, interop.caches_to_numpy(caches, cfg)):
        for name in ("k", "v"):
            assert c[name].shape[2] == P + T
            assert not c[name][:, :, P:].any()
            np.testing.assert_allclose(c[name][:, :, :P], f32(ref_c[name]),
                                       rtol=CACHE_TOL[dtype],
                                       atol=CACHE_TOL[dtype])
    ref_caches = ref_grow(ref, ref_caches, T)
    for i in range(T):
        tok = toks[:, P + i:P + i + 1]      # teacher forcing
        wnext, wlog, ref_caches = ref.lm.decode_step(
            params, ref.jnp.asarray(tok), ref_caches, ref_cfg, P + i)
        gnext, glog, caches = lm.decode_step(model, torch.as_tensor(tok),
                                             caches, P + i)
        np.testing.assert_allclose(f32(glog), f32(wlog), rtol=tol, atol=tol)
        if dtype == "float32":
            np.testing.assert_array_equal(gnext.numpy(), np.asarray(wnext))
    for ref_c, c in zip(ref_caches, interop.caches_to_numpy(caches, cfg)):
        for name in ("k", "v"):
            np.testing.assert_allclose(c[name], f32(ref_c[name]),
                                       rtol=CACHE_TOL[dtype],
                                       atol=CACHE_TOL[dtype])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_continues_from_reference_prefill_caches(arch, ref):
    """The reference's prefill caches, carried across, let the port decode
    on: the same logits and tokens as the reference's decode."""
    ref_cfg, params, cfg, model = carried(ref, arch, "float32", seed=1)
    toks = tokens(cfg, seed=1)
    _, ref_caches = ref.lm.prefill_step(
        params, ref.jnp.asarray(toks[:, :P]), ref_cfg)
    ref_caches = ref_grow(ref, ref_caches, T)
    caches = interop.caches_from_numpy(
        ref.jax.tree.map(np.asarray, ref_caches), cfg, "cpu")
    assert len(caches) == cfg.num_layers
    for i in range(T):
        tok = toks[:, P + i:P + i + 1]
        wnext, wlog, ref_caches = ref.lm.decode_step(
            params, ref.jnp.asarray(tok), ref_caches, ref_cfg, P + i)
        gnext, glog, caches = lm.decode_step(model, torch.as_tensor(tok),
                                             caches, P + i)
        np.testing.assert_allclose(f32(glog), f32(wlog), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_array_equal(gnext.numpy(), np.asarray(wnext))


def test_forward_logits_match_reference(ref):
    ref_cfg, params, cfg, model = carried(ref, "qwen3-0.6b", "float32",
                                          seed=2)
    toks = tokens(cfg, seed=2)
    want, _ = ref.lm.forward(params, ref.jnp.asarray(toks), ref_cfg)
    got = model(torch.as_tensor(toks))
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-4, atol=1e-4)


def test_greedy_serve_matches_reference_generation(ref):
    """The slice as a whole: the server's prefill and greedy decode loop
    give the reference's tokens (float32, no teacher forcing)."""
    ref_cfg, params, cfg, model = carried(ref, "qwen2-1.5b", "float32",
                                          seed=3)
    prompts = tokens(cfg, seed=3)[:, :P]
    logits, ref_caches = ref.lm.prefill_step(
        params, ref.jnp.asarray(prompts), ref_cfg)
    ref_caches = ref_grow(ref, ref_caches, 6)
    tok = ref.jnp.argmax(logits, -1).astype(ref.jnp.int32)
    want = [tok]
    for i in range(5):
        tok, _, ref_caches = ref.lm.decode_step(params, tok, ref_caches,
                                                ref_cfg, P + i)
        want.append(tok)
    got = serve.serve(model, torch.as_tensor(prompts), 6)
    np.testing.assert_array_equal(got.seqs.numpy(),
                                  np.asarray(ref.jnp.concatenate(want,
                                                                 axis=1)))
    assert len(got.logits) == 6


def test_cast_for_compute_keeps_scales_and_biases_float32(ref):
    """Named for the rule this test first held, which was wrong: the
    reference stacks every layer parameter as ``(P, ...)``, so its cast
    (2+ dims) rounds the layers' norm scales and biases to bf16 too and
    keeps only ``final_norm`` float32.  Leaf by leaf, the port's cast
    weights have the reference's cast's dtypes and bits."""
    ref_cfg, params, cfg, model = carried(ref, "qwen2-1.5b", "bfloat16")
    rng = np.random.default_rng(5)
    params = ref.jax.tree.map(
        lambda a: np.asarray(a) + rng.standard_normal(a.shape).astype(
            np.float32) * 0.3, params)
    model = lm.cast_params_for_compute(
        interop.params_from_numpy(params, cfg, "cpu"))
    want = ref.jax.tree.map(np.asarray,
                            ref.lm.cast_params_for_compute(params, ref_cfg))
    got = dict(model.named_parameters())
    n_pos = len(transformer.block_specs(cfg))
    checked = 0
    for path, leaf in flatten_ref(want).items():
        parts = path.split("/")
        if parts[0] == "stack":
            pos, rest = int(parts[1]), ".".join(parts[2:])
            slices = [(f"stack.blocks.{i * n_pos + pos}.{rest}", leaf[i])
                      for i in range(leaf.shape[0])]
        else:
            slices = [(path, leaf)]
        for name, w in slices:
            p = got[name].detach()
            assert str(p.dtype).removeprefix("torch.") == w.dtype.name, name
            if p.dtype == torch.bfloat16:
                p, w = p.float(), w.astype(np.float32)
            np.testing.assert_array_equal(p.numpy(), w, err_msg=name)
            checked += 1
    assert checked == len(got)
    assert got["final_norm"].dtype == torch.float32
    assert got["stack.blocks.0.mixer_norm"].dtype == torch.bfloat16
    assert got["stack.blocks.0.mixer.bq"].dtype == torch.bfloat16


def flatten_ref(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten_ref(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten_ref(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def test_bf16_logits_follow_the_reference_norm_rounding(ref):
    """With nonzero norm scales that bf16 cannot hold, the port's bf16
    logits are closer to the reference's with the reference's cast rule
    (scales rounded to bf16) than with the former rule (scales kept
    float32): the scales enter every normalisation."""
    ref_cfg, params, cfg, _ = carried(ref, "qwen3-0.6b", "bfloat16", seed=4)
    rng = np.random.default_rng(4)

    def scales(path, a):
        names = [str(getattr(k, "key", "")) for k in path]
        a = np.asarray(a)
        if names[-1].endswith("norm") and names[-1] != "final_norm":
            return (rng.standard_normal(a.shape) * 0.5).astype(np.float32)
        return a
    params = ref.jax.tree_util.tree_map_with_path(scales, params)
    toks = tokens(cfg, seed=4)
    want, _ = ref.lm.forward(params, ref.jnp.asarray(toks), ref_cfg)
    want = f32(want)
    fixed = lm.cast_params_for_compute(
        interop.params_from_numpy(params, cfg, "cpu"))
    former = interop.params_from_numpy(params, cfg, "cpu")
    for name, p in former.named_parameters():    # the former rule
        if p.ndim >= 2:
            p.data = p.data.to(torch.bfloat16)
    assert former.stack.blocks[0].mixer.q_norm.dtype == torch.float32
    err_fixed = np.abs(f32(fixed(torch.as_tensor(toks))) - want).max()
    err_former = np.abs(f32(former(torch.as_tensor(toks))) - want).max()
    assert err_fixed < err_former, (err_fixed, err_former)


def test_serve_main_runs_on_cpu(capsys):
    kbuild.reset_launches()
    model, prompts, _, res = serve.main(
        ["--device", "cpu", "--arch", "qwen2-1.5b-smoke", "--batch", "2",
         "--prompt-len", "12", "--tokens", "5", "--dtype", "float32"])
    assert tuple(res.seqs.shape) == (2, 5)
    assert res.prefill_ms > 0 and res.decode_ms_per_token > 0
    assert sum(kbuild.LAUNCHES.values()) == 0
    out = capsys.readouterr().out
    assert "qwen2-1.5b-smoke" in out and "on cpu" in out
    again = serve.serve(model, prompts, 5)
    assert torch.equal(again.seqs, res.seqs)
    model, _, _, res = serve.main(["--device", "cpu", "--tokens", "3"])
    assert model.cfg.name == "serve-demo" and tuple(res.seqs.shape) == (4, 3)


def test_serve_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        serve.main(["--tokens", "2"])


# ---------------------------------------------------------------------------
# On the card: the LM through the kernels against the LM on the CPU
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
    toks = torch.as_tensor(tokens(cfg))
    kbuild.reset_launches()
    want = serve.serve(cpu, toks[:, :P], T)
    got = serve.serve(card, toks[:, :P].cuda(), T)
    assert kbuild.LAUNCHES["flash_attention"] == cfg.num_layers
    assert kbuild.LAUNCHES["decode_attention"] == cfg.num_layers * (T - 1)
    assert torch.equal(got.seqs.cpu(), want.seqs)
    for g, w in zip(got.logits, want.logits):
        np.testing.assert_allclose(f32(g.cpu()), f32(w), rtol=1e-4,
                                   atol=1e-4)
