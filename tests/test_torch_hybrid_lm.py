"""repro_torch's hybrid LM (jamba: Mamba + attention + MoE) serving path
against the reference's.

The reference's ``lm.init_params`` weights for the reduced jamba-v0.1-52b
(``reduce_for_smoke``: one 8-layer period, d 64, di 128, N 16, 8 experts
top-2, vocab 503), carried across with ``interop.params_from_numpy``, go
through the port's ``prefill_step`` and ``decode_step`` and the
reference's, with the same numpy-made tokens; decode is teacher-forced.
In float32 the logits and every cache (attention ``k``/``v``, Mamba
``h``/``conv``) agree within 1e-4 and the greedy tokens are equal.  In
bfloat16 the reference's bf16 sigmoid (XLA's, inside ``jax.nn.silu``)
differs from torch's by one bf16 ulp on many elements, and
that difference runs through 8 layers: logits agree within 4e-2 (about
9% of the largest logit) and each cache within 10% of its largest
magnitude.  That holds only while no token's top-2 routing sits within
bf16 noise of a tie: a route that flips sends the token to another expert
and moves the logits by tens of percent, a discontinuity of the model
itself (``test_bf16_routing_makes_the_logits_discontinuous``).  So the
decode steps record the reference's router logits at every MoE layer:
the port's must agree within ``ROUTER_NOISE``, and where a top-2 set
differs, the reference's own margin must be within that noise too (a
tie); that row then takes the reference's experts, so every row stays
held to the tolerances at every step.  In float32 no route may differ.
Which row ties depends on the host: the recurrent states integrate
one-ulp bf16 differences, and the host's float32 arithmetic moves them
(on an AMD EPYC host, row 0 at the last MoE layer of decode step 3, the
reference's margin 0.054).  On the CPU the scan and attention take the
kernels' plain torch versions.
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
from repro_torch.models import lm, moe, transformer  # noqa: E402

ARCH = "jamba-v0.1-52b"
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 4e-2}
#: caches: absolute in float32, a share of the largest magnitude in bf16
CACHE_TOL = {"float32": 1e-4, "bfloat16": 0.1}
#: router logits, port against reference at each MoE layer of a decode
#: step (absolute; the logits reach 2.4): the largest distances measured
#: over the 16 MoE calls of these inputs, on an AMD EPYC host, are 3.2e-6
#: in float32 and 0.085 in bf16 (about 5 bf16 ulps at that magnitude)
ROUTER_NOISE = {"float32": 1e-5, "bfloat16": 0.1}
B, P, T = 2, 16, 4


@pytest.fixture
def ref():
    """The reference (JAX); the card machine has no JAX."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as ref_get_config
    from repro.configs.smoke import reduce_for_smoke as ref_reduce
    from repro.models import lm as ref_lm
    return types.SimpleNamespace(jax=jax, jnp=jnp, get_config=ref_get_config,
                                 reduce=ref_reduce, lm=ref_lm)


def carried(ref, dtype, seed=0):
    """(reference cfg, reference params, port cfg, port LM cast for
    compute) from the same reference weights."""
    ref_cfg = ref.reduce(ref.get_config(ARCH)).replace(dtype=dtype)
    cfg = reduce_for_smoke(get_config(ARCH)).replace(dtype=dtype)
    params = ref.lm.init_params(ref.jax.random.PRNGKey(seed), ref_cfg)
    model = interop.params_from_numpy(ref.jax.tree.map(np.asarray, params),
                                      cfg, "cpu")
    return ref_cfg, params, cfg, lm.cast_params_for_compute(model)


def tokens(cfg, seed=0, n=P + T):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, n)).astype(np.int32)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def ref_grow(ref, caches, extra):
    """Grow the reference's attention caches (only those) by ``extra``
    positions for the decode steps."""
    def grow(path, a):
        if str(path[-1].key) not in ("k", "v"):
            return a
        return ref.jnp.pad(a, [(0, 0)] * 2 + [(0, extra)] + [(0, 0)] * 2)
    return ref.jax.tree_util.tree_map_with_path(grow, caches)


def assert_caches_close(got, want, dtype, prefix=None):
    """Every cache of every period position; ``prefix`` cuts the attention
    caches to their first positions."""
    names = set()
    for w, g in zip(want, got):
        for name, wa in w.items():
            ga, wa = g[name], f32(wa)
            if prefix is not None and name in ("k", "v"):
                ga = ga[:, :, :prefix]
            tol = CACHE_TOL[dtype]
            if dtype == "bfloat16":
                tol *= float(np.abs(wa).max())
            np.testing.assert_allclose(ga, wa, rtol=0, atol=tol,
                                       err_msg=name)
            names.add(name)
    assert names == {"k", "v", "h", "conv"}


def test_params_carry_across_every_weight(ref):
    ref_cfg, params, cfg, model = carried(ref, "float32")
    n = sum(p.numel() for p in model.parameters())
    assert n == ref.lm.param_count(ref_cfg)
    mixer = params["stack"][0]["mixer"]
    np.testing.assert_array_equal(model.stack.blocks[0].mixer.A_log.numpy(),
                                  np.asarray(mixer["A_log"][0]))
    router = params["stack"][1]["ffn"]["router"]
    np.testing.assert_array_equal(model.stack.blocks[1].ffn.router.numpy(),
                                  np.asarray(router[0]))
    gate = params["stack"][7]["ffn"]["gate"]
    np.testing.assert_array_equal(model.stack.blocks[7].ffn.gate.numpy(),
                                  np.asarray(gate[0]))
    assert [b.spec for b in model.stack.blocks] == \
        transformer.block_specs(cfg)


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


def test_compute_cast_matches_reference_leaf_by_leaf(ref):
    """The reference stacks layer parameters as (P, ...), so its cast
    (every float32 leaf of 2+ dims, router excepted) rounds the Mamba
    vectors (A_log, D, dt_bias, conv_b) to bf16 and keeps the routers and
    ``final_norm`` float32.  Leaf by leaf, the port's cast weights have
    the reference's cast's dtypes and bits."""
    ref_cfg, params, cfg, _ = carried(ref, "bfloat16")
    rng = np.random.default_rng(6)
    params = ref.jax.tree.map(
        lambda a: np.asarray(a) + rng.standard_normal(a.shape).astype(
            np.float32) * 0.01, params)
    model = lm.cast_params_for_compute(
        interop.params_from_numpy(params, cfg, "cpu"))
    want = ref.jax.tree.map(np.asarray,
                            ref.lm.cast_params_for_compute(params, ref_cfg))
    got = dict(model.named_parameters())
    checked = 0
    for path, leaf in flatten_ref(want).items():
        parts = path.split("/")
        name = (f"stack.blocks.{parts[1]}.{'.'.join(parts[2:])}"
                if parts[0] == "stack" else path)
        w = leaf[0] if parts[0] == "stack" else leaf
        p = got[name].detach()
        assert str(p.dtype).removeprefix("torch.") == w.dtype.name, name
        if p.dtype == torch.bfloat16:
            p, w = p.float(), w.astype(np.float32)
        np.testing.assert_array_equal(p.numpy(), w, err_msg=name)
        checked += 1
    assert checked == len(got)
    mixer = model.stack.blocks[0].mixer
    for leaf in (mixer.A_log, mixer.D, mixer.dt_bias, mixer.conv_b):
        assert leaf.dtype == torch.bfloat16
    assert model.stack.blocks[1].ffn.router.dtype == torch.float32
    assert model.final_norm.dtype == torch.float32


def force_ties(ref, monkeypatch, dtype):
    """Hold every MoE layer of each decode step to the reference's routes.

    The reference's router logits (tokens, E) are recorded through a host
    callback, in call order.  At the same layer the port's must agree
    within ``ROUTER_NOISE[dtype]``; where the port's top-k expert set
    differs from the reference's, the reference's own margin (its k-th
    logit less its (k+1)-th) must be within that noise too: the flip is a
    tie.  Such a row then takes the reference's experts, weighted by the
    port's own probabilities, so that every row stays checked.  Returns
    ``{"ref": [...], "flips": [(MoE call, rows, margins)], "calls": n}``."""
    seen = {"ref": [], "flips": [], "calls": 0}
    from repro.models import moe as ref_moe
    apply = ref_moe.apply_moe

    def ref_apply(params, x, cfg, *a, **k):
        logits = (x.astype(ref.jnp.float32) @
                  params["router"].astype(ref.jnp.float32))
        ref.jax.debug.callback(
            lambda v: seen["ref"].append(
                np.asarray(v).reshape(-1, v.shape[-1])), logits,
            ordered=True)
        return apply(params, x, cfg, *a, **k)

    route = moe._route
    noise = ROUTER_NOISE[dtype]

    def port_route(p, x, cfg):
        probs, w, idx = route(p, x, cfg)
        seen["calls"] += 1
        want = seen["ref"].pop(0)
        got = (x.float() @ p["router"].float()).reshape(want.shape).numpy()
        dist = float(np.abs(got - want).max())
        assert dist <= noise, f"router logits {dist} apart"
        k = cfg.experts_per_tok
        top = np.argsort(-want, axis=1, kind="stable")[:, :k]
        mine = idx.reshape(top.shape).numpy()
        rows = [b for b in range(top.shape[0])
                if set(top[b]) != set(mine[b])]
        if rows:
            srt = -np.sort(-want, axis=1)
            margins = srt[rows, k - 1] - srt[rows, k]
            assert (margins <= noise).all(), (rows, margins, dist)
            seen["flips"].append((seen["calls"], rows, margins))
            mine[rows] = top[rows]
            idx = torch.as_tensor(mine).reshape(idx.shape)
            w = probs.gather(-1, idx)
            w = w / w.sum(-1, keepdim=True).clamp(min=1e-9)
        return probs, w, idx

    monkeypatch.setattr(moe, "_route", port_route)
    monkeypatch.setattr(ref_moe, "apply_moe", ref_apply)
    return seen


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(dtype, ref, monkeypatch):
    ref_cfg, params, cfg, model = carried(ref, dtype)
    toks = tokens(cfg)
    tol = LOGIT_TOL[dtype]
    want, ref_caches = ref.lm.prefill_step(
        params, ref.jnp.asarray(toks[:, :P]), ref_cfg)
    got, caches = lm.prefill_step(model, torch.as_tensor(toks[:, :P]),
                                  cache_len=P + T)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol)
    attn = transformer.block_specs(cfg).index(("attn", "mlp"))
    assert caches[attn]["k"].shape[1] == P + T
    assert not caches[attn]["k"][:, P:].any()
    assert caches[0]["h"].dtype == torch.float32
    assert caches[0]["conv"].dtype == getattr(torch, dtype)
    assert_caches_close(interop.caches_to_numpy(caches, cfg), ref_caches,
                        dtype, prefix=P)
    ref_caches = ref_grow(ref, ref_caches, T)
    seen = force_ties(ref, monkeypatch, dtype)
    for i in range(T):
        tok = toks[:, P + i:P + i + 1]      # teacher forcing
        wnext, wlog, ref_caches = ref.lm.decode_step(
            params, ref.jnp.asarray(tok), ref_caches, ref_cfg, P + i)
        ref.jax.effects_barrier()
        gnext, glog, caches = lm.decode_step(model, torch.as_tensor(tok),
                                             caches, P + i)
        assert not seen["ref"], "the port ran fewer MoE layers"
        np.testing.assert_allclose(f32(glog), f32(wlog), rtol=tol, atol=tol)
        if dtype == "float32":
            np.testing.assert_array_equal(gnext.numpy(), np.asarray(wnext))
    if dtype == "float32":
        assert not seen["flips"]
    assert_caches_close(interop.caches_to_numpy(caches, cfg), ref_caches,
                        dtype)


def test_decode_continues_from_reference_prefill_caches(ref):
    """The reference's prefill caches (KV and Mamba states), carried
    across, let the port decode on: the same logits and tokens."""
    ref_cfg, params, cfg, model = carried(ref, "float32", seed=1)
    toks = tokens(cfg, seed=1)
    _, ref_caches = ref.lm.prefill_step(
        params, ref.jnp.asarray(toks[:, :P]), ref_cfg)
    ref_caches = ref_grow(ref, ref_caches, T)
    caches = interop.caches_from_numpy(
        ref.jax.tree.map(np.asarray, ref_caches), cfg, "cpu")
    assert len(caches) == cfg.num_layers
    assert sorted(caches[0]) == ["conv", "h"]
    for i in range(T):
        tok = toks[:, P + i:P + i + 1]
        wnext, wlog, ref_caches = ref.lm.decode_step(
            params, ref.jnp.asarray(tok), ref_caches, ref_cfg, P + i)
        gnext, glog, caches = lm.decode_step(model, torch.as_tensor(tok),
                                             caches, P + i)
        np.testing.assert_allclose(f32(glog), f32(wlog), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_array_equal(gnext.numpy(), np.asarray(wnext))


def test_greedy_serve_matches_reference_generation(ref):
    """The slice as a whole: the server's prefill and greedy decode loop
    give the reference's tokens (float32, no teacher forcing)."""
    ref_cfg, params, cfg, model = carried(ref, "float32", seed=3)
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
    kbuild.reset_launches()
    got = serve.serve(model, torch.as_tensor(prompts), 6)
    assert sum(kbuild.LAUNCHES.values()) == 0
    np.testing.assert_array_equal(got.seqs.numpy(),
                                  np.asarray(ref.jnp.concatenate(want,
                                                                 axis=1)))


@pytest.mark.parametrize("k", [1, 5])
def test_mamba_state_after_prefill_equals_decode_state(k):
    """Layer 0 (a Mamba layer, fed by the embeddings alone) holds the same
    state after a prefill of prompt + k tokens as after the prompt's
    prefill and k decode steps: the scan and the decode recurrence are one
    function (float32; 1e-5, the order of the float32 sums)."""
    cfg = reduce_for_smoke(get_config(ARCH)).replace(dtype="float32")
    model = lm.LM(cfg, seed=2, device="cpu")
    toks = torch.as_tensor(tokens(cfg, seed=2, n=P + k))
    _, caches = lm.prefill_step(model, toks[:, :P], P + k)
    for i in range(k):
        lm.decode_step(model, toks[:, P + i:P + i + 1], caches, P + i)
    _, want = lm.prefill_step(model, toks)
    for name in ("h", "conv"):
        np.testing.assert_allclose(f32(caches[0][name]), f32(want[0][name]),
                                   rtol=1e-5, atol=1e-5)


def test_prefill_and_decode_differ_only_through_moe_drops(monkeypatch):
    """As in the reference, prefill (grouped, drops pairs beyond the
    capacity) and decode (dense, drops nothing) are different functions:
    the logits of a prefill of prompt + k tokens and of decode step k
    differ.  With capacity_factor = E / k nothing is dropped and they are
    one function (float32; 1e-5)."""
    cfg = reduce_for_smoke(get_config(ARCH)).replace(dtype="float32")
    model = lm.LM(cfg, seed=4, device="cpu")
    toks = torch.as_tensor(tokens(cfg, seed=4, n=40 + 6))

    def gap():
        _, caches = lm.prefill_step(model, toks[:, :40], 46)
        worst = 0.0
        for i in range(6):
            _, dec, _ = lm.decode_step(model, toks[:, 40 + i:41 + i], caches,
                                       40 + i)
            pre, _ = lm.prefill_step(model, toks[:, :41 + i])
            worst = max(worst, float((pre - dec).abs().max()))
        return worst

    assert gap() > 1e-2
    no_drops = cfg.num_experts / cfg.experts_per_tok
    monkeypatch.setattr(
        transformer, "apply_moe",
        lambda p, x, cfg: moe.apply_moe(p, x, cfg, capacity_factor=no_drops))
    assert gap() < 1e-5


def bf16_ulp_shift(cfg, seed):
    """Max |logit change| of a reduced model in bf16 when 30% of layer 0's
    ``in_proj`` entries are raised by one bf16 ulp, over a prefill of 64
    tokens and 7 teacher-forced decode steps, and the largest logit."""
    cfg = cfg.replace(dtype="bfloat16")
    model = lm.cast_params_for_compute(lm.LM(cfg, seed=0, device="cpu"))
    prompts = torch.as_tensor(tokens(cfg, seed=1, n=64 + 8))

    def run():
        logits, caches = lm.prefill_step(model, prompts[:, :64], 72)
        out = [logits]
        for i in range(7):
            _, logits, caches = lm.decode_step(
                model, prompts[:, 64 + i:65 + i], caches, 64 + i)
            out.append(logits)
        return torch.cat(out, dim=1)

    want = run()
    w = model.stack.blocks[0].mixer.in_proj
    gen = torch.Generator().manual_seed(seed)
    raise_ = torch.rand(w.shape, generator=gen) < 0.3
    w.data = torch.where(raise_, (w.float() * (1 + 2 ** -7)).to(w.dtype), w)
    return float((run() - want).abs().max()), float(want.abs().max())


def test_bf16_routing_makes_the_logits_discontinuous():
    """Why an MoE model's bf16 logits cannot be held to another device's:
    one bf16 ulp on 30% of layer 0's in_proj moves the reduced jamba's
    logits by more than 20% of the largest (a rounding crosses a near tie
    of the top-2 router and sends tokens to other experts), and the same
    model with MLPs in place of its MoE layers by less than 10%."""
    cfg = reduce_for_smoke(get_config(ARCH))
    dense = cfg.replace(num_experts=0, experts_per_tok=0, moe_d_ff=0)
    assert all(s[1] == "mlp" for s in transformer.block_specs(dense))
    for seed in (10, 11):
        shift, scale = bf16_ulp_shift(cfg, seed)
        assert shift > 0.2 * scale, (shift, scale)
        shift, scale = bf16_ulp_shift(dense, seed)
        assert shift < 0.1 * scale, (shift, scale)


def test_init_caches_follow_each_spec():
    cfg = reduce_for_smoke(get_config(ARCH))
    caches = transformer.init_caches(cfg, 2, 24, device="cpu")
    for spec, cache in zip(transformer.block_specs(cfg), caches):
        if spec[0] == "attn":
            assert tuple(cache["k"].shape) == (2, 24, cfg.num_kv_heads,
                                               cfg.hd)
        else:
            assert tuple(cache["h"].shape) == (2, 128, 16)
            assert cache["h"].dtype == torch.float32
            assert tuple(cache["conv"].shape) == (2, 3, 128)
            assert cache["conv"].dtype == torch.bfloat16


def test_serve_main_runs_on_cpu_and_launches_no_kernel(capsys):
    kbuild.reset_launches()
    model, prompts, _, res = serve.main(
        ["--device", "cpu", "--arch", "jamba-v0.1-52b-smoke", "--batch", "2",
         "--prompt-len", "12", "--tokens", "5"])
    assert tuple(res.seqs.shape) == (2, 5)
    assert sum(kbuild.LAUNCHES.values()) == 0
    out = capsys.readouterr().out
    assert "jamba-v0.1-52b-smoke (bfloat16)" in out and "on cpu" in out
    again = serve.serve(model, prompts, 5)
    assert torch.equal(again.seqs, res.seqs)


def test_moe_blocks_train_under_attention():
    """jamba's MoE blocks train under attention mixers: the training
    forward returns finite logits and a positive aux
    (``tests/test_torch_moe_train.py`` holds it to the reference; the
    whole jamba's training, Mamba blocks too, is held to ``jax.grad`` in
    ``tests/test_torch_ssm_train.py``)."""
    cfg = reduce_for_smoke(get_config(ARCH)).replace(
        dtype="float32", block_pattern=("attn",))
    params = lm.init_params(cfg, device="cpu")
    toks = torch.as_tensor(tokens(cfg))
    assert ("attn", "moe") in transformer.block_specs(cfg)
    logits, aux = lm.forward(params, toks, cfg)
    assert bool(torch.isfinite(logits).all()) and float(aux) > 0


# ---------------------------------------------------------------------------
# On the card: the jamba path through the kernels against the CPU
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                    "mode)")
    cfg = reduce_for_smoke(get_config(ARCH)).replace(dtype="float32")
    cpu = lm.LM(cfg, seed=0, device="cpu")
    card = lm.LM(cfg, seed=0, device="cpu").to("cuda")
    toks = torch.as_tensor(tokens(cfg))
    kbuild.reset_launches()
    want = serve.serve(cpu, toks[:, :P], T)
    got = serve.serve(card, toks[:, :P].cuda(), T)
    specs = transformer.block_specs(cfg)
    assert kbuild.LAUNCHES["mamba_scan"] == sum(
        s[0] == "mamba" for s in specs)
    assert kbuild.LAUNCHES["flash_attention"] == 1
    assert kbuild.LAUNCHES["decode_attention"] == T - 1
    assert torch.equal(got.seqs.cpu(), want.seqs)
    for g, w in zip(got.logits, want.logits):
        np.testing.assert_allclose(f32(g.cpu()), f32(w), rtol=1e-4,
                                   atol=1e-4)
