"""The LM step over a device mesh: every leaf a DTensor.

Eight gloo ranks on the CPU (``rank_cases.dtensor_cases``, spawned once)
lay a (2, 2, 2) ("pod", "data", "model") ``DeviceMesh`` over themselves
(``mesh.device_mesh``) and run, with every parameter, optimizer leaf,
batch, weight and cache a DTensor placed by the reference's rules:

* the reduced deepseek-moe-16b (float32) for 2 train steps at 2 pods in
  mode 3 (BEST_EFFORT) and mode 3 with the int8 compressor: the state on
  the ("data", "model") axes, the pods over the "pod" axis's group
  (``mesh.pod_group``), the experts over "model" (expert parallelism);
* the reduced qwen2-1.5b (float32): prefill of 8 prompts of 16 tokens and
  2 teacher-forced decode steps under the serving rules (batch over
  ("pod", "data"), the caches' sequence over "model");
* the reduced jamba-v0.1-52b (float32): 2 decode steps under
  ``long_500k``'s rules, its attention cache's 64 positions split 8 ways
  (each rank holds 8; the live keys end in rank 2's block, so five ranks
  merge empty partials).

Each is held to two references: the one-process port on the same inputs,
and the reference's jitted step (train) or its ``lm`` functions (serve)
on the same weights.  The tensor-parallel split changes the order of the
contractions' float32 sums, so these are tolerances, not bits.  Measured
maxima against one process (a CPU run): train loss 1.5e-7 relative,
aux 0, grad norm 8.7e-8 relative, parameters and moments 5.1e-6
absolute; logits 7.7e-7.  A gradient that differs in its last bits can
round to another int8 level: in the int8 case 2 of a leaf's 65,536
elements moved by 2.2e-5 and 1.2e-5 (``INT8_FLIPS``); the other pods'
sums and the int8 residuals are not compared.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import rank_cases  # noqa: E402
import torch_cases  # noqa: E402,F401  (caps torch's threads)
from repro_torch import interop  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.pytree import flatten  # noqa: E402

#: against one process: loss and aux relative, grad norm relative,
#: parameters and moments absolute, logits absolute
LOSS_RTOL, NORM_RTOL, LEAF_ATOL, LOGIT_ATOL = 1e-6, 1e-5, 2e-5, 1e-5
#: int8 cases: elements a leaf past LEAF_ATOL, where a gradient that differs
#: in its last bits rounded to another int8 level, each within FLIP_ATOL
INT8_FLIPS, FLIP_ATOL = 4, 2e-4
#: against the reference: test_torch_train.py's and test_torch_lm.py's
REF_LOSS_RTOL, REF_NORM_RTOL, MOVE_TOL, REF_LOGIT_TOL = 1e-5, 1e-4, 0.05, 1e-4
#: the serve cases: name -> (arch, long_context)
SERVE = {"qwen2_prefill_decode": ("qwen2-1.5b", False),
         "jamba_long_decode": ("jamba-v0.1-52b", True)}


@pytest.fixture(scope="module")
def ref():
    """The reference (JAX)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.configs.smoke import reduce_for_smoke
    from repro.models import lm as ref_lm
    return types.SimpleNamespace(jax=jax, jnp=jnp, lm=ref_lm,
                                 cfg=lambda a: reduce_for_smoke(
                                     get_config(a)).replace(dtype="float32"))


def serve_inputs(ref, arch, long_context):
    """(reference params, their numpy tree, tokens) of a serve case."""
    params = ref.lm.init_params(ref.jax.random.PRNGKey(3), ref.cfg(arch))
    cfg = rank_cases.train_cfg(arch)
    rng = np.random.default_rng(5)
    batch = 1 if long_context else rank_cases.DT_SB
    toks = rng.integers(0, cfg.vocab_size,
                        (batch, rank_cases.DT_P + rank_cases.DT_T)
                        ).astype(np.int32)
    return params, ref.jax.tree.map(np.asarray, params), toks


@pytest.fixture(scope="module")
def runs(ref, tmp_path_factory):
    inputs = {name: serve_inputs(ref, *case) for name, case in SERVE.items()}
    payload = {"train": list(rank_cases.DT_TRAIN),
               "serve": {name: (SERVE[name][0], inputs[name][1],
                                inputs[name][2], SERVE[name][1])
                         for name in SERVE}}
    ranks = rank_cases.start(8, tmp_path_factory.mktemp("dtensor"),
                             "dtensor_cases", payload)
    one = {"train": {case: rank_cases.dt_train(*case)
                     for case in rank_cases.DT_TRAIN},
           "serve": {name: rank_cases.dt_serve(*args)
                     for name, args in payload["serve"].items()}}
    return dict(mesh=ranks.results()[0], one=one, inputs=inputs)


@pytest.mark.parametrize("case", rank_cases.DT_TRAIN,
                         ids=lambda c: f"{c[0]}-mode{c[1]}-{c[2] or 'plain'}")
def test_train_steps_match_one_process(runs, case):
    state, metrics = runs["mesh"]["train"][case]
    want_state, want = runs["one"]["train"][case]
    for m, w in zip(metrics, want):
        assert abs(m["loss"] / w["loss"] - 1) <= LOSS_RTOL, (m, w)
        assert abs(m["aux"] - w["aux"]) <= LOSS_RTOL * abs(w["aux"]), (m, w)
        assert abs(m["grad_norm"] / w["grad_norm"] - 1) <= NORM_RTOL
        assert m["lr"] == w["lr"]
    got, want_state = flatten(state), flatten(want_state)
    assert sorted(got) == sorted(want_state)
    flips = INT8_FLIPS if case[2] == "int8" else 0
    for k, v in want_state.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
        if k.split("/")[0] in ("params", "opt"):
            err = (got[k].double() - v.double()).abs().flatten()
            assert int((err > LEAF_ATOL).sum()) <= flips, (k, err.max())
            assert float(err.max()) <= FLIP_ATOL, (k, err.max())
    assert torch.equal(got["step"], want_state["step"])


@pytest.mark.parametrize("case", rank_cases.DT_TRAIN,
                         ids=lambda c: f"{c[0]}-mode{c[1]}-{c[2] or 'plain'}")
def test_train_steps_match_the_reference(runs, ref, case):
    from repro.core.modes import AsyncMode
    from repro.launch import train as ref_train
    from repro.optim.adamw import AdamWConfig
    from repro.optim.outer import OuterConfig
    arch, mode, comp = case
    spec = ref_train.TrainSpec(
        mode=AsyncMode(mode), compressor=comp,
        adamw=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20),
        outer=OuterConfig(sync_period=2))
    step = ref.jax.jit(ref_train.make_train_step(ref.cfg(arch), spec,
                                                 rank_cases.DT_PODS))
    ref_state = interop.train_state_to_numpy(train.init_train_state(
        rank_cases.train_cfg(arch), rank_cases.train_spec(mode, comp),
        rank_cases.DT_PODS, device="cpu"))
    state, metrics = runs["mesh"]["train"][case]
    lr_sum = 0.0
    for b, m in zip(rank_cases.dt_batches(rank_cases.train_cfg(arch)),
                    metrics):
        ref_state, want = step(ref_state, {k: v.numpy()
                                           for k, v in b.items()})
        lr_sum += float(want["lr"])
        assert abs(m["loss"] / float(want["loss"]) - 1) <= REF_LOSS_RTOL
        assert abs(m["grad_norm"] / float(want["grad_norm"]) - 1) \
            <= REF_NORM_RTOL
    want = flatten(ref.jax.tree.map(np.asarray, ref_state))
    for k, v in flatten(state).items():
        if k.startswith("params/"):
            err = float((v.double() - torch.as_tensor(want[k]).double())
                        .abs().max())
            assert err <= MOVE_TOL * lr_sum, (k, err, lr_sum)


@pytest.mark.parametrize("name", sorted(SERVE))
def test_serve_steps_match_one_process(runs, name):
    got, want = runs["mesh"]["serve"][name], runs["one"]["serve"][name]
    assert len(got["steps"]) == len(want["steps"]) == 1 + rank_cases.DT_T
    if got["steps"][0] is not None:
        err = float((got["steps"][0] - want["steps"][0]).abs().max())
        assert err <= LOGIT_ATOL, err
    for (gn, gl), (wn, wl) in zip(got["steps"][1:], want["steps"][1:]):
        assert torch.equal(gn, wn)
        assert float((gl - wl).abs().max()) <= LOGIT_ATOL


@pytest.mark.parametrize("name", sorted(SERVE))
def test_serve_steps_match_the_reference(runs, ref, name):
    arch, long_context = SERVE[name]
    params, _, toks = runs["inputs"][name]
    cfg = ref.cfg(arch)
    P, T = rank_cases.DT_P, rank_cases.DT_T
    logits, caches = ref.lm.prefill_step(params, ref.jnp.asarray(toks[:, :P]),
                                         cfg)
    got = runs["mesh"]["serve"][name]["steps"]
    if got[0] is not None:
        np.testing.assert_allclose(got[0].numpy(), np.asarray(logits),
                                   rtol=REF_LOGIT_TOL, atol=REF_LOGIT_TOL)
    total = rank_cases.DT_LONG_S if long_context else P + T
    caches = ref.jax.tree.map(
        lambda a: ref.jnp.pad(a, [(0, 0)] * 2 + [(0, total - a.shape[2])]
                              + [(0, 0)] * (a.ndim - 3))
        if a.ndim == 5 else a, caches)
    for i in range(T):
        nxt, logits, caches = ref.lm.decode_step(
            params, ref.jnp.asarray(toks[:, P + i:P + i + 1]), caches, cfg,
            P + i)
        gn, gl = got[1 + i]
        np.testing.assert_array_equal(gn.numpy(), np.asarray(nxt))
        np.testing.assert_allclose(gl.numpy(), np.asarray(logits),
                                   rtol=REF_LOGIT_TOL, atol=REF_LOGIT_TOL)


def test_long_context_cache_is_split_eight_ways(runs):
    """Under long_500k's rules each rank holds 8 of the attention cache's
    64 positions: the cache is never gathered."""
    k_local = runs["mesh"]["serve"]["jamba_long_decode"]["k_local"]
    assert k_local[1] == rank_cases.DT_LONG_S // 8
    assert runs["mesh"]["serve"]["qwen2_prefill_decode"]["k_local"][0] \
        == rank_cases.DT_SB // 4
