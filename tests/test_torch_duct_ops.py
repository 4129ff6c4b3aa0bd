"""repro_torch duct ops against the reference's three implementations.

The port's plain torch versions of the dense-layout window and commit ops
(``duct_window_torch`` / ``duct_commit_torch``) must be slot-exact (bitwise,
``+inf`` writes included) against the reference's numpy oracles, its jnp
twins, and its Pallas kernels run in interpret mode, on the same random
ring states made with numpy.  On the CPU the public ``duct_window`` /
``duct_commit`` take the plain versions and never reach the CUDA kernel
loader; the kernels themselves are held against the plain versions on the
card by the ``cuda``-marked tests at the end, which need no JAX (run them
on the card with ``python -m pytest -q -m cuda tests/test_torch_duct_ops.py``).
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.duct_exchange import kernel as tkernel  # noqa: E402
from repro_torch.kernels.duct_exchange.ops import (  # noqa: E402
    dense_halo_select,
    dense_stage,
    duct_commit,
    duct_commit_torch,
    duct_window,
    duct_window_torch,
)


def random_window_state(rng, n, d, C, L, cap):
    """A random dense ring state with an engine-style staged push (eager
    drop-iff-full against the carried size, already counted in size)."""
    qa = np.full((n, d, C), np.inf, np.float32)
    qt = np.zeros((n, d, C), np.int32)
    qp = np.zeros((n, d, C, L), np.int32)
    head = rng.integers(0, C, (n, d)).astype(np.int32)
    size = np.zeros((n, d), np.int32)
    for p in range(n):
        for j in range(d):
            s = rng.integers(0, cap)
            size[p, j] = s
            for k in range(s):
                pos = (head[p, j] + k) % C
                qa[p, j, pos] = rng.random() * 2
                qt[p, j, pos] = rng.integers(0, 50)
                qp[p, j, pos] = rng.integers(0, 99, L)
    pacc = (rng.random((n, d)) < 0.7) & (size < cap)
    ppos = ((head + size) % C).astype(np.int32)
    size = (size + pacc).astype(np.int32)
    pav = (rng.random((n, d)) * 2).astype(np.float32)
    ptch = rng.integers(0, 50, (n, d)).astype(np.int32)
    ppay = rng.integers(0, 99, (n, d, L)).astype(np.int32)
    rnow = (rng.random(n) * 2).astype(np.float32)
    ract = rng.random(n) < 0.8
    return (qa, qt, qp, head, size, ppos, pacc, pav, ptch, ppay, rnow, ract)


def random_commit_state(rng, R, C, L, W):
    qa = (rng.random((R, C)) * 2).astype(np.float32)
    qt = rng.integers(0, 50, (R, C)).astype(np.int32)
    qp = rng.integers(0, 99, (R, C, L)).astype(np.int32)
    head = rng.integers(0, C, R).astype(np.int32)
    size0 = rng.integers(0, C, R).astype(np.int32)
    # the engine guarantees pb_cnt pushes fit behind the frozen tail
    cnt = np.minimum(rng.integers(0, W + 1, R), C - size0).astype(np.int32)
    pa = (rng.random((R, W)) * 2).astype(np.float32)
    pt = rng.integers(0, 50, (R, W)).astype(np.int32)
    pp = rng.integers(0, 99, (R, W, L)).astype(np.int32)
    return (qa, qt, qp, head, size0, cnt, pa, pt, pp)


@pytest.fixture
def ref():
    """The reference package's duct ops (JAX); the card machine has no JAX,
    so only the comparisons with the reference need it."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import duct_exchange as de
    return types.SimpleNamespace(jnp=jnp, **{
        name: getattr(de, name) for name in (
            "dense_halo_select", "dense_stage", "duct_commit",
            "duct_commit_jnp", "duct_commit_ref", "duct_window",
            "duct_window_jnp", "duct_window_ref")})


def _t(args, device="cpu"):
    return [torch.as_tensor(a, device=device) for a in args]


def _assert_fields_equal(want, got, label):
    for name, a, b in zip(want._fields, want, got):
        b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        a = np.asarray(a)
        assert a.dtype == b.dtype, (label, name)
        np.testing.assert_array_equal(b, a, err_msg=f"{label}: field {name}")


#: (n, d, C, L, cap, max_pops): degree 1 with a one-slot ring, degree 4
#: (torus) and degree 8 (padded buckets), one- and eight-lane payloads,
#: pop budgets below, at and far above the ring size
WINDOW_CASES = [
    (3, 1, 1, 1, 1, 1),
    (6, 4, 8, 1, 8, 3),
    (6, 4, 8, 8, 8, 64),
    (5, 8, 6, 8, 6, 3),
    (5, 8, 6, 1, 6, 64),
    (7, 2, 5, 8, 5, 1),
    (4, 4, 64, 1, 64, 16),
]


@pytest.mark.parametrize("case", WINDOW_CASES,
                         ids=["n{}-d{}-C{}-L{}-cap{}-pops{}".format(*c)
                              for c in WINDOW_CASES])
def test_duct_window_bitwise_vs_reference(case, ref):
    n, d, C, L, cap, max_pops = case
    rng = np.random.default_rng(1000 + sum(case))
    args = random_window_state(rng, n, d, C, L, cap)
    got = duct_window_torch(*_t(args), max_pops=max_pops)
    _assert_fields_equal(ref.duct_window_ref(*args, max_pops=max_pops), got,
                         "numpy ref")
    jargs = [ref.jnp.asarray(a) for a in args]
    _assert_fields_equal(ref.duct_window_jnp(*jargs, max_pops=max_pops),
                         got, "jnp twin")
    _assert_fields_equal(
        ref.duct_window(*jargs, max_pops=max_pops, use_pallas=True,
                        interpret=True), got, "pallas interpret")
    # the public op on CPU tensors is the plain version
    _assert_fields_equal(got, duct_window(*_t(args), max_pops=max_pops),
                         "dispatch")


COMMIT_CASES = [(1, 1, 1, 1), (24, 6, 2, 5), (40, 8, 8, 4), (16, 64, 1, 8)]


@pytest.mark.parametrize("case", COMMIT_CASES,
                         ids=["R{}-C{}-L{}-W{}".format(*c) for c in COMMIT_CASES])
def test_duct_commit_bitwise_vs_reference(case, ref):
    R, C, L, W = case
    rng = np.random.default_rng(2000 + sum(case))
    args = random_commit_state(rng, R, C, L, W)
    got = duct_commit_torch(*_t(args))
    _assert_fields_equal(ref.duct_commit_ref(*args), got, "numpy ref")
    jargs = [ref.jnp.asarray(a) for a in args]
    _assert_fields_equal(ref.duct_commit_jnp(*jargs), got, "jnp twin")
    _assert_fields_equal(
        ref.duct_commit(*jargs, use_pallas=True, interpret=True), got,
        "pallas interpret")
    _assert_fields_equal(got, duct_commit(*_t(args)), "dispatch")


@pytest.mark.parametrize("d", [1, 2, 4, 7, 8])
def test_dense_halo_select_matches_jax(d, ref):
    rng = np.random.default_rng(30 + d)
    n, L = 9, 3
    delivered = rng.random((n, d)) < 0.5
    payload = rng.integers(-5, 99, (n, d, L)).astype(np.int32)
    jp, jw = ref.dense_halo_select(ref.jnp.asarray(delivered),
                                   ref.jnp.asarray(payload))
    tp, tw = dense_halo_select(torch.as_tensor(delivered),
                               torch.as_tensor(payload))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


def test_dense_stage_matches_jax(ref):
    rng = np.random.default_rng(44)
    C = 7
    head = rng.integers(0, C, 50).astype(np.int32)
    size = rng.integers(0, C + 1, 50).astype(np.int32)
    active = rng.random(50) < 0.6
    jnp = ref.jnp
    jpos, jacc = ref.dense_stage(jnp.asarray(head), jnp.asarray(size),
                                 jnp.asarray(active), capacity=C)
    tpos, tacc = dense_stage(torch.as_tensor(head), torch.as_tensor(size),
                             torch.as_tensor(active), capacity=C)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    assert tpos.dtype == torch.int32 and tacc.dtype == torch.bool


def test_cpu_tensors_never_reach_the_kernel_loader(monkeypatch):
    """The dispatch is on the tensor's device only: CPU tensors take the
    plain version without building or loading a CUDA library, and the
    CUDA wrappers refuse CPU tensors before the loader."""
    def refuse(*a, **k):
        raise AssertionError("kernel loader reached from a CPU tensor")

    monkeypatch.setattr(tkernel, "_lib", refuse)
    monkeypatch.setattr(tkernel, "build", refuse)
    rng = np.random.default_rng(3)
    wargs = _t(random_window_state(rng, 4, 4, 8, 2, 8))
    cargs = _t(random_commit_state(rng, 8, 6, 2, 3))
    tkernel.reset_launches()
    duct_window(*wargs, max_pops=4)
    duct_commit(*cargs)
    assert tkernel.LAUNCHES == {"duct_window": 0, "duct_commit": 0}
    with pytest.raises(ValueError, match="CUDA tensors"):
        tkernel.duct_window_cuda(*wargs, max_pops=4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tkernel.duct_commit_cuda(*cargs)
    with pytest.raises(ValueError, match="cpu .* or cuda"):
        duct_window(*[a.to("meta") for a in wargs], max_pops=4)


# ---------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain version, bitwise
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA duct kernels have no "
                    "CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", WINDOW_CASES,
                         ids=["n{}-d{}-C{}-L{}-cap{}-pops{}".format(*c)
                              for c in WINDOW_CASES])
def test_duct_window_kernel_matches_plain_on_card(case, cuda_device):
    n, d, C, L, cap, max_pops = case
    rng = np.random.default_rng(1000 + sum(case))
    args = _t(random_window_state(rng, n, d, C, L, cap), cuda_device)
    want = duct_window_torch(*args, max_pops=max_pops)
    before = tkernel.LAUNCHES["duct_window"]
    got = duct_window(*args, max_pops=max_pops)
    torch.cuda.synchronize()
    assert tkernel.LAUNCHES["duct_window"] == before + 1
    for name, a, b in zip(want._fields, want, got):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("case", COMMIT_CASES,
                         ids=["R{}-C{}-L{}-W{}".format(*c) for c in COMMIT_CASES])
def test_duct_commit_kernel_matches_plain_on_card(case, cuda_device):
    R, C, L, W = case
    rng = np.random.default_rng(2000 + sum(case))
    args = _t(random_commit_state(rng, R, C, L, W), cuda_device)
    want = duct_commit_torch(*args)
    before = tkernel.LAUNCHES["duct_commit"]
    got = duct_commit(*args)
    torch.cuda.synchronize()
    assert tkernel.LAUNCHES["duct_commit"] == before + 1
    for name, a, b in zip(want._fields, want, got):
        assert torch.equal(a, b), name
