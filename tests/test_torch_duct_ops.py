"""repro_torch duct ops against the reference's three implementations.

The port's plain torch versions of the dense-layout window and commit ops
(``duct_window_torch`` / ``duct_commit_torch``) must be slot-exact (bitwise,
``+inf`` writes included) against the reference's numpy oracles, its jnp
twins, and its Pallas kernels run in interpret mode, on the same random
ring states made with numpy, with int32 (graph coloring) and float32 (evo)
payloads.  A float32 ``-0.0`` payload is where select and one-hot sum
part: the window's halo select sums in the Pallas kernel, the jnp twin and
the plain version (``+0.0``) and copies in the numpy oracle and the CUDA
kernel (``-0.0``).  On the CPU the public ``duct_window`` /
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
from torch_cases import assert_bits_equal  # noqa: E402


def random_payload(rng, shape, dtype):
    """Random payload rows: small ints for int32, normals for float32."""
    if np.dtype(dtype) == np.float32:
        return rng.standard_normal(shape).astype(np.float32)
    return rng.integers(0, 99, shape).astype(np.int32)


def random_window_state(rng, n, d, C, L, cap, pay_dtype=np.int32):
    """A random dense ring state with an engine-style staged push (eager
    drop-iff-full against the carried size, already counted in size)."""
    qa = np.full((n, d, C), np.inf, np.float32)
    qt = np.zeros((n, d, C), np.int32)
    qp = np.zeros((n, d, C, L), pay_dtype)
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
                qp[p, j, pos] = random_payload(rng, L, pay_dtype)
    pacc = (rng.random((n, d)) < 0.7) & (size < cap)
    ppos = ((head + size) % C).astype(np.int32)
    size = (size + pacc).astype(np.int32)
    pav = (rng.random((n, d)) * 2).astype(np.float32)
    ptch = rng.integers(0, 50, (n, d)).astype(np.int32)
    ppay = random_payload(rng, (n, d, L), pay_dtype)
    rnow = (rng.random(n) * 2).astype(np.float32)
    ract = rng.random(n) < 0.8
    return (qa, qt, qp, head, size, ppos, pacc, pav, ptch, ppay, rnow, ract)


def random_commit_state(rng, R, C, L, W, pay_dtype=np.int32):
    qa = (rng.random((R, C)) * 2).astype(np.float32)
    qt = rng.integers(0, 50, (R, C)).astype(np.int32)
    qp = random_payload(rng, (R, C, L), pay_dtype)
    head = rng.integers(0, C, R).astype(np.int32)
    size0 = rng.integers(0, C, R).astype(np.int32)
    # the engine guarantees pb_cnt pushes fit behind the frozen tail
    cnt = np.minimum(rng.integers(0, W + 1, R), C - size0).astype(np.int32)
    pa = (rng.random((R, W)) * 2).astype(np.float32)
    pt = rng.integers(0, 50, (R, W)).astype(np.int32)
    pp = random_payload(rng, (R, W, L), pay_dtype)
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


#: float32 payloads: evo's halo rows at small widths and its L = 60
F32_WINDOW_CASES = [(6, 4, 8, 8, 8, 3), (5, 8, 6, 4, 6, 64),
                    (4, 4, 64, 60, 64, 16)]
F32_COMMIT_CASES = [(24, 6, 5, 5), (16, 64, 60, 8)]


@pytest.mark.parametrize("case", F32_WINDOW_CASES,
                         ids=["n{}-d{}-C{}-L{}-cap{}-pops{}".format(*c)
                              for c in F32_WINDOW_CASES])
def test_duct_window_f32_bitwise_vs_reference(case, ref):
    n, d, C, L, cap, max_pops = case
    rng = np.random.default_rng(3000 + sum(case))
    args = random_window_state(rng, n, d, C, L, cap, np.float32)
    got = duct_window_torch(*_t(args), max_pops=max_pops)
    assert got.q_pay.dtype == got.halo_pay.dtype == torch.float32
    assert bool(got.halo_win.any())
    jargs = [ref.jnp.asarray(a) for a in args]
    assert_bits_equal(
        ref.duct_window(*jargs, max_pops=max_pops, use_pallas=True,
                        interpret=True), got, "pallas interpret")
    assert_bits_equal(ref.duct_window_jnp(*jargs, max_pops=max_pops), got,
                       "jnp twin")
    assert_bits_equal(ref.duct_window_ref(*args, max_pops=max_pops), got,
                       "numpy ref")
    assert_bits_equal(got, duct_window(*_t(args), max_pops=max_pops),
                       "dispatch")


@pytest.mark.parametrize("case", F32_COMMIT_CASES,
                         ids=["R{}-C{}-L{}-W{}".format(*c)
                              for c in F32_COMMIT_CASES])
def test_duct_commit_f32_bitwise_vs_reference(case, ref):
    R, C, L, W = case
    rng = np.random.default_rng(4000 + sum(case))
    args = random_commit_state(rng, R, C, L, W, np.float32)
    got = duct_commit_torch(*_t(args))
    assert got.q_pay.dtype == torch.float32
    jargs = [ref.jnp.asarray(a) for a in args]
    assert_bits_equal(ref.duct_commit(*jargs, use_pallas=True,
                                       interpret=True), got,
                       "pallas interpret")
    assert_bits_equal(ref.duct_commit_jnp(*jargs), got, "jnp twin")
    assert_bits_equal(ref.duct_commit_ref(*args), got, "numpy ref")
    assert_bits_equal(got, duct_commit(*_t(args)), "dispatch")


def window_kernel_emulation(args, max_pops):
    """The CUDA window kernel's arithmetic in numpy, a ring row at a time
    as its warp runs it: the drain by 32-slot ballot rounds (the pop count
    is the first blocked lane's position), every output word written once
    (the push folded into the copy of the ring row, the payload copied in
    4-word vectors where C*L % 4 == 0), and the halo payload read from the
    input ring, or from push_pay when the freshest popped slot is the
    pushed one."""
    (qa, qt, qp, head, size, ppos, pacc, pav, ptch, ppay, rnow,
     ract) = [np.asarray(a) for a in args]
    n, d, C = qa.shape
    L = qp.shape[-1]
    CL = C * L
    vec = CL % 4 == 0
    out = dict(q_avail=np.empty_like(qa), q_touch=np.empty_like(qt),
               q_pay=np.empty_like(qp), head=np.empty_like(head),
               size=np.empty_like(size), drained=np.empty_like(size),
               recv_touch=np.empty_like(size),
               halo_pay=np.empty((n, 4, L), qp.dtype),
               halo_win=np.empty((n, 4), bool))
    dr_all = np.zeros((n, d), np.int64)
    fresh_src = {}
    for i in range(n):
        for j in range(d):
            h, sz, pp = int(head[i, j]), int(size[i, j]), int(ppos[i, j])
            push = bool(pacc[i, j]) and 0 <= pp < C

            def avail(s):
                return pav[i, j] if push and s == pp else qa[i, j, s]
            dr = 0
            if ract[i]:
                lim = min(sz, max_pops)
                dr = max(lim, 0)
                for base in range(0, lim, 32):
                    lanes = np.arange(base, base + 32)
                    blocked = [bool(jj < lim and avail((h + jj) % C) > rnow[i])
                               for jj in lanes]
                    if any(blocked):
                        dr = base + blocked.index(True)
                        break
            fresh = (h + dr - 1) % C
            for c in range(C):
                pushed = push and c == pp
                out["q_avail"][i, j, c] = (np.inf if (c - h) % C < dr
                                           else avail(c))
                out["q_touch"][i, j, c] = ptch[i, j] if pushed else qt[i, j, c]
            words_in = qp[i, j].reshape(-1)
            words = out["q_pay"][i, j].reshape(-1)
            lo = pp * L if push else CL
            step = 4 if vec else 1
            for e0 in range(0, CL, step):
                for e in range(e0, e0 + step):
                    words[e] = (ppay[i, j, e - lo] if 0 <= e - lo < L
                                else words_in[e])
            fp = push and fresh == pp
            out["recv_touch"][i, j] = (
                (ptch[i, j] if fp else qt[i, j, fresh]) if dr > 0 else 0)
            out["head"][i, j] = (h + dr) % C
            out["size"][i, j] = sz - dr
            out["drained"][i, j] = dr
            dr_all[i, j] = dr
            fresh_src[i, j] = ppay[i, j] if fp else qp[i, j, fresh]
    for i in range(n):
        for s in range(4):
            win = max((j for j in range(s, d, 4) if dr_all[i, j] > 0),
                      default=-1)
            out["halo_win"][i, s] = win >= 0
            out["halo_pay"][i, s] = (fresh_src[i, win] if win >= 0 else 0)
    return out


#: the kernel's edge cases (n, d, C, L, cap, max_pops): C = 5 with L = 3
#: (C*L not a multiple of 4: word copies), C = 33 (two 32-slot ballot
#: rounds), d = 9 and d = 33 (more rows than a block's warps), n = 7 (not a
#: multiple of the 2 receivers a block holds at d = 4)
EDGE_WINDOW_CASES = [(5, 4, 5, 3, 5, 64), (4, 2, 33, 2, 33, 64),
                     (3, 9, 8, 2, 8, 16), (3, 33, 8, 2, 8, 16),
                     (7, 4, 8, 1, 8, 8)]
EMULATION_CASES = ([c + (np.int32,) for c in WINDOW_CASES + EDGE_WINDOW_CASES]
                   + [c + (np.float32,) for c in
                      F32_WINDOW_CASES + EDGE_WINDOW_CASES[:2]])


def edge_window_state(case):
    """A random ring state for an (n, d, C, L, cap, max_pops, payload
    dtype) case in which every other receiver finds all its slots
    available and, where C > 32, receiver 0's rings are full, so that a
    drain takes two ballot rounds."""
    n, d, C, L, cap, max_pops, pay = case
    rng = np.random.default_rng(5000 + sum(case[:6]))
    args = list(random_window_state(rng, n, d, C, L, cap, pay))
    args[10][::2] = 3.0
    if C > 32:
        args[0][0] = (rng.random((d, C)) * 2).astype(np.float32)
        args[4][0] = C
        args[6][0] = False
    return args


def _case_id(c):
    return "n{}-d{}-C{}-L{}-cap{}-pops{}-{}".format(*c[:6],
                                                     np.dtype(c[6]).name)


@pytest.mark.parametrize("case", EMULATION_CASES, ids=_case_id)
def test_duct_window_kernel_emulation_equals_plain(case):
    n, d, C, L, cap, max_pops, pay = case
    args = edge_window_state(case)
    got = window_kernel_emulation(args, max_pops)
    want = duct_window_torch(*_t(args), max_pops=max_pops)
    if C == 33:
        assert int(want.drained.max()) > 32      # a second ballot round
    for name, a in zip(want._fields, want):
        np.testing.assert_array_equal(got[name], a.numpy(),
                                      err_msg=f"field {name}")
        assert got[name].dtype == a.numpy().dtype, name


def commit_kernel_emulation(args, vec=None):
    """The CUDA commit kernel's walk in numpy, a ring row at a time as its
    warp runs it: avail and touch slot by slot; the row's C * L payload
    words as 4-word chunks (where L % 4 == 0, or ``vec``), each chunk
    copied from the slot's pushbuf entry min(j, W - 1) when its pushbuf
    index j = (c - head - size0) mod C is below pb_cnt, else from the ring;
    4-byte words otherwise."""
    (qa, qt, qp, head, size0, cnt, pa, pt, pp) = [np.asarray(a)
                                                   for a in args]
    R, C = qa.shape
    W = pa.shape[1]
    L = qp.shape[-1]
    vec = L % 4 == 0 if vec is None else vec
    out = dict(q_avail=np.empty_like(qa), q_touch=np.empty_like(qt),
               q_pay=np.empty_like(qp))
    for r in range(R):
        base, n = int(head[r]) + int(size0[r]), int(cnt[r])

        def src(c):
            j = (c - base) % C               # a floor-mod, as in the kernel
            return min(j, W - 1) if j < n else -1
        for c in range(C):
            j = src(c)
            out["q_avail"][r, c] = pa[r, j] if j >= 0 else qa[r, c]
            out["q_touch"][r, c] = pt[r, j] if j >= 0 else qt[r, c]
        ring, push = qp[r].reshape(-1), pp[r].reshape(-1)
        words = out["q_pay"][r].reshape(-1)
        step = 4 if vec else 1
        for e in range(0, C * L, step):
            c, l = divmod(e, L)
            j = src(c)
            words[e:e + step] = (push[j * L + l:j * L + l + step] if j >= 0
                                 else ring[e:e + step])
    return out


#: (R, C, L, W, payload, kind): every ring's tail wrapping past slot C - 1,
#: pushbufs empty or full (pb_cnt 0 and W), pb_cnt above W (the j >= W
#: clamp), word copies (L 1 and 3) and 16-byte chunks (L 4 and 60)
COMMIT_EMULATION_CASES = [
    (6, 8, 1, 3, np.int32, "wrap"), (6, 8, 60, 3, np.float32, "wrap"),
    (8, 16, 1, 4, np.int32, "empty-full"),
    (8, 16, 60, 4, np.float32, "empty-full"),
    (5, 12, 3, 2, np.int32, "clamp"), (5, 12, 60, 2, np.float32, "clamp"),
    (16, 64, 4, 8, np.int32, "random"),
    (16, 64, 60, 8, np.float32, "random")]


def commit_emulation_state(case):
    """A random commit state shaped by the case's kind."""
    R, C, L, W, pay, kind = case
    rng = np.random.default_rng(6000 + R + C + L + W)
    args = list(random_commit_state(rng, R, C, L, W, pay))
    head, size0, cnt = args[3], args[4], args[5]
    if kind == "wrap":           # head + size0 < C <= head + size0 + cnt
        cnt[:] = W
        size0[:] = rng.integers(0, C - W, R)
        head[:] = C - size0 - 1 - rng.integers(0, W - 1, R)
    elif kind == "empty-full":
        size0[:] = rng.integers(0, C - W + 1, R)
        cnt[:] = np.where(np.arange(R) % 2 == 0, 0, W)
    elif kind == "clamp":        # W < pb_cnt <= C - size0
        size0[:] = rng.integers(0, C - W - 2, R)
        cnt[:] = np.minimum(W + 1 + rng.integers(0, 4, R), C - size0)
    return args


@pytest.mark.parametrize("case", COMMIT_EMULATION_CASES,
                         ids=lambda c: "R{}-C{}-L{}-W{}-{}-{}".format(
                             *c[:4], np.dtype(c[4]).name, c[5]))
def test_duct_commit_kernel_emulation_equals_plain(case, ref):
    """Bitwise: the emulated warp-a-row walk against the plain version and
    the Pallas kernel in interpret mode.  Where pb_cnt exceeds W (never on
    the engine's path) the plain version and the CUDA kernel clamp j to W -
    1 while the Pallas kernel's loop over j < W leaves those slots as they
    were: there the Pallas kernel is held on the other slots only."""
    args = commit_emulation_state(case)
    R, C, L, W, pay, kind = case
    head, size0, cnt = args[3], args[4], args[5]
    if kind == "wrap":
        assert ((head + size0 < C) & (head + size0 + cnt > C)).all()
    if kind == "clamp":
        assert (cnt > W).all()
    got = commit_kernel_emulation(args)
    want = duct_commit_torch(*_t(args))
    for name, a in zip(want._fields, want):
        assert got[name].dtype == a.numpy().dtype, name
        np.testing.assert_array_equal(got[name].view(np.int32),
                                      a.numpy().view(np.int32),
                                      err_msg=f"plain: field {name}")
    if L % 4 == 0:      # the kernel's word walk, where a payload array
        words = commit_kernel_emulation(args, vec=False)  # is unaligned
        for name in got:
            np.testing.assert_array_equal(words[name].view(np.int32),
                                          got[name].view(np.int32))
    pallas = ref.duct_commit(*[ref.jnp.asarray(a) for a in args],
                             use_pallas=True, interpret=True)
    j = (np.arange(C)[None, :] - (head + size0)[:, None]) % C
    keep = ~((j >= W) & (j < cnt[:, None]))     # slots the clamp writes
    assert (kind == "clamp") == bool((~keep).any())
    for name, a in zip(want._fields, pallas):
        a = np.asarray(a).view(np.int32)
        b = got[name].view(np.int32)
        m = keep if a.ndim == 2 else keep[..., None].repeat(L, -1)
        np.testing.assert_array_equal(b[m], a[m],
                                      err_msg=f"pallas: field {name}")


def negative_zero_window_state():
    """One receiver of degree 4 whose row 0 holds one available message
    with payload ``[-0.0, 1.5, -0.0]``; the drain pops it into halo slot
    0."""
    n, d, C, L = 1, 4, 8, 3
    qa = np.full((n, d, C), np.inf, np.float32)
    qa[0, 0, 0] = 0.0
    qp = np.zeros((n, d, C, L), np.float32)
    qp[0, 0, 0] = [-0.0, 1.5, -0.0]
    size = np.zeros((n, d), np.int32)
    size[0, 0] = 1
    z = np.zeros((n, d), np.int32)
    return (qa, np.zeros((n, d, C), np.int32), qp, z, size, z,
            np.zeros((n, d), bool), np.zeros((n, d), np.float32), z,
            np.zeros((n, d, L), np.float32), np.ones(n, np.float32),
            np.ones(n, bool))


def negative_zero_commit_state():
    """Two rings whose pushbuf entries carry ``-0.0`` payload lanes."""
    R, C, L, W = 2, 4, 2, 2
    pp = np.full((R, W, L), -0.0, np.float32)
    pp[:, :, 1] = 2.5
    return (np.full((R, C), np.inf, np.float32), np.zeros((R, C), np.int32),
            np.ones((R, C, L), np.float32), np.array([0, 3], np.int32),
            np.array([1, 2], np.int32), np.array([2, 1], np.int32),
            np.zeros((R, W), np.float32), np.ones((R, W), np.int32), pp)


def test_negative_zero_payloads(ref):
    """The window's halo select: the plain version sums a one-hot as the
    Pallas kernel does (``-0.0`` comes out ``+0.0``); the numpy oracle
    copies (``-0.0`` stays).  The commit copies everywhere but in the jnp
    twin, so the plain version keeps ``-0.0`` as the Pallas kernel does."""
    args = negative_zero_window_state()
    got = duct_window_torch(*_t(args), max_pops=4)
    assert bool(got.halo_win[0, 0])
    assert not np.signbit(got.halo_pay[0, 0].numpy()).any()
    jargs = [ref.jnp.asarray(a) for a in args]
    assert_bits_equal(ref.duct_window(*jargs, max_pops=4, use_pallas=True,
                                       interpret=True), got,
                       "pallas interpret")
    want = ref.duct_window_ref(*args, max_pops=4)
    assert np.signbit(want.halo_pay[0, 0, [0, 2]]).all()
    np.testing.assert_array_equal(got.halo_pay.numpy(), want.halo_pay)

    cargs = negative_zero_commit_state()
    got = duct_commit_torch(*_t(cargs))
    assert np.signbit(got.q_pay.numpy()[0, 1, 0])
    assert_bits_equal(ref.duct_commit(*[ref.jnp.asarray(a) for a in cargs],
                                       use_pallas=True, interpret=True), got,
                       "pallas interpret")
    assert_bits_equal(ref.duct_commit_ref(*cargs), got, "numpy ref")


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
    assert tkernel.LAUNCHES == {"duct_window": 0, "duct_commit": 0,
                                "duct_exchange": 0}
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
@pytest.mark.parametrize("case", [c for c in EMULATION_CASES
                                  if c[:6] in EDGE_WINDOW_CASES],
                         ids=_case_id)
def test_duct_window_kernel_edge_cases_on_card(case, cuda_device):
    """Word copies (C*L % 4 != 0), two ballot rounds, d = 9 and 33 (warps
    looping over rows), n not a multiple of the receivers a block holds,
    int32 and float32: bitwise the plain version, twice the same."""
    n, d, C, L, cap, max_pops, pay = case
    args = _t(edge_window_state(case), cuda_device)
    want = duct_window_torch(*args, max_pops=max_pops)
    before = tkernel.LAUNCHES["duct_window"]
    got = duct_window(*args, max_pops=max_pops)
    again = duct_window(*args, max_pops=max_pops)
    torch.cuda.synchronize()
    assert tkernel.LAUNCHES["duct_window"] == before + 2
    assert_bits_equal(want, got, "duct_window")
    assert_bits_equal(got, again, "duct_window twice")


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


@pytest.mark.cuda
@pytest.mark.parametrize("case", F32_WINDOW_CASES,
                         ids=["n{}-d{}-C{}-L{}-cap{}-pops{}".format(*c)
                              for c in F32_WINDOW_CASES])
def test_duct_window_f32_kernel_matches_plain_on_card(case, cuda_device):
    n, d, C, L, cap, max_pops = case
    rng = np.random.default_rng(3000 + sum(case))
    args = _t(random_window_state(rng, n, d, C, L, cap, np.float32),
              cuda_device)
    want = duct_window_torch(*args, max_pops=max_pops)
    got = duct_window(*args, max_pops=max_pops)
    torch.cuda.synchronize()
    assert_bits_equal(want, got, "duct_window_f32")


@pytest.mark.cuda
@pytest.mark.parametrize("case", F32_COMMIT_CASES,
                         ids=["R{}-C{}-L{}-W{}".format(*c)
                              for c in F32_COMMIT_CASES])
def test_duct_commit_f32_kernel_matches_plain_on_card(case, cuda_device):
    R, C, L, W = case
    rng = np.random.default_rng(4000 + sum(case))
    args = _t(random_commit_state(rng, R, C, L, W, np.float32), cuda_device)
    want = duct_commit_torch(*args)
    got = duct_commit(*args)
    torch.cuda.synchronize()
    assert_bits_equal(want, got, "duct_commit_f32")


@pytest.mark.cuda
@pytest.mark.parametrize("case", COMMIT_EMULATION_CASES,
                         ids=lambda c: "R{}-C{}-L{}-W{}-{}-{}".format(
                             *c[:4], np.dtype(c[4]).name, c[5]))
def test_duct_commit_kernel_edge_cases_on_card(case, cuda_device):
    """Tails wrapping past slot C - 1, pb_cnt 0 and W, pb_cnt above W (the
    clamp), word copies (L 1, 3) and 16-byte chunks (L 4, 60), int32 and
    float32: bitwise the plain version, twice the same."""
    args = _t(commit_emulation_state(case), cuda_device)
    want = duct_commit_torch(*args)
    before = tkernel.LAUNCHES["duct_commit"]
    got = duct_commit(*args)
    again = duct_commit(*args)
    torch.cuda.synchronize()
    assert tkernel.LAUNCHES["duct_commit"] == before + 2
    assert_bits_equal(want, got, "duct_commit")
    assert_bits_equal(got, again, "duct_commit twice")


@pytest.mark.cuda
def test_duct_commit_kernel_word_walk_on_card(cuda_device):
    """A payload array 16-byte aligned in no row (a view one word in)
    takes the kernel's word walk at L = 60: bitwise the plain version."""
    R, C, L, W = 16, 64, 60, 8
    args = _t(commit_emulation_state((R, C, L, W, np.float32, "random")),
              cuda_device)
    pay = torch.empty(R * C * L + 1, dtype=torch.float32, device=cuda_device)
    pay[1:] = args[2].reshape(-1)
    args[2] = pay[1:].view(R, C, L)
    assert args[2].data_ptr() % 16 and args[2].is_contiguous()
    assert_bits_equal(duct_commit_torch(*args), duct_commit(*args),
                       "duct_commit word walk")


@pytest.mark.cuda
def test_negative_zero_payloads_on_card(cuda_device):
    """The CUDA window kernel copies the winning payload, so ``-0.0``
    stays ``-0.0`` (equal as a number to the plain version's ``+0.0``);
    the CUDA commit kernel copies like the plain version."""
    args = _t(negative_zero_window_state(), cuda_device)
    want = duct_window_torch(*args, max_pops=4)
    got = duct_window(*args, max_pops=4)
    torch.cuda.synchronize()
    hp = got.halo_pay[0, 0].cpu().numpy()
    np.testing.assert_array_equal(np.signbit(hp), [True, False, True])
    for name, a, b in zip(want._fields, want, got):
        assert torch.equal(a, b), name
    cargs = _t(negative_zero_commit_state(), cuda_device)
    assert_bits_equal(duct_commit_torch(*cargs), duct_commit(*cargs),
                       "duct_commit_f32")


@pytest.mark.cuda
def test_kernels_refuse_other_payload_dtypes(cuda_device):
    rng = np.random.default_rng(9)
    wargs = _t(random_window_state(rng, 2, 4, 8, 2, 8), cuda_device)
    wargs[2], wargs[9] = wargs[2].double(), wargs[9].double()
    with pytest.raises(TypeError, match="int32 or float32"):
        tkernel.duct_window_cuda(*wargs, max_pops=4)
    cargs = _t(random_commit_state(rng, 4, 6, 2, 3), cuda_device)
    cargs[2], cargs[8] = cargs[2].long(), cargs[8].long()
    with pytest.raises(TypeError, match="int32 or float32"):
        tkernel.duct_commit_cuda(*cargs)
