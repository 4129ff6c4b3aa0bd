"""repro_torch's edge-major duct ops against the reference's.

``duct_exchange_torch`` (the fused drain -> send over per-edge rings) must
be slot-exact, ``+inf`` popped slots included, against the reference's
Pallas ``duct_exchange_kernel`` in interpret mode, its jnp twin
``duct_exchange_jnp`` and its numpy oracle ``duct_exchange_ref``, on seeded
numpy ring states with full rings, inactive senders and receivers, and pop
budgets below the available prefix.  Its two degenerate forms (every
sender inactive, every receiver inactive) are ``duct_drain_torch`` and
``duct_send_torch``, which are also held against the reference's jnp
phases.  On the card, the ``cuda``-marked tests hold the CUDA kernel's
three entry points (routes ``full``, ``drain`` and ``send``) against the
plain versions, bitwise; they need no JAX (``python -m pytest -q -m cuda
tests/test_torch_duct_exchange.py``).  On both devices the drain returns
its input ``q_touch`` tensor and the send new rings.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.duct_exchange import kernel as tkernel  # noqa: E402
from repro_torch.kernels.duct_exchange.ops import (  # noqa: E402
    DrainResult,
    SendResult,
    duct_drain,
    duct_drain_torch,
    duct_exchange,
    duct_exchange_torch,
    duct_send,
    duct_send_torch,
)
from repro_torch.kernels import build as kbuild  # noqa: E402
from torch_cases import assert_bits_equal  # noqa: E402


def random_exchange_state(rng, E, C, cap, p_recv, p_send, p_full=0.25):
    """Per-edge rings with a random head and occupancy (a share of them
    full), random availability and touch stamps, and random activity."""
    head = rng.integers(0, C, E).astype(np.int32)
    size = rng.integers(0, cap + 1, E)
    size = np.where(rng.random(E) < p_full, cap, size).astype(np.int32)
    off = (np.arange(C)[None, :] - head[:, None]) % C
    live = off < size[:, None]
    qa = np.where(live, rng.random((E, C)) * 2, np.inf).astype(np.float32)
    qt = np.where(live, rng.integers(0, 50, (E, C)), 0).astype(np.int32)
    return (qa, qt, head, size,
            (rng.random(E) * 2).astype(np.float32),         # recv_now
            rng.random(E) < p_recv,                          # recv_active
            (rng.random(E) * 2).astype(np.float32),         # send_now
            rng.random(E) < p_send,                          # send_active
            (rng.random(E) * 0.5).astype(np.float32),       # send_lat
            rng.integers(0, 50, E).astype(np.int32))         # send_touch


#: (E, C, cap, max_pops, p_recv, p_send): pop budgets below, at and far
#: above the available prefix; all, some and no active receivers/senders;
#: one-slot rings and the paper's 64-slot buffer
EXCHANGE_CASES = [
    (37, 8, 8, 3, 0.8, 0.7),
    (40, 8, 8, 64, 1.0, 1.0),
    (16, 1, 1, 1, 0.7, 0.7),
    (33, 64, 64, 16, 0.9, 0.6),
    (25, 6, 6, 2, 0.0, 0.8),
    (25, 6, 6, 4, 0.8, 0.0),
    (30, 5, 5, 1, 0.0, 0.0),
]
IDS = ["E{}-C{}-cap{}-pops{}-recv{}-send{}".format(*c) for c in EXCHANGE_CASES]


@pytest.fixture
def ref():
    """The reference package's edge-major ops (JAX); the card machine has
    no JAX, so only the comparisons with the reference need it."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.duct_exchange import ops as rops
    from repro.kernels.duct_exchange import ref as rref
    return types.SimpleNamespace(
        jnp=jnp, jnp_exchange=rops.duct_exchange_jnp, drain=rops.duct_drain,
        send=rops.duct_send, dispatch=rops.duct_exchange,
        numpy=rref.duct_exchange_ref)


def _t(args, device="cpu"):
    return [torch.as_tensor(a, device=device) for a in args]


def _case(case, seed_base=5000):
    E, C, cap, max_pops, p_recv, p_send = case
    rng = np.random.default_rng(seed_base + E + C + max_pops)
    return random_exchange_state(rng, E, C, cap, p_recv, p_send), cap, max_pops


@pytest.mark.parametrize("case", EXCHANGE_CASES, ids=IDS)
def test_duct_exchange_bitwise_vs_reference(case, ref):
    args, cap, max_pops = _case(case)
    got = duct_exchange_torch(*_t(args), capacity=cap, max_pops=max_pops)
    kw = dict(capacity=cap, max_pops=max_pops)
    assert_bits_equal(ref.numpy(*args, **kw), got, "numpy ref")
    jargs = [ref.jnp.asarray(a) for a in args]
    assert_bits_equal(ref.jnp_exchange(*jargs, **kw), got, "jnp twin")
    # duct_exchange_kernel (the Pallas kernel) through the reference's own
    # dispatch, which names its result fields
    assert_bits_equal(ref.dispatch(*jargs, **kw, use_pallas=True,
                                    interpret=True), got, "pallas interpret")
    # the public op on CPU tensors is the plain version
    assert_bits_equal(got, duct_exchange(*_t(args), **kw), "dispatch")


def test_cases_exercise_every_branch():
    """Across the cases some rings pop, some pops stop at max_pops below
    the available prefix, some sends drop on a full ring, and some are
    accepted."""
    capped = dropped = accepted = popped = 0
    for case in EXCHANGE_CASES:
        args, cap, max_pops = _case(case)
        t = _t(args)
        r = duct_exchange_torch(*t, capacity=cap, max_pops=max_pops)
        free = duct_exchange_torch(*t, capacity=cap, max_pops=10 ** 6)
        capped += int((free.drained > r.drained).sum())
        popped += int((r.drained > 0).sum())
        dropped += int((t[7] & ~r.accepted).sum())
        accepted += int(r.accepted.sum())
    assert min(capped, dropped, accepted, popped) > 0, \
        (capped, dropped, accepted, popped)


@pytest.mark.parametrize("case", EXCHANGE_CASES, ids=IDS)
def test_degenerate_forms_are_drain_and_send(case, ref):
    """With every sender inactive the exchange is the drain; with every
    receiver inactive it is the send; both plain phases also equal the
    reference's jnp phases."""
    args, cap, max_pops = _case(case)
    (qa, qt, head, size, rnow, ract, snow, sact, slat, stouch) = args
    no = np.zeros_like(ract)
    d = duct_drain_torch(*_t((qa, qt, head, size, rnow, ract)),
                         max_pops=max_pops)
    x = duct_exchange_torch(*_t((qa, qt, head, size, rnow, ract, snow, no,
                                 slat, stouch)),
                            capacity=cap, max_pops=max_pops)
    assert_bits_equal(d, DrainResult(x.q_avail, x.q_touch, x.head, x.size,
                                      x.drained, x.recv_touch, x.pop_pos),
                       "exchange without senders")
    assert not bool(x.accepted.any()) and int(x.push_pos.abs().sum()) == 0
    s = duct_send_torch(*_t((qa, qt, head, size, snow, sact, slat, stouch)),
                        capacity=cap)
    x = duct_exchange_torch(*_t((qa, qt, head, size, rnow, no, snow, sact,
                                 slat, stouch)),
                            capacity=cap, max_pops=max_pops)
    assert_bits_equal(s, SendResult(x.q_avail, x.q_touch, x.size,
                                     x.accepted, x.push_pos),
                       "exchange without receivers")
    assert int(x.drained.sum()) == 0
    jnp = ref.jnp
    assert_bits_equal(ref.drain(*[jnp.asarray(a) for a in
                                   (qa, qt, head, size, rnow, ract)],
                                 max_pops=max_pops), d, "jnp drain")
    assert_bits_equal(ref.send(*[jnp.asarray(a) for a in
                                  (qa, qt, head, size, snow, sact, slat,
                                   stouch)], capacity=cap), s, "jnp send")
    # the public phases on CPU tensors are the plain versions
    assert_bits_equal(d, duct_drain(*_t((qa, qt, head, size, rnow, ract)),
                                     max_pops=max_pops), "drain dispatch")
    assert_bits_equal(s, duct_send(*_t((qa, qt, head, size, snow, sact,
                                         slat, stouch)), capacity=cap),
                       "send dispatch")


def test_cpu_tensors_never_reach_the_exchange_kernel(monkeypatch):
    """CPU tensors take the plain versions without building or loading the
    CUDA library; the CUDA wrapper refuses CPU tensors before the loader."""
    def refuse(*a, **k):
        raise AssertionError("kernel loader reached from a CPU tensor")

    monkeypatch.setattr(tkernel, "_lib", refuse)
    monkeypatch.setattr(tkernel, "build", refuse)
    args, cap, max_pops = _case(EXCHANGE_CASES[0])
    t = _t(args)
    tkernel.reset_launches()
    duct_exchange(*t, capacity=cap, max_pops=max_pops)
    duct_drain(*t[:6], max_pops=max_pops)
    duct_send(*t[:4], *t[6:], capacity=cap)
    assert tkernel.LAUNCHES["duct_exchange"] == 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        tkernel.duct_exchange_cuda(*t, capacity=cap, max_pops=max_pops)
    with pytest.raises(ValueError, match="cpu .* or cuda"):
        duct_exchange(*[a.to("meta") for a in t], capacity=cap,
                      max_pops=max_pops)


@pytest.mark.parametrize("case", EXCHANGE_CASES, ids=IDS)
def test_drain_returns_its_q_touch_and_send_new_rings(case):
    """The aliasing contract the card must honour too: the drain hands back
    its input q_touch (it never changes it), the send writes new rings and
    leaves its inputs as they were."""
    args, cap, max_pops = _case(case)
    t = _t(args)
    kept = [a.clone() for a in t]
    d = duct_drain(*t[:6], max_pops=max_pops)
    assert d.q_touch is t[1]
    s = duct_send(*t[:4], *t[6:], capacity=cap)
    assert s.q_avail is not t[0] and s.q_touch is not t[1]
    assert s.q_avail.data_ptr() != t[0].data_ptr()
    assert s.q_touch.data_ptr() != t[1].data_ptr()
    for a, b in zip(kept, t):
        assert torch.equal(a, b)


def test_new_wrappers_refuse_cpu_tensors_and_bad_shapes_before_loading(
        monkeypatch):
    """duct_drain_cuda and duct_send_cuda check the rings' shape, the
    32-bit index range and the device before the library is built or
    loaded."""
    def refuse(*a, **k):
        raise AssertionError("kernel loader reached")

    monkeypatch.setattr(tkernel, "_lib", refuse)
    monkeypatch.setattr(tkernel, "build", refuse)
    args, cap, max_pops = _case(EXCHANGE_CASES[0])
    t = _t(args)
    drain = lambda *r: tkernel.duct_drain_cuda(  # noqa: E731
        *r, *t[2:6], max_pops=max_pops)
    send = lambda *r: tkernel.duct_send_cuda(  # noqa: E731
        *r, *t[2:4], *t[6:], capacity=cap)
    huge = torch.zeros(1).expand(2 ** 16, 2 ** 15)      # E * C = 2^31
    for call in (drain, send):
        with pytest.raises(ValueError, match="CUDA tensors"):
            call(t[0], t[1])
        with pytest.raises(ValueError, match=r"rings \(E, C\)"):
            call(t[0].reshape(-1), t[1])
        with pytest.raises(ValueError, match="32 bits"):
            call(huge, t[1])
    assert tkernel.LAUNCHES["duct_exchange"] == 0


# ---------------------------------------------------------------------------
# On the card: the CUDA kernel against the plain versions, bitwise
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA duct kernels have no "
                    "CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", EXCHANGE_CASES, ids=IDS)
def test_duct_exchange_kernel_matches_plain_on_card(case, cuda_device):
    args, cap, max_pops = _case(case)
    t = _t(args, cuda_device)
    before = tkernel.LAUNCHES["duct_exchange"]
    assert_bits_equal(duct_exchange_torch(*t, capacity=cap,
                                           max_pops=max_pops),
                       duct_exchange(*t, capacity=cap, max_pops=max_pops),
                       "exchange")
    assert_bits_equal(duct_drain_torch(*t[:6], max_pops=max_pops),
                       duct_drain(*t[:6], max_pops=max_pops), "drain")
    assert_bits_equal(duct_send_torch(*t[:4], *t[6:], capacity=cap),
                       duct_send(*t[:4], *t[6:], capacity=cap), "send")
    torch.cuda.synchronize()
    assert tkernel.LAUNCHES["duct_exchange"] == before + 3


#: rings wider than the register-held drain's 64 slots, which the drain
#: and the fused form walk a slot at a time (C 200 and 400 even, C 601
#: odd, which the send also copies a slot at a time);
#: (E, C, cap, max_pops, p_recv, p_send)
WIDE_CASES = [(9, 200, 200, 150, 0.9, 0.7), (11, 400, 400, 300, 0.8, 0.8),
              (7, 601, 601, 500, 0.9, 0.7)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", EXCHANGE_CASES + WIDE_CASES,
                         ids=IDS + ["E{}-C{}-wide".format(*c[:2])
                                    for c in WIDE_CASES])
def test_each_entry_point_is_one_launch_on_its_route(case, cuda_device):
    """ops.duct_drain, duct_send and duct_exchange each launch their own
    entry point once (routes drain, send, full), bitwise equal to the
    plain versions; the drain returns its input q_touch, the send new
    rings."""
    args, cap, max_pops = _case(case)
    t = _t(args, cuda_device)
    for route, run, plain in (
            ("drain", lambda: duct_drain(*t[:6], max_pops=max_pops),
             lambda: duct_drain_torch(*t[:6], max_pops=max_pops)),
            ("send", lambda: duct_send(*t[:4], *t[6:], capacity=cap),
             lambda: duct_send_torch(*t[:4], *t[6:], capacity=cap)),
            ("full", lambda: duct_exchange(*t, capacity=cap,
                                           max_pops=max_pops),
             lambda: duct_exchange_torch(*t, capacity=cap,
                                         max_pops=max_pops))):
        kbuild.reset_launches()
        got = run()
        torch.cuda.synchronize()
        assert kbuild.ROUTES == {f"duct_exchange/{route}": 1}, route
        assert kbuild.LAUNCHES["duct_exchange"] == 1
        assert_bits_equal(plain(), got, route)
        if route == "drain":
            assert got.q_touch is t[1]
        if route == "send":
            assert got.q_avail.data_ptr() != t[0].data_ptr()
            assert got.q_touch.data_ptr() != t[1].data_ptr()


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [1, 2], ids=["4-bytes", "8-bytes"])
def test_rings_inside_their_buffer_take_the_slot_path(shift, cuda_device):
    """Rings that are contiguous but start ``shift`` slots into their
    buffer (not 16-byte aligned; at 4 bytes not even 8): every entry point
    still launches once, bitwise equal to the plain versions, instead of
    faulting on a misaligned vector load."""
    args, cap, max_pops = _case((33, 64, 64, 16, 0.9, 0.6))
    t = _t(args, cuda_device)
    for i in (0, 1):                      # q_avail, q_touch
        flat = torch.zeros(t[i].numel() + shift, dtype=t[i].dtype,
                           device=cuda_device)
        shifted = flat[shift:].view_as(t[i])
        shifted.copy_(t[i])
        assert shifted.data_ptr() % 16 != 0
        t[i] = shifted
    for route, run, plain in (
            ("drain", lambda: duct_drain(*t[:6], max_pops=max_pops),
             lambda: duct_drain_torch(*t[:6], max_pops=max_pops)),
            ("send", lambda: duct_send(*t[:4], *t[6:], capacity=cap),
             lambda: duct_send_torch(*t[:4], *t[6:], capacity=cap)),
            ("full", lambda: duct_exchange(*t, capacity=cap,
                                           max_pops=max_pops),
             lambda: duct_exchange_torch(*t, capacity=cap,
                                         max_pops=max_pops))):
        kbuild.reset_launches()
        got = run()
        torch.cuda.synchronize()
        assert kbuild.ROUTES == {f"duct_exchange/{route}": 1}, route
        assert_bits_equal(plain(), got, route)
