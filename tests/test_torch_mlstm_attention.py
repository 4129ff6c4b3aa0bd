"""repro_torch's mLSTM sequence mix against the reference's.

The port's plain version (``mlstm_attention_torch``) is the reference
oracle's materialised form in float32, so on the same inputs, made with
numpy from a seed (the distributions of tests/test_kernel_mlstm.py), it
must agree with ``mlstm_attention_ref`` and with
``mlstm_attention_kernel(..., interpret=True)`` within that test's bounds:
1e-4 relative and 1e-5 absolute in float32, 3e-2 in bf16 (the three
differ in the order of float32 sums; in bf16 each rounds its float32
result once, and an output near a rounding boundary can land one bf16 ulp
apart).  In the model's layout it reproduces ``ssm._mlstm_chunk``, the
reference model's own mix.  The CUDA kernel takes any S, where the Pallas
kernel asserts S % bq == 0, so a ragged S is held against the oracle.  On
the CPU the dispatching wrapper takes the plain version and never reaches
the kernel loader.  The ``cuda``-marked tests at the end hold the CUDA
kernel against the plain version on the card; they need no JAX
(``python -m pytest -q -m cuda tests/test_torch_mlstm_attention.py``).
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cases  # noqa: E402,F401  (caps torch's CPU threads)

from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels.mlstm_attention import (  # noqa: E402
    mlstm_attention,
    mlstm_attention_plain,
    mlstm_attention_torch,
)
from repro_torch.kernels.mlstm_attention import kernel as mkernel  # noqa: E402
from repro_torch.kernels.mlstm_attention import ops as mops  # noqa: E402

TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}
#: (BH, S, hd, bq, bk): tests/test_kernel_mlstm.py's shapes
CASES = [(4, 256, 64, 128, 128), (2, 512, 128, 128, 64),
         (8, 128, 32, 128, 128)]


@pytest.fixture
def ref():
    """The reference's mix (JAX); the card machine has no JAX, so only the
    comparisons with the reference need it."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.mlstm_attention.kernel import mlstm_attention_kernel
    from repro.kernels.mlstm_attention.ref import mlstm_attention_ref
    from repro.models.ssm import _mlstm_chunk
    return types.SimpleNamespace(jnp=jnp, kernel=mlstm_attention_kernel,
                                 oracle=mlstm_attention_ref,
                                 chunk=_mlstm_chunk)


def inputs(seed, BH, S, hd):
    """q, k (scaled by hd**-0.5), v; F = cumsum(log_sigmoid(n + 3)) and
    I = 0.5 n, float32, as the repo's kernel test draws them."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((BH, S, hd))
    k = rng.standard_normal((BH, S, hd)) * hd ** -0.5
    v = rng.standard_normal((BH, S, hd))
    log_f = -np.logaddexp(0.0, -(rng.standard_normal((BH, S)) + 3.0))
    F = np.cumsum(log_f, axis=1)
    I = rng.standard_normal((BH, S)) * 0.5
    return [a.astype(np.float32) for a in (q, k, v, F, I)]


def as_torch(arrays, dtype="float32", device="cpu"):
    """q, k, v in ``dtype``, F and I float32."""
    ts = [torch.as_tensor(a).to(device) for a in arrays]
    return [t.to(getattr(torch, dtype)) for t in ts[:3]] + ts[3:]


def as_jax(ref, arrays, dtype="float32"):
    js = [ref.jnp.asarray(a) for a in arrays]
    return [j.astype(dtype) for j in js[:3]] + js[3:]


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_plain_matches_oracle_and_pallas_kernel(case, dtype, ref):
    BH, S, hd, bq, bk = case
    arrays = inputs(0, BH, S, hd)
    got = mlstm_attention_torch(*as_torch(arrays, dtype))
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == (BH, S, hd)
    js = as_jax(ref, arrays, dtype)
    for want in (ref.oracle(*js),
                 ref.kernel(*js, bq=bq, bk=bk, interpret=True)):
        np.testing.assert_allclose(f32(got), f32(want), **TOL[dtype])


def to_model(a, B, H):
    """(B * H, S, ...) numpy -> (B, S, H, ...)."""
    S = a.shape[1]
    return np.moveaxis(a.reshape(B, H, S, *a.shape[2:]), 1, 2)


def test_model_layout_matches_reference_model_chunk(ref):
    """In the model's layout (B, S, H, hd) the dispatching wrapper
    reproduces ``repro.models.ssm._mlstm_chunk``, the reference model's
    mix, as tests/test_kernel_mlstm.py holds the Pallas kernel to it."""
    B, S, H, hd = 2, 128, 4, 32
    arrays = [np.ascontiguousarray(to_model(a, B, H))
              for a in inputs(3, B * H, S, hd)]
    got = mlstm_attention(*as_torch(arrays))
    assert tuple(got.shape) == (B, S, H, hd)
    q, k, v, F, I = [ref.jnp.asarray(a) for a in arrays]
    pos = ref.jnp.arange(S)
    want = ref.chunk(q, F, k, v, I, F, pos, pos)
    np.testing.assert_allclose(f32(got), f32(want), **TOL["float32"])


@pytest.mark.parametrize("S", [1, 37])
def test_ragged_length_matches_oracle(S, ref):
    """An S that no query tile divides: the port takes it."""
    arrays = inputs(1, 3, S, 32)
    got = mlstm_attention_torch(*as_torch(arrays))
    want = ref.oracle(*as_jax(ref, arrays))
    np.testing.assert_allclose(f32(got), f32(want), **TOL["float32"])


def test_very_negative_input_gate_gives_no_nan(ref):
    """A row whose first live key has a very negative log input gate: the
    stabilizer m is that key's D, and where exp(-m) overflows the
    output is 0, as in the reference; never NaN."""
    arrays = inputs(2, 2, 40, 16)
    arrays[4][:, 0] = -1e4          # the first key of every row
    arrays[4][1, :] = -200.0        # every key of row 1: exp(-m) = inf
    got = mlstm_attention_torch(*as_torch(arrays))
    assert bool(torch.isfinite(got).all())
    want = f32(ref.oracle(*as_jax(ref, arrays)))
    assert np.isfinite(want).all()
    np.testing.assert_allclose(f32(got), want, **TOL["float32"])
    assert not got[1].any() and got[0, 1:].abs().max() > 0


def test_dispatch_never_launches_on_cpu():
    arrays = inputs(4, 4, 9, 16)
    model = [np.ascontiguousarray(to_model(a, 2, 2)) for a in arrays]
    kbuild.reset_launches()
    got = mlstm_attention(*as_torch(model))
    want = mlstm_attention_torch(*as_torch(arrays))
    np.testing.assert_array_equal(
        f32(got), to_model(f32(want), 2, 2))
    assert kbuild.LAUNCHES["mlstm_attention"] == 0
    q, k, v, F, I = as_torch(model)
    with pytest.raises(ValueError, match="cpu .* or cuda"):
        mlstm_attention(q.to("meta"), k, v, F, I)


def test_a_card_tensor_never_reaches_the_plain_version(monkeypatch):
    """Dispatch follows the tensor's device alone: a tensor on the card
    goes to the kernel's wrapper (contiguous), and the plain version is
    not called."""
    calls = []

    def plain(*a):
        raise AssertionError("the plain version was called")

    monkeypatch.setattr(mops, "device_kind", lambda t, what: "cuda")
    monkeypatch.setattr(mops, "mlstm_attention_plain", plain)
    monkeypatch.setattr(mops, "mlstm_attention_torch", plain)
    monkeypatch.setattr(mkernel, "mlstm_attention_cuda",
                        lambda *a: calls.append(a) or "kernel")
    q, k, v, F, I = as_torch([np.ascontiguousarray(to_model(a, 1, 2))
                              for a in inputs(5, 2, 6, 16)])
    q = q.transpose(1, 2).contiguous().transpose(1, 2)
    assert not q.is_contiguous()
    assert mlstm_attention(q, k, v, F[:, :, :1].expand(1, 6, 2),
                           I) == "kernel"
    assert len(calls) == 1
    assert all(t.is_contiguous() for t in calls[0])


def test_wrapper_refuses_cpu_tensors():
    arrays = [np.ascontiguousarray(to_model(a, 1, 2))
              for a in inputs(6, 2, 8, 16)]
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        mkernel.mlstm_attention_cuda(*as_torch(arrays))


def test_plain_in_model_layout_is_the_heads_layout():
    B, H = 3, 2
    arrays = inputs(7, B * H, 11, 16)
    got = mlstm_attention_plain(*as_torch(
        [np.ascontiguousarray(to_model(a, B, H)) for a in arrays]))
    want = mlstm_attention_torch(*as_torch(arrays))
    np.testing.assert_array_equal(f32(got), to_model(f32(want), B, H))


@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256, 384])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_route_takes_tensor_cores_only_for_bf16_at_hd_128_to_384(dtype, hd):
    want = ("wgmma" if dtype == "bfloat16" and hd in (128, 256, 384)
            else "simt")
    assert mkernel.route(getattr(torch, dtype), hd) == want


#: the card's bf16 tolerance (chip_smoke.MLSTM_TOL[bf16]): one bf16 ulp of
#: the output, and the float32 sums' own error near 0
CARD_BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-5)


def wgmma_route_emulation(q, k, v, F, I, *, terms=3):
    """The tensor-core route's tile arithmetic on the CPU, (BH, S, hd) bf16
    q, k, v and (BH, S) float32 F, I: 64-row query tiles; each row's exact
    stabilizer m_t = max(-1e30, max_{s <= t} (F_t - F_s) + I_s) from the
    vectors before any score; 64-key tiles up to the diagonal, each split
    into the two consumers' 32-key halves, scores as float32 sums of the
    bf16 products, p = s exp(D - m) with W = 0 past the diagonal and in
    rows past S; the signed row sums of the float32 p per consumer, added
    at the end (consumer 0's first); P V with p in ``terms`` bf16 terms,
    each the bf16 rounding of what the ones before it left, summed in
    float32; acc / max(|sum|, exp(-m)), rounded once to bf16."""
    BH, S, hd = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.empty((BH, S, hd), dtype=q.dtype)
    for q0 in range(0, S, 64):
        t = torch.arange(q0, q0 + 64)
        live_row = t < S
        tc = t.clamp(max=S - 1)
        ft = torch.where(live_row, F[:, tc], torch.zeros(()))   # (BH, 64)
        n_kv = -(-min(q0 + 64, S) // 64)
        s_all = torch.arange(min(q0 + 64, S))
        D = (ft[:, :, None] - F[:, None, s_all]) + I[:, None, s_all]
        D = D.masked_fill(s_all[None, None, :] > t[None, :, None],
                          float("-inf"))
        m = torch.where(live_row, D.amax(dim=-1).clamp(min=-1e30),
                        torch.zeros(()))
        last = torch.where(live_row, t, -1)
        qt = torch.where(live_row[None, :, None], qf[:, tc],
                         torch.zeros(()))
        acc = torch.zeros((BH, 64, hd))
        l = torch.zeros((BH, 2, 64))
        for j in range(n_kv):
            P = torch.zeros((BH, 64, 64))
            for cw in range(2):
                keys = j * 64 + 32 * cw + torch.arange(32)
                live = keys[None, :] <= last[:, None]          # (64, 32)
                kc = keys.clamp(max=S - 1)
                sc = torch.einsum("bqd,bkd->bqk", qt,
                                  torch.where((keys < S)[None, :, None],
                                              kf[:, kc], torch.zeros(())))
                Dk = (ft[:, :, None] - torch.where(keys < S, F[:, kc], 0.0)
                      [:, None, :]) + torch.where(keys < S, I[:, kc], 0.0)[
                          :, None, :]
                W = torch.exp(Dk - m[:, :, None])
                p = torch.where(live[None], sc * W, torch.zeros(()))
                l[:, cw] += p.sum(dim=-1)
                P[:, :, 32 * cw:32 * cw + 32] = p
            keys = j * 64 + torch.arange(64)
            vt = torch.where((keys < S)[None, :, None],
                             vf[:, keys.clamp(max=S - 1)], torch.zeros(()))
            for _ in range(terms):
                term = P.bfloat16().float()
                acc = acc + torch.bmm(term, vt)
                P = P - term
        den = torch.maximum((l[:, 0] + l[:, 1]).abs(), torch.exp(-m))
        rows = slice(q0, min(q0 + 64, S))
        out[:, rows] = (acc / den[..., None])[:, :rows.stop - q0].to(q.dtype)
    return out


def emulation_case(case):
    """(BH, S, hd, seed, negative gate) -> bf16 q, k, v and float32 F, I
    as numpy arrays (the repo's distributions); a negative gate makes the
    first key of every row, and every key of row 1, very negative, so that
    m is that key's D and row 1's exp(-m) overflows."""
    BH, S, hd, seed, negative = case
    arrays = inputs(seed, BH, S, hd)
    if negative:
        arrays[4][:, 0] = -1e4
        arrays[4][1, :] = -200.0
    return arrays


#: (BH, S, hd, seed, negative gate): one key, a tile less one, one tile,
#: a ragged long S, and the very negative input gate
EMULATION_CASES = [(3, 1, 128, 11, False), (2, 63, 128, 12, False),
                   (2, 64, 384, 13, False), (2, 2047, 128, 14, False),
                   (2, 100, 128, 15, True)]


def exact(args):
    """The plain version on the bf16 inputs widened to float64, rounded
    once to bf16: the function's value, as far as bf16 can hold it."""
    return mlstm_attention_torch(*(t.double() for t in args)).bfloat16()


@pytest.mark.parametrize("case", EMULATION_CASES,
                         ids=lambda c: f"BH{c[0]}-S{c[1]}-hd{c[2]}"
                                       + ("-negative" if c[4] else ""))
def test_wgmma_route_emulation_matches_plain_and_pallas(case, ref):
    """The emulated tensor-core route and the Pallas kernel (interpret
    mode, the largest query block that divides S) both stay within the
    card's bf16 tolerance of the plain version computed in float64, on the
    same bf16 inputs.  Not of each other's float32 results directly: at S
    2047 the outputs near 0 are differences of sums of ~2000 signed terms,
    and two float32 summation orders (the plain version's bmm among them,
    whose blocking this CPU picks per process) land up to ~1e-5 apart."""
    arrays = emulation_case(case)
    args = as_torch(arrays, "bfloat16")
    got = wgmma_route_emulation(*args)
    assert bool(torch.isfinite(got.float()).all())
    want = exact(args)
    np.testing.assert_allclose(f32(got), f32(want), **CARD_BF16_TOL)
    S = case[1]
    bq = max(b for b in range(1, min(S, 128) + 1) if S % b == 0)
    pallas = ref.kernel(*as_jax(ref, arrays, "bfloat16"), bq=bq, bk=bq,
                        interpret=True)
    np.testing.assert_allclose(f32(pallas), f32(want), **CARD_BF16_TOL)
    if case[4]:
        assert not got[1].float().any()          # exp(-m) overflowed


@pytest.mark.parametrize("case", [(2, 2047, 128, 14, False),
                                  (1, 2048, 384, 1, False)],
                         ids=["S2047-hd128", "S2048-hd384"])
def test_two_bf16_terms_of_p_miss_the_card_tolerance(case):
    """Three bf16 terms carry p to about 2^-24 and hold the card's bf16
    tolerance; two (flash's hi and lo, about 2^-16) leave outputs near 0
    outside it on the same inputs: p is signed and |sum p| can be small.
    That is why the route pays for three P V products.  xlstm-125m's
    prefill length and head dim."""
    args = as_torch(emulation_case(case), "bfloat16")
    want = f32(exact(args))
    np.testing.assert_allclose(f32(wgmma_route_emulation(*args)), want,
                               **CARD_BF16_TOL)
    two = f32(wgmma_route_emulation(*args, terms=2))
    outside = np.abs(two - want) > CARD_BF16_TOL["atol"] + \
        CARD_BF16_TOL["rtol"] * np.abs(want)
    assert outside.sum() > 0, "two bf16 terms held the tolerance"
    assert float(np.abs(want[outside]).min()) < 1e-2    # near 0


# ---------------------------------------------------------------------------
# On the card: the CUDA kernel against the plain version
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


#: (B, S, H, hd, dtype): the reference test's shapes (H = 1, its layout),
#: ragged lengths, xlstm-125m's head dim and the smoke config's
CARD_CASES = [(4, 256, 1, 64, "float32"), (2, 512, 1, 128, "bfloat16"),
              (8, 128, 1, 32, "float32"), (2, 77, 4, 384, "bfloat16"),
              (2, 300, 4, 384, "float32"), (1, 1, 2, 32, "float32"),
              (2, 1000, 4, 32, "float32"), (3, 130, 2, 16, "bfloat16"),
              (1, 64, 2, 256, "bfloat16")]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
def test_kernel_matches_plain_on_card(case, cuda_device):
    """Both entry points: float32 within 1e-4 / 1e-5 (the order of the
    float32 sums); bf16 within one bf16 ulp of each output (both round the
    same float32 value once, up to that order) plus 1e-5."""
    B, S, H, hd, dtype = case
    arrays = [np.ascontiguousarray(to_model(a, B, H))
              for a in inputs(8, B * H, S, hd)]
    args = as_torch(arrays, dtype, cuda_device)
    kbuild.reset_launches()
    got = mlstm_attention(*args)
    torch.cuda.synchronize()
    assert kbuild.LAUNCHES["mlstm_attention"] == 1
    assert got.dtype == args[0].dtype and got.shape == args[0].shape
    want = mlstm_attention_plain(*args)
    tol = (dict(rtol=1e-4, atol=1e-5) if dtype == "float32"
           else dict(rtol=2.0 ** -7, atol=1e-5))
    np.testing.assert_allclose(f32(got.cpu()), f32(want.cpu()), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,route", [("bfloat16", "wgmma"),
                                         ("float32", "simt")])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 1000, 2047])
def test_both_routes_at_hd_384_on_card(S, dtype, route, cuda_device):
    """xlstm-125m's head dim with H = 4 in the model's layout, ragged and
    whole tiles: each dtype takes the route that ``route`` names (counted
    in ``build.ROUTES``) and holds the plain version's tolerance (bf16:
    one bf16 ulp plus 1e-5; float32: 1e-4 / 1e-5)."""
    B, H, hd = 2, 4, 384
    arrays = [np.ascontiguousarray(to_model(a, B, H))
              for a in inputs(20 + S, B * H, S, hd)]
    args = as_torch(arrays, dtype, cuda_device)
    assert mkernel.route(args[0].dtype, hd) == route
    kbuild.reset_launches()
    got = mlstm_attention(*args)
    again = mlstm_attention(*args)
    torch.cuda.synchronize()
    assert kbuild.ROUTES == {f"mlstm_attention/{route}": 2}
    want = mlstm_attention_plain(*args)
    tol = (dict(rtol=1e-4, atol=1e-5) if dtype == "float32"
           else dict(rtol=2.0 ** -7, atol=1e-5))
    np.testing.assert_allclose(f32(got.cpu()), f32(want.cpu()), **tol)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_wgmma_route_very_negative_gate_and_misalignment_on_card(
        cuda_device):
    """On the tensor-core route: a very negative first gate and a row whose
    exp(-m) overflows (output 0, never NaN); q one element off 16-byte
    alignment is refused before any launch."""
    arrays = inputs(9, 2, 100, 128)
    arrays[4][:, 0] = -1e4
    arrays[4][1, :] = -200.0
    model = [np.ascontiguousarray(to_model(a, 1, 2)) for a in arrays]
    args = as_torch(model, "bfloat16", cuda_device)
    kbuild.reset_launches()
    got = mlstm_attention(*args)
    torch.cuda.synchronize()
    assert kbuild.ROUTES == {"mlstm_attention/wgmma": 1}
    assert bool(torch.isfinite(got.float()).all())
    np.testing.assert_allclose(f32(got.cpu()),
                               f32(mlstm_attention_plain(*args).cpu()),
                               rtol=2.0 ** -7, atol=1e-5)
    assert not got[:, :, 1].float().any()
    q = torch.empty(args[0].numel() + 1, dtype=torch.bfloat16,
                    device=cuda_device)[1:].view(args[0].shape)
    q.copy_(args[0])
    with pytest.raises(ValueError, match="16-byte aligned"):
        mkernel.mlstm_attention_cuda(q, *args[1:])
    assert kbuild.LAUNCHES["mlstm_attention"] == 1


@pytest.mark.cuda
def test_kernel_very_negative_gate_on_card(cuda_device):
    arrays = inputs(9, 2, 100, 32)
    arrays[4][:, 0] = -1e4
    arrays[4][1, :] = -200.0
    model = [np.ascontiguousarray(to_model(a, 1, 2)) for a in arrays]
    args = as_torch(model, "float32", cuda_device)
    got = mlstm_attention(*args)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(f32(got.cpu()),
                               f32(mlstm_attention_plain(*args).cpu()),
                               rtol=1e-4, atol=1e-5)
    assert not got[:, :, 1].any()


@pytest.mark.cuda
def test_other_dtype_raises_on_card(cuda_device):
    model = [np.ascontiguousarray(to_model(a, 1, 2))
             for a in inputs(10, 2, 8, 32)]
    args = as_torch(model, "float16", cuda_device)
    kbuild.reset_launches()
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        mlstm_attention(*args)
    args = as_torch(model, "bfloat16", cuda_device)
    args[3] = args[3].to(torch.bfloat16)
    with pytest.raises(TypeError, match="float32"):
        mlstm_attention(*args)
    assert kbuild.LAUNCHES["mlstm_attention"] == 0
