"""repro_torch's flash attention against the reference's.

The port's plain version (``flash_attention_torch``) has the semantics of
the reference's ``flash_attention_ref`` and of its Pallas kernel
(float32 scores, softmax and sum, one cast at the end), so on the same
inputs, made with numpy from a seed and cast to the working dtype by both
packages, it must agree with ``flash_attention_kernel(interpret=True)``
and ``flash_attention_ref`` within 2e-5 in float32 and 2e-2 in bfloat16
(one bf16 ulp of the output is up to 1.6e-2 here; the repo's kernel tests
use the same bounds).  The CUDA kernel takes any S, where the Pallas
kernel asserts S % bq == 0, so ragged S is held against the jnp oracle.
On the CPU, the dispatching wrappers take the plain version and never
reach the kernel loader; the CPU tests also hold the choice of route and
an emulation of the tensor-core route's arithmetic (P split in two bf16
terms).  The ``cuda``-marked tests at the end hold both CUDA routes
against the plain version on the card; they need no JAX
(``python -m pytest -q -m cuda tests/test_torch_flash_attention.py``).
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cases  # noqa: E402,F401  (caps torch's CPU threads)

from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention,
    flash_attention_grouped,
    flash_attention_torch,
)
from repro_torch.kernels.flash_attention import kernel as fkernel  # noqa: E402

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}

#: (BK, G, S, hd, bq, bk): the reference's kernel-test shapes
CASES = [(2, 1, 256, 64, 128, 128), (2, 2, 256, 128, 64, 128),
         (1, 4, 512, 64, 128, 64), (3, 1, 128, 32, 128, 128)]


@pytest.fixture
def ref():
    """The reference's flash attention (JAX); the card machine has no JAX,
    so only the comparisons with the reference need it."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.flash_attention import (flash_attention,
                                               flash_attention_ref)
    from repro.kernels.flash_attention.kernel import flash_attention_kernel
    return types.SimpleNamespace(
        jnp=jnp, flash_attention=flash_attention,
        flash_attention_ref=flash_attention_ref,
        flash_attention_kernel=flash_attention_kernel)


def qkv(seed, BK, G, S, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((BK, G, S, hd)).astype(np.float32),
            rng.standard_normal((BK, S, hd)).astype(np.float32),
            rng.standard_normal((BK, S, hd)).astype(np.float32))


def as_jnp(ref, arrays, dtype):
    return [ref.jnp.asarray(a).astype(dtype) for a in arrays]


def as_torch(arrays, dtype, device="cpu"):
    return [torch.as_tensor(a).to(device=device, dtype=getattr(torch, dtype))
            for a in arrays]


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().cpu().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_plain_matches_pallas_kernel_and_oracle(case, dtype, ref):
    BK, G, S, hd, bq, bk = case
    arrays = qkv(1, BK, G, S, hd)
    jq, jk, jv = as_jnp(ref, arrays, dtype)
    got = flash_attention_torch(*as_torch(arrays, dtype), causal=True)
    assert got.dtype == getattr(torch, dtype)
    kern = ref.flash_attention_kernel(jq, jk, jv, causal=True, bq=bq, bk=bk,
                                      interpret=True)
    oracle = ref.flash_attention_ref(jq, jk, jv, causal=True)
    np.testing.assert_allclose(f32(got), f32(kern), **TOL[dtype])
    np.testing.assert_allclose(f32(got), f32(oracle), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_non_causal_matches_pallas_kernel(dtype, ref):
    arrays = qkv(2, 2, 2, 256, 64)
    jq, jk, jv = as_jnp(ref, arrays, dtype)
    got = flash_attention_torch(*as_torch(arrays, dtype), causal=False)
    kern = ref.flash_attention_kernel(jq, jk, jv, causal=False,
                                      interpret=True)
    np.testing.assert_allclose(f32(got), f32(kern), **TOL[dtype])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [1, 77, 200])
def test_plain_ragged_seq_matches_oracle(S, causal, ref):
    arrays = qkv(3, 2, 3, S, 16)
    got = flash_attention_torch(*as_torch(arrays, "float32"), causal=causal)
    want = ref.flash_attention_ref(*as_jnp(ref, arrays, "float32"),
                                   causal=causal)
    np.testing.assert_allclose(f32(got), f32(want), **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_layout_wrapper_matches_reference_wrapper(dtype, ref):
    """q (B,S,KH,G,hd), k/v (B,S,KH,hd) against the reference's ops
    wrapper (Pallas kernel in interpret mode)."""
    rng = np.random.default_rng(4)
    B, S, KH, G, hd = 2, 128, 2, 3, 32
    arrays = (rng.standard_normal((B, S, KH, G, hd)).astype(np.float32),
              rng.standard_normal((B, S, KH, hd)).astype(np.float32),
              rng.standard_normal((B, S, KH, hd)).astype(np.float32))
    want = ref.flash_attention(*as_jnp(ref, arrays, dtype), causal=True,
                               interpret=True)
    got = flash_attention(*as_torch(arrays, dtype), causal=True)
    assert tuple(got.shape) == (B, S, KH, G, hd)
    np.testing.assert_allclose(f32(got), f32(want), **TOL[dtype])


def test_cpu_tensors_never_reach_the_kernel(monkeypatch):
    """CPU tensors take the plain version without building or loading the
    CUDA library; the CUDA wrapper refuses CPU tensors before the loader."""
    def refuse(*a, **k):
        raise AssertionError("kernel loader reached from a CPU tensor")

    monkeypatch.setattr(fkernel, "load", refuse)
    monkeypatch.setattr(kbuild, "build", refuse)
    q, k, v = as_torch(qkv(5, 2, 2, 64, 16), "float32")
    kbuild.reset_launches()
    out = flash_attention_grouped(q, k, v)
    torch.testing.assert_close(out, flash_attention_torch(q, k, v),
                               rtol=0, atol=0)
    assert kbuild.LAUNCHES["flash_attention"] == 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        fkernel.flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="cpu .* or cuda"):
        flash_attention_grouped(q.to("meta"), k.to("meta"), v.to("meta"))


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_route_takes_tensor_cores_only_for_bf16_at_hd_64_and_128(dtype, hd):
    want = "wgmma" if (dtype, hd) in (("bfloat16", 64),
                                      ("bfloat16", 128)) else "simt"
    assert fkernel.route(getattr(torch, dtype), hd) == want


#: the card's bf16 tolerance (chip_smoke.ATTN_TOL[bf16]): one bf16 ulp of
#: the output, and the float32 sums' own error near 0
CARD_BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-5)


def wgmma_emulation(q, k, v, *, causal, split=True, tile=128):
    """The tensor-core route's arithmetic on the CPU: float32 scores of the
    bf16 inputs, an online softmax over 128-key tiles in float32, and P V
    with p in two bf16 terms, bf16(p) + bf16(p - bf16(p)) (``split``), or
    in one, bf16(p), summed in float32; acc / max(l, 1e-30), rounded once
    to bf16."""
    BK, G, S, hd = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((BK, G, S), float("-inf"))
    l = torch.zeros((BK, G, S))
    acc = torch.zeros((BK, G, S, hd))
    rows = torch.arange(S)[:, None]
    for k0 in range(0, S, tile):
        keys = torch.arange(k0, min(k0 + tile, S))
        s = torch.einsum("bgqd,bkd->bgqk", qf, kf[:, keys]) * hd ** -0.5
        if causal:
            s = s.masked_fill(keys[None, :] > rows, float("-inf"))
        mn = torch.maximum(m, s.amax(dim=-1))
        mu = torch.where(mn == float("-inf"), torch.zeros_like(mn), mn)
        c = torch.exp(m - mu)
        p = torch.exp(s - mu[..., None])
        l = l * c + p.sum(dim=-1)
        hi = p.bfloat16().float()
        terms = (hi, (p - hi).bfloat16().float()) if split else (hi,)
        acc = acc * c[..., None] + sum(
            torch.einsum("bgqk,bkd->bgqd", t, vf[:, keys]) for t in terms)
        m = mn
    return (acc / l.clamp_min(1e-30)[..., None]).bfloat16()


def near_zero_case(seed, BK, G, S, hd):
    """bf16 inputs with flat attention over up to 300 keys: the outputs are
    averages of many values of both signs, many of them near 0."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((BK, G, S, hd)) * 0.3
    k = rng.standard_normal((BK, S, hd))
    v = rng.standard_normal((BK, S, hd))
    return [torch.as_tensor(a, dtype=torch.float32).bfloat16()
            for a in (q, k, v)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [77, 130, 300])
def test_split_p_emulation_holds_card_tolerance(S, causal):
    """hi + lo carries p to ~2^-17, so the emulated route stays within the
    card's bf16 tolerance of the plain version; one bf16 P does not, on
    the same inputs, at the outputs near 0: that is why the kernel pays
    for two P V products."""
    q, k, v = near_zero_case(9, 2, 3, S, 64)
    want = flash_attention_torch(q, k, v, causal=causal)
    got = wgmma_emulation(q, k, v, causal=causal)
    np.testing.assert_allclose(f32(got), f32(want), **CARD_BF16_TOL)
    one = f32(wgmma_emulation(q, k, v, causal=causal, split=False))
    w = f32(want)
    outside = np.abs(one - w) > CARD_BF16_TOL["atol"] + \
        CARD_BF16_TOL["rtol"] * np.abs(w)
    assert outside.sum() > 0, "one bf16 P held the tolerance"
    assert float(np.abs(w[outside]).min()) < 1e-2    # near 0


# ---------------------------------------------------------------------------
# On the card: the CUDA kernel against the plain version
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA flash-attention kernel "
                    "has no CPU mode)")
    return torch.device("cuda")


#: (BK, G, S, hd, causal): every head dim, ragged S, one row, non-causal
CARD_CASES = [(2, 1, 256, 64, True), (2, 2, 256, 128, True),
              (3, 2, 77, 16, True), (1, 4, 200, 32, True),
              (2, 6, 1000, 128, True), (1, 1, 1, 64, True),
              (2, 2, 130, 128, False), (2, 3, 64, 16, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CARD_CASES)
def test_kernel_matches_plain_on_card(case, dtype, cuda_device):
    BK, G, S, hd, causal = case
    q, k, v = as_torch(qkv(6, BK, G, S, hd), dtype, cuda_device)
    before = kbuild.LAUNCHES["flash_attention"]
    got = flash_attention_grouped(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert kbuild.LAUNCHES["flash_attention"] == before + 1
    want = flash_attention_torch(q, k, v, causal=causal)
    assert got.dtype == q.dtype
    # float32: the sums run in another order than the plain version's
    # (online softmax over 64-key tiles); bfloat16: both compute in float32
    # and round once, so one bf16 ulp of the output (2^-7 of it)
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" else \
        dict(rtol=2.0 ** -7, atol=1e-5)
    np.testing.assert_allclose(f32(got), f32(want), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 2, 4, 6])
@pytest.mark.parametrize("S", [1, 77, 128, 130, 1000, 2047])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [64, 128])
def test_wgmma_route_matches_plain_on_card(hd, causal, S, G, cuda_device):
    q, k, v = as_torch(qkv(10 + S, 2, G, S, hd), "bfloat16", cuda_device)
    kbuild.reset_launches()
    got = flash_attention_grouped(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert kbuild.LAUNCHES["flash_attention"] == 1
    assert kbuild.ROUTES == {"flash_attention/wgmma": 1}
    want = flash_attention_torch(q, k, v, causal=causal)
    assert torch.isfinite(got.float()).all()
    np.testing.assert_allclose(f32(got), f32(want), rtol=2.0 ** -7,
                               atol=1e-5)


@pytest.mark.cuda
def test_kernel_refuses_what_it_was_not_built_for(cuda_device):
    q, k, v = as_torch(qkv(7, 1, 1, 64, 16), "float32", cuda_device)
    with pytest.raises(ValueError, match="head dims"):
        fkernel.flash_attention_cuda(q[..., :8].contiguous(),
                                     k[..., :8].contiguous(),
                                     v[..., :8].contiguous())
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        fkernel.flash_attention_cuda(q.half(), k.half(), v.half())
    with pytest.raises(TypeError, match="dtype"):
        fkernel.flash_attention_cuda(q, k.bfloat16(), v)
    # the tensor-core route reads by TMA from 16-byte aligned addresses
    q, k, v = as_torch(qkv(7, 1, 1, 64, 64), "bfloat16", cuda_device)
    odd = torch.zeros(64 * 64 + 1, dtype=torch.bfloat16,
                      device=cuda_device)[1:].view(1, 64, 64)
    with pytest.raises(ValueError, match="aligned"):
        fkernel.flash_attention_cuda(q, odd, v)
