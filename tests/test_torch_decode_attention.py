"""repro_torch's flash-decoding against the reference's.

The port's partials run over the model's cache layout, q (B, KH, G, hd)
and k, v (B, S, KH, hd); the reference's (BK, G, hd) / (BK, S, hd) layout
is the case KH = 1.  Only keys ``[0, kv_len)`` count, so the partials are
those of the reference's Pallas kernel on ``k[:, :kv_len]``: chunks cut at
kv_len, a chunk wholly past it m = -inf, l = 0, acc = 0.  On the same
inputs, made with numpy from a seed, the plain partials must agree with
``decode_attention_partials(interpret=True)`` within 1e-5 (both keep them
in float32 from the same inputs; acc sums up to 512 products), and the
combined output with ``decode_attention_ref`` within 2e-5 in float32 and
2e-2 in bfloat16 (one bf16 ulp of the output).  The ``cuda``-marked tests
at the end hold the CUDA kernel against the plain partials on the card;
they need no JAX
(``python -m pytest -q -m cuda tests/test_torch_decode_attention.py``).
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention,
    decode_attention_partials,
    decode_attention_partials_torch,
    decode_attention_torch,
)
from repro_torch.kernels.decode_attention import (  # noqa: E402
    kernel as dkernel,
)

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
PARTIAL_TOL = dict(rtol=1e-5, atol=1e-5)

#: (BK, G, S, hd, bc): the reference's kernel-test shapes
CASES = [(4, 2, 1024, 64, 256), (2, 1, 2048, 128, 512),
         (1, 8, 512, 64, 512)]


@pytest.fixture
def ref():
    """The reference's flash-decoding (JAX); the card machine has no JAX,
    so only the comparisons with the reference need it."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.decode_attention import (decode_attention,
                                                decode_attention_ref)
    from repro.kernels.decode_attention.kernel import (
        decode_attention_partials)
    return types.SimpleNamespace(
        jnp=jnp, decode_attention=decode_attention,
        decode_attention_ref=decode_attention_ref,
        partials=decode_attention_partials)


def qkv(seed, BK, G, S, hd):
    """The reference's layout, float32."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((BK, G, hd)).astype(np.float32),
            rng.standard_normal((BK, S, hd)).astype(np.float32),
            rng.standard_normal((BK, S, hd)).astype(np.float32))


def as_jnp(ref, arrays, dtype):
    return [ref.jnp.asarray(a).astype(dtype) for a in arrays]


def as_cache(arrays, dtype, device="cpu"):
    """The reference's (BK, G, hd) / (BK, S, hd) as the port's cache layout
    with KH = 1: (BK, 1, G, hd) / (BK, S, 1, hd)."""
    q, k, v = (torch.as_tensor(a).to(device=device, dtype=getattr(torch, dtype))
               for a in arrays)
    return q[:, None].contiguous(), k[:, :, None].contiguous(), \
        v[:, :, None].contiguous()


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().cpu().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_plain_partials_and_output_match_reference(case, dtype, ref):
    BK, G, S, hd, bc = case
    arrays = qkv(1, BK, G, S, hd)
    jq, jk, jv = as_jnp(ref, arrays, dtype)
    q, k, v = as_cache(arrays, dtype)
    acc, m, l = decode_attention_partials_torch(q, k, v, kv_len=S, bc=bc)
    wacc, wm, wl = ref.partials(jq, jk, jv, bc=bc, interpret=True)
    for got, want in ((acc, wacc), (m, wm), (l, wl)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(f32(got), f32(want), **PARTIAL_TOL)
    out = decode_attention(q, k, v, bc=bc)[:, 0]
    assert out.dtype == q.dtype
    np.testing.assert_allclose(f32(out), f32(ref.decode_attention_ref(
        jq, jk, jv)), **TOL[dtype])
    np.testing.assert_allclose(f32(out), f32(ref.decode_attention(
        jq, jk, jv, bc=bc, interpret=True)), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_len_is_the_pallas_kernel_on_the_live_prefix(dtype, ref):
    """kv_len = 768 of a 1024-key cache with bc = 256: the first three
    chunks are the Pallas kernel's on k[:, :768], the fourth is empty."""
    S, kv_len, bc = 1024, 768, 256
    arrays = qkv(2, 3, 2, S, 64)
    q, k, v = as_cache(arrays, dtype)
    acc, m, l = decode_attention_partials_torch(q, k, v, kv_len=kv_len,
                                                bc=bc)
    jq, jk, jv = as_jnp(ref, arrays, dtype)
    wacc, wm, wl = ref.partials(jq, jk[:, :kv_len], jv[:, :kv_len], bc=bc,
                                interpret=True)
    np.testing.assert_allclose(f32(acc[:, :, :3]), f32(wacc), **PARTIAL_TOL)
    np.testing.assert_allclose(f32(m[:, :, :3]), f32(wm), **PARTIAL_TOL)
    np.testing.assert_allclose(f32(l[:, :, :3]), f32(wl), **PARTIAL_TOL)
    assert bool((m[:, :, 3] == float("-inf")).all())
    assert bool((l[:, :, 3] == 0).all()) and bool((acc[:, :, 3] == 0).all())
    out = decode_attention(q, k, v, kv_len=kv_len, bc=bc)[:, 0]
    want = ref.decode_attention_ref(jq, jk[:, :kv_len], jv[:, :kv_len])
    np.testing.assert_allclose(f32(out), f32(want), **TOL[dtype])


@pytest.mark.parametrize("kv_len", [1, 100, 300, 511, 512])
def test_ragged_and_empty_chunks_match_oracle(kv_len, ref):
    """kv_len cuts a chunk and leaves whole chunks empty (bc = 128 over a
    512-key cache): the output is the oracle's over k[:, :kv_len], and so
    is the plain whole function."""
    S, bc = 512, 128
    arrays = qkv(3, 2, 4, S, 32)
    q, k, v = as_cache(arrays, "float32")
    jq, jk, jv = as_jnp(ref, arrays, "float32")
    want = f32(ref.decode_attention_ref(jq, jk[:, :kv_len], jv[:, :kv_len]))
    got = decode_attention(q, k, v, kv_len=kv_len, bc=bc)[:, 0]
    np.testing.assert_allclose(f32(got), want, **TOL["float32"])
    whole = decode_attention_torch(q, k, v, kv_len=kv_len)[:, 0]
    np.testing.assert_allclose(f32(whole), want, **TOL["float32"])
    _, m, l = decode_attention_partials_torch(q, k, v, kv_len=kv_len, bc=bc)
    live = -(-kv_len // bc)
    assert bool((m[..., live:] == float("-inf")).all())
    assert bool((l[..., :live] > 0).all()) and bool((l[..., live:] == 0).all())


def test_partials_combine_invariance():
    """Chunk size must not change the combined result (flash-decoding),
    with kv_len cutting the last chunk."""
    arrays = qkv(4, 2, 2, 1024, 64)
    q, k, v = as_cache(arrays, "float32")
    a = decode_attention(q, k, v, kv_len=1000, bc=128)
    b = decode_attention(q, k, v, kv_len=1000, bc=1024)
    np.testing.assert_allclose(f32(a), f32(b), rtol=2e-6, atol=2e-6)


def test_model_cache_layout_is_per_kv_head():
    """With KH > 1 each kv head attends its own cache column: the result is
    the KH = 1 function on each head's slice."""
    rng = np.random.default_rng(5)
    B, S, KH, G, hd = 2, 96, 3, 2, 16
    q = torch.as_tensor(rng.standard_normal((B, KH, G, hd)), dtype=torch.float32)
    k = torch.as_tensor(rng.standard_normal((B, S, KH, hd)), dtype=torch.float32)
    v = torch.as_tensor(rng.standard_normal((B, S, KH, hd)), dtype=torch.float32)
    out = decode_attention(q, k, v, kv_len=70, bc=32)
    for h in range(KH):
        one = decode_attention(q[:, h:h + 1].contiguous(),
                               k[:, :, h:h + 1].contiguous(),
                               v[:, :, h:h + 1].contiguous(), kv_len=70,
                               bc=32)
        torch.testing.assert_close(out[:, h], one[:, 0], rtol=0, atol=0)


def test_cpu_tensors_never_reach_the_kernel(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("kernel loader reached from a CPU tensor")

    monkeypatch.setattr(dkernel, "load", refuse)
    monkeypatch.setattr(kbuild, "build", refuse)
    q, k, v = as_cache(qkv(6, 2, 2, 64, 16), "float32")
    kbuild.reset_launches()
    decode_attention(q, k, v, kv_len=40, bc=16)
    assert kbuild.LAUNCHES["decode_attention"] == 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        dkernel.decode_attention_cuda(q, k, v, kv_len=40, bc=16)
    with pytest.raises(ValueError, match="cpu .* or cuda"):
        decode_attention_partials(q.to("meta"), k.to("meta"), v.to("meta"),
                                  kv_len=40, bc=16)


# ---------------------------------------------------------------------------
# On the card: the CUDA kernel against the plain partials
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA flash-decoding kernel "
                    "has no CPU mode)")
    return torch.device("cuda")


#: (B, KH, G, S, hd, kv_len, bc): the serving shape and its edges, every
#: head dim, a ragged chunk, empty chunks
CARD_CASES = [(8, 2, 6, 2080, 128, 2049, 512), (8, 2, 6, 2080, 128, 2080, 512),
              (8, 2, 6, 2080, 128, 1, 512), (2, 2, 2, 40, 16, 17, 16),
              (3, 1, 4, 300, 32, 300, 128), (1, 8, 2, 1024, 64, 700, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CARD_CASES)
def test_kernel_matches_plain_on_card(case, dtype, cuda_device):
    B, KH, G, S, hd, kv_len, bc = case
    rng = np.random.default_rng(7)
    dt = getattr(torch, dtype)
    q, k, v = (torch.as_tensor(rng.standard_normal(shape),
                               dtype=torch.float32).to(cuda_device, dt)
               for shape in ((B, KH, G, hd), (B, S, KH, hd), (B, S, KH, hd)))
    before = kbuild.LAUNCHES["decode_attention"]
    got = decode_attention_partials(q, k, v, kv_len=kv_len, bc=bc)
    torch.cuda.synchronize()
    assert kbuild.LAUNCHES["decode_attention"] == before + 1
    want = decode_attention_partials_torch(q, k, v, kv_len=kv_len, bc=bc)
    # both keep the partials in float32 from the same inputs; only the
    # order of the sums differs (acc sums up to 512 products)
    for g, w in zip(got, want):
        np.testing.assert_allclose(f32(g), f32(w), rtol=1e-4, atol=1e-4)
    # the combined output: both round once from float32, so in bfloat16
    # one bf16 ulp (2^-7 of the value)
    out = decode_attention(q, k, v, kv_len=kv_len, bc=bc)
    np.testing.assert_allclose(
        f32(out), f32(decode_attention_torch(q, k, v, kv_len=kv_len)),
        **(dict(rtol=2.0 ** -7, atol=1e-5) if dtype == "bfloat16" else
           dict(rtol=1e-4, atol=1e-4)))


@pytest.mark.cuda
def test_kernel_refuses_what_it_was_not_built_for(cuda_device):
    q = torch.zeros((1, 1, 2, 8), device=cuda_device)
    k = torch.zeros((1, 64, 1, 8), device=cuda_device)
    with pytest.raises(ValueError, match="head dims"):
        dkernel.decode_attention_cuda(q, k, k, kv_len=64, bc=32)
    q = torch.zeros((1, 1, 32, 128), device=cuda_device)
    k = torch.zeros((1, 64, 1, 128), device=cuda_device)
    with pytest.raises(ValueError, match="G x hd"):
        dkernel.decode_attention_cuda(q, k, k, kv_len=64, bc=32)
    q = torch.zeros((1, 1, 2, 16), device=cuda_device)
    k = torch.zeros((1, 64, 1, 16), device=cuda_device)
    with pytest.raises(ValueError, match="kv_len"):
        dkernel.decode_attention_cuda(q, k, k, kv_len=65, bc=32)
