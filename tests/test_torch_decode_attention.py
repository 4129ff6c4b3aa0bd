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
2e-2 in bfloat16 (one bf16 ulp of the output).  On the card the kernel
computes the whole function in one launch over its own split of the keys
(``kernel.plan_splits``); the CPU tests hold the planner and an emulation
of the split plan with its ordered combine.  The ``cuda``-marked tests at
the end hold the CUDA kernel against the plain whole function on the
card; they need no JAX
(``python -m pytest -q -m cuda tests/test_torch_decode_attention.py``).
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cases  # noqa: E402,F401  (caps torch's CPU threads)

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
        dkernel.decode_attention_cuda(q, k, v, kv_len=40)
    with pytest.raises(ValueError, match="cpu .* or cuda"):
        decode_attention_partials(q.to("meta"), k.to("meta"), v.to("meta"),
                                  kv_len=40, bc=16)


#: (kv_len, B x KH, SMs): one key, fewer keys than the splits the SM count
#: asks for, qwen2-1.5b's decode shape at 2049 and 2080 live keys, a cache
#: read whole (S = kv_len), one (b, kv head) over a long cache, and more
#: (b, kv head) pairs than SMs
PLAN_CASES = [(1, 16, 132), (10, 1, 132), (63, 2, 132), (2049, 16, 132),
              (2080, 16, 132), (700, 8, 132), (100_000, 1, 132),
              (4096, 512, 132), (130, 3, 132)]


@pytest.mark.parametrize("kv_len,bkh,sms", PLAN_CASES)
def test_split_plan_covers_the_live_keys(kv_len, bkh, sms):
    nsplit, kps = dkernel.plan_splits(kv_len, bkh, sms)
    assert 1 <= nsplit <= dkernel.MAX_SPLITS
    splits = [(s * kps, min((s + 1) * kps, kv_len)) for s in range(nsplit)]
    assert all(b > a for a, b in splits), splits        # none empty
    assert splits[0][0] == 0 and splits[-1][1] == kv_len
    assert all(splits[i][1] == splits[i + 1][0] for i in range(nsplit - 1))
    if nsplit > 1:      # at least one full tile of keys a split
        assert kps >= dkernel.MIN_SPLIT_KEYS
    if kv_len < dkernel.MIN_SPLIT_KEYS:
        assert nsplit == 1
    if (kv_len, bkh) in ((2049, 16), (2080, 16)):    # qwen2-1.5b decode
        assert nsplit * bkh >= 2 * sms


def test_split_plan_at_qwen2_decode_shape():
    """16 (b, kv head) pairs x 17 splits = 272 blocks of ~121 keys."""
    assert dkernel.plan_splits(2049, 16, 132) == (17, 121)
    assert dkernel.plan_splits(1, 16, 132) == (1, 1)


@pytest.mark.parametrize("kv_len", [1, 5, 100, 2049, 2080])
def test_split_plan_and_ordered_combine_emulate_the_function(kv_len):
    """The kernel's arithmetic on the CPU: each split's (m, l, acc) in
    float32 over its keys, then the splits combined in split order with
    weights exp(m_s - max m), as the last block does.  Equal to the plain
    whole function within the float32 TOL."""
    B, KH, G, S, hd = 2, 2, 6, 2080, 32
    rng = np.random.default_rng(8)
    q, k, v = (torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)
               for shape in ((B, KH, G, hd), (B, S, KH, hd), (B, S, KH, hd)))
    nsplit, kps = dkernel.plan_splits(kv_len, B * KH, 132)
    qs = q.reshape(B * KH, G, hd) * hd ** -0.5
    ks = k.permute(0, 2, 1, 3).reshape(B * KH, S, hd)
    vs = v.permute(0, 2, 1, 3).reshape(B * KH, S, hd)
    parts = []
    for s in range(nsplit):
        a, b = s * kps, min((s + 1) * kps, kv_len)
        sc = torch.einsum("ngd,nkd->ngk", qs, ks[:, a:b])
        m = sc.amax(dim=-1)
        p = torch.exp(sc - m[..., None])
        parts.append((m, p.sum(dim=-1), torch.einsum("ngk,nkd->ngd", p,
                                                     vs[:, a:b])))
    top = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    num = torch.zeros((B * KH, G, hd))
    den = torch.zeros((B * KH, G))
    for m, l, acc in parts:                 # split order
        w = torch.exp(m - top)
        num = num + w[..., None] * acc
        den = den + w * l
    got = (num / den.clamp_min(1e-30)[..., None]).reshape(B, KH, G, hd)
    want = decode_attention_torch(q, k, v, kv_len=kv_len)
    np.testing.assert_allclose(f32(got), f32(want), **TOL["float32"])


# ---------------------------------------------------------------------------
# On the card: the CUDA kernel against the plain partials
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA flash-decoding kernel "
                    "has no CPU mode)")
    return torch.device("cuda")


#: (B, KH, G, S, hd): qwen2-1.5b's decode shape with every KH, and every
#: head dim and G bucket
CARD_SHAPES = [(4, 1, 6, 2080, 128), (4, 2, 6, 2080, 128),
               (2, 8, 6, 2080, 128), (2, 2, 1, 2080, 64),
               (2, 8, 2, 2080, 32), (3, 1, 3, 2080, 16),
               (1, 2, 8, 2080, 128), (2, 2, 5, 2080, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_len", [1, 5, 100, 2049, 2080])
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_kernel_matches_plain_on_card(shape, kv_len, dtype, cuda_device):
    """The fused kernel (one launch: partials and combine) against the
    plain whole function, and bitwise equal to itself over two calls."""
    B, KH, G, S, hd = shape
    rng = np.random.default_rng(7)
    dt = getattr(torch, dtype)
    q, k, v = (torch.as_tensor(rng.standard_normal(shp),
                               dtype=torch.float32).to(cuda_device, dt)
               for shp in ((B, KH, G, hd), (B, S, KH, hd), (B, S, KH, hd)))
    before = kbuild.LAUNCHES["decode_attention"]
    got = decode_attention(q, k, v, kv_len=kv_len)
    again = decode_attention(q, k, v, kv_len=kv_len)
    torch.cuda.synchronize()
    assert kbuild.LAUNCHES["decode_attention"] == before + 2
    assert got.dtype == q.dtype and tuple(got.shape) == (B, KH, G, hd)
    assert torch.equal(got, again), "two calls gave other bits"
    assert int(dkernel._COUNTERS[torch.cuda.current_device()].abs().sum()) == 0
    # bfloat16: both compute in float32 and round once, so one bf16 ulp
    # (2^-7 of the value); float32: only the order of the sums differs
    tol = dict(rtol=2.0 ** -7, atol=1e-5) if dtype == "bfloat16" else \
        dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        f32(got), f32(decode_attention_torch(q, k, v, kv_len=kv_len)), **tol)


@pytest.mark.cuda
def test_kernel_refuses_what_it_was_not_built_for(cuda_device):
    q = torch.zeros((1, 1, 2, 8), device=cuda_device)
    k = torch.zeros((1, 64, 1, 8), device=cuda_device)
    with pytest.raises(ValueError, match="head dims"):
        dkernel.decode_attention_cuda(q, k, k, kv_len=64)
    q = torch.zeros((1, 1, 32, 128), device=cuda_device)
    k = torch.zeros((1, 64, 1, 128), device=cuda_device)
    with pytest.raises(ValueError, match="G up to"):
        dkernel.decode_attention_cuda(q, k, k, kv_len=64)
    q = torch.zeros((1, 1, 2, 16), device=cuda_device)
    k = torch.zeros((1, 64, 1, 16), device=cuda_device)
    with pytest.raises(ValueError, match="kv_len"):
        dkernel.decode_attention_cuda(q, k, k, kv_len=65)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        dkernel.decode_attention_cuda(q.half(), k.half(), k.half(), kv_len=9)
    with pytest.raises(ValueError, match="aligned"):
        odd = torch.zeros(64 * 16 + 1, device=cuda_device)[1:]
        dkernel.decode_attention_cuda(q, odd.view(1, 64, 1, 16), k,
                                      kv_len=9)
    with pytest.raises(ValueError, match="fused kernel"):
        decode_attention_partials(q, k, k, kv_len=9, bc=16)
