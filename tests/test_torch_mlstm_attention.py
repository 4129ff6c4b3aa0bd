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
