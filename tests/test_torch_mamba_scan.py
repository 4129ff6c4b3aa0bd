"""repro_torch's selective scan against the reference's.

The port's plain version (``mamba_scan_torch``) is the reference oracle's
sequential recurrence in float32, so on the same inputs, made with numpy
from a seed (the distributions of tests/test_kernel_mamba.py), it must
agree with ``mamba_scan_ref`` and with
``mamba_scan_kernel(..., interpret=True)`` within 1e-5, the bound the
repo's kernel test uses (the three differ only in the order of float32
sums).  The CUDA kernel takes any S and di, where the Pallas kernel
asserts S % chunk == 0 and di % bdi == 0, so a ragged shape is held
against the oracle.  On the CPU the dispatching wrapper takes the plain
version and never reaches the kernel loader.  The ``cuda``-marked tests at
the end hold both routes of the CUDA kernel (``tma`` where di % 4 == 0,
``simt`` otherwise or on request) against the plain version on the card;
they need no JAX (``python -m pytest -q -m cuda
tests/test_torch_mamba_scan.py``).
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cases  # noqa: E402,F401  (caps torch's CPU threads)

from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels.mamba_scan import (  # noqa: E402
    mamba_scan,
    mamba_scan_torch,
)
from repro_torch.kernels.mamba_scan import kernel as mkernel  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
#: (Bb, S, di, N, bdi, chunk): tests/test_kernel_mamba.py's shapes
CASES = [(2, 128, 64, 16, 32, 64), (1, 256, 128, 8, 128, 128),
         (3, 64, 32, 4, 32, 64)]


@pytest.fixture
def ref():
    """The reference's scan (JAX); the card machine has no JAX, so only the
    comparisons with the reference need it."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.mamba_scan.kernel import mamba_scan_kernel
    from repro.kernels.mamba_scan.ref import mamba_scan_ref
    return types.SimpleNamespace(jnp=jnp, kernel=mamba_scan_kernel,
                                 oracle=mamba_scan_ref)


def inputs(seed, Bb, S, di, N):
    """x, dt > 0, B, C, A < 0, float32, as the repo's kernel test draws
    them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bb, S, di)).astype(np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((Bb, S, di)) - 1))
    B = rng.standard_normal((Bb, S, N)).astype(np.float32) * 0.5
    C = rng.standard_normal((Bb, S, N)).astype(np.float32) * 0.5
    A = -np.exp(rng.standard_normal((di, N)) * 0.3)
    return [a.astype(np.float32) for a in (x, dt, B, C, A)]


def as_torch(arrays, device="cpu"):
    return [torch.as_tensor(a).to(device) for a in arrays]


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_oracle_and_pallas_kernel(case, ref):
    Bb, S, di, N, bdi, chunk = case
    arrays = inputs(0, Bb, S, di, N)
    y, h = mamba_scan_torch(*as_torch(arrays))
    assert y.dtype == torch.float32 and tuple(y.shape) == (Bb, S, di)
    assert h.dtype == torch.float32 and tuple(h.shape) == (Bb, di, N)
    js = [ref.jnp.asarray(a) for a in arrays]
    for wy, wh in (ref.oracle(*js),
                   ref.kernel(*js, bdi=bdi, chunk=chunk, interpret=True)):
        np.testing.assert_allclose(y.numpy(), np.asarray(wy), **TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(wh), **TOL)


def test_ragged_shape_matches_oracle(ref):
    """S and di that no chunk or tile divides: the port takes them."""
    arrays = inputs(1, 2, 77, 45, 16)
    y, h = mamba_scan(*as_torch(arrays))
    wy, wh = ref.oracle(*[ref.jnp.asarray(a) for a in arrays])
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(wh), **TOL)


def test_dispatch_keeps_x_dtype_and_never_launches_on_cpu():
    x, dt, B, C, A = as_torch(inputs(2, 1, 9, 8, 4))
    kbuild.reset_launches()
    y, h = mamba_scan(x.double(), dt, B, C, A)
    assert y.dtype == torch.float64 and h.dtype == torch.float32
    y32, h32 = mamba_scan_torch(x, dt, B, C, A)
    np.testing.assert_allclose(y.numpy(), y32.numpy(), rtol=1e-6, atol=1e-6)
    assert kbuild.LAUNCHES["mamba_scan"] == 0
    with pytest.raises(ValueError, match="cpu .* or cuda"):
        mamba_scan(x.to("meta"), dt, B, C, A)


def test_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        mkernel.mamba_scan_cuda(*as_torch(inputs(3, 1, 4, 8, 4)))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        mkernel.mamba_scan_cuda(*as_torch(inputs(3, 1, 4, 8, 4)), simt=True)


@pytest.mark.parametrize("N", mkernel.STATE_SIZES)
def test_route_is_tma_iff_a_row_of_x_is_16_byte_strided(N):
    """The tensor maps of the tma route need 16-byte strides: a row of x
    (di float32) qualifies iff di % 4 == 0; B and C rows (N float32) always
    do.  Jamba's di (8192) and the ragged smoke shape's (8100) take tma."""
    for di in range(1, 400):
        assert mkernel.route(di, N) == ("tma" if di % 4 == 0 else "simt")
    assert mkernel.route(8192, N) == mkernel.route(8100, N) == "tma"


# ---------------------------------------------------------------------------
# On the card: the CUDA kernel against the plain version
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


#: (Bb, S, di, N): the reference test's shapes, a ragged one, and a
#: reduced jamba prefill (di 8192 of the full width); S not a multiple of
#: the tma route's 16-step stage with di % 4 == 0 but di % 128 != 0; and
#: Bb = 3 with a ragged S, where a box read across batch rows would show
CARD_CASES = CASES[:1] + [(2, 77, 45, 16), (1, 300, 8192, 16),
                          (2, 64, 100, 8), (1, 33, 64, 32),
                          (2, 77, 100, 16), (3, 77, 256, 8), (4, 45, 132, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
def test_kernel_matches_plain_on_card(case, cuda_device):
    Bb, S, di, N = case[:4]
    args = as_torch(inputs(4, Bb, S, di, N), cuda_device)
    kbuild.reset_launches()
    y, h = mamba_scan(*args)
    torch.cuda.synchronize()
    assert kbuild.LAUNCHES["mamba_scan"] == 1
    wy, wh = mamba_scan_torch(*args)
    np.testing.assert_allclose(y.cpu().numpy(), wy.cpu().numpy(), **TOL)
    np.testing.assert_allclose(h.cpu().numpy(), wh.cpu().numpy(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
def test_both_routes_match_plain_on_card(case, cuda_device):
    """Each call is one launch on the route ``kernel.route`` picks, or on
    ``simt`` when forced; both agree with the plain version at 1e-5, and
    with each other, on the same inputs."""
    Bb, S, di, N = case[:4]
    args = as_torch(inputs(6, Bb, S, di, N), cuda_device)
    wy, wh = mamba_scan_torch(*args)
    got = {}
    for simt in (False, True):
        want_route = "simt" if simt else mkernel.route(di, N)
        kbuild.reset_launches()
        got[simt] = mkernel.mamba_scan_cuda(*args, simt=simt)
        torch.cuda.synchronize()
        assert kbuild.ROUTES == {f"mamba_scan/{want_route}": 1}
        assert kbuild.LAUNCHES["mamba_scan"] == 1
        y, h = got[simt]
        np.testing.assert_allclose(y.cpu().numpy(), wy.cpu().numpy(), **TOL)
        np.testing.assert_allclose(h.cpu().numpy(), wh.cpu().numpy(), **TOL)
    for a, b in zip(got[False], got[True]):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), **TOL)


@pytest.mark.cuda
def test_tma_route_reads_no_other_batch_row(cuda_device):
    """Batch rows of very different scale, S ragged against the stage: a
    tma box that ran past S into the next batch row would carry that
    row's large x into this row's last steps.  y and h are linear in x,
    so the large row is held at its scale times the tolerance."""
    Bb, S, di, N = 3, 37, 128, 16
    x, dt, B, C, A = as_torch(inputs(7, Bb, S, di, N), cuda_device)
    scale = [1e-3, 1e3, 1e-3]
    x = x * torch.tensor(scale, device=cuda_device)[:, None, None]
    kbuild.reset_launches()
    y, h = mamba_scan(x, dt, B, C, A)
    torch.cuda.synchronize()
    assert kbuild.ROUTES == {"mamba_scan/tma": 1}
    wy, wh = mamba_scan_torch(x, dt, B, C, A)
    for b, sc in enumerate(scale):
        tol = dict(rtol=TOL["rtol"], atol=TOL["atol"] * max(sc, 1.0))
        np.testing.assert_allclose(y[b].cpu().numpy(), wy[b].cpu().numpy(),
                                   **tol)
        np.testing.assert_allclose(h[b].cpu().numpy(), wh[b].cpu().numpy(),
                                   **tol)


@pytest.mark.cuda
def test_tma_route_refuses_misaligned_tensors(cuda_device):
    x, dt, B, C, A = as_torch(inputs(8, 1, 9, 8, 4), cuda_device)
    flat = torch.zeros(x.numel() + 1, device=cuda_device)
    shifted = flat[1:].view_as(x)          # 4 bytes past an aligned base
    shifted.copy_(x)
    kbuild.reset_launches()
    with pytest.raises(ValueError, match="aligned"):
        mkernel.mamba_scan_cuda(shifted, dt, B, C, A)
    assert kbuild.LAUNCHES["mamba_scan"] == 0
    y, _ = mkernel.mamba_scan_cuda(shifted, dt, B, C, A, simt=True)
    wy, _ = mamba_scan_torch(x, dt, B, C, A)
    np.testing.assert_allclose(y.cpu().numpy(), wy.cpu().numpy(), **TOL)


@pytest.mark.cuda
def test_bf16_cuda_tensor_raises(cuda_device):
    args = as_torch(inputs(5, 1, 8, 32, 16), cuda_device)
    args[0] = args[0].to(torch.bfloat16)
    kbuild.reset_launches()
    with pytest.raises(TypeError, match="float32"):
        mamba_scan(*args)
    assert kbuild.LAUNCHES["mamba_scan"] == 0
