"""repro_torch counter-hash RNG against the reference's.

``hash_u32`` and ``hash_uniform`` are integer arithmetic (uint32 wrap-around,
computed in the port as int64 masked to 32 bits) plus an exact float32
construction, so they must be bitwise equal to the reference's jnp functions
and to the event engine's numpy twins, negative int32 keys included.
``hash_normal`` and ``lognormal_factor`` go through log, cos, sqrt and exp,
whose float32 results differ between libm/XLA and torch by an ulp or so:
they are held to ``rtol=1e-6`` (a few float32 ulps), no looser.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.runtime import window_core as jwc  # noqa: E402
from repro.runtime.faults import np_hash_u32, np_hash_uniform  # noqa: E402
from repro_torch.runtime import window_core as twc  # noqa: E402

#: libm-ulp tolerance for the transcendental draws (float32 eps is 1.2e-7)
TRANSCENDENTAL_RTOL = 1e-6


def _keys(seed, n=4096):
    rng = np.random.default_rng(seed)
    k1 = rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64).astype(np.int32)
    k2 = rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64).astype(np.int32)
    k3 = rng.integers(0, 1 << 20, n).astype(np.int32)
    # the extremes wrap like astype(uint32) does
    k1[:4] = [-1, -2 ** 31, 2 ** 31 - 1, 0]
    return k1, k2, k3


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hash_u32_bitwise(seed):
    k1, k2, k3 = _keys(seed)
    want_j = np.asarray(jwc.hash_u32(seed, 3, jnp.asarray(k1),
                                     jnp.asarray(k2), jnp.asarray(k3)))
    want_np = np_hash_u32(seed, 3, k1, k2, k3)
    got = twc.hash_u32(seed, 3, torch.as_tensor(k1), torch.as_tensor(k2),
                       torch.as_tensor(k3))
    assert got.dtype == torch.int64
    got = got.numpy()
    assert got.min() >= 0 and got.max() < 2 ** 32
    np.testing.assert_array_equal(got.astype(np.uint32), want_j)
    np.testing.assert_array_equal(got.astype(np.uint32), want_np)


def test_hash_u32_broadcasts_and_takes_tensor_seeds():
    k1, k2, _ = _keys(7, 64)
    seed = torch.tensor(-5, dtype=torch.int32)
    got = twc.hash_u32(seed, torch.as_tensor(k1)[:, None],
                       torch.as_tensor(k2)[None, :8]).numpy()
    want = np.asarray(jwc.hash_u32(jnp.int32(-5), jnp.asarray(k1)[:, None],
                                   jnp.asarray(k2)[None, :8]))
    assert got.shape == (64, 8)
    np.testing.assert_array_equal(got.astype(np.uint32), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hash_uniform_bitwise(seed):
    k1, k2, k3 = _keys(seed)
    want_j = np.asarray(jwc.hash_uniform(seed, jnp.asarray(k1),
                                         jnp.asarray(k2), jnp.asarray(k3)))
    want_np = np_hash_uniform(seed, k1, k2, k3)
    got = twc.hash_uniform(seed, torch.as_tensor(k1), torch.as_tensor(k2),
                           torch.as_tensor(k3))
    assert got.dtype == torch.float32
    got = got.numpy()
    assert (got > 0).all() and (got < 1).all()
    np.testing.assert_array_equal(got, want_j)
    np.testing.assert_array_equal(got, want_np)


def test_hash_normal_within_libm_ulps():
    k1, k2, _ = _keys(11)
    want = np.asarray(jwc.hash_normal(5, jnp.asarray(k1), jnp.asarray(k2)))
    got = twc.hash_normal(5, torch.as_tensor(k1), torch.as_tensor(k2))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TRANSCENDENTAL_RTOL,
                               atol=1e-6)


@pytest.mark.parametrize("sigma", [0.0, 0.15, 0.5])
def test_lognormal_factor_within_libm_ulps(sigma):
    k1, k2, _ = _keys(13)
    want = np.asarray(jwc.lognormal_factor(sigma, 5, jwc.STREAM_STEP,
                                           jnp.asarray(k1), jnp.asarray(k2)))
    got = twc.lognormal_factor(sigma, 5, twc.STREAM_STEP,
                               torch.as_tensor(k1), torch.as_tensor(k2))
    assert got.dtype == torch.float32 and got.shape == want.shape
    if sigma == 0.0:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want,
                                   rtol=TRANSCENDENTAL_RTOL)


def test_stream_tags_match_reference():
    for name in ("STREAM_STEP", "STREAM_STALL", "STREAM_LAT", "STREAM_APP",
                 "STREAM_MUT", "STREAM_LOSS", "STREAM_FLAP"):
        assert getattr(twc, name) == getattr(jwc, name), name
