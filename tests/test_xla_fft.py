"""The cuFFT route (fft backend 'xla', jnp.fft) vs np.fft references.

On the CPU test backend jnp.fft is pocketfft; on the GPU the same graph
lowers to cuFFT (chip_smoke.py checks that at 2048²). These cases pin
the SoA wrapper around the library call: layout, batching, the unscaled
inverse, non-power-of-two lengths and the axis handling of fft2d.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from fft_restoration_tpu.ops.fft import fft1d, fft2d
from fft_restoration_tpu.ops.wiener import wiener_filter


def _c(pair):
    return np.asarray(pair[0]) + 1j * np.asarray(pair[1])


def _rel(ours, ref):
    return np.abs(ours - ref).max() / max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("n", [2, 8, 128, 512])
def test_fft_rows_xla_matches_npfft(rng, n):
    re = rng.standard_normal((16, n)).astype(np.float32)
    im = rng.standard_normal((16, n)).astype(np.float32)
    ours = _c(fft1d(jnp.asarray(re), jnp.asarray(im), False, "xla"))
    ref = np.fft.fft(re.astype(np.complex128) + 1j * im, axis=-1)
    assert _rel(ours, ref) < 1e-5


def test_fft_rows_xla_inverse_roundtrip(rng):
    re = rng.standard_normal((4, 64)).astype(np.float32)
    zero = jnp.zeros((4, 64), jnp.float32)
    r, i = fft1d(jnp.asarray(re), zero, False, "xla")
    r2, _ = fft1d(r, i, True, "xla")
    assert np.abs(np.asarray(r2) / 64 - re).max() < 1e-5


def test_fft_rows_xla_3d_batch(rng):
    re = rng.standard_normal((3, 8, 32)).astype(np.float32)
    ours = _c(fft1d(jnp.asarray(re), jnp.zeros_like(jnp.asarray(re)), False, "xla"))
    ref = np.fft.fft(re.astype(np.complex128), axis=-1)
    assert ours.shape == (3, 8, 32)
    assert np.abs(ours - ref).max() / np.abs(ref).max() < 1e-5


def test_fft_rows_xla_ragged_batch(rng):
    # a batch of 7 rows: no blocking constraint on the library route
    re = rng.standard_normal((7, 16)).astype(np.float32)
    ours = _c(fft1d(jnp.asarray(re), jnp.zeros_like(jnp.asarray(re)), False, "xla"))
    ref = np.fft.fft(re.astype(np.complex128), axis=-1)
    assert np.abs(ours - ref).max() < 1e-4


def test_fft_rows_xla_accepts_non_pow2(rng):
    re = rng.standard_normal((4, 12)).astype(np.float32)
    ours = _c(fft1d(jnp.asarray(re), jnp.zeros((4, 12)), False, "xla"))
    ref = np.fft.fft(re.astype(np.complex128), axis=-1)
    assert _rel(ours, ref) < 1e-5


@pytest.mark.parametrize("shape", [(2, 24, 32), (2, 32, 24)])
def test_fft2d_xla_transpose_commutes(rng, shape):
    """fft2d of the transposed planes == transposed fft2d (the 2D
    transform is one library call over both axes)."""
    re = rng.standard_normal(shape).astype(np.float32)
    im = rng.standard_normal(shape).astype(np.float32)
    r0, i0 = fft2d(jnp.asarray(re), jnp.asarray(im), False, "xla")
    r1, i1 = fft2d(
        jnp.asarray(np.swapaxes(re, -1, -2)),
        jnp.asarray(np.swapaxes(im, -1, -2)), False, "xla",
    )
    assert r1.shape == shape[:1] + shape[:0:-1]
    ours = np.swapaxes(_c((r1, i1)), -1, -2)
    assert _rel(ours, _c((r0, i0))) < 1e-6


def test_fft2d_xla_real_input_ragged(rng):
    re = rng.standard_normal((20, 16)).astype(np.float32)
    ours = _c(fft2d(jnp.asarray(re), jnp.zeros((20, 16)), False, "xla"))
    ref = np.fft.fft2(re.astype(np.complex128))
    assert np.abs(ours - ref).max() / np.abs(ref).max() < 1e-5


def test_minmax_normalize_per_plane(rng):
    """Per-plane min/max of the restored planes map to exactly 0 and 1
    (the normalize the pipeline runs after the inverse FFT)."""
    from fft_restoration_tpu.models.pipeline import _minmax_normalize

    x = rng.standard_normal((3, 8, 32)).astype(np.float32) * 7.0 - 2.0
    out = np.asarray(_minmax_normalize(jnp.asarray(x)))
    np.testing.assert_allclose(out.min(axis=(-2, -1)), 0.0, atol=1e-7)
    np.testing.assert_allclose(out.max(axis=(-2, -1)), 1.0, rtol=3e-7)
    flat = np.asarray(_minmax_normalize(jnp.ones((2, 4, 4))))
    assert (flat == 0.0).all()  # degenerate range -> scale 0


def test_fft2d_xla_inverse_of_hermitian_is_real(rng):
    """The inverse of a real plane's spectrum has a zero imaginary part
    (the pipeline keeps only the real plane of single-channel inputs)."""
    re = rng.standard_normal((4, 32)).astype(np.float32)
    F = fft2d(jnp.asarray(re), jnp.zeros((4, 32)), False, "xla")
    r, i = fft2d(F[0], F[1], True, "xla")
    assert np.abs(np.asarray(i)).max() <= 4e-6 * max(1.0, np.abs(np.asarray(r)).max())
    np.testing.assert_allclose(np.asarray(r) / 128, re, atol=1e-5)


# ---------------------------------------------------------------------------
# columns: the transform over the second-to-last axis, as the sharded
# path runs it after its all_to_all transpose


def _cols(re, im, inverse=False):
    r, i = fft1d(
        jnp.swapaxes(jnp.asarray(re), -1, -2),
        jnp.swapaxes(jnp.asarray(im), -1, -2), inverse, "xla",
    )
    return jnp.swapaxes(r, -1, -2), jnp.swapaxes(i, -1, -2)


@pytest.mark.parametrize("h", [2, 8, 128])
def test_fft_cols_xla_matches_npfft(rng, h):
    re = rng.standard_normal((h, 16)).astype(np.float32)
    im = rng.standard_normal((h, 16)).astype(np.float32)
    ours = _c(_cols(re, im))
    ref = np.fft.fft(re.astype(np.complex128) + 1j * im, axis=0)
    assert _rel(ours, ref) < 1e-5


def test_fft_cols_xla_inverse_roundtrip(rng):
    re = rng.standard_normal((64, 8)).astype(np.float32)
    r, i = _cols(re, np.zeros_like(re))
    r2, _ = _cols(r, i, inverse=True)
    assert np.abs(np.asarray(r2) / 64 - re).max() < 1e-5


def test_fft2d_xla_roundtrip(rng):
    re = rng.standard_normal((32, 8)).astype(np.float32)
    r, i = fft2d(jnp.asarray(re), jnp.zeros((32, 8)), False, "xla")
    r2, _ = fft2d(r, i, True, "xla")
    assert np.abs(np.asarray(r2) / 256 - re).max() < 1e-5


def test_fft_cols_xla_3d_batch_and_ragged_cols(rng):
    re = rng.standard_normal((2, 16, 7)).astype(np.float32)
    ours = _c(_cols(re, np.zeros_like(re)))
    ref = np.fft.fft(re.astype(np.complex128), axis=-2)
    assert ours.shape == (2, 16, 7)
    assert np.abs(ours - ref).max() / np.abs(ref).max() < 1e-5


def test_fft_cols_xla_accepts_non_pow2(rng):
    re = rng.standard_normal((12, 4)).astype(np.float32)
    ours = _c(_cols(re, np.zeros_like(re)))
    ref = np.fft.fft(re.astype(np.complex128), axis=0)
    assert _rel(ours, ref) < 1e-5


def test_fft2d_xla_matches_fft2(rng):
    x = rng.standard_normal((32, 16)).astype(np.float32)
    ours = _c(fft2d(jnp.asarray(x), jnp.zeros((32, 16)), False, "xla"))
    ref = np.fft.fft2(x.astype(np.complex128))
    assert np.abs(ours - ref).max() / np.abs(ref).max() < 1e-5


def test_wiener_filter_matches_complex_formula(rng):
    gr = rng.standard_normal((3, 16, 128)).astype(np.float32)
    gi = rng.standard_normal((3, 16, 128)).astype(np.float32)
    hr = rng.standard_normal((16, 128)).astype(np.float32)
    hi = rng.standard_normal((16, 128)).astype(np.float32)
    ours = wiener_filter(
        (jnp.asarray(gr), jnp.asarray(gi)), (jnp.asarray(hr), jnp.asarray(hi)), 0.01
    )
    G, H = gr + 1j * gi, hr + 1j * hi
    ref = G * np.conj(H) / (np.abs(H) ** 2 + 0.01)
    assert np.abs(np.asarray(ours[0]) - ref.real).max() < 1e-4
    assert np.abs(np.asarray(ours[1]) - ref.imag).max() < 1e-4


def test_unknown_backend_and_shape_mismatch_raise():
    with pytest.raises(ValueError, match="unknown fft backend"):
        fft2d(jnp.zeros((4, 4)), jnp.zeros((4, 4)), backend="pallas")
    with pytest.raises(ValueError, match="shape mismatch"):
        fft1d(jnp.zeros((4, 4)), jnp.zeros((4, 8)))


def test_xla_inverse_is_unscaled_like_the_other_backends(rng):
    """The inverse carries no 1/n, matching radix2/matmul, so the
    backends are interchangeable under the pipeline's normalize."""
    re = rng.standard_normal((2, 16, 16)).astype(np.float32)
    im = rng.standard_normal((2, 16, 16)).astype(np.float32)
    ref = np.fft.ifft2(re + 1j * im) * 256
    for backend in ("xla", "matmul"):
        ours = _c(fft2d(jnp.asarray(re), jnp.asarray(im), True, backend))
        assert _rel(ours, ref) < 1e-5, backend
