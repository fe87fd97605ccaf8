"""The spectral middle of the restore (forward FFT -> Wiener ->
inverse FFT) on the xla route vs a float64 NumPy composition."""

import numpy as np

import jax.numpy as jnp

from fft_restoration_tpu.ops.fft import fft2d
from fft_restoration_tpu.ops.wiener import wiener_filter


def _middle(a_re, a_im, h, K, backend="xla"):
    G = fft2d(jnp.asarray(a_re), jnp.asarray(a_im), False, backend)
    H = fft2d(jnp.asarray(h), jnp.zeros_like(jnp.asarray(h)), False, backend)
    F = wiener_filter(G, H, K)
    return fft2d(F[0], F[1], True, backend)


def _middle_np(a, h, K):
    G = np.fft.fft2(a)
    H = np.fft.fft2(h)
    return np.fft.ifft2(G * np.conj(H) / (np.abs(H) ** 2 + K)) * a.shape[-1] * a.shape[-2]


def test_megakernel_matches_unfused(rng):
    """The composed middle equals the float64 composition."""
    n = 64
    a_re = rng.standard_normal((3, 16, n)).astype(np.float32)
    a_im = rng.standard_normal((3, 16, n)).astype(np.float32)
    h = rng.random((16, n)).astype(np.float32)
    ours = _middle(a_re, a_im, h, 0.01)
    ref = _middle_np(a_re + 1j * a_im, h, 0.01)
    scale = max(np.abs(ref).max(), 1.0)
    assert np.abs(np.asarray(ours[0]) - ref.real).max() / scale < 1e-3
    assert np.abs(np.asarray(ours[1]) - ref.imag).max() / scale < 1e-3


def test_spectral_rows_t_matches_pair(rng):
    """xla and the matmul four-step give the same middle at (2, 128, 256)
    for a real (corner-anchored motion) PSF; a random-noise H would be
    ill-conditioned and measure the conditioning, not the transforms."""
    from fft_restoration_tpu.oracle.psf import motion_blur_kernel_oracle

    m, n = 128, 256
    a = rng.standard_normal((2, m, n)).astype(np.float32)
    h = np.zeros((m, n), np.float32)
    h[:9, :9] = motion_blur_kernel_oracle(9, 30.0)
    zero = np.zeros_like(a)
    pr, pi = _middle(a, zero, h, 0.01, "matmul")
    out = _middle(a, zero, h, 0.01, "xla")
    scale = max(np.abs(np.asarray(pr)).max(), 1.0)
    assert np.abs(np.asarray(out[0]) - np.asarray(pr)).max() / scale < 1e-5
    assert np.abs(np.asarray(out[1]) - np.asarray(pi)).max() / scale < 1e-5


def test_spectral_rows_t_fallback_on_unaligned(rng):
    """Extents with no power-of-two or alignment structure (50 rows) run
    on the library route unchanged."""
    a = rng.standard_normal((50, 256)).astype(np.float32)
    h = rng.random((50, 256)).astype(np.float32)
    ours = _middle(a, np.zeros_like(a), h, 0.01)
    ref = _middle_np(a.astype(np.complex128), h, 0.01)
    scale = max(np.abs(ref).max(), 1.0)
    assert np.abs(np.asarray(ours[0]) - ref.real).max() / scale < 1e-5
