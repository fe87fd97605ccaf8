"""Forward FFT + Wiener filter on the xla route vs NumPy float64."""

import numpy as np

import jax.numpy as jnp

from fft_restoration_tpu.ops.fft import fft2d
from fft_restoration_tpu.ops.wiener import wiener_filter


def _fwd_wiener(a_re, a_im, h, K):
    G = fft2d(jnp.asarray(a_re), jnp.asarray(a_im), False, "xla")
    return wiener_filter(G, (jnp.asarray(h[0]), jnp.asarray(h[1])), K)


def _ref(a, h, K):
    G = np.fft.fft2(a)
    H = h[0] + 1j * h[1]
    return G * np.conj(H) / (np.abs(H) ** 2 + K)


def test_fwd_wiener_fused_matches_unfused(rng):
    n, m = 64, 16
    a_re = rng.standard_normal((3, m, n)).astype(np.float32)
    a_im = rng.standard_normal((3, m, n)).astype(np.float32)
    h = rng.standard_normal((2, m, n)).astype(np.float32)
    ours = _fwd_wiener(a_re, a_im, h, 0.01)
    ref = _ref(a_re + 1j * a_im, h, 0.01)
    scale = max(np.abs(ref).max(), 1.0)
    assert np.abs(np.asarray(ours[0]) - ref.real).max() / scale < 1e-5
    assert np.abs(np.asarray(ours[1]) - ref.imag).max() / scale < 1e-5


def test_fused_ragged_rows(rng):
    # m = 12 rows: not a power of two
    n, m = 32, 12
    a_re = rng.standard_normal((2, m, n)).astype(np.float32)
    a_im = rng.standard_normal((2, m, n)).astype(np.float32)
    h = rng.standard_normal((2, m, n)).astype(np.float32)
    ours = _fwd_wiener(a_re, a_im, h, 0.05)
    ref = _ref(a_re + 1j * a_im, h, 0.05)
    scale = max(np.abs(ref).max(), 1.0)
    assert np.abs(np.asarray(ours[0]) - ref.real).max() / scale < 1e-5
