"""jnp SoA FFT backends vs np.fft and vs the NumPy oracle."""

import numpy as np
import pytest

import jax.numpy as jnp

from fft_restoration_tpu.ops.fft import fft1d, fft2d, FFT_BACKENDS
from fft_restoration_tpu.oracle.serial import fft_radix2 as oracle_fft


def _to_c(pair):
    return np.asarray(pair[0]).astype(np.complex128) + 1j * np.asarray(pair[1])


@pytest.mark.parametrize("backend", FFT_BACKENDS)
@pytest.mark.parametrize("n", [2, 8, 64, 512])
def test_fft1d_matches_npfft(rng, backend, n):
    re = rng.standard_normal((4, n)).astype(np.float32)
    im = rng.standard_normal((4, n)).astype(np.float32)
    ref = np.fft.fft(re.astype(np.complex128) + 1j * im, axis=-1)
    ours = _to_c(fft1d(jnp.asarray(re), jnp.asarray(im), False, backend))
    assert np.abs(ours - ref).max() / np.abs(ref).max() < 1e-5


@pytest.mark.parametrize("backend", ("radix2", "matmul"))
def test_fft1d_inverse_unscaled(rng, backend):
    n = 128
    re = rng.standard_normal((2, n)).astype(np.float32)
    im = rng.standard_normal((2, n)).astype(np.float32)
    f = fft1d(jnp.asarray(re), jnp.asarray(im), False, backend)
    b = fft1d(f[0], f[1], True, backend)
    # unscaled inverse: round trip gains a factor n
    assert np.abs(np.asarray(b[0]) / n - re).max() < 1e-4
    assert np.abs(np.asarray(b[1]) / n - im).max() < 1e-4


@pytest.mark.parametrize("backend", ("radix2", "matmul", "naive"))
def test_fft2d_matches_npfft2(rng, backend):
    re = rng.standard_normal((2, 32, 64)).astype(np.float32)
    ref = np.fft.fft2(re.astype(np.complex128))
    ours = _to_c(fft2d(jnp.asarray(re), jnp.zeros_like(jnp.asarray(re)), False, backend))
    assert np.abs(ours - ref).max() / np.abs(ref).max() < 1e-5


def test_non_pow2_falls_back_to_naive(rng):
    re = rng.standard_normal((3, 12)).astype(np.float32)
    ref = np.fft.fft(re.astype(np.complex128), axis=-1)
    ours = _to_c(fft1d(jnp.asarray(re), jnp.zeros((3, 12), jnp.float32), False, "radix2"))
    assert np.abs(ours - ref).max() < 1e-4


def test_matches_oracle_radix2(rng):
    """radix2 backend (exact tables) vs oracle (recurrence twiddles): same
    transform within the reference's own cross-mode tolerance tiers."""
    n = 256
    x = (rng.standard_normal((4, n)) + 1j * rng.standard_normal((4, n))).astype(
        np.complex64
    )
    o = oracle_fft(x, inverse=False)
    ours = _to_c(fft1d(jnp.asarray(x.real), jnp.asarray(x.imag), False, "radix2"))
    assert np.abs(ours - o).max() / np.abs(o).max() < 1e-5


def test_bad_backend_raises(rng):
    with pytest.raises(ValueError):
        fft1d(jnp.zeros((2, 8)), jnp.zeros((2, 8)), False, "cufft")
