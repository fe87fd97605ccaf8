"""Circular convolution with a PSF spectrum — the framework's blur model.

utils/blurgen.py synthesizes every blurred input by spectral
multiplication with the corner-anchored PSF, i.e. CIRCULAR convolution
(reference others/gen_blurred_img.ipynb cell 1); this module is the
forward operator of that model as a reusable device function. Both
iterative restoration (models/richardson_lucy.py) and edge tapering
(models/edgetaper.py) are built on it. Everything is SoA (re, im)
float32 planes (ops/fft.py).
"""

from __future__ import annotations

import jax.numpy as jnp

from fft_restoration_tpu.ops.fft import DEFAULT_FFT_BACKEND, fft2d


def _conv_planes(re, im, s_re, s_im, backend):
    """Circular convolution of independent real planes (re, im) with the
    spectrum (s_re, s_im): (..., Hp, Wp) -> (..., Hp, Wp), scaled."""
    hp, wp = re.shape[-2:]
    a_re, a_im = fft2d(re, im, False, backend)
    c_re = a_re * s_re - a_im * s_im
    c_im = a_re * s_im + a_im * s_re
    b_re, b_im = fft2d(c_re, c_im, True, backend)
    scale = jnp.float32(1.0 / (hp * wp))
    return b_re * scale, b_im * scale


def circular_conv_builder(
    psf: jnp.ndarray,
    hp: int,
    wp: int,
    *,
    fft_backend: str = DEFAULT_FFT_BACKEND,
):
    """Build conv(re, im, conj=False) circularly convolving independent
    real (..., hp, wp) planes with the corner-anchored PSF (conj=True
    convolves with the mirrored PSF — conj(H) for a real kernel).

    The PSF spectrum is computed once at build (traced) time and closed
    over, so a loop around conv (RL, tiles) reuses it."""
    from fft_restoration_tpu.models.pipeline import _pad2d

    psf_pad = _pad2d(psf, hp, wp)
    h_re, h_im = fft2d(psf_pad, jnp.zeros_like(psf_pad), False, fft_backend)

    def conv(re, im, conj=False):
        return _conv_planes(
            re, im, h_re, (-h_im if conj else h_im), fft_backend
        )

    return conv
