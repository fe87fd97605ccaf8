"""Edge tapering on device: blend the frame toward its circular blur.

tapered = alpha * x + (1 - alpha) * blur(x), with alpha the separable
raised-cosine window of utils/taper.py and blur the framework's
circular-convolution forward model (models/convolve.py). Run BEFORE the
forward FFT of any deconvolution (--edgetaper in the CLI), it removes
the wrap discontinuity that rings through Wiener and Richardson-Lucy
restorations of real (non-circularly-blurred) photos; in the DFT pad
region alpha = 0, so the zero pad is replaced by the blur's own smooth
wrap tail.

The blur rides the packed-channel-pair trick (models/pipeline.
_pack_channel_pairs): convolution is linear, so the re/im planes stay
independent channels and 3 channels cost 2 complex FFT chains. The
oracle-side twin is oracle/edgetaper.py; both bake the identical window
coefficients, so the differential verification contract (CLI verify vs
oracle) holds with tapering enabled on both sides.

Not in the reference (it deconvolves the zero-padded frame as-is,
fft_serial.cpp:157-171, and shows the ringing); cited as an extension
of the restoration family it completes.
"""

from __future__ import annotations

import jax.numpy as jnp

from fft_restoration_tpu.models.convolve import circular_conv_builder
from fft_restoration_tpu.ops.fft import DEFAULT_FFT_BACKEND
from fft_restoration_tpu.utils.taper import taper_windows


def edge_taper_planes(
    channels: jnp.ndarray,
    psf: jnp.ndarray,
    live_hw: tuple[int, int],
    *,
    fft_backend: str = DEFAULT_FFT_BACKEND,
) -> jnp.ndarray:
    """Taper (..., Hp, Wp) zero-padded float32 planes whose live image
    occupies the top-left live_hw = (h, w) extent. Returns planes of the
    same shape, ready for the forward restoration FFT."""
    if channels.dtype == jnp.uint8:
        channels = channels.astype(jnp.float32) / jnp.float32(255.0)
    hp, wp = channels.shape[-2:]
    h, w = live_hw
    wy, wx = taper_windows(h, w, hp, wp, psf.shape[-1])
    alpha = jnp.asarray(wy)[:, None] * jnp.asarray(wx)[None, :]

    conv = circular_conv_builder(psf, hp, wp, fft_backend=fft_backend)

    packed = channels.ndim >= 3 and channels.shape[-3] >= 2
    if packed:
        from fft_restoration_tpu.models.pipeline import (
            _pack_channel_pairs,
            _unpack_channel_pairs,
        )

        c = channels.shape[-3]
        x_re, x_im = _pack_channel_pairs(channels)
        b_re, b_im = conv(x_re, x_im)
        blurred = _unpack_channel_pairs(b_re, b_im, c)
    else:
        b_re, _ = conv(channels, jnp.zeros_like(channels))
        blurred = b_re
    return alpha * channels + (1.0 - alpha) * blurred
