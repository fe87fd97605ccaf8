"""Richardson-Lucy iterative deconvolution.

The reference family is one-shot spectral filters (Wiener everywhere,
inverse/CLS in the lineage, others/fft_image_restoration.py); RL is the
classic ITERATIVE restoration the family lacks — a multiplicative
fixed-point iteration

    x_{k+1} = x_k * C(psf_flipped, y / (C(psf, x_k) + eps))

with C = circular convolution (the framework's blur model: blurgen.py
synthesizes inputs by spectral multiplication, i.e. circular
convolution). In the frequency domain C(psf, .) is one fwd/inv FFT
round trip times the PSF spectrum, and the mirrored-PSF convolution is
the same round trip times conj(H) (real PSF).

Design:
  * the iteration is a `jax.lax.fori_loop` — one compiled body,
    constant graph size regardless of iteration count;
  * the PSF spectrum is hoisted out of the loop (computed once);
  * channels ride complex pairs (models/pipeline._pack_channel_pairs):
    the convs are linear so re/im planes stay the two real channels,
    and RL's nonlinear steps (divide, multiply) are PLANE-wise spatial
    ops — they never mix re and im, so the packing survives the whole
    iteration. 3 channels = 2 complex FFT chains, exactly like Wiener.

Nonexistent in the reference — cited against the family it extends
(reference others/fft_image_restoration.py:45-92, the spectral restore
prototype).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from fft_restoration_tpu.models.convolve import circular_conv_builder
from fft_restoration_tpu.ops.fft import DEFAULT_FFT_BACKEND


def richardson_lucy_planes(
    channels: jnp.ndarray,
    psf: jnp.ndarray,
    n_iters: int = 10,
    *,
    eps: float = 1e-6,
    fft_backend: str = DEFAULT_FFT_BACKEND,
) -> jnp.ndarray:
    """RL-deconvolve (..., Hp, Wp) padded planes with a (S, S) PSF.

    channels: float32 in [0, 1] (uint8 is converted), the observed
    blurred planes at their padded DFT extents. Returns restored planes
    CLIPPED to [0, 1] — not min-max normalized like the one-shot
    spectral filters: RL is flux-preserving (the multiplicative update
    keeps the mean near the observation's), and its boundary-ringing
    spikes on real (non-circularly-blurred) inputs can reach 10-30x the
    signal, so a min-max stretch would crush the whole image to ~black
    (measured on the car fixture: mean 0.5, max 30.8 after 20 iters).
    Clipping keeps the intensity scale and saturates only the spikes.

    The blur model is CIRCULAR convolution with the corner-anchored PSF
    (what blurgen.py synthesizes); boundary ringing on non-synthetic
    inputs is inherent to that model, exactly as for the Wiener path.

    Cross-implementation parity note: the multiplicative divisions
    amplify ANY f32 transform rounding difference — equivalent FFT
    backends (matmul/radix2/xla, or sharded-vs-single) measure ~1e-2
    plane INF apart after a few iterations on padded inputs (a few
    uint8 counts), where the one-shot filters hold 1e-3. This is
    intrinsic to RL, not an implementation defect; parity contracts
    for RL are therefore uint8-level or 5e-2 plane INF
    (__graft_entry__.py dryrun, tests/test_richardson_lucy.py).
    """
    from fft_restoration_tpu.models.pipeline import (
        _pack_channel_pairs,
        _unpack_channel_pairs,
    )

    if channels.dtype == jnp.uint8:
        channels = channels.astype(jnp.float32) / jnp.float32(255.0)
    hp, wp = channels.shape[-2:]

    # PSF spectrum hoisted out of the loop
    conv = circular_conv_builder(psf, hp, wp, fft_backend=fft_backend)

    packed = channels.ndim >= 3 and channels.shape[-3] >= 2
    if packed:
        c = channels.shape[-3]
        y_re, y_im = _pack_channel_pairs(channels)
    else:
        c = None
        y_re, y_im = channels, jnp.zeros_like(channels)

    eps32 = jnp.float32(eps)

    def body(_, x):
        x_re, x_im = x
        d_re, d_im = conv(x_re, x_im, conj=False)
        # plane-wise spatial ops: re/im are independent real channels
        r_re = y_re / (d_re + eps32)
        r_im = y_im / (d_im + eps32)
        g_re, g_im = conv(r_re, r_im, conj=True)
        return (
            jnp.maximum(x_re * g_re, 0.0),
            jnp.maximum(x_im * g_im, 0.0),
        )

    x_re, x_im = jax.lax.fori_loop(0, n_iters, body, (y_re, y_im))
    restored = x_re if c is None else _unpack_channel_pairs(x_re, x_im, c)
    return jnp.clip(restored, 0.0, 1.0)
