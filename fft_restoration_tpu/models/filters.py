"""Restoration filter family.

The reference ships Wiener only (every fft_<mode>.cpp), but its lineage
(others/fft_image_restoration.py) references inverse and constrained-
least-squares filtering; all three share the FFT plumbing, so the family
is first-class here. Each entry maps SoA (G, H, params) -> F in the
frequency domain.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from fft_restoration_tpu.ops.wiener import wiener_filter, inverse_filter, cls_filter
from fft_restoration_tpu.ops.fft import DEFAULT_FFT_BACKEND, fft2d


def _laplacian_fft(shape, backend: str):
    """FFT of the corner-anchored 3x3 Laplacian regularizer, for CLS."""
    lap = np.zeros(shape, np.float32)
    lap[0, 0] = 4.0
    lap[0, 1] = lap[1, 0] = lap[0, -1] = lap[-1, 0] = -1.0
    return fft2d(jnp.asarray(lap), jnp.zeros(shape, jnp.float32), backend=backend)


def apply_filter(name: str, G, H, K, backend: str = DEFAULT_FFT_BACKEND):
    if name == "wiener":
        return wiener_filter(G, H, K)
    if name == "inverse":
        return inverse_filter(G, H)
    if name == "cls":
        P = _laplacian_fft(G[0].shape[-2:], backend)
        return cls_filter(G, H, P, K)
    raise ValueError(f"unknown filter {name!r}; one of {FILTERS}")


FILTERS = ("wiener", "inverse", "cls")
