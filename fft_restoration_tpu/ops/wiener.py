"""Elementwise frequency-domain restoration filters (jnp, SoA layout).

Counterpart of the Wiener block in every reference mode — e.g. the
whole-Mat serial version (fft_serial.cpp:185-224), the AVX2 one
(fft_simd.cpp:328-372), and the CUDA wiener_kernel (fft_gpu.cu:169-181).
Operands are (re, im) float32 plane pairs (see ops/fft.py docstring for
why SoA). Pure elementwise math; XLA fuses it into one elementwise kernel between
the forward and inverse FFT calls.

With G = gr + i*gi, H = hr + i*hi:
    G * conj(H) = (gr*hr + gi*hi) + i*(gi*hr - gr*hi)
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

SoA = Tuple[jnp.ndarray, jnp.ndarray]


def wiener_filter(G: SoA, H: SoA, K) -> SoA:
    """F = G * conj(H) / (|H|^2 + K).

    |H|^2 is computed directly (re^2 + im^2) rather than the reference's
    sqrt-then-square (fft_serial.cpp:195-197) — same value, fewer ops;
    parity is within the reference's own verification tiers.
    """
    gr, gi = G
    hr, hi = H
    inv = 1.0 / (hr * hr + hi * hi + jnp.asarray(K, jnp.float32))
    return (gr * hr + gi * hi) * inv, (gi * hr - gr * hi) * inv


def inverse_filter(G: SoA, H: SoA, eps=1e-8) -> SoA:
    """Direct inverse filter F = G / H with a small-|H| guard.

    Mirrors the denom > 1e-8 guard pattern (fft_openmp.cpp:235,
    fft_gpu.cu:176).
    """
    gr, gi = G
    hr, hi = H
    mag2 = hr * hr + hi * hi
    safe = mag2 > jnp.asarray(eps, jnp.float32)
    inv = jnp.where(safe, 1.0 / jnp.where(safe, mag2, 1.0), 0.0)
    return (gr * hr + gi * hi) * inv, (gi * hr - gr * hi) * inv


def cls_filter(G: SoA, H: SoA, P: SoA, gamma) -> SoA:
    """Constrained least squares: F = G * conj(H) / (|H|^2 + gamma*|P|^2)."""
    gr, gi = G
    hr, hi = H
    pr, pi = P
    denom = hr * hr + hi * hi + jnp.asarray(gamma, jnp.float32) * (
        pr * pr + pi * pi
    )
    inv = 1.0 / denom
    return (gr * hr + gi * hi) * inv, (gi * hr - gr * hi) * inv
