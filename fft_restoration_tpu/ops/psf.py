"""Motion-blur PSF synthesis in jnp (traceable, vmappable over angle).

Counterpart of motionBlurKernel (reference utils.hpp:15-24):
horizontal line of 1/size through (size/2, size/2), rotated by a
getRotationMatrix2D affine with exact inverse-map bilinear sampling
(constant-0 border), NOT re-normalized — matching the oracle
(fft_restoration_tpu/oracle/psf.py) to float rounding.

`size` is static (shapes); `angle_deg` may be a traced scalar, so the
PSF can live inside a jit graph and be vmapped for (length, angle) grid
sweeps.
"""

from __future__ import annotations

import math

import jax.numpy as jnp


def motion_blur_kernel(size: int, angle_deg) -> jnp.ndarray:
    """(size, size) float32 PSF; angle may be traced."""
    angle = jnp.asarray(angle_deg, jnp.float32) * jnp.float32(math.pi / 180.0)
    alpha = jnp.cos(angle)
    beta = jnp.sin(angle)
    cx = jnp.float32(size // 2)
    cy = jnp.float32(size // 2)

    # Forward affine: [[a, b, (1-a)cx - b*cy], [-b, a, b*cx + (1-a)cy]].
    # Its inverse (rotation, det=1): [[a, -b], [b, a]] with matching shift.
    # warpAffine maps dst->src through the inverse.
    m02 = (1.0 - alpha) * cx - beta * cy
    m12 = beta * cx + (1.0 - alpha) * cy
    # invert 2x3 affine (det = alpha^2 + beta^2 = 1, but keep general form)
    det = alpha * alpha + beta * beta
    d = jnp.where(det != 0.0, 1.0 / det, 0.0)
    i00 = alpha * d
    i01 = -beta * d
    i10 = beta * d
    i11 = alpha * d
    i02 = -(i00 * m02 + i01 * m12)
    i12 = -(i10 * m02 + i11 * m12)

    x = jnp.arange(size, dtype=jnp.float32)[None, :]
    y = jnp.arange(size, dtype=jnp.float32)[:, None]
    sx = i00 * x + i01 * y + i02
    sy = i10 * x + i11 * y + i12
    xi = jnp.floor(sx)
    yi = jnp.floor(sy)
    fx = sx - xi
    fy = sy - yi
    xi = xi.astype(jnp.int32)
    yi = yi.astype(jnp.int32)

    # Source is a single horizontal line: src[r, c] = 1/size iff r == size//2.
    # Sampling reduces to row-membership tests — no gather needed at all.
    line_row = size // 2
    val = jnp.float32(1.0 / size)

    def sample(row_idx, col_idx):
        ok = (
            (row_idx == line_row)
            & (col_idx >= 0)
            & (col_idx < size)
            & (row_idx >= 0)
            & (row_idx < size)
        )
        return jnp.where(ok, val, jnp.float32(0.0))

    s00 = sample(yi, xi)
    s01 = sample(yi, xi + 1)
    s10 = sample(yi + 1, xi)
    s11 = sample(yi + 1, xi + 1)

    wx0 = 1.0 - fx
    wy0 = 1.0 - fy
    out = s00 * (wy0 * wx0) + s01 * (wy0 * fx) + s10 * (fy * wx0) + s11 * (fy * fx)
    return out.astype(jnp.float32)


def gaussian_kernel(size: int, sigma) -> jnp.ndarray:
    """(size, size) isotropic Gaussian PSF, sum-normalized; sigma may be
    traced. The defocus/soft-blur member of the PSF family the
    reference lacks (it synthesizes motion lines only, utils.hpp:15-24);
    Wiener/CLS/RL are kernel-agnostic so the whole pipeline works
    unchanged."""
    sigma = jnp.maximum(jnp.asarray(sigma, jnp.float32), 1e-3)
    c = jnp.float32(size // 2)
    x = jnp.arange(size, dtype=jnp.float32)[None, :] - c
    y = jnp.arange(size, dtype=jnp.float32)[:, None] - c
    g = jnp.exp(-(x * x + y * y) / (2.0 * sigma * sigma))
    return (g / jnp.sum(g)).astype(jnp.float32)


def disk_kernel(size: int) -> jnp.ndarray:
    """(size, size) defocus disk of diameter `size`, sum-normalized,
    with a linear antialiased rim (pixel weight = clamped distance to
    the circle edge — the standard coverage approximation)."""
    c = jnp.float32(size // 2)
    r = jnp.float32(size) / 2.0
    x = jnp.arange(size, dtype=jnp.float32)[None, :] - c
    y = jnp.arange(size, dtype=jnp.float32)[:, None] - c
    d = jnp.sqrt(x * x + y * y)
    w = jnp.clip(r + 0.5 - d, 0.0, 1.0)
    return (w / jnp.sum(w)).astype(jnp.float32)


PSF_TYPES = ("motion", "gaussian", "disk")


def make_psf(psf_type, size: int, param) -> jnp.ndarray:
    """PSF family dispatcher: 'motion' (param = angle in degrees, the
    reference's kernel), 'gaussian' (param = sigma in px), 'disk'
    (defocus of diameter `size`; param ignored) — or a CONCRETE (size,
    size) kernel array (the --psf-file surface; param ignored, the
    array rides the jit graph as a constant). size is static, param
    may be traced. NOTE: array psf_types are for the CLI/library paths;
    serve.py's per-request option caches key on psf_type and accept
    strings only (arrays are unhashable by design there)."""
    if not isinstance(psf_type, str):
        kernel = jnp.asarray(psf_type, jnp.float32)
        if kernel.shape != (size, size):
            raise ValueError(
                f"custom PSF kernel shape {kernel.shape} != ({size}, {size})"
            )
        return kernel
    if psf_type == "motion":
        return motion_blur_kernel(size, param)
    if psf_type == "gaussian":
        return gaussian_kernel(size, param)
    if psf_type == "disk":
        return disk_kernel(size)
    raise ValueError(f"unknown psf type {psf_type!r}; one of {PSF_TYPES}")


def load_psf_file(path: str):
    """Host-side loader for user-supplied PSF kernels (--psf-file):
    .npy / .txt / .csv arrays or any decodable grayscale image (the
    common interchange formats of external PSF estimators). Returns a
    float32 (S, S) kernel, zero-padded square (bottom/right — the
    corner-anchored pad convention, so alignment is preserved) and
    sum-normalized like every synthesized family member."""
    import os

    import numpy as np

    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        k = np.load(path)
    elif ext in (".txt", ".csv"):
        k = np.loadtxt(path, delimiter="," if ext == ".csv" else None)
    else:
        from fft_restoration_tpu.utils.imageio import imread

        k = np.asarray(imread(path), np.float64)
        if k.ndim == 3:
            k = k.mean(axis=-1)
    k = np.atleast_2d(np.asarray(k, np.float64))
    if k.ndim != 2 or k.size == 0:
        raise ValueError(f"PSF file {path!r}: need a 2D kernel, got shape {k.shape}")
    if not np.isfinite(k).all():
        raise ValueError(f"PSF file {path!r}: kernel has non-finite values")
    # a PSF is a light-spread density: negative lobes (a Laplacian/DoG
    # saved by mistake) would silently corrupt RL's multiplicative
    # updates. Tiny float noise below zero is clipped, real lobes error.
    if k.min() < -1e-6 * max(k.max(), 0.0):
        raise ValueError(
            f"PSF file {path!r}: kernel has negative entries "
            f"(min {k.min():.3g}); a PSF must be non-negative"
        )
    k = np.clip(k, 0.0, None)
    s = max(k.shape)
    k = np.pad(k, ((0, s - k.shape[0]), (0, s - k.shape[1])))
    total = k.sum()
    if total <= 0:
        raise ValueError(f"PSF file {path!r}: kernel sum must be > 0")
    return (k / total).astype(np.float32)
