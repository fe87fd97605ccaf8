"""BGR <-> CIELAB and white balance in jnp (jit-fusable).

Same semantics as the NumPy oracle (fft_restoration_tpu/oracle/color.py):
exact analytic sRGB companding, D65 white, L in [0,100]. Used by the
pipeline's post-processing stage (serial.cpp:43-54, utils.hpp:55-71).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from fft_restoration_tpu.oracle.color import _SRGB2XYZ_N, _XYZ2SRGB, _D65

_T0 = 0.008856
_CBRT_A = 7.787
_CBRT_B = 16.0 / 116.0


# Powers are written exp2(log2(x)*p), which agrees with x**p to ~1 ulp;
# every branch that uses it has x > 0.


def _pow2_pos(x, p):
    return jnp.exp2(jnp.log2(jnp.maximum(x, 1e-30)) * p)


def _srgb_to_linear(x):
    return jnp.where(
        x <= 0.04045, x / 12.92, _pow2_pos((x + 0.055) / 1.055, 2.4)
    )


def _linear_to_srgb(x):
    x = jnp.maximum(x, 0.0)
    return jnp.where(
        x <= 0.0031308, 12.92 * x, 1.055 * _pow2_pos(x, 1.0 / 2.4) - 0.055
    )


def _f_cbrt(t):
    return jnp.where(t > _T0, _pow2_pos(t, 1.0 / 3.0), _CBRT_A * t + _CBRT_B)


def bgr_to_lab(img_bgr: jnp.ndarray) -> jnp.ndarray:
    """float BGR in [0,1], (..., 3) -> Lab float32 (L in [0,100])."""
    # channel order is absorbed into the 3x3 constant (columns flipped)
    # instead of reversing the image tensor, which XLA may materialize
    # as a full-image `rev` copy
    lin = _srgb_to_linear(jnp.clip(img_bgr.astype(jnp.float32), 0.0, 1.0))
    m = jnp.asarray(np.asarray(_SRGB2XYZ_N, np.float32)[:, ::-1])
    # HIGHEST: a reduced-precision (TF32/bf16) matmul costs ~0.1 L of
    # noise on a 3-wide contraction that is effectively free in f32
    t = jnp.matmul(lin, m.T, precision=jax.lax.Precision.HIGHEST)
    f = _f_cbrt(t)
    fy = f[..., 1]
    L = jnp.where(t[..., 1] > _T0, 116.0 * fy - 16.0, 903.3 * t[..., 1])
    a = 500.0 * (f[..., 0] - fy)
    b = 200.0 * (fy - f[..., 2])
    return jnp.stack([L, a, b], axis=-1).astype(jnp.float32)


def lab_to_bgr(lab: jnp.ndarray) -> jnp.ndarray:
    """Lab (L in [0,100]) -> float BGR in [0,1], (..., 3)."""
    lab = lab.astype(jnp.float32)
    L, a, b = lab[..., 0], lab[..., 1], lab[..., 2]
    fy = (L + 16.0) / 116.0
    fx = fy + a / 500.0
    fz = fy - b / 200.0

    def _inv_f(f):
        f3 = f**3
        return jnp.where(f3 > _T0, f3, (f - _CBRT_B) / _CBRT_A)

    t = jnp.stack([_inv_f(fx), _inv_f(fy), _inv_f(fz)], axis=-1)
    xyz = t * jnp.asarray(np.asarray(_D65, np.float32))
    # emit BGR directly by flipping the 3x3 constant's rows (see
    # bgr_to_lab) — companding is elementwise, so order commutes
    m = jnp.asarray(np.asarray(_XYZ2SRGB, np.float32)[::-1])
    lin = jnp.matmul(xyz, m.T, precision=jax.lax.Precision.HIGHEST)
    return jnp.clip(_linear_to_srgb(lin), 0.0, 1.0)


# ---------------------------------------------------------------------------
# Planar variants: per-channel (H, W) planes instead of (..., 3)
# interleaved tensors, so every load and store is a contiguous plane.
# The pipeline works in planes end-to-end and interleaves once, at the
# final uint8 conversion.


def bgr_to_lab_planar(b: jnp.ndarray, g: jnp.ndarray, r: jnp.ndarray):
    """(H, W) float BGR planes in [0,1] -> (L, a, b) float32 planes."""
    to_lin, fc = _srgb_to_linear, _f_cbrt
    m = np.asarray(_SRGB2XYZ_N, np.float32)
    lb = to_lin(jnp.clip(b.astype(jnp.float32), 0.0, 1.0))
    lg = to_lin(jnp.clip(g.astype(jnp.float32), 0.0, 1.0))
    lr = to_lin(jnp.clip(r.astype(jnp.float32), 0.0, 1.0))
    # rgb-ordered rows applied to bgr planes
    tx = m[0, 2] * lb + m[0, 1] * lg + m[0, 0] * lr
    ty = m[1, 2] * lb + m[1, 1] * lg + m[1, 0] * lr
    tz = m[2, 2] * lb + m[2, 1] * lg + m[2, 0] * lr
    fx, fy, fz = fc(tx), fc(ty), fc(tz)
    L = jnp.where(ty > _T0, 116.0 * fy - 16.0, 903.3 * ty)
    return (
        L.astype(jnp.float32),
        (500.0 * (fx - fy)).astype(jnp.float32),
        (200.0 * (fy - fz)).astype(jnp.float32),
    )


def lab_to_bgr_planar(L: jnp.ndarray, a: jnp.ndarray, b: jnp.ndarray):
    """(L, a, b) planes -> (b, g, r) float planes in [0,1]."""
    to_srgb = _linear_to_srgb
    fy = (L.astype(jnp.float32) + 16.0) / 116.0
    fx = fy + a.astype(jnp.float32) / 500.0
    fz = fy - b.astype(jnp.float32) / 200.0

    def _inv_f(f):
        f3 = f**3
        return jnp.where(f3 > _T0, f3, (f - _CBRT_B) / _CBRT_A)

    d65 = np.asarray(_D65, np.float32)
    x = _inv_f(fx) * d65[0]
    y = _inv_f(fy) * d65[1]
    z = _inv_f(fz) * d65[2]
    m = np.asarray(_XYZ2SRGB, np.float32)
    lr = m[0, 0] * x + m[0, 1] * y + m[0, 2] * z
    lg = m[1, 0] * x + m[1, 1] * y + m[1, 2] * z
    lb = m[2, 0] * x + m[2, 1] * y + m[2, 2] * z
    out = tuple(
        jnp.clip(to_srgb(v), 0.0, 1.0) for v in (lb, lg, lr)
    )
    return out


def luminance_l_planar(b: jnp.ndarray, g: jnp.ndarray, r: jnp.ndarray):
    """Lab L plane only (the white-balance gain's input)."""
    to_lin, fc = _srgb_to_linear, _f_cbrt
    m = np.asarray(_SRGB2XYZ_N, np.float32)
    lb = to_lin(jnp.clip(b.astype(jnp.float32), 0.0, 1.0))
    lg = to_lin(jnp.clip(g.astype(jnp.float32), 0.0, 1.0))
    lr = to_lin(jnp.clip(r.astype(jnp.float32), 0.0, 1.0))
    y = m[1, 2] * lb + m[1, 1] * lg + m[1, 0] * lr
    fy = fc(y)
    return jnp.where(y > _T0, 116.0 * fy - 16.0, 903.3 * y).astype(jnp.float32)


def luminance_l(img_bgr: jnp.ndarray) -> jnp.ndarray:
    """Just the Lab L channel of a BGR image — the only part of
    bgr_to_lab the white-balance gain consumes for the ORIGINAL image.
    Bitwise-identical to bgr_to_lab(img)[..., 0] (same ops, same order)
    at a third of the matrix/cbrt work."""
    lin = _srgb_to_linear(jnp.clip(img_bgr.astype(jnp.float32), 0.0, 1.0))
    # Y row of the (column-flipped, BGR-ordered) sRGB->XYZ matrix
    y_row = jnp.asarray(np.asarray(_SRGB2XYZ_N, np.float32)[1, ::-1])
    y = jnp.matmul(lin, y_row, precision=jax.lax.Precision.HIGHEST)
    fy = _f_cbrt(y)
    return jnp.where(y > _T0, 116.0 * fy - 16.0, 903.3 * y).astype(jnp.float32)


def apply_white_balance_gain(lab_deblur: jnp.ndarray, l_orig_mean) -> jnp.ndarray:
    """White balance against a precomputed mean original luminance
    (utils.hpp:55-71 semantics; see apply_white_balance)."""
    avg_deblur = jnp.mean(lab_deblur[..., 0])
    gain = jnp.asarray(l_orig_mean, jnp.float32) / (avg_deblur + 1e-6)
    L = jnp.clip(lab_deblur[..., 0] * gain, 0.0, 100.0)
    return jnp.concatenate([L[..., None], lab_deblur[..., 1:]], axis=-1)


def apply_white_balance(lab_deblur: jnp.ndarray, lab_orig: jnp.ndarray) -> jnp.ndarray:
    """Scale deblurred L by mean(L_orig)/(mean(L_deblur)+1e-6), clamp
    [0,100] (utils.hpp:55-71). Means are full reductions — in the sharded
    pipeline they become psums (SURVEY.md §7 hard part 4)."""
    avg_orig = jnp.mean(lab_orig[..., 0])
    avg_deblur = jnp.mean(lab_deblur[..., 0])
    gain = avg_orig / (avg_deblur + 1e-6)
    L = jnp.clip(lab_deblur[..., 0] * gain, 0.0, 100.0)
    return jnp.concatenate([L[..., None], lab_deblur[..., 1:]], axis=-1)
