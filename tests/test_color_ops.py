"""jnp color ops vs the NumPy oracle color path."""

import numpy as np

import jax.numpy as jnp

from fft_restoration_tpu.ops.color import (
    apply_white_balance as wb_jnp,
    bgr_to_lab as lab_jnp,
    lab_to_bgr as bgr_jnp,
)
from fft_restoration_tpu.oracle.color import (
    apply_white_balance as wb_np,
    bgr_to_lab as lab_np,
    lab_to_bgr as bgr_np,
)


def test_bgr_to_lab_matches_oracle(small_bgr):
    ours = np.asarray(lab_jnp(jnp.asarray(small_bgr)))
    ref = lab_np(small_bgr)
    assert np.abs(ours - ref).max() < 1e-3


def test_lab_to_bgr_matches_oracle(small_bgr):
    lab = lab_np(small_bgr)
    ours = np.asarray(bgr_jnp(jnp.asarray(lab)))
    ref = bgr_np(lab)
    assert np.abs(ours - ref).max() < 1e-5


def test_white_balance_matches_oracle(small_bgr, rng):
    lab_d = lab_np(small_bgr)
    lab_o = lab_np(rng.random(small_bgr.shape).astype(np.float32))
    ours = np.asarray(wb_jnp(jnp.asarray(lab_d), jnp.asarray(lab_o)))
    ref = wb_np(lab_d, lab_o)
    assert np.abs(ours - ref).max() < 1e-3


def test_companding_powers_match_numpy():
    """ops/color.py writes powers as exp2(log2(x)*p): the sRGB
    companding and the Lab cube root agree with float64 NumPy, and the
    planar Lab round trip returns the input to well under half a uint8
    count."""
    import jax.numpy as jnp

    from fft_restoration_tpu.ops import color as C

    x = np.linspace(0.0, 1.0, 50001).astype(np.float32)
    xd = x.astype(np.float64)
    lin_ref = np.where(xd <= 0.04045, xd / 12.92, ((xd + 0.055) / 1.055) ** 2.4)
    lin_err = np.abs(np.asarray(C._srgb_to_linear(jnp.asarray(x))) - lin_ref).max()
    assert lin_err < 1e-5, lin_err
    srgb_ref = np.where(xd <= 0.0031308, 12.92 * xd, 1.055 * xd ** (1 / 2.4) - 0.055)
    srgb_err = np.abs(np.asarray(C._linear_to_srgb(jnp.asarray(x))) - srgb_ref).max()
    assert srgb_err < 1e-5, srgb_err
    t = np.linspace(0.01, 1.2, 50001).astype(np.float32)
    rel = (
        np.abs(np.asarray(C._f_cbrt(jnp.asarray(t))) - np.cbrt(t.astype(np.float64)))
        / np.cbrt(t)
    ).max()
    assert rel < 1e-5, rel

    rng = np.random.default_rng(3)
    b, g, r = (jnp.asarray(rng.random((64, 64), np.float32)) for _ in range(3))
    back = C.lab_to_bgr_planar(*C.bgr_to_lab_planar(b, g, r))
    worst = max(
        np.abs(np.asarray(a) - np.asarray(v)).max() for a, v in zip(back, (b, g, r))
    )
    assert worst * 255 < 0.5, worst  # <= half a uint8 count
