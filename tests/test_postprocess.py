"""Post-processing on the XLA path (ops/color.py planar math + the
pipeline's normalize / white balance / u8 encode) vs the NumPy oracle
(oracle/color.py)."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fft_restoration_tpu.oracle import color as ocolor
from fft_restoration_tpu.ops.color import (
    bgr_to_lab,
    bgr_to_lab_planar,
    lab_to_bgr_planar,
    luminance_l_planar,
)


def _rand_planes(rng, h, w):
    return rng.random((3, h, w), np.float32)


def _wb_encode(planes, gain):
    """The pipeline's planar WB + u8 encode for a fixed gain."""
    L, a, b = bgr_to_lab_planar(planes[0], planes[1], planes[2])
    L = jnp.clip(L * gain, 0.0, 100.0)
    out = lab_to_bgr_planar(L, a, b)
    return jnp.stack(
        [jnp.clip(p * 255.0, 0.0, 255.0).astype(jnp.uint8) for p in out]
    )


def _oracle_wb_encode(planes, gain):
    lab = ocolor.bgr_to_lab(np.moveaxis(np.asarray(planes, np.float64), 0, -1))
    lab[..., 0] = np.clip(lab[..., 0] * gain, 0.0, 100.0)
    bgr = ocolor.lab_to_bgr(lab)
    return np.moveaxis(np.clip(bgr * 255.0, 0, 255).astype(np.uint8), -1, 0)


@pytest.mark.parametrize("h,w", [(64, 128), (100, 256), (30, 140)])
def test_lab_l_mean_matches_oracle(h, w):
    rng = np.random.default_rng(0)
    restored = _rand_planes(rng, h, w)
    orig_u8 = (rng.random((3, h, w)) * 255).astype(np.uint8)
    ours = float(jax.jit(lambda r: jnp.mean(luminance_l_planar(*r)))(restored))
    want = float(ocolor.bgr_to_lab(np.moveaxis(restored, 0, -1))[..., 0].mean())
    assert abs(ours - want) < 1e-3  # L in [0,100]
    o32 = orig_u8.astype(np.float32) / np.float32(255.0)
    ours_o = float(jnp.mean(luminance_l_planar(*jnp.asarray(o32))))
    want_o = float(ocolor.bgr_to_lab(np.moveaxis(o32, 0, -1))[..., 0].mean())
    assert abs(ours_o - want_o) < 1e-3


@pytest.mark.parametrize("h,w", [(64, 128), (100, 256), (30, 140)])
def test_wb_encode_matches_oracle(h, w):
    rng = np.random.default_rng(1)
    restored = _rand_planes(rng, h, w)
    out = jax.jit(lambda r: _wb_encode(r, jnp.float32(1.17)))(restored)
    assert out.shape == (3, h, w) and out.dtype == jnp.uint8
    diff = np.abs(
        np.asarray(out).astype(int) - _oracle_wb_encode(restored, 1.17)
    )
    # f32 vs f64 color math can flip the trunc boundary by one count
    assert diff.max() <= 1
    assert (diff > 0).mean() < 0.01


def test_f32_orig_planes_accepted():
    """uint8-derived and float planes of the same values give the same L."""
    rng = np.random.default_rng(2)
    u8 = (rng.random((3, 32, 128)) * 255).astype(np.uint8)
    f32 = u8.astype(np.float32) / np.float32(255.0)
    a = np.asarray(luminance_l_planar(*jnp.asarray(f32)))
    assert np.isfinite(a).all()
    np.testing.assert_array_equal(
        a, np.asarray(bgr_to_lab(jnp.asarray(np.moveaxis(f32, 0, -1))))[..., 0]
    )


def test_planar_matches_interleaved():
    rng = np.random.default_rng(3)
    planes = _rand_planes(rng, 16, 128)
    lab_i = np.asarray(bgr_to_lab(jnp.asarray(np.moveaxis(planes, 0, -1))))
    lab_p = np.stack([np.asarray(p) for p in bgr_to_lab_planar(*planes)], -1)
    np.testing.assert_allclose(lab_p, lab_i, atol=2e-4)


def _restore(img, backend, **kw):
    from fft_restoration_tpu.models.pipeline import _restore_core

    fn = functools.partial(
        _restore_core, psf_length=9, fft_backend=backend,
        filter_name="wiener", white_balance=True, **kw,
    )
    return jax.jit(fn)(jnp.asarray(img), jnp.float32(30.0), jnp.float32(0.01))


def test_pipeline_xla_path_matches_matmul_path():
    """Same restore math on both FFT backends => planes within 1e-5 and
    the final u8 within 1 count."""
    rng = np.random.default_rng(5)
    img = (rng.random((128, 128, 3)) * 255).astype(np.uint8)
    out_x, planes_x = _restore(img, "xla")
    out_m, planes_m = _restore(img, "matmul")
    assert float(np.abs(np.asarray(planes_x) - np.asarray(planes_m)).max()) <= 1e-5
    diff = np.abs(np.asarray(out_x).astype(int) - np.asarray(out_m).astype(int))
    assert diff.max() <= 1


def test_pipeline_emit_planes_false():
    rng = np.random.default_rng(6)
    img = (rng.random((128, 128, 3)) * 255).astype(np.uint8)
    out = _restore(img, "xla", emit_planes=False)
    assert out.shape == img.shape and out.dtype == jnp.uint8
    # same image as the two-output graph
    out2, _ = _restore(img, "xla")
    assert np.array_equal(np.asarray(out), np.asarray(out2))


@pytest.mark.parametrize("h,w", [(64, 128), (30, 140)])
def test_normalize_then_wb_matches_oracle(h, w):
    """Min-max normalize of raw planes followed by WB + encode matches
    the oracle's normalize + WB on the same raw planes."""
    from fft_restoration_tpu.models.pipeline import _minmax_normalize

    rng = np.random.default_rng(8)
    raw = rng.random((3, h, w), np.float32) * 7.0 - 2.0
    ours = np.asarray(_wb_encode(_minmax_normalize(jnp.asarray(raw)), 1.1))
    lo = raw.min(axis=(-2, -1), keepdims=True)
    hi = raw.max(axis=(-2, -1), keepdims=True)
    ref = _oracle_wb_encode((raw - lo) / (hi - lo), 1.1)
    d = np.abs(ours.astype(int) - ref.astype(int))
    assert d.max() <= 1


def test_pipeline_ragged_shape_matches_matmul():
    """Non-pow2 frame: pad, restore, crop and post-process agree across
    FFT backends."""
    rng = np.random.default_rng(9)
    img = (rng.random((200, 300, 3)) * 255).astype(np.uint8)
    out_x, planes_x = _restore(img, "xla")
    out_m, planes_m = _restore(img, "matmul")
    assert out_x.shape == img.shape
    assert float(np.abs(np.asarray(planes_x) - np.asarray(planes_m)).max()) <= 1e-5
    diff = np.abs(np.asarray(out_x).astype(int) - np.asarray(out_m).astype(int))
    assert diff.max() <= 1


def _structured_frame(h, w, seed=0):
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.zeros((h, w, 3), np.float32)
    img[..., 0] = 80 + 100 * np.sin(yy / (19.0 + seed)) * np.cos(xx / 11.0)
    img[..., 1] = 60 + 0.2 * xx
    img[..., 2] = 70 + 0.3 * yy
    img[h // 5 : 4 * h // 5, w // 3 : w // 3 + 20] += 120
    return np.clip(img, 0, 255).astype(np.uint8)


def test_white_balance_matches_oracle_on_structured_frame():
    """The whole restore + white balance on a row-structured 500x640
    frame stays within 2 uint8 counts of the oracle's restore_image."""
    from fft_restoration_tpu.models.pipeline import WienerDeblurPipeline
    from fft_restoration_tpu.oracle.serial import restore_image
    from fft_restoration_tpu.utils.blurgen import blur_image

    blurred = blur_image(_structured_frame(500, 640), 11, 30.0)
    ours = WienerDeblurPipeline().restore(blurred, 11, 30.0)
    ref = restore_image(blurred, 11, 30.0)
    d = np.abs(ours.astype(np.int16) - ref.astype(np.int16))
    assert d.max() <= 2, d.max()


def test_white_balance_gain_reads_live_pixels_only():
    """The WB gain's L means cover the cropped frame, not the pad: a
    frame whose pow2 pad region would shift the mean restores the same
    as the oracle, which never sees the pad."""
    from fft_restoration_tpu.models.pipeline import WienerDeblurPipeline
    from fft_restoration_tpu.oracle.serial import restore_image

    img = np.full((70, 90, 3), 200, np.uint8)
    img[20:50, 30:60] = 40
    ours = WienerDeblurPipeline().restore(img, 5, 0.0)
    ref = restore_image(img, 5, 0.0)
    assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 2


def test_batched_white_balance_matches_single():
    """Per-image gains in the batched graph equal the single-frame
    pipeline's, frame by frame, within 1 count."""
    from fft_restoration_tpu.models.batched import BatchedWienerPipeline
    from fft_restoration_tpu.models.pipeline import WienerDeblurPipeline
    from fft_restoration_tpu.utils.blurgen import blur_image

    imgs = np.stack(
        [blur_image(_structured_frame(250, 140, i), 9, 30.0) for i in range(2)]
    )
    batched = BatchedWienerPipeline().restore(imgs, 9, 30.0)
    single = WienerDeblurPipeline()
    for i in range(2):
        d = np.abs(
            batched[i].astype(np.int16)
            - single.restore(imgs[i], 9, 30.0).astype(np.int16)
        )
        assert d.max() <= 1, d.max()


def test_u8_ingest_matches_float_ingest():
    """uint8 frames convert on device after the de-interleave; the
    result matches feeding the host-converted float frame (to f32
    rounding: XLA may fuse the convert differently)."""
    rng = np.random.default_rng(10)
    img = (rng.random((96, 112, 3)) * 255).astype(np.uint8)
    out_u8, planes_u8 = _restore(img, "xla")
    out_f, planes_f = _restore(img.astype(np.float32) / np.float32(255.0), "xla")
    assert float(np.abs(np.asarray(planes_u8) - np.asarray(planes_f)).max()) <= 1e-5
    d = np.abs(np.asarray(out_u8).astype(int) - np.asarray(out_f).astype(int))
    assert d.max() <= 1
