"""Single-device jit pipeline vs the NumPy oracle, at the reference's
verification tiers (SURVEY.md §4) — the differential-oracle pattern every
reference driver uses (simd.cpp:66-99 et al.)."""

import numpy as np
import pytest

from fft_restoration_tpu.models.pipeline import WienerDeblurPipeline
from fft_restoration_tpu.oracle.psf import motion_blur_kernel_oracle
from fft_restoration_tpu.oracle.serial import restore_channels, restore_image
from fft_restoration_tpu.ops.psf import motion_blur_kernel
from fft_restoration_tpu.utils.verify import channels_equal


@pytest.mark.parametrize(
    "size,angle", [(9, 30.0), (15, 45.0), (12, -60.0), (5, 0.0)]
)
def test_jnp_psf_matches_oracle(size, angle):
    ours = np.asarray(motion_blur_kernel(size, angle))
    oracle = motion_blur_kernel_oracle(size, angle)
    assert np.abs(ours - oracle).max() < 1e-6


@pytest.mark.parametrize("backend", ["radix2", "matmul", "xla"])
def test_restored_channels_match_oracle(rng, backend):
    img = (rng.random((40, 56, 3)) * 255).astype(np.uint8)
    pipe = WienerDeblurPipeline(fft_backend=backend)
    ours = pipe.restore_channels(img, 9, 30.0)

    imgf = img.astype(np.float32) / 255.0
    psf = motion_blur_kernel_oracle(9, 30.0)
    oracle = restore_channels(np.moveaxis(imgf, -1, 0), psf)

    for tier in ("l2", "inf", "gpu"):
        report = channels_equal(ours, oracle, tier)
        assert report.passed, str(report)


def test_full_image_matches_oracle(rng):
    img = (rng.random((40, 56, 3)) * 255).astype(np.uint8)
    ours = WienerDeblurPipeline().restore(img, 9, 30.0)
    oracle = restore_image(img, 9, 30.0)
    diff = np.abs(ours.astype(int) - oracle.astype(int))
    # uint8 rounding can flip a pixel by 1 count
    assert diff.max() <= 1


@pytest.mark.parametrize("filter_name", ["inverse", "cls"])
def test_other_filters_run(rng, filter_name):
    img = (rng.random((32, 32, 3)) * 255).astype(np.uint8)
    out = WienerDeblurPipeline(filter_name=filter_name).restore(img, 7, 20.0)
    assert out.shape == img.shape and out.dtype == np.uint8


def test_no_white_balance_mode(rng):
    img = (rng.random((32, 32, 3)) * 255).astype(np.uint8)
    out = WienerDeblurPipeline(white_balance=False).restore(img, 7, 20.0)
    assert out.shape == img.shape


def test_non_square_non_pow2(rng):
    img = (rng.random((33, 70, 3)) * 255).astype(np.uint8)
    out = WienerDeblurPipeline().restore(img, 7, 15.0)
    assert out.shape == img.shape


def test_angle_sweep_reuses_one_executable(rng):
    """PSF angle and K are traced scalars: a sweep over angles reuses
    the executable compiled for the frame shape and PSF length."""
    img = (rng.random((96, 160, 3)) * 255).astype(np.uint8)
    pipe = WienerDeblurPipeline()
    a = pipe.restore(img, 9, 30.0)
    b = pipe.restore(img, 9, 45.0)
    assert len(pipe._cache) == 1
    assert not np.array_equal(a, b)
    np.testing.assert_array_equal(a, WienerDeblurPipeline().restore(img, 9, 30.0))


def test_u8_kernel_ingest_matches_f32_input():
    """uint8 frames convert to f32 on device after the de-interleave.
    That can differ from the host-side conversion by 1 ulp (different
    division lowering), so the contract is ulp-scale agreement — far
    inside every verification tier."""
    import functools

    import jax
    import jax.numpy as jnp
    import numpy as np

    from fft_restoration_tpu.models.pipeline import _restore_core

    rng = np.random.default_rng(11)
    img_u8 = (rng.random((64, 128, 3)) * 255).astype(np.uint8)
    img_f32 = img_u8.astype(np.float32) / np.float32(255.0)
    mk = lambda: functools.partial(
        _restore_core,
        psf_length=9,
        fft_backend="xla",
        filter_name="wiener",
        white_balance=True,
    )
    out_u8, planes_u8 = jax.jit(mk())(
        jnp.asarray(img_u8), jnp.float32(30.0), jnp.float32(0.01)
    )
    out_f, planes_f = jax.jit(mk())(
        jnp.asarray(img_f32), jnp.float32(30.0), jnp.float32(0.01)
    )
    assert float(np.abs(np.asarray(planes_u8) - np.asarray(planes_f)).max()) <= 1e-5
    assert (
        int(
            np.abs(
                np.asarray(out_u8).astype(int) - np.asarray(out_f).astype(int)
            ).max()
        )
        <= 1
    )


def test_restore_planes_matches_oracle_gpu_tier():
    """restore_planes on the xla route vs the oracle at the reference's
    gpu tier (PSNR >= 30 dB / INF <= 1e-3 — gpu.cpp:13-55), on
    pre-padded planes and through the pipeline class (uint8 in/out)."""
    import jax.numpy as jnp

    from fft_restoration_tpu.models.pipeline import restore_planes

    rng = np.random.default_rng(3)
    chans = rng.random((3, 256, 256)).astype(np.float32)
    psf = motion_blur_kernel(15, jnp.float32(45.0))
    ours = np.asarray(restore_planes(jnp.asarray(chans), psf, 0.01))
    oracle = restore_channels(chans, motion_blur_kernel_oracle(15, 45.0))
    report = channels_equal(ours, oracle, "gpu")
    assert report.passed, str(report)

    img = (rng.random((150, 200, 3)) * 255).astype(np.uint8)
    ours = WienerDeblurPipeline().restore_channels(img, 9, 30.0)
    oracle = restore_channels(
        np.moveaxis(img.astype(np.float32) / 255.0, -1, 0),
        motion_blur_kernel_oracle(9, 30.0),
    )
    report = channels_equal(ours, oracle, "gpu")
    assert report.passed, str(report)


def test_restore_planes_rejects_unknown_backend_and_filter():
    import jax.numpy as jnp

    from fft_restoration_tpu.models.pipeline import restore_planes

    psf = motion_blur_kernel(9, jnp.float32(30.0))
    x = jnp.zeros((3, 128, 128), jnp.float32)
    with pytest.raises(ValueError, match="unknown fft backend"):
        restore_planes(x, psf, 0.01, fft_backend="pallas")
    with pytest.raises(ValueError, match="unknown filter"):
        restore_planes(x, psf, 0.01, filter_name="bogus")


def test_compiled_caches_key_on_shape(rng):
    """Each cache holds one executable per distinct shape/config and
    none per call: a repeat call hits, a new shape compiles."""
    from fft_restoration_tpu.models.tiled import (
        _DEVICE_FN_CACHE,
        tiled_restore_image,
    )
    from fft_restoration_tpu.parallel.sharded_pipeline import (
        _SHARDED_JIT_CACHE,
        sharded_restore_planes,
    )

    img = rng.integers(0, 255, (140, 180, 3), np.uint8)
    pipe = WienerDeblurPipeline()
    a = pipe.restore(img, 9, 30.0)
    b = pipe.restore(img, 9, 30.0)
    assert len(pipe._cache) == 1
    np.testing.assert_array_equal(a, b)
    pipe.restore(img[:100], 9, 30.0)
    assert len(pipe._cache) == 2

    chans = np.random.default_rng(0).random((3, 128, 128), np.float32)
    psf = np.ones((5, 5), np.float32) / 25.0
    _SHARDED_JIT_CACHE.clear()
    sharded_restore_planes(chans, psf)
    sharded_restore_planes(chans, psf)
    assert len(_SHARDED_JIT_CACHE) == 1
    sharded_restore_planes(chans, psf, fft_backend="matmul")
    assert len(_SHARDED_JIT_CACHE) == 2

    _DEVICE_FN_CACHE.clear()
    frame = rng.integers(0, 255, (150, 200, 3), np.uint8)
    tiled_restore_image(frame, 7, 30.0, tile=128)
    tiled_restore_image(frame, 7, 30.0, tile=128)
    assert len(_DEVICE_FN_CACHE) == 1
    tiled_restore_image(frame[:140], 7, 30.0, tile=128)
    assert len(_DEVICE_FN_CACHE) == 2
