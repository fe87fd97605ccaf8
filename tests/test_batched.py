"""Batched stack restoration and PSF grid sweep vs per-image results."""

import numpy as np

import jax.numpy as jnp

from fft_restoration_tpu.models.batched import BatchedWienerPipeline, psf_grid_sweep
from fft_restoration_tpu.models.pipeline import WienerDeblurPipeline


def test_batched_matches_per_image(rng):
    imgs = (rng.random((4, 32, 40, 3)) * 255).astype(np.uint8)
    batched = BatchedWienerPipeline().restore_planes(imgs, 7, 30.0)
    single = WienerDeblurPipeline()
    for b in range(4):
        ref = single.restore_channels(imgs[b], 7, 30.0)
        assert np.abs(batched[b] - ref).max() < 1e-6


def test_batched_xla_matches_per_image(rng):
    """The batched graph flattens leading (batch, channel) axes — parity
    with per-image restores on the xla route."""
    imgs = (rng.random((3, 16, 24, 3)) * 255).astype(np.uint8)
    batched = BatchedWienerPipeline(fft_backend="xla").restore_planes(
        imgs, 5, 45.0
    )
    single = WienerDeblurPipeline(fft_backend="xla")
    for b in range(3):
        ref = single.restore_channels(imgs[b], 5, 45.0)
        assert np.abs(batched[b] - ref).max() < 1e-6


def test_psf_grid_sweep_matches_single(rng):
    img = (rng.random((32, 32, 3)) * 255).astype(np.uint8)
    out = psf_grid_sweep(img, [5, 7], [0.0, 30.0, 60.0])
    assert out.shape == (2, 3, 3, 32, 32)
    single = WienerDeblurPipeline()
    ref = single.restore_channels(img, 7, 60.0)
    assert np.abs(out[1, 2] - ref).max() < 1e-5


def test_psf_grid_sweep_xla(rng):
    """vmap over the library FFT agrees with the matmul four-step."""
    img = (rng.random((16, 16, 3)) * 255).astype(np.uint8)
    out = psf_grid_sweep(img, [3, 5], [0.0, 45.0], fft_backend="xla")
    assert out.shape == (2, 2, 3, 16, 16)
    ref = psf_grid_sweep(img, [3, 5], [0.0, 45.0], fft_backend="matmul")
    assert np.abs(out - ref).max() < 1e-3


def test_batched_device_white_balance_matches_single(rng):
    """restore() (device-side per-frame WB) vs the single-image pipeline
    frame by frame: same WB semantics, within uint8 rounding of the
    cross-image-packed FFT path."""
    from fft_restoration_tpu.models.pipeline import WienerDeblurPipeline

    stack = (rng.random((4, 40, 56, 3)) * 255).astype(np.uint8)
    outs = BatchedWienerPipeline(fft_backend="matmul").restore(stack, 9, 30.0)
    single = WienerDeblurPipeline(fft_backend="matmul")
    for i in range(stack.shape[0]):
        want = single.restore(stack[i], 9, 30.0)
        diff = np.abs(outs[i].astype(int) - want.astype(int)).max()
        assert diff <= 1, diff


def test_batched_restore_no_white_balance(rng):
    stack = (rng.random((2, 32, 32, 3)) * 255).astype(np.uint8)
    outs = BatchedWienerPipeline(
        fft_backend="matmul", white_balance=False
    ).restore(stack, 7, 20.0)
    assert outs.shape == stack.shape and outs.dtype == np.uint8


def test_batched_wb_path_matches_single_pipeline(rng):
    """At >=128px the batched graph's per-image WB gains match the
    single-image pipeline frame by frame."""
    from fft_restoration_tpu.models.pipeline import WienerDeblurPipeline

    stack = (rng.random((3, 128, 128, 3)) * 255).astype(np.uint8)
    outs = BatchedWienerPipeline(fft_backend="xla").restore(
        stack, 9, 30.0
    )
    single = WienerDeblurPipeline(fft_backend="xla")
    for i in range(stack.shape[0]):
        want = single.restore(stack[i], 9, 30.0)
        diff = np.abs(outs[i].astype(int) - want.astype(int)).max()
        # cross-image channel packing perturbs the FFT rounding
        assert diff <= 1, diff


def test_batched_ragged(rng):
    """Non-pow2 batched frames: per-image pad, crop and WB."""
    from fft_restoration_tpu.models.pipeline import WienerDeblurPipeline

    stack = (rng.random((2, 150, 200, 3)) * 255).astype(np.uint8)
    outs = BatchedWienerPipeline(fft_backend="xla").restore(
        stack, 9, 30.0
    )
    assert outs.shape == stack.shape
    single = WienerDeblurPipeline(fft_backend="xla")
    for i in range(stack.shape[0]):
        want = single.restore(stack[i], 9, 30.0)
        diff = np.abs(outs[i].astype(int) - want.astype(int)).max()
        assert diff <= 1, diff


def test_batched_backends_agree(rng):
    """The batched planes and images graphs agree across the xla and
    matmul FFT backends at the gpu tier."""
    stack = (rng.random((2, 128, 128, 3)) * 255).astype(np.uint8)
    x = BatchedWienerPipeline(fft_backend="xla").restore_planes(stack, 9, 30.0)
    m = BatchedWienerPipeline(fft_backend="matmul").restore_planes(
        stack, 9, 30.0
    )
    mse = float(((x - m) ** 2).mean())
    assert 10 * np.log10(1.0 / max(mse, 1e-30)) > 50.0

    out_x = BatchedWienerPipeline(fft_backend="xla").restore(stack, 9, 30.0)
    out_m = BatchedWienerPipeline(fft_backend="matmul").restore(stack, 9, 30.0)
    assert np.abs(out_m.astype(int) - out_x.astype(int)).max() <= 2
