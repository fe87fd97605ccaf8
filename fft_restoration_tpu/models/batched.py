"""Batched restoration: image stacks through one jit graph.

Replacement for the reference's outermost sequential loops —
the per-channel for (serial.cpp:34-39) and any multi-image invocation of
the CLI binaries. Batch and channel become leading array axes of the
same fused graph (e.g. a 64-image stack with a shared PSF).
The PSF spectrum is computed ONCE and broadcast across the whole stack,
the optimization the CUDA mode approximates by hoisting allocations
(fft_gpu.cu:304-322) but cannot get for the PSF FFT itself (it re-runs
it per channel, fft_gpu.cu:356).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from fft_restoration_tpu.models.pipeline import (
    _u8_to_unit,
    pad_extents,
    restore_planes,
    wb_encode,
)
from fft_restoration_tpu.ops.fft import DEFAULT_FFT_BACKEND
from fft_restoration_tpu.ops.psf import make_psf, motion_blur_kernel
from fft_restoration_tpu.utils.padding import next_power_of_two


def _batched_core(
    imgs: jnp.ndarray,
    angle_deg: jnp.ndarray,
    K: jnp.ndarray,
    *,
    psf_length: int,
    fft_backend: str,
    filter_name: str,
    pad_mode: str = "pow2",
    rl_iters: int = 10,
    edgetaper: bool = False,
    psf_type: str = "motion",
):
    """(B, H, W, 3) uint8 or float32 in [0,1] -> (B, 3, H, W) restored
    planes."""
    b, h, w = imgs.shape[:3]
    hp, wp = pad_extents(h, w, pad_mode)
    psf = make_psf(psf_type, psf_length, angle_deg)
    with jax.named_scope("fphase_ingest_pad"):
        chans = _u8_to_unit(jnp.moveaxis(imgs, -1, 1))  # (B, 3, H, W)
        chans = jnp.pad(chans, ((0, 0), (0, 0), (0, hp - h), (0, wp - w)))
        # restore_planes batches over all leading axes at once; one PSF
        # FFT. Flattening (B, 3) -> 3B planes lets channel packing
        # (models/pipeline._pack_channel_pairs) pair planes ACROSS
        # images: ceil(3B/2) complex transforms instead of 2 per image —
        # the full 2x for even batches (a 3-channel image alone gets 2
        # transforms, one half-empty).
        flat = chans.reshape(b * 3, hp, wp)
        if edgetaper:
            from fft_restoration_tpu.models.edgetaper import edge_taper_planes

            flat = edge_taper_planes(
                flat, psf, (h, w), fft_backend=fft_backend
            )
    restored = restore_planes(
        flat,
        psf,
        K,
        fft_backend=fft_backend,
        filter_name=filter_name,
        rl_iters=rl_iters,
    ).reshape(b, 3, hp, wp)
    return restored[..., :h, :w]


def _batched_images_core(
    imgs: jnp.ndarray,
    angle_deg: jnp.ndarray,
    K: jnp.ndarray,
    *,
    psf_length: int,
    fft_backend: str,
    filter_name: str,
    white_balance: bool,
    emit_planes: bool = True,
    pad_mode: str = "pow2",
    rl_iters: int = 10,
    edgetaper: bool = False,
    psf_type: str = "motion",
):
    """(B, H, W, 3) uint8/float BGR -> ((B, H, W, 3) uint8, (B, 3, H, W)
    planes): the batched analog of pipeline._restore_core — ALL
    post-processing (per-frame Lab white balance, uint8 encode) stays on
    device. The planar color functions are elementwise, so they batch
    over (B, H, W) planes directly; the per-frame means reduce over the
    trailing axes."""
    restored = _batched_core(
        imgs,
        angle_deg,
        K,
        psf_length=psf_length,
        fft_backend=fft_backend,
        filter_name=filter_name,
        pad_mode=pad_mode,
        rl_iters=rl_iters,
        edgetaper=edgetaper,
        psf_type=psf_type,
    )
    with jax.named_scope("fphase_wb_encode"):
        out = wb_encode(restored, jnp.moveaxis(imgs, -1, 1), white_balance)
    return out, (restored if emit_planes else None)


class BatchedWienerPipeline:
    """Restore a stack of same-shape images with one shared PSF."""

    def __init__(
        self,
        fft_backend: str = DEFAULT_FFT_BACKEND,
        filter_name: str = "wiener",
        white_balance: bool = True,
        emit_planes: bool = True,
        pad_mode: str = "pow2",
        rl_iters: int = 10,
        edgetaper: bool = False,
        psf_type: str = "motion",
    ):
        self.fft_backend = fft_backend
        self.filter_name = filter_name
        self.white_balance = white_balance
        # serving graph: skip the (B, 3, H, W) diagnostic planes output
        # (see pipeline.WienerDeblurPipeline emit_planes)
        self.emit_planes = emit_planes
        # 'smooth' = minimal odd*2^k DFT extents (pipeline.pad_extents)
        self.pad_mode = pad_mode
        self.rl_iters = rl_iters
        # border blend toward the circular blur (models/edgetaper.py)
        self.edgetaper = edgetaper
        self.psf_type = psf_type
        self._cache = {}
        self._img_cache = {}

    def _compiled(self, b: int, h: int, w: int, psf_length: int):
        key = (b, h, w, psf_length)
        if key not in self._cache:
            self._cache[key] = jax.jit(
                functools.partial(
                    _batched_core,
                    psf_length=psf_length,
                    fft_backend=self.fft_backend,
                    filter_name=self.filter_name,
                    pad_mode=self.pad_mode,
                    rl_iters=self.rl_iters,
                    edgetaper=self.edgetaper,
                    psf_type=self.psf_type,
                )
            )
        return self._cache[key]

    def restore_planes(
        self,
        imgs_bgr: np.ndarray,
        psf_length: int,
        psf_angle: float,
        K: float = 0.01,
    ) -> np.ndarray:
        """(B, H, W, 3) uint8 -> (B, 3, H, W) float32 restored planes."""
        imgs = jnp.asarray(np.asarray(imgs_bgr, np.float32) / np.float32(255.0))
        fn = self._compiled(*imgs.shape[:3], int(psf_length))
        return np.asarray(fn(imgs, jnp.float32(psf_angle), jnp.float32(K)))

    def restore(
        self,
        imgs_bgr: np.ndarray,
        psf_length: int,
        psf_angle: float,
        K: float = 0.01,
    ) -> np.ndarray:
        """(B, H, W, 3) uint8 -> (B, H, W, 3) uint8 restored, with
        per-frame Lab white balance ON DEVICE (the host-side per-frame
        NumPy color loop was the batch path's throughput ceiling)."""
        arr = np.asarray(imgs_bgr)
        imgs = jnp.asarray(
            arr if arr.dtype == np.uint8
            else arr.astype(np.float32) / np.float32(255.0)
        )
        key = (imgs.shape[:3], int(psf_length))
        if key not in self._img_cache:
            self._img_cache[key] = jax.jit(
                functools.partial(
                    _batched_images_core,
                    psf_length=int(psf_length),
                    fft_backend=self.fft_backend,
                    filter_name=self.filter_name,
                    white_balance=self.white_balance,
                    emit_planes=self.emit_planes,
                    pad_mode=self.pad_mode,
                    rl_iters=self.rl_iters,
                    edgetaper=self.edgetaper,
                    psf_type=self.psf_type,
                )
            )
        out, _ = self._img_cache[key](
            imgs, jnp.float32(psf_angle), jnp.float32(K)
        )
        return np.asarray(out)


def _sweep_one_length(
    chans, angles, K, *, h, w, psf_length, fft_backend
):
    def one_angle(angle):
        psf = motion_blur_kernel(psf_length, angle)
        return restore_planes(
            chans, psf, K, fft_backend=fft_backend, filter_name="wiener"
        )[..., :h, :w]

    return jax.vmap(one_angle)(angles)


# jitted sweep executables keyed on (shape, length, backend): fresh
# closures per call would RE-TRACE every sweep (measured 10.4 s of host
# overhead for a 16-point car sweep whose device work is ~3 ms)
_SWEEP_JIT_CACHE = {}


def psf_grid_sweep(
    img_bgr: np.ndarray,
    psf_lengths,
    psf_angles,
    K: float = 0.01,
    fft_backend: str = DEFAULT_FFT_BACKEND,
) -> np.ndarray:
    """(length, angle) PSF grid sweep on one image.

    Angles are a traced vmap axis (one compile per distinct length, since
    length is a shape). Returns (n_lengths, n_angles, 3, H, W) planes.
    """
    img = jnp.asarray(np.asarray(img_bgr, np.float32) / np.float32(255.0))
    h, w = img.shape[:2]
    hp, wp = next_power_of_two(h), next_power_of_two(w)
    chans = jnp.moveaxis(img, -1, 0)
    chans = jnp.pad(chans, ((0, 0), (0, hp - h), (0, wp - w)))

    results = []
    angles = jnp.asarray(np.asarray(psf_angles, np.float32))
    for length in psf_lengths:
        key = (h, w, int(length), fft_backend)
        if key not in _SWEEP_JIT_CACHE:
            _SWEEP_JIT_CACHE[key] = jax.jit(
                functools.partial(
                    _sweep_one_length,
                    h=h,
                    w=w,
                    psf_length=int(length),
                    fft_backend=fft_backend,
                )
            )
        results.append(_SWEEP_JIT_CACHE[key](chans, angles, jnp.float32(K)))
    return np.asarray(jnp.stack(results, axis=0))
