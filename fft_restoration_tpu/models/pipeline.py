"""Single-device Wiener-deblur pipeline: one fused jit graph.

Counterpart of the reference's accelerator mode (reference
fft/fft_gpu.cu:279-394 wienerDeblur_RGB_optimized + gpu.cpp driver):
where CUDA stages pinned-host H2D copies, per-kernel launches and
explicit device buffers, here the WHOLE restoration — pad, complexify,
PSF synthesis, forward FFTs, filter, inverse FFT, crop, min-max
normalize, Lab white balance, uint8 encode — is one traced XLA graph.
The FFTs are library calls (cuFFT through ``jnp.fft`` on the GPU) and
XLA fuses the elementwise phases between them. Buffer reuse falls out of
XLA's allocator + input donation (the reference's optimized-vs-naive
allocation comparison, SURVEY.md §2 row 9, is subsumed by
donate_argnums).

Semantics preserved from the serial oracle (SURVEY.md §7 contract):
  * channels are power-of-two padded BEFORE restoration (serial.cpp:36),
  * min-max normalize runs over the PADDED extent, then crop
    (fft_serial.cpp:246, serial.cpp:38),
  * the IFFT stays UNSCALED and min-max normalize absorbs 1/(M*N) — the
    serial convention (fft_serial.cpp:229,246). Normalize is exactly
    scale-invariant, so this matches the GPU/MPI explicit-scale outputs
    too while saving one elementwise pass.

Phase labels: every section runs under a ``fphase_*`` named scope
(ingest_pad, fft_psf, fft_image, filter, ifft, normalize, wb_encode), which
utils/trace_profile.phase_breakdown reads back from the device trace.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from fft_restoration_tpu.models.filters import apply_filter
from fft_restoration_tpu.ops.color import apply_white_balance, bgr_to_lab, lab_to_bgr
from fft_restoration_tpu.ops.fft import DEFAULT_FFT_BACKEND, fft2d
from fft_restoration_tpu.ops.psf import make_psf
from fft_restoration_tpu.utils.padding import next_power_of_two, next_smooth_size

PAD_MODES = ("pow2", "smooth")


def pad_extents(h: int, w: int, pad_mode: str = "pow2"):
    """DFT extents (hp, wp) for an (h, w) frame.

    'pow2' — the reference contract (utils.hpp:40-47).
    'smooth' — minimal odd*2^k extents (odd in {3,5,9,15}), which cuFFT
    and the matmul backend's generalized four-step transform at
    O(n log n). NOTE: the Wiener output depends on the pad extent
    (circular boundary), so smooth mode is verified against the oracle
    AT THE SAME extents (oracle/serial.py pad_to), not against the
    pow2-padded output."""
    if pad_mode == "smooth":
        return next_smooth_size(h), next_smooth_size(w)
    if pad_mode != "pow2":
        raise ValueError(f"unknown pad mode {pad_mode!r}; one of {PAD_MODES}")
    return next_power_of_two(h), next_power_of_two(w)


def _pad2d(x: jnp.ndarray, rows: int, cols: int) -> jnp.ndarray:
    if rows == x.shape[-2] and cols == x.shape[-1]:
        return x  # already at extent: no pad copy
    pad = [(0, 0)] * (x.ndim - 2) + [
        (0, rows - x.shape[-2]),
        (0, cols - x.shape[-1]),
    ]
    return jnp.pad(x, pad)


def _pack_channel_pairs(channels: jnp.ndarray):
    """Pack adjacent real channels as complex planes: (..., C, H, W) ->
    SoA (re, im) of shape (..., ceil(C/2), H, W).

    The DFT is linear and every filter in this framework multiplies by a
    single Hermitian spectrum W = conj(H)/(|H|^2 + ...), so for real
    channels r, g:  ifft(W * fft(r + i*g)) = ifft(W*R) + i*ifft(W*G) —
    the restored channels fall out of the real/imag parts with NO
    Hermitian unpack. 3 channels ride 2 complex transforms instead of 3
    (-33% FFT work); even channel counts get the full 2x. The reference
    runs one full complex FFT per channel (serial.cpp:34-39)."""
    c = channels.shape[-3]
    re = channels[..., 0::2, :, :]
    im = channels[..., 1::2, :, :]
    if c % 2:
        pad = jnp.zeros_like(channels[..., :1, :, :])
        im = jnp.concatenate([im, pad], axis=-3)
    return re, im


def _unpack_channel_pairs(re: jnp.ndarray, im: jnp.ndarray, c: int) -> jnp.ndarray:
    """Inverse of _pack_channel_pairs: interleave real/imag planes back
    into (..., C, H, W) channel order."""
    stacked = jnp.stack([re, im], axis=-3)  # (..., P, 2, H, W)
    shape = stacked.shape[:-4] + (2 * re.shape[-3],) + stacked.shape[-2:]
    return stacked.reshape(shape)[..., :c, :, :]


def _minmax_normalize(x: jnp.ndarray) -> jnp.ndarray:
    """Per-plane min-max to [0,1] over the last two axes, with the
    reference's degenerate-range convention scale=0 (fft_serial.cpp:246
    via cv::normalize NORM_MINMAX)."""
    lo = jnp.min(x, axis=(-2, -1), keepdims=True)
    hi = jnp.max(x, axis=(-2, -1), keepdims=True)
    scale = jnp.where(hi > lo, 1.0 / (hi - lo), 0.0)
    return (x - lo) * scale


def _u8_to_unit(x: jnp.ndarray) -> jnp.ndarray:
    """uint8 -> float32 in [0, 1]; exact division (not a reciprocal
    multiply) so it bit-matches the oracle's host-side conversion."""
    if x.dtype == jnp.uint8:
        return x.astype(jnp.float32) / jnp.float32(255.0)
    return x


def restore_planes(
    channels: jnp.ndarray,
    psf: jnp.ndarray,
    K,
    *,
    fft_backend: str = DEFAULT_FFT_BACKEND,
    filter_name: str = "wiener",
    rl_iters: int = 10,
    normalize: bool = True,
) -> jnp.ndarray:
    """Restore (..., Hp, Wp) planes (pow2 or smooth extents) with an
    (S, S) PSF.

    normalize=False returns the RAW unscaled-inverse planes instead of
    min-max normalizing them — the tiled-restore path (models/tiled.py)
    stitches raw tiles and normalizes globally so tile brightness stays
    consistent. The filter is linear in the input, so raw planes from
    same-extent transforms are directly comparable. ('rl' ignores it:
    the RL loop's clipped [0,1] output is already flux-calibrated.)

    The (...) leading axes batch channels/images — the counterpart of
    the reference's sequential per-channel loop (serial.cpp:34-39); the
    PSF FFT is computed once and broadcast.
    Returns restored planes, min-max normalized over the padded extent.
    """
    hp, wp = channels.shape[-2:]
    channels = _u8_to_unit(channels)
    if filter_name == "rl":
        # iterative Richardson-Lucy: its own fori_loop pipeline (it is
        # not a one-shot spectral multiply); K is unused by design
        from fft_restoration_tpu.models.richardson_lucy import (
            richardson_lucy_planes,
        )

        return richardson_lucy_planes(
            channels, psf, rl_iters, fft_backend=fft_backend
        )
    with jax.named_scope("fphase_fft_psf"):
        psf_pad = _pad2d(psf, hp, wp)
        H = fft2d(psf_pad, jnp.zeros_like(psf_pad), False, fft_backend)
    with jax.named_scope("fphase_fft_image"):
        if channels.ndim >= 3 and channels.shape[-3] >= 2:
            c = channels.shape[-3]
            p_re, p_im = _pack_channel_pairs(channels)
        else:
            c = None
            p_re, p_im = channels, jnp.zeros_like(channels)
        G = fft2d(p_re, p_im, False, fft_backend)
    with jax.named_scope("fphase_filter"):
        F = apply_filter(filter_name, G, H, K, backend=fft_backend)
    with jax.named_scope("fphase_ifft"):
        r_re, r_im = fft2d(F[0], F[1], True, fft_backend)
        restored = r_re if c is None else _unpack_channel_pairs(r_re, r_im, c)
    if not normalize:
        return restored
    # No 1/(MN) scale: min-max normalize is scale-invariant, and the
    # serial oracle also normalizes the unscaled inverse directly
    # (fft_serial.cpp:229,246 — SURVEY.md §7 item 5). Saves a full
    # elementwise pass over the restored planes.
    with jax.named_scope("fphase_normalize"):
        return _minmax_normalize(restored)


def wb_encode(
    restored: jnp.ndarray, orig: jnp.ndarray, white_balance: bool = True
) -> jnp.ndarray:
    """(..., 3, H, W) restored BGR planes -> (..., H, W, 3) uint8.

    White balance (reference utils.hpp:55-71): scale each frame's Lab L
    by mean L of its ORIGINAL planes `orig` (uint8 or [0, 1] float,
    same shape) over mean L of the restored ones, then back to BGR and
    encode. Leading axes batch frames; each frame gets its own gain.
    Post-processing stays PLANAR: channels interleave exactly once, at
    the final uint8 stack."""
    from fft_restoration_tpu.ops.color import (
        bgr_to_lab_planar,
        lab_to_bgr_planar,
        luminance_l_planar,
    )

    planes = tuple(restored[..., c, :, :] for c in range(3))
    if white_balance:
        L, a_, b_ = bgr_to_lab_planar(*planes)
        o = _u8_to_unit(orig)
        l_orig = luminance_l_planar(
            o[..., 0, :, :], o[..., 1, :, :], o[..., 2, :, :]
        )
        gain = jnp.mean(l_orig, axis=(-2, -1), keepdims=True) / (
            jnp.mean(L, axis=(-2, -1), keepdims=True) + 1e-6
        )
        planes = lab_to_bgr_planar(jnp.clip(L * gain, 0.0, 100.0), a_, b_)
    return jnp.stack(
        [jnp.clip(p * 255.0, 0.0, 255.0).astype(jnp.uint8) for p in planes],
        axis=-1,
    )


def _restore_core(
    img: jnp.ndarray,
    angle_deg: jnp.ndarray,
    K: jnp.ndarray,
    *,
    psf_length: int,
    fft_backend: str = DEFAULT_FFT_BACKEND,
    filter_name: str = "wiener",
    white_balance: bool = True,
    emit_planes: bool = True,
    pad_mode: str = "pow2",
    rl_iters: int = 10,
    edgetaper: bool = False,
    psf_type: str = "motion",
):
    """(H, W, 3) BGR image -> (H, W, 3) uint8 BGR restored.

    Accepts float32 in [0,1] OR uint8: uint8 inputs are converted
    on-device AFTER the channel de-interleave, so the (H, W, 3)->
    (3, H, W) transpose reads 1-byte pixels and the host ships a 4x
    smaller buffer.

    pad_mode='smooth': minimal odd*2^k DFT extents instead of the pow2
    pad (see pad_extents) — e.g. UHD 3840x2160 restores at 3840x2304
    (8.8 MP) instead of 4096x4096 (16.8 MP)."""
    h, w = img.shape[:2]
    hp, wp = pad_extents(h, w, pad_mode)

    with jax.named_scope("fphase_ingest_pad"):
        # PSF family: 'motion' (reference), 'gaussian' (angle_deg is
        # sigma), 'disk' defocus — every filter is kernel-agnostic
        psf = make_psf(psf_type, psf_length, angle_deg)
        chans0 = jnp.moveaxis(img, -1, 0)  # (3, H, W) BGR planes
        chans = _pad2d(_u8_to_unit(chans0), hp, wp)
        if edgetaper:
            from fft_restoration_tpu.models.edgetaper import (
                edge_taper_planes,
            )

            chans = edge_taper_planes(
                chans, psf, (h, w), fft_backend=fft_backend
            )
    restored = restore_planes(
        chans, psf, K, fft_backend=fft_backend, filter_name=filter_name,
        rl_iters=rl_iters,
    )[..., :h, :w]

    with jax.named_scope("fphase_wb_encode"):
        out = wb_encode(restored, chans0, white_balance)
    # emit_planes=False is the serving graph: the (3, H, W) f32
    # diagnostic output is a 50 MB device materialization per 2048²
    # frame that only verification consumes — callers that ship the
    # uint8 image alone skip it (the reference drivers likewise only
    # ever output the image; verification re-runs separately,
    # simd.cpp:66-99)
    if not emit_planes:
        return out
    return out, restored


class WienerDeblurPipeline:
    """Compiled single-device restoration pipeline.

    One instance caches compiled executables per (H, W, psf_length)
    signature; psf angle and K are traced scalars, so PSF sweeps reuse
    the same executable.
    """

    def __init__(
        self,
        fft_backend: str = DEFAULT_FFT_BACKEND,
        filter_name: str = "wiener",
        white_balance: bool = True,
        device: Optional[object] = None,
        donate_input: bool = True,
        emit_planes: bool = True,
        pad_mode: str = "pow2",
        rl_iters: int = 10,
        edgetaper: bool = False,
        psf_type: str = "motion",
    ):
        # emit_planes=False compiles the SERVING graph: restore() skips
        # the (3, H, W) f32 diagnostic planes output (a 50 MB device
        # materialization per 2048² frame that only verification
        # consumes); restore_with_planes()/restore_channels() then
        # raise. The reference drivers likewise only output the image.
        self.emit_planes = emit_planes
        self.fft_backend = fft_backend
        # 'smooth' restores at minimal odd*2^k DFT extents
        # (pad_extents); 'pow2' is the reference contract. The restored
        # output depends on the pad extent, so verification compares
        # against the oracle at matching extents.
        if pad_mode not in PAD_MODES:
            raise ValueError(f"unknown pad mode {pad_mode!r}; one of {PAD_MODES}")
        self.pad_mode = pad_mode
        # iteration count for filter_name='rl' (Richardson-Lucy)
        self.rl_iters = rl_iters
        # border blend toward the circular blur (models/edgetaper.py)
        self.edgetaper = edgetaper
        # 'motion' | 'gaussian' | 'disk' (ops/psf.py make_psf)
        self.psf_type = psf_type
        self.filter_name = filter_name
        self.white_balance = white_balance
        self.device = device
        # Buffer donation lets XLA reuse the input image's device memory
        # for intermediates — the allocation-reuse optimization the CUDA
        # reference demonstrates by hoisting buffers out of the channel
        # loop (wienerDeblur_RGB_optimized vs _naive, fft_gpu.cu:279,400).
        self.donate_input = donate_input
        self._cache = {}

    def _compiled(self, h: int, w: int, psf_length: int):
        key = (h, w, psf_length)
        if key not in self._cache:
            fn = functools.partial(
                _restore_core,
                psf_length=psf_length,
                fft_backend=self.fft_backend,
                filter_name=self.filter_name,
                white_balance=self.white_balance,
                emit_planes=self.emit_planes,
                pad_mode=self.pad_mode,
                rl_iters=self.rl_iters,
                edgetaper=self.edgetaper,
                psf_type=self.psf_type,
            )
            donate = (0,) if self.donate_input else ()
            self._cache[key] = jax.jit(fn, donate_argnums=donate)
        return self._cache[key]

    def _check_psf_fits(self, h: int, w: int, psf_length: int) -> None:
        hp, wp = pad_extents(h, w, self.pad_mode)
        if psf_length > hp or psf_length > wp:
            raise ValueError(
                f"PSF length {psf_length} exceeds the padded "
                f"image ({hp}x{wp}); use a smaller PSF or a larger image"
            )

    def restore(
        self,
        img_bgr: np.ndarray,
        psf_length: int,
        psf_angle: float,
        K: float = 0.01,
    ) -> np.ndarray:
        """uint8 BGR (H, W, 3) -> restored uint8 BGR (H, W, 3)."""
        if not self.emit_planes:
            out = self._run(img_bgr, psf_length, psf_angle, K)
            return np.asarray(out)
        out, _ = self.restore_with_planes(img_bgr, psf_length, psf_angle, K)
        return out

    def restore_with_planes(
        self,
        img_bgr: np.ndarray,
        psf_length: int,
        psf_angle: float,
        K: float = 0.01,
    ):
        """One device execution returning BOTH the final uint8 image and
        the restored float planes (3, H, W) — so callers that verify
        against the oracle don't re-run the whole graph."""
        if not self.emit_planes:
            raise ValueError(
                "this pipeline was built with emit_planes=False (serving "
                "graph); construct with emit_planes=True for diagnostics"
            )
        out, restored = self._run(img_bgr, psf_length, psf_angle, K)
        return np.asarray(out), np.asarray(restored)

    def _run(self, img_bgr, psf_length, psf_angle, K):
        arr = np.asarray(img_bgr)
        if arr.dtype == np.uint8:
            img = jnp.asarray(arr)  # device-side /255 (see _restore_core)
        else:
            # non-uint8 callers keep the historical contract: values are
            # 0..255-scaled and normalized here
            img = jnp.asarray(arr.astype(np.float32) / np.float32(255.0))
        self._check_psf_fits(img.shape[0], img.shape[1], int(psf_length))
        if self.device is not None:
            img = jax.device_put(img, self.device)
        fn = self._compiled(img.shape[0], img.shape[1], int(psf_length))
        return fn(img, jnp.float32(psf_angle), jnp.float32(K))

    def restore_channels(
        self,
        img_bgr: np.ndarray,
        psf_length: int,
        psf_angle: float,
        K: float = 0.01,
    ) -> np.ndarray:
        """Restored float32 planes (3, H, W) before color post-processing —
        the quantity the reference drivers verify against serial
        (simd.cpp:66-99 et al.)."""
        _, restored = self.restore_with_planes(img_bgr, psf_length, psf_angle, K)
        return restored


def profile_phases(
    img_bgr: np.ndarray,
    psf_length: int,
    psf_angle: float,
    K: float = 0.01,
    fft_backend: str = DEFAULT_FFT_BACKEND,
    white_balance: bool = True,
    profiler=None,
    psf_type: str = "motion",
):
    """Run the pipeline as six separately-dispatched device phases and
    accumulate per-phase wall time, preserving the reference's phase
    taxonomy (fft_serial.cpp:158-236: Pre-process / FFT Image / FFT PSF /
    Wiener Filter / IFFT / Post-process; CUDA Profiler fft_gpu.cu:17-57).

    The production path fuses all phases into one graph (XLA erases the
    boundaries), so this instrumented mode exists purely for the
    profiler — each phase is forced to materialize with
    block_until_ready before the next is dispatched.
    Returns (restored uint8 image, PhaseProfiler).
    """
    import jax

    from fft_restoration_tpu.models.filters import apply_filter
    from fft_restoration_tpu.ops.fft import fft2d
    from fft_restoration_tpu.ops.psf import make_psf
    from fft_restoration_tpu.utils.timing import PhaseProfiler

    prof = profiler or PhaseProfiler(mode="jit")
    img = jnp.asarray(np.asarray(img_bgr, np.float32) / np.float32(255.0))
    h, w = img.shape[:2]
    hp, wp = next_power_of_two(h), next_power_of_two(w)

    def sync(tree):
        jax.block_until_ready(tree)

    @jax.jit
    def pre(img):
        psf = make_psf(psf_type, psf_length, jnp.float32(psf_angle))
        chans = _pad2d(jnp.moveaxis(img, -1, 0), hp, wp)
        psf_pad = _pad2d(psf, hp, wp)
        return chans, psf_pad

    fftf = jax.jit(lambda re: fft2d(re, jnp.zeros_like(re), False, fft_backend))
    wien = jax.jit(
        lambda G, H: apply_filter("wiener", G, H, jnp.float32(K), backend=fft_backend)
    )
    ifft = jax.jit(lambda F: fft2d(F[0], F[1], True, fft_backend))

    @jax.jit
    def post(r_re, img):
        restored = _minmax_normalize(r_re)
        merged = jnp.moveaxis(restored[..., :h, :w], 0, -1)
        if white_balance:
            lab_deblur = bgr_to_lab(merged)
            lab_orig = bgr_to_lab(img)
            merged = lab_to_bgr(apply_white_balance(lab_deblur, lab_orig))
        return jnp.clip(merged * 255.0, 0.0, 255.0).astype(jnp.uint8)

    with prof.phase("Pre-process"):
        chans, psf_pad = pre(img)
        sync((chans, psf_pad))
    with prof.phase("FFT Image"):
        G = fftf(chans)
        sync(G)
    with prof.phase("FFT PSF"):
        H = fftf(psf_pad)
        sync(H)
    with prof.phase("Wiener Filter"):
        F = wien(G, H)
        sync(F)
    with prof.phase("IFFT"):
        r = ifft(F)
        sync(r)
    with prof.phase("Post-process"):
        out = post(r[0], img)
        out = np.asarray(out)
    return out, prof


def deblur_image(
    img_bgr: np.ndarray,
    psf_length: int,
    psf_angle: float,
    K: float = 0.01,
    **kwargs,
) -> np.ndarray:
    """One-shot convenience wrapper around WienerDeblurPipeline."""
    return WienerDeblurPipeline(**kwargs).restore(img_bgr, psf_length, psf_angle, K)
