"""Pure-NumPy serial oracle for the Wiener deblur pipeline.

This is the semantic ground truth every device mode verifies against —
the same role `fft_serial` plays for every parallel driver in the
reference (SURVEY.md §4, reference fft/fft_serial.cpp).

Numerical fidelity notes (all mirror fft_serial.cpp):
  * complex64 (float32 re/im) throughout.
  * Radix-2 butterflies in the exact C++ order: bit-reversal permutation,
    then for len = 2,4,...,n combine u = a[i+k], v = a[i+k+len/2]*w
    (fft_serial.cpp:40-68). The per-stage twiddle w is produced by the
    *recurrence* w *= wlen in complex64 — NOT an exact table — so it
    drifts exactly like the C++ float recurrence (fft_serial.cpp:57-63).
    Rows are vectorized here, which preserves the per-element op sequence.
  * Inverse transform applies NO 1/(M*N) scaling (fft_serial.cpp:67);
    the final min-max normalize absorbs it (fft_serial.cpp:246).
  * The Wiener |H|^2 is computed as (sqrt(re^2+im^2))^2 — sqrt-then-square,
    wastefully, exactly like magnitude() then mul (fft_serial.cpp:195-197).
  * Min-max normalization runs over the *padded* plane before the driver
    crops to the original size (fft_serial.cpp:243-246, serial.cpp:36-38).
"""

from __future__ import annotations

import math

import numpy as np

from fft_restoration_tpu.utils.padding import is_power_of_two, next_power_of_two

_CV_PI = math.pi


def _bit_reversal_permutation(n: int) -> np.ndarray:
    """Index permutation equivalent to the swap loop at fft_serial.cpp:45-51."""
    perm = np.zeros(n, dtype=np.int64)
    j = 0
    for i in range(1, n):
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j ^= bit
        perm[i] = j
    # perm[i] = partner of i; the swap-if(i<j) loop realizes the full
    # bit-reversal permutation since bitrev is an involution.
    return perm


def _stage_twiddles(length: int, inverse: bool) -> np.ndarray:
    """Twiddles for one stage via the float32 recurrence w *= wlen.

    Matches fft_serial.cpp:54-63: wlen = (cos(ang), sin(ang)) with
    ang = 2*pi/len * (inverse ? +1 : -1), and w starts at 1 and is
    multiplied by wlen once per butterfly, in complex64.
    """
    ang = np.float32(2.0 * _CV_PI / length * (1.0 if inverse else -1.0))
    wlen = np.complex64(complex(np.cos(ang), np.sin(ang)))
    seq = np.full(length // 2, wlen, dtype=np.complex64)
    seq[0] = np.complex64(1.0)
    # cumprod is sequential left-to-right: w_k = w_{k-1} * wlen, same op
    # sequence (and same float32 rounding) as the C++ recurrence.
    return np.cumprod(seq, dtype=np.complex64)


def fft_radix2(a: np.ndarray, inverse: bool) -> np.ndarray:
    """Iterative radix-2 Cooley-Tukey over the last axis (power-of-two length).

    Vectorized over leading axes; per-element arithmetic matches
    fft_serial.cpp:40-68 including the drifting float32 twiddle recurrence.
    No scaling on inverse.
    """
    a = np.ascontiguousarray(a, dtype=np.complex64)
    n = a.shape[-1]
    if n <= 1:
        return a
    if not is_power_of_two(n):
        raise ValueError(f"fft_radix2 requires power-of-two length, got {n}")
    perm = _bit_reversal_permutation(n)
    a = a[..., perm]
    length = 2
    while length <= n:
        half = length // 2
        w = _stage_twiddles(length, inverse)  # (half,) complex64
        blocks = a.reshape(a.shape[:-1] + (n // length, length))
        u = blocks[..., :half]
        v = (blocks[..., half:] * w).astype(np.complex64)
        upper = (u + v).astype(np.complex64)
        lower = (u - v).astype(np.complex64)
        a = np.concatenate([upper, lower], axis=-1).reshape(a.shape)
        length <<= 1
    return a


def dft_naive(a: np.ndarray, inverse: bool) -> np.ndarray:
    """O(n^2) direct DFT over the last axis for arbitrary n.

    Mirrors dft_naive_inplace (fft_serial.cpp:71-87): float32 angles,
    complex64 accumulation, no scaling on inverse.
    """
    a = np.asarray(a, dtype=np.complex64)
    n = a.shape[-1]
    if n <= 1:
        return a
    sign = np.float32(1.0 if inverse else -1.0)
    k = np.arange(n, dtype=np.float32)[:, None]
    t = np.arange(n, dtype=np.float32)[None, :]
    ang = (np.float32(2.0 * _CV_PI) * k * t / np.float32(n) * sign).astype(np.float32)
    w = (np.cos(ang) + 1j * np.sin(ang)).astype(np.complex64)
    return np.einsum("...t,kt->...k", a, w).astype(np.complex64)


def transform_rows(a: np.ndarray, inverse: bool) -> np.ndarray:
    """1D transform of every row (last axis); radix-2 if pow2 else naive DFT.

    Mirrors transform_row_inplace (fft_serial.cpp:90-108).
    """
    n = a.shape[-1]
    if is_power_of_two(n):
        return fft_radix2(a, inverse)
    return dft_naive(a, inverse)


def dft2d(a: np.ndarray, inverse: bool) -> np.ndarray:
    """2D separable transform over the last two axes.

    Row pass -> transpose -> row pass -> transpose back, mirroring
    my_dft2D (fft_serial.cpp:113-139). No scaling on inverse.
    """
    a = transform_rows(a, inverse)
    a = np.swapaxes(a, -1, -2)
    a = transform_rows(a, inverse)
    return np.swapaxes(a, -1, -2)


def _pad_to(a: np.ndarray, rows: int, cols: int) -> np.ndarray:
    pad = [(0, 0)] * (a.ndim - 2) + [(0, rows - a.shape[-2]), (0, cols - a.shape[-1])]
    return np.pad(a, pad, mode="constant")


def wiener_deblur(
    img: np.ndarray, psf: np.ndarray, K: float = 0.01, pad_to=None
) -> np.ndarray:
    """Wiener deconvolution of one (padded) channel. Oracle for
    wienerDeblur_myfft (fft_serial.cpp:141-261).

    img: (H, W) float32 channel in [0,1], typically already power-of-two
         padded by the driver (serial.cpp:36).
    psf: (S, S) float32 blur kernel (corner-anchored after padding — the
         reference does NOT fftshift it, utils.hpp:15-24).
    pad_to: explicit (rows, cols) DFT extents — the parity target for
         the pipeline's --pad smooth mode (non-pow2 extents run the
         naive-DFT path, mirroring fft_serial.cpp:100-101; the restored
         output depends on the pad extent, so oracle and pipeline must
         agree on it).
    Returns the restored (H, W) float32 plane, min-max normalized to [0,1]
    over the full padded extent.
    """
    img = np.asarray(img, dtype=np.float32)
    psf = np.asarray(psf, dtype=np.float32)
    if pad_to is not None:
        opt_r, opt_c = int(pad_to[0]), int(pad_to[1])
        if opt_r < img.shape[0] or opt_c < img.shape[1]:
            raise ValueError(
                f"pad_to {pad_to} smaller than the image {img.shape}"
            )
    else:
        # getOptimalDFTSize on a power-of-two input is the identity; the
        # reference driver always pre-pads to pow2 (serial.cpp:20,36), so
        # we pad to next_power_of_two here (no-op when already padded).
        opt_r = next_power_of_two(img.shape[0])
        opt_c = next_power_of_two(img.shape[1])

    # Pre-process: zero-pad, complexify (fft_serial.cpp:157-171).
    complex_i = _pad_to(img, opt_r, opt_c).astype(np.complex64)
    psf_c = _pad_to(psf, opt_r, opt_c).astype(np.complex64)

    # FFT image / FFT PSF (fft_serial.cpp:176,182).
    G = dft2d(complex_i, inverse=False)
    H = dft2d(psf_c, inverse=False)

    # Wiener filter (fft_serial.cpp:185-224): F = G * conj(H) / (|H|^2 + K)
    # with |H|^2 computed via sqrt-then-square like magnitude().mul().
    mag = np.sqrt(H.real * H.real + H.imag * H.imag, dtype=np.float32)
    denom = (mag * mag + np.float32(K)).astype(np.float32)
    num_re = (G.real * H.real - G.imag * (-H.imag)).astype(np.float32)
    num_im = (G.real * (-H.imag) + G.imag * H.real).astype(np.float32)
    res = ((num_re / denom) + 1j * (num_im / denom)).astype(np.complex64)

    # IFFT, unscaled (fft_serial.cpp:229).
    res = dft2d(res, inverse=True)

    # Post-process: real part, crop (no-op for pow2 input), min-max
    # normalize to [0,1] over the padded plane (fft_serial.cpp:238-246).
    restored = res.real[: img.shape[0], : img.shape[1]].astype(np.float32)
    lo = restored.min()
    hi = restored.max()
    scale = np.float32(1.0) / np.float32(hi - lo) if hi > lo else np.float32(0.0)
    return ((restored - lo) * scale).astype(np.float32)


def restore_channels(
    channels: np.ndarray,
    psf: np.ndarray,
    K: float = 0.01,
    use_power_of_two: bool = True,
    pad_to=None,
    edgetaper: bool = False,
) -> np.ndarray:
    """Per-channel restoration loop of the serial driver (serial.cpp:34-39).

    channels: (C, H, W) float32 in [0,1]. Returns (C, H, W) restored
    planes. pad_to: explicit DFT extents (see wiener_deblur) — overrides
    the pow2 pre-pad. edgetaper: blend the padded frame toward its
    circular blur at the borders first (oracle/edgetaper.py — an
    extension knob, NOT reference behavior; the CLI enables it on both
    sides so verification still runs).
    """
    channels = np.asarray(channels, dtype=np.float32)
    h, w = channels.shape[-2:]
    if edgetaper:
        if pad_to is not None:
            opt = (int(pad_to[0]), int(pad_to[1]))
        elif use_power_of_two:
            opt = (next_power_of_two(h), next_power_of_two(w))
        else:
            opt = (h, w)
        from fft_restoration_tpu.oracle.edgetaper import edge_taper_channels

        padded = _pad_to(channels, *opt)
        tapered = edge_taper_channels(padded, psf, (h, w))
        return np.stack(
            [
                wiener_deblur(tapered[c], psf, K, pad_to=opt)[:h, :w]
                for c in range(tapered.shape[0])
            ],
            axis=0,
        )
    out = []
    for c in range(channels.shape[0]):
        ch = channels[c]
        if pad_to is None and use_power_of_two:
            ch = _pad_to(ch, next_power_of_two(h), next_power_of_two(w))
        restored = wiener_deblur(ch, psf, K, pad_to=pad_to)
        out.append(restored[:h, :w])
    return np.stack(out, axis=0)


def restore_image(
    img_bgr: np.ndarray,
    psf_length: int,
    psf_angle: float,
    K: float = 0.01,
    edgetaper: bool = False,
    psf_type: str = "motion",
) -> np.ndarray:
    """Full serial driver: uint8 BGR -> restored uint8 BGR (serial.cpp:9-61).

    Steps: /255 float32 -> per-channel Wiener deblur -> merge -> BGR->Lab ->
    white balance (L gain) -> Lab->BGR -> *255 uint8.
    """
    from fft_restoration_tpu.oracle.psf import make_psf_oracle
    from fft_restoration_tpu.oracle.color import (
        bgr_to_lab,
        lab_to_bgr,
        apply_white_balance,
    )

    img = np.asarray(img_bgr, dtype=np.float32) / np.float32(255.0)
    psf = make_psf_oracle(psf_type, psf_length, psf_angle)
    chans = np.moveaxis(img, -1, 0)  # (3, H, W), BGR order
    restored = restore_channels(chans, psf, K, edgetaper=edgetaper)
    merged = np.moveaxis(restored, 0, -1)  # (H, W, 3)

    lab_deblur = bgr_to_lab(merged)
    lab_orig = bgr_to_lab(img)
    corrected = apply_white_balance(lab_deblur, lab_orig)
    bgr = lab_to_bgr(corrected)
    return np.clip(bgr * np.float32(255.0), 0, 255).astype(np.uint8)
