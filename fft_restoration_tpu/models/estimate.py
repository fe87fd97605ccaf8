"""Blind motion-PSF estimation from the blurred image (cepstral method).

The reference requires the user to KNOW the blur parameters — every
driver takes <psf-length> <psf-angle> positionals
(reference serial.cpp:12-18) and the fixtures' parameters are
documented in the README. This module removes that requirement: a
linear motion blur of length L multiplies the image spectrum by a
sinc-like transfer function whose periodic zeros put strong NEGATIVE
peaks into the cepstrum

    C = IFFT( log |FFT(image)|^2 )

at distance L along the blur direction (Cannon, "Blind deconvolution
of spatially invariant image blurs with phase", IEEE TASSP 1976 — the
classic cepstral blur-identification result). Estimating (L, angle) is
therefore: window the image, one FFT, log-power, one IFFT, argmin over
an annulus.

The whole estimator is ONE jit graph on the SoA fft2d backends, with
the Hann window and the annulus mask
baked as constants; only the final argmin index is converted to
(length, angle) on the host. The y-down image convention mirrors the
cepstral angle, so the returned angle is (-atan2) mod 180 — calibrated
against utils/blurgen.py syntheses (tests/test_estimate.py).
"""

from __future__ import annotations

import functools
import math

import numpy as np

import jax
import jax.numpy as jnp

from fft_restoration_tpu.ops.fft import DEFAULT_FFT_BACKEND, fft2d
from fft_restoration_tpu.utils.padding import next_power_of_two


def _annulus_mask(hp: int, wp: int, r_min: float, r_max: float) -> np.ndarray:
    yy, xx = np.mgrid[-(hp // 2) : hp - hp // 2, -(wp // 2) : wp - wp // 2]
    r = np.hypot(yy, xx)
    return (r >= r_min) & (r <= r_max)


@functools.partial(
    jax.jit, static_argnames=("hp", "wp", "r_min", "r_max", "fft_backend")
)
def _cepstral_peak(
    gray: jnp.ndarray,
    *,
    hp: int,
    wp: int,
    r_min: float,
    r_max: float,
    fft_backend: str,
):
    """(H, W) float32 grayscale -> (flat argmin index over the shifted
    (hp, wp) cepstrum, peak value, cepstrum origin value)."""
    h, w = gray.shape
    wy = np.hanning(h).astype(np.float32)
    wx = np.hanning(w).astype(np.float32)
    g = (gray - jnp.mean(gray)) * jnp.asarray(wy)[:, None] * jnp.asarray(
        wx
    )[None, :]
    g = jnp.pad(g, ((0, hp - h), (0, wp - w)))
    f_re, f_im = fft2d(g, jnp.zeros_like(g), False, fft_backend)
    # log2 instead of ln: same argmin (positive scale)
    p = jnp.log2(f_re * f_re + f_im * f_im + jnp.float32(1e-12))
    c_re, _ = fft2d(p, jnp.zeros_like(p), True, fft_backend)
    c = jnp.roll(c_re, (hp // 2, wp // 2), axis=(0, 1))  # fftshift
    mask = jnp.asarray(_annulus_mask(hp, wp, r_min, r_max))
    cm = jnp.where(mask, c, jnp.inf)
    idx = jnp.argmin(cm)
    # robust annulus statistics for the confidence z-score: how far the
    # peak sits below the cepstrum's own noise floor
    vals = jnp.where(mask, c, jnp.nan)
    med = jnp.nanmedian(vals)
    mad = jnp.nanmedian(jnp.abs(vals - med)) + jnp.float32(1e-12)
    return idx, cm.reshape(-1)[idx], med, mad


# confidence z-score below which the frame likely carries no linear
# motion blur (sharp structured scene measured ~10; blurred 18-69)
_CONF_WARN = 14.0


def estimate_motion_psf(
    img_bgr: np.ndarray,
    *,
    fft_backend: str = DEFAULT_FFT_BACKEND,
    max_length: int | None = None,
) -> tuple[int, float, float]:
    """Estimate (length, angle_deg, confidence) of a linear motion blur
    from a blurred uint8/float BGR image.

    length is in the CLI's psf-length units (the PSF side synthesized
    by ops/psf.motion_blur_kernel); angle is in [0, 180) degrees, the
    same convention the CLI positionals take (the PSF is symmetric, so
    angle is defined mod 180). confidence is a robust z-score: how many
    MAD-sigmas the cepstral peak sits below the annulus median —
    measured 18-69 on most linearly blurred frames (fixtures 50-55)
    vs ~10 on a sharp structured scene; long oblique blurs can dip to
    ~13 (correct estimate, spread peak), so _CONF_WARN=14 is a warning
    threshold, not a rejection — the CLI proceeds with the estimate
    either way and only prints a note.
    """
    img = np.asarray(img_bgr)
    if img.ndim == 3:
        gray = img.astype(np.float32).mean(axis=-1)
    else:
        gray = img.astype(np.float32)
    h, w = gray.shape
    if min(h, w) < 12:
        # r_max = min(h,w)//3 must clear r_min=3 or the annulus is
        # empty and the argmin returns garbage (the fftshift origin)
        raise ValueError(
            f"image too small for blur estimation (min dim {min(h, w)} "
            f"< 12)"
        )
    hp, wp = next_power_of_two(h), next_power_of_two(w)
    r_max = float(
        min(min(h, w) // 3, max_length if max_length else 10**9)
    )
    idx, peak, med, mad = _cepstral_peak(
        jnp.asarray(gray), hp=hp, wp=wp, r_min=3.0, r_max=r_max,
        fft_backend=fft_backend,
    )
    iy, ix = np.unravel_index(int(idx), (hp, wp))
    dy, dx = iy - hp // 2, ix - wp // 2
    length = int(round(float(np.hypot(dy, dx))))
    # y points down in image coords -> the cepstral angle is mirrored
    angle = float((-np.degrees(np.arctan2(dy, dx))) % 180.0)
    conf = float((med - peak) / (1.4826 * mad))
    if not np.isfinite(conf):
        conf = 0.0  # degenerate cepstrum (constant frame): no blur signal
    return length, angle, conf


# ---------------------------------------------------------------------------
# PSF-family blind estimation: disk diameter and gaussian sigma.
#
# Both work on radially AVERAGED spectral statistics of the square
# power-of-two padded, Hann-windowed frame — one jit graph computes the
# power spectrum, its log-cepstrum, and their radial bin sums
# (segment_sum over a precomputed radius-bin map); the host converts
# bins to profiles and does the tiny 1D analysis.
#
#   disk:     |H| is Airy-like with zero rings spaced ~1/size cycles/px,
#             so the cepstrum carries a negative RING at radius ~= size.
#             The radial cepstral profile's argmin (parabola-refined,
#             calibrated /0.967 for the first-zero offset 3.83 vs the
#             asymptotic pi spacing of J1's zeros) recovers the diameter
#             to +-1 px on blurgen syntheses (tests/test_estimate.py).
#   gaussian: NO spectral zeros exist — identification needs an image
#             prior. We scan sigma over a log grid, subtract each
#             candidate's EXACT truncated-sampled-kernel radial log-MTF
#             (separable outer sum of 1D factors, the same kernel
#             ops/psf.gaussian_kernel synthesizes), and keep the sigma
#             whose deblurred profile best fits a power law
#             a + b*ln(rho) (Huber-weighted). Typical accuracy is
#             10-20% on structured scenes; a frame whose spectrum is
#             intrinsically steep (smooth scene) is PHYSICALLY
#             ambiguous — the confidence ratio (power-law residual
#             with no blur / residual at the best sigma) stays near 1
#             there and the CLI warns below _GAUSS_CONF_WARN.
# ---------------------------------------------------------------------------


def _radial_bin_map(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Radius-bin ids for the UNSHIFTED (n, n) DFT grid (so no fftshift
    roll is needed in-graph) and the per-bin counts."""
    d = np.minimum(np.arange(n), n - np.arange(n)).astype(np.float64)
    r = np.hypot(d[:, None], d[None, :])
    rbin = np.round(r).astype(np.int32)
    counts = np.bincount(rbin.ravel()).astype(np.float64)
    return rbin, counts


@functools.partial(jax.jit, static_argnames=("n", "fft_backend"))
def _spectral_profile_sums(gray: jnp.ndarray, *, n: int, fft_backend: str):
    """(H, W) f32 -> per-radius SUMS of the power spectrum and of the
    log-power cepstrum over the (n, n) padded Hann-windowed frame."""
    h, w = gray.shape
    wy = np.hanning(h).astype(np.float32)
    wx = np.hanning(w).astype(np.float32)
    g = (gray - jnp.mean(gray)) * jnp.asarray(wy)[:, None] * jnp.asarray(
        wx
    )[None, :]
    g = jnp.pad(g, ((0, n - h), (0, n - w)))
    f_re, f_im = fft2d(g, jnp.zeros_like(g), False, fft_backend)
    p = f_re * f_re + f_im * f_im
    lp = jnp.log2(p + jnp.float32(1e-12))
    c_re, _ = fft2d(lp, jnp.zeros_like(lp), True, fft_backend)
    rbin, counts = _radial_bin_map(n)
    seg = jnp.asarray(rbin.reshape(-1))
    nseg = len(counts)
    s_sum = jax.ops.segment_sum(p.reshape(-1), seg, num_segments=nseg)
    c_sum = jax.ops.segment_sum(c_re.reshape(-1), seg, num_segments=nseg)
    return s_sum, c_sum, c_re


def _spectral_profiles(
    gray: np.ndarray, fft_backend: str
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int, np.ndarray]:
    """Radial mean power profile S[rho], radial mean cepstrum c[rho],
    annulus counts, the square pad size n (profiles cut to rho < n//2,
    the clean non-corner range), and the full UNSHIFTED 2D cepstrum
    (for per-direction isotropy checks)."""
    h, w = gray.shape
    n = next_power_of_two(max(h, w))
    s_sum, c_sum, c2d = _spectral_profile_sums(
        jnp.asarray(gray, jnp.float32), n=n, fft_backend=fft_backend
    )
    _, counts = _radial_bin_map(n)
    half = n // 2
    s = np.asarray(s_sum, np.float64)[:half] / counts[:half]
    c = np.asarray(c_sum, np.float64)[:half] / counts[:half]
    return s, c, counts[:half], n, np.asarray(c2d, np.float64)


def _to_gray(img_bgr: np.ndarray, min_dim: int) -> np.ndarray:
    img = np.asarray(img_bgr)
    gray = (
        img.astype(np.float32).mean(axis=-1)
        if img.ndim == 3
        else img.astype(np.float32)
    )
    if min(gray.shape) < min_dim:
        raise ValueError(
            f"image too small for blur estimation (min dim "
            f"{min(gray.shape)} < {min_dim})"
        )
    return gray


# first-zero offset of J1 (3.8317) vs its asymptotic pi spacing shifts
# the cepstral ring slightly inward; measured ratio ring/size = 0.94-0.98
# over sizes 7-41 on blurgen syntheses, median 0.967
_DISK_RING_CAL = 0.967
# sector-isotropy z-scores measured 6.3-52 on blurgen disk syntheses
# (sizes 7-41, two scenes) vs -0.7..1.5 on sharp structured scenes and
# motion-blurred frames (the motion-blurred car fixture reads 5.6 —
# correctly flagged: its blur is linear, not defocus)
_DISK_CONF_WARN = 6.0


def _sector_ring_conf(
    c2d: np.ndarray, n: int, ring_bin: int, r_hi: int, nsec: int = 16
) -> float:
    """Isotropy-robust ring confidence: split the UNSHIFTED 2D cepstrum
    into nsec angular sectors, build each sector's own radial mean
    profile, z-score the dip at ring_bin against that sector's robust
    band statistics, and return the 25th-percentile z — a true defocus
    ring is deep in EVERY direction, while a directional texture or
    motion-blur dip is deep in few, so scene structure cannot fake a
    high confidence."""
    k = np.arange(n)
    signed = np.where(k <= n // 2, k, k - n)
    th = np.arctan2(signed[:, None], signed[None, :]) % (2.0 * np.pi)
    sec = np.minimum(
        (th / (2.0 * np.pi / nsec)).astype(np.int64), nsec - 1
    )
    rbin, _ = _radial_bin_map(n)
    nb = int(rbin.max()) + 1
    comb = (sec * nb + rbin).ravel()
    sums = np.bincount(comb, weights=c2d.ravel(), minlength=nsec * nb)
    cnts = np.bincount(comb, minlength=nsec * nb).astype(np.float64)
    prof = (sums / np.maximum(cnts, 1.0)).reshape(nsec, nb)
    zs = np.empty(nsec)
    for s in range(nsec):
        band = prof[s, 3 : r_hi + 1]
        med = float(np.median(band))
        mad = float(np.median(np.abs(band - med))) + 1e-12
        lo = float(np.min(prof[s, max(ring_bin - 1, 0) : ring_bin + 2]))
        zs[s] = (med - lo) / (1.4826 * mad)
    conf = float(np.percentile(zs, 25))
    return conf if np.isfinite(conf) else 0.0


def estimate_disk_psf(
    img_bgr: np.ndarray,
    *,
    fft_backend: str = DEFAULT_FFT_BACKEND,
    max_size: int | None = None,
) -> tuple[int, float]:
    """Blind defocus-diameter estimation: (size, confidence).

    size feeds straight into --psf-type disk's psf-length positional
    (the disk diameter ops/psf.disk_kernel synthesizes). confidence is
    the sector-isotropy z-score of _sector_ring_conf (warn below
    _DISK_CONF_WARN)."""
    gray = _to_gray(img_bgr, 12)
    h, w = gray.shape
    _, cep, _, n, c2d = _spectral_profiles(gray, fft_backend)
    r_hi = min(min(h, w) // 3, max_size if max_size else 10**9)
    if r_hi <= 4:
        raise ValueError("image too small for disk estimation")
    band = cep[3 : r_hi + 1]
    i = int(np.argmin(band)) + 3
    # parabolic sub-bin refinement
    if 1 <= i < len(cep) - 1:
        y0, y1, y2 = cep[i - 1], cep[i], cep[i + 1]
        den = y0 - 2.0 * y1 + y2
        d = float(np.clip((y0 - y2) / (2.0 * den), -1, 1)) if den else 0.0
    else:
        d = 0.0
    size = max(3, int(round((i + d) / _DISK_RING_CAL)))
    if max_size is not None:
        # max_size bounds the RING search; the /0.967 calibration can
        # push the final size ~3% past it, and callers (serve.py) use
        # it as a hard compile-cache bound — clamp the output too
        size = min(size, max_size)
    conf = _sector_ring_conf(c2d, n, i, r_hi)
    return size, conf


def gaussian_ksize(sigma: float) -> int:
    """Kernel extent covering +-3 sigma (odd), the psf-length the CLI's
    gaussian family pairs with an estimated sigma."""
    return max(3, 2 * int(math.ceil(3.0 * float(sigma))) + 1)


def _huber_fit(
    A: np.ndarray, y: np.ndarray, w0: np.ndarray, iters: int = 4
) -> tuple[np.ndarray, float]:
    """Weighted Huber regression; returns (coef, weighted mean-square
    residual)."""
    w = w0.copy()
    coef, *_ = np.linalg.lstsq(A * w[:, None], y * w, rcond=None)
    for _ in range(iters):
        r = y - A @ coef
        s = 1.4826 * np.median(np.abs(r)) + 1e-12
        hub = np.clip(1.345 * s / np.maximum(np.abs(r), 1e-12), 0.0, 1.0)
        w = w0 * hub
        coef, *_ = np.linalg.lstsq(A * w[:, None], y * w, rcond=None)
    r = y - A @ coef
    return coef, float(np.sum((w * r) ** 2) / np.sum(w * w))


def _gaussian_radial_log_mtf(
    sigma: float, n: int, rbin: np.ndarray, counts_half: np.ndarray
) -> np.ndarray:
    """Radial mean of ln|H|^2 for the TRUNCATED SAMPLED gaussian kernel
    (exactly ops/psf.gaussian_kernel's transfer function — its
    truncation side-lobes decay slower than the continuous gaussian,
    which is why a quadratic fit under-estimates large sigmas).
    Separable: ln|H2(fy, fx)|^2 = lh1[fy] + lh1[fx]."""
    ks = gaussian_ksize(sigma)
    x = np.arange(ks, dtype=np.float64) - (ks // 2)
    a = np.exp(-(x * x) / (2.0 * sigma * sigma))
    a = a / a.sum()
    h1 = np.fft.fft(a, n)
    lh1 = np.log(np.abs(h1) ** 2 + 1e-300)
    lm = lh1[:, None] + lh1[None, :]
    prof = np.bincount(rbin.ravel(), weights=lm.ravel())
    half = n // 2
    return prof[:half] / counts_half


_GAUSS_CONF_WARN = 1.3
_GAUSS_SIGMA_GRID = np.geomspace(0.5, 16.0, 33)


def estimate_gaussian_psf(
    img_bgr: np.ndarray, *, fft_backend: str = DEFAULT_FFT_BACKEND
) -> tuple[float, float]:
    """Blind gaussian-blur sigma estimation: (sigma, confidence).

    Scans sigma candidates, subtracting each one's exact truncated-
    kernel radial log-MTF from the radial log-power profile and scoring
    the power-law fit of the remainder (see the section comment above
    for the method and its physical limits). confidence is the residual
    ratio no-blur/best — near 1 means the frame cannot distinguish
    blur from intrinsically smooth content (warn below
    _GAUSS_CONF_WARN)."""
    gray = _to_gray(img_bgr, 32)
    s, _, counts, n, _ = _spectral_profiles(gray, fft_backend)
    half = n // 2
    rho = np.arange(half, dtype=np.float64)
    floor = float(np.median(s[int(0.85 * half):]))
    t = s - floor
    ok = (t > 3.0 * floor) & (rho >= 3)
    idx = np.where(ok)[0]
    if len(idx) < 10:
        raise ValueError(
            "no usable spectral decay band (flat or floor-dominated "
            "spectrum); cannot estimate a gaussian blur"
        )
    # leading contiguous run (gaps <= 4 merged): the main signal lobe,
    # not isolated high-frequency outliers
    runs = np.split(idx, np.where(np.diff(idx) > 3)[0] + 1)
    band = runs[0]
    for r in runs[1:]:
        if band[-1] + 4 >= r[0]:
            band = np.concatenate([band, r])
    y = np.log(t[band])
    w0 = np.sqrt(counts[band])
    A = np.stack([np.ones(len(band)), np.log(rho[band])], axis=-1)
    _, resid0 = _huber_fit(A, y, w0)
    rbin, _ = _radial_bin_map(n)
    resids = np.empty(len(_GAUSS_SIGMA_GRID))
    for j, sc in enumerate(_GAUSS_SIGMA_GRID):
        mtf = _gaussian_radial_log_mtf(float(sc), n, rbin, counts)
        _, resids[j] = _huber_fit(A, y - mtf[band], w0)
    i = int(np.argmin(resids))
    # parabolic refinement in log-sigma
    if 0 < i < len(_GAUSS_SIGMA_GRID) - 1:
        l0, l1 = np.log(_GAUSS_SIGMA_GRID[i - 1 : i + 1])
        r0, r1, r2 = resids[i - 1 : i + 2]
        den = r0 - 2.0 * r1 + r2
        d = float(np.clip(0.5 * (r0 - r2) / den, -1, 1)) if den else 0.0
        sigma = float(np.exp(l1 + d * (l1 - l0)))
    else:
        sigma = float(_GAUSS_SIGMA_GRID[i])
    conf = float(resid0 / (resids[i] + 1e-30))
    if not np.isfinite(conf):
        conf = 0.0
    return sigma, conf


@jax.jit
def _noise_stats(gray: jnp.ndarray):
    """(H, W) float32 in [0,1] -> (noise sigma, signal variance).

    Immerkaer's fast noise-variance estimator (PRL 1996): the 3x3 mask
    [[1,-2,1],[-2,4,-2],[1,-2,1]] annihilates locally-linear image
    structure, so its response is ~pure noise; for gaussian noise
    sigma = sqrt(pi/2) * mean|I*N| / 6. One shift-stencil pass +
    reductions — a single cheap jit graph, like the cepstral estimator.
    """
    c = gray[1:-1, 1:-1]
    u, d = gray[:-2, 1:-1], gray[2:, 1:-1]
    l, r = gray[1:-1, :-2], gray[1:-1, 2:]
    ul, ur = gray[:-2, :-2], gray[:-2, 2:]
    dl, dr = gray[2:, :-2], gray[2:, 2:]
    lap = 4.0 * c - 2.0 * (u + d + l + r) + (ul + ur + dl + dr)
    sigma = (
        jnp.sqrt(jnp.float32(np.pi / 2.0)) * jnp.mean(jnp.abs(lap)) / 6.0
    )
    return sigma, jnp.var(gray)


def estimate_noise_K(
    img_bgr: np.ndarray, *, k_min: float = 1e-4, k_max: float = 0.5
) -> tuple[float, float]:
    """Noise-adaptive Wiener regularization: estimate the noise sigma
    (Immerkaer) and return (sigma, K) with K = the noise-to-signal
    power ratio sigma^2 / max(var - sigma^2, eps) — the quantity the
    Wiener filter's K term stands in for (the reference hardcodes
    K=0.01, serial.cpp:28). K is clamped to [k_min, k_max] and rounded
    to 2 significant digits (stable co-batch keys in serve.py; the
    filter is insensitive at that granularity).

    Works on uint8 or float BGR/gray frames; the blur itself helps —
    a blurred image has little high-frequency content, so the stencil
    response is dominated by the noise being estimated.
    """
    img = np.asarray(img_bgr)
    gray = (
        img.astype(np.float32).mean(axis=-1) if img.ndim == 3
        else img.astype(np.float32)
    )
    if img.dtype == np.uint8:
        gray = gray / np.float32(255.0)
    if min(gray.shape) < 3:
        raise ValueError(
            f"image too small for noise estimation (min dim "
            f"{min(gray.shape)} < 3)"
        )
    sigma, var = (float(v) for v in _noise_stats(jnp.asarray(gray)))
    k = (sigma * sigma) / max(var - sigma * sigma, 1e-8)
    k = min(max(k, k_min), k_max)
    # 2 significant digits
    from math import floor, log10

    k = round(k, 1 - floor(log10(k)))
    return sigma, float(k)
