"""Blurred test-input generator — the fixture factory.

Counterpart of the reference's others/gen_blurred_img.ipynb (cell 1,
SURVEY.md §3.5): synthesize a motion-blurred image from a sharp one by
frequency-domain convolution with a known PSF — the forward problem the
Wiener pipeline inverts. The notebook's recipe is preserved: build the
centered PSF, roll it to the corner, multiply spectra, clip to uint8.

Runs on the host in NumPy float64 (fixture generation is offline; exact
reproducibility beats speed here).
"""

from __future__ import annotations

import numpy as np

from fft_restoration_tpu.oracle.psf import make_psf_oracle


def blur_image(
    img_bgr: np.ndarray, psf_length: int, psf_angle: float,
    psf_type: str = "motion",
) -> np.ndarray:
    """uint8 BGR (H, W, 3) -> blurred uint8 BGR (psf_type: 'motion'
    default, 'gaussian' with psf_angle as sigma, 'disk' defocus).

    Per channel: zero-pad the PSF to the image size with its center at
    the image center, np.roll it to the corner (so the convolution is
    shift-free), multiply spectra, inverse transform, clip to [0, 255].
    """
    img = np.asarray(img_bgr, np.float64)
    h, w = img.shape[:2]
    psf = make_psf_oracle(psf_type, psf_length, psf_angle).astype(np.float64)
    # normalize so the blur preserves brightness (the notebook's PSF is
    # sum-normalized before convolution)
    s = psf.sum()
    if s != 0:
        psf = psf / s
    psf_full = np.zeros((h, w))
    cy, cx = psf.shape[0] // 2, psf.shape[1] // 2
    top, left = h // 2 - cy, w // 2 - cx
    psf_full[top : top + psf.shape[0], left : left + psf.shape[1]] = psf
    psf_corner = np.roll(psf_full, (-(h // 2), -(w // 2)), axis=(0, 1))
    H = np.fft.fft2(psf_corner)

    out = np.empty_like(img)
    for c in range(img.shape[2]):
        spec = np.fft.fft2(img[..., c]) * H
        out[..., c] = np.real(np.fft.ifft2(spec))
    return np.clip(out, 0, 255).astype(np.uint8)


def synthetic_scene(h: int, w: int, seed: int = 0) -> np.ndarray:
    """Sharp uint8 BGR (h, w, 3) test scene made from a seed: smooth
    colour gradients, a low-frequency wave field, flat-coloured
    rectangles and discs with hard edges, a fine stripe patch and mild
    sensor noise — the mix of edges and texture a motion-blur restore
    has to bring back. Deterministic for a given (h, w, seed)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    u, v = xx / max(w - 1, 1), yy / max(h - 1, 1)
    img = np.empty((h, w, 3))
    for c in range(3):
        a, b, f1, f2 = rng.uniform(-1, 1, 4)
        img[..., c] = (
            110 + 60 * a * u + 60 * b * v
            + 25 * np.sin(2 * np.pi * (1 + 3 * abs(f1)) * u + 6 * f2)
            * np.cos(2 * np.pi * (1 + 2 * abs(f2)) * v)
        )
    side = min(h, w)
    for _ in range(14):
        color = rng.uniform(0, 255, 3)
        y0, x0 = rng.uniform(0, h), rng.uniform(0, w)
        r = rng.uniform(0.03, 0.18) * side
        if rng.random() < 0.5:
            m = (abs(yy - y0) < r) & (abs(xx - x0) < r * rng.uniform(0.5, 2))
        else:
            m = (yy - y0) ** 2 + (xx - x0) ** 2 < r * r
        img[m] = color
    # fine stripes: high-frequency detail the blur wipes out
    sy, sx = int(0.6 * h), int(0.1 * w)
    patch = img[sy : sy + h // 5, sx : sx + w // 4]
    patch[..., :] = np.where(
        (np.arange(patch.shape[1]) // 3) % 2, 230.0, 30.0
    )[None, :, None]
    img += rng.normal(0.0, 2.0, img.shape)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def blurred_scene(
    h: int, w: int, psf_length: int, psf_angle: float, seed: int = 0
) -> np.ndarray:
    """synthetic_scene(h, w, seed) motion-blurred with PSF(length, angle):
    the seed-generated stand-in for a blurred photo."""
    return blur_image(synthetic_scene(h, w, seed), psf_length, psf_angle)


def make_fixture(
    src_path: str, dst_path: str, psf_length: int, psf_angle: float
) -> None:
    """Read a sharp PNG, write its blurred counterpart."""
    from fft_restoration_tpu.utils.imageio import imread, imwrite

    imwrite(dst_path, blur_image(imread(src_path), psf_length, psf_angle))
