"""Blind PSF estimation (cepstral method) vs blurgen ground truth.

The reference has no blur identification at all — the user must know
<psf-length> <psf-angle> (serial.cpp:12-18). models/estimate.py infers
them from the blurred frame.
"""

import numpy as np
import pytest

from fft_restoration_tpu.models.estimate import estimate_motion_psf
from fft_restoration_tpu.utils.blurgen import blur_image


def _scene(rng, h=256, w=320):
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.zeros((h, w, 3), np.float32)
    img[..., 0] = 80 + 100 * np.sin(yy / 17.0) * np.cos(xx / 13.0)
    img[..., 1] = 60 + 0.5 * xx + 30 * np.sin(xx / 7.0)
    img[..., 2] = 70 + 0.5 * yy
    img[60 : h - 56, 100:110] += 120
    img[120:130, 40 : w - 40] += 90
    img = np.clip(img + rng.normal(0, 4, img.shape), 0, 255)
    return img.astype(np.uint8)


def _angle_diff(a, b):
    """Distance between angles defined mod 180 degrees."""
    d = abs((a - b) % 180.0)
    return min(d, 180.0 - d)


@pytest.mark.parametrize(
    "true_len,true_ang",
    [(21, 30.0), (35, 0.0), (15, 75.0), (41, 120.0), (25, -45.0)],
)
def test_estimate_recovers_blur_params(rng, true_len, true_ang):
    blurred = blur_image(_scene(rng), true_len, true_ang)
    length, angle, conf = estimate_motion_psf(blurred)
    assert abs(length - true_len) <= 2, (length, true_len)
    assert _angle_diff(angle, true_ang) <= 3.0, (angle, true_ang)
    # long oblique blurs spread the cepstral peak: (41, 120deg)
    # measures z=13.4 — correct estimate, confidence near _CONF_WARN
    assert conf > 12.0, conf


def test_estimate_angle_is_cli_convention(rng):
    """The returned angle must feed straight back into the restoration:
    blind restore (estimated params) lands within 1 dB of the
    known-PSF restore."""
    from fft_restoration_tpu.models.pipeline import WienerDeblurPipeline
    from fft_restoration_tpu.utils.verify import psnr

    sharp = _scene(rng)
    blurred = blur_image(sharp, 21, 30.0)
    length, angle, _ = estimate_motion_psf(blurred)
    pipe = WienerDeblurPipeline(fft_backend="matmul")
    known = pipe.restore(blurred, 21, 30.0)
    blind = pipe.restore(blurred, length, angle)
    s = sharp.astype(np.float64)
    p_known = psnr(s, known.astype(np.float64), peak=255.0)
    p_blind = psnr(s, blind.astype(np.float64), peak=255.0)
    assert p_blind > p_known - 1.0, (p_known, p_blind)


def test_estimate_cli_blind_mode(tmp_path, rng):
    """--estimate-psf end to end: the positionals are overridden and the
    restoration runs with the estimated parameters."""
    from fft_restoration_tpu.cli import main
    from fft_restoration_tpu.utils.imageio import imwrite

    blurred = blur_image(_scene(rng, 128, 160), 17, 60.0)
    src = tmp_path / "in.png"
    imwrite(str(src), blurred)
    dst = tmp_path / "out.png"
    # deliberately wrong positionals - the estimate must override them
    rc = main(
        [str(src), "3", "0", "--mode", "jit", "--estimate-psf",
         "-o", str(dst)]
    )
    assert rc == 0 and dst.exists()


def test_estimate_confidence_separates_sharp():
    """The z-score confidence flags frames with no linear blur: a sharp
    structured scene scores below _CONF_WARN, its blurred version far
    above (measured ~10 vs 18-69; fixtures 50-55)."""
    from fft_restoration_tpu.models.estimate import _CONF_WARN

    # a fixed scene: the shared session rng's state depends on which
    # tests ran before this one, and the sharp score moves with the noise
    sharp = _scene(np.random.default_rng(0))
    _, _, c_sharp = estimate_motion_psf(sharp)
    _, _, c_blur = estimate_motion_psf(blur_image(sharp, 25, 60.0))
    assert c_sharp < _CONF_WARN < c_blur, (c_sharp, c_blur)


def test_estimate_rejects_tiny_images():
    """min dim < 12 would make the cepstral annulus empty (argmin
    garbage, NaN confidence): contract error instead."""
    import pytest as _pytest

    with _pytest.raises(ValueError, match="too small"):
        estimate_motion_psf(np.zeros((6, 512, 3), np.uint8))


def test_cli_rejects_bad_iters(tmp_path, rng):
    from fft_restoration_tpu.cli import main
    from fft_restoration_tpu.utils.imageio import imwrite

    src = tmp_path / "in.png"
    imwrite(str(src), (rng.random((32, 32, 3)) * 255).astype(np.uint8))
    assert main([str(src), "5", "30", "--filter", "rl", "--iters", "0"]) == 2
    assert main([str(src), "0", "30"]) == 2


def test_estimate_cli_directory_mode(tmp_path, rng):
    """Directory input estimates from the first frame and applies the
    parameters to the whole batch."""
    from fft_restoration_tpu.cli import main
    from fft_restoration_tpu.utils.imageio import imwrite

    d = tmp_path / "frames"
    d.mkdir()
    scene = _scene(rng, 96, 128)
    for i in range(2):
        imwrite(str(d / f"f{i}.png"), blur_image(scene, 13, 45.0))
    out = tmp_path / "out"
    rc = main(
        [str(d), "3", "0", "--estimate-psf", "-o", str(out)]
    )
    assert rc == 0
    assert sorted(p.name for p in out.iterdir()) == [
        "f0_restored.png", "f1_restored.png"
    ]


def _rect_scene(h=256, w=320, seed=7):
    """Natural-statistics scene (random rectangles over a gradient):
    its radial spectrum follows the power-law prior the gaussian
    estimator fits, unlike _scene's pure sinusoids whose discrete
    spectral peaks are adversarial for any smooth spectral model."""
    r = np.random.default_rng(seed)
    img = np.zeros((h, w, 3), np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    img += (0.3 * xx / w + 0.2 * yy / h)[..., None]
    for _ in range(60):
        y0, x0 = r.integers(0, h - 8), r.integers(0, w - 8)
        hh, ww = r.integers(8, h // 3), r.integers(8, w // 3)
        img[y0 : y0 + hh, x0 : x0 + ww] += r.uniform(
            -0.4, 0.4, 3
        ).astype(np.float32)
    img += r.normal(0, 0.02, img.shape).astype(np.float32)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


@pytest.mark.parametrize("true_size", [7, 11, 15])
def test_estimate_disk_recovers_size(true_size):
    """Cepstral-ring defocus identification: exact size recovery on
    blurgen disk syntheses (measured exact at 7-41 over multiple
    scenes), with the sector-isotropy confidence above the warn line."""
    from fft_restoration_tpu.models.estimate import (
        _DISK_CONF_WARN,
        estimate_disk_psf,
    )

    blurred = blur_image(_rect_scene(), true_size, 0.0, psf_type="disk")
    size, conf = estimate_disk_psf(blurred)
    assert abs(size - true_size) <= 1, (size, true_size)
    assert conf > _DISK_CONF_WARN, conf


def test_estimate_disk_confidence_separates_sharp():
    """The sector-isotropy z-score flags frames with no defocus ring: a
    sharp scene measures ~1, a motion-blurred frame ~0 (directional
    dip), a disk-blurred one 10+."""
    from fft_restoration_tpu.models.estimate import (
        _DISK_CONF_WARN,
        estimate_disk_psf,
    )

    scene = _rect_scene()
    _, c_sharp = estimate_disk_psf(scene)
    _, c_motion = estimate_disk_psf(blur_image(scene, 15, 30.0))
    _, c_disk = estimate_disk_psf(
        blur_image(scene, 11, 0.0, psf_type="disk")
    )
    assert c_sharp < _DISK_CONF_WARN < c_disk, (c_sharp, c_disk)
    assert c_motion < _DISK_CONF_WARN, c_motion


@pytest.mark.parametrize("true_sigma", [1.5, 2.5, 4.0])
def test_estimate_gaussian_recovers_sigma(true_sigma):
    """Spectral log-MTF scan: sigma within 20% on power-law scenes
    (measured 1-6% over three seeds), confidence well above the
    ambiguity line."""
    from fft_restoration_tpu.models.estimate import (
        _GAUSS_CONF_WARN,
        estimate_gaussian_psf,
        gaussian_ksize,
    )

    blurred = blur_image(
        _rect_scene(), gaussian_ksize(true_sigma), true_sigma,
        psf_type="gaussian",
    )
    sigma, conf = estimate_gaussian_psf(blurred)
    assert abs(sigma - true_sigma) / true_sigma < 0.2, (sigma, true_sigma)
    assert conf > 2.0 > _GAUSS_CONF_WARN, conf


def test_estimate_gaussian_sharp_is_ambiguous():
    """A sharp power-law scene cannot be distinguished from a barely
    blurred one — the residual-ratio confidence stays near 1 (the
    documented physical limit), under the warn line."""
    from fft_restoration_tpu.models.estimate import (
        _GAUSS_CONF_WARN,
        estimate_gaussian_psf,
    )

    _, conf = estimate_gaussian_psf(_rect_scene())
    assert conf < _GAUSS_CONF_WARN, conf


def test_estimate_cli_disk_and_gaussian(tmp_path, capsys):
    """--estimate-psf composes with --psf-type disk|gaussian end to
    end (the round-3 contract error, now a working estimate)."""
    from fft_restoration_tpu.cli import main
    from fft_restoration_tpu.utils.imageio import imwrite

    scene = _rect_scene(160, 192)
    src_d = tmp_path / "disk.png"
    imwrite(str(src_d), blur_image(scene, 9, 0.0, psf_type="disk"))
    rc = main(
        [str(src_d), "3", "0", "--psf-type", "disk", "--estimate-psf",
         "-o", str(tmp_path / "od.png")]
    )
    out = capsys.readouterr().out
    assert rc == 0 and (tmp_path / "od.png").exists()
    assert "estimated PSF: disk size=9" in out

    src_g = tmp_path / "gauss.png"
    imwrite(
        str(src_g), blur_image(scene, 11, 1.8, psf_type="gaussian")
    )
    rc = main(
        [str(src_g), "3", "0", "--psf-type", "gaussian",
         "--estimate-psf", "-o", str(tmp_path / "og.png")]
    )
    out = capsys.readouterr().out
    assert rc == 0 and (tmp_path / "og.png").exists()
    assert "estimated PSF: gaussian sigma=" in out


def test_noise_K_estimation_accuracy(rng):
    """Immerkaer sigma within ~15% of truth on a smooth scene, and K
    monotone in the noise level (the auto-K contract)."""
    from fft_restoration_tpu.models.estimate import estimate_noise_K

    h, w = 256, 320
    base = np.linspace(0.2, 0.8, w, dtype=np.float32)[None, :].repeat(h, 0)
    ks = []
    for true_sigma in (0.005, 0.02, 0.05):
        noisy = np.clip(base + rng.normal(0, true_sigma, (h, w)), 0, 1)
        frame = (noisy[..., None].repeat(3, -1) * 255).astype(np.uint8)
        sigma, k = estimate_noise_K(frame)
        assert abs(sigma - true_sigma) / true_sigma < 0.15, (
            sigma, true_sigma,
        )
        ks.append(k)
    assert ks[0] < ks[1] < ks[2], ks
    # clamp floor on a noise-free frame
    _, k0 = estimate_noise_K((base * 255).astype(np.uint8)[..., None])
    assert k0 == pytest.approx(1e-4)
    with pytest.raises(ValueError, match="too small"):
        estimate_noise_K(np.zeros((2, 2), np.uint8))


def test_cli_auto_K(tmp_path, rng, capsys):
    """--auto-K end to end: single frame (verification runs at the
    estimated K) and directory mode (one estimate per size-group)."""
    from fft_restoration_tpu.cli import main
    from fft_restoration_tpu.utils.imageio import imwrite

    scene = blur_image(_scene(rng, 96, 128), 9, 30.0)
    noisy = np.clip(
        scene.astype(np.float32) + rng.normal(0, 5.0, scene.shape), 0, 255
    ).astype(np.uint8)
    src = tmp_path / "in.png"
    imwrite(str(src), noisy)
    rc = main([str(src), "9", "30", "--auto-K", "-o", str(tmp_path / "o.png")])
    out = capsys.readouterr().out
    assert rc == 0
    assert "[INFO] auto-K" in out and "[Success]" in out

    d = tmp_path / "frames"
    d.mkdir()
    for i in range(2):
        imwrite(str(d / f"f{i}.png"), noisy)
    rc = main([str(d), "9", "30", "--auto-K", "-o", str(tmp_path / "outd")])
    out = capsys.readouterr().out
    assert rc == 0
    assert "[INFO] auto-K[128x96]" in out


def test_disk_estimate_respects_max_size():
    # max_size is a hard bound callers (serve.py) rely on for the
    # compile cache; the ring calibration must not push size past it.
    from fft_restoration_tpu.models.estimate import estimate_disk_psf

    blurred = blur_image(_rect_scene(), 25, 0.0, psf_type="disk")
    size, _ = estimate_disk_psf(blurred, max_size=20)
    assert size <= 20
