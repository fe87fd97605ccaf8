"""Tiled restoration (models/tiled.py): bounded-memory restore of
arbitrarily large frames, verified against the global pipeline.

The tiled output is approximate by construction (tile-local
deconvolution; see the module docstring), so the contract is
structural agreement with the global edge-tapered restore after a
per-channel affine alignment (the two paths stretch over different
extents — live frame vs padded plane — so a global gain/offset is
expected and removed before comparing).
"""

import numpy as np
import pytest

from fft_restoration_tpu.models.tiled import tile_grid, tiled_restore_image
from fft_restoration_tpu.utils.blurgen import blur_image
from fft_restoration_tpu.utils.verify import psnr


def _scene(rng, h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.zeros((h, w, 3), np.float32)
    img[..., 0] = 80 + 100 * np.sin(yy / 17.0) * np.cos(xx / 13.0)
    img[..., 1] = 60 + 0.5 * xx + 30 * np.sin(xx / 7.0)
    img[..., 2] = 70 + 0.5 * yy
    img[60 : h - 60, 100:110] += 120
    img[120:130, 40 : w - 40] += 90
    return np.clip(img + rng.normal(0, 3, img.shape), 0, 255).astype(
        np.uint8
    )


def _affine_align(a, b):
    out = np.empty_like(b)
    for c in range(3):
        x, y = b[..., c].ravel(), a[..., c].ravel()
        A = np.vstack([x, np.ones_like(x)]).T
        coef, *_ = np.linalg.lstsq(A, y, rcond=None)
        out[..., c] = b[..., c] * coef[0] + coef[1]
    return out


def test_tile_grid_covers_exactly():
    for extent, tile, ov in ((200, 128, 28), (1030, 1024, 32), (96, 128, 16)):
        core = tile - 2 * ov
        starts, cores = tile_grid(extent, tile, core, ov)
        # cores partition [0, extent)
        assert cores[0][0] == 0 and cores[-1][1] == extent
        for (a0, a1), (b0, b1) in zip(cores, cores[1:]):
            assert a1 == b0
        # every tile read stays inside the image and contains its core
        for t0, (c0, c1) in zip(starts, cores):
            assert 0 <= t0 and t0 + min(tile, extent) <= extent or extent <= tile
            assert t0 <= c0 and c1 <= t0 + tile


def test_clamped_grid_covers_with_uniform_cores():
    from fft_restoration_tpu.models.tiled import clamped_grid

    for extent, tile, ov in ((200, 128, 28), (1030, 1024, 32), (500, 256, 40)):
        core = tile - 2 * ov
        starts, cstarts = clamped_grid(extent, tile, core, ov)
        covered = np.zeros(extent, bool)
        for c0 in cstarts:
            assert 0 <= c0 <= extent - core
            covered[c0 : c0 + core] = True
        assert covered.all()
        for t0, c0 in zip(starts, cstarts):
            assert 0 <= t0 <= extent - tile
            assert t0 <= c0 and c0 + core <= t0 + tile


def test_device_and_host_stitch_agree(rng):
    """The device-resident path (dynamic_slice gather + resident stitch
    + on-device WB) matches the host-stitch path to 1 uint8 count —
    they differ only in the clamped-core overwrite bands and float
    summation order."""
    img = blur_image(_scene(rng, 200, 264), 7, 30.0)
    a = tiled_restore_image(
        img, 7, 30.0, tile=128, overlap=32, fft_backend="matmul",
        device_stitch=True,
    )
    b = tiled_restore_image(
        img, 7, 30.0, tile=128, overlap=32, fft_backend="matmul",
        device_stitch=False,
    )
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_tiled_matches_global_after_alignment(rng):
    h, w, S = 280, 360, 7
    from fft_restoration_tpu.models.pipeline import WienerDeblurPipeline

    blurred = blur_image(_scene(rng, h, w), S, 30.0)
    glob = (
        WienerDeblurPipeline(fft_backend="matmul", edgetaper=True)
        .restore(blurred, S, 30.0)
        .astype(np.float64)
    )
    t = tiled_restore_image(
        blurred, S, 30.0, tile=128, overlap=32, chunk=4,
        fft_backend="matmul",
    )
    assert t.shape == blurred.shape and t.dtype == np.uint8
    d = psnr(glob, _affine_align(glob, t.astype(np.float64)), peak=255.0)
    # measured 29.4 dB on the CPU backend; the global taper-on/off spread
    # is 20.7 dB, so >26 means tiled sits well inside the family
    assert d > 26.0, d


def test_tiled_single_tile_small_image(rng):
    """Frames smaller than one tile take the single-tile path (zero-pad
    + live-extent taper) and still restore."""
    img = blur_image(_scene(rng, 150, 200), 7, 30.0)
    t = tiled_restore_image(
        img, 7, 30.0, tile=256, overlap=32, fft_backend="matmul"
    )
    assert t.shape == (150, 200, 3)


def test_tiled_validation_errors(rng):
    img = blur_image(_scene(rng, 150, 200), 7, 30.0)
    with pytest.raises(ValueError, match="power of two"):
        tiled_restore_image(img, 7, 30.0, tile=100)
    with pytest.raises(ValueError, match="core"):
        tiled_restore_image(img, 7, 30.0, tile=64, overlap=30)
    with pytest.raises(ValueError, match="DFT extent"):
        tiled_restore_image(img, 300, 30.0, tile=256, overlap=8)


def test_cli_tile_mode(tmp_path, rng, capsys):
    from fft_restoration_tpu.cli import main
    from fft_restoration_tpu.utils.imageio import imwrite

    src = tmp_path / "in.png"
    imwrite(str(src), blur_image(_scene(rng, 200, 264), 7, 30.0))
    rc = main(
        [str(src), "7", "30", "--tile", "128", "--tile-overlap", "32",
         "--fft-backend", "matmul", "-o", str(tmp_path / "out.png")]
    )
    out = capsys.readouterr().out
    assert rc == 0
    assert "took(tiled)" in out and "overlap-discard" in out
    # per-tile oracle anchor: the center tile verifies
    # against the serial oracle at the tile extent, gpu tier
    assert "per-tile oracle anchor" in out and "[Success]" in out
    assert (tmp_path / "out.png").exists()
    # tiled x mesh composes (round 4): same frame through the 2D
    # (batch, rows) mesh matches the jit tiled restore
    rc = main(
        [str(src), "7", "30", "--tile", "128", "--tile-overlap", "32",
         "--fft-backend", "matmul", "--mode", "sharded", "--devices",
         "4", "-o", str(tmp_path / "out_sharded.png")]
    )
    out = capsys.readouterr().out
    assert rc == 0
    assert "took(tiled-sharded)" in out
    from fft_restoration_tpu.utils.imageio import imread

    a = imread(str(tmp_path / "out.png"))
    b = imread(str(tmp_path / "out_sharded.png"))
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 2
    # oracle mode has no tiled counterpart
    rc = main([str(src), "7", "30", "--tile", "128", "--mode", "oracle"])
    assert rc == 2


def test_cli_tile_directory_mode(tmp_path, rng):
    """--tile with a directory restores every frame per-frame (sizes
    need not match) and respects --auto-K."""
    from fft_restoration_tpu.cli import main
    from fft_restoration_tpu.utils.imageio import imwrite

    d = tmp_path / "frames"
    d.mkdir()
    imwrite(str(d / "a.png"), blur_image(_scene(rng, 150, 200), 7, 30.0))
    imwrite(str(d / "b.png"), blur_image(_scene(rng, 180, 140), 7, 30.0))
    out = tmp_path / "out"
    rc = main(
        [str(d), "7", "30", "--tile", "128", "--tile-overlap", "28",
         "--auto-K", "--fft-backend", "matmul", "-o", str(out)]
    )
    assert rc == 0
    assert sorted(p.name for p in out.iterdir()) == [
        "a_restored.png", "b_restored.png"
    ]


def test_tiled_xla_matches_matmul(rng):
    """The xla tile path (loop-invariant PSF transform hoisted by XLA)
    agrees with the matmul tile path."""
    img = blur_image(_scene(rng, 140, 200), 7, 30.0)
    a = tiled_restore_image(
        img, 7, 30.0, tile=128, overlap=28, fft_backend="xla"
    )
    b = tiled_restore_image(
        img, 7, 30.0, tile=128, overlap=28, fft_backend="matmul"
    )
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 2


def test_tiled_negative_overlap_and_batch_validation(tmp_path, rng):
    from fft_restoration_tpu.cli import main
    from fft_restoration_tpu.utils.imageio import imwrite

    img = blur_image(_scene(rng, 150, 200), 7, 30.0)
    with pytest.raises(ValueError, match=">= 0"):
        tiled_restore_image(img, 7, 30.0, tile=128, overlap=-16)
    # directory config error fails ONCE with exit code 2
    d = tmp_path / "frames"
    d.mkdir()
    imwrite(str(d / "a.png"), img)
    rc = main([str(d), "7", "30", "--tile", "100", "-o", str(tmp_path / "o")])
    assert rc == 2


def test_device_fn_cache_reuses_array_kernels(rng):
    """--psf-file kernels key the device-fn cache by bytes: a directory
    of same-shape frames reuses one compiled graph per kernel."""
    from fft_restoration_tpu.models.tiled import _DEVICE_FN_CACHE
    from fft_restoration_tpu.oracle.psf import gaussian_kernel_oracle

    _DEVICE_FN_CACHE.clear()
    img = blur_image(_scene(rng, 150, 200), 7, 1.7, psf_type="gaussian")
    k = gaussian_kernel_oracle(7, 1.7)
    tiled_restore_image(img, 7, 0.0, tile=128, psf_type=k,
                        fft_backend="matmul")
    assert len(_DEVICE_FN_CACHE) == 1
    tiled_restore_image(img, 7, 0.0, tile=128, psf_type=k.copy(),
                        fft_backend="matmul")
    assert len(_DEVICE_FN_CACHE) == 1  # same bytes -> same entry


def test_tiled_rl_matches_untiled(rng):
    """RL through the tiled path: clipped flux-calibrated tiles are
    stitched as-is (no global stretch) and match the UNTILED RL
    pipeline to ~1 uint8 count on a frame small enough to run both
    (the tiling contract; RL's deblur quality itself is covered by
    tests/test_richardson_lucy.py with the shift-free kernel)."""
    from fft_restoration_tpu.models.pipeline import WienerDeblurPipeline

    h, w, S = 150, 200, 5
    sharp = np.zeros((h, w, 3), np.uint8)
    sharp[40:110, 60:70] = 255
    sharp[70:80, 30:170] = 200
    blurred = blur_image(sharp, S, 0.0, psf_type="disk")
    t = tiled_restore_image(
        blurred, S, 0.0, tile=128, overlap=28, fft_backend="matmul",
        filter_name="rl", rl_iters=15, psf_type="disk",
        white_balance=False,
    )
    g = WienerDeblurPipeline(
        fft_backend="matmul", filter_name="rl", rl_iters=15,
        psf_type="disk", white_balance=False,
    ).restore(blurred, S, 0.0)
    assert np.abs(t.astype(int) - g.astype(int)).max() <= 2


def test_tiled_sharded_matches_jit_host_stitch(rng):
    """tiled x mesh: the tile stack dispatched through
    the 2D (batch, rows) mesh — per-tile taper + RAW restore inside
    shard_map, host stitch, one global normalize/WB — matches the jit
    host-stitch tiled restore to <=2 uint8 counts (same grid, same
    taper math; only the schedule is distributed)."""
    from fft_restoration_tpu.parallel.mesh import make_mesh2d

    img = blur_image(_scene(rng, 200, 264), 7, 30.0)
    a = tiled_restore_image(
        img, 7, 30.0, tile=128, overlap=32, chunk=4,
        fft_backend="matmul", mesh=make_mesh2d(2, 4),
    )
    b = tiled_restore_image(
        img, 7, 30.0, tile=128, overlap=32, chunk=4,
        fft_backend="matmul", device_stitch=False,
    )
    assert a.shape == img.shape and a.dtype == np.uint8
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 2


def test_tiled_sharded_rl(rng):
    """RL tiles ride the mesh too (clipped flux-calibrated stitch)."""
    from fft_restoration_tpu.parallel.mesh import make_mesh2d

    h, w, S = 150, 200, 5
    sharp = np.zeros((h, w, 3), np.uint8)
    sharp[40:110, 60:70] = 255
    blurred = blur_image(sharp, S, 0.0, psf_type="disk")
    a = tiled_restore_image(
        blurred, S, 0.0, tile=128, overlap=28, fft_backend="matmul",
        filter_name="rl", rl_iters=8, psf_type="disk",
        white_balance=False, mesh=make_mesh2d(2, 4),
    )
    b = tiled_restore_image(
        blurred, S, 0.0, tile=128, overlap=28, fft_backend="matmul",
        filter_name="rl", rl_iters=8, psf_type="disk",
        white_balance=False, device_stitch=False,
    )
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 2
