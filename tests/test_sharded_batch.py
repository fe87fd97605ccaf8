"""2D (batch × rows) mesh batch path — full capability coverage.

RL, edge tapering, and per-frame Lab white balance all run ON the mesh
in the batched directory path (the reference's contract is every
capability × every mode by construction, reference fft/fft.hpp:9-92).
Parity is against the single-device jit batched pipeline, which itself
verifies against the oracle.
"""

import numpy as np
import pytest

from fft_restoration_tpu.models.batched import BatchedWienerPipeline
from fft_restoration_tpu.oracle.psf import make_psf_oracle
from fft_restoration_tpu.parallel.mesh import make_mesh2d
from fft_restoration_tpu.parallel.sharded_pipeline import (
    sharded_batched_restore_images,
    sharded_batched_restore_planes,
)


def _stack(rng, b=3, h=40, w=56):
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.zeros((h, w, 3), np.float32)
    base[..., 0] = 90 + 80 * np.sin(yy / 5.0)
    base[..., 1] = 60 + 2.0 * xx
    base[..., 2] = 70 + 1.5 * yy
    frames = [
        np.clip(base + rng.normal(0, 6, base.shape) + 10 * i, 0, 255)
        for i in range(b)
    ]
    return np.stack(frames).astype(np.uint8)


def test_sharded_batched_images_matches_jit_wb(rng):
    """Device-WB sharded batch (one jit dispatch) vs the jit batched
    pipeline: <=1 uint8 count."""
    stack = _stack(rng)
    psf = make_psf_oracle("motion", 5, 30.0)
    a = sharded_batched_restore_images(
        stack, psf, 0.01, mesh=make_mesh2d(2, 4), fft_backend="matmul"
    )
    b = BatchedWienerPipeline(fft_backend="matmul").restore(
        stack, 5, 30.0, 0.01
    )
    assert a.shape == stack.shape and a.dtype == np.uint8
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_sharded_batched_edgetaper_matches_jit(rng):
    stack = _stack(rng)
    psf = make_psf_oracle("motion", 5, 30.0)
    a = sharded_batched_restore_images(
        stack, psf, 0.01, mesh=make_mesh2d(2, 4), fft_backend="matmul",
        edgetaper=True,
    )
    b = BatchedWienerPipeline(fft_backend="matmul", edgetaper=True).restore(
        stack, 5, 30.0, 0.01
    )
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 2


def test_sharded_batched_rl_matches_jit(rng):
    stack = _stack(rng, b=2)
    psf = make_psf_oracle("disk", 5, 0.0)
    a = sharded_batched_restore_images(
        stack, psf, 0.01, mesh=make_mesh2d(2, 4), fft_backend="matmul",
        filter_name="rl", rl_iters=8, white_balance=False,
    )
    b = BatchedWienerPipeline(
        fft_backend="matmul", filter_name="rl", rl_iters=8,
        white_balance=False, psf_type="disk",
    ).restore(stack, 5, 0.0, 0.01)
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 2


def test_sharded_batched_raw_planes_match_single_chip(rng):
    """normalize=False returns RAW unscaled-inverse planes matching
    models/pipeline.restore_planes(normalize=False) — the tiled×mesh
    contract (same-extent raw tiles are directly stitchable)."""
    import jax.numpy as jnp

    from fft_restoration_tpu.models.pipeline import restore_planes

    chans = rng.random((2, 3, 32, 32)).astype(np.float32)
    psf = make_psf_oracle("motion", 5, 30.0)
    raw_sharded = sharded_batched_restore_planes(
        chans, psf, 0.01, mesh=make_mesh2d(2, 4), fft_backend="matmul",
        normalize=False,
    )
    raw_single = np.stack(
        [
            np.asarray(
                restore_planes(
                    jnp.asarray(c), jnp.asarray(psf), jnp.float32(0.01),
                    fft_backend="matmul", normalize=False,
                )
            )
            for c in chans
        ]
    )
    scale = max(np.abs(raw_single).max(), 1.0)
    assert np.abs(raw_sharded - raw_single).max() / scale < 1e-5


def test_cli_batch_sharded_rl_and_taper(tmp_path):
    """Directory + --mode sharded accepts --filter rl and --edgetaper
    (the two round-3 [Error] exits are gone) and matches jit outputs."""
    import subprocess
    import sys

    from fft_restoration_tpu.utils.imageio import imread, imwrite

    rng = np.random.default_rng(7)
    d = tmp_path / "frames"
    d.mkdir()
    for i in range(2):
        imwrite(
            str(d / f"f{i}.png"),
            (rng.random((24, 24, 3)) * 255).astype(np.uint8),
        )

    def run(extra, out):
        return subprocess.run(
            [sys.executable, "-m", "fft_restoration_tpu", str(d), "3",
             "30", "-o", str(out)] + extra,
            capture_output=True, text=True,
        )

    for extra in (["--edgetaper"], ["--filter", "rl", "--iters", "4"]):
        out_s = tmp_path / ("s" + extra[0][2:4])
        out_j = tmp_path / ("j" + extra[0][2:4])
        r = run(extra + ["--mode", "sharded", "--devices", "4"], out_s)
        assert r.returncode == 0, r.stdout + r.stderr
        assert "Restored 2 frames" in r.stdout
        r = run(extra, out_j)
        assert r.returncode == 0, r.stdout + r.stderr
        for i in range(2):
            a = imread(str(out_s / f"f{i}_restored.png"))
            b = imread(str(out_j / f"f{i}_restored.png"))
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 2, extra
