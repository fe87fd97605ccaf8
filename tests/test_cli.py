"""CLI driver smoke tests (subprocess, CPU-forced)."""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, timeout=600):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    ).strip()
    return subprocess.run(
        [sys.executable, "-m", "fft_restoration_tpu", *args],
        capture_output=True,
        text=True,
        cwd=REPO,
        env=env,
        timeout=timeout,
    )


@pytest.fixture(scope="module")
def small_png(tmp_path_factory, rng=None):
    from fft_restoration_tpu.utils.imageio import imwrite

    rng = np.random.default_rng(7)
    p = tmp_path_factory.mktemp("cli") / "small.png"
    imwrite(str(p), (rng.random((32, 40, 3)) * 255).astype(np.uint8))
    return str(p)


def test_cli_jit_mode(small_png, tmp_path):
    out = str(tmp_path / "out.png")
    r = _run([small_png, "5", "30", "--mode", "jit", "-o", out])
    assert r.returncode == 0, r.stdout + r.stderr
    assert "[Success]" in r.stdout
    assert "[Speedup]" in r.stdout
    assert os.path.exists(out)


def test_cli_strict_tier(small_png, tmp_path):
    """The strict inf tier passes on the default (xla) backend."""
    out = str(tmp_path / "out.png")
    r = _run(
        [small_png, "5", "30", "--mode", "jit", "--tier", "inf", "-o", out]
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert "[Success]" in r.stdout


def test_cli_sharded_mode(small_png, tmp_path):
    out = str(tmp_path / "out.png")
    r = _run(
        [small_png, "5", "30", "--mode", "sharded", "--devices", "4", "-o", out]
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert "[Success]" in r.stdout


def test_cli_oracle_mode(small_png, tmp_path):
    out = str(tmp_path / "out.png")
    r = _run([small_png, "5", "30", "--mode", "oracle", "-o", out])
    assert r.returncode == 0, r.stdout + r.stderr
    assert "took(oracle)" in r.stdout


def test_cli_profile_prints_phase_table(small_png, tmp_path):
    r = _run(
        [small_png, "5", "30", "--mode", "jit", "--profile",
         "-o", str(tmp_path / "o.png")]
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert "Accumulated Time" in r.stdout
    assert "jit: FFT Image" in r.stdout


def test_cli_bad_psf_length(small_png):
    r = _run([small_png, "0", "30"])
    assert r.returncode == 2
    assert "[Error]" in r.stdout


def test_cli_missing_file():
    r = _run(["/nonexistent_image.png", "5", "30"])
    assert r.returncode == 1
    assert "Cannot read image" in r.stdout


def test_cli_batch_directory(tmp_path, small_png):
    import shutil

    src = tmp_path / "frames"
    src.mkdir()
    for i in range(3):
        shutil.copy(small_png, src / f"f{i}.png")
    out = tmp_path / "out"
    r = _run([str(src), "5", "30", "-o", str(out)])
    assert r.returncode == 0, r.stdout + r.stderr
    assert "Restored 3 frames" in r.stdout
    assert sorted(p.name for p in out.iterdir()) == [
        "f0_restored.png",
        "f1_restored.png",
        "f2_restored.png",
    ]


def test_cli_batch_stem_collision(tmp_path, small_png):
    """Same stem in two formats must not overwrite each other's output:
    colliding stems keep the extension (car_png/car_bmp), unique ones
    keep the short <stem>_restored.png name."""
    import shutil

    import cv2
    import numpy as np

    src = tmp_path / "frames"
    src.mkdir()
    shutil.copy(small_png, src / "car.png")
    img = cv2.imread(str(small_png))
    cv2.imwrite(str(src / "car.bmp"), img)
    cv2.imwrite(str(src / "other.bmp"), img)
    # second-order collision: a literal car_bmp.png whose unique-stem
    # name collides with car.bmp's extension-mangled name
    shutil.copy(small_png, src / "car_bmp.png")
    out = tmp_path / "out"
    r = _run([str(src), "5", "30", "-o", str(out)])
    assert r.returncode == 0, r.stdout + r.stderr
    assert "Restored 4 frames" in r.stdout
    names = sorted(p.name for p in out.iterdir())
    assert len(names) == 4 and len(set(names)) == 4, names
    assert "car_png_restored.png" in names and "other_restored.png" in names
    assert sum(n.startswith("car_bmp") for n in names) == 2, names


def test_cli_batch_skips_corrupt_files(tmp_path, small_png):
    import shutil

    src = tmp_path / "frames"
    src.mkdir()
    shutil.copy(small_png, src / "good.png")
    (src / "bad.png").write_text("not a png at all")
    r = _run([str(src), "5", "30", "-o", str(tmp_path / "out")])
    assert r.returncode == 0, r.stdout + r.stderr
    assert "skipping" in r.stdout
    assert "Restored 1 frames" in r.stdout
    assert "[1 skipped]" in r.stdout


def test_cli_empty_directory(tmp_path):
    d = tmp_path / "empty"
    d.mkdir()
    r = _run([str(d), "5", "30"])
    assert r.returncode == 1
    assert "no image files" in r.stdout


def test_cli_batch_sharded_2d_mesh(tmp_path):
    """Directory input + --mode sharded runs the batched restore over a
    2D (batch, rows) mesh and matches the jit batch outputs."""
    from fft_restoration_tpu.utils.imageio import imread, imwrite

    rng = np.random.default_rng(3)
    d = tmp_path / "frames"
    d.mkdir()
    for i in range(3):
        imwrite(str(d / f"f{i}.png"), (rng.random((16, 16, 3)) * 255).astype(np.uint8))
    out_s = tmp_path / "out_sharded"
    out_j = tmp_path / "out_jit"
    r = _run([str(d), "3", "30", "--mode", "sharded", "--devices", "4", "-o", str(out_s)])
    assert r.returncode == 0, r.stdout + r.stderr
    assert "Restored 3 frames" in r.stdout
    r = _run([str(d), "3", "30", "-o", str(out_j)])
    assert r.returncode == 0, r.stdout + r.stderr
    for i in range(3):
        a = imread(str(out_s / f"f{i}_restored.png"))
        b = imread(str(out_j / f"f{i}_restored.png"))
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_batch_chunking(tmp_path, monkeypatch):
    """Oversized same-size groups are restored in bounded chunks (no
    single giant device batch)."""
    import fft_restoration_tpu.cli as cli
    import numpy as np
    from fft_restoration_tpu.utils.imageio import imwrite

    rng = np.random.default_rng(0)
    d = tmp_path / "frames"
    d.mkdir()
    for i in range(5):
        imwrite(str(d / f"f{i}.png"),
                (rng.random((32, 48, 3)) * 255).astype(np.uint8))
    # force a tiny chunk budget so 5 frames split into 3 device batches
    calls = []
    real = cli._restore_group

    def spy(args, group, out_dir, single, batched=None):
        calls.append(len(group))
        return real(args, group, out_dir, single, batched)

    monkeypatch.setattr(cli, "_restore_group", spy)
    # shrink the chunk budget so 5 tiny frames split into multiple calls
    monkeypatch.setattr(cli, "_BATCH_CHUNK_BYTES", 32 * 64 * 4 * 12 * 2)
    r = cli.main([str(d), "5", "30", "-o", str(tmp_path / "out")])
    assert r == 0
    outs = sorted((tmp_path / "out").glob("*_restored.png"))
    assert len(outs) == 5
    # top-level call saw 5, then chunked recursive calls each <= chunk
    assert max(calls) == 5 and len(calls) > 1
