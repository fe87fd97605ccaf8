"""Terminal preview (`--show`) — the imshow/waitKey analog
(reference serial.cpp:59-60)."""

import io

import numpy as np
import pytest

from fft_restoration_tpu.utils.termview import render_ansi, show_image


def test_render_dimensions_and_ansi():
    img = np.zeros((64, 128, 3), np.uint8)
    img[:, :, 2] = 200  # red in BGR
    s = render_ansi(img, max_cols=40, max_lines=10)
    lines = s.split("\n")
    # 64x128 fits to 40 cols -> 20 pixel rows -> 10 text lines
    assert len(lines) == 10
    assert all(line.endswith("\x1b[0m") for line in lines)
    # uniform image: one SGR pair per line (run-length elision), fg=red
    assert lines[0].startswith("\x1b[38;2;200;0;0m\x1b[48;2;200;0;0m")
    assert lines[0].count("▀") == 40


def test_render_aspect_and_tall_images():
    s = render_ansi(np.zeros((400, 10, 3), np.uint8), max_cols=80, max_lines=20)
    assert len(s.split("\n")) == 20  # height-bound fit


def test_render_top_bottom_split():
    img = np.zeros((2, 1, 3), np.uint8)
    img[0] = (255, 255, 255)  # top white, bottom black
    s = render_ansi(img, max_cols=4, max_lines=4)
    assert s == "\x1b[38;2;255;255;255m\x1b[48;2;0;0;0m▀\x1b[0m"


def test_render_gray_and_float_inputs():
    g = render_ansi(np.full((8, 8), 128, np.uint8), max_cols=8, max_lines=4)
    assert "38;2;128;128;128" in g
    f = render_ansi(np.full((8, 8, 3), 0.5, np.float32), max_cols=8, max_lines=4)
    assert "38;2;128;128;128" in f  # 0.5*255+0.5 rounds to 128


def test_render_rejects_bad_shape():
    with pytest.raises(ValueError):
        render_ansi(np.zeros((4, 4, 1), np.uint8))


def test_show_image_no_tty_never_blocks():
    buf = io.StringIO()
    show_image(
        np.zeros((4, 4, 3), np.uint8), title="t", file=buf, max_cols=4,
        max_lines=2,
    )
    out = buf.getvalue()
    assert out.startswith("t\n") and "▀" in out


def test_cli_show_flag(tmp_path):
    import os
    import subprocess
    import sys

    from fft_restoration_tpu.utils.imageio import imwrite

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = tmp_path / "in.png"
    rng = np.random.default_rng(3)
    imwrite(str(p), (rng.random((16, 16, 3)) * 255).astype(np.uint8))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [
            sys.executable, "-m", "fft_restoration_tpu", str(p), "5", "30",
            "--mode", "jit", "--no-verify", "--show",
            "-o", str(tmp_path / "out.png"),
        ],
        capture_output=True, text=True, cwd=repo, env=env, timeout=600,
    )
    assert r.returncode == 0, r.stderr
    assert "▀" in r.stdout  # preview rendered; no TTY so no blocking
