"""Warmup tool and compile-cache placement (subprocess, CPU)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.update(extra)
    return env


def test_warmup_tool(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, executables land there."""
    cache = tmp_path / "cache"
    r = subprocess.run(
        [sys.executable, "-m", "fft_restoration_tpu.warmup", "16x32",
         "--psf-length", "5"],
        capture_output=True,
        text=True,
        cwd=REPO,
        env=_env(
            JAX_COMPILATION_CACHE_DIR=str(cache),
            JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
        ),
        timeout=600,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    # shapes are HEIGHTxWIDTH; the parsed geometry is echoed back
    assert "warmed H=16 W=32" in r.stdout
    assert cache.exists() and any(cache.iterdir())


def test_warmup_bad_shape():
    r = subprocess.run(
        [sys.executable, "-m", "fft_restoration_tpu.warmup", "banana"],
        capture_output=True,
        text=True,
        cwd=REPO,
        env=_env(),
        timeout=300,
    )
    assert r.returncode == 2
    assert "bad shape" in r.stdout


def test_compile_cache_dir_unset_is_checkout_path(monkeypatch):
    from fft_restoration_tpu.cli import _compile_cache_dir

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert _compile_cache_dir() == os.path.join(REPO, ".jax_cache")


def test_compile_cache_dir_set_leaves_it_to_jax(monkeypatch, tmp_path):
    from fft_restoration_tpu.cli import _compile_cache_dir

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert _compile_cache_dir() is None


def test_enable_compile_cache_configures_jax():
    """In a fresh process: unset -> the checkout's .jax_cache; set ->
    JAX's own reading of the variable, untouched by the program."""
    code = (
        "import jax; from fft_restoration_tpu.cli import "
        "_enable_compile_cache as e; e(); "
        "print(jax.config.jax_compilation_cache_dir)"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=REPO, env=_env(), timeout=300,
    )
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == os.path.join(REPO, ".jax_cache")
    r = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=REPO, env=_env(JAX_COMPILATION_CACHE_DIR="/nonexistent/x"),
        timeout=300,
    )
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "/nonexistent/x"
