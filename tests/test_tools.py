"""Harnesses (bench.py, bench_extended.py, tools/): structural checks on
the CPU. Their measurements need a GPU; here they must refuse to run."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
sys.path.insert(0, REPO)


def _cpu_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return env


def test_bench_json_contract():
    """bench.py prints one JSON line with the record's metric keys plus
    the device record and the trace-derived fields. Static check of the
    emitted dict (running it needs the GPU)."""
    src = open(os.path.join(REPO, "bench.py")).read()
    for key in (
        '"metric"', '"value"', '"unit"', '"vs_baseline"', '"backend"',
        '"device_ms_per_frame"', '"idle_share"', '"phases_device_ms"',
        '"phase_hbm_roofline_share"', '"platform"', '"device_kind"',
        '"device_count"', '"xla_flags"', '"card"',
    ):
        assert key in src, key
    assert "wiener_deblur_2048sq_rgb_throughput" in src


@pytest.mark.parametrize("script", ["bench.py", "bench_extended.py"])
def test_bench_refuses_cpu(script):
    r = subprocess.run(
        [sys.executable, script, "--backend", "xla"], capture_output=True,
        text=True, cwd=REPO, env=_cpu_env(), timeout=300,
    )
    assert r.returncode == 1, r.stdout + r.stderr
    assert "no GPU" in r.stderr
    assert r.stdout.strip() == ""


def test_phase_bytes_and_roofline_share():
    import bench

    nb = bench.phase_bytes(2048, 2048, 2048, 2048)
    c64 = 2048 * 2048 * 8
    assert nb["fft_image"] == 4 * c64
    assert nb["filter"] == 5 * c64
    assert set(nb) == {
        "ingest_pad", "fft_psf", "fft_image", "filter", "ifft",
        "normalize", "wb_encode",
    }
    kind = "NVIDIA H100 80GB HBM3"
    bw = bench.PEAKS[kind]["hbm_bytes_per_s"]
    t_min_ms = nb["fft_image"] / bw * 1e3
    share = bench.roofline_share(
        {"fft_image": 2 * t_min_ms, "filter": 0.0}, nb, kind
    )
    assert share == {"fft_image": 0.5}  # unmeasured phases are left out
    with pytest.raises(KeyError):
        bench.roofline_share({"fft_image": 1.0}, nb, "Unknown Card")


def test_time_rounds_counts_calls():
    import bench

    calls = []
    rounds = bench.time_rounds(lambda: calls.append(1), iters=3, rounds=2)
    assert len(rounds) == 2 and all(r >= 0 for r in rounds)
    assert len(calls) == 1 + 3 * 2  # one warm-up call


def test_serve_slo_importable():
    import serve_slo  # noqa: F401  (argument parsing only happens in main)
