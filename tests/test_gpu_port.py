"""The GPU port's invariants that the CPU can check: one default FFT
backend at every entry point, meshes only from the default platform,
and chip_smoke.py refusing to run anywhere but on a GPU."""

import inspect
import os
import shutil
import subprocess
import sys

import pytest

from fft_restoration_tpu.ops.fft import DEFAULT_FFT_BACKEND

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _entry_points():
    from fft_restoration_tpu.models import (
        batched,
        convolve,
        edgetaper,
        estimate,
        filters,
        pipeline,
        richardson_lucy,
        tiled,
    )
    from fft_restoration_tpu.ops import fft
    from fft_restoration_tpu.parallel import sharded_fft, sharded_pipeline as sp

    return [
        (pipeline.restore_planes, "fft_backend"),
        (pipeline._restore_core, "fft_backend"),
        (pipeline.WienerDeblurPipeline, "fft_backend"),
        (pipeline.profile_phases, "fft_backend"),
        (batched.BatchedWienerPipeline, "fft_backend"),
        (batched.psf_grid_sweep, "fft_backend"),
        (tiled.tiled_restore_image, "fft_backend"),
        (richardson_lucy.richardson_lucy_planes, "fft_backend"),
        (edgetaper.edge_taper_planes, "fft_backend"),
        (convolve.circular_conv_builder, "fft_backend"),
        (estimate.estimate_motion_psf, "fft_backend"),
        (estimate.estimate_disk_psf, "fft_backend"),
        (estimate.estimate_gaussian_psf, "fft_backend"),
        (filters.apply_filter, "backend"),
        (fft.fft1d, "backend"),
        (fft.fft2d, "backend"),
        (sp.sharded_restore_planes, "fft_backend"),
        (sp.sharded_batched_restore_planes, "fft_backend"),
        (sp.sharded_batched_restore_images, "fft_backend"),
        (sp.profile_phases_sharded, "fft_backend"),
        (sp.ShardedWienerPipeline, "fft_backend"),
        (sharded_fft.sharded_fft2d, "backend"),
        (sharded_fft.sharded_fft2d_conv_fwd, "backend"),
        (sharded_fft.sharded_fft2d_conv_inv, "backend"),
    ]


@pytest.mark.parametrize("index", range(24))
def test_library_entry_point_default_backend(index):
    fn, param = _entry_points()[index]
    default = inspect.signature(fn).parameters[param].default
    assert default == DEFAULT_FFT_BACKEND, (fn.__qualname__, default)


def test_entry_point_list_is_complete():
    assert len(_entry_points()) == 24


def _parsers():
    import bench
    import bench_extended
    from fft_restoration_tpu import cli, serve, warmup

    return {
        "cli": (cli.build_parser(), ["x.png", "5", "30"], "fft_backend"),
        "serve": (serve.build_parser(), [], "backend"),
        "warmup": (warmup.build_parser(), ["16x16"], "backend"),
        "bench": (bench.build_parser(), [], "backend"),
        "bench_extended": (bench_extended.build_parser(), [], "backend"),
    }


@pytest.mark.parametrize(
    "name", ["cli", "serve", "warmup", "bench", "bench_extended"]
)
def test_command_line_default_backend(name):
    parser, argv, dest = _parsers()[name]
    assert getattr(parser.parse_args(argv), dest) == DEFAULT_FFT_BACKEND


def test_default_backend_is_the_library_fft():
    from fft_restoration_tpu.ops.fft import FFT_BACKENDS

    assert DEFAULT_FFT_BACKEND == "xla"
    assert "pallas" not in FFT_BACKENDS


def test_make_mesh_raises_when_platform_has_too_few_devices():
    import jax

    from fft_restoration_tpu.parallel.mesh import make_mesh, make_mesh2d

    n = len(jax.devices())
    with pytest.raises(ValueError, match="need"):
        make_mesh(n + 1)
    with pytest.raises(ValueError, match="need"):
        make_mesh2d(2, n)


def test_make_mesh_uses_default_platform():
    import jax

    from fft_restoration_tpu.parallel.mesh import make_mesh, make_mesh2d

    mesh = make_mesh(4)
    assert {d.platform for d in mesh.devices.flat} == {jax.default_backend()}
    assert make_mesh2d(2, 2).devices.shape == (2, 2)


def _cpu_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return env


def test_chip_smoke_refuses_cpu():
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], capture_output=True, text=True,
        cwd=REPO, env=_cpu_env(), timeout=300,
    )
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert '"ok"' not in r.stdout


def test_chip_smoke_refuses_without_the_program(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = _cpu_env()
    env.pop("PYTHONPATH", None)
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], capture_output=True, text=True,
        cwd=tmp_path, env=env, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_parses_chips():
    import chip_smoke

    assert chip_smoke.build_parser().parse_args([]).chips == 1
    assert chip_smoke.build_parser().parse_args(["--chips", "4"]).chips == 4
    with pytest.raises(SystemExit):
        chip_smoke.build_parser().parse_args(["--chips", "3"])
