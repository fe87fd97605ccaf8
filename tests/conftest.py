"""Test configuration: force CPU with 8 virtual devices.

Multi-device sharding (parallel/) is validated on a virtual 8-device
CPU mesh, mirroring how the reference verifies its MPI modes with
oversubscribed local ranks on one host (SURVEY.md §4, reference
README.md:55). Must run before jax initializes.

The image fixtures are generated from a seed (utils/blurgen.py) at the
shapes of the reference's two inputs: car 640x330 and cat 1920x782.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np
import pytest

# (h, w, psf_length, psf_angle, seed) of each seed-generated fixture
FIXTURES = {
    "car": (330, 640, 40, 45.0, 1),
    "cat": (782, 1920, 50, 30.0, 2),
}


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


@pytest.fixture(scope="session")
def small_bgr(rng):
    """Random small BGR float image in [0,1] for fast pipeline tests."""
    return rng.random((48, 56, 3)).astype(np.float32)


@pytest.fixture(scope="session")
def fixture_pngs(tmp_path_factory):
    """{name: path} of the blurred fixtures written as PNG."""
    from fft_restoration_tpu.utils.blurgen import blurred_scene
    from fft_restoration_tpu.utils.imageio import imwrite

    d = tmp_path_factory.mktemp("fixtures")
    paths = {}
    for name, (h, w, length, angle, seed) in FIXTURES.items():
        paths[name] = str(d / f"{name}_blurred.png")
        imwrite(paths[name], blurred_scene(h, w, length, angle, seed))
    return paths


@pytest.fixture(scope="session")
def car_png(fixture_pngs):
    return fixture_pngs["car"]


@pytest.fixture(scope="session")
def cat_png(fixture_pngs):
    return fixture_pngs["cat"]


@pytest.fixture(scope="session")
def car_image(car_png):
    """Small blurred fixture (640x330 BGR uint8)."""
    from fft_restoration_tpu.utils.imageio import imread

    return imread(car_png)
