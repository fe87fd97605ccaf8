"""Golden-output regression pins on both seed-generated fixtures.

The oracle defines the framework's semantics; this pins its exact bytes
on the car-shaped fixture (640x330) with PSF(40, 45) and on the cat-shaped
one (1920x782) with the reference README's headline invocation PSF(50, 30)
(reference README.md:12-13), so any semantic drift (PSF synthesis, FFT
ordering, normalize convention, Lab round trip) fails loudly. The jit
pipeline is then held to the reference GPU tier against the same
fixtures.
"""

import hashlib

import numpy as np
import pytest

from fft_restoration_tpu.oracle.serial import restore_image
from fft_restoration_tpu.utils.verify import psnr

# car fixture (640x330) restored with PSF(40, 45deg), K=0.01
GOLDEN_MD5 = "e51f61b7f321d3b2768d509ed34fc7dc"
GOLDEN_MEAN = 104.95497632575757
# cat fixture (1920x782) restored with PSF(50, 30deg), K=0.01
CAT_GOLDEN_MD5 = "02dbe434b0ff2ce858188a57d4d70297"
CAT_GOLDEN_MEAN = 120.15142774048024


@pytest.fixture(scope="module")
def car_oracle_restored(car_image):
    return restore_image(car_image, 40, 45.0)


def test_oracle_golden_car(car_oracle_restored):
    out = car_oracle_restored
    assert out.shape == (330, 640, 3)
    assert abs(float(out.mean()) - GOLDEN_MEAN) < 1e-6
    assert hashlib.md5(out.tobytes()).hexdigest() == GOLDEN_MD5


@pytest.mark.parametrize("backend", ["matmul", "xla"])
def test_pipeline_vs_golden_car(car_image, car_oracle_restored, backend):
    from fft_restoration_tpu.models.pipeline import WienerDeblurPipeline

    out = WienerDeblurPipeline(fft_backend=backend).restore(car_image, 40, 45.0)
    # final uint8 images agree to ~1 count; PSNR on the 255 scale
    assert psnr(car_oracle_restored.astype(float), out.astype(float), peak=255.0) > 50.0
    assert np.abs(out.astype(int) - car_oracle_restored.astype(int)).max() <= 2


@pytest.fixture(scope="module")
def cat_image(cat_png):
    from fft_restoration_tpu.utils.imageio import imread

    return imread(cat_png)


@pytest.fixture(scope="module")
def cat_oracle_restored(cat_image):
    return restore_image(cat_image, 50, 30.0)


def test_oracle_golden_cat(cat_oracle_restored):
    out = cat_oracle_restored
    assert out.shape == (782, 1920, 3)
    assert abs(float(out.mean()) - CAT_GOLDEN_MEAN) < 1e-6
    assert hashlib.md5(out.tobytes()).hexdigest() == CAT_GOLDEN_MD5


def test_pipeline_vs_golden_cat(cat_image, cat_oracle_restored):
    from fft_restoration_tpu.models.pipeline import WienerDeblurPipeline

    out = WienerDeblurPipeline().restore(cat_image, 50, 30.0)
    assert psnr(cat_oracle_restored.astype(float), out.astype(float), peak=255.0) > 50.0
    assert np.abs(out.astype(int) - cat_oracle_restored.astype(int)).max() <= 2
