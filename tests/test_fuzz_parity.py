"""Randomized shape/angle parity sweep vs the oracle — the differential
pattern applied across awkward sizes (odd dims, extreme aspect ratios,
PSF bigger than the short side)."""

import numpy as np
import pytest

from fft_restoration_tpu.models.pipeline import WienerDeblurPipeline
from fft_restoration_tpu.oracle.psf import motion_blur_kernel_oracle
from fft_restoration_tpu.oracle.serial import restore_channels
from fft_restoration_tpu.utils.verify import channels_equal

CASES = [
    ((17, 33), 5, 12.0),
    ((64, 16), 7, 95.0),
    ((31, 128), 11, -170.0),
    ((48, 48), 40, 45.0),  # PSF close to image size
    ((20, 100), 3, 0.5),
]


@pytest.mark.parametrize("backend", ["matmul", "xla"])
@pytest.mark.parametrize("shape,length,angle", CASES)
def test_parity_fuzz(rng, shape, length, angle, backend):
    img = (rng.random((*shape, 3)) * 255).astype(np.uint8)
    ours = WienerDeblurPipeline(fft_backend=backend).restore_channels(
        img, length, angle
    )
    oracle = restore_channels(
        np.moveaxis(img.astype(np.float32) / 255.0, -1, 0),
        motion_blur_kernel_oracle(length, angle),
    )
    report = channels_equal(ours, oracle, "gpu")
    assert report.passed, f"{shape} psf({length},{angle}) {backend}: {report}"
