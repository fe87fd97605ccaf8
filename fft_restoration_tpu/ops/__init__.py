from fft_restoration_tpu.ops.fft import DEFAULT_FFT_BACKEND, FFT_BACKENDS, fft1d, fft2d
from fft_restoration_tpu.ops.psf import motion_blur_kernel
from fft_restoration_tpu.ops.wiener import wiener_filter
from fft_restoration_tpu.ops.color import bgr_to_lab, lab_to_bgr

__all__ = [
    "fft1d",
    "fft2d",
    "FFT_BACKENDS",
    "DEFAULT_FFT_BACKEND",
    "motion_blur_kernel",
    "wiener_filter",
    "bgr_to_lab",
    "lab_to_bgr",
]
