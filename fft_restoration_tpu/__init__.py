"""fft_restoration_tpu — frequency-domain image restoration on JAX/XLA.

A from-scratch JAX/XLA re-design of the capabilities of
`vayne1125/Parallel-Implementation-of-Frequency-Domain-Image-Restoration-using-FFT`
(the reference): Wiener deconvolution of motion-blurred RGB images via a
2D FFT, with PSF synthesis from (length, angle), power-of-two padding,
min-max normalization and Lab-space white balance. On a GPU the FFTs are
cuFFT calls (``jnp.fft``) and XLA fuses the elementwise phases.

Where the reference implements the same pipeline six times (serial, AVX2,
OpenMP, MPI, MPI+AVX2, CUDA — its fft/ directory), this package maps each
parallelism strategy to one JAX equivalent:

    serial      -> NumPy oracle (fft_restoration_tpu.oracle)
    simd/openmp -> vectorized jnp ops inside one jit graph (ops.fft)
    gpu (CUDA)  -> single-device jit graph (models.pipeline)
    mpi(+simd)  -> shard_map over a device Mesh with all_to_all transposes
                   (parallel.sharded_fft; NCCL over NVLink on a GPU host)
    channel loop-> leading batch axes over channels / images (models.batched)
"""

__version__ = "0.4.0"

__all__ = [
    "WienerDeblurPipeline",
    "BatchedWienerPipeline",
    "ShardedWienerPipeline",
    "deblur_image",
    "motion_blur_kernel",
    "richardson_lucy_planes",
    "edge_taper_planes",
    "estimate_motion_psf",
    "estimate_noise_K",
    "tiled_restore_image",
    "make_psf",
    "load_psf_file",
    "__version__",
]


def __getattr__(name):
    # Lazy imports keep `import fft_restoration_tpu` cheap (no jax init)
    # for oracle-only / host-only users.
    if name in ("WienerDeblurPipeline", "deblur_image"):
        from fft_restoration_tpu.models import pipeline

        return getattr(pipeline, name)
    if name == "BatchedWienerPipeline":
        from fft_restoration_tpu.models.batched import BatchedWienerPipeline

        return BatchedWienerPipeline
    if name == "ShardedWienerPipeline":
        from fft_restoration_tpu.parallel.sharded_pipeline import (
            ShardedWienerPipeline,
        )

        return ShardedWienerPipeline
    if name == "richardson_lucy_planes":
        from fft_restoration_tpu.models.richardson_lucy import (
            richardson_lucy_planes,
        )

        return richardson_lucy_planes
    if name == "edge_taper_planes":
        from fft_restoration_tpu.models.edgetaper import edge_taper_planes

        return edge_taper_planes
    if name == "estimate_motion_psf":
        from fft_restoration_tpu.models.estimate import estimate_motion_psf

        return estimate_motion_psf
    if name == "estimate_noise_K":
        from fft_restoration_tpu.models.estimate import estimate_noise_K

        return estimate_noise_K
    if name == "tiled_restore_image":
        from fft_restoration_tpu.models.tiled import tiled_restore_image

        return tiled_restore_image
    if name in ("motion_blur_kernel", "make_psf", "load_psf_file"):
        from fft_restoration_tpu.ops import psf

        return getattr(psf, name)
    raise AttributeError(name)
