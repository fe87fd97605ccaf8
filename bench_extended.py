#!/usr/bin/env python
"""Extended benchmark: the other frame shapes on one GPU.

    python bench_extended.py [--backend xla|matmul|radix2|naive]

Prints one JSON line per configuration (bench.py stays the single-line
headline). Frames are made from a seed (utils/blurgen.py) at the shapes
the cells come from:

  * cat 1920x782 PSF(50, 30) and car 640x330 PSF(40, 45) — the
    reference's two input shapes;
  * 64-image 256² batch and 8-image 2048² batch, shared PSF;
  * UHD 3840x2160, pow2 pad (4096²) and smooth pad (3840x2304);
  * tiled 4096x6144 (25 MP) with 1024 tiles.

Each line: ms per call on the host clock (uint8 in on the device, the
call ends in block_until_ready), device busy ms from a profiler trace,
and the device record of bench.py. Fails (exit 1) without a GPU.
"""

from __future__ import annotations

import argparse
import functools
import json
import statistics
import sys

from bench import device_record, require_gpu, time_rounds


def build_parser() -> argparse.ArgumentParser:
    from fft_restoration_tpu.ops.fft import DEFAULT_FFT_BACKEND, FFT_BACKENDS

    ap = argparse.ArgumentParser(description="extended restore benchmark")
    ap.add_argument("--backend", choices=FFT_BACKENDS, default=DEFAULT_FFT_BACKEND)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    devs = require_gpu()
    import jax
    import jax.numpy as jnp
    import numpy as np

    from fft_restoration_tpu.cli import _enable_compile_cache
    from fft_restoration_tpu.models.batched import _batched_images_core
    from fft_restoration_tpu.models.pipeline import _restore_core
    from fft_restoration_tpu.models.tiled import tiled_restore_image
    from fft_restoration_tpu.utils.blurgen import blurred_scene
    from fft_restoration_tpu.utils.trace_profile import device_trace

    _enable_compile_cache()
    rec = device_record(devs)

    def run(name, fn, args_, unit, mpix, iters=10):
        ms = statistics.median(
            time_rounds(lambda: jax.block_until_ready(fn(*args_)), iters, 3)
        )
        busy = device_trace(fn, args_, n_iters=3).device_busy_ms
        print(json.dumps({
            "metric": name, "value": round(ms, 4), "unit": unit,
            "mp_per_s": round(mpix / ms * 1e3, 1),
            "device_busy_ms": round(busy, 4), "backend": args.backend, **rec,
        }), flush=True)

    def single(name, h, w, length, angle, pad_mode="pow2"):
        fn = jax.jit(functools.partial(
            _restore_core, psf_length=length, fft_backend=args.backend,
            emit_planes=False, pad_mode=pad_mode,
        ))
        x = jax.device_put(jnp.asarray(blurred_scene(h, w, length, angle, 0)))
        run(name, fn, (x, jnp.float32(angle), jnp.float32(0.01)),
            "ms/frame", h * w * 3 / 1e6)

    def batch(name, b, n, length):
        fn = jax.jit(functools.partial(
            _batched_images_core, psf_length=length, fft_backend=args.backend,
            filter_name="wiener", white_balance=True, emit_planes=False,
        ))
        stack = np.stack([blurred_scene(n, n, length, 30.0, i) for i in range(b)])
        x = jax.device_put(jnp.asarray(stack))
        run(name, fn, (x, jnp.float32(30.0), jnp.float32(0.01)),
            "ms/batch", b * n * n * 3 / 1e6, iters=5)

    single("cat_1920x782_psf50_30", 782, 1920, 50, 30.0)
    single("car_640x330_psf40_45", 330, 640, 40, 45.0)
    batch("batch64_256sq_shared_psf", 64, 256, 25)
    batch("batch8_2048sq_shared_psf", 8, 2048, 50)
    single("uhd_3840x2160_psf50_30", 2160, 3840, 50, 30.0)
    single("uhd_3840x2160_psf50_30_smoothpad", 2160, 3840, 50, 30.0, "smooth")

    big = blurred_scene(4096, 6144, 50, 30.0, 0)
    call = functools.partial(
        tiled_restore_image, big, 50, 30.0, tile=1024, fft_backend=args.backend
    )
    ms = statistics.median(time_rounds(call, 2, 3))
    print(json.dumps({
        "metric": "tiled_4096x6144_tile1024", "value": round(ms, 3),
        "unit": "ms/frame (host u8 in/out)",
        "mp_per_s": round(4096 * 6144 * 3 / 1e6 / ms * 1e3, 1),
        "backend": args.backend, **rec,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
