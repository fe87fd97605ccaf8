"""Executable-cache warmup for serving deployments.

First compilation of a pipeline shape costs seconds; a serving process
should not pay that on its first request. This tool pre-compiles the
restoration graph for a list of frame geometries into the persistent
compilation cache (JAX_COMPILATION_CACHE_DIR if set, else the checkout's
.jax_cache — see cli._compile_cache_dir), so subsequent CLI/server
processes start warm.

Shapes are HEIGHTxWIDTH (matching numpy/jnp array order). The cat
fixture (1920 wide, 782 tall) is warmed as `782x1920`.

Usage:
    python -m fft_restoration_tpu.warmup 2048x2048 782x1920 --psf-length 50
    python -m fft_restoration_tpu.warmup 330x640 --sharded 4
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="fft_restoration_tpu.warmup")
    p.add_argument(
        "shapes",
        nargs="+",
        help="frame geometries to warm, HEIGHTxWIDTH (e.g. 2048x2048, "
        "782x1920 for a 1920-wide 782-tall frame)",
    )
    p.add_argument("--psf-length", type=int, default=50)
    from fft_restoration_tpu.ops.fft import DEFAULT_FFT_BACKEND, FFT_BACKENDS

    p.add_argument(
        "--backend", choices=FFT_BACKENDS, default=DEFAULT_FFT_BACKEND
    )
    p.add_argument("--filter", choices=("wiener", "inverse", "cls"), default="wiener")
    p.add_argument(
        "--sharded",
        type=int,
        default=0,
        metavar="N",
        help="also warm the N-device sharded pipeline",
    )
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from fft_restoration_tpu.cli import _enable_compile_cache

    _enable_compile_cache()

    import numpy as np

    from fft_restoration_tpu.models.pipeline import WienerDeblurPipeline

    pipe = WienerDeblurPipeline(fft_backend=args.backend, filter_name=args.filter)
    sharded = None
    if args.sharded:
        from fft_restoration_tpu.parallel.mesh import make_mesh
        from fft_restoration_tpu.parallel.sharded_pipeline import (
            ShardedWienerPipeline,
        )

        sharded = ShardedWienerPipeline(
            mesh=make_mesh(args.sharded),
            fft_backend=args.backend,
            filter_name=args.filter,
        )

    rng = np.random.default_rng(0)
    for spec in args.shapes:
        try:
            h, w = (int(v) for v in spec.lower().split("x"))
        except ValueError:
            print(
                f"[Error] bad shape {spec!r}; expected HEIGHTxWIDTH "
                f"like 2048x2048"
            )
            return 2
        img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        t0 = time.perf_counter()
        pipe.restore(img, args.psf_length, 30.0)
        print(
            f"warmed H={h} W={w} ({args.backend}) in "
            f"{time.perf_counter() - t0:.1f}s"
        )
        if sharded is not None:
            t0 = time.perf_counter()
            sharded.restore(img, args.psf_length, 30.0)
            print(
                f"warmed {h}x{w} sharded x{args.sharded} in "
                f"{time.perf_counter() - t0:.1f}s"
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
