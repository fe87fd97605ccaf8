#!/usr/bin/env python
"""Benchmark: 2048x2048 RGB Wiener restoration throughput on one GPU.

    python bench.py [--backend xla|matmul|radix2|naive] [--no-oracle]

Prints ONE JSON line. `value` is restored megapixels per second through
the library's serving path (WienerDeblurPipeline(emit_planes=False):
uint8 frame in, uint8 frame out, host transfers included) at PSF(50, 30°),
K=0.01, timed on the host clock around calls that end in the returned
numpy array. Beside it:

* device_ms_per_frame — the same graph on a device-resident frame, timed
  with block_until_ready (no host transfers);
* phases_device_ms / phase_hbm_roofline_share / idle_share — from a
  jax.profiler trace (utils/trace_profile.py): device busy time per
  fphase_* scope, the least time each phase's bytes need at the card's
  HBM bandwidth over its measured time, and the device's idle share of
  the traced window;
* copy_hbm_bytes_per_s — what a large elementwise pass reaches on this
  card in the same run, beside the published 3.35 TB/s;
* vs_baseline — speedup over the serial NumPy oracle on this host (the
  "[Speedup] x.xx vs serial" every reference driver prints);
* platform, device_kind, device_count, XLA_FLAGS, and the card's name
  and power limit from nvidia-smi.

Fails (exit 1, no JSON) when JAX finds no GPU: a number from another
device is not this benchmark's number.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

H = W = 2048
PSF_LEN = 50
PSF_ANGLE = 30.0
K = 0.01
ITERS = 20
ROUNDS = 5

# Published peaks per device_kind (NVIDIA H100 data sheet, SXM part;
# dense rates). A device missing from this table is an error.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "f32_flops_per_s": 67e12},
}


def require_gpu():
    """The JAX devices, or exit 1 when the default platform is not GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(
            f"{os.path.basename(sys.argv[0])}: no GPU (JAX platform "
            f"{devs[0].platform!r}); refusing to report a device number",
            file=sys.stderr,
        )
        sys.exit(1)
    return devs


def device_record(devs) -> dict:
    """What every benchmark record names: the device and the card."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return {
        "platform": devs[0].platform,
        "device_kind": devs[0].device_kind,
        "device_count": len(devs),
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
        "card": r.stdout.strip().splitlines()[0] if r.returncode == 0 else None,
    }


def time_rounds(call, iters: int = ITERS, rounds: int = ROUNDS) -> list:
    """ms per call for each of `rounds` rounds of `iters` calls; `call`
    must block until its result is ready (block_until_ready or a host
    array)."""
    call()
    out = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(iters):
            call()
        out.append((time.perf_counter() - t0) / iters * 1e3)
    return out


def phase_bytes(h: int, w: int, hp: int, wp: int) -> dict:
    """Least bytes each pipeline phase must move through device memory
    for one (h, w, 3) u8 frame restored at (hp, wp): each phase reads
    its inputs and writes its outputs once. Three channels ride two
    packed complex64 planes (models/pipeline._pack_channel_pairs)."""
    c64 = hp * wp * 8
    return {
        "ingest_pad": 3 * h * w + 2 * c64,  # u8 in, packed planes out
        "fft_psf": 2 * c64,  # PSF plane in, spectrum out
        "fft_image": 4 * c64,  # 2 planes in, 2 out
        "filter": 5 * c64,  # G (2) + H (1) in, F (2) out
        "ifft": 4 * c64,  # 2 planes in, 2 out
        "normalize": 3 * hp * wp * 4 + 3 * h * w * 4,  # f32 in, cropped out
        "wb_encode": 3 * h * w * 4 + 3 * h * w + 3 * h * w,  # f32 + u8 in, u8 out
    }


def copy_bytes_per_s(nbytes: int = 1 << 30) -> float:
    """Achieved device-memory bandwidth of a large elementwise pass
    (read + write of an `nbytes` float32 array): the practical ceiling
    beside the published peak."""
    import jax
    import jax.numpy as jnp

    x = jnp.ones((nbytes // 4,), jnp.float32)
    f = jax.jit(lambda a: a + 1.0)
    ms = statistics.median(time_rounds(lambda: jax.block_until_ready(f(x)), 10, 3))
    return 2 * nbytes / (ms / 1e3)


def roofline_share(phases_ms: dict, nbytes: dict, device_kind: str) -> dict:
    """Per phase: (bytes / peak HBM bandwidth) / measured time."""
    bw = PEAKS[device_kind]["hbm_bytes_per_s"]
    return {
        k: round(nbytes[k] / bw * 1e3 / phases_ms[k], 4)
        for k in nbytes
        if phases_ms.get(k)
    }


def build_parser() -> argparse.ArgumentParser:
    from fft_restoration_tpu.ops.fft import DEFAULT_FFT_BACKEND, FFT_BACKENDS

    ap = argparse.ArgumentParser(description="2048² RGB restore benchmark")
    ap.add_argument("--backend", choices=FFT_BACKENDS, default=DEFAULT_FFT_BACKEND)
    ap.add_argument("--no-oracle", action="store_true",
                    help="skip the serial-oracle speedup (vs_baseline: null)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    devs = require_gpu()
    import jax
    import jax.numpy as jnp

    from fft_restoration_tpu.cli import _enable_compile_cache
    from fft_restoration_tpu.models.pipeline import WienerDeblurPipeline
    from fft_restoration_tpu.utils.blurgen import blurred_scene
    from fft_restoration_tpu.utils.trace_profile import device_trace

    _enable_compile_cache()
    rec = device_record(devs)
    if rec["device_kind"] not in PEAKS:
        raise KeyError(f"no peak rates for device_kind {rec['device_kind']!r}")
    img = blurred_scene(H, W, PSF_LEN, PSF_ANGLE, seed=0)

    pipe = WienerDeblurPipeline(
        fft_backend=args.backend, emit_planes=False, donate_input=False
    )
    x = jax.device_put(jnp.asarray(img))
    a = (x, jnp.float32(PSF_ANGLE), jnp.float32(K))
    fn = pipe._compiled(H, W, PSF_LEN)
    t0 = time.perf_counter()
    fn.lower(*a).compile()
    compile_s = time.perf_counter() - t0

    host = time_rounds(lambda: pipe.restore(img, PSF_LEN, PSF_ANGLE, K))
    dev = time_rounds(lambda: jax.block_until_ready(fn(*a)))
    ms_host = statistics.median(host)
    ms_dev = statistics.median(dev)

    rep = device_trace(fn, a, n_iters=10)
    phases = {k: round(v, 4) for k, v in rep.phases_ms.items()}
    share = roofline_share(rep.phases_ms, phase_bytes(H, W, H, W), rec["device_kind"])

    copy_bw = copy_bytes_per_s()
    speedup = None
    if not args.no_oracle:
        from fft_restoration_tpu.oracle.psf import motion_blur_kernel_oracle
        from fft_restoration_tpu.oracle.serial import restore_channels

        psf = motion_blur_kernel_oracle(PSF_LEN, PSF_ANGLE)
        chans = np.moveaxis(img.astype(np.float32) / np.float32(255.0), -1, 0)
        t0 = time.perf_counter()
        restore_channels(chans, psf, K)
        speedup = round((time.perf_counter() - t0) * 1e3 / ms_host, 2)

    print(
        f"{H}x{W}x3 Wiener restore ({args.backend}): {ms_host:.3f} ms/frame "
        f"host, {ms_dev:.3f} ms/frame device-resident, device busy "
        f"{rep.device_busy_ms:.3f} ms, on {rec['card']}",
        file=sys.stderr,
    )
    print(rep.report(), file=sys.stderr)
    mp = H * W * 3 / 1e6
    print(
        json.dumps(
            {
                "metric": "wiener_deblur_2048sq_rgb_throughput",
                "value": round(mp / ms_host * 1e3, 1),
                "unit": "MP/s",
                "vs_baseline": speedup,
                "backend": args.backend,
                "ms_per_frame": round(ms_host, 4),
                "rounds_ms": [round(r, 4) for r in host],
                "device_ms_per_frame": round(ms_dev, 4),
                "device_rounds_ms": [round(r, 4) for r in dev],
                "device_busy_ms": round(rep.device_busy_ms, 4),
                "idle_share": (
                    None if rep.idle_share is None else round(rep.idle_share, 4)
                ),
                "phases_device_ms": phases,
                "phase_hbm_roofline_share": share,
                "compile_s": round(compile_s, 3),
                "copy_hbm_bytes_per_s": round(copy_bw, -6),
                **rec,
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
