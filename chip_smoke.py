#!/usr/bin/env python
"""Smoke test of the restore path on a GPU, through the entry points a
user calls: the library, the CLI and the HTTP server.

    python chip_smoke.py             # one card: every phase below
    python chip_smoke.py --chips 4   # four cards: the sharded phase only

Phases, one process for the whole run (a second JAX process could not
get the card's memory), each printing its time and its comparison:

* device   — platform, device_kind, count, card name and power limit;
* library  — WienerDeblurPipeline on a 2048x2048x3 u8 frame blurred with
             PSF(50, 30°) vs the NumPy oracle (oracle/serial.py);
* kernels  — each translated piece at 2048² vs its plain reference:
             fft2d('xla') vs np.fft in float64, the Wiener spectrum vs
             the oracle's, white balance + u8 encode vs oracle/color.py;
* cli      — cli.main on a written 2048² PNG must print [Success];
* serve    — three POSTs of a 1280x720 PNG to serve.py's server on an
             ephemeral port, each vs the library restore of the body;
* surfaces — batched 64x256², --tile 1024 on 4096², --pad smooth on
             3840x2160 and --estimate-psf, each vs what the CPU tests
             compare it with;
* sharded  — (--chips 4 only) the row-sharded restore on a 4-card mesh
             vs the single-card restore, and the (2, 2) batch x rows
             restore vs the single-card batched restore.

All inputs are made from a seed (utils/blurgen.py). Exits non-zero, with
no result line, when JAX finds no GPU or any phase fails. The last line
of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import traceback

import numpy as np

SEED = 0
PSF_LEN, PSF_ANGLE, K = 50, 30.0, 0.01


def _say(msg: str) -> None:
    print(msg, flush=True)


def _card() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else "unknown"


def _check(name: str, ok: bool, detail: str) -> None:
    _say(f"  {name}: {detail} -> {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"{name}: {detail}")


def _u8_cmp(name, ours, ref, max_counts, min_psnr=None):
    from fft_restoration_tpu.utils.verify import psnr

    d = int(np.abs(ours.astype(np.int16) - ref.astype(np.int16)).max())
    detail = f"max |diff| {d} counts (bound {max_counts})"
    ok = d <= max_counts
    if min_psnr is not None:
        p = psnr(ref.astype(float), ours.astype(float), peak=255.0)
        detail += f", PSNR {p:.2f} dB (bound > {min_psnr})"
        ok = ok and p > min_psnr
    _check(name, ok, detail)


def _rel(ours, ref):
    return (
        float(np.abs(ours - ref).max() / np.abs(ref).max()),
        float(np.linalg.norm(ours - ref) / np.linalg.norm(ref)),
    )


def phase_library():
    import jax
    import jax.numpy as jnp

    from fft_restoration_tpu.models.pipeline import WienerDeblurPipeline
    from fft_restoration_tpu.oracle.psf import motion_blur_kernel_oracle
    from fft_restoration_tpu.oracle.serial import restore_channels, restore_image
    from fft_restoration_tpu.utils.blurgen import blurred_scene
    from fft_restoration_tpu.utils.verify import channels_equal

    img = blurred_scene(2048, 2048, PSF_LEN, PSF_ANGLE, SEED)
    x = jnp.asarray(img)
    args = (x, jnp.float32(PSF_ANGLE), jnp.float32(K))
    # compile times of the serving graph (u8 in, u8 out)
    serving = WienerDeblurPipeline(emit_planes=False, donate_input=False)
    t0 = time.perf_counter()
    serving._compiled(2048, 2048, PSF_LEN).lower(*args).compile()
    cold = time.perf_counter() - t0
    jax.clear_caches()
    serving = WienerDeblurPipeline(emit_planes=False, donate_input=False)
    fn = serving._compiled(2048, 2048, PSF_LEN)
    t0 = time.perf_counter()
    fn.lower(*args).compile()
    warm = time.perf_counter() - t0
    _say(
        f"  compile: first {cold:.2f} s, again after clearing in-process "
        f"caches (persistent cache) {warm:.2f} s"
    )
    n = 20
    serving.restore(img, PSF_LEN, PSF_ANGLE, K)
    t0 = time.perf_counter()
    for _ in range(n):
        serving.restore(img, PSF_LEN, PSF_ANGLE, K)
    host_ms = (time.perf_counter() - t0) / n * 1e3
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(n):
        r = fn(*args)
    jax.block_until_ready(r)
    dev_ms = (time.perf_counter() - t0) / n * 1e3
    _say(
        f"  warm: {host_ms:.3f} ms/frame through restore() (u8 host in/out), "
        f"{dev_ms:.3f} ms/frame on device-resident input"
    )
    out, planes = WienerDeblurPipeline().restore_with_planes(
        img, PSF_LEN, PSF_ANGLE, K
    )
    t0 = time.perf_counter()
    ref = restore_image(img, PSF_LEN, PSF_ANGLE, K)
    ref_planes = restore_channels(
        np.moveaxis(img.astype(np.float32) / np.float32(255.0), -1, 0),
        motion_blur_kernel_oracle(PSF_LEN, PSF_ANGLE), K,
    )
    _say(f"  oracle: {time.perf_counter() - t0:.1f} s")
    _u8_cmp("u8 image vs oracle", out, ref, 2, 50.0)
    rep = channels_equal(planes, ref_planes, "inf")
    _check(
        "planes vs oracle (complex64 cuFFT, color matmuls at HIGHEST)",
        rep.passed, f"INF {rep.inf:.3e} (bound 1e-3), PSNR {rep.psnr_db:.1f} dB",
    )


def phase_kernels():
    import jax
    import jax.numpy as jnp

    from fft_restoration_tpu.models.pipeline import wb_encode
    from fft_restoration_tpu.oracle import color as ocolor
    from fft_restoration_tpu.oracle import serial as oserial
    from fft_restoration_tpu.oracle.psf import motion_blur_kernel_oracle
    from fft_restoration_tpu.ops.fft import fft2d
    from fft_restoration_tpu.ops.wiener import wiener_filter
    from fft_restoration_tpu.utils.blurgen import blurred_scene

    rng = np.random.default_rng(SEED)
    a = rng.standard_normal((2, 2048, 2048)).astype(np.float32)
    b = rng.standard_normal((2, 2048, 2048)).astype(np.float32)
    f = jax.jit(lambda re, im: fft2d(re, im, False, "xla"))
    re, im = f(a, b)
    ours = np.asarray(re) + 1j * np.asarray(im)
    mx, l2 = _rel(ours, np.fft.fft2(a.astype(np.float64) + 1j * b))
    # float32 FFT: error grows ~ eps32 * log2(n) = 1.2e-7 * 22 at most
    _check(
        "fft2d('xla') vs np.fft.fft2 (float64), 2 x 2048²",
        mx <= 1e-5 and l2 <= 1e-6,
        f"max err / max |ref| {mx:.2e} (bound 1e-5), relative L2 {l2:.2e} "
        "(bound 1e-6)",
    )

    img = blurred_scene(2048, 2048, PSF_LEN, PSF_ANGLE, SEED)
    ch = img[..., 0].astype(np.float32) / np.float32(255.0)
    pp = np.zeros((2048, 2048), np.float32)
    psf = motion_blur_kernel_oracle(PSF_LEN, PSF_ANGLE)
    pp[: psf.shape[0], : psf.shape[1]] = psf
    G = oserial.dft2d(ch.astype(np.complex64), inverse=False)
    H = oserial.dft2d(pp.astype(np.complex64), inverse=False)
    den = (H.real * H.real + H.imag * H.imag + np.float32(K)).astype(np.float32)
    Fo = (G.real * H.real + G.imag * H.imag) / den + 1j * (
        (G.imag * H.real - G.real * H.imag) / den
    )

    @jax.jit
    def spectrum(c, p):
        z = jnp.zeros_like(c)
        return wiener_filter(fft2d(c, z, False), fft2d(p, z, False), K)

    Fr, Fi = spectrum(ch, pp)
    mx, l2 = _rel(np.asarray(Fr) + 1j * np.asarray(Fi), Fo)
    _check(
        "Wiener spectrum vs oracle (radix-2 complex64), 2048²",
        l2 <= 1e-4,
        f"max err / max |ref| {mx:.2e}, relative L2 {l2:.2e} (bound 1e-4)",
    )

    planes = rng.random((3, 2048, 2048), np.float32)
    orig = (rng.random((3, 2048, 2048)) * 255).astype(np.uint8)
    enc = np.asarray(jax.jit(wb_encode)(planes, orig))
    lab = ocolor.apply_white_balance(
        ocolor.bgr_to_lab(np.moveaxis(planes, 0, -1)),
        ocolor.bgr_to_lab(np.moveaxis(orig, 0, -1).astype(np.float32) / 255.0),
    )
    ref = np.clip(ocolor.lab_to_bgr(lab) * np.float32(255.0), 0, 255).astype(
        np.uint8
    )
    _u8_cmp("white balance + u8 encode vs oracle/color.py, 2048²", enc, ref, 1)


def phase_cli(tmp):
    from fft_restoration_tpu import cli
    from fft_restoration_tpu.utils.blurgen import blurred_scene
    from fft_restoration_tpu.utils.imageio import imwrite

    src = os.path.join(tmp, "frame.png")
    imwrite(src, blurred_scene(2048, 2048, PSF_LEN, PSF_ANGLE, SEED + 1))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([src, str(PSF_LEN), str(PSF_ANGLE), "-o",
                       os.path.join(tmp, "out.png")])
    lines = [l for l in buf.getvalue().splitlines() if l.strip()]
    for l in lines:
        if l.startswith(("[Success]", "[Error]", "Deblurring", "[Speedup]")):
            _say(f"  | {l}")
    _check(
        "cli.main 2048² PNG", rc == 0 and any(l.startswith("[Success]") for l in lines),
        f"exit {rc}",
    )


def _post(addr, path, body):
    import http.client

    conn = http.client.HTTPConnection(*addr, timeout=600)
    try:
        conn.request("POST", path, body=body,
                     headers={"Content-Type": "application/octet-stream"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def phase_serve():
    from http.server import ThreadingHTTPServer

    from fft_restoration_tpu.models.pipeline import WienerDeblurPipeline
    from fft_restoration_tpu.serve import (
        RestorationService,
        build_parser,
        make_handler,
    )
    from fft_restoration_tpu.utils.blurgen import blurred_scene
    from fft_restoration_tpu.utils.imageio import decode_png, encode_png

    service = RestorationService(build_parser().parse_args(["--port", "0"]))
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        bgr = blurred_scene(720, 1280, PSF_LEN, PSF_ANGLE, SEED + 2)
        body = encode_png(bgr[..., ::-1])  # PNG bodies are RGB
        for query, kw in (
            ("", {}),
            ("?filter=rl&iters=10", {"filter_name": "rl", "rl_iters": 10}),
            ("?edgetaper=1", {"edgetaper": True}),
        ):
            t0 = time.perf_counter()
            status, data = _post(srv.server_address, "/restore" + query, body)
            dt = time.perf_counter() - t0
            _check(f"POST /restore{query} status", status == 200, f"{status} in {dt:.2f} s")
            got = decode_png(data)[..., ::-1]
            want = WienerDeblurPipeline(emit_planes=False, **kw).restore(
                bgr, PSF_LEN, PSF_ANGLE, K
            )
            _u8_cmp(f"POST /restore{query} vs library", got, want, 1)
    finally:
        srv.shutdown()
        srv.server_close()
        service.batcher.shutdown()
        thread.join(timeout=30)


def _affine_align(a, b):
    out = np.empty_like(b)
    for c in range(3):
        x, y = b[..., c].ravel(), a[..., c].ravel()
        A = np.vstack([x, np.ones_like(x)]).T
        coef, *_ = np.linalg.lstsq(A, y, rcond=None)
        out[..., c] = b[..., c] * coef[0] + coef[1]
    return out


def phase_surfaces():
    from fft_restoration_tpu.models import estimate as est
    from fft_restoration_tpu.models.batched import BatchedWienerPipeline
    from fft_restoration_tpu.models.pipeline import WienerDeblurPipeline, pad_extents
    from fft_restoration_tpu.models.tiled import tiled_restore_image
    from fft_restoration_tpu.oracle.psf import motion_blur_kernel_oracle
    from fft_restoration_tpu.utils.blurgen import blurred_scene
    from fft_restoration_tpu.utils.verify import psnr

    # batched 64 x 256², shared PSF, vs the single-frame pipeline
    stack = np.stack([blurred_scene(256, 256, 9, 30.0, SEED + 10 + i) for i in range(64)])
    t0 = time.perf_counter()
    outs = BatchedWienerPipeline().restore(stack, 9, 30.0)
    dt = time.perf_counter() - t0
    single = WienerDeblurPipeline()
    d = max(
        int(np.abs(outs[i].astype(int) - single.restore(stack[i], 9, 30.0).astype(int)).max())
        for i in range(len(stack))
    )
    _check("batched 64x256² vs per-frame pipeline", d <= 1,
           f"max |diff| {d} counts (bound 1), first call {dt:.2f} s")

    # --tile 1024 on 4096²: vs the global tapered restore, affine-aligned
    img = blurred_scene(4096, 4096, 15, 30.0, SEED + 3)
    t0 = time.perf_counter()
    tiled = tiled_restore_image(img, 15, 30.0, K, tile=1024)
    dt = time.perf_counter() - t0
    glob = WienerDeblurPipeline(edgetaper=True).restore(img, 15, 30.0, K)
    p = psnr(glob.astype(float), _affine_align(glob.astype(float), tiled.astype(float)),
             peak=255.0)
    _check("tile 1024 on 4096² vs global tapered restore", p > 26.0,
           f"PSNR {p:.2f} dB after affine align (bound > 26), first call {dt:.2f} s")

    # --pad smooth on 3840x2160 vs a float64 restore at the same extents
    h, w = 2160, 3840
    img = blurred_scene(h, w, 25, 30.0, SEED + 4)
    hp, wp = pad_extents(h, w, "smooth")
    t0 = time.perf_counter()
    _, planes = WienerDeblurPipeline(pad_mode="smooth").restore_with_planes(
        img, 25, 30.0, K
    )
    dt = time.perf_counter() - t0
    psf = motion_blur_kernel_oracle(25, 30.0).astype(np.float64)
    pp = np.zeros((hp, wp))
    pp[: psf.shape[0], : psf.shape[1]] = psf
    H = np.fft.fft2(pp)
    W = np.conj(H) / (np.abs(H) ** 2 + K)
    err = 0.0
    for c in range(3):
        cp = np.zeros((hp, wp))
        cp[:h, :w] = img[..., c] / 255.0
        r = np.fft.ifft2(np.fft.fft2(cp) * W).real
        r = (r - r.min()) / (r.max() - r.min())
        err = max(err, float(np.abs(planes[c] - r[:h, :w]).max()))
    _check(f"pad smooth 3840x2160 at {wp}x{hp} vs float64 restore", err < 2e-4,
           f"INF {err:.2e} (bound 2e-4), first call {dt:.2f} s")

    # --estimate-psf on a frame blurred with a known motion PSF
    img = blurred_scene(1024, 1024, 21, 30.0, SEED + 5)
    t0 = time.perf_counter()
    length, angle, conf = est.estimate_motion_psf(img)
    dt = time.perf_counter() - t0
    da = abs((angle - 30.0) % 180.0)
    da = min(da, 180.0 - da)
    _check("estimate-psf on PSF(21, 30°)", abs(length - 21) <= 2 and da <= 3.0,
           f"length {length}, angle {angle:.1f}, z {conf:.1f} "
           f"(bounds ±2 px, ±3°), {dt:.2f} s")


def phase_sharded():
    import jax
    import jax.numpy as jnp

    from fft_restoration_tpu.models.batched import BatchedWienerPipeline
    from fft_restoration_tpu.models.pipeline import WienerDeblurPipeline
    from fft_restoration_tpu.oracle.psf import motion_blur_kernel_oracle
    from fft_restoration_tpu.parallel.mesh import make_mesh, make_mesh2d
    from fft_restoration_tpu.parallel.sharded_pipeline import (
        ShardedWienerPipeline,
        sharded_batched_restore_images,
        sharded_batched_restore_planes,
    )
    from fft_restoration_tpu.utils.blurgen import blurred_scene
    from fft_restoration_tpu.utils.trace_profile import (
        _load_trace,
        device_events,
    )

    n = 2048
    img = blurred_scene(n, n, PSF_LEN, PSF_ANGLE, SEED)
    sp = ShardedWienerPipeline(mesh=make_mesh(4))
    t0 = time.perf_counter()
    out_s, planes_s = sp.restore_with_planes(img, PSF_LEN, PSF_ANGLE, K)
    dt = time.perf_counter() - t0
    out_1, planes_1 = WienerDeblurPipeline().restore_with_planes(img, PSF_LEN, PSF_ANGLE, K)
    inf = float(np.abs(planes_s - planes_1).max())
    _check("sharded 2048² on a 4-card rows mesh vs single card", inf <= 1e-3,
           f"INF {inf:.2e} on the planes (bound 1e-3), first call {dt:.2f} s")
    _u8_cmp("sharded u8 vs single card", out_s, out_1, 1)

    fn = sp._compiled(n, n, PSF_LEN)
    x = sp._put(img)
    args = (x, jnp.float32(PSF_ANGLE), jnp.float32(K))
    jax.block_until_ready(fn(*args))
    iters = 10
    t0 = time.perf_counter()
    for _ in range(iters):
        r = fn(*args)
    jax.block_until_ready(r)
    ms = (time.perf_counter() - t0) / iters * 1e3
    with tempfile.TemporaryDirectory() as d:
        with jax.profiler.trace(d):
            for _ in range(iters):
                r = fn(*args)
            jax.block_until_ready(r)
        evs = device_events(_load_trace(d))
    # NCCL kernels, split into the all_to_all HLO ops (named
    # "all_to_all.N" in the trace) and the other collectives
    # (pmin/pmax and GSPMD's all-reduce / all-gather)
    nccl = [e for e in evs if "nccl" in e.get("name", "").lower()]
    a2a = [
        e for e in nccl
        if "all_to_all" in str(e.get("args", {}).get("hlo_op", ""))
    ]
    other_ms = (sum(e["dur"] for e in nccl) - sum(e["dur"] for e in a2a)) / 1e3 / iters / 4
    # 3 all_to_all exchanges per restore (conv layout): image forward
    # 4 planes (2 packed channel pairs x re/im), PSF forward 2, inverse 4;
    # each card sends (D-1)/D of its share of every plane
    d_ = 4
    a2a_bytes = 10 * n * n * 4 * (d_ - 1) // d_
    if a2a:
        lanes = {e["pid"] for e in a2a}
        a2a_ms = sum(e["dur"] for e in a2a) / 1e3 / iters / len(lanes)
        a2a_time = (
            f"{a2a_ms:.3f} ms per restore per card ({len(a2a)} trace events; "
            f"other collectives {other_ms:.3f} ms per card)"
        )
    else:
        # kernels launched inside a CUDA graph show as one event; run with
        # XLA_FLAGS=--xla_gpu_enable_command_buffer= to see collectives
        a2a_time = "time not measured (no collective events in the trace)"
    _say(
        f"  all_to_all: {a2a_bytes / 1e6:.1f} MB per restore across the mesh, "
        f"{a2a_time}; sharded restore {ms:.3f} ms end to end"
    )

    stack = np.stack([blurred_scene(1024, 1024, 15, 30.0, SEED + 20 + i) for i in range(8)])
    psf = motion_blur_kernel_oracle(15, 30.0)
    mesh2 = make_mesh2d(2, 2)
    t0 = time.perf_counter()
    outs = sharded_batched_restore_images(stack, psf, K, mesh=mesh2)
    dt = time.perf_counter() - t0
    ref = BatchedWienerPipeline().restore(stack, 15, 30.0, K)
    _u8_cmp("(2, 2) batch x rows 8x1024² vs single-card batched", outs, ref, 1)
    chans = np.moveaxis(stack.astype(np.float32) / np.float32(255.0), -1, 1)
    p_s = sharded_batched_restore_planes(chans, psf, K, mesh=mesh2)
    p_1 = BatchedWienerPipeline().restore_planes(stack, 15, 30.0, K)
    inf = float(np.abs(p_s - p_1).max())
    _check("(2, 2) planes vs single-card batched", inf <= 1e-3,
           f"INF {inf:.2e} (bound 1e-3), first call {dt:.2f} s")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4: run only the four-card sharded phase")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    try:
        import jax

        from fft_restoration_tpu.cli import _enable_compile_cache
    except ImportError as e:
        print(f"chip_smoke: cannot import the program: {e}", file=sys.stderr)
        return 2
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devs[0].platform!r})",
              file=sys.stderr)
        return 1
    if len(devs) < args.chips:
        print(f"chip_smoke: --chips {args.chips} needs {args.chips} GPUs, "
              f"JAX sees {len(devs)}", file=sys.stderr)
        return 1
    _enable_compile_cache()
    device = {"platform": devs[0].platform, "kind": devs[0].device_kind,
              "count": len(devs)}
    _say(f"[device] {device}, XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    _say(f"[card] {_card()}")

    with tempfile.TemporaryDirectory() as tmp:
        if args.chips == 4:
            phases = [("sharded", phase_sharded)]
        else:
            phases = [
                ("library", phase_library),
                ("kernels", phase_kernels),
                ("cli", lambda: phase_cli(tmp)),
                ("serve", phase_serve),
                ("surfaces", phase_surfaces),
            ]
        failed = []
        for name, fn in phases:
            _say(f"[{name}]")
            t0 = time.perf_counter()
            try:
                fn()
            except Exception:  # report every phase, then fail the run
                traceback.print_exc()
                failed.append(name)
            _say(f"[{name}] {'FAILED' if name in failed else 'passed'} in "
                 f"{time.perf_counter() - t0:.1f} s")
    _say(f"[card] {_card()}")
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
