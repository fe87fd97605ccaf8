"""Minimal production serving endpoint (stdlib HTTP, no dependencies).

The reference is a single-shot CLI (serial.cpp:9); this is the serving
counterpart the framework is built for: one process per device behind a
load balancer (docs/SERVING.md), compiled executables warmed at startup,
uint8 ingest straight to the device.

    python -m fft_restoration_tpu.serve --port 8571 \\
        --psf-length 50 --psf-angle 30 \\
        --warmup 2048x2048 782x1920

API:
  POST /restore            body = image bytes (PNG/JPEG/BMP/PNM/TIFF);
                           query params psf_length, psf_angle, K
                           override the defaults; filter=wiener|inverse|
                           cls|rl (+iters=N for rl), edgetaper=1 (border
                           blend, models/edgetaper.py), estimate=1
                           (blind per-request PSF estimation for the
                           selected psf_type — motion length/angle,
                           disk size, or gaussian sigma,
                           models/estimate.py — psf_length/psf_angle are
                           then ignored), psf_type=motion|gaussian|disk
                           (gaussian reuses psf_angle as sigma),
                           auto_k=1 (noise-adaptive K from the frame's
                           Immerkaer sigma — K is then ignored),
                           tile=N [tile_overlap=M] (device-resident
                           tiled restore for giant frames,
                           models/tiled.py — bypasses the batcher;
                           edgetaper= is ignored there, every tile is
                           tapered by construction; raise
                           --max-body-mb for giant uploads; the FIRST
                           request per frame shape compiles under the
                           device lock — send a warmup request before
                           taking traffic).
                           Response: PNG bytes.
  GET  /healthz            JSON liveness + device + compiled-shape list
                           + queue depth / batch occupancy + rolling
                           p50/p95/p99 request latency (1024-window).

Concurrency: requests are served on a thread pool; device work is
serialized per process around the single device context. Concurrent
same-shape requests are DYNAMICALLY BATCHED: a dispatcher thread groups
requests by (shape, PSF, K) within a short gather window and runs them
through BatchedWienerPipeline as one stack (models/batched.py), so
co-batched frames share one dispatch and one PSF transform. Scale out
further with one process per device (docs/SERVING.md).
"""

from __future__ import annotations

import argparse
import collections
import json
import queue as queue_mod
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="fft_restoration_tpu.serve")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8571)
    p.add_argument("--psf-length", type=int, default=50)
    p.add_argument("--psf-angle", type=float, default=30.0)
    p.add_argument("-K", type=float, default=0.01)
    from fft_restoration_tpu.ops.fft import DEFAULT_FFT_BACKEND, FFT_BACKENDS

    p.add_argument(
        "--backend", choices=FFT_BACKENDS, default=DEFAULT_FFT_BACKEND
    )
    p.add_argument(
        "--max-rl-iters",
        type=int,
        default=100,
        help="cap on the per-request Richardson-Lucy iteration count "
        "(device time is linear in iters; an uncapped request would be "
        "a device-time DoS while the dispatcher holds the lock)",
    )
    p.add_argument(
        "--max-body-mb",
        type=float,
        default=64.0,
        help="reject request bodies above this size with HTTP 413",
    )
    p.add_argument(
        "--max-batch",
        type=int,
        default=16,
        help="dynamic batching: max frames per device dispatch",
    )
    p.add_argument(
        "--batch-wait-ms",
        type=float,
        default=4.0,
        help="dynamic batching: gather window for co-batchable requests",
    )
    p.add_argument(
        "--pad",
        choices=("pow2", "smooth"),
        default="pow2",
        help="DFT pad extents: 'smooth' = minimal odd*2^k (UHD "
        "restores 1.9x fewer pixels); the restoration then matches the "
        "oracle at the smooth extents rather than the pow2 ones",
    )
    p.add_argument("--no-white-balance", action="store_true")
    p.add_argument(
        "--warmup",
        nargs="*",
        default=[],
        metavar="HxW[@tileN]",
        help="frame geometries (HEIGHTxWIDTH) to pre-compile at "
        "startup; 'HxW@tileN' pre-compiles the tiled graph for that "
        "frame shape (tile=N requests then start warm)",
    )
    return p


class _Req:
    """One in-flight restoration request awaiting batch dispatch."""

    __slots__ = (
        "img", "length", "angle", "K", "opts", "done", "result", "error"
    )

    def __init__(
        self, img, length, angle, K,
        opts=("wiener", 10, False, "motion"),
    ):
        self.img = img
        self.length = length
        self.angle = angle
        self.K = K
        self.opts = opts  # (filter_name, rl_iters, edgetaper, psf_type)
        self.done = threading.Event()
        self.result = None
        self.error = None

    def key(self):
        return (self.img.shape, self.length, self.angle, self.K, self.opts)


class DynamicBatcher:
    """Groups concurrent same-(shape, PSF, K) requests into device batches.

    A dispatcher thread drains the inbound queue, waits up to
    `max_wait_ms` for co-batchable arrivals, groups by request key and
    dispatches the largest group as ONE BatchedWienerPipeline stack
    (batch padded up to a power-of-two bucket so the number of compiled
    executables stays logarithmic in max_batch). Group size 1 falls
    through to the single-frame pipeline. The reference has no server at all (single-shot
    CLIs, serial.cpp:9); this is the production-throughput counterpart.
    """

    def __init__(self, service, max_batch: int, max_wait_ms: float):
        self.service = service
        self.max_batch = max(1, int(max_batch))
        self.max_wait_s = max_wait_ms / 1e3
        self.inbox = queue_mod.Queue()
        self.pending = collections.deque()
        self.batches_dispatched = 0
        self.frames_batched = 0
        self.stop = False
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def submit(
        self, img, length, angle, K,
        opts=("wiener", 10, False, "motion"),
    ):
        if self.stop or not self.thread.is_alive():
            # fail fast instead of blocking forever on a dead dispatcher
            raise RuntimeError("service is shutting down")
        req = _Req(img, int(length), float(angle), float(K), opts)
        self.inbox.put(req)
        req.done.wait()
        if req.error is not None:
            raise req.error
        return req.result

    def queue_depth(self) -> int:
        return self.inbox.qsize() + len(self.pending)

    def _gather(self):
        """Block for one request, then keep draining until the wait
        window closes or max_batch co-batchable requests are in hand."""
        try:
            first = self.pending.popleft()
        except IndexError:
            first = self.inbox.get()
            if first is None:
                return None
        group = [first]
        rest = []
        deadline = time.perf_counter() + self.max_wait_s
        while len(group) < self.max_batch:
            timeout = deadline - time.perf_counter()
            # drain co-batchable pendings first
            for _ in range(len(self.pending)):
                r = self.pending.popleft()
                if r.key() == first.key() and len(group) < self.max_batch:
                    group.append(r)
                else:
                    rest.append(r)
            if len(group) >= self.max_batch:
                break
            try:
                r = self.inbox.get(timeout=max(timeout, 0.0))
            except queue_mod.Empty:
                break
            if r is None:
                self.stop = True
                break
            if r.key() == first.key():
                group.append(r)
            else:
                rest.append(r)
        self.pending.extend(rest)
        return group

    def _run(self):
        try:
            self._run_loop()
        finally:
            # however the loop exits (shutdown consumed mid-gather, or a
            # non-Exception error), no waiter may be left blocked: fail
            # everything still queued or deferred in pending
            err = RuntimeError("service is shutting down")
            leftovers = list(self.pending)
            self.pending.clear()
            while True:
                try:
                    r = self.inbox.get_nowait()
                except queue_mod.Empty:
                    break
                if r is not None:
                    leftovers.append(r)
            for r in leftovers:
                r.error = err
                r.done.set()

    def _run_loop(self):
        import numpy as np

        while not self.stop:
            group = self._gather()
            if not group:
                if self.stop:
                    return
                continue
            svc = self.service
            try:
                if len(group) == 1:
                    r = group[0]
                    with svc.lock:
                        out = svc.pipe_for(r.opts).restore(
                            r.img, r.length, r.angle, r.K
                        )
                        svc.n_served += 1
                    # singles count as batch-of-1 dispatches so
                    # batch_occupancy ~1.0 really means "paying per-frame
                    # dispatch" (docs/SERVING.md's monitoring signal)
                    self.batches_dispatched += 1
                    self.frames_batched += 1
                    results = [out]
                else:
                    # pow2 bucket: pad by repeating the last frame so the
                    # compiled-batch-size set stays small
                    b = len(group)
                    bucket = 1
                    while bucket < b:
                        bucket <<= 1
                    stack = np.stack(
                        [r.img for r in group]
                        + [group[-1].img] * (bucket - b)
                    )
                    r0 = group[0]
                    with svc.lock:
                        outs = svc.batched_for(r0.opts).restore(
                            stack, r0.length, r0.angle, r0.K
                        )
                        svc.n_served += b
                    self.batches_dispatched += 1
                    self.frames_batched += b
                    results = list(outs[:b])
                for r, out in zip(group, results):
                    r.result = out
                    r.done.set()
            except Exception as e:  # deliver the failure to every waiter
                for r in group:
                    r.error = e
                    r.done.set()

    def shutdown(self):
        self.stop = True
        self.inbox.put(None)
        self.thread.join(timeout=30.0)
        # catch any request that raced past submit()'s stop check after
        # the dispatcher's own drain finished
        while True:
            try:
                r = self.inbox.get_nowait()
            except queue_mod.Empty:
                break
            if r is not None:
                r.error = RuntimeError("service is shutting down")
                r.done.set()


class RestorationService:
    """Pipelines + lock + stats; shared by all request threads."""

    def __init__(self, args):
        from fft_restoration_tpu.models.batched import BatchedWienerPipeline
        from fft_restoration_tpu.models.pipeline import WienerDeblurPipeline

        self.args = args
        pad_mode = getattr(args, "pad", "pow2")
        self.pipe = WienerDeblurPipeline(
            fft_backend=args.backend,
            white_balance=not args.no_white_balance,
            # serving graph: ship the uint8 image only — skips the
            # 50 MB/frame diagnostic planes materialization
            emit_planes=False,
            pad_mode=pad_mode,
        )
        self.batched = BatchedWienerPipeline(
            fft_backend=args.backend,
            white_balance=not args.no_white_balance,
            emit_planes=False,
            pad_mode=pad_mode,
        )
        # per-(filter, iters, edgetaper, psf_type) pipeline caches; the defaults
        # above stay the warm/startup instances
        self._pipes = {("wiener", 10, False, "motion"): self.pipe}
        self._batcheds = {("wiener", 10, False, "motion"): self.batched}
        self.lock = threading.Lock()
        self.n_served = 0
        self.started = time.time()
        # rolling window of end-to-end request latencies (decode ->
        # restored PNG) for the /healthz percentiles; deque append is
        # GIL-atomic, so no extra lock on the hot path
        from collections import deque

        self._latencies = deque(maxlen=1024)
        self.max_body = int(args.max_body_mb * 1024 * 1024)
        import jax

        self.device_str = str(jax.devices()[0])
        self.batcher = DynamicBatcher(
            self, max_batch=args.max_batch, max_wait_ms=args.batch_wait_ms
        )

    # per-option pipeline caches are bounded: beyond this many distinct
    # (filter, iters, edgetaper, psf_type) combinations the oldest non-default
    # entry is evicted (each entry holds compiled executables)
    _MAX_OPT_PIPES = 16

    def _evict(self, cache):
        if len(cache) >= self._MAX_OPT_PIPES:
            for k in cache:
                if k != ("wiener", 10, False, "motion"):
                    del cache[k]
                    break

    def pipe_for(self, opts):
        """Single-frame pipeline for (filter_name, rl_iters, edgetaper,
        psf_type); lazily built, cached (bounded) for the service
        lifetime."""
        if opts not in self._pipes:
            self._evict(self._pipes)
            from fft_restoration_tpu.models.pipeline import (
                WienerDeblurPipeline,
            )

            f, iters, taper, ptype = opts
            self._pipes[opts] = WienerDeblurPipeline(
                fft_backend=self.args.backend,
                filter_name=f,
                white_balance=not self.args.no_white_balance,
                emit_planes=False,
                pad_mode=getattr(self.args, "pad", "pow2"),
                rl_iters=iters,
                edgetaper=taper,
                psf_type=ptype,
            )
        return self._pipes[opts]

    def batched_for(self, opts):
        if opts not in self._batcheds:
            self._evict(self._batcheds)
            from fft_restoration_tpu.models.batched import (
                BatchedWienerPipeline,
            )

            f, iters, taper, ptype = opts
            self._batcheds[opts] = BatchedWienerPipeline(
                fft_backend=self.args.backend,
                filter_name=f,
                white_balance=not self.args.no_white_balance,
                emit_planes=False,
                pad_mode=getattr(self.args, "pad", "pow2"),
                rl_iters=iters,
                edgetaper=taper,
                psf_type=ptype,
            )
        return self._batcheds[opts]

    def warm(self, shapes) -> None:
        import numpy as np

        rng = np.random.default_rng(0)
        for spec in shapes:
            spec = spec.lower()
            tile = 0
            if "@tile" in spec:
                # "HxW@tileN": pre-compile the device-resident tiled
                # graph for that frame shape (otherwise the FIRST tile=N
                # request compiles under the device lock — minutes cold)
                spec, tile_s = spec.split("@tile", 1)
                tile = int(tile_s)
            h, w = (int(v) for v in spec.split("x"))
            t0 = time.perf_counter()
            frame = (rng.random((h, w, 3)) * 255).astype("uint8")
            if tile:
                from fft_restoration_tpu.models.tiled import (
                    tiled_restore_image,
                )

                with self.lock:
                    tiled_restore_image(
                        frame,
                        self.args.psf_length,
                        self.args.psf_angle,
                        self.args.K,
                        tile=tile,
                        fft_backend=self.args.backend,
                        white_balance=not self.args.no_white_balance,
                    )
                print(
                    f"[serve] warmed H={h} W={w} tile={tile} in "
                    f"{time.perf_counter() - t0:.1f}s",
                    file=sys.stderr,
                )
                continue
            with self.lock:
                self.pipe.restore(
                    frame,
                    self.args.psf_length,
                    self.args.psf_angle,
                    self.args.K,
                )
            print(
                f"[serve] warmed H={h} W={w} in "
                f"{time.perf_counter() - t0:.1f}s",
                file=sys.stderr,
            )
            if self.args.max_batch < 2:
                continue
            # also warm the first co-batch bucket: otherwise the FIRST
            # pair of concurrent requests triggers a fresh compile while
            # the dispatcher holds the lock, stalling every in-flight
            # request. Larger buckets (4, 8, ...) still compile on demand.
            t0 = time.perf_counter()
            with self.lock:
                self.batched.restore(
                    np.stack([frame, frame]),
                    self.args.psf_length,
                    self.args.psf_angle,
                    self.args.K,
                )
            print(
                f"[serve] warmed batch=2 H={h} W={w} in "
                f"{time.perf_counter() - t0:.1f}s",
                file=sys.stderr,
            )

    def restore(
        self, blob: bytes, length: int, angle: float, K: float,
        opts=("wiener", 10, False, "motion"), estimate: bool = False,
        auto_k: bool = False, tile: int = 0, tile_overlap=None,
    ) -> bytes:
        import numpy as np

        from fft_restoration_tpu.utils.imageio import decode_image_bgr, encode_png

        t_req = time.perf_counter()
        # Shared decoder with cli/imread: same format dispatch, same
        # channel canonicalisation (gray / gray+alpha / RGBA -> 3ch BGR),
        # decoder-internal failures normalised to ValueError -> HTTP 400.
        img = decode_image_bgr(blob)
        if estimate:
            from fft_restoration_tpu.models import estimate as est

            backend = self.args.backend
            ptype = opts[3]
            # under the device lock: estimation is device work and the
            # module contract serializes device work per process.
            # Estimated sizes are bounded at 128: they feed psf_length
            # into the compile cache (huge PSFs = huge kernels)
            with self.lock:
                if ptype == "gaussian":
                    sigma, _conf = est.estimate_gaussian_psf(
                        img, fft_backend=backend
                    )
                    length = min(est.gaussian_ksize(sigma), 128)
                    angle = sigma
                elif ptype == "disk":
                    length, _conf = est.estimate_disk_psf(
                        img, fft_backend=backend, max_size=128
                    )
                else:
                    length, angle, _conf = est.estimate_motion_psf(
                        img, fft_backend=backend, max_length=128
                    )
        if auto_k:
            from fft_restoration_tpu.models.estimate import estimate_noise_K

            # K is rounded to 2 significant digits by the estimator, so
            # same-noise-level requests keep co-batching (K is part of
            # the batch key)
            with self.lock:
                _sigma, K = estimate_noise_K(img)
        if tile:
            # giant frames route through the device-resident tiled
            # restore (models/tiled.py) — the frame's own tiles are the
            # batch, so it bypasses the request batcher; validation
            # errors surface as ValueError -> HTTP 400
            from fft_restoration_tpu.models.tiled import (
                tiled_restore_image,
            )

            f, iters, taper, ptype = opts
            with self.lock:
                out = tiled_restore_image(
                    img, length, angle, K,
                    tile=tile, overlap=tile_overlap,
                    fft_backend=self.args.backend,
                    filter_name=f, rl_iters=iters, psf_type=ptype,
                    white_balance=not self.args.no_white_balance,
                )
                self.n_served += 1
            png = encode_png(out[..., ::-1])
            self._latencies.append((time.perf_counter() - t_req) * 1e3)
            return png
        out = self.batcher.submit(
            np.ascontiguousarray(img), length, angle, K, opts
        )
        png = encode_png(out[..., ::-1])  # BGR -> RGB PNG
        self._latencies.append((time.perf_counter() - t_req) * 1e3)
        return png

    def health(self) -> dict:
        import numpy as np

        def _tiled_cache():
            from fft_restoration_tpu.models.tiled import _DEVICE_FN_CACHE

            return _DEVICE_FN_CACHE

        b = self.batcher
        lat = np.asarray(self._latencies, np.float64)
        lat_ms = (
            {
                "p50": round(float(np.percentile(lat, 50)), 1),
                "p95": round(float(np.percentile(lat, 95)), 1),
                "p99": round(float(np.percentile(lat, 99)), 1),
                "window": int(lat.size),
            }
            if lat.size
            else None
        )
        return {
            "status": "ok",
            "backend": self.args.backend,
            "device": self.device_str,
            "compiled_shapes": sorted(
                f"{h}x{w}" for (h, w, *_rest) in self.pipe._cache
            ),
            # tiled compiles live in models/tiled's own cache — surface
            # them so compile churn on the giant-frame path is visible
            "tiled_shapes": sorted(
                f"{h}x{w}" for (h, w, *_rest) in _tiled_cache()
            ),
            "served": self.n_served,
            "uptime_s": round(time.time() - self.started, 1),
            "latency_ms": lat_ms,
            "queue_depth": b.queue_depth(),
            "batches_dispatched": b.batches_dispatched,
            "frames_batched": b.frames_batched,
            "batch_occupancy": round(
                b.frames_batched / b.batches_dispatched, 2
            )
            if b.batches_dispatched
            else None,
        }


def make_handler(service: RestorationService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # quiet access log to stderr
            print("[serve]", fmt % a, file=sys.stderr)

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if urlparse(self.path).path != "/healthz":
                self._send(404, b'{"error": "not found"}', "application/json")
                return
            self._send(
                200,
                json.dumps(service.health()).encode(),
                "application/json",
            )

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/restore":
                self._send(404, b'{"error": "not found"}', "application/json")
                return
            q = parse_qs(url.query)

            def one(name, cast, default):
                try:
                    return cast(q[name][0]) if name in q else default
                except (TypeError, ValueError):
                    raise ValueError(f"bad query param {name!r}")

            try:
                length = one("psf_length", int, service.args.psf_length)
                angle = one("psf_angle", float, service.args.psf_angle)
                K = one("K", float, service.args.K)
                filt = one("filter", str, "wiener")
                if filt not in ("wiener", "inverse", "cls", "rl"):
                    raise ValueError(f"bad query param 'filter'")
                iters = one("iters", int, 10)
                if filt != "rl":
                    # iters is meaningless for one-shot filters: pin it
                    # so ?filter=wiener&iters=N sweeps can't mint
                    # per-value pipeline cache entries
                    iters = 10
                max_iters = getattr(service.args, "max_rl_iters", 100)
                if not 1 <= iters <= max_iters:
                    raise ValueError(
                        f"bad query param 'iters' (1..{max_iters})"
                    )
                taper = bool(one("edgetaper", int, 0))
                ptype = one("psf_type", str, "motion")
                if ptype not in ("motion", "gaussian", "disk"):
                    raise ValueError("bad query param 'psf_type'")
                estimate = bool(one("estimate", int, 0))
                auto_k = bool(one("auto_k", int, 0))
                tile = one("tile", int, 0)
                if tile and not 128 <= tile <= 4096:
                    raise ValueError(
                        "bad query param 'tile' (pow2 in 128..4096, or 0)"
                    )
                tile_overlap = one("tile_overlap", int, None)
                n = int(self.headers.get("Content-Length", 0))
                if n <= 0:
                    raise ValueError("empty body")
                if n > service.max_body:
                    self._send(
                        413,
                        json.dumps(
                            {"error": f"body exceeds {service.max_body} bytes"}
                        ).encode(),
                        "application/json",
                    )
                    return
                blob = self.rfile.read(n)
                png = service.restore(
                    blob, length, angle, K,
                    opts=(filt, iters, taper, ptype), estimate=estimate,
                    auto_k=auto_k, tile=tile, tile_overlap=tile_overlap,
                )
            except ValueError as e:
                self._send(
                    400,
                    json.dumps({"error": str(e)}).encode(),
                    "application/json",
                )
                return
            except RuntimeError as e:  # dispatcher gone / shutting down
                self._send(
                    503,
                    json.dumps({"error": str(e)}).encode(),
                    "application/json",
                )
                return
            self._send(200, png, "image/png")

    return Handler


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from fft_restoration_tpu.cli import _enable_compile_cache

    _enable_compile_cache()
    service = RestorationService(args)
    if args.warmup:
        service.warm(args.warmup)
    server = ThreadingHTTPServer((args.host, args.port), make_handler(service))
    print(
        f"[serve] listening on {args.host}:{server.server_address[1]} "
        f"(backend={args.backend}, PSF {args.psf_length}@{args.psf_angle})",
        file=sys.stderr,
    )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        service.batcher.shutdown()
        server.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
