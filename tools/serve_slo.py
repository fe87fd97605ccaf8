"""Serving SLO measurement for fft_restoration_tpu.serve.

Hits a running serve.py with concurrent mixed load and records
client-side percentiles per phase plus the server's own /healthz rolling
window:

  phase "batch":  co-batchable duplicates (same shape/PSF/K) from N
                  threads — exercises the dynamic batcher;
  phase "mixed":  six request classes concurrently — wiener, rl,
                  edgetaper, auto_k all on the SAME small body
                  (isolating option cost), plus wiener/edgetaper on
                  the big body (isolating frame size);
  phase "giant":  one tile= giant frame riding alongside small
                  co-batchable requests (the batcher bypass path).

Bodies are made from a seed (utils/blurgen.py) at the reference's input
shapes: 640x330 (small) and 1920x782 (big), plus a 4096x6144 giant.

Usage (server first, then this, same machine):

  python -m fft_restoration_tpu.serve --port 8571 \
      --max-body-mb 160 --warmup 330x640 782x1920 4096x6144@tile1024
  python tools/serve_slo.py --port 8571 --out serve_slo.json

Timings are host wall-clock on the client side, so record the card name
and power limit beside them.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np


def _pct(xs, p):
    return float(np.percentile(np.asarray(xs, np.float64), p))


def _summary(lat_ms):
    lat_ms = sorted(lat_ms)
    return {
        "n": len(lat_ms),
        "p50_ms": round(_pct(lat_ms, 50), 1),
        "p95_ms": round(_pct(lat_ms, 95), 1),
        "p99_ms": round(_pct(lat_ms, 99), 1),
        "min_ms": round(lat_ms[0], 1),
        "max_ms": round(lat_ms[-1], 1),
    }


class Client:
    def __init__(self, base):
        self.base = base
        self.errors = []
        self.lock = threading.Lock()

    def post(self, path, body, timeout=600):
        t0 = time.perf_counter()
        req = urllib.request.Request(
            self.base + path, data=body,
            headers={"Content-Type": "application/octet-stream"},
        )
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                r.read()
                code = r.status
        except urllib.error.HTTPError as e:
            code = e.code
            e.read()
        except Exception as e:  # noqa: BLE001 - record, keep loading
            with self.lock:
                self.errors.append(repr(e))
            return None
        dt = (time.perf_counter() - t0) * 1e3
        if code != 200:
            with self.lock:
                self.errors.append(f"HTTP {code} {path}")
            return None
        return dt

    def healthz(self):
        with urllib.request.urlopen(self.base + "/healthz", timeout=60) as r:
            return json.loads(r.read())


def _bmp(img):
    from fft_restoration_tpu.utils.formats import encode_bmp

    return encode_bmp(img)


def run(port: int, out_path: str):
    base = f"http://127.0.0.1:{port}"
    cli = Client(base)

    # bodies made from a seed at the reference's input shapes
    from fft_restoration_tpu.utils.blurgen import blurred_scene
    from fft_restoration_tpu.utils.imageio import encode_png

    small = encode_png(blurred_scene(330, 640, 40, 45.0, 1)[..., ::-1])
    smooth = encode_png(blurred_scene(782, 1920, 50, 30.0, 2)[..., ::-1])
    rng = np.random.default_rng(0)
    giant = _bmp((rng.random((4096, 6144, 3)) * 255).astype(np.uint8))

    print("waiting for server ...", flush=True)
    deadline = time.time() + 7200
    while True:
        try:
            h = cli.healthz()
            if h.get("status") == "ok":
                break
        except Exception:
            pass
        if time.time() > deadline:
            print("server never became ready", file=sys.stderr)
            return 1
        time.sleep(5)
    print("server ready:", json.dumps(cli.healthz())[:400], flush=True)

    report = {"ts": time.time(), "port": port, "phases": {}}

    # Phase 1 — co-batchable duplicates: 32 identical requests, 8 threads
    def small_req():
        return cli.post("/restore", small)

    # warm the request path once (first request may compile nothing but
    # fills codec/pipeline caches)
    small_req()

    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(8) as ex:
        lat = [f.result() for f in [ex.submit(small_req) for _ in range(32)]]
    lat = [x for x in lat if x is not None]
    report["phases"]["batch"] = {
        **_summary(lat),
        "wall_s": round(time.perf_counter() - t0, 2),
        "offered": 32,
        "threads": 8,
    }
    print("batch:", report["phases"]["batch"], flush=True)

    # Phase 2 — mixed classes, 6 threads x 24 requests round-robin.
    # De-confound option cost from frame size: every option class posts
    # the SAME small body so the per-class columns isolate option cost;
    # the two *_big classes isolate frame size on the same option.
    classes = [
        ("wiener", "/restore", small),
        ("rl", "/restore?filter=rl&iters=3", small),
        ("edgetaper", "/restore?edgetaper=1", small),
        ("auto_k", "/restore?auto_k=1", small),
        ("wiener_big", "/restore", smooth),
        ("edgetaper_big", "/restore?edgetaper=1", smooth),
    ]
    per_class = {name: [] for name, _, _ in classes}

    def mixed_req(i):
        name, path, body = classes[i % len(classes)]
        dt = cli.post(path, body)
        if dt is not None:
            per_class[name].append(dt)
        return dt

    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(6) as ex:
        lat = [f.result() for f in [ex.submit(mixed_req, i) for i in range(36)]]
    lat = [x for x in lat if x is not None]
    report["phases"]["mixed"] = {
        **_summary(lat),
        "wall_s": round(time.perf_counter() - t0, 2),
        "offered": 36,
        "threads": 6,
        "per_class_p50_ms": {
            k: round(_pct(v, 50), 1) for k, v in per_class.items() if v
        },
    }
    print("mixed:", report["phases"]["mixed"], flush=True)

    # Phase 3 — one giant tiled frame alongside small co-batchables
    giant_lat = []

    def giant_req():
        dt = cli.post("/restore?tile=1024", giant, timeout=1800)
        if dt is not None:
            giant_lat.append(dt)

    t0 = time.perf_counter()
    gt = threading.Thread(target=giant_req)
    gt.start()
    time.sleep(0.5)  # let the giant hit the device lock first
    with cf.ThreadPoolExecutor(4) as ex:
        lat = [f.result() for f in [ex.submit(small_req) for _ in range(8)]]
    gt.join()
    lat = [x for x in lat if x is not None]
    report["phases"]["giant"] = {
        "small_alongside": _summary(lat) if lat else None,
        "giant_ms": round(giant_lat[0], 1) if giant_lat else None,
        "giant_mp": round(4096 * 6144 / 1e6, 1),
        "wall_s": round(time.perf_counter() - t0, 2),
    }
    print("giant:", report["phases"]["giant"], flush=True)

    h = cli.healthz()
    report["healthz"] = {
        k: h.get(k)
        for k in ("latency_ms", "queue_depth", "batches_dispatched",
                  "frames_batched", "batch_occupancy", "served",
                  "compiled_shapes", "tiled_shapes", "device", "backend")
        if k in h
    }
    report["errors"] = cli.errors
    with open(out_path, "w") as f:
        json.dump(report, f, indent=1)
    print("wrote", out_path, flush=True)
    return 0 if not cli.errors else 2


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=8571)
    ap.add_argument("--out", default="serve_slo.json")
    a = ap.parse_args()
    sys.exit(run(a.port, a.out))
