"""HTTP serving endpoint (fft_restoration_tpu/serve.py)."""

import http.client
import json
import threading
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

from fft_restoration_tpu.serve import (
    RestorationService,
    build_parser,
    make_handler,
)
from fft_restoration_tpu.utils.imageio import decode_png, encode_png
from fft_restoration_tpu.utils import formats


@pytest.fixture(scope="module")
def server():
    args = build_parser().parse_args(
        ["--backend", "matmul", "--psf-length", "5", "--psf-angle", "30"]
    )
    service = RestorationService(args)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv.server_address
    srv.shutdown()
    srv.server_close()
    service.batcher.shutdown()


def _post(addr, path, body):
    conn = http.client.HTTPConnection(*addr, timeout=120)
    conn.request("POST", path, body=body)
    r = conn.getresponse()
    data = r.read()
    conn.close()
    return r.status, data


def test_healthz(server):
    conn = http.client.HTTPConnection(*server, timeout=30)
    conn.request("GET", "/healthz")
    r = conn.getresponse()
    body = json.loads(r.read())
    conn.close()
    assert r.status == 200
    assert body["status"] == "ok"
    assert body["backend"] == "matmul"


def test_restore_png_roundtrip(server):
    rng = np.random.default_rng(0)
    img = (rng.random((24, 40, 3)) * 255).astype(np.uint8)
    status, data = _post(server, "/restore", encode_png(img))
    assert status == 200
    out = decode_png(data)
    assert out.shape == img.shape


def test_restore_bmp_with_params(server):
    rng = np.random.default_rng(1)
    img = (rng.random((16, 32, 3)) * 255).astype(np.uint8)
    status, data = _post(
        server, "/restore?psf_length=3&psf_angle=45&K=0.02",
        formats.encode_bmp(img),
    )
    assert status == 200
    assert decode_png(data).shape == img.shape


def test_restore_gif_and_pam_roundtrip(server):
    """Round-4 codecs flow through the serving surface unchanged."""
    from fft_restoration_tpu.utils.gif import encode_gif

    rng = np.random.default_rng(5)
    img = ((rng.random((16, 32, 3)) * 8).astype(np.uint8)) * 32
    status, data = _post(server, "/restore", encode_gif(img[..., ::-1]))
    assert status == 200
    assert decode_png(data).shape == img.shape
    status, data = _post(server, "/restore", formats.encode_pam(img))
    assert status == 200
    assert decode_png(data).shape == img.shape


def test_restore_matches_pipeline(server):
    """The endpoint returns exactly what the library pipeline returns."""
    from fft_restoration_tpu.models.pipeline import WienerDeblurPipeline

    rng = np.random.default_rng(2)
    img = (rng.random((20, 36, 3)) * 255).astype(np.uint8)  # RGB for PNG
    status, data = _post(server, "/restore", encode_png(img))
    assert status == 200
    got = decode_png(data)
    want_bgr = WienerDeblurPipeline(fft_backend="matmul").restore(
        img[..., ::-1].copy(), 5, 30.0
    )
    np.testing.assert_array_equal(got, want_bgr[..., ::-1])


def test_bad_requests(server):
    status, data = _post(server, "/restore", b"not an image at all")
    assert status == 400 and b"error" in data
    status, _ = _post(server, "/restore?psf_length=abc", b"x")
    assert status == 400
    status, _ = _post(server, "/nope", b"x")
    assert status == 404
    status, _ = _post(server, "/restore", b"")
    assert status == 400


def test_health_after_serving(server):
    conn = http.client.HTTPConnection(*server, timeout=30)
    conn.request("GET", "/healthz")
    body = json.loads(conn.getresponse().read())
    conn.close()
    assert body["served"] >= 1
    assert any("x" in s for s in body["compiled_shapes"])
    lat = body["latency_ms"]
    assert lat is not None and lat["window"] >= 1
    assert 0 < lat["p50"] <= lat["p95"] <= lat["p99"]


def test_restore_gray_alpha_png(server):
    """2-channel gray+alpha PNG (color type 4) restores instead of 500ing:
    serve shares imread's channel canonicalisation (advisor finding)."""
    rng = np.random.default_rng(3)
    ga = (rng.random((16, 24, 2)) * 255).astype(np.uint8)
    status, data = _post(server, "/restore", encode_png(ga))
    assert status == 200
    assert decode_png(data).shape == (16, 24, 3)


def test_restore_truncated_bmp_is_400(server):
    """Decoder-internal failures (struct/IndexError) surface as HTTP 400,
    not a dropped connection."""
    rng = np.random.default_rng(4)
    img = (rng.random((16, 32, 3)) * 255).astype(np.uint8)
    blob = formats.encode_bmp(img)[:60]  # header sniffs as BMP, body gone
    status, data = _post(server, "/restore", blob)
    assert status == 400 and b"error" in data


def test_body_too_large_is_413():
    args = build_parser().parse_args(
        ["--backend", "matmul", "--max-body-mb", "0.001"]
    )
    service = RestorationService(args)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        status, data = _post(srv.server_address, "/restore", b"x" * 4096)
        assert status == 413 and b"error" in data
    finally:
        srv.shutdown()
        srv.server_close()
        service.batcher.shutdown()


@pytest.fixture(scope="module")
def batch_server():
    args = build_parser().parse_args(
        [
            "--backend",
            "matmul",
            "--psf-length",
            "5",
            "--max-batch",
            "8",
            "--batch-wait-ms",
            "60",
        ]
    )
    service = RestorationService(args)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv.server_address, service
    srv.shutdown()
    srv.server_close()
    service.batcher.shutdown()


def test_dynamic_batching_under_load(batch_server):
    """N concurrent same-shape requests are grouped into device batches:
    healthz occupancy shows >1 frame/dispatch, every response matches the
    single-request output, and warm concurrent wall-clock stays well
    under N x the warm single-request latency."""
    import time

    addr, service = batch_server
    rng = np.random.default_rng(5)
    img = (rng.random((24, 32, 3)) * 255).astype(np.uint8)
    blob = encode_png(img)

    # warm: one single (compiles the single-frame graph), one concurrent
    # burst (compiles the pow2 batched buckets it lands in)
    status, single_out = _post(addr, "/restore", blob)
    assert status == 200

    n = 8

    def burst():
        results = [None] * n
        statuses = [None] * n

        def worker(i):
            statuses[i], results[i] = _post(addr, "/restore", blob)

        threads = [
            threading.Thread(target=worker, args=(i,)) for i in range(n)
        ]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return time.perf_counter() - t0, statuses, results

    burst()  # warm the batched executables
    # warm single-request latency
    t0 = time.perf_counter()
    status, single_out = _post(addr, "/restore", blob)
    t_single = time.perf_counter() - t0
    assert status == 200

    t_burst, statuses, results = burst()
    assert all(s == 200 for s in statuses)
    want = decode_png(single_out).astype(np.int16)
    for data in results:
        got = decode_png(data).astype(np.int16)
        # batched packing pairs planes across images; parity within the
        # reference's own INF tier (1e-3 of [0,1] ~ 0.26 uint8 levels)
        assert np.abs(got - want).max() <= 1

    conn = http.client.HTTPConnection(*addr, timeout=30)
    conn.request("GET", "/healthz")
    health = json.loads(conn.getresponse().read())
    conn.close()
    assert health["batches_dispatched"] >= 1
    assert health["frames_batched"] >= 2
    assert health["batch_occupancy"] > 1.0
    # the batch path must beat naive serialization by a wide margin;
    # allow generous CI slack vs the ideal t_single + epsilon
    assert t_burst < max(n * t_single * 0.6, t_single + 1.0)


def test_batcher_shutdown_drains_waiters():
    """Requests queued or deferred when the dispatcher stops must fail
    fast (RuntimeError -> HTTP 503), never hang on done.wait(); submits
    after shutdown fail immediately."""
    import queue as queue_mod
    import time

    from fft_restoration_tpu.serve import DynamicBatcher, _Req

    class _SlowService:
        """First dispatch blocks long enough for shutdown to land."""

        def __init__(self):
            self.lock = threading.Lock()
            self.n_served = 0
            self.release = threading.Event()
            self.pipe = self
            self.batched = self

        def pipe_for(self, opts):
            return self

        def batched_for(self, opts):
            return self

        def restore(self, img, *a):
            self.release.wait(timeout=30)
            if img.ndim == 4:
                return np.zeros_like(img)
            return np.zeros_like(img)

    svc = _SlowService()
    b = DynamicBatcher(svc, max_batch=4, max_wait_ms=1.0)
    img_a = np.zeros((8, 8, 3), np.uint8)
    img_b = np.ones((16, 8, 3), np.uint8)  # different key -> deferred

    errs = {}

    def submit(name, img):
        try:
            b.submit(img, 5, 30.0, 0.01)
            errs[name] = None
        except Exception as e:
            errs[name] = e

    t1 = threading.Thread(target=submit, args=("a", img_a))
    t1.start()
    time.sleep(0.2)  # dispatcher is now blocked inside restore(img_a)
    t2 = threading.Thread(target=submit, args=("b", img_b))
    t2.start()
    time.sleep(0.2)  # b sits in inbox/pending behind the blocked dispatch
    b.stop = True
    b.inbox.put(None)
    svc.release.set()  # let the in-flight dispatch finish
    t1.join(timeout=10)
    t2.join(timeout=10)
    assert not t1.is_alive() and not t2.is_alive(), "waiter hung"
    assert errs["a"] is None  # in-flight request completed normally
    assert isinstance(errs["b"], RuntimeError)  # drained, not hung

    with pytest.raises(RuntimeError, match="shutting down"):
        b.submit(img_a, 5, 30.0, 0.01)


def test_warm_compiles_single_and_batch_bucket():
    """--warmup must pre-compile BOTH the single-frame graph and the
    first co-batch bucket (batch=2): the first concurrent pair must not
    pay a fresh device compile while holding the service lock."""
    args = build_parser().parse_args(
        ["--backend", "matmul", "--psf-length", "5", "--psf-angle", "30"]
    )
    service = RestorationService(args)
    try:
        service.warm(["24x32"])
        assert len(service.pipe._cache) >= 1
        assert any(
            key[0][0] == 2 for key in service.batched._img_cache
        ), service.batched._img_cache.keys()
    finally:
        service.batcher.shutdown()


def test_serve_pad_smooth_roundtrip(rng):
    """--pad smooth server: a 300x380 frame restores at 384x384 smooth
    extents; the response must match the smooth-pad pipeline exactly."""
    args = build_parser().parse_args(
        ["--pad", "smooth",
         "--psf-length", "5", "--psf-angle", "30"]
    )
    service = RestorationService(args)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        img = (rng.random((300, 380, 3)) * 255).astype(np.uint8)  # RGB PNG
        status, data = _post(
            srv.server_address, "/restore", encode_png(img)
        )
        assert status == 200
        out = decode_png(data)

        from fft_restoration_tpu.models.pipeline import WienerDeblurPipeline

        pipe = WienerDeblurPipeline(pad_mode="smooth", emit_planes=False)
        # server decodes to BGR, restores, re-encodes RGB (see
        # test_restore_matches_pipeline for the convention)
        expect_bgr = pipe.restore(img[..., ::-1].copy(), 5, 30.0)
        np.testing.assert_array_equal(out, expect_bgr[..., ::-1])
    finally:
        srv.shutdown()
        srv.server_close()
        service.batcher.shutdown()


def test_restore_filter_and_taper_params(server):
    """Per-request filter/iters/edgetaper/estimate query params."""
    rng = np.random.default_rng(7)
    img = (rng.random((24, 40, 3)) * 255).astype(np.uint8)
    for qs in (
        "/restore?psf_length=3&filter=rl&iters=3",
        "/restore?psf_length=3&edgetaper=1",
        "/restore?psf_length=3&filter=cls&edgetaper=1",
    ):
        status, data = _post(server, qs, encode_png(img))
        assert status == 200, (qs, data)
        assert decode_png(data).shape == img.shape
    # invalid values are 400s, not crashes
    status, _ = _post(server, "/restore?filter=nope", encode_png(img))
    assert status == 400
    status, _ = _post(
        server, "/restore?filter=rl&iters=0", encode_png(img)
    )
    assert status == 400


def test_restore_blind_estimate(server):
    """estimate=1: the blurred frame is identified per request; the
    restoration uses the estimated parameters (positionals ignored)."""
    from fft_restoration_tpu.utils.blurgen import blur_image

    yy, xx = np.mgrid[0:128, 0:160]
    scene = np.zeros((128, 160, 3), np.float32)
    scene[..., 0] = 80 + 100 * np.sin(yy / 17.0) * np.cos(xx / 13.0)
    scene[..., 1] = 60 + 0.5 * xx
    scene[..., 2] = 70 + 0.5 * yy
    scene[40:90, 60:70] += 120
    blurred = blur_image(
        np.clip(scene, 0, 255).astype(np.uint8), 15, 30.0
    )
    status, data = _post(
        server, "/restore?psf_length=3&psf_angle=0&estimate=1",
        encode_png(blurred),
    )
    assert status == 200
    assert decode_png(data).shape == blurred.shape


def test_serve_option_hardening(server):
    """Round-3 review fixes: iters pinned for one-shot filters (no
    per-value pipeline cache growth), rl iters capped, tiny-image
    blind estimation is a 400 (degenerate cepstral annulus)."""
    rng = np.random.default_rng(11)
    img = (rng.random((24, 40, 3)) * 255).astype(np.uint8)
    # one-shot filter with a swept iters value: served fine, and no
    # (wiener, 777, *) pipeline is minted
    status, _ = _post(
        server, "/restore?psf_length=3&filter=wiener&iters=777",
        encode_png(img),
    )
    assert status == 200
    # rl iters beyond the cap is a 400
    status, _ = _post(
        server, "/restore?psf_length=3&filter=rl&iters=999",
        encode_png(img),
    )
    assert status == 400
    # blind estimation of a sub-12px frame: clean 400
    tiny = (rng.random((6, 64, 3)) * 255).astype(np.uint8)
    status, data = _post(server, "/restore?estimate=1", encode_png(tiny))
    assert status == 400 and b"too small" in data
    # psf_type family per request; per-family blind estimation works
    status, data = _post(
        server, "/restore?psf_length=5&psf_angle=1.5&psf_type=gaussian",
        encode_png(img),
    )
    assert status == 200 and decode_png(data).shape == img.shape
    status, data = _post(
        server, "/restore?psf_type=disk&estimate=1", encode_png(img)
    )
    assert status == 200 and decode_png(data).shape == img.shape
    # gaussian estimation needs min dim >= 32: clean 400 on this frame
    status, data = _post(
        server, "/restore?psf_type=gaussian&estimate=1", encode_png(img)
    )
    assert status == 400 and b"too small" in data
    status, _ = _post(
        server, "/restore?psf_type=nope", encode_png(img)
    )
    assert status == 400


def test_restore_auto_k(server):
    """auto_k=1 computes a noise-adaptive K per request (models/
    estimate.estimate_noise_K) and still returns a valid PNG."""
    rng = np.random.default_rng(11)
    img = np.clip(
        rng.random((40, 48, 3)) * 120 + rng.normal(0, 12, (40, 48, 3)),
        0, 255,
    ).astype(np.uint8)
    status, data = _post(server, "/restore?auto_k=1", encode_png(img))
    assert status == 200
    out = decode_png(data)
    assert out.shape == (40, 48, 3)
    status, _ = _post(server, "/restore?auto_k=2", encode_png(img))
    assert status == 200  # any nonzero int is truthy; 0 disables


def test_restore_tiled_param(server):
    """tile=N routes through the device-resident tiled restore; bad
    tile values are 400."""
    rng = np.random.default_rng(12)
    img = (rng.random((150, 200, 3)) * 255).astype(np.uint8)
    status, data = _post(
        server, "/restore?tile=128&tile_overlap=28", encode_png(img)
    )
    assert status == 200
    out = decode_png(data)
    assert out.shape == (150, 200, 3)
    status, _ = _post(server, "/restore?tile=64", encode_png(img))
    assert status == 400  # handler range check (128..4096)
    status, data = _post(server, "/restore?tile=192", encode_png(img))
    assert status == 400  # in range but not pow2: models/tiled ValueError
    assert b"power of two" in data
    conn = http.client.HTTPConnection(*server, timeout=30)
    conn.request("GET", "/healthz")
    health = json.loads(conn.getresponse().read())
    conn.close()
    assert "150x200" in health["tiled_shapes"]


def test_tiled_and_batched_requests_interleave(server):
    """A tiled request and normal requests in flight together: the
    shared device lock serializes them and everyone gets a 200."""
    rng = np.random.default_rng(13)
    big = (rng.random((150, 200, 3)) * 255).astype(np.uint8)
    small = (rng.random((24, 32, 3)) * 255).astype(np.uint8)
    results = {}

    def worker(name, path, img):
        results[name] = _post(server, path, encode_png(img))

    threads = [
        threading.Thread(
            target=worker, args=("tile", "/restore?tile=128", big)
        )
    ] + [
        threading.Thread(target=worker, args=(f"n{i}", "/restore", small))
        for i in range(4)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(status == 200 for status, _ in results.values()), {
        k: v[0] for k, v in results.items()
    }


def test_tiled_with_estimate_and_auto_k(server):
    """estimate=1 and auto_k=1 compose with tile=N: blind parameters
    feed the tiled restore."""
    from fft_restoration_tpu.utils.blurgen import blur_image

    rng = np.random.default_rng(14)
    yy, xx = np.mgrid[0:150, 0:200]
    scene = np.zeros((150, 200, 3), np.float32)
    scene[..., 0] = 80 + 100 * np.sin(yy / 17.0) * np.cos(xx / 13.0)
    scene[..., 1] = 60 + 0.5 * xx
    scene[..., 2] = 70 + 0.5 * yy
    scene[40:110, 90:100] += 120
    img = blur_image(
        np.clip(scene + rng.normal(0, 3, scene.shape), 0, 255).astype(
            np.uint8
        ),
        13, 45.0,
    )
    status, data = _post(
        server, "/restore?tile=128&estimate=1&auto_k=1", encode_png(img)
    )
    assert status == 200
    assert decode_png(data).shape == (150, 200, 3)


def test_warmup_tiled_spec():
    """--warmup HxW@tileN pre-compiles the tiled graph so the first
    tile request starts warm."""
    from fft_restoration_tpu.models.tiled import _DEVICE_FN_CACHE

    args = build_parser().parse_args(
        ["--backend", "matmul", "--psf-length", "5"]
    )
    service = RestorationService(args)
    try:
        _DEVICE_FN_CACHE.clear()
        service.warm(["150x200@tile128"])
        assert any(
            (k[0], k[1]) == (150, 200) for k in _DEVICE_FN_CACHE
        )
    finally:
        service.batcher.shutdown()
