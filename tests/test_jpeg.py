"""Baseline JPEG decoder vs OpenCV's decode of the SAME byte stream.

Decoding is deterministic up to IDCT rounding, so our decoder must match
cv2.imdecode within a couple of counts per pixel on bytes cv2 encoded.
"""

import numpy as np
import pytest

from fft_restoration_tpu.utils.jpeg import decode_jpeg

cv2 = pytest.importorskip("cv2")


def _encode(img_bgr, quality=90, **params):
    flags = [cv2.IMWRITE_JPEG_QUALITY, quality]
    for k, v in params.items():
        flags += [getattr(cv2, k), v]
    ok, buf = cv2.imencode(".jpg", img_bgr, flags)
    assert ok
    return bytes(buf.tobytes())


def _roundtrip_diff(img_bgr, **params):
    data = _encode(img_bgr, **params)
    ours_rgb = decode_jpeg(data)
    theirs_bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    ours_bgr = ours_rgb[..., ::-1]
    return np.abs(ours_bgr.astype(int) - theirs_bgr.astype(int))


@pytest.fixture(scope="module")
def photo():
    # smooth gradients + texture: exercises DC prediction and AC runs.
    # Local deterministic rng: the shared session fixture's state depends
    # on test ORDER, which made the codec-rounding tolerances flaky
    # between solo and full-suite runs.
    rng = np.random.default_rng(1234)
    y, x = np.mgrid[:96, :120]
    base = (
        128
        + 60 * np.sin(x / 9.0)
        + 50 * np.cos(y / 7.0)
        + (rng.random((96, 120)) * 30)
    )
    img = np.stack([base, np.roll(base, 7, 0), 255 - base], axis=-1)
    return np.clip(img, 0, 255).astype(np.uint8)


def test_jpeg_420_matches_cv2(photo):
    # default cv2 encoding is 4:2:0. libjpeg's fancy upsampler is an
    # integer (9:3:3:1)/16 filter with asymmetric biases; ours is the
    # equivalent separable float filter -> max 1 extra count of rounding
    # skew on top of IDCT rounding.
    assert _roundtrip_diff(photo).max() <= 3


def test_jpeg_444_matches_cv2(photo):
    # <=3: our float32 IDCT vs libjpeg's integer IDCT can disagree by
    # one extra count on top of the +-2 quantization rounding
    d = _roundtrip_diff(photo, IMWRITE_JPEG_SAMPLING_FACTOR=0x111111)
    assert d.max() <= 3


def test_jpeg_gray_matches_cv2(photo):
    gray = cv2.cvtColor(photo, cv2.COLOR_BGR2GRAY)
    ok, buf = cv2.imencode(".jpg", gray, [cv2.IMWRITE_JPEG_QUALITY, 90])
    assert ok
    data = bytes(buf.tobytes())
    ours = decode_jpeg(data)
    theirs = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_GRAYSCALE)
    assert ours.ndim == 2
    assert np.abs(ours.astype(int) - theirs.astype(int)).max() <= 2


def test_jpeg_restart_markers(photo):
    d = _roundtrip_diff(photo, IMWRITE_JPEG_RST_INTERVAL=2)
    assert d.max() <= 3


def test_jpeg_odd_size_matches_cv2():
    img = (np.random.default_rng(77).random((41, 53, 3)) * 255).astype(np.uint8)
    assert _roundtrip_diff(img, quality=95).max() <= 3


def test_progressive_now_decodes(photo):
    """Round 3: progressive streams decode (TestProgressive below) —
    this replaces the round-2 rejection contract."""
    data = _encode(photo, IMWRITE_JPEG_PROGRESSIVE=1)
    out = decode_jpeg(data)
    assert out.shape == photo.shape


def test_truncated_jpeg_raises(photo):
    data = _encode(photo)
    with pytest.raises(ValueError):
        decode_jpeg(data[: len(data) // 2])


def test_imread_dispatches_jpeg(tmp_path, photo):
    from fft_restoration_tpu.utils.imageio import imread, probe_size

    p = tmp_path / "x.jpg"
    p.write_bytes(_encode(photo))
    img = imread(str(p))  # BGR like cv::imread
    theirs = cv2.imread(str(p), cv2.IMREAD_COLOR)
    assert np.abs(img.astype(int) - theirs.astype(int)).max() <= 3
    assert probe_size(str(p)) == photo.shape[:2]


def test_cli_batch_accepts_jpeg(tmp_path, photo, capsys):
    from fft_restoration_tpu.cli import main

    p = tmp_path / "x.jpg"
    p.write_bytes(_encode(photo))
    rc = main([str(tmp_path), "5", "30", "--no-verify"])
    assert rc == 0
    assert "Restored 1 frames" in capsys.readouterr().out
    assert (tmp_path / "x_restored.png").exists()


def test_truncated_dht_raises_valueerror(photo):
    """Corruption inside a DHT segment must surface as ValueError (the
    CLI skip contract), not IndexError."""
    data = _encode(photo)
    i = data.find(b"\xff\xc4")
    assert i > 0
    with pytest.raises(ValueError):
        decode_jpeg(data[: i + 10])


def test_progressive_dc_scan_undefined_table(photo):
    """A progressive DC scan naming a DHT id that was never defined must
    raise ValueError (not AttributeError from decode(None)): patch the
    first SOS's Td nibble to 3. Regression for the dc_tables .get(None)
    hole."""
    data = _encode(photo, IMWRITE_JPEG_PROGRESSIVE=1)
    i = data.find(b"\xff\xda")  # first SOS: the spectral-selection DC scan
    assert i > 0
    ns = data[i + 4]
    # component specs start at i+5: (id, Td<<4|Ta) pairs
    patched = bytearray(data)
    for k in range(ns):
        patched[i + 6 + 2 * k] = (3 << 4) | (patched[i + 6 + 2 * k] & 0x0F)
    with pytest.raises(ValueError, match="undefined"):
        decode_jpeg(bytes(patched))


def test_probe_size_accepts_progressive_rejects_lossless(tmp_path, photo):
    """probe_size's decodability must track decode_jpeg: progressive
    (SOF2) decodes now so it must group normally, while lossless (SOF3)
    must raise HERE so one such file doesn't poison its whole same-size
    batch group."""
    from fft_restoration_tpu.utils.imageio import probe_size

    prog = _encode(photo, IMWRITE_JPEG_PROGRESSIVE=1)
    p = tmp_path / "prog.jpg"
    p.write_bytes(prog)
    assert probe_size(str(p)) == photo.shape[:2]

    i = prog.find(b"\xff\xc2")
    assert i > 0
    lossless = prog[:i] + b"\xff\xc3" + prog[i + 2 :]
    q = tmp_path / "lossless.jpg"
    q.write_bytes(lossless)
    with pytest.raises(ValueError, match="baseline and progressive"):
        probe_size(str(q))


def test_gray_nonunit_sampling_factors(photo):
    """T.81 A.2: single-component scans are non-interleaved regardless
    of the SOF sampling factors; patch a gray JPEG's factors to 2x2 and
    the decode must still match cv2."""
    gray = cv2.cvtColor(photo, cv2.COLOR_BGR2GRAY)
    ok, buf = cv2.imencode(".jpg", gray, [cv2.IMWRITE_JPEG_QUALITY, 90])
    assert ok
    data = bytearray(buf.tobytes())
    i = data.find(b"\xff\xc0")
    assert i > 0
    # SOF0: FF C0 len(2) prec(1) h(2) w(2) ncomp(1) cid(1) hv(1) ...
    hv_off = i + 11
    assert data[hv_off] == 0x11
    data[hv_off] = 0x22
    patched = bytes(data)
    ours = decode_jpeg(patched)
    theirs = cv2.imdecode(np.frombuffer(patched, np.uint8), cv2.IMREAD_GRAYSCALE)
    assert np.abs(ours.astype(int) - theirs.astype(int)).max() <= 2


class TestEncoder:
    """Baseline JPEG encoder (utils/jpeg_encode.py): round trips through
    our own decoder AND OpenCV's."""

    def _smooth(self, rng, shape):
        import scipy.ndimage as ndi

        return (ndi.gaussian_filter(rng.random(shape), 3) * 255).astype(np.uint8)

    def test_roundtrip_own_decoder(self, rng):
        from fft_restoration_tpu.utils.jpeg import decode_jpeg
        from fft_restoration_tpu.utils.jpeg_encode import encode_jpeg

        img = np.stack([self._smooth(rng, (48, 56))] * 3, -1)
        back = decode_jpeg(encode_jpeg(img, quality=95))
        mse = np.mean((img.astype(float) - back.astype(float)) ** 2)
        assert 10 * np.log10(255**2 / max(mse, 1e-9)) > 35

    def test_cv2_decodes_our_jpeg(self, rng):
        cv2 = pytest.importorskip("cv2")
        from fft_restoration_tpu.utils.jpeg_encode import encode_jpeg

        img = np.stack([self._smooth(rng, (33, 41, 3))[..., c] for c in range(3)], -1)
        blob = encode_jpeg(img, quality=90)
        ref = cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]
        assert ref.shape == img.shape
        mse = np.mean((img.astype(float) - ref.astype(float)) ** 2)
        assert 10 * np.log10(255**2 / max(mse, 1e-9)) > 30

    def test_gray_and_odd_sizes(self, rng):
        cv2 = pytest.importorskip("cv2")
        from fft_restoration_tpu.utils.jpeg_encode import encode_jpeg

        g = self._smooth(rng, (17, 23))  # not multiples of 8
        ref = cv2.imdecode(
            np.frombuffer(encode_jpeg(g, quality=90), np.uint8),
            cv2.IMREAD_GRAYSCALE,
        )
        assert ref.shape == g.shape
        assert np.abs(ref.astype(int) - g.astype(int)).mean() < 6

    def test_quality_knob_changes_size(self, rng):
        from fft_restoration_tpu.utils.jpeg_encode import encode_jpeg

        img = np.stack([self._smooth(rng, (64, 64))] * 3, -1)
        hi = len(encode_jpeg(img, quality=95))
        lo = len(encode_jpeg(img, quality=20))
        assert lo < hi

    def test_imwrite_jpg_dispatch(self, rng, tmp_path):
        from fft_restoration_tpu.utils.imageio import imread, imwrite

        img_bgr = np.stack([self._smooth(rng, (32, 40))] * 3, -1)
        p = tmp_path / "x.jpg"
        imwrite(str(p), img_bgr)
        back = imread(str(p))  # our own baseline decoder
        assert back.shape == img_bgr.shape
        assert np.abs(back.astype(int) - img_bgr.astype(int)).mean() < 6


class TestProgressive:
    """Progressive (SOF2) decode vs cv2's libjpeg ground truth
    (cv::imread accepts these streams)."""

    def _roundtrip(self, img, flags):
        import cv2

        src = img if img.ndim == 2 else img[..., ::-1]
        ok, enc = cv2.imencode(".jpg", src, flags)
        assert ok
        blob = enc.tobytes()
        assert b"\xff\xc2" in blob  # really progressive
        ref = cv2.imdecode(enc, cv2.IMREAD_UNCHANGED)
        if ref.ndim == 3:
            ref = ref[..., ::-1]
        out = decode_jpeg(blob)
        assert out.shape == ref.shape
        d = np.abs(out.astype(int) - ref.astype(int))
        # same parity class as the baseline decoder vs libjpeg
        # (upsample/rounding differences)
        assert d.max() <= 3, d.max()
        return out

    def _img(self, h, w, gray=False, seed=1):
        rng = np.random.default_rng(seed)
        x = (
            np.add.outer(np.linspace(0, 255, h), np.linspace(0, 255, w)) / 2
            + rng.normal(0, 12, (h, w))
        ).clip(0, 255).astype(np.uint8)
        if gray:
            return x
        return np.stack([x, x[::-1], np.roll(x, 7, 1)], -1)

    def test_progressive_rgb_420(self):
        import cv2

        self._roundtrip(
            self._img(96, 128),
            [cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_QUALITY, 92],
        )

    def test_progressive_odd_dims(self):
        import cv2

        self._roundtrip(
            self._img(97, 131),
            [cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_QUALITY, 75],
        )

    def test_progressive_with_restart_markers(self):
        import cv2

        self._roundtrip(
            self._img(128, 192),
            [
                cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                cv2.IMWRITE_JPEG_QUALITY, 85,
                cv2.IMWRITE_JPEG_RST_INTERVAL, 4,
            ],
        )

    def test_progressive_gray(self):
        import cv2

        self._roundtrip(
            self._img(120, 90, gray=True),
            [cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_QUALITY, 90],
        )

    def test_progressive_444(self):
        import cv2

        self._roundtrip(
            self._img(160, 160),
            [
                cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                cv2.IMWRITE_JPEG_QUALITY, 95,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            ],
        )

    def test_progressive_truncated_raises(self):
        import cv2

        ok, enc = cv2.imencode(
            ".jpg",
            self._img(64, 64)[..., ::-1],
            [cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
        )
        blob = enc.tobytes()[: len(enc) // 2]
        with pytest.raises(ValueError):
            decode_jpeg(blob)

    def test_lossless_sof_rejected_with_spec_gap(self):
        """Non-baseline/progressive SOFs name the T.81 gap."""
        blob = (
            b"\xff\xd8\xff\xc3" + b"\x00\x0b" + b"\x08\x00\x10\x00\x10\x01"
            + b"\x01\x11\x00" + b"\xff\xd9"
        )
        with pytest.raises(ValueError, match="lossless|arithmetic|hierarchical"):
            decode_jpeg(blob)


class TestAdobeCMYK:
    """4-component Adobe JPEGs: CMYK (transform 0) and YCCK (transform 2).

    The reference ingests these through cv::imread
    (/root/reference/serial.cpp:22); cv2.imdecode is the parity oracle.
    The YCCK branch re-inverts the inks after the YCbCr step, matching
    libjpeg's ycck_cmyk_convert (round-4 advisor finding: without the
    inversion colors come out complemented, max diff 254).
    """

    @staticmethod
    def _cmyk_jpeg(quality=92):
        import io

        from PIL import Image

        rng = np.random.default_rng(99)
        y, x = np.mgrid[:80, :104]
        base = (
            128
            + 60 * np.sin(x / 9.0)
            + 50 * np.cos(y / 7.0)
            + rng.random((80, 104)) * 30
        )
        img = np.clip(
            np.stack([base, np.roll(base, 7, 0), 255 - base, base / 2], -1),
            0,
            255,
        ).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(img, mode="CMYK").save(
            buf, format="JPEG", quality=quality
        )
        return buf.getvalue()

    def _parity(self, data):
        ours = decode_jpeg(data)
        theirs = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        assert theirs is not None and ours.shape == theirs.shape
        return np.abs(ours[..., ::-1].astype(int) - theirs.astype(int)).max()

    def test_cmyk_transform0_matches_cv2(self):
        data = self._cmyk_jpeg()
        i = data.find(b"Adobe")
        assert i >= 0 and data[i + 11] == 0  # PIL writes transform 0
        assert self._parity(data) <= 3

    def test_ycck_transform2_matches_cv2(self):
        # Patch the Adobe APP14 transform byte to 2: the decoder must
        # now run the YCbCr step AND re-invert the inks like libjpeg.
        data = bytearray(self._cmyk_jpeg())
        i = bytes(data).find(b"Adobe")
        data[i + 11] = 2
        assert self._parity(bytes(data)) <= 3


class TestProgressiveNativeLane:
    """The C++ progressive entropy lanes (jpeg_decode_prog_dc/_ac) must
    be bit-identical to the pure-Python loops on every stream shape —
    the pure path is the parity oracle (native/png_codec.cpp header)."""

    @staticmethod
    def _img(h, w, seed=5):
        rng = np.random.default_rng(seed)
        y, x = np.mgrid[:h, :w]
        base = 128 + 60 * np.sin(x / 9.0) + 50 * np.cos(y / 7.0) + rng.random(
            (h, w)
        ) * 30
        return np.clip(
            np.stack([base, np.roll(base, 7, 0), 255 - base], -1), 0, 255
        ).astype(np.uint8)

    @pytest.mark.parametrize(
        "shape,params",
        [
            ((96, 120), []),
            ((67, 93), []),  # odd dims
            ((64, 80), [cv2.IMWRITE_JPEG_RST_INTERVAL, 2]),  # restarts
            ((48, 56), [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                        cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444]),
        ],
        ids=["420", "odd", "restarts", "444"],
    )
    def test_native_matches_pure_bitwise(self, shape, params, monkeypatch):
        # Pin the entropy lanes' actual product — the per-component
        # coefficient grids — to the pure loops, bit for bit. (The
        # final pixels can differ by 1 count between the C++ and NumPy
        # IDCT back halves, a separate pre-existing rounding property.)
        from fft_restoration_tpu.utils import imageio as iio
        from fft_restoration_tpu.utils import jpeg as jpeg_mod

        if not iio._load_native() or not hasattr(
            iio._load_native(), "jpeg_decode_prog_ac"
        ):
            pytest.skip("native lane not built")
        img = self._img(*shape)
        ok, enc = cv2.imencode(
            ".jpg", img[..., ::-1],
            [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
            + list(params),
        )
        blob = enc.tobytes()
        grids = {}
        orig = jpeg_mod._decode_progressive

        def spy(*a, **k):
            out = orig(*a, **k)
            grids[tag].extend(g.copy() for g in out)
            return out

        monkeypatch.setattr(jpeg_mod, "_decode_progressive", spy)
        tag = "native"
        grids[tag] = []
        native_out = decode_jpeg(blob)
        monkeypatch.setattr(iio, "_load_native", lambda: False)
        tag = "pure"
        grids[tag] = []
        pure_out = decode_jpeg(blob)
        assert len(grids["native"]) == len(grids["pure"]) > 0
        for gn, gp in zip(grids["native"], grids["pure"]):
            np.testing.assert_array_equal(gn, gp)
        assert np.abs(
            native_out.astype(int) - pure_out.astype(int)
        ).max() <= 1  # back-half IDCT rounding only

    def test_truncated_stream_raises_not_crashes(self):
        img = self._img(64, 64)
        ok, enc = cv2.imencode(
            ".jpg", img[..., ::-1],
            [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
        )
        blob = enc.tobytes()
        for cut in range(len(blob) // 2, len(blob), 97):
            try:
                decode_jpeg(blob[:cut])
            except ValueError:
                pass
