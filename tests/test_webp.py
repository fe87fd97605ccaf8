"""WebP decoder parity (utils/webp.py, utils/webp_vp8.py).

The reference accepts whatever cv::imread reads
(/root/reference/serial.cpp:22), which includes WebP. Both bitstream
families are decoded from scratch in-repo; these tests hold them
bit-exact against libwebp (via cv2 / PIL as test-only encode+decode
oracles) across lossy qualities, lossless, alpha, and corrupt input.
"""

import base64
import io

import numpy as np
import pytest

from fft_restoration_tpu.utils.webp import decode_webp, probe_webp_size

cv2 = pytest.importorskip("cv2")


def _bgr(m):
    """module output (RGB/RGBA) -> cv2 channel order for comparison."""
    if m.ndim == 3 and m.shape[-1] == 4:
        return np.dstack([m[..., :3][..., ::-1], m[..., 3:]])
    return m[..., ::-1]


def _roundtrip(img_bgr, params):
    ok, enc = cv2.imencode(".webp", img_bgr, params)
    assert ok
    blob = enc.tobytes()
    ref = cv2.imdecode(enc, cv2.IMREAD_UNCHANGED)
    return blob, ref


def _gradient(h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    r = (yy * 255 // max(h - 1, 1)).astype(np.uint8)
    g = (xx * 255 // max(w - 1, 1)).astype(np.uint8)
    b = ((yy + xx) * 127 // max(h + w - 2, 1)).astype(np.uint8)
    return np.stack([b, g, r], -1)


# ---------------------------------------------------------------------------
# VP8 (lossy)


@pytest.mark.parametrize("q", [10, 50, 90])
@pytest.mark.parametrize("shape", [(32, 48), (17, 23), (64, 80)])
def test_vp8_lossy_bit_exact_vs_libwebp(q, shape):
    rng = np.random.default_rng(q * 1000 + shape[0])
    img = rng.integers(0, 256, (*shape, 3), np.uint8)
    img = cv2.GaussianBlur(img, (5, 5), 2)  # natural-ish: mixes i16/i4 modes
    blob, ref = _roundtrip(img, [cv2.IMWRITE_WEBP_QUALITY, q])
    got = decode_webp(blob)
    np.testing.assert_array_equal(_bgr(got), ref)


def test_vp8_flat_blocks_q100():
    rng = np.random.default_rng(3)
    img = np.zeros((48, 64, 3), np.uint8)
    for _ in range(8):
        y0, x0 = rng.integers(0, 48), rng.integers(0, 64)
        img[y0 : y0 + 20, x0 : x0 + 20] = rng.integers(0, 256, 3)
    blob, ref = _roundtrip(img, [cv2.IMWRITE_WEBP_QUALITY, 100])
    got = decode_webp(blob)
    np.testing.assert_array_equal(_bgr(got), ref)


# Regression: q10 160x120 stream whose MB(2,2) is an i16 MB with zero
# coefficients everywhere — libwebp's f_inner must be 0 there (inner loop
# filter edges skipped). Caught a `nz > 0` vs `nz > first` bug in the
# has-coeffs derivation (webp_vp8.py residual loop).
_F_INNER_REGRESSION = (
    "UklGRjgCAABXRUJQVlA4ICwCAABQEACdASqgAHgAP3GuzF67v72tqNdKw/AuCWYD15mV"
    "w6mi76Tfp4Bt/98wgWDt/20dkYtfxkxTOZjrYfpYnTDfTRtvUhsEKam1F//adf/6tH4l"
    "yJY91Y0D8yzBLvjQMmQ8pqwHYWt5Y+AR1FEM1hJV5EbktNK01TNf/4wuyj6XBtLK/s8I"
    "S6TfJtZgAP6/mvq/bKJ2tX2mDc58ABxoVnqESHntk+f5YOTxF5C7n64HpGnyDxA+jaCS"
    "t2s9LJ7wy/spkStddx1sh1J+XpXjt+e9Te2QbjPHp32CYvZZqs8DK1IsCnhMrJB90VrC"
    "xFLutma9wV+ZSelHN7vYbWOiwp3fdEtULkR+aRqLY/AEUajRaSI4SGgdTlpT1TDMtk/Y"
    "IyZyg60lrFpX3TdKEnEM5lSHLdqgvdcEudxESzqsa2EhoNmcDbEnf7Dy4EVe5ls2+9nc"
    "J1DBj5h9NNUzWFFg7JdwCVrOD+LzGpCo2vF4weXcKeG2PIrbUCMomoFFSV0MibIXry7a"
    "Y5lFa4/W4bnTQZBbEA87dk5yQRPjB3XQ+e5jE14yQSENeL/LZwP3FdfvFBc2y8K9EgvS"
    "nJPnatgur05YIUYVCG96OIyQpFZ4yg96eaoNTGYxIcGwF6QpH+EFMhhavwSV/goV/8tZ"
    "IBqX7UmjIINtVRRCtVXpZEhvejiMoj9tRPpJ4SAOvssnMhsXvtmWYizeo/PByMHaEHBG"
    "YGo/JTejWLQRcySd4AAA"
)


def test_vp8_loop_filter_f_inner_regression():
    blob = base64.b64decode(_F_INNER_REGRESSION)
    ref = cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_UNCHANGED)
    got = decode_webp(blob)
    np.testing.assert_array_equal(_bgr(got), ref)


# ---------------------------------------------------------------------------
# VP8L (lossless)


@pytest.mark.parametrize("shape", [(16, 16), (33, 47), (1, 1), (7, 100)])
def test_vp8l_lossless_bit_exact(shape):
    rng = np.random.default_rng(shape[0] * 7 + shape[1])
    img = rng.integers(0, 256, (*shape, 3), np.uint8)
    blob, ref = _roundtrip(img, [cv2.IMWRITE_WEBP_QUALITY, 101])
    got = decode_webp(blob)
    np.testing.assert_array_equal(_bgr(got), ref)


def test_vp8l_gradient_lossless():
    img = _gradient(40, 56)
    blob, ref = _roundtrip(img, [cv2.IMWRITE_WEBP_QUALITY, 101])
    got = decode_webp(blob)
    np.testing.assert_array_equal(_bgr(got), ref)


# Regression: 16x16 RGBA lossless stream with a 252-entry palette where
# the encoder emits index 252 — libwebp's ExpandColorMap zero-fills the
# table to 256 entries, so out-of-range indices decode as transparent
# black (caught a clamp-to-last-entry bug in the color-indexing inverse).
_PALETTE_OOR_REGRESSION = (
    "UklGRtoEAABXRUJQVlA4TM4EAAAvD8ADEN8HNwDAtI0kM1OYGbeOfEY/7gXMzLUdToR+"
    "A24AgGkby2KHmZl57xF9oR/1MWbuFuakZhIka9vSOpBwYtfdXWa93UcX0FE30B127u7u"
    "7vEESAoBDgAABJrsmm3btm3btq3L5mXjsm3btm0jIFQMNkCo6DXgdoJTXMJuBlp/WApL"
    "ZkP2xZbLmn/jieykssz+/csVY/Kn9Cwe+N7C9w2UPcN+cv4vlFtUKenuqKLQvsuc80L0"
    "pjkncil7FR7cSlsmFhvbRX7FLeWP/vYfghqmW0R1lxRQ+xHl6WiHfqz95HgyoW93foan"
    "BZ4AawXYhCi6VNW2CS2UsZlcd+GLRl929JmEGuQ+RdyypTIy2UBQdC0BBpGi9RWjAgEb"
    "1VqopX1pLo4gqInNPJjxe3wCLIpYH2TEhq2HuLgIOWFZviZxD+VlCnHZBLcXoW+nFQFL"
    "4th5RPqVBglCQ03JrOAmEXbqm42G3k+YHR++uOmWrUi7m3FNMRCZmojV9la8UjqrSTbI"
    "/Tj4sbkE/Jd415ryr+x0HxyboFY2oaGHjACVZZk5NDhXnrKFz9paY4vomKU4MVT8C0XS"
    "XowVGNpr7sD9x3v0DadWSn5Klaa0ddk3wvtP9r0QXYAwW18Cxgcys587wRIcYHb7kUSn"
    "RFl4OIv9d2AAVVHeKq8r3PyAHM1dLqoS0rlILtiHSt4YxEwLI4ll/7UGV6A35s1wdUEX"
    "HXMzOsOKsEJ7NoR4gjiWUk/9+SExxDmTvHpKzeDnrrg+BYKArxbZnBQWowIfGTipTP4l"
    "fYx6BYGx2hdb1rAUagYugAhtCTcNfd51j0/q1IYyBRU7wPN/EYxBLpioVYCrtQktsMTk"
    "pxiuSNY8uXeT91EsbDrZDBpB9vii+yZCmma4ZjiTkkA+8gZjJjVqEt2xaEajReMZEtb4"
    "UMYGc6Z4g9L0vlxyp37vdKrG3afO7/Pqx4DGmlWnGEtZveN/vKXSWaHYV4UdpK7S6IX1"
    "+P1S6gv9xV7YQPjXSYRnpmZq3ClP8AVtcpR2gW4XaeX+awXMsCHYFyrQAGzn8Ruyyy9Y"
    "t+h/R9RMJQuRtwyMeWbq86RXb5NZuvhQ2UPLBpgFkW+PPL/6XytLxA2vxM0QXCLhy+4b"
    "D8eu/qufornuJzOvXSXfyNLasGjX7btUwtGkQphmA443YCdFhLapq2+eXK08s3zdF8y7"
    "hIMIzsvOT2vFkKG5XkdfDIf6PFm1Rd/PLwHmP3iJXy1Q1gUk+a91zUEA9fUpta87ul6g"
    "B4MAAIjYtm3btm3btm3btm3btm3bDYnof3CO91GPHRHVZ8O21booYWABRiLMtMLXF9aT"
    "ZoikVB418+aJVpvVJ8p6/gGyBnapO/BpwTlufoQtu65SCe7eFgBj70wMQemE1zeOJ4hM"
    "XbcgborxxpDY/3EgB1QeUsQiGrdG0MjTaFTze0UJ+pZN3B+MyezqEqv+T367NENmsu+p"
    "zrZcpTPfC2oYnrymZBH43qD4GhkCS1bPeqyQrcN+YWvDV9Nl2fSyahU/hMSwE9urIqCO"
    "efb7GaKN30HPAwbqM9f/0Ggfj1xAEQl5T0zDe1jcZfqWzmV5Wy6qG8oe3rmgABw8k5Os"
    "qEzlaj1CY58zOUYbosDdCNypXWUM0H1QJgE="
)


def test_vp8l_palette_out_of_range_index_regression():
    blob = base64.b64decode(_PALETTE_OOR_REGRESSION)
    ref = cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_UNCHANGED)
    got = decode_webp(blob)
    np.testing.assert_array_equal(_bgr(got), ref)


def test_vp8l_real_image_far_plane_codes(car_png):
    """Lossless encode of the car fixture: its transform-tile streams
    use 2D distance codes >= 97, the tail of the spec's dist_map table
    that a nearest-neighbour sort mis-orders (regression for the
    generated-table bug; bit-exactness checked end to end)."""
    img = cv2.imread(car_png)
    blob, ref = _roundtrip(img, [cv2.IMWRITE_WEBP_QUALITY, 101])
    got = decode_webp(blob)
    np.testing.assert_array_equal(_bgr(got)[..., :3], ref[..., :3])


def test_vp8l_paletted_image():
    # <=16 colors forces COLOR_INDEXING with pixel bundling (xbits>0)
    rng = np.random.default_rng(11)
    colors = rng.integers(0, 256, (7, 3), np.uint8)
    idx = rng.integers(0, 7, (25, 39))
    img = colors[idx]
    blob, ref = _roundtrip(img, [cv2.IMWRITE_WEBP_QUALITY, 101])
    got = decode_webp(blob)
    np.testing.assert_array_equal(_bgr(got), ref)


# ---------------------------------------------------------------------------
# Alpha (VP8X containers, ALPH chunk, lossless RGBA)


def test_lossless_rgba_alpha_preserved():
    rng = np.random.default_rng(21)
    rgba = rng.integers(0, 256, (20, 28, 4), np.uint8)
    blob, ref = _roundtrip(rgba, [cv2.IMWRITE_WEBP_QUALITY, 101])
    got = decode_webp(blob)
    assert got.shape[-1] == 4
    np.testing.assert_array_equal(_bgr(got), ref)


def test_lossy_alpha_alph_chunk():
    PIL = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(22)
    rgba = cv2.GaussianBlur(
        rng.integers(0, 256, (33, 47, 4), np.uint8), (5, 5), 2
    )
    im = PIL.fromarray(rgba, "RGBA")
    b = io.BytesIO()
    im.save(b, "WEBP", quality=60, lossless=False)
    blob = b.getvalue()
    ref = cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_UNCHANGED)
    got = decode_webp(blob)
    np.testing.assert_array_equal(_bgr(got), ref)


def test_alph_unfilter_exact_all_methods():
    """ALPH filtering methods 1-3 against direct ports of libwebp's
    forward filters (dsp/filters.c): unfilter(filter(img)) == img.
    Regression: method 1 col-0 and method 2 row-0 previously used raw
    (not decoded) predictors and corrupted everything below row 1."""
    from fft_restoration_tpu.utils.webp import _decode_alpha

    def _filter(img, method):
        h, w = img.shape
        out = np.zeros_like(img)
        for y in range(h):
            for x in range(w):
                if method == 1:  # horizontal
                    p = (0 if y == 0 else int(img[y - 1, 0])) if x == 0 \
                        else int(img[y, x - 1])
                elif method == 2:  # vertical (row 0 = horizontal)
                    p = (0 if x == 0 else int(img[0, x - 1])) if y == 0 \
                        else int(img[y - 1, x])
                else:  # gradient (row 0 = horizontal)
                    if y == 0:
                        p = 0 if x == 0 else int(img[0, x - 1])
                    elif x == 0:
                        p = int(img[y - 1, 0])
                    else:
                        g = (int(img[y, x - 1]) + int(img[y - 1, x])
                             - int(img[y - 1, x - 1]))
                        p = min(max(g, 0), 255)
                out[y, x] = (int(img[y, x]) - p) & 0xFF
        return out

    rng = np.random.default_rng(23)
    cases = [rng.integers(0, 256, (11, 17), np.uint8),
             np.full((6, 5), 128, np.uint8),  # the constant-plane regression
             rng.integers(0, 256, (1, 9), np.uint8),
             rng.integers(0, 256, (9, 1), np.uint8)]
    for img in cases:
        h, w = img.shape
        for method in (1, 2, 3):
            alph = bytes([method << 2]) + _filter(img, method).tobytes()
            np.testing.assert_array_equal(_decode_alpha(alph, h, w), img)


# ---------------------------------------------------------------------------
# Header probing + failure contract


def test_probe_webp_size_all_container_forms():
    img = _gradient(24, 40)
    for q in (80, 101):
        blob, _ = _roundtrip(img, [cv2.IMWRITE_WEBP_QUALITY, q])
        assert probe_webp_size(blob) == (24, 40)
    PIL = pytest.importorskip("PIL.Image")
    rgba = np.dstack([img[..., ::-1], np.full((24, 40), 128, np.uint8)])
    b = io.BytesIO()
    PIL.fromarray(rgba, "RGBA").save(b, "WEBP", quality=60)
    assert probe_webp_size(b.getvalue()) == (24, 40)  # VP8X path

    from fft_restoration_tpu.utils import formats

    assert formats.probe_size(blob) == (24, 40)


def test_truncated_streams_raise_valueerror():
    img = _gradient(32, 32)
    for q in (75, 101):
        blob, _ = _roundtrip(img, [cv2.IMWRITE_WEBP_QUALITY, q])
        for cut in (10, len(blob) // 3, len(blob) - 4):
            try:
                decode_webp(blob[:cut])
            except ValueError:
                pass  # the contract: clean ValueError, never a crash


def test_animated_webp_rejected():
    hdr = b"RIFF" + (38).to_bytes(4, "little") + b"WEBP"
    anim = b"ANIM" + (6).to_bytes(4, "little") + b"\x00" * 6
    with pytest.raises(ValueError, match="animated"):
        decode_webp(hdr + anim)


# ---------------------------------------------------------------------------
# Encoder-diversity stress: PIL/libwebp across quality x method x mode


@pytest.mark.parametrize(
    "q,method,mode",
    [
        (5, 0, "RGB"),     # fastest encoder path, heavy quantization
        (35, 4, "RGB"),
        (75, 6, "RGB"),    # slowest/most features (better modes, filters)
        (95, 4, "RGBA"),   # lossy + ALPH chunk
        (None, 4, "RGB"),  # lossless VP8L
        (None, 6, "RGBA"), # lossless VP8L + internal alpha
    ],
)
def test_pil_encoder_matrix_bit_exact(q, method, mode):
    """A second independent encoder (PIL/libwebp, different settings
    surface than cv2) across quality/method/alpha: different encoder
    method levels toggle segment usage, loop-filter strengths and
    prediction modes, so this sweeps bitstream features cv2's fixed
    settings never emit."""
    import io

    PIL = pytest.importorskip("PIL.Image")

    img = _gradient(96, 128)[..., ::-1]  # RGB
    rng = np.random.default_rng(7)
    img = np.clip(
        img.astype(int) + rng.integers(-25, 26, img.shape), 0, 255
    ).astype(np.uint8)
    arr = (
        np.dstack([img, np.full(img.shape[:2], 200, np.uint8)])
        if mode == "RGBA"
        else img
    )
    buf = io.BytesIO()
    kw = {"lossless": True} if q is None else {"quality": q}
    PIL.fromarray(arr, mode).save(buf, "WEBP", method=method, **kw)
    blob = buf.getvalue()
    ref = np.asarray(PIL.open(io.BytesIO(blob)).convert(mode))
    got = decode_webp(blob)
    if mode == "RGB" and got.ndim == 3 and got.shape[-1] == 4:
        got = got[..., :3]
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("shape", [(1, 64), (64, 1), (1, 1), (3, 5), (33, 1)])
@pytest.mark.parametrize("lossless", [False, True])
def test_extreme_geometry(shape, lossless):
    """Degenerate extents: single-row/column/pixel frames exercise the
    4:2:0 chroma edge replication and VP8L's tiny-image paths."""
    rng = np.random.default_rng(shape[0] * 100 + shape[1])
    img = rng.integers(0, 256, (*shape, 3), np.uint8)
    params = [cv2.IMWRITE_WEBP_QUALITY, 101 if lossless else 80]
    blob, ref = _roundtrip(img, params)
    got = decode_webp(blob)
    np.testing.assert_array_equal(_bgr(got), ref)


# ---------------------------------------------------------------------------
# encoder (utils/webp_encode.py, round 4): literal-only lossless VP8L


@pytest.mark.parametrize(
    "shape",
    [(97, 130, 3), (50, 60), (40, 55, 4), (1, 1, 3), (1, 64, 3)],
    ids=["rgb", "gray", "rgba", "1x1", "row"],
)
def test_encode_lossless_round_trip(shape, tmp_path):
    from fft_restoration_tpu.utils.webp_encode import encode_webp

    rng = np.random.default_rng(sum(shape))
    img = rng.integers(0, 256, shape, np.uint8)
    blob = encode_webp(img)
    exp = img if img.ndim == 3 else np.repeat(img[..., None], 3, -1)
    mine = decode_webp(blob)
    np.testing.assert_array_equal(mine[..., : exp.shape[-1]], exp)
    # libwebp (via cv2) must read it bit-exactly too
    p = str(tmp_path / "e.webp")
    open(p, "wb").write(blob)
    o = cv2.imread(p, cv2.IMREAD_UNCHANGED)
    assert o is not None
    order = [2, 1, 0] + ([3] if o.shape[-1] == 4 else [])
    np.testing.assert_array_equal(o[..., order][..., : exp.shape[-1]], exp)


def test_encode_degenerate_palettes(tmp_path):
    # flat frames hit the single-symbol (zero-bit) code path; binary
    # frames hit the 2-symbol simple form.
    from fft_restoration_tpu.utils.webp_encode import encode_webp

    flat = np.full((30, 40, 3), 77, np.uint8)
    two = (np.indices((33, 47)).sum(0) % 2 * 255).astype(np.uint8)
    for img in (flat, two):
        blob = encode_webp(img)
        exp = img if img.ndim == 3 else np.repeat(img[..., None], 3, -1)
        np.testing.assert_array_equal(decode_webp(blob)[..., :3], exp)
        p = str(tmp_path / "d.webp")
        open(p, "wb").write(blob)
        np.testing.assert_array_equal(cv2.imread(p)[..., ::-1], exp)


def test_encode_depth15_codes(tmp_path):
    # a near-geometric histogram forces package-merge to the 15-bit
    # length limit; code-length symbol 15 is the LAST entry of the
    # code-length order table, so all 19 entries must be transmitted.
    from fft_restoration_tpu.utils.webp_encode import (
        _limited_lengths,
        encode_webp,
    )

    rng = np.random.default_rng(0)
    vals = np.minimum(rng.geometric(0.35, size=(400_000, 3)) - 1, 255)
    side = 632
    img = vals[: side * side].reshape(side, side, 3).astype(np.uint8)
    freq = np.bincount(img[..., 1].ravel(), minlength=280)
    assert _limited_lengths(freq, 15).max() == 15  # the case under test
    blob = encode_webp(img)
    np.testing.assert_array_equal(decode_webp(blob)[..., :3], img)
    p = str(tmp_path / "s.webp")
    open(p, "wb").write(blob)
    np.testing.assert_array_equal(cv2.imread(p)[..., ::-1], img)


def test_imwrite_webp_dispatch(tmp_path):
    from fft_restoration_tpu.utils.imageio import imread, imwrite

    rng = np.random.default_rng(29)
    bgr = (rng.random((45, 58, 3)) * 255).astype(np.uint8)
    p = str(tmp_path / "out.webp")
    imwrite(p, bgr)
    np.testing.assert_array_equal(imread(p), bgr)
    np.testing.assert_array_equal(cv2.imread(p), bgr)
