"""PNG codec parity with OpenCV's imread on the seed-generated fixtures."""

import numpy as np
import pytest

from fft_restoration_tpu.utils.imageio import imread, imwrite, encode_png, decode_png

cv2 = pytest.importorskip("cv2")


def test_decode_matches_cv2_car(car_png):
    ours = imread(car_png)
    ref = cv2.imread(car_png, cv2.IMREAD_COLOR)
    assert np.array_equal(ours, ref)


def test_roundtrip(tmp_path, rng):
    img = (rng.random((37, 61, 3)) * 255).astype(np.uint8)
    p = str(tmp_path / "x.png")
    imwrite(p, img)
    assert np.array_equal(imread(p), img)
    # cv2 can read what we write
    assert np.array_equal(cv2.imread(p, cv2.IMREAD_COLOR), img)


def test_gray_roundtrip(rng):
    img = (rng.random((16, 24)) * 255).astype(np.uint8)
    assert np.array_equal(decode_png(encode_png(img)), img)


# ---------------------------------------------------------------------------
# corrupt-file handling (advisor finding: zlib/struct errors must surface
# as ValueError so the CLI's [Error]-and-skip paths catch them)


def _corrupt_idat_png(rng):
    """Valid signature/IHDR, garbage IDAT payload."""
    img = (rng.random((8, 8, 3)) * 255).astype(np.uint8)
    good = bytearray(encode_png(img))
    idat = good.find(b"IDAT")
    assert idat > 0
    # stomp the deflate stream (keep length/crc fields structurally there)
    good[idat + 4 : idat + 12] = b"\xde\xad\xbe\xef\xfe\xed\xfa\xce"
    return bytes(good)


def test_corrupt_idat_raises_valueerror(rng):
    with pytest.raises(ValueError, match="corrupt PNG"):
        decode_png(_corrupt_idat_png(rng))


def test_truncated_chunk_raises_valueerror(rng):
    img = (rng.random((8, 8, 3)) * 255).astype(np.uint8)
    data = encode_png(img)
    with pytest.raises(ValueError):
        decode_png(data[: len(data) * 2 // 3])  # cut mid-IDAT


def test_cli_corrupt_idat_exits_1(tmp_path, rng, capsys):
    from fft_restoration_tpu.cli import main

    p = tmp_path / "bad.png"
    p.write_bytes(_corrupt_idat_png(rng))
    rc = main([str(p), "5", "30"])
    assert rc == 1
    assert "[Error]" in capsys.readouterr().out


def test_cli_batch_skips_corrupt_idat(tmp_path, rng, capsys):
    """A corrupt-IDAT file (valid header, bad payload) must be skipped,
    not crash the batch run."""
    from fft_restoration_tpu.cli import main
    from fft_restoration_tpu.utils.imageio import imwrite as _imwrite

    good = (rng.random((16, 16, 3)) * 255).astype(np.uint8)
    _imwrite(str(tmp_path / "good.png"), good)
    (tmp_path / "bad.png").write_bytes(_corrupt_idat_png(rng))
    rc = main([str(tmp_path), "3", "30", "--no-verify"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "skipped" in out and "Restored 1 frames" in out


# ---------------------------------------------------------------------------
# 16-bit conversion + scanline filters


def _chunk(ctype: bytes, body: bytes) -> bytes:
    import struct
    import zlib

    crc = zlib.crc32(ctype + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", crc)


def _make_png(width, height, bit_depth, color_type, scanlines: bytes) -> bytes:
    import struct
    import zlib

    ihdr = struct.pack(">IIBBBBB", width, height, bit_depth, color_type, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(scanlines))
        + _chunk(b"IEND", b"")
    )


def test_adam7_interlaced_decode(rng):
    """Hand-built Adam7 stream (filter-0 rows per pass) round-trips."""
    import zlib

    truth = (rng.random((21, 13, 3)) * 255).astype(np.uint8)
    passes = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
              (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
    parts = bytearray()
    for x0, y0, dx, dy in passes:
        sub = truth[y0::dy, x0::dx]
        for row in sub:
            parts += b"\x00" + row.tobytes()
    ihdr = __import__("struct").pack(">IIBBBBB", 13, 21, 8, 2, 0, 0, 1)
    data = (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(bytes(parts)))
        + _chunk(b"IEND", b"")
    )
    assert np.array_equal(decode_png(data), truth)
    # cross-check against cv2's decoder on the same bytes
    ref = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    assert np.array_equal(decode_png(data)[..., ::-1], ref)


def test_16bit_decode_rounds_not_truncates():
    # gray16 pixels: 0x00FF (=255/65535 -> 0.992 -> rounds to 1; a
    # high-byte truncate would give 0) and 0xFF00 (-> 253.996 -> 254).
    row = b"\x00" + b"\x00\xff" + b"\xff\x00"
    img = decode_png(_make_png(2, 1, 16, 0, row))
    assert img.tolist() == [[1, 254]]


def test_sub_filter_decode_python_fallback(monkeypatch, rng):
    """Filter-1 (Sub) rows through the vectorized cumsum fallback."""
    import fft_restoration_tpu.utils.imageio as iio

    monkeypatch.setattr(iio, "_load_native", lambda: False)
    truth = (rng.random((5, 7, 3)) * 255).astype(np.uint8)
    lines = bytearray()
    for y in range(5):
        raw = truth[y].reshape(-1).astype(np.int16)
        filt = raw.copy()
        filt[3:] = (raw[3:] - raw[:-3]) & 0xFF
        lines += b"\x01" + filt.astype(np.uint8).tobytes()
    img = iio.decode_png(_make_png(7, 5, 8, 2, bytes(lines)))
    assert np.array_equal(img, truth)


def test_paeth_decode_python_fallback_warns(monkeypatch, rng):
    import fft_restoration_tpu.utils.imageio as iio

    monkeypatch.setattr(iio, "_load_native", lambda: False)
    # encode with cv2 (which uses adaptive filters incl. Paeth/Average on
    # natural gradients) and decode through the pure-Python path
    truth = np.add.outer(np.arange(32), np.arange(48)).astype(np.uint8)
    truth = np.stack([truth, truth[::-1], (truth * 3 + 17)], axis=-1)
    ok, buf = cv2.imencode(".png", truth)
    assert ok
    data = bytes(buf.tobytes())
    import warnings as _w

    with _w.catch_warnings(record=True):
        _w.simplefilter("always")
        img = iio.decode_png(data)
    # cv2.imencode takes BGR and writes RGB into the PNG; decode_png
    # returns the stored RGB order
    assert np.array_equal(img, truth[..., ::-1])


# ---------------------------------------------------------------------------
# sub-byte bit depths (1/2/4): gray and palette, sequential and Adam7
# (cv::imread decodes these; round 4 closed the parity tail)


def _raw_png(samples, depth, color_type, interlace, palette=None):
    """Hand-craft a PNG: (H, W) sample values at the given bit depth,
    filter 0 scanlines, optional Adam7 interlacing (PIL cannot write
    interlaced or 2/4-bit gray files, so the fixtures are built here)."""
    import struct
    import zlib

    h, w = samples.shape

    def pack_rows(sub):
        rows = []
        for y in range(sub.shape[0]):
            bits = np.unpackbits(sub[y].astype(np.uint8)[:, None], axis=1)[
                :, 8 - depth :
            ].reshape(-1)
            pad = (-len(bits)) % 8
            bits = np.concatenate([bits, np.zeros(pad, np.uint8)])
            rows.append(b"\x00" + np.packbits(bits).tobytes())
        return b"".join(rows)

    if interlace:
        grid = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
                (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
        raw = b"".join(
            pack_rows(samples[y0::dy, x0::dx])
            for x0, y0, dx, dy in grid
            if samples[y0::dy, x0::dx].size
        )
    else:
        raw = pack_rows(samples)

    def chunk(ctype, payload):
        c = ctype + payload
        return struct.pack(">I", len(payload)) + c + struct.pack(
            ">I", zlib.crc32(c) & 0xFFFFFFFF
        )

    ihdr = struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, interlace)
    parts = [b"\x89PNG\r\n\x1a\n", chunk(b"IHDR", ihdr)]
    if palette is not None:
        parts.append(chunk(b"PLTE", palette.astype(np.uint8).tobytes()))
    parts.append(chunk(b"IDAT", zlib.compress(raw)))
    parts.append(chunk(b"IEND", b""))
    return b"".join(parts)


@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("interlace", [0, 1])
def test_subbyte_gray_matches_cv2(depth, interlace, rng):
    samples = rng.integers(0, 1 << depth, (13, 19), dtype=np.uint8)
    blob = _raw_png(samples, depth, 0, interlace)
    ref = cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_GRAYSCALE)
    assert ref is not None
    np.testing.assert_array_equal(decode_png(blob), ref)


@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("interlace", [0, 1])
def test_subbyte_palette_matches_cv2(depth, interlace, rng):
    n = 1 << depth
    palette = rng.integers(0, 256, (n, 3), dtype=np.uint8)
    samples = rng.integers(0, n, (11, 23), dtype=np.uint8)
    blob = _raw_png(samples, depth, 3, interlace, palette=palette)
    ref = cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_COLOR)
    assert ref is not None
    ours = decode_png(blob)  # RGB; cv2 returns BGR
    np.testing.assert_array_equal(ours[..., ::-1], ref)


def test_subbyte_pil_written_palette(rng):
    """A PIL-written 4-bit palette PNG (bits=4) decodes identically."""
    import io

    from PIL import Image

    img = (rng.random((24, 32, 3)) * 255).astype(np.uint8)
    pal = Image.fromarray(img).convert(
        "P", palette=Image.Palette.ADAPTIVE, colors=16
    )
    buf = io.BytesIO()
    pal.save(buf, "PNG", bits=4)
    blob = buf.getvalue()
    ref = cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(decode_png(blob)[..., ::-1], ref)
