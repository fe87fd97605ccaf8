"""AV1/AVIF decoder tests: container + header parse (phase A) against
streams written by this environment's OpenCV 5.0 (libavif/libaom) —
the cv::imread surface of the reference's serial.cpp:22."""

import cv2
import numpy as np
import pytest

from fft_restoration_tpu.utils.av1 import (
    parse_avif,
    parse_frame_header,
    parse_sequence_header,
    probe_avif_size,
    split_obus,
)


def _enc(img, q=None):
    params = [cv2.IMWRITE_AVIF_QUALITY, q] if q is not None else []
    ok, buf = cv2.imencode(".avif", img, params)
    assert ok
    return buf.tobytes()


def _grad(h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.zeros((h, w, 3), np.uint8)
    img[..., 0] = (xx * 2) % 256
    img[..., 1] = (yy * 3) % 256
    img[..., 2] = (xx + yy) % 256
    return img


def _headers(data):
    item = parse_avif(data)
    obus = split_obus(item.data)
    seq = parse_sequence_header(next(p for t, p in obus if t == 1))
    hdr = parse_frame_header(next(p for t, p in obus if t in (3, 6)), seq)
    return item, seq, hdr


class TestContainer:
    def test_primary_item_and_dims(self):
        item, seq, hdr = _headers(_enc(_grad(64, 96)))
        assert (item.width, item.height) == (96, 64)
        assert (hdr.width, hdr.height) == (96, 64)
        assert item.depth == 8 and not item.monochrome

    def test_probe_size_matches_cv2(self):
        for h, w in [(64, 96), (37, 53), (80, 112)]:
            data = _enc(_grad(h, w))
            assert probe_avif_size(data) == (h, w)

    def test_colr_nclx(self):
        # cv2 lossy: BT.601 full range (the JPEG convention)
        item, _, _ = _headers(_enc(_grad(64, 64), 50))
        assert item.matrix == 6 and item.full_range

    def test_corrupt_container_raises(self):
        good = _enc(_grad(32, 32))
        for mutate in [
            lambda b: b[:20],  # truncated
            lambda b: b.replace(b"meta", b"zeta", 1),
            lambda b: b.replace(b"pitm", b"zitm", 1),
        ]:
            with pytest.raises(ValueError):
                parse_avif(bytes(mutate(bytearray(good))))

    def test_obu_framing(self):
        item, _, _ = _headers(_enc(_grad(32, 32)))
        types = [t for t, _ in split_obus(item.data)]
        assert 1 in types  # sequence header
        assert 6 in types or (3 in types and 4 in types)  # frame payload


class TestHeaders:
    def test_lossy_defaults(self):
        _, seq, hdr = _headers(_enc(_grad(64, 96)))
        assert seq.seq_profile == 0
        assert seq.still_picture and seq.reduced_still_picture_header
        assert (seq.subsampling_x, seq.subsampling_y) == (1, 1)
        assert not seq.enable_restoration and not seq.enable_superres
        assert seq.enable_cdef and seq.enable_filter_intra
        assert hdr.base_q_idx > 0 and not hdr.coded_lossless
        assert hdr.tile_cols == 1 and hdr.tile_rows == 1
        assert not hdr.allow_intrabc
        assert not hdr.segmentation_enabled

    def test_q100_is_lossless_444(self):
        _, seq, hdr = _headers(_enc(_grad(64, 96), 100))
        assert hdr.coded_lossless and hdr.base_q_idx == 0
        # identity matrix coefficients force 4:4:4
        assert seq.matrix_coefficients == 0
        assert (seq.subsampling_x, seq.subsampling_y) == (0, 0)
        assert hdr.loop_filter_level == (0, 0, 0, 0)

    def test_quality_sweep_parses(self, car_png):
        img = cv2.imread(car_png)[:80, :112]
        for q in (0, 15, 40, 75, 95, 100):
            _, seq, hdr = _headers(_enc(img, q))
            assert (hdr.width, hdr.height) == (112, 80)
            assert hdr.header_bitpos % 8 == 0

    def test_big_fixture(self, cat_png):
        img = cv2.imread(cat_png)
        _, seq, hdr = _headers(_enc(img))
        assert (hdr.width, hdr.height) == (1920, 782)
        assert hdr.mi_cols == 480 and hdr.mi_rows == 196

    def test_delta_q_is_twos_complement(self):
        # cv2 default streams carry a negative chroma AC delta; the
        # su(1+6) read must be two's complement, not sign-magnitude
        _, _, hdr = _headers(_enc(_grad(64, 96)))
        assert -63 <= hdr.delta_q_u_ac <= 0
        assert hdr.delta_q_u_dc == hdr.delta_q_u_ac or True  # both read
        assert abs(hdr.delta_q_u_ac) < 40


# ---------------------------------------------------------------------------
# Phase B-E: full decode. Ladder: reconstruction / +deblock / +CDEF are
# each pinned plane-exact vs libdav1d (tests/dav1d_oracle.py), then the
# RGB output is pinned bit-exact vs cv2.imdecode (libavif+libyuv).


def _dav1d():
    oracle = pytest.importorskip("dav1d_oracle")
    try:
        oracle._load()
    except OSError:
        pytest.skip("libdav1d not available")
    return oracle


def _decode_planes(data, **kw):
    from fft_restoration_tpu.utils.av1_decode import decode_frame

    item = parse_avif(data)
    seq = hdr = tile = None
    for t, p in split_obus(item.data):
        if t == 1:
            seq = parse_sequence_header(p)
        elif t == 6:
            hdr = parse_frame_header(p, seq)
            tile = p[(hdr.header_bitpos + 7) // 8:]
    return decode_frame(seq, hdr, tile, **kw), item


def _noise(h, w, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (h, w, 3)
    ).astype(np.uint8)


class TestTileDecode:
    @pytest.mark.parametrize("shape", [(64, 64), (40, 40), (33, 57)])
    def test_recon_exact_vs_dav1d(self, shape):
        oracle = _dav1d()
        data = _enc(_grad(*shape), 40)
        planes, _ = _decode_planes(
            data, apply_deblock=False, apply_cdef=False
        )
        ref, _, _ = oracle.decode_yuv(
            parse_avif(data).data, oracle.INLOOP_NONE
        )
        for ours, theirs in zip(planes, ref):
            np.testing.assert_array_equal(ours, theirs)

    def test_deblock_exact_vs_dav1d(self):
        oracle = _dav1d()
        img = np.zeros((64, 64, 3), np.uint8)
        img[:, 32:] = 230  # one hard edge -> the wide 14-tap path
        for data in (_enc(img, 40), _enc(_noise(100, 100), 30)):
            planes, _ = _decode_planes(data, apply_cdef=False)
            ref, _, _ = oracle.decode_yuv(
                parse_avif(data).data, oracle.INLOOP_DEBLOCK
            )
            for ours, theirs in zip(planes, ref):
                np.testing.assert_array_equal(ours, theirs)

    @pytest.mark.parametrize("shape", [(64, 64), (33, 57), (100, 100)])
    def test_full_pipeline_exact_vs_dav1d(self, shape):
        oracle = _dav1d()
        data = _enc(_noise(*shape), 40)
        planes, _ = _decode_planes(data)
        ref, _, _ = oracle.decode_yuv(
            parse_avif(data).data, oracle.INLOOP_ALL
        )
        for ours, theirs in zip(planes, ref):
            np.testing.assert_array_equal(ours, theirs)

    def test_bottom_edge_overhang(self, car_png):
        # 330 % 8 != 0: the mi-grid overhang is NOT deblocked (dav1d
        # f->h4 semantics) and feeds CDEF's direction search
        oracle = _dav1d()
        img = cv2.imread(car_png)
        data = _enc(img, 30)
        planes, _ = _decode_planes(data)
        ref, _, _ = oracle.decode_yuv(
            parse_avif(data).data, oracle.INLOOP_ALL
        )
        for ours, theirs in zip(planes, ref):
            np.testing.assert_array_equal(ours, theirs)


class TestAvifRGB:
    @pytest.mark.parametrize("q", [30, 75, 90, 100])
    def test_bit_exact_vs_cv2(self, q, car_png):
        from fft_restoration_tpu.utils.av1 import decode_avif

        img = cv2.imread(car_png)
        data = _enc(img, q)
        ours = decode_avif(data)
        ref = cv2.imdecode(
            np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR
        )
        np.testing.assert_array_equal(ours[..., ::-1], ref)

    @pytest.mark.parametrize("shape", [(33, 57), (97, 35)])
    def test_odd_dims_bit_exact(self, shape):
        # odd output width exercises libyuv's vertical-only last column
        from fft_restoration_tpu.utils.av1 import decode_avif

        data = _enc(_noise(*shape), 50)
        ours = decode_avif(data)
        ref = cv2.imdecode(
            np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR
        )
        np.testing.assert_array_equal(ours[..., ::-1], ref)

    def test_gray_bit_exact(self, car_png):
        from fft_restoration_tpu.utils.av1 import decode_avif

        img = cv2.cvtColor(
            cv2.imread(car_png),
            cv2.COLOR_BGR2GRAY,
        )
        data = _enc(img, 60)
        ours = decode_avif(data)
        ref = cv2.imdecode(
            np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED
        )
        assert ours.ndim == 2
        np.testing.assert_array_equal(ours, ref)

    @pytest.mark.parametrize("q", [30, 60, 90])
    def test_gray_flat_bit_exact(self, q):
        # a flat lossy monochrome frame codes CDEF strengths for luma
        # only; reading chroma strengths too misaligns the header
        from fft_restoration_tpu.utils.av1 import decode_avif

        data = _enc(np.full((64, 64), 128, np.uint8), q)
        ours = decode_avif(data)
        ref = cv2.imdecode(
            np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED
        )
        np.testing.assert_array_equal(ours, ref)

    def test_alpha_bit_exact(self, car_png):
        from fft_restoration_tpu.utils.av1 import decode_avif

        img = cv2.cvtColor(
            cv2.imread(car_png),
            cv2.COLOR_BGR2BGRA,
        )
        img[..., 3] = 200
        data = _enc(img, 70)
        ours = decode_avif(data)
        ref = cv2.imdecode(
            np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED
        )
        assert ours.shape[2] == 4
        np.testing.assert_array_equal(ours[..., [2, 1, 0, 3]], ref)

    def test_imread_dispatch(self, tmp_path, car_png):
        from fft_restoration_tpu.utils.imageio import imread

        img = cv2.imread(car_png)
        p = tmp_path / "x.avif"
        p.write_bytes(_enc(img, 70))
        ours = imread(str(p))
        ref = cv2.imread(str(p))
        np.testing.assert_array_equal(ours, ref)

    def test_corrupt_payload_raises(self):
        data = bytearray(_enc(_grad(32, 32), 50))
        # truncate the mdat payload
        with pytest.raises(ValueError):
            from fft_restoration_tpu.utils.av1 import decode_avif

            decode_avif(bytes(data[: len(data) // 2]))
