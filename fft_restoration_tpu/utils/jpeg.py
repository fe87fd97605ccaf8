"""JPEG (JFIF) decoder — own codec, no OpenCV/PIL.

The reference ingests images through cv::imread
(/root/reference/serial.cpp:22), which accepts JPEG alongside PNG. This
module brings the framework's own codec to driver parity for the JPEG
case: baseline sequential AND progressive (T.81 Annex G: spectral
selection + successive approximation) Huffman DCT, 8-bit, grayscale or
YCbCr (any common subsampling), restart markers.
Arithmetic/lossless/hierarchical/12-bit streams raise ValueError with a
clear message naming the spec gap.

Decode pipeline: marker parse -> Huffman entropy decode -> dequantize +
dezigzag -> batched 8x8 IDCT -> chroma upsample (libjpeg 'fancy'
triangular for 2x) -> YCbCr->RGB (JFIF/BT.601).

Performance lanes: the BASELINE scan decode and the whole back half
(dequant/IDCT/upsample/color) run in C++ when native/libpngfilt.so is
built (~45 MP/s measured; jpeg_decode_scan + jpeg_backend_rgb), with
this module's NumPy path as the transparent fallback. PROGRESSIVE
entropy decode is pure-Python per-block loops (inherently sequential
across bands/passes; an ingest path, not a hot path) feeding the same
native back half.
"""

from __future__ import annotations

import struct

import numpy as np

ZIGZAG = np.array(
    [
        0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
        12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
        35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
        58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    ],
    dtype=np.int32,
)

# DCT-II orthonormal basis; IDCT of block X is M.T @ X @ M with
# M[k, x] = c(k) * cos((2x+1) k pi / 16). float32 throughout: |coef| <=
# ~2^20, so f32 keeps the IDCT within ~1e-3 of exact — far under the
# final round-to-uint8.
_K = np.arange(8, dtype=np.float64)
_M = np.cos((2.0 * _K[None, :] + 1.0) * _K[:, None] * np.pi / 16.0)
_M[0] *= 1.0 / np.sqrt(2.0)
_M = (_M * 0.5).astype(np.float32)


class _Huff:
    """Canonical Huffman table resolved through a 16-bit lookup: every
    16-bit window maps to (symbol, code length) in one indexed read
    (codes are <= 16 bits, so the window always contains a full code)."""

    def __init__(self, counts, symbols):
        self.symbols = np.asarray(symbols, np.uint8)
        self.lut_sym = np.zeros(1 << 16, np.uint8)
        self.lut_len = np.zeros(1 << 16, np.uint8)  # 0 = invalid code
        code = 0
        k = 0
        for length in range(1, 17):
            for _ in range(counts[length - 1]):
                lo = code << (16 - length)
                hi = (code + 1) << (16 - length)
                self.lut_sym[lo:hi] = self.symbols[k]
                self.lut_len[lo:hi] = length
                code += 1
                k += 1
            code <<= 1

    def lut_lookup(self, window16: int):
        length = int(self.lut_len[window16])
        if length == 0:
            raise ValueError("corrupt JPEG: invalid Huffman code")
        return int(self.lut_sym[window16]), length


class _BitReader:
    """MSB-first bit reader over a stuffing-stripped segment.

    Decoding speed matters for batch ingest, so instead of walking bits
    one at a time this precomputes a sliding 16-bit window per bit
    position (one vectorized matmul) and resolves each Huffman symbol /
    value field with a single table lookup — the classic libjpeg
    16-bit-LUT decode, in NumPy."""

    _POW2_16 = (1 << np.arange(15, -1, -1)).astype(np.uint16)

    def __init__(self, data: bytes):
        bits = np.unpackbits(np.frombuffer(data, np.uint8))
        self.n_bits = len(bits)
        # pad so the window is defined up to the last bit
        padded = np.concatenate([bits, np.zeros(16, np.uint8)])
        from numpy.lib.stride_tricks import sliding_window_view

        self.win = sliding_window_view(padded, 16)[: self.n_bits].astype(
            np.uint16
        ) @ self._POW2_16
        self.pos = 0

    def read_bits(self, n: int) -> int:
        if n == 0:
            return 0
        if self.pos + n > self.n_bits:
            raise ValueError("corrupt JPEG: entropy data exhausted")
        v = int(self.win[self.pos]) >> (16 - n)
        self.pos += n
        return v

    def decode(self, table: _Huff) -> int:
        if self.pos >= self.n_bits:
            raise ValueError("corrupt JPEG: entropy data exhausted")
        sym, length = table.lut_lookup(int(self.win[self.pos]))
        if self.pos + length > self.n_bits:
            raise ValueError("corrupt JPEG: entropy data exhausted")
        self.pos += length
        return sym


def _extend(v: int, s: int) -> int:
    """T.81 F.2.2.1: signed magnitude extension of an s-bit value."""
    return v - (1 << s) + 1 if s and v < (1 << (s - 1)) else v


def _strip_stuffing(data: bytes) -> bytes:
    return data.replace(b"\xff\x00", b"\xff")


def _decode_entropy(segments, comps, comp_tables, plan, n_mcu, restart_interval):
    """Huffman-decode all restart segments -> (n_mcu, blocks_per_mcu, 64)
    int32 coefficient blocks (zigzag order). Uses the C++ scan decoder
    (native/png_codec.cpp jpeg_decode_scan) when built — the entropy
    loop is inherently sequential and runs ~50x faster native — with
    this module's LUT BitReader as the pure-Python fallback."""
    bpm = len(plan)
    out = np.zeros((n_mcu, bpm, 64), np.int32)

    from fft_restoration_tpu.utils.imageio import _load_native

    lib = _load_native()
    native = lib and hasattr(lib, "jpeg_decode_scan")
    if native:
        import ctypes

        n_comps = len(comps)
        lut_sym = np.zeros((2 * n_comps, 1 << 16), np.uint8)
        lut_len = np.zeros((2 * n_comps, 1 << 16), np.uint8)
        for ci, (dc_t, ac_t) in comp_tables.items():
            lut_sym[2 * ci] = dc_t.lut_sym
            lut_len[2 * ci] = dc_t.lut_len
            lut_sym[2 * ci + 1] = ac_t.lut_sym
            lut_len[2 * ci + 1] = ac_t.lut_len
        block_comp = np.asarray([p[0] for p in plan], np.int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        mcu_idx = 0
        for seg_data in segments:
            data = _strip_stuffing(seg_data)
            limit = (
                min(mcu_idx + restart_interval, n_mcu)
                if restart_interval
                else n_mcu
            )
            n_seg = limit - mcu_idx
            if n_seg <= 0:
                break
            rc = lib.jpeg_decode_scan(
                data,
                len(data),
                n_comps,
                lut_sym.ctypes.data_as(u8p),
                lut_len.ctypes.data_as(u8p),
                block_comp.ctypes.data_as(i32p),
                bpm,
                n_seg,
                out[mcu_idx].ctypes.data_as(i32p),
            )
            if rc != 0:
                raise ValueError(
                    f"corrupt JPEG: entropy decode failed (code {rc})"
                )
            mcu_idx = limit
        return out

    mcu_idx = 0
    for seg_data in segments:
        reader = _BitReader(_strip_stuffing(seg_data))
        preds = [0] * len(comps)
        limit = (
            min(mcu_idx + restart_interval, n_mcu) if restart_interval else n_mcu
        )
        while mcu_idx < limit:
            for j, (ci, _v, _hh) in enumerate(plan):
                dc_t, ac_t = comp_tables[ci]
                blk = out[mcu_idx, j]
                s = reader.decode(dc_t)
                diff = _extend(reader.read_bits(s), s)
                preds[ci] += diff
                blk[0] = preds[ci]
                kk = 1
                while kk < 64:
                    rs = reader.decode(ac_t)
                    r, ssz = rs >> 4, rs & 15
                    if ssz == 0:
                        if r == 15:
                            kk += 16
                            continue
                        break  # EOB
                    kk += r
                    if kk > 63:
                        raise ValueError("corrupt JPEG: AC overflow")
                    blk[kk] = _extend(reader.read_bits(ssz), ssz)
                    kk += 1
            mcu_idx += 1
    return out


def _native_backend(
    blocks, comps, qtables, plan, mcux, mcuy, hmax, vmax, h, w
):
    """Full native back half (dequant + IDCT + upsample + color) via
    native/png_codec.cpp jpeg_backend_rgb. Returns the decoded image, or
    None to fall back to the NumPy path (no .so, unusual layout, or a
    native error). Bitwise-matched to the NumPy path: same float32 DCT
    basis, fancy 2x upsample, BT.601 coefficients, round-half-even."""
    from fft_restoration_tpu.utils.imageio import _load_native

    lib = _load_native()
    if not lib or not hasattr(lib, "jpeg_backend_rgb") or len(comps) not in (1, 3):
        return None
    import ctypes

    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    block_comp = np.ascontiguousarray([p[0] for p in plan], np.int32)
    block_v = np.ascontiguousarray([p[1] for p in plan], np.int32)
    block_h = np.ascontiguousarray([p[2] for p in plan], np.int32)
    comp_h = np.ascontiguousarray([c["h"] for c in comps], np.int32)
    comp_v = np.ascontiguousarray([c["v"] for c in comps], np.int32)
    qtab = np.ascontiguousarray(
        np.stack([qtables[c["tq"]] for c in comps]), np.int32
    )
    out = (
        np.empty((h, w, 3), np.uint8)
        if len(comps) == 3
        else np.empty((h, w), np.uint8)
    )
    blocks = np.ascontiguousarray(blocks, np.int32)
    rc = lib.jpeg_backend_rgb(
        blocks.ctypes.data_as(i32p),
        ctypes.c_int64(blocks.shape[0]),
        int(blocks.shape[1]),
        block_comp.ctypes.data_as(i32p),
        block_v.ctypes.data_as(i32p),
        block_h.ctypes.data_as(i32p),
        len(comps),
        comp_h.ctypes.data_as(i32p),
        comp_v.ctypes.data_as(i32p),
        qtab.ctypes.data_as(i32p),
        mcux,
        mcuy,
        hmax,
        vmax,
        h,
        w,
        out.ctypes.data_as(u8p),
    )
    return out if rc == 0 else None


def _upsample(plane: np.ndarray, factor: int, axis: int) -> np.ndarray:
    """Chroma upsampling. factor 2 = libjpeg 'fancy' triangular filter
    (jdsample.c h2v1/h2v2): out[2i] = (3*s[i] + s[i-1])/4,
    out[2i+1] = (3*s[i] + s[i+1])/4, edges replicated. Matches the
    default libjpeg/cv2 decode; nearest for other factors."""
    if factor == 1:
        return plane
    if factor != 2:
        return np.repeat(plane, factor, axis=axis)
    s = np.moveaxis(plane, axis, 0)
    prev = np.concatenate([s[:1], s[:-1]], axis=0)
    nxt = np.concatenate([s[1:], s[-1:]], axis=0)
    out = np.empty((2 * s.shape[0],) + s.shape[1:], s.dtype)
    out[0::2] = (3.0 * s + prev) * 0.25
    out[1::2] = (3.0 * s + nxt) * 0.25
    return np.moveaxis(out, 0, axis)


def _split_restarts(entropy: bytes, restart_interval: int):
    """Split entropy data on RSTn markers (byte-aligned; FF-00 stuffing
    means a bare FF Dn is always a real marker, so slicing is exact)."""
    if not restart_interval:
        return [entropy]
    earr = np.frombuffer(entropy, np.uint8)
    ff = np.flatnonzero(earr[: len(entropy) - 1] == 0xFF)
    marks = (
        ff[(earr[ff + 1] >= 0xD0) & (earr[ff + 1] <= 0xD7)] if ff.size else ff
    )
    segments = []
    start = 0
    for m in marks.tolist():
        segments.append(entropy[start:m])
        start = m + 2
    segments.append(entropy[start:])
    return segments


def _ac_first(reader, ac_t, blk, ss, se, al, eobrun):
    """Progressive AC first pass (T.81 G.1.2.2): band ss..se (zigzag
    indices), values shifted left al, EOBn run codes span blocks.
    Returns the remaining EOB run."""
    if eobrun > 0:
        return eobrun - 1
    k = ss
    while k <= se:
        rs = reader.decode(ac_t)
        r, s = rs >> 4, rs & 15
        if s == 0:
            if r == 15:  # ZRL: 16 zero coefficients
                k += 16
                continue
            eobrun = (1 << r) - 1
            if r:
                eobrun += reader.read_bits(r)
            return eobrun
        k += r
        if k > se:
            raise ValueError("corrupt JPEG: AC band overflow")
        blk[k] = _extend(reader.read_bits(s), s) << al
        k += 1
    return 0


def _ac_refine(reader, ac_t, blk, ss, se, al, eobrun):
    """Progressive AC refinement (T.81 G.1.2.3): append one magnitude
    bit (position al) to already-nonzero coefficients and introduce
    newly-nonzero ones at ±(1<<al). Correction bits are read for EVERY
    nonzero coefficient the scan passes over."""
    p1 = 1 << al
    m1 = -p1
    k = ss
    if eobrun == 0:
        while k <= se:
            rs = reader.decode(ac_t)
            r, s = rs >> 4, rs & 15
            newval = 0
            if s == 0:
                if r != 15:
                    eobrun = 1 << r
                    if r:
                        eobrun += reader.read_bits(r)
                    break
                # ZRL: advance over 16 zero-history coefficients below
            else:
                if s != 1:
                    raise ValueError("corrupt JPEG: bad refinement size")
                newval = p1 if reader.read_bits(1) else m1
            while k <= se:
                v = blk[k]
                if v != 0:
                    if reader.read_bits(1) and (v & p1) == 0:
                        blk[k] = v + (p1 if v >= 0 else m1)
                else:
                    if r == 0:
                        break
                    r -= 1
                k += 1
            if newval and k <= se:
                blk[k] = newval
            k += 1
    if eobrun > 0:
        while k <= se:
            v = blk[k]
            if v != 0 and reader.read_bits(1) and (v & p1) == 0:
                blk[k] = v + (p1 if v >= 0 else m1)
            k += 1
        eobrun -= 1
    return eobrun


def _decode_progressive(scans, comps, by_id, h, w, hmax, vmax, mcux, mcuy):
    """Decode all progressive scans (T.81 Annex G, Huffman: spectral
    selection + successive approximation) into per-component coefficient
    grids (blocks_y, blocks_x, 64), zigzag order.

    The per-block band/approximation bit loops run in C++ when the
    native lane is built (native/png_codec.cpp jpeg_decode_prog_dc/_ac,
    a host-side speedup on progressive photos); the pure-Python loops below are the always-working
    fallback and the parity oracle. cv::imread accepts these streams
    (serial.cpp:22)."""
    from fft_restoration_tpu.utils.imageio import _load_native

    lib = _load_native()
    native = lib if lib and hasattr(lib, "jpeg_decode_prog_ac") else None
    if native is not None:
        import ctypes

        _i32p = ctypes.POINTER(ctypes.c_int32)
        _i64p = ctypes.POINTER(ctypes.c_int64)
        _u8p = ctypes.POINTER(ctypes.c_uint8)
        _i64 = ctypes.c_longlong

    coef = [
        np.zeros((mcuy * c["v"], mcux * c["h"], 64), np.int32) for c in comps
    ]

    def _native_dc_scan(scan, idxs, dc_tables, ah, al, plan, units_per_row,
                        n_units, segments):
        """One DC scan through jpeg_decode_prog_dc (per restart
        segment; the predictor resets at segment boundaries)."""
        n = len(idxs)
        local = {ci: k for k, ci in enumerate(idxs)}
        lut_sym = np.zeros((n, 1 << 16), np.uint8)
        lut_len = np.zeros((n, 1 << 16), np.uint8)
        if ah == 0:
            for ci in idxs:
                lut_sym[local[ci]] = dc_tables[ci].lut_sym
                lut_len[local[ci]] = dc_tables[ci].lut_len
        comp_base = (_i32p * n)(
            *[coef[ci].ctypes.data_as(_i32p) for ci in idxs]
        )
        comp_stride = np.asarray(
            [coef[ci].shape[1] * 64 for ci in idxs], np.int64
        )
        if len(idxs) > 1:  # MCU walk: true sampling factors
            comp_ch = np.asarray([comps[ci]["h"] for ci in idxs], np.int32)
            comp_cv = np.asarray([comps[ci]["v"] for ci in idxs], np.int32)
        else:  # single-component scan walks its own block grid
            comp_ch = np.ones(1, np.int32)
            comp_cv = np.ones(1, np.int32)
        plan_comp = np.asarray([local[p[0]] for p in plan], np.int32)
        plan_v = np.asarray([p[1] for p in plan], np.int32)
        plan_h = np.asarray([p[2] for p in plan], np.int32)
        pred = np.zeros(n, np.int32)
        unit = 0
        for seg_data in segments:
            data = _strip_stuffing(seg_data)
            limit = (
                min(unit + scan["ri"], n_units) if scan["ri"] else n_units
            )
            if limit <= unit:
                break
            pred[:] = 0
            rc = lib.jpeg_decode_prog_dc(
                data, _i64(len(data)),
                lut_sym.ctypes.data_as(_u8p), lut_len.ctypes.data_as(_u8p),
                int(ah != 0), al, n,
                comp_base, comp_stride.ctypes.data_as(_i64p),
                comp_ch.ctypes.data_as(_i32p), comp_cv.ctypes.data_as(_i32p),
                len(plan),
                plan_comp.ctypes.data_as(_i32p),
                plan_v.ctypes.data_as(_i32p),
                plan_h.ctypes.data_as(_i32p),
                _i64(units_per_row), _i64(unit), _i64(limit - unit),
                pred.ctypes.data_as(_i32p),
            )
            if rc != 0:
                raise ValueError(
                    f"corrupt JPEG: progressive DC decode failed ({rc})"
                )
            unit = limit

    for scan in scans:
        idxs = [by_id[sc["id"]] for sc in scan["comps"]]
        ss, se, ah, al = scan["ss"], scan["se"], scan["ah"], scan["al"]
        segments = _split_restarts(scan["entropy"], scan["ri"])
        if ss == 0:
            if se != 0:
                raise ValueError("corrupt JPEG: DC scan with Se != 0")
            dc_tables = {
                by_id[sc["id"]]: scan["dc"].get(sc["dc"])
                for sc in scan["comps"]
            }
            # first DC pass (ah == 0) entropy-decodes through the table;
            # refinement passes read raw bits and never touch it
            if ah == 0 and any(t is None for t in dc_tables.values()):
                raise ValueError(
                    "corrupt JPEG: DC scan references an undefined "
                    "Huffman table"
                )
            if len(idxs) > 1:
                # interleaved DC scan: MCU walk over the full grid
                plan = [
                    (ci, v, hh)
                    for ci in idxs
                    for v in range(comps[ci]["v"])
                    for hh in range(comps[ci]["h"])
                ]
                n_units = mcux * mcuy
                if native is not None:
                    _native_dc_scan(scan, idxs, dc_tables, ah, al, plan,
                                    mcux, n_units, segments)
                    continue
                unit = 0
                for seg_data in segments:
                    reader = _BitReader(_strip_stuffing(seg_data))
                    preds = {ci: 0 for ci in idxs}
                    limit = (
                        min(unit + scan["ri"], n_units)
                        if scan["ri"]
                        else n_units
                    )
                    while unit < limit:
                        uy, ux = divmod(unit, mcux)
                        for ci, v, hh in plan:
                            c = comps[ci]
                            blk = coef[ci][uy * c["v"] + v, ux * c["h"] + hh]
                            if ah == 0:
                                s = reader.decode(dc_tables[ci])
                                preds[ci] += _extend(reader.read_bits(s), s)
                                blk[0] = preds[ci] << al
                            elif reader.read_bits(1):
                                blk[0] |= 1 << al
                        unit += 1
            else:
                ci = idxs[0]
                c = comps[ci]
                cw = -(-(w * c["h"]) // hmax)
                chh = -(-(h * c["v"]) // vmax)
                bw, bh = -(-cw // 8), -(-chh // 8)
                if native is not None:
                    _native_dc_scan(scan, idxs, dc_tables, ah, al,
                                    [(ci, 0, 0)], bw, bw * bh, segments)
                    continue
                unit = 0
                for seg_data in segments:
                    reader = _BitReader(_strip_stuffing(seg_data))
                    pred = 0
                    limit = (
                        min(unit + scan["ri"], bw * bh)
                        if scan["ri"]
                        else bw * bh
                    )
                    while unit < limit:
                        uy, ux = divmod(unit, bw)
                        blk = coef[ci][uy, ux]
                        if ah == 0:
                            s = reader.decode(dc_tables[ci])
                            pred += _extend(reader.read_bits(s), s)
                            blk[0] = pred << al
                        elif reader.read_bits(1):
                            blk[0] |= 1 << al
                        unit += 1
        else:
            # AC scans are always single-component (T.81 G.1.1.1)
            if len(idxs) != 1:
                raise ValueError("corrupt JPEG: interleaved AC scan")
            ci = idxs[0]
            c = comps[ci]
            ac_t = scan["ac"].get(scan["comps"][0]["ac"])
            if ac_t is None:
                raise ValueError("corrupt JPEG: missing AC table")
            cw = -(-(w * c["h"]) // hmax)
            chh = -(-(h * c["v"]) // vmax)
            bw, bh = -(-cw // 8), -(-chh // 8)
            if native is not None:
                unit = 0
                for seg_data in segments:
                    data = _strip_stuffing(seg_data)
                    limit = (
                        min(unit + scan["ri"], bw * bh)
                        if scan["ri"]
                        else bw * bh
                    )
                    if limit <= unit:
                        break
                    rc = lib.jpeg_decode_prog_ac(
                        data, _i64(len(data)),
                        ac_t.lut_sym.ctypes.data_as(_u8p),
                        ac_t.lut_len.ctypes.data_as(_u8p),
                        int(ah != 0), ss, se, al,
                        coef[ci].ctypes.data_as(_i32p),
                        _i64(coef[ci].shape[1] * 64),
                        _i64(bw), _i64(unit), _i64(limit - unit),
                    )
                    if rc != 0:
                        raise ValueError(
                            f"corrupt JPEG: progressive AC decode failed ({rc})"
                        )
                    unit = limit
                continue
            unit = 0
            for seg_data in segments:
                reader = _BitReader(_strip_stuffing(seg_data))
                eobrun = 0
                limit = (
                    min(unit + scan["ri"], bw * bh)
                    if scan["ri"]
                    else bw * bh
                )
                while unit < limit:
                    uy, ux = divmod(unit, bw)
                    blk = coef[ci][uy, ux]
                    if ah == 0:
                        eobrun = _ac_first(reader, ac_t, blk, ss, se, al, eobrun)
                    else:
                        eobrun = _ac_refine(reader, ac_t, blk, ss, se, al, eobrun)
                    unit += 1
    return coef


def decode_jpeg(data: bytes) -> np.ndarray:
    """Decode JPEG bytes -> uint8 RGB (H, W, 3) or gray (H, W).

    Baseline sequential (with the native fast lane) and progressive
    (spectral selection + successive approximation, Huffman) streams;
    arithmetic/lossless/hierarchical modes raise ValueError."""
    try:
        return _decode_jpeg(data)
    except (IndexError, struct.error) as e:
        # truncated/corrupt segments surface as slice/unpack failures
        # deep in the parser; the CLI skip contract wants ValueError
        raise ValueError(f"corrupt JPEG: {type(e).__name__}: {e}") from e


def _decode_jpeg(data: bytes) -> np.ndarray:
    if len(data) < 4 or data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file")
    pos = 2
    qtables = {}
    huff_dc = {}
    huff_ac = {}
    frame = None
    restart_interval = 0
    scans = []
    progressive = False
    adobe_transform = None
    saw_jfif = False

    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"corrupt JPEG: expected marker at {pos}")
        marker = data[pos + 1]
        if marker == 0xFF:  # fill byte (T.81 B.1.1.2): skip padding
            pos += 1
            continue
        pos += 2
        if marker == 0xD9:  # EOI
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:  # RSTn/TEM: bare
            continue
        (seglen,) = struct.unpack(">H", data[pos : pos + 2])
        seg = data[pos + 2 : pos + seglen]
        if marker == 0xDB:  # DQT
            p = 0
            while p < len(seg):
                pq, tq = seg[p] >> 4, seg[p] & 15
                p += 1
                if pq:
                    raise ValueError("16-bit quantization tables not supported")
                qtables[tq] = np.frombuffer(seg[p : p + 64], np.uint8).astype(
                    np.int32
                )
                p += 64
        elif marker in (0xC0, 0xC1, 0xC2):  # SOF0/1 baseline, SOF2 progressive
            progressive = marker == 0xC2
            precision, h, w, ncomp = struct.unpack(">BHHB", seg[:6])
            if precision != 8:
                raise ValueError(f"{precision}-bit JPEG not supported")
            comps = []
            for c in range(ncomp):
                cid, hv, tq = seg[6 + 3 * c : 9 + 3 * c]
                comps.append({"id": cid, "h": hv >> 4, "v": hv & 15, "tq": tq})
            frame = {"h": h, "w": w, "comps": comps}
        elif marker in (0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF):
            raise ValueError(
                "only baseline and progressive Huffman JPEG are supported "
                f"(SOF marker 0xFF{marker:02X}: lossless/arithmetic/"
                "hierarchical modes, T.81 Annexes H/J)"
            )
        elif marker == 0xC4:  # DHT
            p = 0
            while p < len(seg):
                tc, th = seg[p] >> 4, seg[p] & 15
                counts = list(seg[p + 1 : p + 17])
                nsym = sum(counts)
                symbols = list(seg[p + 17 : p + 17 + nsym])
                if tc == 0 and any(s > 15 for s in symbols):
                    # DC symbols are SSSS bit-lengths; >15 is spec-
                    # invalid and would turn into an out-of-range shift
                    # in the native scan lanes
                    raise ValueError("corrupt JPEG: DC Huffman symbol > 15")
                (huff_dc if tc == 0 else huff_ac)[th] = _Huff(counts, symbols)
                p += 17 + nsym
        elif marker == 0xDD:  # DRI
            (restart_interval,) = struct.unpack(">H", seg[:2])
        elif marker == 0xE0 and seg[:5] == b"JFIF\x00":
            saw_jfif = True
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            # APP14: color-transform flag for 4-component streams
            # (0 = CMYK as-is, 2 = YCCK)
            adobe_transform = seg[11]
        elif marker == 0xDA:  # SOS
            ns = seg[0]
            scan_comps = []
            for c in range(ns):
                cs, tdta = seg[1 + 2 * c : 3 + 2 * c]
                scan_comps.append({"id": cs, "dc": tdta >> 4, "ac": tdta & 15})
            # progression parameters (baseline: 0, 63, 0, 0)
            ss, se, a = seg[1 + 2 * ns : 4 + 2 * ns]
            scan_start = pos + seglen
            # entropy data runs until the next non-RST, non-stuffing
            # marker; vectorized scan (a per-byte Python loop here was
            # ~45% of the whole decode on a 1 MP image)
            arr = np.frombuffer(data, np.uint8)
            ff = np.flatnonzero(arr[scan_start : len(data) - 1] == 0xFF)
            if ff.size:
                nxt = arr[scan_start + ff + 1]
                real = ff[
                    (nxt != 0x00) & ~((nxt >= 0xD0) & (nxt <= 0xD7))
                ]
                p = scan_start + int(real[0]) if real.size else len(data) - 1
            else:
                p = len(data) - 1
            scans.append(
                {
                    "comps": scan_comps,
                    "ss": ss,
                    "se": se,
                    "ah": a >> 4,
                    "al": a & 15,
                    "entropy": data[scan_start:p],
                    "ri": restart_interval,
                    # DHT tables may be redefined between scans: snapshot
                    "dc": dict(huff_dc),
                    "ac": dict(huff_ac),
                }
            )
            pos = p
            continue
        pos += seglen

    if frame is None or not scans:
        raise ValueError("corrupt JPEG: missing SOF/SOS")
    scan_comps, entropy = scans[0]["comps"], scans[0]["entropy"]
    comps = frame["comps"]
    h, w = frame["h"], frame["w"]
    if len(comps) == 1:
        # T.81 A.2: a single-component scan is NON-interleaved — the MCU
        # is one data unit regardless of the SOF sampling factors (some
        # encoders keep luma 2x2 factors when dropping chroma)
        comps[0]["h"] = comps[0]["v"] = 1
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    mcux = -(-w // (8 * hmax))
    mcuy = -(-h // (8 * vmax))
    n_mcu = mcux * mcuy
    by_id = {c["id"]: i for i, c in enumerate(comps)}
    mcu = np.arange(n_mcu)
    my, mx = np.divmod(mcu, mcux)

    if progressive:
        coef = _decode_progressive(
            scans, comps, by_id, h, w, hmax, vmax, mcux, mcuy
        )
        # gather per-component grids into MCU-ordered blocks for the
        # shared (native/NumPy) back half
        plan = []
        for ci, c in enumerate(comps):
            for v in range(c["v"]):
                for hh in range(c["h"]):
                    plan.append((ci, v, hh))
        blocks = np.empty((n_mcu, len(plan), 64), np.int32)
        for j, (ci, v, hh) in enumerate(plan):
            c = comps[ci]
            blocks[:, j] = coef[ci][my * c["v"] + v, mx * c["h"] + hh]
    else:
        order = [by_id[sc["id"]] for sc in scan_comps]
        if sorted(order) != list(range(len(comps))):
            raise ValueError("non-interleaved scans not supported")
        segments = _split_restarts(entropy, scans[0]["ri"])
        # per-MCU block plan: (component, v, h) in interleave order
        plan = []
        for ci in order:
            c = comps[ci]
            for v in range(c["v"]):
                for hh in range(c["h"]):
                    plan.append((ci, v, hh))
        comp_tables = {}
        for sc in scan_comps:
            comp_tables[by_id[sc["id"]]] = (
                scans[0]["dc"][sc["dc"]],
                scans[0]["ac"][sc["ac"]],
            )
        blocks = _decode_entropy(
            segments, comps, comp_tables, plan, n_mcu, scans[0]["ri"]
        )
    bpm = len(plan)
    # libjpeg's jdmaster color-space guess for 3 components: JFIF wins
    # (YCbCr), then the Adobe transform flag (0 = stored RGB), else
    # component ids — 'R','G','B' marks an untransformed RGB stream
    # (the form libtiff's JPEG-in-TIFF codec writes for photometric
    # RGB, tested in tests/test_tiff.py). The native back half bakes in
    # the YCbCr conversion, so RGB-direct streams take the NumPy tail.
    rgb_direct = False
    if len(comps) == 3 and not saw_jfif:
        ids = [c["id"] for c in comps]
        rgb_direct = (
            adobe_transform == 0
            if adobe_transform is not None
            else ids == [0x52, 0x47, 0x42]
        )
    native_out = None if rgb_direct else _native_backend(
        blocks, comps, qtables, plan, mcux, mcuy, hmax, vmax, h, w
    )
    if native_out is not None:
        return native_out
    # scatter MCU-ordered blocks into per-component grids (vectorized)
    coef = [
        np.zeros((mcuy * c["v"], mcux * c["h"], 64), np.int32) for c in comps
    ]
    for j, (ci, v, hh) in enumerate(plan):
        c = comps[ci]
        coef[ci][my * c["v"] + v, mx * c["h"] + hh] = blocks[:, j]

    # dequantize + dezigzag + batched IDCT per component
    planes = []
    for ci, c in enumerate(comps):
        q = qtables[c["tq"]]
        blocks = (coef[ci] * q[None, None, :]).astype(np.float32)
        spatial = np.zeros(blocks.shape[:2] + (64,), np.float32)
        spatial[..., ZIGZAG] = blocks
        spatial = spatial.reshape(blocks.shape[:2] + (8, 8))
        # IDCT: M.T @ X @ M over every block, two batched 8x8 matmuls
        pix = np.einsum(
            "ky,...kl,lx->...yx", _M, spatial, _M, optimize=True
        ) + np.float32(128.0)
        by, bx = pix.shape[:2]
        plane = pix.transpose(0, 2, 1, 3).reshape(by * 8, bx * 8)
        # upsample to full resolution; 2x uses the triangular filter
        # libjpeg calls "fancy upsampling" (the default cv2/libjpeg
        # decode path), other factors use nearest
        plane = _upsample(plane, vmax // c["v"], axis=0)
        plane = _upsample(plane, hmax // c["h"], axis=1)
        planes.append(plane[: mcuy * vmax * 8, : mcux * hmax * 8])

    if len(planes) == 1:
        out = np.clip(np.round(planes[0]), 0, 255).astype(np.uint8)
        return out[:h, :w]
    if len(planes) == 4:
        # Adobe CMYK / YCCK. Stored samples follow the Adobe convention
        # (ink values inverted); libjpeg hands them through unchanged
        # and cv2 converts with R = k - (255-c)*k/256 etc. — replicated
        # here so cv::imread parity holds (tests/test_jpeg.py).
        c, m, ye, k = (p[:h, :w].astype(np.float32) for p in planes)
        if adobe_transform == 2:  # YCCK: YCbCr over the inverted CMY
            cb = m - np.float32(128.0)
            cr = ye - np.float32(128.0)
            r = c + np.float32(1.402) * cr
            g = c - np.float32(0.344136) * cb - np.float32(0.714136) * cr
            b = c + np.float32(1.772) * cb
            # libjpeg's ycck_cmyk_convert re-inverts the inks
            # (MAXJSAMPLE - value) before handing CMYK through; without
            # this the image comes out color-inverted (round-4 advisor
            # finding, verified vs cv2: max diff 254 -> 3).
            c, m, ye = (
                np.float32(255.0) - r,
                np.float32(255.0) - g,
                np.float32(255.0) - b,
            )
        cmy = np.clip(np.round(np.stack([c, m, ye], -1)), 0, 255).astype(
            np.int32
        )
        kk = np.clip(np.round(k), 0, 255).astype(np.int32)[..., None]
        rgb = kk - (((255 - cmy) * kk) >> 8)
        return np.clip(rgb, 0, 255).astype(np.uint8)
    if len(planes) != 3:
        raise ValueError(f"{len(planes)}-component JPEG not supported")
    if rgb_direct:  # untransformed RGB stream (decided above)
        rgb = np.stack([p[:h, :w] for p in planes], axis=-1)
        return np.clip(np.round(rgb), 0, 255).astype(np.uint8)
    y, cb, cr = (p[:h, :w].astype(np.float32) for p in planes)
    cb = cb - np.float32(128.0)
    cr = cr - np.float32(128.0)
    r = y + np.float32(1.402) * cr
    g = y - np.float32(0.344136) * cb - np.float32(0.714136) * cr
    b = y + np.float32(1.772) * cb
    rgb = np.stack([r, g, b], axis=-1)
    return np.clip(np.round(rgb), 0, 255).astype(np.uint8)
