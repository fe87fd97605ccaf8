"""AVIF (ISOBMFF) container + AV1 still-picture bitstream headers.

From-scratch AV1 intra-frame decode, phase A: the container walk
(meta/iloc/iprp boxes -> the av01 item payload + av1C/colr properties),
OBU framing, and the full uncompressed header parse for the streams this
environment's OpenCV 5.0 (libavif/libaom 3.6) writes — still pictures,
profile 0, 8-bit 4:2:0 or 4:4:4, one tile. This is the
`cv::imread`-surface counterpart of /root/reference/serial.cpp:22.

Spec: AV1 Bitstream & Decoding Process Specification v1.0.0 (public),
sections 5.5 (sequence header), 5.9 (frame header), 5.11 (tile group).
The syntax here follows the spec's field order exactly; fields that can
only occur in inter frames are omitted because `reduced_still_picture_
header`/KEY_FRAME forces the intra path (asserted, not assumed).

Entropy decode + reconstruction live in av1_decode.py (phase B+).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

__all__ = [
    "parse_avif",
    "split_obus",
    "SequenceHeader",
    "FrameHeader",
    "parse_sequence_header",
    "parse_frame_header",
    "probe_avif_size",
]


# ---------------------------------------------------------------- container


@dataclass
class AvifItem:
    """The primary av01 item: coded payload + decode-relevant props."""

    data: bytes
    width: int
    height: int
    # colr nclx (defaults match libavif's when the box is absent)
    matrix: int = 6  # MC_BT_601
    full_range: bool = True
    # av1C essentials
    seq_profile: int = 0
    depth: int = 8
    monochrome: bool = False
    alpha_item: bytes | None = None


def _boxes(buf: bytes, start: int = 0, end: int | None = None):
    """Yield (fourcc, payload_start, payload_end) for top-level boxes."""
    end = len(buf) if end is None else end
    pos = start
    while pos + 8 <= end:
        size = struct.unpack(">I", buf[pos : pos + 4])[0]
        name = buf[pos + 4 : pos + 8]
        hdr = 8
        if size == 1:
            if pos + 16 > end:
                raise ValueError("corrupt AVIF: truncated largesize box")
            size = struct.unpack(">Q", buf[pos + 8 : pos + 16])[0]
            hdr = 16
        elif size == 0:
            size = end - pos
        if size < hdr or pos + size > end:
            raise ValueError("corrupt AVIF: box overruns file")
        yield name, pos + hdr, pos + size
        pos += size


def _fullbox(buf: bytes, pos: int):
    """(version, flags, payload_start) of a FullBox."""
    vf = struct.unpack(">I", buf[pos : pos + 4])[0]
    return vf >> 24, vf & 0xFFFFFF, pos + 4


def _parse_iloc(buf: bytes, s: int, e: int) -> dict[int, list[tuple[int, int]]]:
    """item_id -> [(offset, length), ...] (construction method 0/file)."""
    ver, _, p = _fullbox(buf, s)
    if p + 2 > e:
        raise ValueError("corrupt AVIF: truncated iloc")
    b = buf[p]
    offset_size, length_size = b >> 4, b & 15
    b2 = buf[p + 1]
    base_offset_size = b2 >> 4
    index_size = (b2 & 15) if ver in (1, 2) else 0
    p += 2
    if ver < 2:
        count = struct.unpack(">H", buf[p : p + 2])[0]
        p += 2
    else:
        count = struct.unpack(">I", buf[p : p + 4])[0]
        p += 4

    def _read(n):
        nonlocal p
        v = int.from_bytes(buf[p : p + n], "big")
        p += n
        return v

    items: dict[int, list[tuple[int, int]]] = {}
    for _ in range(count):
        item_id = _read(2 if ver < 2 else 4)
        method = 0
        if ver in (1, 2):
            method = _read(2) & 15
        _read(2)  # data_reference_index
        base = _read(base_offset_size)
        extent_count = _read(2)
        extents = []
        for _ in range(extent_count):
            _read(index_size)
            off = _read(offset_size)
            ln = _read(length_size)
            extents.append((base + off, ln))
        if method == 0:
            items[item_id] = extents
    return items


def parse_avif(data: bytes) -> AvifItem:
    """Walk the HEIF structure and return the primary item's AV1 payload
    plus the properties `imread` needs (dims, matrix/range, av1C)."""
    meta_s = meta_e = None
    for name, s, e in _boxes(data):
        if name == b"meta":
            meta_s, meta_e = s, e
            break
    if meta_s is None:
        raise ValueError("corrupt AVIF: no meta box")
    _, _, p = _fullbox(data, meta_s)

    primary_id = None
    iloc: dict[int, list[tuple[int, int]]] = {}
    ipco: list[tuple[bytes, bytes]] = []  # property boxes, in order
    ipma: dict[int, list[tuple[int, bool]]] = {}  # item -> [(prop_1based,…)]
    item_types: dict[int, bytes] = {}
    auxl_pairs: list[tuple[int, int]] = []  # (aux_item, master_item)

    for name, s, e in _boxes(data, p, meta_e):
        if name == b"pitm":
            ver, _, q = _fullbox(data, s)
            primary_id = (
                struct.unpack(">H", data[q : q + 2])[0]
                if ver == 0
                else struct.unpack(">I", data[q : q + 4])[0]
            )
        elif name == b"iloc":
            iloc = _parse_iloc(data, s, e)
        elif name == b"iinf":
            ver, _, q = _fullbox(data, s)
            n = (
                struct.unpack(">H", data[q : q + 2])[0]
                if ver == 0
                else struct.unpack(">I", data[q : q + 4])[0]
            )
            q += 2 if ver == 0 else 4
            for iname, is_, ie_ in _boxes(data, q, e):
                if iname != b"infe":
                    continue
                iver, _, r = _fullbox(data, is_)
                if iver >= 2:
                    iid = struct.unpack(">H", data[r : r + 2])[0]
                    item_types[iid] = data[r + 4 : r + 8]
                n -= 1
                if n <= 0:
                    break
        elif name == b"iref":
            ver, _, q = _fullbox(data, s)
            idw = 2 if ver == 0 else 4
            for rname, rs, re_ in _boxes(data, q, e):
                if rname != b"auxl":
                    continue
                from_id = int.from_bytes(data[rs : rs + idw], "big")
                cnt = struct.unpack(">H", data[rs + idw : rs + idw + 2])[0]
                for k in range(cnt):
                    to = int.from_bytes(
                        data[rs + idw + 2 + k * idw :][:idw], "big"
                    )
                    auxl_pairs.append((from_id, to))
        elif name == b"iprp":
            for pname, ps, pe in _boxes(data, s, e):
                if pname == b"ipco":
                    for qn, qs, qe in _boxes(data, ps, pe):
                        ipco.append((qn, data[qs:qe]))
                elif pname == b"ipma":
                    ver, flags, q = _fullbox(data, ps)
                    cnt = struct.unpack(">I", data[q : q + 4])[0]
                    q += 4
                    for _ in range(cnt):
                        iid = int.from_bytes(
                            data[q : q + (2 if ver == 0 else 4)], "big"
                        )
                        q += 2 if ver == 0 else 4
                        assoc_n = data[q]
                        q += 1
                        props = []
                        for _ in range(assoc_n):
                            if flags & 1:
                                v = struct.unpack(">H", data[q : q + 2])[0]
                                q += 2
                                props.append((v & 0x7FFF, bool(v >> 15)))
                            else:
                                v = data[q]
                                q += 1
                                props.append((v & 0x7F, bool(v >> 7)))
                        ipma[iid] = props

    if primary_id is None or primary_id not in iloc:
        raise ValueError("corrupt AVIF: no primary item payload")

    def _payload(iid: int) -> bytes:
        return b"".join(data[o : o + ln] for o, ln in iloc[iid])

    item = AvifItem(data=_payload(primary_id), width=0, height=0)
    for prop_idx, _ess in ipma.get(primary_id, []):
        if not 1 <= prop_idx <= len(ipco):
            continue
        pname, body = ipco[prop_idx - 1]
        if pname == b"ispe" and len(body) >= 12:
            item.width, item.height = struct.unpack(">II", body[4:12])
        elif pname == b"av1C" and len(body) >= 4:
            item.seq_profile = body[1] >> 5
            b2 = body[2]
            high, twelve = (b2 >> 6) & 1, (b2 >> 5) & 1
            item.depth = 12 if (high and twelve) else (10 if high else 8)
            item.monochrome = bool((b2 >> 4) & 1)
        elif pname == b"colr" and body[:4] == b"nclx" and len(body) >= 11:
            # nclx: primaries u16, transfer u16, matrix u16, range bit
            item.matrix = struct.unpack(">H", body[8:10])[0]
            item.full_range = bool(body[10] & 0x80)
    if item.width == 0:
        raise ValueError("corrupt AVIF: primary item has no ispe")

    # alpha plane: the auxl item pointing at the primary (decoded as a
    # monochrome AV1 stream; wired through in phase D)
    for aux_id, master in auxl_pairs:
        if master == primary_id and aux_id in iloc:
            item.alpha_item = _payload(aux_id)
            break
    return item


# --------------------------------------------------------------------- OBUs

OBU_SEQUENCE_HEADER = 1
OBU_TEMPORAL_DELIMITER = 2
OBU_FRAME_HEADER = 3
OBU_TILE_GROUP = 4
OBU_METADATA = 5
OBU_FRAME = 6
OBU_PADDING = 15


def _leb128(buf: bytes, pos: int) -> tuple[int, int]:
    v = 0
    for i in range(8):
        if pos >= len(buf):
            raise ValueError("corrupt AV1: truncated leb128")
        b = buf[pos]
        pos += 1
        v |= (b & 0x7F) << (7 * i)
        if not b & 0x80:
            return v, pos
    raise ValueError("corrupt AV1: leb128 too long")


def split_obus(buf: bytes) -> list[tuple[int, bytes]]:
    """[(obu_type, payload), ...] — size-field framing (av1C requires)."""
    out = []
    pos = 0
    while pos < len(buf):
        hdr = buf[pos]
        if hdr & 0x80:
            raise ValueError("corrupt AV1: obu_forbidden_bit set")
        otype = (hdr >> 3) & 0xF
        has_ext = hdr & 4
        has_size = hdr & 2
        pos += 1
        if has_ext:
            pos += 1
        if has_size:
            size, pos = _leb128(buf, pos)
        else:
            size = len(buf) - pos
        if pos + size > len(buf):
            raise ValueError("corrupt AV1: OBU overruns buffer")
        out.append((otype, buf[pos : pos + size]))
        pos += size
    return out


# --------------------------------------------------------------- bit reader


class BitReader:
    """MSB-first reader for f(n)/uvlc/su/ns over an OBU payload."""

    __slots__ = ("buf", "pos", "nbits")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0
        self.nbits = 8 * len(buf)

    def f(self, n: int) -> int:
        if self.pos + n > self.nbits:
            raise ValueError("corrupt AV1: header overruns OBU")
        v = 0
        pos = self.pos
        for _ in range(n):
            v = (v << 1) | ((self.buf[pos >> 3] >> (7 - (pos & 7))) & 1)
            pos += 1
        self.pos = pos
        return v

    def su(self, n: int) -> int:
        """Spec su(1+n): n+1 bits read MSB-first, two's complement
        (4.10.6 — the leading bit is the sign of the complement)."""
        v = self.f(n + 1)
        return v - (2 << n) if v & (1 << n) else v

    def uvlc(self) -> int:
        lead = 0
        while not self.f(1):
            lead += 1
            if lead > 32:
                raise ValueError("corrupt AV1: uvlc overflow")
        if lead >= 32:
            return (1 << 32) - 1
        return (1 << lead) - 1 + (self.f(lead) if lead else 0)

    def ns(self, n: int) -> int:
        """Non-symmetric unsigned, spec 4.10.7."""
        w = n.bit_length()
        m = (1 << w) - n
        v = self.f(w - 1) if w > 1 else 0
        if v < m:
            return v
        return (v << 1) - m + self.f(1)

    def byte_align(self):
        self.pos = (self.pos + 7) & ~7


# ------------------------------------------------------------------ headers


@dataclass
class SequenceHeader:
    seq_profile: int = 0
    still_picture: bool = False
    reduced_still_picture_header: bool = False
    frame_width_bits: int = 0
    frame_height_bits: int = 0
    max_frame_width: int = 0
    max_frame_height: int = 0
    frame_id_numbers_present: bool = False
    delta_frame_id_length: int = 0
    additional_frame_id_length: int = 0
    use_128x128_superblock: bool = False
    enable_filter_intra: bool = False
    enable_intra_edge_filter: bool = False
    force_screen_content_tools: int = 2  # SELECT
    force_integer_mv: int = 2  # SELECT
    order_hint_bits: int = 0
    enable_superres: bool = False
    enable_cdef: bool = False
    enable_restoration: bool = False
    bit_depth: int = 8
    monochrome: bool = False
    color_primaries: int = 2
    transfer_characteristics: int = 2
    matrix_coefficients: int = 2
    color_range: bool = False
    subsampling_x: int = 1
    subsampling_y: int = 1
    chroma_sample_position: int = 0
    separate_uv_delta_q: bool = False
    film_grain_params_present: bool = False

    @property
    def num_planes(self) -> int:
        return 1 if self.monochrome else 3


def parse_sequence_header(payload: bytes) -> SequenceHeader:
    """Spec 5.5: the subset reachable for still pictures, exact order."""
    r = BitReader(payload)
    s = SequenceHeader()
    s.seq_profile = r.f(3)
    if s.seq_profile > 2:
        raise ValueError(f"corrupt AV1: seq_profile {s.seq_profile}")
    s.still_picture = bool(r.f(1))
    s.reduced_still_picture_header = bool(r.f(1))
    if s.reduced_still_picture_header:
        r.f(5)  # seq_level_idx[0]
    else:
        if r.f(1):  # timing_info_present_flag
            r.f(32)  # num_units_in_display_tick
            r.f(32)  # time_scale
            if r.f(1):  # equal_picture_interval
                r.uvlc()  # num_ticks_per_picture_minus_1
            if r.f(1):  # decoder_model_info_present_flag
                raise ValueError(
                    "AV1 decoder-model operating points are out of scope "
                    "for still-picture decode"
                )
        initial_display_delay_present = r.f(1)
        op_cnt = r.f(5) + 1
        for _ in range(op_cnt):
            r.f(12)  # operating_point_idc
            if r.f(5) > 7:  # seq_level_idx
                r.f(1)  # seq_tier
            if initial_display_delay_present and r.f(1):
                r.f(4)  # initial_display_delay_minus_1
    s.frame_width_bits = r.f(4) + 1
    s.frame_height_bits = r.f(4) + 1
    s.max_frame_width = r.f(s.frame_width_bits) + 1
    s.max_frame_height = r.f(s.frame_height_bits) + 1
    if not s.reduced_still_picture_header:
        s.frame_id_numbers_present = bool(r.f(1))
    if s.frame_id_numbers_present:
        s.delta_frame_id_length = r.f(4) + 2
        s.additional_frame_id_length = r.f(3) + 1
    s.use_128x128_superblock = bool(r.f(1))
    s.enable_filter_intra = bool(r.f(1))
    s.enable_intra_edge_filter = bool(r.f(1))
    if s.reduced_still_picture_header:
        s.force_screen_content_tools = 2
        s.force_integer_mv = 2
    else:
        r.f(1)  # enable_interintra_compound
        r.f(1)  # enable_masked_compound
        r.f(1)  # enable_warped_motion
        r.f(1)  # enable_dual_filter
        enable_order_hint = r.f(1)
        if enable_order_hint:
            r.f(1)  # enable_jnt_comp
            r.f(1)  # enable_ref_frame_mvs
        if r.f(1):  # seq_choose_screen_content_tools
            s.force_screen_content_tools = 2
        else:
            s.force_screen_content_tools = r.f(1)
        if s.force_screen_content_tools > 0:
            if r.f(1):  # seq_choose_integer_mv
                s.force_integer_mv = 2
            else:
                s.force_integer_mv = r.f(1)
        else:
            s.force_integer_mv = 2
        if enable_order_hint:
            s.order_hint_bits = r.f(3) + 1
    s.enable_superres = bool(r.f(1))
    s.enable_cdef = bool(r.f(1))
    s.enable_restoration = bool(r.f(1))
    # color_config (5.5.2)
    high_bitdepth = r.f(1)
    if s.seq_profile == 2 and high_bitdepth:
        s.bit_depth = 12 if r.f(1) else 10
    else:
        s.bit_depth = 10 if high_bitdepth else 8
    s.monochrome = bool(r.f(1)) if s.seq_profile != 1 else False
    if r.f(1):  # color_description_present_flag
        s.color_primaries = r.f(8)
        s.transfer_characteristics = r.f(8)
        s.matrix_coefficients = r.f(8)
    if s.monochrome:
        s.color_range = bool(r.f(1))
        s.subsampling_x = s.subsampling_y = 1
    elif (
        s.color_primaries == 1
        and s.transfer_characteristics == 13
        and s.matrix_coefficients == 0
    ):
        s.color_range = True
        s.subsampling_x = s.subsampling_y = 0
    else:
        s.color_range = bool(r.f(1))
        if s.seq_profile == 0:
            s.subsampling_x = s.subsampling_y = 1
        elif s.seq_profile == 1:
            s.subsampling_x = s.subsampling_y = 0
        else:
            if s.bit_depth == 12:
                s.subsampling_x = r.f(1)
                s.subsampling_y = r.f(1) if s.subsampling_x else 0
            else:
                s.subsampling_x, s.subsampling_y = 1, 0
        if s.subsampling_x and s.subsampling_y:
            s.chroma_sample_position = r.f(2)
    if not s.monochrome:
        s.separate_uv_delta_q = bool(r.f(1))
    s.film_grain_params_present = bool(r.f(1))
    return s


@dataclass
class FrameHeader:
    width: int = 0
    height: int = 0
    upscaled_width: int = 0
    render_width: int = 0
    render_height: int = 0
    disable_cdf_update: bool = False
    allow_screen_content_tools: bool = False
    allow_intrabc: bool = False
    superres_denom: int = 8
    # tiles
    tile_cols_log2: int = 0
    tile_rows_log2: int = 0
    tile_cols: int = 1
    tile_rows: int = 1
    mi_col_starts: list = field(default_factory=list)
    mi_row_starts: list = field(default_factory=list)
    context_update_tile_id: int = 0
    tile_size_bytes: int = 1
    # quantization
    base_q_idx: int = 0
    delta_q_y_dc: int = 0
    delta_q_u_dc: int = 0
    delta_q_u_ac: int = 0
    delta_q_v_dc: int = 0
    delta_q_v_ac: int = 0
    using_qmatrix: bool = False
    qm_y: int = 0
    qm_u: int = 0
    qm_v: int = 0
    # segmentation / deltas
    segmentation_enabled: bool = False
    delta_q_present: bool = False
    delta_q_res: int = 0
    delta_lf_present: bool = False
    delta_lf_res: int = 0
    delta_lf_multi: bool = False
    coded_lossless: bool = False
    all_lossless: bool = False
    # loop filter
    loop_filter_level: tuple = (0, 0, 0, 0)
    loop_filter_sharpness: int = 0
    loop_filter_delta_enabled: bool = False
    loop_filter_ref_deltas: tuple = (1, 0, 0, 0, -1, 0, -1, -1)
    loop_filter_mode_deltas: tuple = (0, 0)
    # cdef
    cdef_damping: int = 3
    cdef_bits: int = 0
    cdef_y_pri: list = field(default_factory=lambda: [0])
    cdef_y_sec: list = field(default_factory=lambda: [0])
    cdef_uv_pri: list = field(default_factory=lambda: [0])
    cdef_uv_sec: list = field(default_factory=lambda: [0])
    # loop restoration
    lr_type: tuple = (0, 0, 0)
    lr_unit_shift: int = 0
    lr_uv_shift: int = 0
    # modes
    tx_mode_select: bool = False
    reduced_tx_set: bool = False
    disable_frame_end_update_cdf: bool = True
    header_bitpos: int = 0  # bit offset where the tile data would start

    @property
    def mi_cols(self) -> int:
        return 2 * ((self.width + 7) >> 3)

    @property
    def mi_rows(self) -> int:
        return 2 * ((self.height + 7) >> 3)


def _read_delta_q(r: BitReader) -> int:
    return r.su(6) if r.f(1) else 0


def _tile_info(r: BitReader, seq: SequenceHeader, h: FrameHeader):
    """Spec 5.9.15 — fills tile grid fields on h. All internal sizes in
    MI (4x4 luma) units; sb_shift converts MI -> superblock units."""
    sb_shift = 5 if seq.use_128x128_superblock else 4
    mi_cols, mi_rows = h.mi_cols, h.mi_rows
    sb_cols = (mi_cols + (1 << sb_shift) - 1) >> sb_shift
    sb_rows = (mi_rows + (1 << sb_shift) - 1) >> sb_shift
    max_tile_width_sb = (4096 >> 2) >> sb_shift
    max_tile_area_sb = ((4096 * 2304) >> 4) >> (2 * sb_shift)
    min_log2_tile_cols = _tile_log2(max_tile_width_sb, sb_cols)
    max_log2_tile_cols = _tile_log2(1, min(sb_cols, 64))
    max_log2_tile_rows = _tile_log2(1, min(sb_rows, 64))
    min_log2_tiles = max(
        min_log2_tile_cols,
        _tile_log2(max_tile_area_sb, sb_rows * sb_cols),
    )
    if r.f(1):  # uniform_tile_spacing_flag
        h.tile_cols_log2 = min_log2_tile_cols
        while h.tile_cols_log2 < max_log2_tile_cols and r.f(1):
            h.tile_cols_log2 += 1
        tile_width_sb = (sb_cols + (1 << h.tile_cols_log2) - 1) >> (
            h.tile_cols_log2
        )
        h.mi_col_starts = list(
            range(0, mi_cols, tile_width_sb << sb_shift)
        ) + [mi_cols]
        h.tile_cols = len(h.mi_col_starts) - 1
        min_log2_tile_rows = max(min_log2_tiles - h.tile_cols_log2, 0)
        h.tile_rows_log2 = min_log2_tile_rows
        while h.tile_rows_log2 < max_log2_tile_rows and r.f(1):
            h.tile_rows_log2 += 1
        tile_height_sb = (sb_rows + (1 << h.tile_rows_log2) - 1) >> (
            h.tile_rows_log2
        )
        h.mi_row_starts = list(
            range(0, mi_rows, tile_height_sb << sb_shift)
        ) + [mi_rows]
        h.tile_rows = len(h.mi_row_starts) - 1
    else:
        widest = 0
        start_sb = 0
        h.mi_col_starts = []
        while start_sb < sb_cols:
            h.mi_col_starts.append(start_sb << sb_shift)
            max_w = min(sb_cols - start_sb, max_tile_width_sb)
            w = r.ns(max_w) + 1
            widest = max(widest, w)
            start_sb += w
        h.mi_col_starts.append(mi_cols)
        h.tile_cols = len(h.mi_col_starts) - 1
        h.tile_cols_log2 = _tile_log2(1, h.tile_cols)
        if min_log2_tiles > 0:
            max_area = (sb_rows * sb_cols) >> (min_log2_tiles + 1)
        else:
            max_area = sb_rows * sb_cols
        max_tile_height_sb = max(max_area // widest, 1)
        start_sb = 0
        h.mi_row_starts = []
        while start_sb < sb_rows:
            h.mi_row_starts.append(start_sb << sb_shift)
            max_h = min(sb_rows - start_sb, max_tile_height_sb)
            hh = r.ns(max_h) + 1
            start_sb += hh
        h.mi_row_starts.append(mi_rows)
        h.tile_rows = len(h.mi_row_starts) - 1
        h.tile_rows_log2 = _tile_log2(1, h.tile_rows)
    if h.tile_cols_log2 > 0 or h.tile_rows_log2 > 0:
        h.context_update_tile_id = r.f(h.tile_rows_log2 + h.tile_cols_log2)
        h.tile_size_bytes = r.f(2) + 1
    else:
        h.context_update_tile_id = 0


def _tile_log2(blk_size: int, target: int) -> int:
    k = 0
    while (blk_size << k) < target:
        k += 1
    return k


def parse_frame_header(
    payload: bytes, seq: SequenceHeader
) -> FrameHeader:
    """Spec 5.9.2 uncompressed_header, intra/still path. `payload` is an
    OBU_FRAME or OBU_FRAME_HEADER body; `header_bitpos` on the result is
    where tile-group data begins inside an OBU_FRAME (byte-aligned)."""
    r = BitReader(payload)
    h = FrameHeader()
    frame_is_intra = True
    show_frame = True
    showable_frame = False
    error_resilient = True
    frame_type = 0  # KEY_FRAME
    if seq.reduced_still_picture_header:
        pass  # KEY_FRAME, show_frame=1 — no bits
    else:
        if r.f(1):  # show_existing_frame
            raise ValueError(
                "AV1 show_existing_frame is out of scope for still decode"
            )
        frame_type = r.f(2)
        frame_is_intra = frame_type in (0, 2)  # KEY / INTRA_ONLY
        if not frame_is_intra:
            raise ValueError(
                "AV1 inter frames are out of scope (still-picture decode)"
            )
        show_frame = bool(r.f(1))
        if not show_frame:
            showable_frame = bool(r.f(1))
        if frame_type == 3 or (frame_type == 0 and show_frame):
            error_resilient = True
        else:
            error_resilient = bool(r.f(1))
    showable_frame  # parsed for spec completeness
    h.disable_cdf_update = bool(r.f(1))
    if seq.force_screen_content_tools == 2:
        h.allow_screen_content_tools = bool(r.f(1))
    else:
        h.allow_screen_content_tools = bool(seq.force_screen_content_tools)
    if h.allow_screen_content_tools and seq.force_integer_mv == 2:
        r.f(1)  # force_integer_mv (intra frames force it to 1 anyway)
    if seq.frame_id_numbers_present:
        id_len = seq.additional_frame_id_length + seq.delta_frame_id_length
        r.f(id_len)  # current_frame_id
    if seq.reduced_still_picture_header:
        frame_size_override = False
    else:
        frame_size_override = bool(r.f(1))
    r.f(seq.order_hint_bits)  # order_hint
    # primary_ref_frame: intra -> PRIMARY_REF_NONE, no bits
    if not seq.reduced_still_picture_header and not (
        frame_type == 0 and show_frame  # KEY+shown -> refresh = all
    ):
        r.f(8)  # refresh_frame_flags (also read for INTRA_ONLY)
    # frame_size()
    if frame_size_override:
        h.width = r.f(seq.frame_width_bits) + 1
        h.height = r.f(seq.frame_height_bits) + 1
    else:
        h.width = seq.max_frame_width
        h.height = seq.max_frame_height
    # superres_params()
    use_superres = bool(r.f(1)) if seq.enable_superres else False
    h.upscaled_width = h.width
    if use_superres:
        h.superres_denom = r.f(3) + 9
        h.width = (h.upscaled_width * 8 + h.superres_denom // 2) // (
            h.superres_denom
        )
    # render_size()
    if r.f(1):  # render_and_frame_size_different
        h.render_width = r.f(16) + 1
        h.render_height = r.f(16) + 1
    else:
        h.render_width, h.render_height = h.upscaled_width, h.height
    if h.allow_screen_content_tools and h.upscaled_width == h.width:
        h.allow_intrabc = bool(r.f(1))
    # (inter-only: ref frames, interpolation filter, motion switches)
    if seq.reduced_still_picture_header or h.disable_cdf_update:
        h.disable_frame_end_update_cdf = True
    else:
        h.disable_frame_end_update_cdf = bool(r.f(1))
    # primary_ref_frame == NONE -> init_non_coeff_cdfs, no bits
    _tile_info(r, seq, h)
    # quantization_params()
    h.base_q_idx = r.f(8)
    h.delta_q_y_dc = _read_delta_q(r)
    if seq.num_planes > 1:
        diff_uv_delta = bool(r.f(1)) if seq.separate_uv_delta_q else False
        h.delta_q_u_dc = _read_delta_q(r)
        h.delta_q_u_ac = _read_delta_q(r)
        if diff_uv_delta:
            h.delta_q_v_dc = _read_delta_q(r)
            h.delta_q_v_ac = _read_delta_q(r)
        else:
            h.delta_q_v_dc = h.delta_q_u_dc
            h.delta_q_v_ac = h.delta_q_u_ac
    h.using_qmatrix = bool(r.f(1))
    if h.using_qmatrix:
        h.qm_y = r.f(4)
        h.qm_u = r.f(4)
        if seq.separate_uv_delta_q:
            h.qm_v = r.f(4)
        else:
            h.qm_v = h.qm_u
    # segmentation_params()
    h.segmentation_enabled = bool(r.f(1))
    if h.segmentation_enabled:
        raise ValueError(
            "AV1 segmentation is out of scope (libaom still encodes "
            "disable it); re-encode without segmentation"
        )
    # delta_q_params()
    if h.base_q_idx > 0:
        h.delta_q_present = bool(r.f(1))
    if h.delta_q_present:
        h.delta_q_res = r.f(2)
    # delta_lf_params()
    if h.delta_q_present:
        if not h.allow_intrabc:
            h.delta_lf_present = bool(r.f(1))
        if h.delta_lf_present:
            h.delta_lf_res = r.f(2)
            h.delta_lf_multi = bool(r.f(1))
    # lossless derivation (per-segment; no segmentation -> one value)
    qy = _clamp(h.base_q_idx + h.delta_q_y_dc, 0, 255)
    h.coded_lossless = (
        h.base_q_idx == 0
        and h.delta_q_y_dc == 0
        and h.delta_q_u_dc == 0
        and h.delta_q_u_ac == 0
        and h.delta_q_v_dc == 0
        and h.delta_q_v_ac == 0
    )
    qy  # (kept: useful when segmentation lands)
    h.all_lossless = h.coded_lossless and h.width == h.upscaled_width
    # loop_filter_params()
    if not (h.coded_lossless or h.allow_intrabc):
        lvl = [r.f(6), r.f(6), 0, 0]
        if seq.num_planes > 1 and (lvl[0] or lvl[1]):
            lvl[2] = r.f(6)
            lvl[3] = r.f(6)
        h.loop_filter_level = tuple(lvl)
        h.loop_filter_sharpness = r.f(3)
        h.loop_filter_delta_enabled = bool(r.f(1))
        if h.loop_filter_delta_enabled and r.f(1):  # delta_update
            ref_deltas = list(h.loop_filter_ref_deltas)
            for i in range(8):
                if r.f(1):
                    ref_deltas[i] = r.su(6)
            mode_deltas = list(h.loop_filter_mode_deltas)
            for i in range(2):
                if r.f(1):
                    mode_deltas[i] = r.su(6)
            h.loop_filter_ref_deltas = tuple(ref_deltas)
            h.loop_filter_mode_deltas = tuple(mode_deltas)
    # cdef_params()
    if not (h.coded_lossless or h.allow_intrabc) and seq.enable_cdef:
        h.cdef_damping = r.f(2) + 3
        h.cdef_bits = r.f(2)
        n = 1 << h.cdef_bits
        h.cdef_y_pri, h.cdef_y_sec = [], []
        h.cdef_uv_pri, h.cdef_uv_sec = [], []
        for _ in range(n):
            h.cdef_y_pri.append(r.f(4))
            v = r.f(2)
            h.cdef_y_sec.append(v + (v == 3))
            # chroma strengths are coded only when chroma planes exist
            if seq.num_planes > 1:
                h.cdef_uv_pri.append(r.f(4))
                v = r.f(2)
                h.cdef_uv_sec.append(v + (v == 3))
    # lr_params()
    if not (h.all_lossless or h.allow_intrabc) and seq.enable_restoration:
        kinds = []
        uses_lr = uses_chroma_lr = False
        for p in range(seq.num_planes):
            t = r.f(2)
            # remap: 0 NONE, 1 SWITCHABLE, 2 WIENER, 3 SGRPROJ
            kinds.append((0, 3, 1, 2)[t])
            if t:
                uses_lr = True
                if p:
                    uses_chroma_lr = True
        h.lr_type = tuple(kinds) + (0,) * (3 - len(kinds))
        if uses_lr:
            if seq.use_128x128_superblock:
                h.lr_unit_shift = r.f(1) + 1
            else:
                h.lr_unit_shift = r.f(1)
                if h.lr_unit_shift:
                    h.lr_unit_shift += r.f(1)
            if seq.subsampling_x and seq.subsampling_y and uses_chroma_lr:
                h.lr_uv_shift = r.f(1)
    # read_tx_mode()
    h.tx_mode_select = False if h.coded_lossless else bool(r.f(1))
    # frame_reference_mode / skip_mode: intra -> no bits
    # allow_warped_motion: intra -> no bits
    h.reduced_tx_set = bool(r.f(1))
    # global_motion_params / film_grain: intra still -> no bits unless
    # film grain is present AND frame is shown
    if seq.film_grain_params_present and (show_frame or showable_frame):
        if r.f(1):  # apply_grain
            raise ValueError(
                "AV1 film grain synthesis is out of scope for still decode"
            )
    r.byte_align()
    h.header_bitpos = r.pos
    return h


def _clamp(v, lo, hi):
    return max(lo, min(hi, v))


# ------------------------------------------------------------------- probes


def probe_avif_size(data: bytes) -> tuple[int, int]:
    """(height, width) from the ispe box only."""
    item = parse_avif(data)
    return item.height, item.width


# ------------------------------------------------------------ full decode


def _decode_obu_stream(payload: bytes):
    """OBU stream -> uint8 planes via av1_decode (lazy import: the
    header layer stays importable without the reconstruction stack)."""
    from .av1_decode import decode_frame

    seq = hdr = tile = None
    for t, p in split_obus(payload):
        if t == 1:
            seq = parse_sequence_header(p)
        elif t == 3 and seq is not None:  # OBU_FRAME_HEADER
            hdr = parse_frame_header(p, seq)
        elif t == 4 and hdr is not None:  # OBU_TILE_GROUP
            tile = p
        elif t == 6 and seq is not None:  # OBU_FRAME
            hdr = parse_frame_header(p, seq)
            tile = p[(hdr.header_bitpos + 7) // 8:]
    if seq is None or hdr is None or tile is None:
        raise ValueError("corrupt AVIF: no decodable AV1 frame in item")
    return decode_frame(seq, hdr, tile), seq, hdr


def _upsample_bilinear(c, h, w):
    """libyuv bilinear 2x chroma upsampling as libavif drives it: the
    centered 9/3/3/1 kernel with edge replication, except the final
    column of an odd output width, which libyuv special-cases to the
    vertical-only 3:1 blend (pinned bit-exact vs cv2 on odd frames)."""
    import numpy as np

    ch, cw = c.shape
    cp = np.pad(c.astype(np.uint16), 1, mode="edge")
    out = np.empty((2 * ch, 2 * cw), np.uint16)
    a = cp[1:-1, 1:-1]
    out[0::2, 0::2] = (9 * a + 3 * cp[:-2, 1:-1] + 3 * cp[1:-1, :-2] + cp[:-2, :-2] + 8) >> 4
    out[0::2, 1::2] = (9 * a + 3 * cp[:-2, 1:-1] + 3 * cp[1:-1, 2:] + cp[:-2, 2:] + 8) >> 4
    out[1::2, 0::2] = (9 * a + 3 * cp[2:, 1:-1] + 3 * cp[1:-1, :-2] + cp[2:, :-2] + 8) >> 4
    out[1::2, 1::2] = (9 * a + 3 * cp[2:, 1:-1] + 3 * cp[1:-1, 2:] + cp[2:, 2:] + 8) >> 4
    if w & 1:
        last = c[:, -1].astype(np.uint16)
        rows = np.arange(h)
        ci = rows >> 1
        adj = np.where(rows & 1, np.minimum(ci + 1, ch - 1),
                       np.maximum(ci - 1, 0))
        out[:h, w - 1] = (3 * last[ci] + last[adj] + 2) >> 2
    return out[:h, :w].astype(np.uint8)


def decode_avif(data: bytes):
    """AVIF bytes -> uint8 gray (H, W), RGB (H, W, 3) or RGBA (H, W, 4).

    From-scratch ingest path for `cv::imread` parity (reference surface
    /root/reference/serial.cpp:22): ISOBMFF walk, AV1 tile decode
    (dav1d-plane-exact), then libavif's YUV->RGB: identity matrix maps
    (G, B, R) = (Y, U, V); BT.601 full-range uses the float matrix with
    round-half-away and bilinear chroma upsampling for 4:2:0."""
    import numpy as np

    item = parse_avif(data)
    planes, seq, hdr = _decode_obu_stream(item.data)
    h, w = item.height, item.width
    if seq.monochrome or len(planes) == 1:
        return planes[0][:h, :w]
    y = planes[0][:h, :w]
    if item.matrix == 0:  # identity (lossless 4:4:4): G=Y, B=U, R=V
        if seq.subsampling_x or seq.subsampling_y:
            raise ValueError(
                "corrupt AVIF: identity matrix requires 4:4:4"
            )
        rgb = np.stack([planes[2][:h, :w], y, planes[1][:h, :w]], -1)
    else:
        if seq.subsampling_x and seq.subsampling_y:
            u = _upsample_bilinear(planes[1], h, w)
            v = _upsample_bilinear(planes[2], h, w)
        else:
            u, v = planes[1][:h, :w], planes[2][:h, :w]
        if item.full_range:
            # libyuv J420 fixed point (what cv2's libavif drives for
            # full-range BT.601 8-bit) — bit-exact vs cv2.imdecode
            y32 = (y.astype(np.int64) * 0x0101 * 16320) >> 16
            ui = u.astype(np.int64)
            vi = v.astype(np.int64)
            b = np.clip((y32 + 113 * ui + (-113 * 128 + 32)) >> 6, 0, 255)
            g = np.clip(
                (y32 - 22 * ui - 46 * vi + (22 * 128 + 46 * 128 + 32)) >> 6,
                0, 255,
            )
            r = np.clip((y32 + 90 * vi + (-90 * 128 + 32)) >> 6, 0, 255)
            rgb = np.stack([r, g, b], -1).astype(np.uint8)
        else:
            # limited range: libavif float path (documented tolerance)
            yf = (y.astype(np.float64) - 16.0) * (255.0 / 219.0)
            cb = (u.astype(np.float64) - 128.0) * (255.0 / 224.0)
            cr = (v.astype(np.float64) - 128.0) * (255.0 / 224.0)
            kr, kb = 0.299, 0.114
            r = yf + 2.0 * (1.0 - kr) * cr
            b = yf + 2.0 * (1.0 - kb) * cb
            g = (yf - kr * r - kb * b) / (1.0 - kr - kb)
            rgb = np.stack([
                np.clip(np.floor(r + 0.5), 0, 255),
                np.clip(np.floor(g + 0.5), 0, 255),
                np.clip(np.floor(b + 0.5), 0, 255),
            ], -1).astype(np.uint8)
    if item.alpha_item:
        a_planes, a_seq, _ = _decode_obu_stream(item.alpha_item)
        alpha = a_planes[0][:h, :w]
        return np.concatenate([rgb, alpha[..., None]], -1)
    return rgb
