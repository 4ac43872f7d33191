"""AV1 open bitstream units as an AVIF item's payload holds them: OBU headers and sizes, the sequence header
(the reduced still-picture form and the full one), the uncompressed header of a key or intra-only frame,
and tile groups (AV1 Bitstream & Decoding Process Specification, sections 5.3-5.11 and 6.8's semantics).

`parse(data, name)` walks the OBUs of one temporal unit and returns the sequence header, the frame header
and the tile data (each tile's bytes and its rectangle in 4 x 4 units) of its first frame.  Forms the port
does not decode raise UnsupportedImageFormat naming them; bytes no decoder could read raise ValueError.
"""

from __future__ import annotations

from types import SimpleNamespace

OBU_SEQUENCE_HEADER, OBU_FRAME_HEADER, OBU_TILE_GROUP, OBU_FRAME, OBU_REDUNDANT_FRAME_HEADER = 1, 3, 4, 6, 7
OBU_TILE_LIST = 8
KEY_FRAME, INTER_FRAME, INTRA_ONLY_FRAME = 0, 1, 2
RESTORE_NONE, RESTORE_WIENER, RESTORE_SGRPROJ, RESTORE_SWITCHABLE = 0, 1, 2, 3
_REMAP_LR_TYPE = (RESTORE_NONE, RESTORE_SWITCHABLE, RESTORE_WIENER, RESTORE_SGRPROJ)
ONLY_4X4, TX_MODE_LARGEST, TX_MODE_SELECT = 0, 1, 2
SEG_FEATURE_BITS = (8, 6, 6, 6, 6, 3, 0, 0)
SEG_FEATURE_SIGNED = (1, 1, 1, 1, 1, 0, 0, 0)
SEG_FEATURE_MAX = (255, 63, 63, 63, 63, 7, 0, 0)
SEG_LVL_ALT_Q, SEG_LVL_SKIP, SEG_LVL_REF_FRAME = 0, 6, 5


def _unsupported(name: str, what: str):
    from uniir_tpu_torch.data.jpeg import UnsupportedImageFormat

    return UnsupportedImageFormat(f"{name}: AVIF {what} is not decoded")


class Bits:
    """The specification's f(n), su(n), ns(n), leb128() and uvlc() over a byte string."""

    def __init__(self, data: bytes, name: str, pos: int = 0):
        self.data, self.name, self.pos = data, name, pos * 8

    def f(self, n: int) -> int:
        x = 0
        for _ in range(n):
            byte = self.pos >> 3
            if byte >= len(self.data):
                raise ValueError(f"{self.name}: AV1 header cut short")
            x = x << 1 | (self.data[byte] >> (7 - (self.pos & 7))) & 1
            self.pos += 1
        return x

    def su(self, n: int) -> int:
        v = self.f(n)
        return v - (1 << n) if v & (1 << (n - 1)) else v

    def ns(self, n: int) -> int:
        w = n.bit_length()
        m = (1 << w) - n
        v = self.f(w - 1)
        if v < m:
            return v
        return (v << 1) - m + self.f(1)

    def uvlc(self) -> int:
        zeros = 0
        while not self.f(1):
            zeros += 1
            if zeros >= 32:
                return (1 << 32) - 1
        return self.f(zeros) + (1 << zeros) - 1

    def leb128(self) -> int:
        v = 0
        for i in range(8):
            b = self.f(8)
            v |= (b & 0x7F) << (7 * i)
            if not b & 0x80:
                break
        return v

    def byte_align(self):
        self.pos = (self.pos + 7) & ~7


def obus(data: bytes, name: str):
    """(type, temporal id, spatial id, payload) of each OBU in `data` (each with its size field, as AVIF's
    av1C requires, or the last running to the end)."""
    pos = 0
    while pos < len(data):
        b = Bits(data, name, pos)
        b.f(1)  # obu_forbidden_bit: dav1d does not check it
        kind = b.f(4)
        ext, has_size = b.f(1), b.f(1)
        b.f(1)
        tid = sid = 0
        if ext:
            tid, sid = b.f(3), b.f(2)
            b.f(3)
        size = b.leb128() if has_size else len(data) - (b.pos >> 3)
        start = b.pos >> 3
        if start + size > len(data):
            raise ValueError(f"{name}: AV1 OBU of {size} bytes cut short")
        yield kind, tid, sid, data[start : start + size]
        pos = start + size


def sequence_header(payload: bytes, name: str) -> SimpleNamespace:
    b = Bits(payload, name)
    s = SimpleNamespace()
    s.profile = b.f(3)
    if s.profile > 2:
        raise ValueError(f"{name}: AV1 seq_profile {s.profile}")
    s.still_picture, s.reduced = b.f(1), b.f(1)
    s.timing_info = s.decoder_model_info = s.equal_picture_interval = 0
    s.op_idc = [0]
    s.decoder_model_for_op = [0]
    s.level, s.tier = 0, 0
    if s.reduced:
        s.level = b.f(5)
    else:
        s.timing_info = b.f(1)
        if s.timing_info:
            # dav1d's checks: non-zero tick and time scale, a picture interval that fits in 32 bits
            if not b.f(32) or not b.f(32):
                raise ValueError(f"{name}: AV1 timing info of zero")
            s.equal_picture_interval = b.f(1)
            if s.equal_picture_interval and b.uvlc() == (1 << 32) - 1:
                raise ValueError(f"{name}: AV1 picture interval out of range")
            s.decoder_model_info = b.f(1)
            if s.decoder_model_info:
                s.buffer_delay_length = b.f(5) + 1
                if not b.f(32):
                    raise ValueError(f"{name}: AV1 decoding tick of zero")
                s.buffer_removal_time_length = b.f(5) + 1
                s.frame_presentation_time_length = b.f(5) + 1
        initial_display_delay = b.f(1)
        count = b.f(5) + 1
        s.op_idc, s.decoder_model_for_op = [], []
        for op in range(count):
            s.op_idc.append(b.f(12))
            if s.op_idc[-1] and not (s.op_idc[-1] & 0xFF and s.op_idc[-1] & 0xF00):
                raise ValueError(f"{name}: AV1 operating point {op} of no temporal or no spatial layer")
            level = b.f(5)
            tier = b.f(1) if level > 7 else 0
            if op == 0:
                s.level, s.tier = level, tier
            present = 0
            if s.decoder_model_info:
                present = b.f(1)
                if present:
                    b.f(s.buffer_delay_length), b.f(s.buffer_delay_length), b.f(1)
            s.decoder_model_for_op.append(present)
            if initial_display_delay and b.f(1):
                b.f(4)
    wbits, hbits = b.f(4) + 1, b.f(4) + 1
    s.frame_width_bits, s.frame_height_bits = wbits, hbits
    s.max_width, s.max_height = b.f(wbits) + 1, b.f(hbits) + 1
    s.frame_id_numbers = 0 if s.reduced else b.f(1)
    if s.frame_id_numbers:
        s.delta_frame_id_length = b.f(4) + 2
        s.frame_id_length = b.f(3) + 1 + s.delta_frame_id_length
    s.sb128, s.enable_filter_intra, s.enable_intra_edge_filter = b.f(1), b.f(1), b.f(1)
    s.enable_order_hint = 0
    s.force_screen_content_tools, s.force_integer_mv, s.order_hint_bits = 2, 2, 0
    if not s.reduced:
        b.f(1), b.f(1), b.f(1), b.f(1)  # interintra, masked compound, warped motion, dual filter
        s.enable_order_hint = b.f(1)
        if s.enable_order_hint:
            b.f(1), b.f(1)
        if b.f(1):
            s.force_screen_content_tools = 2
        else:
            s.force_screen_content_tools = b.f(1)
        if s.force_screen_content_tools > 0:
            s.force_integer_mv = 2 if b.f(1) else b.f(1)
        if s.enable_order_hint:
            s.order_hint_bits = b.f(3) + 1
    s.enable_superres, s.enable_cdef, s.enable_restoration = b.f(1), b.f(1), b.f(1)
    # color_config
    high = b.f(1)
    s.bit_depth = 8
    if s.profile == 2 and high:
        s.bit_depth = 12 if b.f(1) else 10
    elif high:
        s.bit_depth = 10
    s.mono = 0 if s.profile == 1 else b.f(1)
    s.num_planes = 1 if s.mono else 3
    s.color_primaries = s.transfer = s.matrix = 2
    if b.f(1):
        s.color_primaries, s.transfer, s.matrix = b.f(8), b.f(8), b.f(8)
    s.separate_uv_delta_q = 0
    s.chroma_sample_position = 0
    if s.mono:
        s.color_range = b.f(1)
        s.ss_x = s.ss_y = 1
    elif (s.color_primaries, s.transfer, s.matrix) == (1, 13, 0):
        s.color_range = 1
        s.ss_x = s.ss_y = 0
    else:
        s.color_range = b.f(1)
        if s.profile == 0:
            s.ss_x = s.ss_y = 1
        elif s.profile == 1:
            s.ss_x = s.ss_y = 0
        elif s.bit_depth == 12:
            s.ss_x = b.f(1)
            s.ss_y = b.f(1) if s.ss_x else 0
        else:
            s.ss_x, s.ss_y = 1, 0
        if s.ss_x and s.ss_y:
            s.chroma_sample_position = b.f(2)
    if not s.mono:
        s.separate_uv_delta_q = b.f(1)
    s.film_grain_params_present = b.f(1)
    return s


def _tile_log2(blk: int, target: int) -> int:
    k = 0
    while (blk << k) < target:
        k += 1
    return k


def _delta_q(b: Bits) -> int:
    return b.su(7) if b.f(1) else 0


def frame_header(b: Bits, s: SimpleNamespace, name: str, tid: int = 0, sid: int = 0) -> SimpleNamespace:
    """The uncompressed header of the first frame (a shown key frame or an intra-only frame), read to its
    end; other frames raise UnsupportedImageFormat ("non-key first frame")."""
    h = SimpleNamespace()
    if s.reduced:
        h.frame_type, h.show_frame, h.showable_frame, h.error_resilient = KEY_FRAME, 1, 0, 1
    else:
        if b.f(1):
            raise _unsupported(name, "show_existing_frame first frame (non-key first frame)")
        h.frame_type = b.f(2)
        if h.frame_type not in (KEY_FRAME, INTRA_ONLY_FRAME):
            raise _unsupported(name, "inter first frame (non-key first frame)")
        h.show_frame = b.f(1)
        if h.show_frame and s.decoder_model_info and not s.equal_picture_interval:
            b.f(s.frame_presentation_time_length)
        h.showable_frame = h.frame_type != KEY_FRAME if h.show_frame else b.f(1)
        h.error_resilient = 1 if h.frame_type == KEY_FRAME and h.show_frame else b.f(1)
    h.disable_cdf_update = b.f(1)
    h.allow_screen_content_tools = b.f(1) if s.force_screen_content_tools == 2 else s.force_screen_content_tools
    if h.allow_screen_content_tools:
        raise _unsupported(name, "screen content tools (palette) frame")
    if h.allow_screen_content_tools and s.force_integer_mv == 2:
        b.f(1)
    if s.frame_id_numbers:
        b.f(s.frame_id_length)
    size_override = 0 if s.reduced else b.f(1)
    b.f(s.order_hint_bits)
    if s.decoder_model_info:
        if b.f(1):
            for op, idc in enumerate(s.op_idc):
                if s.decoder_model_for_op[op]:
                    if idc == 0 or ((idc >> tid) & 1 and (idc >> (sid + 8)) & 1):
                        b.f(s.buffer_removal_time_length)
    if not (h.frame_type == KEY_FRAME and h.show_frame):
        refresh = b.f(8)
        if refresh != 0xFF and h.error_resilient and s.enable_order_hint:
            for _ in range(8):
                b.f(s.order_hint_bits)
    # frame_size, superres_params, compute_image_size
    if size_override:
        h.width, h.height = b.f(s.frame_width_bits) + 1, b.f(s.frame_height_bits) + 1
    else:
        h.width, h.height = s.max_width, s.max_height
    h.use_superres = b.f(1) if s.enable_superres else 0
    if h.use_superres:
        raise _unsupported(name, "superres frame")
    h.upscaled_width = h.width
    h.mi_cols, h.mi_rows = 2 * ((h.width + 7) >> 3), 2 * ((h.height + 7) >> 3)
    if b.f(1):  # render_and_frame_size_different
        b.f(16), b.f(16)
    h.allow_intrabc = 0
    if h.allow_screen_content_tools and h.upscaled_width == h.width:
        h.allow_intrabc = b.f(1)
    if h.allow_intrabc:
        raise _unsupported(name, "intra block copy frame")
    h.disable_frame_end_update_cdf = 1 if s.reduced or h.disable_cdf_update else b.f(1)
    _tile_info(b, s, h)
    # quantization_params
    h.base_q_idx = b.f(8)
    h.dq_y_dc = _delta_q(b)
    h.dq_u_dc = h.dq_u_ac = h.dq_v_dc = h.dq_v_ac = 0
    if s.num_planes > 1:
        diff_uv = b.f(1) if s.separate_uv_delta_q else 0
        h.dq_u_dc, h.dq_u_ac = _delta_q(b), _delta_q(b)
        h.dq_v_dc, h.dq_v_ac = (_delta_q(b), _delta_q(b)) if diff_uv else (h.dq_u_dc, h.dq_u_ac)
    if b.f(1):
        raise _unsupported(name, "quantizer matrix frame")
    # segmentation_params
    h.seg_enabled = b.f(1)
    h.seg_feature = [[None] * 8 for _ in range(8)]
    if h.seg_enabled:
        for i in range(8):
            for j in range(8):
                if b.f(1):
                    bits, limit = SEG_FEATURE_BITS[j], SEG_FEATURE_MAX[j]
                    if SEG_FEATURE_SIGNED[j]:
                        h.seg_feature[i][j] = max(-limit, min(limit, b.su(1 + bits)))
                    else:
                        h.seg_feature[i][j] = max(0, min(limit, b.f(bits)))
    h.seg_id_pre_skip, h.last_active_seg_id = 0, 0
    for i in range(8):
        for j in range(8):
            if h.seg_feature[i][j] is not None:
                h.last_active_seg_id = i
                if j >= SEG_LVL_REF_FRAME:
                    h.seg_id_pre_skip = 1
    # delta_q_params, delta_lf_params
    h.delta_q_present = b.f(1) if h.base_q_idx > 0 else 0
    h.delta_q_res = b.f(2) if h.delta_q_present else 0
    h.delta_lf_present = h.delta_lf_res = h.delta_lf_multi = 0
    if h.delta_q_present:
        h.delta_lf_present = b.f(1)
        if h.delta_lf_present:
            h.delta_lf_res, h.delta_lf_multi = b.f(2), b.f(1)
    h.lossless = []
    for seg in range(8):
        q = qindex(h, seg, h.base_q_idx, ignore_delta=True)
        h.lossless.append(q == 0 and not (h.dq_y_dc or h.dq_u_ac or h.dq_u_dc or h.dq_v_ac or h.dq_v_dc))
    h.coded_lossless = all(h.lossless)
    h.all_lossless = h.coded_lossless
    # loop_filter_params
    h.lf_level = [0, 0, 0, 0]
    h.lf_sharpness = 0
    h.lf_ref_deltas = [1, 0, 0, 0, -1, 0, -1, -1]
    h.lf_mode_deltas = [0, 0]
    h.lf_delta_enabled = 0
    if not h.coded_lossless:
        h.lf_level[0], h.lf_level[1] = b.f(6), b.f(6)
        if s.num_planes > 1 and (h.lf_level[0] or h.lf_level[1]):
            h.lf_level[2], h.lf_level[3] = b.f(6), b.f(6)
        h.lf_sharpness = b.f(3)
        h.lf_delta_enabled = b.f(1)
        if h.lf_delta_enabled and b.f(1):
            for i in range(8):
                if b.f(1):
                    h.lf_ref_deltas[i] = b.su(7)
            for i in range(2):
                if b.f(1):
                    h.lf_mode_deltas[i] = b.su(7)
    # cdef_params
    h.cdef_bits, h.cdef_damping = 0, 3
    h.cdef_y_pri, h.cdef_y_sec, h.cdef_uv_pri, h.cdef_uv_sec = [0], [0], [0], [0]
    h.enable_cdef = bool(s.enable_cdef and not h.coded_lossless)
    if h.enable_cdef:
        h.cdef_damping = b.f(2) + 3
        h.cdef_bits = b.f(2)
        h.cdef_y_pri, h.cdef_y_sec, h.cdef_uv_pri, h.cdef_uv_sec = [], [], [], []
        for _ in range(1 << h.cdef_bits):
            h.cdef_y_pri.append(b.f(4))
            sec = b.f(2)
            h.cdef_y_sec.append(4 if sec == 3 else sec)
            if s.num_planes > 1:
                h.cdef_uv_pri.append(b.f(4))
                sec = b.f(2)
                h.cdef_uv_sec.append(4 if sec == 3 else sec)
            else:
                h.cdef_uv_pri.append(0)
                h.cdef_uv_sec.append(0)
    # lr_params
    h.lr_type = [RESTORE_NONE] * 3
    h.lr_unit_size = [256, 256, 256]
    h.uses_lr = 0
    if not h.all_lossless and s.enable_restoration:
        chroma_lr = 0
        for p in range(s.num_planes):
            h.lr_type[p] = _REMAP_LR_TYPE[b.f(2)]
            if h.lr_type[p] != RESTORE_NONE:
                h.uses_lr = 1
                chroma_lr |= p > 0
        if h.uses_lr:
            if s.sb128:
                shift = b.f(1) + 1
            else:
                shift = b.f(1)
                if shift:
                    shift += b.f(1)
            size = 256 >> (2 - shift)
            uv_shift = b.f(1) if s.ss_x and s.ss_y and chroma_lr else 0
            h.lr_unit_size = [size, size >> uv_shift, size >> uv_shift]
    # read_tx_mode
    h.tx_mode = ONLY_4X4 if h.coded_lossless else (TX_MODE_SELECT if b.f(1) else TX_MODE_LARGEST)
    # reference_select, skip_mode and warped motion are absent from intra frames
    h.reduced_tx_set = b.f(1)
    if s.film_grain_params_present and (h.show_frame or h.showable_frame):
        if b.f(1):
            raise _unsupported(name, "film grain frame")
    return h


def qindex(h: SimpleNamespace, segment: int, current: int, ignore_delta: bool = False) -> int:
    """get_qindex(ignoreDeltaQ, segmentId) with CurrentQIndex `current`."""
    data = h.seg_feature[segment][SEG_LVL_ALT_Q] if h.seg_enabled else None
    if data is not None:
        q = (current if not ignore_delta and h.delta_q_present else h.base_q_idx) + data
        return max(0, min(255, q))
    if not ignore_delta and h.delta_q_present:
        return current
    return h.base_q_idx


def _tile_info(b: Bits, s: SimpleNamespace, h: SimpleNamespace):
    sb_cols = (h.mi_cols + 31) >> 5 if s.sb128 else (h.mi_cols + 15) >> 4
    sb_rows = (h.mi_rows + 31) >> 5 if s.sb128 else (h.mi_rows + 15) >> 4
    sb_shift = 5 if s.sb128 else 4
    sb_size = sb_shift + 2
    max_tile_width_sb = 4096 >> sb_size
    max_tile_area_sb = (4096 * 2304) >> (2 * sb_size)
    min_log2_cols = _tile_log2(max_tile_width_sb, sb_cols)
    max_log2_cols = _tile_log2(1, min(sb_cols, 64))
    max_log2_rows = _tile_log2(1, min(sb_rows, 64))
    min_log2_tiles = max(min_log2_cols, _tile_log2(max_tile_area_sb, sb_rows * sb_cols))
    cols, rows = [], []
    if b.f(1):  # uniform_tile_spacing_flag
        h.tile_cols_log2 = min_log2_cols
        while h.tile_cols_log2 < max_log2_cols and b.f(1):
            h.tile_cols_log2 += 1
        w = (sb_cols + (1 << h.tile_cols_log2) - 1) >> h.tile_cols_log2
        cols = list(range(0, sb_cols, w))
        min_log2_rows = max(min_log2_tiles - h.tile_cols_log2, 0)
        h.tile_rows_log2 = min_log2_rows
        while h.tile_rows_log2 < max_log2_rows and b.f(1):
            h.tile_rows_log2 += 1
        hh = (sb_rows + (1 << h.tile_rows_log2) - 1) >> h.tile_rows_log2
        rows = list(range(0, sb_rows, hh))
    else:
        widest, start = 0, 0
        while start < sb_cols:
            cols.append(start)
            size = b.ns(min(sb_cols - start, max_tile_width_sb)) + 1
            widest = max(widest, size)
            start += size
        h.tile_cols_log2 = _tile_log2(1, len(cols))
        area = (sb_rows * sb_cols) >> (min_log2_tiles + 1) if min_log2_tiles > 0 else sb_rows * sb_cols
        max_height = max(area // widest, 1)
        start = 0
        while start < sb_rows:
            rows.append(start)
            start += b.ns(min(sb_rows - start, max_height)) + 1
        h.tile_rows_log2 = _tile_log2(1, len(rows))
    h.mi_col_starts = [c << sb_shift for c in cols] + [h.mi_cols]
    h.mi_row_starts = [r << sb_shift for r in rows] + [h.mi_rows]
    h.tile_cols, h.tile_rows = len(cols), len(rows)
    h.tile_size_bytes = 4
    if h.tile_cols_log2 or h.tile_rows_log2:
        b.f(h.tile_rows_log2 + h.tile_cols_log2)  # context_update_tile_id
        h.tile_size_bytes = b.f(2) + 1


def _tile_group(payload: bytes, start: int, h: SimpleNamespace, tiles: dict, name: str) -> bool:
    """Reads one tile group's tiles into `tiles` (tile number: bytes); True when it held the last tile."""
    b = Bits(payload, name, start)
    n = h.tile_cols * h.tile_rows
    first, last = 0, n - 1
    if n > 1 and b.f(1):
        bits = h.tile_cols_log2 + h.tile_rows_log2
        first, last = b.f(bits), b.f(bits)
    b.byte_align()
    pos = b.pos >> 3
    for t in range(first, last + 1):
        if t == last:
            size = len(payload) - pos
        else:
            if pos + h.tile_size_bytes > len(payload):
                raise ValueError(f"{name}: AV1 tile size cut short")
            size = int.from_bytes(payload[pos : pos + h.tile_size_bytes], "little") + 1
            pos += h.tile_size_bytes
        if size <= 0 or pos + size > len(payload):
            raise ValueError(f"{name}: AV1 tile {t} of {size} bytes cut short")
        tiles[t] = payload[pos : pos + size]
        pos += size
    return last == n - 1


def parse(data: bytes, name: str):
    """(sequence header, frame header, {tile number: bytes}) of the first frame in `data`; the OBUs after it
    are walked for their sizes (dav1d reads them all)."""
    units = obus(data, name)
    out = _first_frame(units, name)
    for kind, _, _, payload in units:  # dav1d reads on: a sequence header must parse, a tile group needs a frame
        if kind == OBU_SEQUENCE_HEADER:
            sequence_header(payload, name)
        elif kind in (OBU_FRAME_HEADER, OBU_FRAME):
            break
        elif kind == OBU_TILE_GROUP:
            raise ValueError(f"{name}: AV1 tile group after the frame's last tile")
    for _ in units:
        pass
    return out


def _first_frame(units, name: str):
    seq = h = None
    tiles = {}
    for kind, tid, sid, payload in units:
        if kind == OBU_SEQUENCE_HEADER:
            if seq is None:
                seq = sequence_header(payload, name)
        elif kind in (OBU_FRAME_HEADER, OBU_FRAME, OBU_REDUNDANT_FRAME_HEADER):
            if h is not None:
                if kind == OBU_FRAME:
                    raise ValueError(f"{name}: a second AV1 frame before the first one's tiles")
                continue
            if seq is None:
                raise ValueError(f"{name}: AV1 frame header before any sequence header")
            b = Bits(payload, name)
            h = frame_header(b, seq, name, tid, sid)
            if kind == OBU_FRAME:
                b.byte_align()
                if _tile_group(payload, b.pos >> 3, h, tiles, name):
                    return seq, h, tiles
        elif kind == OBU_TILE_GROUP:
            if h is None:
                raise ValueError(f"{name}: AV1 tile group before its frame header")
            if _tile_group(payload, 0, h, tiles, name):
                return seq, h, tiles
        elif kind == OBU_TILE_LIST:
            raise ValueError(f"{name}: AV1 tile list OBU (large scale tile)")
    raise ValueError(f"{name}: AV1 data ends before the first frame's last tile")
