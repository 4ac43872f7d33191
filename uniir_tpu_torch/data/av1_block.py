"""AV1 tile decoding of an intra frame (specification sections 5.11 and 6.10's semantics, 7.11-7.13's
processes as `av1_recon` implements them): superblocks and partitions of every type on 64 x 64 and 128 x 128
superblocks, segment ids, skip, delta q / delta lf, y and uv modes with angle deltas, CfL alphas and filter
intra, transform sizes and the intra transform-type sets, coefficients with every context, dequantisation
with its clamps, and reconstruction into the frame's planes.

`decode_frame(seq, hdr, tiles, name)` returns the reconstructed planes and the per-4x4 records the loop
filter reads.  Palette blocks (screen content tools) raise UnsupportedImageFormat.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from uniir_tpu_torch.data import av1_recon as R
from uniir_tpu_torch.data.av1_entropy import SymbolDecoder, tile_cdfs
from uniir_tpu_torch.data.av1_obu import TX_MODE_SELECT, qindex, SEG_LVL_SKIP
from uniir_tpu_torch.data import av1_filters as F
from uniir_tpu_torch.data import av1_tables as T

# block sizes: BLOCK_4X4 .. BLOCK_64X16 (Block_Width / Block_Height)
BW = (4, 4, 8, 8, 8, 16, 16, 16, 32, 32, 32, 64, 64, 64, 128, 128, 4, 16, 8, 32, 16, 64)
BH = (4, 8, 4, 8, 16, 8, 16, 32, 16, 32, 64, 32, 64, 128, 64, 128, 16, 4, 32, 8, 64, 16)
BLOCK = {(w, h): i for i, (w, h) in enumerate(zip(BW, BH))}
BLOCK_4X4, BLOCK_8X8, BLOCK_64X64, BLOCK_128X128 = 0, 3, 12, 15
# transform sizes: TX_4X4 .. TX_64X16
TXW = (4, 8, 16, 32, 64, 4, 8, 8, 16, 16, 32, 32, 64, 4, 16, 8, 32, 16, 64)
TXH = (4, 8, 16, 32, 64, 8, 4, 16, 8, 32, 16, 64, 32, 16, 4, 32, 8, 64, 16)
TX = {(w, h): i for i, (w, h) in enumerate(zip(TXW, TXH))}
TX_4X4, TX_16X64, TX_64X16 = 0, 17, 18
PARTITION_NONE, PARTITION_HORZ, PARTITION_VERT, PARTITION_SPLIT = 0, 1, 2, 3
PARTITION_HORZ_A, PARTITION_HORZ_B, PARTITION_VERT_A, PARTITION_VERT_B, PARTITION_HORZ_4, PARTITION_VERT_4 = range(4, 10)
DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, IDTX, V_DCT, H_DCT = 0, 1, 2, 3, 9, 10, 11
# symbol -> TxType for the intra sets (Tx_Type_Intra_Inv_Set1 / Set2)
_INV_SET1 = (IDTX, DCT_DCT, V_DCT, H_DCT, ADST_ADST, ADST_DCT, DCT_ADST)
_INV_SET2 = (IDTX, DCT_DCT, ADST_ADST, ADST_DCT, DCT_ADST)
_IN_SET = {0: {DCT_DCT}, 1: {DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, IDTX, V_DCT, H_DCT},
           2: {DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, IDTX}}
MODE_TO_TXFM = (DCT_DCT, ADST_DCT, DCT_ADST, DCT_DCT, ADST_ADST, ADST_DCT, DCT_ADST, DCT_ADST, ADST_DCT, ADST_ADST,
                ADST_DCT, DCT_ADST, ADST_ADST, DCT_DCT)
INTRA_MODE_CONTEXT = (0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0)
FILTER_INTRA_MODE_TO_DIR = (R.DC_PRED, R.V_PRED, R.H_PRED, R.D157_PRED, R.DC_PRED)
TX_CLASS_2D, TX_CLASS_HORIZ, TX_CLASS_VERT = 0, 1, 2
_SIG_REF = {TX_CLASS_2D: ((0, 1), (1, 0), (1, 1), (0, 2), (2, 0)),
            TX_CLASS_HORIZ: ((0, 1), (1, 0), (0, 2), (0, 3), (0, 4)),
            TX_CLASS_VERT: ((0, 1), (1, 0), (2, 0), (3, 0), (4, 0))}
_MAG_REF = {TX_CLASS_2D: ((0, 1), (1, 0), (1, 1)), TX_CLASS_HORIZ: ((0, 1), (1, 0), (0, 2)),
            TX_CLASS_VERT: ((0, 1), (1, 0), (2, 0))}


def _tx_class(tx_type: int) -> int:
    if tx_type in (10, 12, 14):  # V_DCT, V_ADST, V_FLIPADST
        return TX_CLASS_VERT
    if tx_type in (11, 13, 15):
        return TX_CLASS_HORIZ
    return TX_CLASS_2D


def _max_tx_rect(bsize: int) -> int:
    return TX[(min(BW[bsize], 64), min(BH[bsize], 64))]


def _split_tx(tx: int) -> int:
    w, h = TXW[tx], TXH[tx]
    if w == h:
        return TX[(max(w // 2, 4), max(h // 2, 4))]
    if max(w, h) == 4 * min(w, h):
        return TX[(w // 2, h)] if w > h else TX[(w, h // 2)]
    return TX[(min(w, h), min(w, h))]


def _max_depth(bsize: int) -> int:
    tx, d = _max_tx_rect(bsize), 0
    while tx != TX_4X4:
        tx, d = _split_tx(tx), d + 1
    return d


MAX_TX_RECT = [_max_tx_rect(b) for b in range(22)]
MAX_TX_DEPTH = [_max_depth(b) for b in range(22)]
SPLIT_TX = [_split_tx(t) for t in range(19)]
TX_SQR = [TX[(min(w, h), min(w, h))] for w, h in zip(TXW, TXH)]
TX_SQR_UP = [TX[(max(w, h), max(w, h))] for w, h in zip(TXW, TXH)]
ADJUSTED_TX = [TX[(min(w, 32), min(h, 32))] for w, h in zip(TXW, TXH)]


def _scan(w: int, h: int) -> list:
    """Default_Scan_WxH: the zig-zag over anti-diagonals for square sizes, one direction per diagonal for
    rectangular ones (positions row * w + col)."""
    order = []
    for d in range(w + h - 1):
        cells = [(r, d - r) for r in range(h) if 0 <= d - r < w]  # row rising (top-right to bottom-left)
        if w == h:
            if d % 2 == 0:
                cells = cells[::-1]
        elif w > h:
            cells = cells[::-1]
        order.extend(r * w + c for r, c in cells)
    return order


_SCANS = {}


def get_scan(tx: int, tx_type: int) -> list:
    if tx == TX_16X64:
        key = (16, 32, 0)
    elif tx == TX_64X16:
        key = (32, 16, 0)
    elif TX_SQR_UP[tx] == 4:  # TX_64X64
        key = (32, 32, 0)
    else:
        key = (TXW[tx], TXH[tx], {TX_CLASS_2D: 0, TX_CLASS_VERT: 1, TX_CLASS_HORIZ: 2}[_tx_class(tx_type)])
    if key not in _SCANS:
        w, h, kind = key
        if kind == 0:
            _SCANS[key] = _scan(w, h)
        elif kind == 1:  # mrow: row by row
            _SCANS[key] = list(range(w * h))
        else:  # mcol: column by column
            _SCANS[key] = [r * w + c for c in range(w) for r in range(h)]
    return _SCANS[key]


def _coeff_base_ctx_offset(tx: int, row: int, col: int) -> int:
    """Coeff_Base_Ctx_Offset[txSz][Min(row, 4)][Min(col, 4)] by its rule."""
    w, h = TXW[tx], TXH[tx]
    if row == 0 and col == 0:
        return 0
    if w == h:
        return 1 if row + col < 2 else 6 if row + col < 4 else 21
    if w > h:
        if col < 2:
            return 16
        return 6 if row + col < 4 else 21
    if row < 2:
        return 11
    return 6 if row + col < 4 else 21


_CONTEXTS = {}


def _coeff_contexts(tx: int, cls: int):
    """Per coefficient position of `tx` (its adjusted, at most 32 x 32, layout) in class `cls`: the
    neighbours coeff_base's context sums, that context's offset (-1: the 2-D DC, context 0), the neighbours
    coeff_br's context sums and its offset."""
    key = (tx, cls)
    if key not in _CONTEXTS:
        adj = ADJUSTED_TX[tx]
        txw, txh = TXW[adj], TXH[adj]
        bwl = txw.bit_length() - 1
        sig_nb, base_off, mag_nb, br_off = [], [], [], []
        for pos in range(txw * txh):
            row, col = pos >> bwl, pos & (txw - 1)
            sig_nb.append(tuple((row + dr << bwl) + col + dc for dr, dc in _SIG_REF[cls]
                                if row + dr < txh and col + dc < txw))
            mag_nb.append(tuple((row + dr << bwl) + col + dc for dr, dc in _MAG_REF[cls]
                                if row + dr < txh and col + dc < txw))
            if cls == TX_CLASS_2D:
                base_off.append(-1 if pos == 0 else _coeff_base_ctx_offset(tx, min(row, 4), min(col, 4)))
                near = row < 2 and col < 2
            else:
                idx = row if cls == TX_CLASS_VERT else col
                base_off.append((26, 31, 36)[min(idx, 2)])
                near = idx == 0
            br_off.append(0 if pos == 0 else 7 if near else 14)
        _CONTEXTS[key] = (sig_nb, base_off, mag_nb, br_off)
    return _CONTEXTS[key]


def _plane_size(bsize: int, sx: int, sy: int) -> int:
    return BLOCK.get((max(BW[bsize] >> sx, 4), max(BH[bsize] >> sy, 4)), -1)


class Frame:
    """The frame being decoded: planes and per-4x4 records."""

    def __init__(self, seq, hdr):
        self.seq, self.hdr = seq, hdr
        self.mi_rows, self.mi_cols = hdr.mi_rows, hdr.mi_cols
        pad = 160
        self.planes = []
        for p in range(seq.num_planes):
            sx = seq.ss_x if p else 0
            sy = seq.ss_y if p else 0
            self.planes.append(np.zeros(((self.mi_rows * 4 >> sy) + pad, (self.mi_cols * 4 >> sx) + pad), np.int32))
        shape = (self.mi_rows + 32, self.mi_cols + 32)
        self.mi_size = np.zeros(shape, np.int8)
        self.y_mode = np.zeros(shape, np.int8)
        self.uv_mode = np.zeros(shape, np.int8)
        self.skip = np.zeros(shape, np.int8)
        self.tx_size = np.zeros(shape, np.int8)
        self.seg_id = np.zeros(shape, np.int8)
        self.delta_lf = np.zeros(shape + (4,), np.int8)
        self.lf_tx = [np.zeros(((self.mi_rows + 32) >> (seq.ss_y if p else 0), (self.mi_cols + 32)
                                >> (seq.ss_x if p else 0)), np.int8) for p in range(seq.num_planes)]
        self.cdef_idx = np.full(shape, -1, np.int8)
        self.lr = {}  # (plane, unit row, unit column) -> the unit's restoration type and coefficients
        self.deblocked = None  # the planes before CDEF, where CDEF runs (loop restoration reads them)


class TileDecoder:
    def __init__(self, frame: Frame, data: bytes, row_start, row_end, col_start, col_end, name: str):
        f = frame
        self.f, self.seq, self.h, self.name = f, f.seq, f.hdr, name
        self.sd = SymbolDecoder(data, self.h.disable_cdf_update, name)
        self.cdf = tile_cdfs(self.h.base_q_idx)
        self.r0, self.r1, self.c0, self.c1 = row_start, row_end, col_start, col_end
        s = self.seq
        np_ = s.num_planes
        self.sub = [(0, 0)] + [(s.ss_x, s.ss_y)] * (np_ - 1)
        # level / dc contexts in each plane's 4 x 4 units, whole-frame indexed
        self.above_level = [[0] * ((f.mi_cols + 64) >> 0) for _ in range(np_)]
        self.above_dc = [[0] * (f.mi_cols + 64) for _ in range(np_)]
        self.left_level = [[0] * (f.mi_rows + 64) for _ in range(np_)]
        self.left_dc = [[0] * (f.mi_rows + 64) for _ in range(np_)]
        self.delta_lf = [0, 0, 0, 0]
        self.current_q = self.h.base_q_idx
        self.sb4 = 32 if s.sb128 else 16
        F.reset_lr_refs(self)

    # -------------------------------------------------------------------------------------------------
    def decode(self):
        h, s = self.h, self.seq
        sb4 = self.sb4
        sbsize = BLOCK_128X128 if s.sb128 else BLOCK_64X64
        for r in range(self.r0, self.r1, sb4):
            for p in range(s.num_planes):
                self.left_level[p] = [0] * len(self.left_level[p])
                self.left_dc[p] = [0] * len(self.left_dc[p])
            for c in range(self.c0, self.c1, sb4):
                self.read_deltas = h.delta_q_present
                f = self.f
                f.cdef_idx[r, c] = -1
                if s.sb128:
                    f.cdef_idx[r, c + 16] = f.cdef_idx[r + 16, c] = f.cdef_idx[r + 16, c + 16] = -1
                self._clear_block_decoded(r, c)
                self._read_lr(r, c, sbsize)
                self._partition(r, c, sbsize)
            # dav1d's check after each superblock row: its symbol decoder read 15 bits or more past the tile
            if self.sd.max_bits < -14:
                raise ValueError(f"{self.name}: AV1 tile data read past its end (decoding of colour planes failed)")

    def _clear_block_decoded(self, r, c):
        sb4 = self.sb4
        self.decoded = []
        for p in range(self.seq.num_planes):
            sx, sy = self.sub[p]
            w4 = (self.c1 - c) >> sx
            h4 = (self.r1 - r) >> sy
            n = (sb4 >> sx) + 3
            m = (sb4 >> sy) + 3
            d = np.zeros((m, n), bool)  # [y + 1][x + 1]
            for x in range(-1, (sb4 >> sx) + 1):
                if x < w4:
                    d[0, x + 1] = True
            for y in range(-1, (sb4 >> sy) + 1):
                if y < h4:
                    d[y + 1, 0] = True
            d[(sb4 >> sy) + 1, 0] = False
            self.decoded.append(d)

    def _inside(self, r, c) -> bool:
        return self.c0 <= c < self.c1 and self.r0 <= r < self.r1

    # ---- loop restoration coefficients (read per superblock) --------------------------------------------
    def _read_lr(self, r, c, bsize):
        if self.h.uses_lr:
            F.read_lr(self, r, c, bsize)

    # ---- partitions --------------------------------------------------------------------------------------
    def _partition(self, r, c, bsize):
        f = self.f
        if r >= f.mi_rows or c >= f.mi_cols:
            return
        avail_u, avail_l = self._inside(r - 1, c), self._inside(r, c - 1)
        n4 = BW[bsize] >> 2
        half = n4 >> 1
        quarter = half >> 1
        has_rows = r + half < f.mi_rows
        has_cols = c + half < f.mi_cols
        if bsize < BLOCK_8X8:
            part = PARTITION_NONE
        else:
            bsl = {8: 1, 16: 2, 32: 3, 64: 4, 128: 5}[BW[bsize]]
            above = avail_u and ({4: 0, 8: 1, 16: 2, 32: 3, 64: 4, 128: 5}[BW[f.mi_size[r - 1, c]]] < bsl)
            left = avail_l and ({4: 0, 8: 1, 16: 2, 32: 3, 64: 4, 128: 5}[BH[f.mi_size[r, c - 1]]] < bsl)
            ctx = left * 2 + above
            cdf = self.cdf[{8: "PARTITION_W8_CDF", 16: "PARTITION_W16_CDF", 32: "PARTITION_W32_CDF",
                            64: "PARTITION_W64_CDF", 128: "PARTITION_W128_CDF"}[BW[bsize]]][ctx]
            if has_rows and has_cols:
                part = self.sd.symbol(cdf)
            elif has_cols:
                prob = lambda x: cdf[x] - (cdf[x - 1] if x else 0)  # noqa: E731
                # split_or_horz: libaom's partition_gather_vert_alike
                psum = sum(prob(x) for x in (PARTITION_VERT, PARTITION_SPLIT, PARTITION_HORZ_A, PARTITION_VERT_A,
                                             PARTITION_VERT_B)) + (prob(PARTITION_VERT_4) if bsize != BLOCK_128X128
                                                                   else 0)
                part = PARTITION_SPLIT if self._bool_p(psum) else PARTITION_HORZ
            elif has_rows:
                prob = lambda x: cdf[x] - (cdf[x - 1] if x else 0)  # noqa: E731
                psum = sum(prob(x) for x in (PARTITION_HORZ, PARTITION_SPLIT, PARTITION_HORZ_A, PARTITION_HORZ_B,
                                             PARTITION_VERT_A)) + (prob(PARTITION_HORZ_4) if bsize != BLOCK_128X128
                                                                   else 0)
                part = PARTITION_SPLIT if self._bool_p(psum) else PARTITION_VERT
            else:
                part = PARTITION_SPLIT
        w, hh = BW[bsize], BH[bsize]
        if part == PARTITION_NONE:
            self._block(r, c, bsize)
        elif part == PARTITION_HORZ:
            sub = BLOCK[(w, hh // 2)]
            self._block(r, c, sub)
            if has_rows:
                self._block(r + half, c, sub)
        elif part == PARTITION_VERT:
            sub = BLOCK[(w // 2, hh)]
            self._block(r, c, sub)
            if has_cols:
                self._block(r, c + half, sub)
        elif part == PARTITION_SPLIT:
            sub = BLOCK[(w // 2, hh // 2)]
            self._partition(r, c, sub)
            self._partition(r, c + half, sub)
            self._partition(r + half, c, sub)
            self._partition(r + half, c + half, sub)
        else:
            split = BLOCK[(w // 2, hh // 2)]
            if part == PARTITION_HORZ_A:
                self._block(r, c, split)
                self._block(r, c + half, split)
                self._block(r + half, c, BLOCK[(w, hh // 2)])
            elif part == PARTITION_HORZ_B:
                self._block(r, c, BLOCK[(w, hh // 2)])
                self._block(r + half, c, split)
                self._block(r + half, c + half, split)
            elif part == PARTITION_VERT_A:
                self._block(r, c, split)
                self._block(r + half, c, split)
                self._block(r, c + half, BLOCK[(w // 2, hh)])
            elif part == PARTITION_VERT_B:
                self._block(r, c, BLOCK[(w // 2, hh)])
                self._block(r, c + half, split)
                self._block(r + half, c + half, split)
            elif part == PARTITION_HORZ_4:
                sub = BLOCK[(w, hh // 4)]
                for i in range(4):
                    if i == 0 or r + quarter * i < f.mi_rows:
                        self._block(r + quarter * i, c, sub)
            else:
                sub = BLOCK[(w // 4, hh)]
                for i in range(4):
                    if i == 0 or c + quarter * i < f.mi_cols:
                        self._block(r, c + quarter * i, sub)

    def _bool_p(self, psum: int) -> int:
        """A symbol of the CDF [32768 - psum, 32768], not adapted."""
        upd = self.sd.update
        self.sd.update = False
        try:
            return self.sd.symbol([32768 - psum, 32768, 0])
        finally:
            self.sd.update = upd

    # ---- blocks ------------------------------------------------------------------------------------------
    def _block(self, r, c, bsize):
        f, s, h = self.f, self.seq, self.h
        sd, cdf = self.sd, self.cdf
        bw4, bh4 = BW[bsize] >> 2, BH[bsize] >> 2
        b = SimpleNamespace(r=r, c=c, size=bsize, bw4=bw4, bh4=bh4)
        if bh4 == 1 and s.ss_y and (r & 1) == 0:
            b.has_chroma = False
        elif bw4 == 1 and s.ss_x and (c & 1) == 0:
            b.has_chroma = False
        else:
            b.has_chroma = s.num_planes > 1
        b.avail_u, b.avail_l = self._inside(r - 1, c), self._inside(r, c - 1)
        b.avail_u_chroma, b.avail_l_chroma = b.avail_u, b.avail_l
        if b.has_chroma:
            if s.ss_y and bh4 == 1:
                b.avail_u_chroma = self._inside(r - 2, c)
            if s.ss_x and bw4 == 1:
                b.avail_l_chroma = self._inside(r, c - 2)
        else:
            b.avail_u_chroma = b.avail_l_chroma = False
        # intra_frame_mode_info
        b.skip = 0
        b.segment_id = 0
        if h.seg_id_pre_skip:
            self._segment_id(b)
        if h.seg_id_pre_skip and h.seg_feature[b.segment_id][SEG_LVL_SKIP] is not None:
            b.skip = 1
        else:
            ctx = (f.skip[r - 1, c] if b.avail_u else 0) + (f.skip[r, c - 1] if b.avail_l else 0)
            b.skip = sd.symbol(cdf["SKIP_CDF"][ctx])
        if not h.seg_id_pre_skip:
            self._segment_id(b)
        b.lossless = h.lossless[b.segment_id]
        if not b.skip and h.enable_cdef:
            cr, cc = r & ~15, c & ~15
            if f.cdef_idx[cr, cc] == -1:
                idx = sd.literal(h.cdef_bits)
                for y in range(cr, cr + bh4, 16):
                    for x in range(cc, cc + bw4, 16):
                        f.cdef_idx[y, x] = idx
        sbsize = BLOCK_128X128 if s.sb128 else BLOCK_64X64
        if not (bsize == sbsize and b.skip) and self.read_deltas:
            self._delta_q_lf()
        self.read_deltas = 0
        above_mode = f.y_mode[r - 1, c] if b.avail_u else R.DC_PRED
        left_mode = f.y_mode[r, c - 1] if b.avail_l else R.DC_PRED
        b.y_mode = sd.symbol(cdf["KF_Y_MODE_CDF"][INTRA_MODE_CONTEXT[above_mode]][INTRA_MODE_CONTEXT[left_mode]])
        b.angle_y = 0
        if bsize >= BLOCK_8X8 and R.V_PRED <= b.y_mode <= R.D67_PRED:
            b.angle_y = sd.symbol(cdf["ANGLE_DELTA_CDF"][b.y_mode - R.V_PRED]) - 3
        b.uv_mode, b.angle_uv, b.cfl_u, b.cfl_v = R.DC_PRED, 0, 0, 0
        if b.has_chroma:
            if b.lossless and _plane_size(bsize, s.ss_x, s.ss_y) == BLOCK_4X4:
                cfl_allowed = True
            else:
                cfl_allowed = not b.lossless and max(BW[bsize], BH[bsize]) <= 32
            if cfl_allowed:
                b.uv_mode = sd.symbol(cdf["UV_MODE_CFL_ALLOWED_CDF"][b.y_mode])
            else:
                b.uv_mode = sd.symbol(cdf["UV_MODE_CFL_NOT_ALLOWED_CDF"][b.y_mode])
            if b.uv_mode == R.UV_CFL_PRED:
                signs = sd.symbol(cdf["CFL_SIGN_CDF"])
                sign_u, sign_v = (signs + 1) // 3, (signs + 1) % 3
                if sign_u:
                    a = 1 + sd.symbol(cdf["CFL_ALPHA_CDF"][(sign_u - 1) * 3 + sign_v])
                    b.cfl_u = -a if sign_u == 1 else a
                if sign_v:
                    a = 1 + sd.symbol(cdf["CFL_ALPHA_CDF"][(sign_v - 1) * 3 + sign_u])
                    b.cfl_v = -a if sign_v == 1 else a
            if bsize >= BLOCK_8X8 and R.V_PRED <= b.uv_mode <= R.D67_PRED:
                b.angle_uv = sd.symbol(cdf["ANGLE_DELTA_CDF"][b.uv_mode - R.V_PRED]) - 3
        b.filter_mode = -1
        if s.enable_filter_intra and b.y_mode == R.DC_PRED and max(BW[bsize], BH[bsize]) <= 32:
            if sd.symbol(cdf["FILTER_INTRA_CDF"][bsize]):
                b.filter_mode = sd.symbol(cdf["FILTER_INTRA_MODE_CDF"])
        # read_block_tx_size
        b.tx_size = self._tx_size(b)
        if b.skip:
            self._reset_block_context(b)
        sl = (slice(r, r + bh4), slice(c, c + bw4))
        f.y_mode[sl] = b.y_mode
        f.uv_mode[sl] = b.uv_mode
        f.skip[sl] = b.skip
        f.tx_size[sl] = b.tx_size
        f.mi_size[sl] = bsize
        f.seg_id[sl] = b.segment_id
        f.delta_lf[sl] = self.delta_lf
        self._residual(b)

    def _segment_id(self, b):
        f, h = self.f, self.h
        if not h.seg_enabled:
            b.segment_id = 0
            return
        r, c = b.r, b.c
        prev_ul = int(f.seg_id[r - 1, c - 1]) if b.avail_u and b.avail_l else -1
        prev_u = int(f.seg_id[r - 1, c]) if b.avail_u else -1
        prev_l = int(f.seg_id[r, c - 1]) if b.avail_l else -1
        if prev_u == -1:
            pred = 0 if prev_l == -1 else prev_l
        elif prev_l == -1:
            pred = prev_u
        else:
            pred = prev_u if prev_ul == prev_u else prev_l
        if b.skip:
            b.segment_id = pred
            return
        if prev_ul < 0:
            ctx = 0
        elif prev_ul == prev_u and prev_ul == prev_l:
            ctx = 2
        elif prev_ul == prev_u or prev_ul == prev_l or prev_u == prev_l:
            ctx = 1
        else:
            ctx = 0
        v = self.sd.symbol(self.cdf["SEGMENT_ID_CDF"][ctx])
        mx = h.last_active_seg_id + 1
        # neg_deinterleave
        if not pred:
            seg = v
        elif pred >= mx - 1:
            seg = mx - v - 1
        elif 2 * pred < mx:
            if v <= 2 * pred:
                seg = pred + ((v + 1) >> 1) if v & 1 else pred - (v >> 1)
            else:
                seg = v
        else:
            if v <= 2 * (mx - pred - 1):
                seg = pred + ((v + 1) >> 1) if v & 1 else pred - (v >> 1)
            else:
                seg = mx - (v + 1)
        b.segment_id = max(0, min(h.last_active_seg_id, seg))

    def _delta_q_lf(self):
        h, sd = self.h, self.sd
        if h.delta_q_present:
            a = sd.symbol(self.cdf["DELTA_Q_CDF"])
            if a == 3:
                bits = sd.literal(3) + 1
                a = sd.literal(bits) + (1 << bits) + 1
            if a:
                sign = sd.literal(1)
                d = -a if sign else a
                self.current_q = max(1, min(255, self.current_q + (d << h.delta_q_res)))
        if h.delta_lf_present:
            count = (4 if self.seq.num_planes > 1 else 2) if h.delta_lf_multi else 1
            for i in range(count):
                cdf = self.cdf["DELTA_LF_MULTI_CDF"][i] if h.delta_lf_multi else self.cdf["DELTA_LF_CDF"]
                a = sd.symbol(cdf)
                if a == 3:
                    bits = sd.literal(3) + 1
                    a = sd.literal(bits) + (1 << bits) + 1
                if a:
                    sign = sd.literal(1)
                    d = -a if sign else a
                    self.delta_lf[i] = max(-63, min(63, self.delta_lf[i] + (d << h.delta_lf_res)))

    def _tx_size(self, b) -> int:
        f, h = self.f, self.h
        if b.lossless:
            return TX_4X4
        bsize = b.size
        tx = MAX_TX_RECT[bsize]
        depth_max = MAX_TX_DEPTH[bsize]
        if bsize > BLOCK_4X4 and h.tx_mode == TX_MODE_SELECT:
            r, c = b.r, b.c
            max_w, max_h = TXW[tx], TXH[tx]
            above_w = TXW[f.tx_size[r - 1, c]] if b.avail_u else 0
            left_h = TXH[f.tx_size[r, c - 1]] if b.avail_l else 0
            ctx = (above_w >= max_w) + (left_h >= max_h)
            name = {1: "TX_8X8_CDF", 2: "TX_16X16_CDF", 3: "TX_32X32_CDF", 4: "TX_64X64_CDF"}[depth_max]
            depth = self.sd.symbol(self.cdf[name][ctx])
            for _ in range(depth):
                tx = SPLIT_TX[tx]
        return tx

    def _reset_block_context(self, b):
        for p in range(1 + 2 * b.has_chroma):
            sx, sy = self.sub[p]
            for i in range(b.c >> sx, ((b.c + b.bw4 - 1) >> sx) + 1):
                self.above_level[p][i] = 0
                self.above_dc[p][i] = 0
            for i in range(b.r >> sy, ((b.r + b.bh4 - 1) >> sy) + 1):
                self.left_level[p][i] = 0
                self.left_dc[p][i] = 0

    # ---- residual ----------------------------------------------------------------------------------------
    def _chroma_tx(self, b) -> int:
        s = self.seq
        uv = MAX_TX_RECT[_plane_size(b.size, s.ss_x, s.ss_y)]
        if TXW[uv] == 64 or TXH[uv] == 64:
            if uv == TX_16X64:
                return TX[(16, 32)]
            if uv == TX_64X16:
                return TX[(32, 16)]
            return TX[(32, 32)]
        return uv

    def _residual(self, b):
        s = self.seq
        sbmask = 31 if s.sb128 else 15
        wchunks, hchunks = max(1, b.bw4 >> 4), max(1, b.bh4 >> 4)
        for cy in range(hchunks):
            for cx in range(wchunks):
                for p in range(1 + 2 * b.has_chroma):
                    tx = TX_4X4 if b.lossless else (b.tx_size if p == 0 else self._chroma_tx(b))
                    step_x, step_y = TXW[tx] >> 2, TXH[tx] >> 2
                    sx, sy = self.sub[p]
                    psz = _plane_size(b.size, sx, sy)
                    n4w, n4h = BW[psz] >> 2, BH[psz] >> 2
                    base_x, base_y = (b.c >> sx) * 4, (b.r >> sy) * 4
                    for y in range(0, min(n4h, 16 >> sy), step_y):
                        for x in range(0, min(n4w, 16 >> sx), step_x):
                            self._transform_block(b, p, base_x, base_y, tx, x + ((cx << 4) >> sx),
                                                  y + ((cy << 4) >> sy), sbmask)

    def _transform_block(self, b, p, base_x, base_y, tx, x, y, sbmask):
        f, s = self.f, self.seq
        sx, sy = self.sub[p]
        start_x, start_y = base_x + 4 * x, base_y + 4 * y
        row, col = (start_y << sy) >> 2, (start_x << sx) >> 2
        sub_r, sub_c = row & sbmask, col & sbmask
        step_x, step_y = TXW[tx] >> 2, TXH[tx] >> 2
        max_x, max_y = (f.mi_cols * 4) >> sx, (f.mi_rows * 4) >> sy
        if start_x >= max_x or start_y >= max_y:
            return
        plane = f.planes[p]
        is_cfl = p > 0 and b.uv_mode == R.UV_CFL_PRED
        mode = b.y_mode if p == 0 else (R.DC_PRED if is_cfl else b.uv_mode)
        dec = self.decoded[p]
        have_left = (b.avail_l if p == 0 else b.avail_l_chroma) or x > 0
        have_above = (b.avail_u if p == 0 else b.avail_u_chroma) or y > 0
        have_ar = bool(dec[(sub_r >> sy) - 1 + 1, (sub_c >> sx) + step_x + 1])
        have_bl = bool(dec[(sub_r >> sy) + step_y + 1, (sub_c >> sx) - 1 + 1])
        R.predict_intra(plane, start_x, start_y, have_left, have_above, have_ar, have_bl, mode,
                        TXW[tx].bit_length() - 1, TXH[tx].bit_length() - 1, max_x - 1, max_y - 1,
                        angle_delta=b.angle_y if p == 0 else b.angle_uv,
                        filter_mode=b.filter_mode if p == 0 else -1,
                        filter_type=self._filter_type(b, p), edge_filter=bool(s.enable_intra_edge_filter),
                        bit_depth=s.bit_depth)
        if is_cfl:
            R.predict_cfl(plane, f.planes[0], start_x, start_y, TXW[tx], TXH[tx], sx, sy, self.max_luma_w,
                          self.max_luma_h, b.cfl_u if p == 1 else b.cfl_v)
        if p == 0:
            self.max_luma_w = start_x + step_x * 4
            self.max_luma_h = start_y + step_y * 4
        if not b.skip:
            eob, coef, tx_type = self._coeffs(b, p, start_x, start_y, tx)
            if eob > 0:
                res = R.inverse_transform(coef, TXW[tx], TXH[tx], tx_type, b.lossless, s.bit_depth)
                hh, ww = res.shape
                blk = plane[start_y : start_y + hh, start_x : start_x + ww]
                plane[start_y : start_y + hh, start_x : start_x + ww] = np.clip(blk + res, 0,
                                                                              (1 << s.bit_depth) - 1)
        f.lf_tx[p][row >> sy : (row >> sy) + step_y, col >> sx : (col >> sx) + step_x] = tx
        dec[(sub_r >> sy) + 1 : (sub_r >> sy) + 1 + step_y, (sub_c >> sx) + 1 : (sub_c >> sx) + 1 + step_x] = True

    def _filter_type(self, b, p) -> int:
        f, s = self.f, self.seq

        def smooth(r, c):
            m = int(f.y_mode[r, c]) if p == 0 else int(f.uv_mode[r, c])
            return m in (R.SMOOTH_PRED, R.SMOOTH_V_PRED, R.SMOOTH_H_PRED)

        above = left = False
        if b.avail_u if p == 0 else b.avail_u_chroma:
            r, c = b.r - 1, b.c
            if p > 0:
                if s.ss_x and not (b.c & 1):
                    c += 1
                if s.ss_y and (b.r & 1):
                    r -= 1
            above = smooth(r, c)
        if b.avail_l if p == 0 else b.avail_l_chroma:
            r, c = b.r, b.c - 1
            if p > 0:
                if s.ss_x and (b.c & 1):
                    c -= 1
                if s.ss_y and not (b.r & 1):
                    r += 1
            left = smooth(r, c)
        return int(above or left)

    # ---- coefficients ------------------------------------------------------------------------------------
    def _tx_type(self, b, p, tx) -> int:
        """compute_tx_type (the luma type is the one `_read_tx_type` read for this block)."""
        if b.lossless or TX_SQR_UP[tx] > 3:
            return DCT_DCT
        tx_set = self._tx_set(tx)
        if p == 0:
            return self._luma_type
        t = MODE_TO_TXFM[b.uv_mode]
        return t if t in _IN_SET[tx_set] else DCT_DCT

    def _tx_set(self, tx) -> int:
        if TX_SQR_UP[tx] > 3 or TX_SQR_UP[tx] == 3:
            return 0
        if self.h.reduced_tx_set or TX_SQR[tx] == 2:
            return 2
        return 1

    def _coeffs(self, b, p, start_x, start_y, tx):
        f, sd, cdf = self.f, self.sd, self.cdf
        x4, y4 = start_x >> 2, start_y >> 2
        w4, h4 = TXW[tx] >> 2, TXH[tx] >> 2
        sx, sy = self.sub[p]
        max_x4, max_y4 = f.mi_cols >> sx, f.mi_rows >> sy
        tx_ctx = (TX_SQR[tx] + TX_SQR_UP[tx] + 1) >> 1
        ptype = int(p > 0)
        al, ad = self.above_level[p], self.above_dc[p]
        ll, ld = self.left_level[p], self.left_dc[p]
        # all_zero context
        w, hh = TXW[tx], TXH[tx]
        bsize = _plane_size(b.size, sx, sy)
        if p == 0:
            top = left = 0
            for k in range(w4):
                if x4 + k < max_x4:
                    top = max(top, al[x4 + k])
            for k in range(h4):
                if y4 + k < max_y4:
                    left = max(left, ll[y4 + k])
            top, left = min(top, 255), min(left, 255)
            if BW[bsize] == w and BH[bsize] == hh:
                ctx = 0
            elif top == 0 and left == 0:
                ctx = 1
            elif top == 0 or left == 0:
                ctx = 2 + (max(top, left) > 3)
            elif max(top, left) <= 3:
                ctx = 4
            elif min(top, left) <= 3:
                ctx = 5
            else:
                ctx = 6
        else:
            above = left = 0
            for i in range(w4):
                if x4 + i < max_x4:
                    above |= al[x4 + i] | ad[x4 + i]
            for i in range(h4):
                if y4 + i < max_y4:
                    left |= ll[y4 + i] | ld[y4 + i]
            ctx = 7 + (above != 0) + (left != 0)
            if BW[bsize] * BH[bsize] > w * hh:
                ctx += 3
        all_zero = sd.symbol(cdf["TXB_SKIP_CDF"][tx_ctx][ctx])
        eob = 0
        cul_level = dc_cat = 0
        tx_type = DCT_DCT
        coef = None
        if all_zero:
            if p == 0:
                self._luma_type = DCT_DCT
        else:
            if p == 0:
                self._luma_type = self._read_tx_type(b, tx)
            tx_type = self._tx_type(b, p, tx)
            scan = get_scan(tx, tx_type)
            cls = _tx_class(tx_type)
            eob_multi = min(w.bit_length() - 1, 5) + min(hh.bit_length() - 1, 5) - 4
            ectx = 0 if cls == TX_CLASS_2D else 1
            name = ("EOB_PT_16_CDF", "EOB_PT_32_CDF", "EOB_PT_64_CDF", "EOB_PT_128_CDF", "EOB_PT_256_CDF",
                    "EOB_PT_512_CDF", "EOB_PT_1024_CDF")[eob_multi]
            eob_pt = sd.symbol(cdf[name][ptype][ectx]) + 1
            eob = eob_pt if eob_pt < 2 else (1 << (eob_pt - 2)) + 1
            shift = eob_pt - 3
            if shift >= 0:
                if sd.symbol(cdf["EOB_EXTRA_CDF"][tx_ctx][ptype][eob_pt - 3]):
                    eob += 1 << shift
                for i in range(1, max(0, eob_pt - 2)):
                    shift = max(0, eob_pt - 2) - 1 - i
                    if sd.literal(1):
                        eob += 1 << shift
            adj = ADJUSTED_TX[tx]
            bwl = TXW[adj].bit_length() - 1
            txw, txh = TXW[adj], TXH[adj]
            quant = [0] * (txw * txh)
            base_eob_cdf = cdf["COEFF_BASE_EOB_CDF"][tx_ctx][ptype]
            base_cdf = cdf["COEFF_BASE_CDF"][tx_ctx][ptype]
            br_cdf = cdf["COEFF_BR_CDF"][min(tx_ctx, 3)][ptype]
            sig_nb, base_off, mag_nb, br_off = _coeff_contexts(tx, cls)
            area = txh << bwl
            symbol = sd.symbol
            for c in range(eob - 1, -1, -1):
                pos = scan[c]
                if c == eob - 1:
                    ctx = 0 if c == 0 else 1 if c <= area // 8 else 2 if c <= area // 4 else 3
                    level = symbol(base_eob_cdf[ctx]) + 1
                else:
                    mag = 0
                    for q in sig_nb[pos]:
                        v = quant[q]
                        mag += v if v < 3 else 3
                    off = base_off[pos]
                    level = symbol(base_cdf[0 if off < 0 else off + ((mag + 1) >> 1 if mag < 8 else 4)])
                if level > 2:
                    mag = 0
                    for q in mag_nb[pos]:
                        v = quant[q]
                        mag += v if v < 15 else 15
                    ctx = br_off[pos] + ((mag + 1) >> 1 if mag < 12 else 6)
                    for _ in range(4):
                        br = symbol(br_cdf[ctx])
                        level += br
                        if br < 3:
                            break
                quant[pos] = level
            signs = [0] * len(quant)
            for c in range(eob):
                pos = scan[c]
                if quant[pos]:
                    if c == 0:
                        dcs = 0
                        for k in range(w4):
                            if x4 + k < max_x4:
                                v = ad[x4 + k]
                                dcs += -1 if v == 1 else 1 if v == 2 else 0
                        for k in range(h4):
                            if y4 + k < max_y4:
                                v = ld[y4 + k]
                                dcs += -1 if v == 1 else 1 if v == 2 else 0
                        sctx = 1 if dcs < 0 else 2 if dcs > 0 else 0
                        sign = sd.symbol(cdf["DC_SIGN_CDF"][ptype][sctx])
                    else:
                        sign = sd.literal(1)
                else:
                    sign = 0
                if quant[pos] > 14:
                    length = 0
                    while True:
                        length += 1
                        if sd.literal(1):
                            break
                        if length == 32:
                            raise ValueError(f"{self.name}: AV1 coefficient Golomb code too long")
                    x = 1
                    for _ in range(length - 1):
                        x = (x << 1) | sd.literal(1)
                    quant[pos] = x + 14
                if pos == 0 and quant[pos] > 0:
                    dc_cat = 1 if sign else 2
                quant[pos] &= 0xFFFFF
                cul_level += quant[pos]
                signs[pos] = sign
            cul_level = min(63, cul_level)
            coef = self._dequant(b, p, tx, quant, signs, txw, txh)
        for i in range(w4):
            al[x4 + i] = cul_level
            ad[x4 + i] = dc_cat
        for i in range(h4):
            ll[y4 + i] = cul_level
            ld[y4 + i] = dc_cat
        return eob, coef, tx_type

    def _read_tx_type(self, b, tx) -> int:
        h = self.h
        tx_set = self._tx_set(tx)
        q = qindex(h, b.segment_id, 0, ignore_delta=True) if h.seg_enabled else h.base_q_idx
        if tx_set > 0 and q > 0:
            intra_dir = FILTER_INTRA_MODE_TO_DIR[b.filter_mode] if b.filter_mode >= 0 else b.y_mode
            if tx_set == 1:
                return _INV_SET1[self.sd.symbol(self.cdf["INTRA_TX_SET1_CDF"][TX_SQR[tx]][intra_dir])]
            return _INV_SET2[self.sd.symbol(self.cdf["INTRA_TX_SET2_CDF"][TX_SQR[tx]][intra_dir])]
        return DCT_DCT

    def _dequant(self, b, p, tx, quant, signs, txw, txh) -> np.ndarray:
        h, s = self.h, self.seq
        q = qindex(h, b.segment_id, self.current_q)
        if p == 0:
            dcq, acq = q + h.dq_y_dc, q
        elif p == 1:
            dcq, acq = q + h.dq_u_dc, q + h.dq_u_ac
        else:
            dcq, acq = q + h.dq_v_dc, q + h.dq_v_ac
        dc = int(T.DC_QLOOKUP[max(0, min(255, dcq))])
        ac = int(T.AC_QLOOKUP[max(0, min(255, acq))])
        area = TXW[tx] * TXH[tx]
        shift = (area > 256) + (area > 1024)
        lim = 1 << (7 + s.bit_depth)
        qa = np.array(quant, np.int64).reshape(txh, txw)
        mult = np.full((txh, txw), ac, np.int64)
        mult[0, 0] = dc
        dq = ((qa * mult) & 0xFFFFFF) >> shift
        dq = np.where(np.array(signs, bool).reshape(txh, txw), -dq, dq)
        return np.clip(dq, -lim, lim - 1)


def decode_frame(seq, hdr, tiles: dict, name: str) -> Frame:
    f = Frame(seq, hdr)
    for t in range(hdr.tile_cols * hdr.tile_rows):
        if t not in tiles:
            raise ValueError(f"{name}: AV1 tile {t} missing")
        tr, tc = divmod(t, hdr.tile_cols)
        dec = TileDecoder(f, tiles[t], hdr.mi_row_starts[tr], hdr.mi_row_starts[tr + 1], hdr.mi_col_starts[tc],
                          hdr.mi_col_starts[tc + 1], name)
        dec.decode()
    return f
