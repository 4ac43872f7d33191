"""AV1 intra prediction, inverse transforms and reconstruction (specification sections 7.11.2, 7.13): every
intra predictor (DC, the directional ones with the edge filter and upsampling, smooth / smooth-V / -H,
Paeth, chroma from luma, the recursive filter-intra one), the 4- to 64-point inverse DCT, ADST, flipped ADST
and identity transforms with the specification's rounding and range clamps (the butterfly network libaom's
reference decoder and dav1d compute, generated here by rule), and the lossless Walsh-Hadamard transform.

Planes are int32 numpy arrays; a 1-D transform runs on every row (or column) of a block at once.
"""

from __future__ import annotations

import math

import numpy as np

from uniir_tpu_torch.data import av1_tables as T

DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D113_PRED, D157_PRED, D203_PRED, D67_PRED = range(9)
SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED, PAETH_PRED, UV_CFL_PRED = 9, 10, 11, 12, 13
MODE_TO_ANGLE = (0, 90, 180, 45, 135, 113, 157, 203, 67, 0, 0, 0, 0)
_EDGE_KERNEL = ((0, 4, 8, 4, 0), (0, 5, 6, 5, 0), (2, 4, 4, 4, 2))
_DR = T.DR_INTRA_DERIVATIVE.tolist()
_SM = T.SM_WEIGHTS.astype(np.int64)
_FILTER_TAPS = T.FILTER_INTRA_TAPS.astype(np.int64)

# cos128(i) = round(4096 cos(i pi / 128)), sinpi(i) of the 4-point ADST = round(4096 * 2 sqrt(2) sin(i pi / 9) / 3)
COSPI = [round(4096 * math.cos(i * math.pi / 128)) for i in range(65)]
SINPI = [0] + [round(4096 * 2 * math.sqrt(2) * math.sin(i * math.pi / 9) / 3) for i in range(1, 5)]


def _round2(x, n):
    return (x + (1 << (n - 1))) >> n if n else x


# ---- prediction -------------------------------------------------------------------------------------------

def _edge_filter_strength(w: int, h: int, filter_type: int, delta: int) -> int:
    d, wh = abs(delta), w + h
    if filter_type == 0:
        if wh <= 8:
            return 1 if d >= 56 else 0
        if wh <= 16:
            return 1 if d >= 40 else 0
        if wh <= 24:
            return 3 if d >= 32 else 2 if d >= 16 else 1 if d >= 8 else 0
        if wh <= 32:
            return 3 if d >= 32 else 2 if d >= 4 else 1 if d >= 1 else 0
        return 3 if d >= 1 else 0
    if wh <= 8:
        return 2 if d >= 64 else 1 if d >= 40 else 0
    if wh <= 16:
        return 2 if d >= 48 else 1 if d >= 20 else 0
    if wh <= 24:
        return 3 if d >= 4 else 0
    return 3 if d >= 1 else 0


def _upsample_selection(w: int, h: int, filter_type: int, delta: int) -> int:
    d = abs(delta)
    if d <= 0 or d >= 40:
        return 0
    return int(w + h <= 8) if filter_type else int(w + h <= 16)


def _edge_filter(edge: list, off: int, size: int, strength: int):
    """Filters edge[off - 1 + i] for i = 1..size-1 (the edge starts at index -1)."""
    if not strength:
        return
    k = _EDGE_KERNEL[strength - 1]
    src = edge[off - 1 : off - 1 + size]
    for i in range(1, size):
        s = 0
        for j in range(5):
            s += k[j] * src[max(0, min(size - 1, i - 2 + j))]
        edge[off + i - 1] = (s + 8) >> 4


def _upsample(edge: list, off: int, num: int, maxv: int):
    dup = [0] * (num + 3)
    dup[0] = edge[off - 1]
    for i in range(-1, num):
        dup[i + 2] = edge[off + i]
    dup[num + 2] = edge[off + num - 1]
    edge[off - 2] = dup[0]
    for i in range(num):
        s = -dup[i] + 9 * dup[i + 1] + 9 * dup[i + 2] - dup[i + 3]
        edge[off + 2 * i - 1] = max(0, min(maxv, _round2(s, 4)))
        edge[off + 2 * i] = dup[i + 2]


def predict_intra(plane: np.ndarray, x: int, y: int, have_left: bool, have_above: bool, have_above_right: bool,
                  have_below_left: bool, mode: int, log2w: int, log2h: int, max_x: int, max_y: int,
                  angle_delta: int = 0, filter_mode: int = -1, filter_type: int = 0, edge_filter: bool = True,
                  bit_depth: int = 8):
    """The intra prediction process: writes the w x h prediction at (x, y) of `plane`."""
    w, h = 1 << log2w, 1 << log2h
    mid = 1 << (bit_depth - 1)
    maxv = (1 << bit_depth) - 1
    n = w + h
    OFF = 16
    above = [0] * (OFF + 2 * n + 16)
    left = [0] * (OFF + 2 * n + 16)
    if not have_above and have_left:
        v = int(plane[y, x - 1])
        for i in range(n):
            above[OFF + i] = v
    elif not have_above and not have_left:
        for i in range(n):
            above[OFF + i] = mid - 1
    else:
        limit = min(max_x, x + (2 * w if have_above_right else w) - 1)
        row = plane[y - 1, x : limit + 1].tolist()
        last = row[-1]
        for i in range(n):
            above[OFF + i] = row[i] if i < len(row) else last
    if not have_left and have_above:
        v = int(plane[y - 1, x])
        for i in range(n):
            left[OFF + i] = v
    elif not have_left and not have_above:
        for i in range(n):
            left[OFF + i] = mid + 1
    else:
        limit = min(max_y, y + (2 * h if have_below_left else h) - 1)
        col = plane[y : limit + 1, x - 1].tolist()
        last = col[-1]
        for i in range(n):
            left[OFF + i] = col[i] if i < len(col) else last
    if have_above and have_left:
        corner = int(plane[y - 1, x - 1])
    elif have_above:
        corner = int(plane[y - 1, x])
    elif have_left:
        corner = int(plane[y, x - 1])
    else:
        corner = mid
    above[OFF - 1] = left[OFF - 1] = corner

    if filter_mode >= 0:
        pred = _filter_intra(above, left, OFF, w, h, filter_mode, maxv)
    elif V_PRED <= mode <= D67_PRED:
        pred = _directional(above, left, OFF, w, h, mode, angle_delta, have_left, have_above, x, y, max_x, max_y,
                            filter_type, edge_filter, maxv)
    elif mode == DC_PRED:
        if have_left and have_above:
            s = sum(above[OFF : OFF + w]) + sum(left[OFF : OFF + h])
            v = (s + (n >> 1)) // n
        elif have_left:
            v = (sum(left[OFF : OFF + h]) + (h >> 1)) >> log2h
        elif have_above:
            v = (sum(above[OFF : OFF + w]) + (w >> 1)) >> log2w
        else:
            v = mid
        pred = np.full((h, w), v, np.int64)
    elif mode in (SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED):
        a = np.array(above[OFF : OFF + w], np.int64)
        lf = np.array(left[OFF : OFF + h], np.int64)
        wy = _SM[h : 2 * h][:, None]
        wx = _SM[w : 2 * w][None, :]
        if mode == SMOOTH_PRED:
            p = wy * a[None, :] + (256 - wy) * lf[h - 1] + wx * lf[:, None] + (256 - wx) * a[w - 1]
            pred = _round2(p, 9)
        elif mode == SMOOTH_V_PRED:
            pred = _round2(wy * a[None, :] + (256 - wy) * lf[h - 1], 8) + np.zeros((1, w), np.int64)
        else:
            pred = _round2(wx * lf[:, None] + (256 - wx) * a[w - 1], 8) + np.zeros((h, 1), np.int64)
    else:  # PAETH_PRED
        a = np.array(above[OFF : OFF + w], np.int64)[None, :]
        lf = np.array(left[OFF : OFF + h], np.int64)[:, None]
        base = a + lf - corner
        p_left, p_top, p_tl = np.abs(base - lf), np.abs(base - a), np.abs(base - corner)
        pred = np.where((p_left <= p_top) & (p_left <= p_tl), lf, np.where(p_top <= p_tl, a, corner))
    plane[y : y + h, x : x + w] = pred


def _filter_intra(above, left, off, w, h, mode, maxv):
    pred = np.zeros((h, w), np.int64)
    taps = _FILTER_TAPS[mode]
    for i2 in range(h >> 1):
        for j4 in range(w >> 2):
            p = [0] * 7
            for i in range(7):
                if i < 5:
                    if i2 == 0:
                        p[i] = above[off + (j4 << 2) + i - 1]
                    elif j4 == 0 and i == 0:
                        p[i] = left[off + (i2 << 1) - 1]
                    else:
                        p[i] = int(pred[(i2 << 1) - 1, (j4 << 2) + i - 1])
                elif j4 == 0:
                    p[i] = left[off + (i2 << 1) + i - 5]
                else:
                    p[i] = int(pred[(i2 << 1) + i - 5, (j4 << 2) - 1])
            v = taps @ np.array(p, np.int64)
            v = np.where(v < 0, -((-v + 8) >> 4), (v + 8) >> 4)
            pred[(i2 << 1) : (i2 << 1) + 2, (j4 << 2) : (j4 << 2) + 4] = np.clip(v, 0, maxv).reshape(2, 4)
    return pred


def _directional(above, left, off, w, h, mode, angle_delta, have_left, have_above, x, y, max_x, max_y,
                 filter_type, edge_filter, maxv):
    angle = MODE_TO_ANGLE[mode] + angle_delta * 3
    up_above = up_left = 0
    if edge_filter:
        if angle != 90 and angle != 180:
            if 90 < angle < 180 and w + h >= 24:
                v = _round2(left[off] * 5 + above[off - 1] * 6 + above[off] * 5, 4)
                above[off - 1] = left[off - 1] = v
            if have_above:
                strength = _edge_filter_strength(w, h, filter_type, angle - 90)
                num = min(w, max_x - x + 1) + (h if angle < 90 else 0) + 1
                _edge_filter(above, off, num, strength)
            if have_left:
                strength = _edge_filter_strength(w, h, filter_type, angle - 180)
                num = min(h, max_y - y + 1) + (w if angle > 180 else 0) + 1
                _edge_filter(left, off, num, strength)
        up_above = _upsample_selection(w, h, filter_type, angle - 90)
        if up_above:
            _upsample(above, off, w + (h if angle < 90 else 0), maxv)
        up_left = _upsample_selection(w, h, filter_type, angle - 180)
        if up_left:
            _upsample(left, off, h + (w if angle > 180 else 0), maxv)
    if angle == 90:
        return np.tile(np.array(above[off : off + w], np.int64), (h, 1))
    if angle == 180:
        return np.tile(np.array(left[off : off + h], np.int64)[:, None], (1, w))
    A = np.array(above, np.int64)
    L = np.array(left, np.int64)
    i = np.arange(h, dtype=np.int64)[:, None]
    j = np.arange(w, dtype=np.int64)[None, :]
    if angle < 90:
        dx = _DR[angle]
        idx = (i + 1) * dx
        base = (idx >> (6 - up_above)) + (j << up_above)
        shift = ((idx << up_above) >> 1) & 0x1F
        max_base = (w + h - 1) << up_above
        b = np.minimum(base, max_base)
        v = _round2(A[off + b] * (32 - shift) + A[off + b + 1] * shift, 5)
        return np.where(base < max_base, v, A[off + max_base])
    if angle > 180:
        dy = _DR[270 - angle]
        idx = (j + 1) * dy
        base = (idx >> (6 - up_left)) + (i << up_left)
        shift = ((idx << up_left) >> 1) & 0x1F
        max_base = (w + h - 1) << up_left
        b = np.minimum(base, max_base)
        v = _round2(L[off + b] * (32 - shift) + L[off + b + 1] * shift, 5)
        return np.where(base < max_base, v, L[off + max_base])
    dx = _DR[180 - angle]
    dy = _DR[angle - 90]
    idx = (j << 6) - (i + 1) * dx
    base = idx >> (6 - up_above)
    use_above = base >= -(1 << up_above)
    shift = ((idx << up_above) >> 1) & 0x1F
    b = np.maximum(base, -2)
    va = _round2(A[off + b] * (32 - shift) + A[off + b + 1] * shift, 5)
    idx2 = (i << 6) - (j + 1) * dy
    base2 = idx2 >> (6 - up_left)
    shift2 = ((idx2 << up_left) >> 1) & 0x1F
    b2 = np.maximum(base2, -2)
    vl = _round2(L[off + b2] * (32 - shift2) + L[off + b2 + 1] * shift2, 5)
    return np.where(use_above, va, vl)


def predict_cfl(plane: np.ndarray, luma: np.ndarray, x: int, y: int, w: int, h: int, sub_x: int, sub_y: int,
                max_luma_w: int, max_luma_h: int, alpha: int, maxv: int = 255):
    """predict_chroma_from_luma: adds alpha times the block's luma (subsampled, its mean removed) to the DC
    prediction already at (x, y)."""
    ys = np.minimum((y + np.arange(h)) << sub_y, max_luma_h - (1 << sub_y))
    xs = np.minimum((x + np.arange(w)) << sub_x, max_luma_w - (1 << sub_x))
    t = np.zeros((h, w), np.int64)
    for dy in range(sub_y + 1):
        for dx in range(sub_x + 1):
            t += luma[(ys + dy)[:, None], (xs + dx)[None, :]]
    lv = t << (3 - sub_x - sub_y)
    avg = _round2(int(lv.sum()), (w.bit_length() - 1) + (h.bit_length() - 1))
    sc = alpha * (lv - avg)
    sc = np.where(sc < 0, -((-sc + 32) >> 6), (sc + 32) >> 6)
    dc = plane[y : y + h, x : x + w].astype(np.int64)
    plane[y : y + h, x : x + w] = np.clip(dc + sc, 0, maxv)


# ---- inverse transforms -----------------------------------------------------------------------------------

def _no_clamp(x):
    return x


def _hb(w0, a, w1, b):
    """half_btf: Round2(w0 * a + w1 * b, 12)."""
    return (w0 * a + w1 * b + 2048) >> 12


def _brev(bits: int, x: int) -> int:
    return int(format(x, f"0{bits}b")[::-1], 2) if bits else 0


class _Clamp:
    """A stage's clamp to `bits` signed bits.  A conformant stream never reaches it; where one does, libaom
    (whose stages this follows) and dav1d (which clamps at its own stages) may part: `clamped` counts those
    transforms, for the tests."""

    def __init__(self, bits: int):
        self.lo, self.hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1

    def __call__(self, x):
        y = np.clip(x, self.lo, self.hi)
        if not self.hit and np.any(y != x):
            self.hit = True
        return y

    hit = False


def _idct(x: list, clamp) -> list:
    """The inverse DCT of len(x) points (a list of arrays): the even half recursively, the odd half by the
    butterfly network of libaom's av1_idct4..64 (rotations with cos128, adds clamped to the stage range)."""
    n = len(x)
    if n == 2:
        return [_hb(COSPI[32], x[0], COSPI[32], x[1]), _hb(COSPI[32], x[0], -COSPI[32], x[1])]
    even = _idct(x[0::2], clamp)
    m = n // 2
    lg = m.bit_length() - 1
    odd_in = x[1::2]
    o = [odd_in[_brev(lg, i)] for i in range(m)]
    # initial rotations: position i holds input 2 * brev(i) + 1
    for i in range(m // 2):
        k = 2 * _brev(lg, i) + 1
        c2 = (64 // n) * k
        c1 = 64 - c2
        a, b = o[i], o[m - 1 - i]
        o[i] = _hb(COSPI[c1], a, -COSPI[c2], b)
        o[m - 1 - i] = _hb(COSPI[c2], a, COSPI[c1], b)
    def adds(g):
        # blocks of 2g: even blocks (a + b, a - b), odd blocks (-a + b, a + b), a its first half, b mirrored
        for blk in range(m // (2 * g)):
            s = blk * 2 * g
            for t in range(g):
                p, q = s + t, s + 2 * g - 1 - t
                a, b = o[p], o[q]
                if blk % 2 == 0:
                    o[p], o[q] = clamp(a + b), clamp(a - b)
                else:
                    o[p], o[q] = clamp(b - a), clamp(a + b)

    if m >= 4:
        adds(1)
        g = 2
        while g < m // 2:
            # rotations on the middle g positions of each 2g-block of the first half, with their mirrors
            blocks = (m // 2) // (2 * g)
            lgb = (2 * blocks).bit_length() - 1
            for blk in range(blocks):
                c = (64 // (4 * blocks)) * (2 * _brev(lgb, blk) + 1)
                s = blk * 2 * g
                for t in range(g // 2, g // 2 + g):
                    p, q = s + t, m - 1 - (s + t)
                    a, b = o[p], o[q]
                    if t < g:
                        o[p], o[q] = _hb(-COSPI[c], a, COSPI[64 - c], b), _hb(COSPI[64 - c], a, COSPI[c], b)
                    else:
                        o[p], o[q] = _hb(-COSPI[64 - c], a, -COSPI[c], b), _hb(-COSPI[c], a, COSPI[64 - c], b)
            adds(g)
            g *= 2
        # the last rotation: positions m/4 .. m/2 - 1 with their mirrors, by cos128(32)
        for p in range(m // 4, m // 2):
            q = m - 1 - p
            a, b = o[p], o[q]
            o[p], o[q] = _hb(-COSPI[32], a, COSPI[32], b), _hb(COSPI[32], a, COSPI[32], b)
    out = [None] * n
    for i in range(m):
        out[i] = clamp(even[i] + o[m - 1 - i])
        out[n - 1 - i] = clamp(even[i] - o[m - 1 - i])
    return out


def _iadst4(x, clamp):
    s0, s1 = SINPI[1] * x[0], SINPI[2] * x[0]
    s2 = SINPI[3] * x[1]
    s3, s4 = SINPI[4] * x[2], SINPI[1] * x[2]
    s5, s6 = SINPI[2] * x[3], SINPI[4] * x[3]
    s7 = (x[0] - x[2]) + x[3]
    s0 = s0 + s3
    s1 = s1 - s4
    s3 = s2
    s2 = SINPI[3] * s7
    s0 = s0 + s5
    s1 = s1 - s6
    x0, x1, x2, x3 = s0 + s3, s1 + s3, s2, s0 + s1
    x3 = x3 - s3
    return [_round2(v, 12) for v in (x0, x1, x2, x3)]


def _iadst8(x, clamp):
    b = [x[7], x[0], x[5], x[2], x[3], x[4], x[1], x[6]]
    c = [None] * 8
    for k, a in enumerate((4, 20, 36, 52)):
        c[2 * k] = _hb(COSPI[a], b[2 * k], COSPI[64 - a], b[2 * k + 1])
        c[2 * k + 1] = _hb(COSPI[64 - a], b[2 * k], -COSPI[a], b[2 * k + 1])
    b = [clamp(c[i] + c[i + 4]) for i in range(4)] + [clamp(c[i] - c[i + 4]) for i in range(4)]
    c = b[:4] + [_hb(COSPI[16], b[4], COSPI[48], b[5]), _hb(COSPI[48], b[4], -COSPI[16], b[5]),
                 _hb(-COSPI[48], b[6], COSPI[16], b[7]), _hb(COSPI[16], b[6], COSPI[48], b[7])]
    b = [clamp(c[0] + c[2]), clamp(c[1] + c[3]), clamp(c[0] - c[2]), clamp(c[1] - c[3]),
         clamp(c[4] + c[6]), clamp(c[5] + c[7]), clamp(c[4] - c[6]), clamp(c[5] - c[7])]
    c = [b[0], b[1], _hb(COSPI[32], b[2], COSPI[32], b[3]), _hb(COSPI[32], b[2], -COSPI[32], b[3]),
         b[4], b[5], _hb(COSPI[32], b[6], COSPI[32], b[7]), _hb(COSPI[32], b[6], -COSPI[32], b[7])]
    return [c[0], -c[4], c[6], -c[2], c[3], -c[7], c[5], -c[1]]


def _iadst16(x, clamp):
    b = [x[15 - i] if i % 2 == 0 else x[i - 1] for i in range(16)]
    c = [None] * 16
    for k in range(8):
        a = 2 + 8 * k
        c[2 * k] = _hb(COSPI[a], b[2 * k], COSPI[64 - a], b[2 * k + 1])
        c[2 * k + 1] = _hb(COSPI[64 - a], b[2 * k], -COSPI[a], b[2 * k + 1])
    b = [clamp(c[i] + c[i + 8]) for i in range(8)] + [clamp(c[i] - c[i + 8]) for i in range(8)]
    c = list(b)
    c[8], c[9] = _hb(COSPI[8], b[8], COSPI[56], b[9]), _hb(COSPI[56], b[8], -COSPI[8], b[9])
    c[10], c[11] = _hb(COSPI[40], b[10], COSPI[24], b[11]), _hb(COSPI[24], b[10], -COSPI[40], b[11])
    c[12], c[13] = _hb(-COSPI[56], b[12], COSPI[8], b[13]), _hb(COSPI[8], b[12], COSPI[56], b[13])
    c[14], c[15] = _hb(-COSPI[24], b[14], COSPI[40], b[15]), _hb(COSPI[40], b[14], COSPI[24], b[15])
    b = [None] * 16
    for s in (0, 8):
        for i in range(4):
            b[s + i], b[s + i + 4] = clamp(c[s + i] + c[s + i + 4]), clamp(c[s + i] - c[s + i + 4])
    c = list(b)
    for s in (4, 12):
        c[s], c[s + 1] = _hb(COSPI[16], b[s], COSPI[48], b[s + 1]), _hb(COSPI[48], b[s], -COSPI[16], b[s + 1])
        c[s + 2], c[s + 3] = (_hb(-COSPI[48], b[s + 2], COSPI[16], b[s + 3]),
                              _hb(COSPI[16], b[s + 2], COSPI[48], b[s + 3]))
    b = [None] * 16
    for s in (0, 4, 8, 12):
        b[s], b[s + 1] = clamp(c[s] + c[s + 2]), clamp(c[s + 1] + c[s + 3])
        b[s + 2], b[s + 3] = clamp(c[s] - c[s + 2]), clamp(c[s + 1] - c[s + 3])
    c = list(b)
    for s in (2, 6, 10, 14):
        c[s], c[s + 1] = _hb(COSPI[32], b[s], COSPI[32], b[s + 1]), _hb(COSPI[32], b[s], -COSPI[32], b[s + 1])
    return [c[0], -c[8], c[12], -c[4], c[6], -c[14], c[10], -c[2], c[3], -c[11], c[15], -c[7], c[5], -c[13],
            c[9], -c[1]]


def _identity(x, clamp):
    n = len(x)
    if n == 4:
        return [_round2(v * 5793, 12) for v in x]
    if n == 8:
        return [v * 2 for v in x]
    if n == 16:
        return [_round2(v * 11586, 12) for v in x]
    return [v * 4 for v in x]


DCT, ADST, FLIPADST, IDTX = 0, 1, 2, 3
# TxType: (vertical / column 1-D type, horizontal / row 1-D type)
TX_TYPE_1D = ((DCT, DCT), (ADST, DCT), (DCT, ADST), (ADST, ADST), (FLIPADST, DCT), (DCT, FLIPADST),
              (FLIPADST, FLIPADST), (ADST, FLIPADST), (FLIPADST, ADST), (IDTX, IDTX), (DCT, IDTX), (IDTX, DCT),
              (ADST, IDTX), (IDTX, ADST), (FLIPADST, IDTX), (IDTX, FLIPADST))


def _1d(kind: int, x: list, clamp) -> list:
    if kind == DCT:
        return _idct(x, clamp)
    if kind == IDTX:
        return _identity(x, clamp)
    n = len(x)
    out = _iadst4(x, clamp) if n == 4 else _iadst8(x, clamp) if n == 8 else _iadst16(x, clamp)
    return out[::-1] if kind == FLIPADST else out


def _iwht(x: list, shift: int) -> list:
    a, c, d, b = x[0] >> shift, x[1] >> shift, x[2] >> shift, x[3] >> shift
    a = a + c
    d = d - b
    e = (a - d) >> 1
    b = e - b
    c = e - c
    a = a - b
    d = d + c
    return [a, b, c, d]


ROW_SHIFT = {(4, 4): 0, (8, 8): 1, (16, 16): 2, (32, 32): 2, (64, 64): 2, (4, 8): 0, (8, 4): 0, (8, 16): 1,
             (16, 8): 1, (16, 32): 1, (32, 16): 1, (32, 64): 1, (64, 32): 1, (4, 16): 1, (16, 4): 1, (8, 32): 2,
             (32, 8): 2, (16, 64): 2, (64, 16): 2}


def inverse_transform(coef: np.ndarray, w: int, h: int, tx_type: int, lossless: bool, bit_depth: int = 8):
    """The 2-D inverse transform of dequantised coefficients `coef` [min(h, 32), min(w, 32)] (rows, cols):
    the residual [h, w]."""
    if lossless:
        d = np.zeros((4, 4), np.int64)
        d[:, :] = coef[:4, :4]
        rows = _iwht([d[:, j] for j in range(4)], 2)
        r = np.stack(rows, axis=1)
        cols = _iwht([r[i, :] for i in range(4)], 0)
        return np.stack(cols, axis=0)
    vtype, htype = TX_TYPE_1D[tx_type]
    # every intermediate of a 1-D stage is at most the sum of its inputs' magnitudes (an identity's times 4)
    # plus its roundings: below both ranges, the clamps change nothing and are skipped
    gain_h, gain_v = (4 if htype == IDTX else 1), (4 if vtype == IDTX else 1)
    if (int(np.abs(coef).sum()) * gain_h + 16 * h) * gain_v + 32 < 1 << min(bit_depth + 7, 15):
        return _inverse(coef, w, h, vtype, htype, _no_clamp, _no_clamp)
    row_clamp = _Clamp(bit_depth + 8)
    col_clamp = _Clamp(max(bit_depth + 6, 16))
    try:
        return _inverse(coef, w, h, vtype, htype, row_clamp, col_clamp)
    finally:
        if row_clamp.hit or col_clamp.hit:
            inverse_transform.clamped += 1


inverse_transform.clamped = 0  # transforms whose stage clamps changed a value (non-conformant streams)


def _inverse(coef, w, h, vtype, htype, row_clamp, col_clamp):
    d = np.zeros((h, w), np.int64)
    th, tw = min(h, 32), min(w, 32)
    d[:th, :tw] = coef[:th, :tw]
    lw, lh = w.bit_length() - 1, h.bit_length() - 1
    if abs(lw - lh) == 1:
        d = _round2(d * 2896, 12)
    d = row_clamp(d)
    # row transforms: each 1-D "point" is a column vector over all rows
    res = _1d(htype, [d[:, j] for j in range(w)], row_clamp)
    r = _round2(np.stack(res, axis=1), ROW_SHIFT[(w, h)])
    r = col_clamp(r)
    res = _1d(vtype, [r[i, :] for i in range(h)], col_clamp)
    return _round2(np.stack(res, axis=0), 4)
