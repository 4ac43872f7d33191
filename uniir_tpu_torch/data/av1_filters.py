"""AV1 in-loop filters of an intra frame, in the specification's order over the frame (section 7.14-7.17):
the deblocking filter (every vertical edge of a plane, then every horizontal one, with the 4-, 6-, 8- and
14-tap filters and their masks), CDEF (8 x 8 blocks, direction search, primary and secondary taps), and
loop restoration (the Wiener filter, the self-guided filter, switchable units, their coefficients read per
superblock).  Each filter runs over whole rows or columns of edges at once with numpy.
"""

from __future__ import annotations

import numpy as np

from uniir_tpu_torch.data import av1_tables as T
from uniir_tpu_torch.data.av1_obu import RESTORE_NONE, RESTORE_SGRPROJ, RESTORE_WIENER

_TXW = (4, 8, 16, 32, 64, 4, 8, 8, 16, 16, 32, 32, 64, 4, 16, 8, 32, 16, 64)
_TXH = (4, 8, 16, 32, 64, 8, 4, 16, 8, 32, 16, 64, 32, 16, 4, 32, 8, 64, 16)


def _levels(f, plane: int, direction: int) -> np.ndarray:
    """The deblocking level of every 4 x 4 unit (mi grid) for `plane` and edge `direction` (0: vertical
    edges), by the adaptive filter strength selection (segment feature, intra reference delta)."""
    h = f.hdr
    i = direction if plane == 0 else plane + 1
    if h.delta_lf_present:
        d = f.delta_lf[:, :, i if h.delta_lf_multi else 0].astype(np.int64)
        base = np.clip(d + h.lf_level[i], 0, 63)
    else:
        base = np.full(f.mi_size.shape, h.lf_level[i], np.int64)
    lvl = base
    if h.seg_enabled:
        seg = f.seg_id.astype(np.int64)
        for s in range(8):
            data = h.seg_feature[s][1 + i]
            if data is not None:
                lvl = np.where(seg == s, np.clip(lvl + data, 0, 63), lvl)
    if h.lf_delta_enabled:
        shift = lvl >> 5
        lvl = np.clip(lvl + (h.lf_ref_deltas[0] << shift), 0, 63)
    return lvl


def _filter_edges(P: list, Q: list, fs: np.ndarray, lvl: np.ndarray, h, plane: int, bd: int = 8):
    """Filters one line of samples across each edge: P[k] / Q[k] the k-th sample before / after the edge
    (int64 arrays), fs the filter size, lvl the level; returns the new P, Q (lists of arrays)."""
    sharp = h.lf_sharpness
    shift = 2 if sharp > 4 else 1 if sharp > 0 else 0
    limit = np.clip(lvl >> shift, 1, 9 - sharp) if sharp > 0 else np.maximum(1, lvl >> shift)
    blimit = 2 * (lvl + 2) + limit
    thresh = lvl >> 4
    p0, p1, p2, p3 = P[0], P[1], P[2], P[3]
    q0, q1, q2, q3 = Q[0], Q[1], Q[2], Q[3]
    ad = np.abs
    hev = (ad(p1 - p0) > thresh) | (ad(q1 - q0) > thresh)
    base = (ad(p0 - q0) * 2 + ad(p1 - q1) // 2 <= blimit) & (ad(p1 - p0) <= limit) & (ad(q1 - q0) <= limit)
    m6 = base & (ad(p2 - p1) <= limit) & (ad(q2 - q1) <= limit)
    m8 = m6 & (ad(p3 - p2) <= limit) & (ad(q3 - q2) <= limit)
    if plane == 0:
        mask = np.where(fs == 4, base, m8)
    else:
        mask = np.where(fs == 4, base, m6)
    t = 1 << (bd - 8)
    flat6 = (ad(p1 - p0) <= t) & (ad(q1 - q0) <= t) & (ad(p2 - p0) <= t) & (ad(q2 - q0) <= t)
    flat = flat6 & (ad(p3 - p0) <= t) & (ad(q3 - q0) <= t) if plane == 0 else flat6
    flat2 = np.zeros_like(flat)
    if plane == 0:
        flat2 = ((ad(P[6] - p0) <= t) & (ad(Q[6] - q0) <= t) & (ad(P[5] - p0) <= t) & (ad(Q[5] - q0) <= t)
                 & (ad(P[4] - p0) <= t) & (ad(Q[4] - q0) <= t))
    mask &= lvl > 0
    narrow = mask & ((fs == 4) | ~flat)
    wide = mask & ~narrow & ((fs == 8) | ~flat2) if plane == 0 else mask & ~narrow
    wide16 = mask & ~narrow & ~wide
    outP, outQ = [x.copy() for x in P], [x.copy() for x in Q]
    # narrow filter
    lo, hi = -(1 << (bd - 1)), (1 << (bd - 1)) - 1
    c = lambda x: np.clip(x, lo, hi)  # noqa: E731
    off = 0x80 << (bd - 8)
    ps1, ps0, qs0, qs1 = p1 - off, p0 - off, q0 - off, q1 - off
    flt = np.where(hev, c(ps1 - qs1), 0)
    flt = c(flt + 3 * (qs0 - ps0))
    f1 = c(flt + 4) >> 3
    f2 = c(flt + 3) >> 3
    oq0 = c(qs0 - f1) + off
    op0 = c(ps0 + f2) + off
    fr = (f1 + 1) >> 1
    oq1 = np.where(hev, q1, c(qs1 - fr) + off)
    op1 = np.where(hev, p1, c(ps1 + fr) + off)
    for arr, new, k in ((outP, op0, 0), (outQ, oq0, 0), (outP, op1, 1), (outQ, oq1, 1)):
        arr[k] = np.where(narrow, new, arr[k])

    def wide_filter(sel, log2, n):
        if not sel.any():
            return
        n2 = 0 if (log2 == 3 and plane == 0) else 1
        F = {k: (Q[k] if k >= 0 else P[-k - 1]) for k in range(-(n + 1), n + 1)}
        for i in range(-n, n):
            t_ = 0
            for j in range(-n, n + 1):
                p = max(-(n + 1), min(n, i + j))
                t_ = t_ + F[p] * (2 if abs(j) <= n2 else 1)
            v = (t_ + (1 << (log2 - 1))) >> log2
            if i >= 0:
                outQ[i] = np.where(sel, v, outQ[i])
            else:
                outP[-i - 1] = np.where(sel, v, outP[-i - 1])

    wide_filter(wide, 3, 3 if plane == 0 else 2)
    if plane == 0:
        wide_filter(wide16, 4, 6)
    return outP, outQ


def deblock(f):
    """The loop filter process over the frame's planes, in place."""
    h, s = f.hdr, f.seq
    for plane in range(s.num_planes):
        if plane == 0 and not (h.lf_level[0] or h.lf_level[1]):
            continue
        if plane > 0 and not h.lf_level[plane + 1]:
            continue
        sx = s.ss_x if plane else 0
        sy = s.ss_y if plane else 0
        img = f.planes[plane]
        # the plane's 4 x 4 units on screen (x = col * 4 < FrameWidth with col = c4 << sx), and the mi each
        # takes its records from (an intra frame filters every transform edge: its block edges are some)
        n_r4 = len([r for r in range(0, f.mi_rows, 1 << sy) if r * 4 < h.height])
        n_c4 = len([c for c in range(0, f.mi_cols, 1 << sx) if c * 4 < h.width])
        mi_r = (np.arange(n_r4) << sy) | sy
        mi_c = (np.arange(n_c4) << sx) | sx
        lftx = f.lf_tx[plane][:n_r4, :n_c4].astype(np.int64)
        txw = np.array(_TXW)[lftx]
        txh = np.array(_TXH)[lftx]
        for direction in (0, 1):
            lv = _levels(f, plane, direction)[np.ix_(mi_r, mi_c)]
            cap = 16 if plane == 0 else 8
            if direction == 0:
                for c4 in range(1, n_c4):
                    xp = 4 * c4
                    is_tx = xp % txw[:, c4] == 0
                    fs = np.minimum(np.minimum(txw[:, c4 - 1], txw[:, c4]), cap)
                    lvl = np.where(lv[:, c4] == 0, lv[:, c4 - 1], lv[:, c4])
                    lvl = np.where(is_tx, lvl, 0)
                    if not lvl.any():
                        continue
                    ys = np.arange(4 * n_r4)
                    sel = np.repeat(np.arange(n_r4), 4)
                    P = [img[ys, xp - 1 - k].astype(np.int64) if xp - 1 - k >= 0 else np.zeros(len(ys), np.int64)
                         for k in range(7)]
                    Q = [img[ys, xp + k].astype(np.int64) for k in range(7)]
                    P2, Q2 = _filter_edges(P, Q, fs[sel], lvl[sel], h, plane, s.bit_depth)
                    for k in range(7):
                        if xp - 1 - k >= 0:
                            img[ys, xp - 1 - k] = P2[k]
                        img[ys, xp + k] = Q2[k]
            else:
                for r4 in range(1, n_r4):
                    yp = 4 * r4
                    is_tx = yp % txh[r4, :] == 0
                    fs = np.minimum(np.minimum(txh[r4 - 1, :], txh[r4, :]), cap)
                    lvl = np.where(lv[r4, :] == 0, lv[r4 - 1, :], lv[r4, :])
                    lvl = np.where(is_tx, lvl, 0)
                    if not lvl.any():
                        continue
                    xs = np.arange(4 * n_c4)
                    sel = np.repeat(np.arange(n_c4), 4)
                    P = [img[yp - 1 - k, xs].astype(np.int64) if yp - 1 - k >= 0 else np.zeros(len(xs), np.int64)
                         for k in range(7)]
                    Q = [img[yp + k, xs].astype(np.int64) for k in range(7)]
                    P2, Q2 = _filter_edges(P, Q, fs[sel], lvl[sel], h, plane, s.bit_depth)
                    for k in range(7):
                        if yp - 1 - k >= 0:
                            img[yp - 1 - k, xs] = P2[k]
                        img[yp + k, xs] = Q2[k]


# ---- CDEF -----------------------------------------------------------------------------------------------

_CDEF_DIRS = (((-1, 1), (-2, 2)), ((0, 1), (-1, 2)), ((0, 1), (0, 2)), ((0, 1), (1, 2)), ((1, 1), (2, 2)),
              ((1, 0), (2, 1)), ((1, 0), (2, 0)), ((1, 0), (2, -1)))
_CDEF_UV_DIR = {(0, 0): range(8), (0, 1): (1, 2, 2, 2, 3, 4, 6, 0), (1, 0): (7, 0, 2, 4, 5, 6, 6, 6),
                (1, 1): range(8)}
_DIV_TABLE = (0, 840, 420, 280, 210, 168, 140, 120, 105)


def _cdef_direction(blocks: np.ndarray):
    """The CDEF direction process of 8 x 8 luma blocks [n, 8, 8]: (direction, variance) per block."""
    x = blocks.astype(np.int64) - 128
    n = x.shape[0]
    partial = np.zeros((8, n, 15), np.int64)
    i, j = np.meshgrid(np.arange(8), np.arange(8), indexing="ij")
    idx = (i + j, i + j // 2, i, 3 + i - j // 2, 7 + i - j, 3 - i // 2 + j, j, i // 2 + j)
    for d in range(8):
        np.add.at(partial[d], (slice(None), idx[d].ravel()), x.reshape(n, 64))
    cost = np.zeros((8, n), np.int64)
    cost[2] = (partial[2][:, :8] ** 2).sum(1) * _DIV_TABLE[8]
    cost[6] = (partial[6][:, :8] ** 2).sum(1) * _DIV_TABLE[8]
    for d in (0, 4):
        for k in range(7):
            cost[d] += (partial[d][:, k] ** 2 + partial[d][:, 14 - k] ** 2) * _DIV_TABLE[k + 1]
        cost[d] += partial[d][:, 7] ** 2 * _DIV_TABLE[8]
    for d in (1, 3, 5, 7):
        cost[d] = (partial[d][:, 3:8] ** 2).sum(1) * _DIV_TABLE[8]
        for k in range(3):
            cost[d] += (partial[d][:, k] ** 2 + partial[d][:, 10 - k] ** 2) * _DIV_TABLE[2 * k + 2]
    best = np.zeros(n, np.int64)
    best_cost = np.zeros(n, np.int64)
    for d in range(8):
        better = cost[d] > best_cost
        best = np.where(better, d, best)
        best_cost = np.where(better, cost[d], best_cost)
    var = (best_cost - cost[(best + 4) & 7, np.arange(n)]) >> 10
    return best, var


def _constrain(diff, threshold, damping):
    """constrain() for per-sample thresholds (arrays) and one damping."""
    t = np.maximum(threshold, 1)
    adj = np.maximum(0, damping - (np.log2(t).astype(np.int64)))
    val = np.minimum(np.abs(diff), np.maximum(0, threshold - (np.abs(diff) >> adj)))
    return np.where(threshold == 0, 0, np.where(diff < 0, -val, val))


def cdef(f):
    """The CDEF process over the frame (every 8 x 8 block of a 64 x 64 whose cdef_idx is not -1 and that is
    not skipped), reading the deblocked frame and writing the filtered one."""
    h, s = f.hdr, f.seq
    if not h.enable_cdef:
        return
    f.deblocked = [p.copy() for p in f.planes]
    r8, c8 = f.mi_rows // 2, f.mi_cols // 2
    skip = f.skip
    sk = (skip[0 : 2 * r8 : 2, 0 : 2 * c8 : 2] & skip[1 : 2 * r8 : 2, 0 : 2 * c8 : 2] &
          skip[0 : 2 * r8 : 2, 1 : 2 * c8 : 2] & skip[1 : 2 * r8 : 2, 1 : 2 * c8 : 2]).astype(bool)
    idx = f.cdef_idx[(np.arange(r8) * 2) & ~15][:, (np.arange(c8) * 2) & ~15].astype(np.int64)
    active = (idx >= 0) & ~sk
    if not active.any():
        return
    luma = f.planes[0][: 8 * r8, : 8 * c8]
    blocks = luma.reshape(r8, 8, c8, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)
    ydir, var = _cdef_direction(blocks)
    ydir, var = ydir.reshape(r8, c8), var.reshape(r8, c8)
    sel = np.maximum(idx, 0)
    for plane in range(s.num_planes):
        sx = s.ss_x if plane else 0
        sy = s.ss_y if plane else 0
        if plane == 0:
            pri = np.array(h.cdef_y_pri)[sel]
            sec = np.array(h.cdef_y_sec)[sel]
            damping = h.cdef_damping
            dirs = np.where(pri == 0, 0, ydir)
            vs = np.where((var >> 6) > 0, np.minimum(np.log2(np.maximum(var >> 6, 1)).astype(np.int64), 12), 0)
            pri = np.where(var > 0, (pri * (4 + vs) + 8) >> 4, 0)
        else:
            pri = np.array(h.cdef_uv_pri)[sel]
            sec = np.array(h.cdef_uv_sec)[sel]
            damping = h.cdef_damping - 1
            dirs = np.where(pri == 0, 0, np.array(list(_CDEF_UV_DIR[(sx, sy)]))[ydir])
        bh, bw = 8 >> sy, 8 >> sx
        hh, ww = r8 * bh, c8 * bw
        src = f.planes[plane][:hh, :ww].astype(np.int64)
        pad = 3
        big = np.zeros((hh + 2 * pad, ww + 2 * pad), np.int64)
        big[pad : pad + hh, pad : pad + ww] = src
        avail = np.zeros(big.shape, bool)
        avail[pad : pad + hh, pad : pad + ww] = True
        P = np.repeat(np.repeat(pri, bh, 0), bw, 1)
        S = np.repeat(np.repeat(sec, bh, 0), bw, 1)
        D = np.repeat(np.repeat(dirs, bh, 0), bw, 1)
        A = np.repeat(np.repeat(active, bh, 0), bw, 1)
        yy, xx = np.meshgrid(np.arange(hh) + pad, np.arange(ww) + pad, indexing="ij")
        total = np.zeros((hh, ww), np.int64)
        hi, lo = src.copy(), src.copy()
        dir_tab = np.array(_CDEF_DIRS)  # [8, 2, 2]
        pri_taps = np.array(((4, 2), (3, 3)))
        sec_taps = np.array(((2, 1), (2, 1)))
        odd = P & 1
        for k in range(2):
            for sign in (-1, 1):
                for off, taps, strength in ((0, pri_taps, P), (-2, sec_taps, S), (2, sec_taps, S)):
                    d = (D + off) & 7
                    ny = yy + sign * dir_tab[d, k, 0]
                    nx = xx + sign * dir_tab[d, k, 1]
                    v = big[ny, nx]
                    ok = avail[ny, nx]
                    tap = taps[odd, k]
                    total += np.where(ok, tap * _constrain(v - src, strength, damping), 0)
                    hi = np.where(ok, np.maximum(hi, v), hi)
                    lo = np.where(ok, np.minimum(lo, v), lo)
        out = np.clip(src + ((8 + total - (total < 0)) >> 4), lo, hi)
        f.planes[plane][:hh, :ww] = np.where(A, out, src)


# ---- loop restoration ------------------------------------------------------------------------------------

WIENER_MIN, WIENER_MAX, WIENER_K, WIENER_MID = (-5, -23, -17), (10, 8, 46), (1, 2, 3), (3, -7, 15)
SGR_XQD_MIN, SGR_XQD_MAX, SGR_XQD_MID = (-96, -32), (31, 95), (-32, 31)
_SGR = T.SGR_PARAMS.tolist()


def _units(size: int, length: int) -> int:
    return max((length + (size >> 1)) // size, 1)


def _plane_dims(f, plane):
    sx = f.seq.ss_x if plane else 0
    sy = f.seq.ss_y if plane else 0
    return sx, sy, (f.hdr.upscaled_width + sx) >> sx, (f.hdr.height + sy) >> sy


def reset_lr_refs(tile):
    tile.ref_wiener = [[list(WIENER_MID), list(WIENER_MID)] for _ in range(3)]
    tile.ref_sgr = [list(SGR_XQD_MID) for _ in range(3)]


def read_lr(tile, r, c, bsize):
    """read_lr: the restoration type and coefficients of each unit whose top-left lies in this superblock."""
    f, h = tile.f, tile.h
    w4, h4 = (128 if f.seq.sb128 else 64) >> 2, (128 if f.seq.sb128 else 64) >> 2
    for plane in range(f.seq.num_planes):
        if h.lr_type[plane] == RESTORE_NONE:
            continue
        sx, sy, pw, ph = _plane_dims(f, plane)
        size = h.lr_unit_size[plane]
        rows, cols = _units(size, ph), _units(size, pw)
        row0 = (r * (4 >> sy) + size - 1) // size
        row1 = min(rows, ((r + h4) * (4 >> sy) + size - 1) // size)
        col0 = (c * (4 >> sx) + size - 1) // size
        col1 = min(cols, ((c + w4) * (4 >> sx) + size - 1) // size)
        for ur in range(row0, row1):
            for uc in range(col0, col1):
                _read_unit(tile, plane, ur, uc)


def _subexp(sd, num: int, k: int) -> int:
    i = mk = 0
    while True:
        b2 = k + i - 1 if i else k
        a = 1 << b2
        if num <= mk + 3 * a:
            n = num - mk
            w = n.bit_length()
            m = (1 << w) - n
            v = sd.literal(w - 1)
            if v >= m:
                v = (v << 1) - m + sd.literal(1)
            return v + mk
        if sd.literal(1):
            i += 1
            mk += a
        else:
            return sd.literal(b2) + mk


def _recenter(r: int, v: int) -> int:
    if v > 2 * r:
        return v
    return r - ((v + 1) >> 1) if v & 1 else r + (v >> 1)


def _signed_subexp(sd, low: int, high: int, k: int, ref: int) -> int:
    mx, r = high - low, ref - low
    v = _subexp(sd, mx, k)
    x = _recenter(r, v) if (r << 1) <= mx else mx - 1 - _recenter(mx - 1 - r, v)
    return x + low


def _read_unit(tile, plane, ur, uc):
    sd, cdf, kind = tile.sd, tile.cdf, tile.h.lr_type[plane]
    if kind == RESTORE_WIENER:
        t = RESTORE_WIENER if sd.symbol(cdf["USE_WIENER_CDF"]) else RESTORE_NONE
    elif kind == RESTORE_SGRPROJ:
        t = RESTORE_SGRPROJ if sd.symbol(cdf["USE_SGRPROJ_CDF"]) else RESTORE_NONE
    else:
        t = (RESTORE_NONE, RESTORE_WIENER, RESTORE_SGRPROJ)[sd.symbol(cdf["RESTORATION_TYPE_CDF"])]
    unit = [t]
    if t == RESTORE_WIENER:
        coeffs = []
        for p in range(2):
            first = 1 if plane else 0
            cf = [0, 0, 0]
            for j in range(first, 3):
                v = _signed_subexp(sd, WIENER_MIN[j], WIENER_MAX[j] + 1, WIENER_K[j], tile.ref_wiener[plane][p][j])
                cf[j] = v
                tile.ref_wiener[plane][p][j] = v
            coeffs.append(cf)
        unit.append(coeffs)
    elif t == RESTORE_SGRPROJ:
        sgr_set = sd.literal(4)
        xqd = [0, 0]
        for i in range(2):
            if _SGR[sgr_set][i * 2]:
                v = _signed_subexp(sd, SGR_XQD_MIN[i], SGR_XQD_MAX[i] + 1, 4, tile.ref_sgr[plane][i])
            else:
                v = 0
                if i == 1:
                    v = max(SGR_XQD_MIN[1], min(SGR_XQD_MAX[1], (1 << 7) - tile.ref_sgr[plane][0]))
            xqd[i] = v
            tile.ref_sgr[plane][i] = v
        unit += [sgr_set, xqd]
    tile.f.lr[(plane, ur, uc)] = unit


def loop_restore(f):
    """The loop restoration process over each plane whose frame type is not RESTORE_NONE (the source is the
    deblocked frame: CDEF is off or refused, superres refused)."""
    h = f.hdr
    for plane in range(f.seq.num_planes):
        if h.lr_type[plane] == RESTORE_NONE:
            continue
        _, sy, pw, ph = _plane_dims(f, plane)
        src = f.planes[plane][:ph, :pw].astype(np.int64)
        pre = (f.deblocked or f.planes)[plane][:ph, :pw].astype(np.int64)
        out = f.planes[plane]
        size = h.lr_unit_size[plane]
        rows, cols = _units(size, ph), _units(size, pw)
        stripe = 0
        while True:
            luma0 = max(0, 64 * stripe - 8)
            if luma0 >= h.height:
                break
            start = (64 * stripe - 8) >> sy
            end = start + (64 >> sy) - 1
            y0 = max(0, start)
            y1 = min(ph - 1, end)
            ur = min(rows - 1, ((64 * stripe) >> sy) // size) if stripe else 0
            for uc in range(cols):
                x0 = uc * size
                x1 = pw - 1 if uc == cols - 1 else (uc + 1) * size - 1
                if x0 > pw - 1:
                    continue
                unit = f.lr.get((plane, ur, uc), [RESTORE_NONE])
                if unit[0] == RESTORE_NONE:
                    continue
                # source rows / cols with the stripe's clamps (get_source_sample)
                pad = 4
                ys = np.arange(y0 - pad, y1 + pad + 1)
                ys = np.clip(ys, 0, ph - 1)
                outside = (ys < start) | (ys > end)
                ys = np.where(ys < start, np.maximum(start - 2, ys), np.where(ys > end, np.minimum(end + 2, ys), ys))
                xs = np.clip(np.arange(x0 - pad, x1 + pad + 1), 0, pw - 1)
                block = np.where(outside[:, None], pre[np.ix_(ys, xs)], src[np.ix_(ys, xs)])
                hh, ww = y1 - y0 + 1, x1 - x0 + 1
                if unit[0] == RESTORE_WIENER:
                    res = _wiener(block, pad, hh, ww, unit[1])
                else:
                    res = _sgr(block, pad, hh, ww, unit[1], unit[2], src[y0 : y1 + 1, x0 : x1 + 1])
                out[y0 : y1 + 1, x0 : x1 + 1] = res
            stripe += 1


def _taps(c):
    return [c[0], c[1], c[2], 128 - 2 * (c[0] + c[1] + c[2]), c[2], c[1], c[0]]


def _wiener(block, pad, hh, ww, coeffs, bd=8):
    r0, r1 = 3, 11
    vf, hf = _taps(coeffs[0]), _taps(coeffs[1])
    offset = 1 << (bd + 7 - r0 - 1)
    limit = (1 << (bd + 1 + 7 - r0)) - 1
    rows = block[pad - 3 : pad + hh + 3]
    s = sum(hf[t] * rows[:, pad + t - 3 : pad + t - 3 + ww] for t in range(7))
    inter = np.clip((s + (1 << (r0 - 1))) >> r0, -offset, limit - offset)
    s = sum(vf[t] * inter[t : t + hh] for t in range(7))
    return np.clip((s + (1 << (r1 - 1))) >> r1, 0, (1 << bd) - 1)


def _box(block, pad, hh, ww, r, s, bd=8):
    """The box filter of one self-guided pass (radius r, scale s): A, B over rows / cols -1 .. h / w."""
    n = (2 * r + 1) ** 2
    a = np.zeros((hh + 2, ww + 2), np.int64)
    b = np.zeros((hh + 2, ww + 2), np.int64)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            c = block[pad - 1 + dy : pad + hh + 1 + dy, pad - 1 + dx : pad + ww + 1 + dx]
            a += c * c
            b += c
    p = np.maximum(0, a * n - b * b)
    z = (p * s + (1 << 19)) >> 20
    a2 = np.where(z >= 255, 256, np.where(z == 0, 1, ((z << 8) + z // 2) // (z + 1)))
    one_over_n = ((1 << 12) + n // 2) // n
    b2 = ((1 << 8) - a2) * b * one_over_n
    return a2, (b2 + (1 << 11)) >> 12


def _sgr(block, pad, hh, ww, sgr_set, xqd, cdef, bd=8):
    r0, e0, r1, e1 = _SGR[sgr_set]
    u = cdef.astype(np.int64) << 4
    w0, w1 = xqd
    w2 = (1 << 7) - w0 - w1
    v = w1 * u
    for pass_, (r, e, w) in enumerate(((r0, e0, w0), (r1, e1, w2))):
        if not r:
            v = v + w * u
            continue
        A, B = _box(block, pad, hh, ww, r, e, bd)
        if pass_ == 0:
            a = 6 * (A[:-2, 1:-1] + A[2:, 1:-1]) + 5 * (A[:-2, :-2] + A[:-2, 2:] + A[2:, :-2] + A[2:, 2:])
            b = 6 * (B[:-2, 1:-1] + B[2:, 1:-1]) + 5 * (B[:-2, :-2] + B[:-2, 2:] + B[2:, :-2] + B[2:, 2:])
            a_odd = 6 * A[1:-1, 1:-1] + 5 * (A[1:-1, :-2] + A[1:-1, 2:])
            b_odd = 6 * B[1:-1, 1:-1] + 5 * (B[1:-1, :-2] + B[1:-1, 2:])
            odd = (np.arange(hh) & 1)[:, None].astype(bool)
            a = np.where(odd, a_odd, a)
            b = np.where(odd, b_odd, b)
            shift = np.where(odd, 4, 5)
        else:
            a = 4 * (A[:-2, 1:-1] + A[2:, 1:-1] + A[1:-1, :-2] + A[1:-1, 2:] + A[1:-1, 1:-1]) + \
                3 * (A[:-2, :-2] + A[:-2, 2:] + A[2:, :-2] + A[2:, 2:])
            b = 4 * (B[:-2, 1:-1] + B[2:, 1:-1] + B[1:-1, :-2] + B[1:-1, 2:] + B[1:-1, 1:-1]) + \
                3 * (B[:-2, :-2] + B[:-2, 2:] + B[2:, :-2] + B[2:, 2:])
            shift = 5
        flt = a * cdef.astype(np.int64) + b
        sh = 8 + shift - 4
        flt = (flt + (1 << (sh - 1))) >> sh
        v = v + w * flt
    return np.clip((v + (1 << 10)) >> 11, 0, (1 << bd) - 1)
