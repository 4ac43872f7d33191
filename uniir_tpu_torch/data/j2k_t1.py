"""JPEG 2000 tier 1 (EBCOT) decoding of one code-block, as OpenJPEG 2.5 decodes it.

One code-block's coding passes, from the most significant coded bit-plane down: a cleanup pass, then
significance propagation, magnitude refinement and cleanup for each lower plane, over stripes of four
rows.  The MQ arithmetic decoder (the 47-state Qe table, 19 contexts: nine zero-coding, five sign, three
refinement, run-length and uniform) reads each segment's bytes followed by a synthetic FF FF, so a
segment whose bytes run out feeds ones, as OpenJPEG's `opj_mqc_init_dec` arranges.  Every code-block
style bit is followed: BYPASS (raw significance and refinement passes from the fifth plane down), RESET
(contexts reset after each pass), TERMALL (a segment per pass), VSC (no context from the stripe below),
PTERM (nothing to do for a decoder) and SEGSYM (four uniform decisions after each cleanup).

Coefficients are kept as OpenJPEG keeps them, sign and magnitude on one more fractional bit than the
coded planes: a coefficient that turns significant at plane p takes 1.5 x 2^p and each refinement adds or
takes away half the plane below, so one whose lower planes are missing sits at the middle of its
interval.  The region-of-interest shift (RGN) is undone as OpenJPEG undoes it.  `decode_block` returns
those values, row-major; the caller halves them (reversible) or scales them by the step size.
"""

from __future__ import annotations

BYPASS, RESET, TERMALL, VSC, SEGSYM = 1, 2, 4, 8, 32  # code-block style bits; PTERM (16) changes nothing here

# the MQ coder's states: (Qe, next on MPS, next on LPS, switch)
QE = (0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401, 0x4801, 0x3801, 0x3001, 0x2401,
      0x1C01, 0x1601, 0x5601, 0x5401, 0x5101, 0x4801, 0x3801, 0x3401, 0x3001, 0x2801, 0x2401, 0x2201,
      0x1C01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101, 0x0AC1, 0x09C1, 0x08A1, 0x0521, 0x0441, 0x02A1,
      0x0221, 0x0141, 0x0111, 0x0085, 0x0049, 0x0025, 0x0015, 0x0009, 0x0005, 0x0001, 0x5601)
NMPS = (1, 2, 3, 4, 5, 38, 7, 8, 9, 10, 11, 12, 13, 29, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27,
        28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46)
NLPS = (1, 6, 9, 12, 29, 33, 6, 14, 14, 14, 17, 18, 20, 21, 14, 14, 15, 16, 17, 18, 19, 19, 20, 21, 22, 23,
        24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46)
SWITCH = (1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1) + (0,) * 32
CTX_RL, CTX_UNI = 17, 18


def _zc_table(orient: int) -> list:
    """Zero-coding context by neighbour count code h * 15 + v * 5 + d, for band `orient` (0 LL, 1 HL,
    2 LH, 3 HH in OpenJPEG's numbering)."""
    out = [0] * 45
    for h in range(3):
        for v in range(3):
            for d in range(5):
                hh, vv = (v, h) if orient == 1 else (h, v)
                if orient == 3:
                    hv = hh + vv
                    n = ((0 if hv == 0 else 1 if hv == 1 else 2) if d == 0 else
                         (3 if hv == 0 else 4 if hv == 1 else 5) if d == 1 else
                         (6 if hv == 0 else 7) if d == 2 else 8)
                elif hh == 0:
                    n = (0 if d == 0 else 1 if d == 1 else 2) if vv == 0 else 3 if vv == 1 else 4
                elif hh == 1:
                    n = (5 if d == 0 else 6) if vv == 0 else 7
                else:
                    n = 8
                out[h * 15 + v * 5 + d] = n
    return out


ZC = [_zc_table(o) for o in range(4)]
# sign context and XOR bit by the clamped horizontal and vertical contributions, indexed (h + 2) * 5 + v + 2
# on the unclamped sums
SC = []
for _h in range(-2, 3):
    for _v in range(-2, 3):
        h1, v1 = max(-1, min(1, _h)), max(-1, min(1, _v))
        if h1 < 0:
            h1, v1, xor = -h1, -v1, 1
        elif h1 == 0 and v1 < 0:
            v1, xor = -v1, 1
        else:
            xor = 0
        SC.append((12 + v1 if h1 else 9 + v1, xor))
del _h, _v


class MQ:
    """OpenJPEG's MQ decoder (opj_mqc_*) over a segment's bytes and a synthetic FF FF."""

    __slots__ = ("state", "mps", "buf", "bp", "a", "c", "ct")

    def __init__(self):
        self.state = [0] * 19
        self.mps = [0] * 19
        self.reset()

    def reset(self) -> None:
        for i in range(19):
            self.state[i] = 0
            self.mps[i] = 0
        self.state[CTX_UNI], self.state[CTX_RL], self.state[0] = 46, 3, 4

    def init(self, seg: bytes) -> None:
        self.buf = seg + b"\xff\xff"
        self.bp = 0
        self.c = self.buf[0] << 16
        self._bytein()
        self.c = (self.c << 7) & 0xFFFFFFFF
        self.ct -= 7
        self.a = 0x8000

    def _bytein(self) -> None:
        buf, bp = self.buf, self.bp
        if buf[bp] == 0xFF:
            if buf[bp + 1] > 0x8F:
                self.c += 0xFF00
                self.ct = 8
            else:
                self.bp = bp + 1
                self.c += buf[bp + 1] << 9
                self.ct = 7
        else:
            self.bp = bp + 1
            self.c += buf[bp + 1] << 8
            self.ct = 8

    def decode(self, cx: int) -> int:
        st = self.state[cx]
        qe = QE[st]
        a = self.a - qe
        c = self.c
        if (c >> 16) < qe:
            if a < qe:
                d = self.mps[cx]
                self.state[cx] = NMPS[st]
            else:
                d = 1 - self.mps[cx]
                if SWITCH[st]:
                    self.mps[cx] = d
                self.state[cx] = NLPS[st]
            a = qe
        else:
            c -= qe << 16
            if a & 0x8000:
                self.a, self.c = a, c
                return self.mps[cx]
            if a < qe:
                d = 1 - self.mps[cx]
                if SWITCH[st]:
                    self.mps[cx] = d
                self.state[cx] = NLPS[st]
            else:
                d = self.mps[cx]
                self.state[cx] = NMPS[st]
        ct = self.ct
        while True:
            if ct == 0:
                self.c = c
                self._bytein()
                c, ct = self.c, self.ct
            a <<= 1
            c = (c << 1) & 0xFFFFFFFF
            ct -= 1
            if a >= 0x8000:
                break
        self.a, self.c, self.ct = a, c, ct
        return d

    def raw_init(self, seg: bytes) -> None:
        self.buf = seg + b"\xff\xff"
        self.bp = 0
        self.c = 0
        self.ct = 0

    def raw(self) -> int:
        if self.ct == 0:
            if self.c == 0xFF:
                if self.buf[self.bp] > 0x8F:
                    self.ct = 8
                else:
                    self.c = self.buf[self.bp]
                    self.bp += 1
                    self.ct = 7
            else:
                self.c = self.buf[self.bp]
                self.bp += 1
                self.ct = 8
        self.ct -= 1
        return (self.c >> self.ct) & 1


def decode_block(data: bytes, segments: list, w: int, h: int, numbps: int, roishift: int, orient: int,
                 style: int) -> list:
    """The w x h coefficients (row-major ints, one fractional bit, ROI shift undone) of a code-block whose
    segments are (length, passes) over the concatenated `data`; raises ValueError where OpenJPEG refuses
    the block (31 or more bit-planes)."""
    W = w + 2
    size = W * (h + 2)
    mag, neg, sig, vis, ref = [0] * size, [0] * size, [0] * size, [0] * size, [0] * size
    cnt, hs, vs = [0] * size, [0] * size, [0] * size
    zc = ZC[orient]
    vsc = bool(style & VSC)
    bpno = roishift + numbps
    if bpno >= 31:
        raise ValueError(f"code-block of {bpno} bit-planes")
    mq = MQ()
    dec = mq.decode

    def significant(p: int, s: int, top: bool) -> None:
        c = -1 if s else 1
        sig[p] = 1
        cnt[p - 1] += 15
        cnt[p + 1] += 15
        hs[p - 1] += c
        hs[p + 1] += c
        cnt[p + W] += 5
        vs[p + W] += c
        cnt[p + W - 1] += 1
        cnt[p + W + 1] += 1
        if not (vsc and top):
            cnt[p - W] += 5
            vs[p - W] += c
            cnt[p - W - 1] += 1
            cnt[p - W + 1] += 1

    def sign(p: int) -> int:
        ctx, xor = SC[(hs[p] + 2) * 5 + vs[p] + 2]
        return dec(ctx) ^ xor

    def sigpass(bp: int, raw: bool) -> None:
        one = 1 << bp
        oph = one | (one >> 1)
        for y0 in range(0, h, 4):
            rows = min(4, h - y0)
            for x in range(w):
                p = (y0 + 1) * W + x + 1
                for r in range(rows):
                    if not sig[p] and cnt[p]:
                        if raw:
                            if mq.raw():
                                s = mq.raw()
                                mag[p], neg[p] = oph, s
                                significant(p, s, r == 0)
                        elif dec(zc[cnt[p]]):
                            s = sign(p)
                            mag[p], neg[p] = oph, s
                            significant(p, s, r == 0)
                        vis[p] = 1
                    p += W

    def refpass(bp: int, raw: bool) -> None:
        half = (1 << bp) >> 1
        for y0 in range(0, h, 4):
            rows = min(4, h - y0)
            for x in range(w):
                p = (y0 + 1) * W + x + 1
                for r in range(rows):
                    if sig[p] and not vis[p]:
                        if raw:
                            v = mq.raw()
                        else:
                            v = dec(16 if ref[p] else 15 if cnt[p] else 14)
                        mag[p] += half if v else -half
                        ref[p] = 1
                    p += W

    def clnpass(bp: int) -> None:
        one = 1 << bp
        oph = one | (one >> 1)
        for y0 in range(0, h, 4):
            rows = min(4, h - y0)
            for x in range(w):
                p0 = (y0 + 1) * W + x + 1
                r = 0
                if rows == 4:
                    p1, p2, p3 = p0 + W, p0 + 2 * W, p0 + 3 * W
                    if not (sig[p0] | sig[p1] | sig[p2] | sig[p3] | vis[p0] | vis[p1] | vis[p2] | vis[p3]
                            | cnt[p0] | cnt[p1] | cnt[p2] | cnt[p3]):
                        if not dec(CTX_RL):
                            continue
                        r = dec(CTX_UNI) << 1
                        r |= dec(CTX_UNI)
                        p = p0 + r * W
                        s = sign(p)
                        mag[p], neg[p] = oph, s
                        significant(p, s, r == 0)
                        r += 1
                p = p0 + r * W
                for rr in range(r, rows):
                    if not (sig[p] or vis[p]) and dec(zc[cnt[p]]):
                        s = sign(p)
                        mag[p], neg[p] = oph, s
                        significant(p, s, rr == 0)
                    p += W
        for i in range(size):
            vis[i] = 0
        if style & SEGSYM:
            for _ in range(4):
                dec(CTX_UNI)

    passtype = 2
    pos = 0
    for seglen, passes in segments:
        raw = bpno <= numbps - 4 and passtype < 2 and bool(style & BYPASS)
        seg = data[pos : pos + seglen]
        pos += seglen
        if raw:
            mq.raw_init(seg)
        else:
            mq.init(seg)
        done = 0
        while done < passes and bpno >= 1:
            if passtype == 0:
                sigpass(bpno, raw)
            elif passtype == 1:
                refpass(bpno, raw)
            else:
                clnpass(bpno)
            if style & RESET and not raw:
                mq.reset()
            passtype += 1
            if passtype == 3:
                passtype = 0
                bpno -= 1
            done += 1
    out = []
    for y in range(h):
        p = (y + 1) * W + 1
        for x in range(w):
            m = mag[p + x]
            out.append(-m if neg[p + x] else m)
    if roishift:
        if roishift >= 31:
            return [0] * (w * h)
        thresh = 1 << roishift
        out = [v if abs(v) < thresh else (-(abs(v) >> roishift) if v < 0 else abs(v) >> roishift) for v in out]
    return out
