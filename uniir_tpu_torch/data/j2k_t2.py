"""JPEG 2000 tier 2 and the tile's decode, as OpenJPEG 2.5 reads them.

  * the geometry of a tile (`Tile`): tile-components on the reference grid divided by the component's
    subsampling, resolutions, sub-bands (B-15), precincts on each resolution's grid (halved for the bands
    of a resolution above the lowest), code-blocks no larger than the precinct, each with its tag trees;
  * the packets in the tile's progression (`packets`): LRCP, RLCP, RPCL, PCRL and CPRL, each POC entry a
    progression of its own from layer 0 whose packets already read are skipped, as opj_pi_next_* walk them;
  * each packet's header (`read_packets`): an optional SOP, the present bit, inclusion and zero-bit-plane
    tag trees, the pass count codewords, the Lblock increments and each segment's length (bit stuffing
    after FF, zeros past the end), the final byte alignment and an optional EPH, from the tile's data or
    from the PPM / PPT headers; then its body, each code-block's bytes cut from the data; a segment that
    runs past the tile's data fails the decode, as OpenJPEG's strict mode fails it;
  * `decode_tile`: tier 1 on every code-block (`j2k_t1`), the coefficients halved (reversible) or scaled
    by the band's step size in float32, the inverse DWT, the component transform and the level shift
    (`j2k_dwt`): each component's int32 samples.
"""

from __future__ import annotations

import numpy as np

from uniir_tpu_torch.data import j2k_dwt, j2k_t1

LRCP, RLCP, RPCL, PCRL, CPRL = range(5)
SOP_FLAG, EPH_FLAG = 2, 4


def ceildiv(a: int, b: int) -> int:
    return -(-a // b)


def ceildivpow2(a: int, b: int) -> int:
    return -(-a >> b)


class TagTree:
    """opj_tgt: leaves then each coarser level, values 999 until decoded."""

    def __init__(self, w: int, h: int):
        self.parent = []
        sizes = []
        nw, nh = w, h
        while True:
            sizes.append((nw, nh))
            if nw * nh <= 1:
                break
            nw, nh = (nw + 1) // 2, (nh + 1) // 2
        start = [0]
        for sw, sh in sizes:
            start.append(start[-1] + sw * sh)
        for lvl, (sw, sh) in enumerate(sizes):
            for j in range(sh):
                for i in range(sw):
                    if lvl + 1 < len(sizes):
                        pw = sizes[lvl + 1][0]
                        self.parent.append(start[lvl + 1] + (j >> 1) * pw + (i >> 1))
                    else:
                        self.parent.append(-1)
        if w * h == 0:
            self.parent = []
        self.reset()

    def reset(self) -> None:
        self.value = [999] * len(self.parent)
        self.low = [0] * len(self.parent)

    def decode(self, bio: "Bio", leaf: int, threshold: int) -> int:
        stack = []
        node = leaf
        while self.parent[node] >= 0:
            stack.append(node)
            node = self.parent[node]
        low = 0
        while True:
            if low > self.low[node]:
                self.low[node] = low
            else:
                low = self.low[node]
            while low < threshold and low < self.value[node]:
                if bio.read(1):
                    self.value[node] = low
                else:
                    low += 1
            self.low[node] = low
            if not stack:
                break
            node = stack.pop()
        return 1 if self.value[node] < threshold else 0


class Bio:
    """opj_bio for reading: bytes from `start` up to `end`, zeros past it, a stuffed bit after FF."""

    def __init__(self, buf: bytes, start: int, end: int):
        self.buf, self.start, self.bp, self.end = buf, start, start, end
        self.word = 0
        self.ct = 0

    def _bytein(self) -> None:
        self.word = (self.word << 8) & 0xFFFF
        self.ct = 7 if self.word == 0xFF00 else 8
        if self.bp < self.end:
            self.word |= self.buf[self.bp]
            self.bp += 1

    def read(self, n: int) -> int:
        v = 0
        for i in range(n - 1, -1, -1):
            if self.ct == 0:
                self._bytein()
            self.ct -= 1
            v |= ((self.word >> self.ct) & 1) << i
        return v

    def inalign(self) -> None:
        if (self.word & 0xFF) == 0xFF:
            self._bytein()
        self.ct = 0

    def numbytes(self) -> int:
        return self.bp - self.start


class Segment:
    __slots__ = ("len", "numpasses", "maxpasses", "newlen", "numnewpasses", "real_num_passes")

    def __init__(self, maxpasses: int):
        self.len = self.numpasses = self.newlen = self.numnewpasses = self.real_num_passes = 0
        self.maxpasses = maxpasses


class Codeblock:
    __slots__ = ("x0", "y0", "x1", "y1", "numbps", "numlenbits", "segs", "numsegs", "chunks", "numnewpasses")

    def __init__(self, x0, y0, x1, y1):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.numbps = self.numlenbits = self.numsegs = self.numnewpasses = 0
        self.segs = []
        self.chunks = []


class Precinct:
    def __init__(self, cw, ch, cblks):
        self.cblks = cblks
        self.incl = TagTree(cw, ch)
        self.imsb = TagTree(cw, ch)


class Band:
    def __init__(self, bandno, x0, y0, x1, y1, numbps, stepsize):
        self.bandno, self.x0, self.y0, self.x1, self.y1 = bandno, x0, y0, x1, y1
        self.numbps, self.stepsize = numbps, stepsize
        self.precincts = []

    def empty(self) -> bool:
        return self.x1 - self.x0 == 0 or self.y1 - self.y0 == 0


class Resolution:
    def __init__(self, x0, y0, x1, y1, pdx, pdy, pw, ph):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.pdx, self.pdy, self.pw, self.ph = pdx, pdy, pw, ph
        self.bands = []


class TileComp:
    def __init__(self, x0, y0, x1, y1):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.resolutions = []


def band_stepsize(prec: int, expn: int, mant: int) -> np.float32:
    """The band's step size as opj_tcd_init_tile computes it for decoding (no sub-band gain)."""
    return np.float32((1.0 + mant / 2048.0) * 2.0 ** (prec - expn))


class Tile:
    """A tile's components, resolutions, bands, precincts and code-blocks (opj_tcd_init_tile)."""

    def __init__(self, image, tcp, tileno: int):
        cp = image
        p, q = tileno % cp.tw, tileno // cp.tw
        self.x0 = max(cp.tx0 + p * cp.tdx, cp.x0)
        self.y0 = max(cp.ty0 + q * cp.tdy, cp.y0)
        self.x1 = min(cp.tx0 + (p + 1) * cp.tdx, cp.x1)
        self.y1 = min(cp.ty0 + (q + 1) * cp.tdy, cp.y1)
        self.comps = []
        for compno, (dx, dy, prec, sgnd) in enumerate(cp.comps):
            tccp = tcp.tccps[compno]
            tc = TileComp(ceildiv(self.x0, dx), ceildiv(self.y0, dy), ceildiv(self.x1, dx), ceildiv(self.y1, dy))
            numres = tccp.numresolutions
            stepno = 0
            for resno in range(numres):
                level = numres - 1 - resno
                rx0, ry0 = ceildivpow2(tc.x0, level), ceildivpow2(tc.y0, level)
                rx1, ry1 = ceildivpow2(tc.x1, level), ceildivpow2(tc.y1, level)
                pdx, pdy = tccp.prcw[resno], tccp.prch[resno]
                px0, py0 = (rx0 >> pdx) << pdx, (ry0 >> pdy) << pdy
                px1, py1 = ceildivpow2(rx1, pdx) << pdx, ceildivpow2(ry1, pdy) << pdy
                pw = 0 if rx0 == rx1 else (px1 - px0) >> pdx
                ph = 0 if ry0 == ry1 else (py1 - py0) >> pdy
                res = Resolution(rx0, ry0, rx1, ry1, pdx, pdy, pw, ph)
                if resno == 0:
                    cbgx, cbgy, cbgw, cbgh = px0, py0, pdx, pdy
                else:
                    cbgx, cbgy, cbgw, cbgh = ceildivpow2(px0, 1), ceildivpow2(py0, 1), pdx - 1, pdy - 1
                cbw, cbh = min(tccp.cblkw, cbgw), min(tccp.cblkh, cbgh)
                for bandno in ([0] if resno == 0 else [1, 2, 3]):
                    if resno == 0:
                        bx0, by0, bx1, by1 = rx0, ry0, rx1, ry1
                    else:
                        xb, yb = bandno & 1, bandno >> 1
                        bx0 = ceildivpow2(tc.x0 - (xb << level), level + 1)
                        by0 = ceildivpow2(tc.y0 - (yb << level), level + 1)
                        bx1 = ceildivpow2(tc.x1 - (xb << level), level + 1)
                        by1 = ceildivpow2(tc.y1 - (yb << level), level + 1)
                    expn, mant = tccp.stepsizes[stepno] if stepno < len(tccp.stepsizes) else (0, 0)
                    stepno += 1
                    band = Band(bandno, bx0, by0, bx1, by1, expn + tccp.numgbits - 1,
                                band_stepsize(prec, expn, mant))
                    for precno in range(pw * ph):
                        gx0 = cbgx + (precno % pw) * (1 << cbgw)
                        gy0 = cbgy + (precno // pw) * (1 << cbgh)
                        x0, y0 = max(gx0, bx0), max(gy0, by0)
                        x1, y1 = min(gx0 + (1 << cbgw), bx1), min(gy0 + (1 << cbgh), by1)
                        tlx, tly = (x0 >> cbw) << cbw, (y0 >> cbh) << cbh
                        brx, bry = ceildivpow2(x1, cbw) << cbw, ceildivpow2(y1, cbh) << cbh
                        cw, ch = (brx - tlx) >> cbw, (bry - tly) >> cbh
                        if cw < 0 or ch < 0:
                            raise ValueError("precinct of negative size")
                        cblks = []
                        for cblkno in range(cw * ch):
                            cx0 = tlx + (cblkno % cw) * (1 << cbw)
                            cy0 = tly + (cblkno // cw) * (1 << cbh)
                            cblks.append(Codeblock(max(cx0, x0), max(cy0, y0), min(cx0 + (1 << cbw), x1),
                                                   min(cy0 + (1 << cbh), y1)))
                        band.precincts.append(Precinct(cw, ch, cblks))
                    res.bands.append(band)
                tc.resolutions.append(res)
            self.comps.append(tc)


def packets(image, tcp, tile: Tile):
    """(layer, resolution, component, precinct) of each packet in the order OpenJPEG's iterators give
    them (opj_pi_next_lrcp / rlcp / rpcl / pcrl / cprl over each progression)."""
    numcomps = len(image.comps)
    numlayers = tcp.numlayers
    max_res = max(tcp.tccps[c].numresolutions for c in range(numcomps))
    if tcp.pocs:
        progs = [(prg, resno0, compno0, min(layno1, numlayers), resno1, min(compno1, numcomps))
                 for resno0, compno0, layno1, resno1, compno1, prg in tcp.pocs]
    else:
        progs = [(tcp.prg, 0, 0, numlayers, max_res, numcomps)]
    seen = set()
    tx0, ty0, tx1, ty1 = tile.x0, tile.y0, tile.x1, tile.y1

    def fresh(key):
        if key in seen:
            return False
        seen.add(key)
        return True

    def nres(c):
        return len(tile.comps[c].resolutions)

    def position_step(comps):
        dx = dy = 0
        for c in comps:
            cdx, cdy = image.comps[c][0], image.comps[c][1]
            n = nres(c)
            for r, res in enumerate(tile.comps[c].resolutions):
                ex, ey = res.pdx + n - 1 - r, res.pdy + n - 1 - r
                if ex < 32 and cdx <= 0xFFFFFFFF // (1 << ex):
                    dx = cdx * (1 << ex) if not dx else min(dx, cdx * (1 << ex))
                if ey < 32 and cdy <= 0xFFFFFFFF // (1 << ey):
                    dy = cdy * (1 << ey) if not dy else min(dy, cdy * (1 << ey))
        return dx, dy

    def precinct_at(c, r, x, y):
        """The precinct of component c, resolution r at reference-grid position (x, y), or None."""
        cdx, cdy = image.comps[c][0], image.comps[c][1]
        res = tile.comps[c].resolutions[r]
        level = nres(c) - 1 - r
        if level >= 32:
            return None
        trx0, try0 = ceildiv(tx0, cdx << level), ceildiv(ty0, cdy << level)
        trx1, try1 = ceildiv(tx1, cdx << level), ceildiv(ty1, cdy << level)
        rpx, rpy = res.pdx + level, res.pdy + level
        if not (y % (cdy << rpy) == 0 or (y == ty0 and (try0 << level) % (1 << rpy))):
            return None
        if not (x % (cdx << rpx) == 0 or (x == tx0 and (trx0 << level) % (1 << rpx))):
            return None
        if res.pw == 0 or res.ph == 0 or trx0 == trx1 or try0 == try1:
            return None
        prci = (ceildiv(x, cdx << level) >> res.pdx) - (trx0 >> res.pdx)
        prcj = (ceildiv(y, cdy << level) >> res.pdy) - (try0 >> res.pdy)
        return prci + prcj * res.pw

    for prg, r0, c0, l1, r1, c1 in progs:
        if prg in (LRCP, RLCP):
            outer = ((l, r) for l in range(l1) for r in range(r0, r1)) if prg == LRCP else \
                ((l, r) for r in range(r0, r1) for l in range(l1))
            for l, r in outer:
                for c in range(c0, c1):
                    if r >= nres(c):
                        continue
                    res = tile.comps[c].resolutions[r]
                    for p in range(res.pw * res.ph):
                        if fresh((l, r, c, p)):
                            yield l, r, c, p
        elif prg == CPRL:
            for c in range(c0, c1):
                dx, dy = position_step([c])
                if dx == 0 or dy == 0:
                    return
                y = ty0
                while y < ty1:
                    x = tx0
                    while x < tx1:
                        for r in range(r0, min(r1, nres(c))):
                            p = precinct_at(c, r, x, y)
                            if p is not None:
                                for l in range(l1):
                                    if fresh((l, r, c, p)):
                                        yield l, r, c, p
                        x += dx - x % dx
                    y += dy - y % dy
        elif prg in (RPCL, PCRL):
            dx, dy = position_step(range(numcomps))
            if dx == 0 or dy == 0:
                return
            if prg == RPCL:
                for r in range(r0, r1):
                    y = ty0
                    while y < ty1:
                        x = tx0
                        while x < tx1:
                            for c in range(c0, c1):
                                if r >= nres(c):
                                    continue
                                p = precinct_at(c, r, x, y)
                                if p is not None:
                                    for l in range(l1):
                                        if fresh((l, r, c, p)):
                                            yield l, r, c, p
                            x += dx - x % dx
                        y += dy - y % dy
            else:
                y = ty0
                while y < ty1:
                    x = tx0
                    while x < tx1:
                        for c in range(c0, c1):
                            for r in range(r0, min(r1, nres(c))):
                                p = precinct_at(c, r, x, y)
                                if p is not None:
                                    for l in range(l1):
                                        if fresh((l, r, c, p)):
                                            yield l, r, c, p
                        x += dx - x % dx
                    y += dy - y % dy
        else:
            raise ValueError(f"unknown progression order {prg}")


def _init_seg(cblk: Codeblock, index: int, style: int, first: bool) -> None:
    """opj_t2_init_seg."""
    if style & j2k_t1.TERMALL:
        maxpasses = 1
    elif style & j2k_t1.BYPASS:
        if first:
            maxpasses = 10
        else:
            prev = cblk.segs[index - 1].maxpasses
            maxpasses = 2 if prev in (1, 10) else 1
    else:
        maxpasses = 109
    seg = Segment(maxpasses)
    if index < len(cblk.segs):
        cblk.segs[index] = seg
    else:
        cblk.segs.append(seg)


def _numpasses(bio: Bio) -> int:
    if not bio.read(1):
        return 1
    if not bio.read(1):
        return 2
    n = bio.read(2)
    if n != 3:
        return 3 + n
    n = bio.read(5)
    if n != 31:
        return 6 + n
    return 37 + bio.read(7)


class Headers:
    """Where packet headers are read: bytes and a position (PPM, shared by every tile; PPT; or None for
    the tile's own data)."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0


def read_packets(image, tcp, tile: Tile, data: bytes, headers: Headers | None) -> list:
    """Tier 2 over the tile's data: fills each code-block's chunks and segments; returns, per component,
    the highest resolution a packet was read for."""
    pos, end = 0, len(data)
    decoded = [0] * len(tile.comps)
    for layno, resno, compno, precno in packets(image, tcp, tile):
        tccp = tcp.tccps[compno]
        res = tile.comps[compno].resolutions[resno]
        decoded[compno] = max(decoded[compno], resno)
        if layno == 0:
            for band in res.bands:
                if not band.empty():
                    prc = band.precincts[precno]
                    prc.incl.reset()
                    prc.imsb.reset()
                    for cblk in prc.cblks:
                        cblk.numsegs = 0
        if tcp.csty & SOP_FLAG:
            if end - pos >= 6 and data[pos] == 0xFF and data[pos + 1] == 0x91:
                pos += 6
        if headers is None:
            hbuf, hstart, hend = data, pos, end
        else:
            hbuf, hstart, hend = headers.data, headers.pos, len(headers.data)
        bio = Bio(hbuf, hstart, hend)
        present = bio.read(1)
        included = []
        if present:
            for band in res.bands:
                if band.empty():
                    continue
                prc = band.precincts[precno]
                for cblkno, cblk in enumerate(prc.cblks):
                    if not cblk.numsegs:
                        inc = prc.incl.decode(bio, cblkno, layno + 1)
                    else:
                        inc = bio.read(1)
                    if not inc:
                        cblk.numnewpasses = 0
                        continue
                    if not cblk.numsegs:
                        i = 0
                        while not prc.imsb.decode(bio, cblkno, i):
                            i += 1
                        cblk.numbps = band.numbps + 1 - i
                        cblk.numlenbits = 3
                    cblk.numnewpasses = _numpasses(bio)
                    incr = 0
                    while bio.read(1):
                        incr += 1
                    cblk.numlenbits += incr
                    segno = 0
                    if not cblk.numsegs:
                        _init_seg(cblk, 0, tccp.cblksty, True)
                    else:
                        segno = cblk.numsegs - 1
                        if cblk.segs[segno].numpasses == cblk.segs[segno].maxpasses:
                            segno += 1
                            _init_seg(cblk, segno, tccp.cblksty, False)
                    n = cblk.numnewpasses
                    while True:
                        seg = cblk.segs[segno]
                        seg.numnewpasses = min(seg.maxpasses - seg.numpasses, n)
                        bits = cblk.numlenbits + (seg.numnewpasses.bit_length() - 1)
                        if bits > 32:
                            raise ValueError(f"invalid bit number {bits} in a packet header")
                        seg.newlen = bio.read(bits)
                        n -= seg.numnewpasses
                        if n <= 0:
                            break
                        segno += 1
                        _init_seg(cblk, segno, tccp.cblksty, False)
                    included.append(cblk)
        bio.inalign()
        hpos = hstart + bio.numbytes()
        if tcp.csty & EPH_FLAG and hend - hpos >= 2:
            if hbuf[hpos] != 0xFF or hbuf[hpos + 1] != 0x92:
                raise ValueError("Expected EPH marker")
            hpos += 2
        if headers is None:
            pos = hpos
        else:
            headers.pos = hpos
        if not present:
            continue
        for cblk in included:
            if not cblk.numsegs:
                segno = 0
                cblk.numsegs = 1
            else:
                segno = cblk.numsegs - 1
                if cblk.segs[segno].numpasses == cblk.segs[segno].maxpasses:
                    segno += 1
                    cblk.numsegs += 1
            while True:
                seg = cblk.segs[segno]
                if pos + seg.newlen > end:
                    raise ValueError(f"segment of {seg.newlen} bytes past the tile's data (read: segment too long)")
                cblk.chunks.append(data[pos : pos + seg.newlen])
                pos += seg.newlen
                seg.len += seg.newlen
                seg.numpasses += seg.numnewpasses
                cblk.numnewpasses -= seg.numnewpasses
                seg.real_num_passes = seg.numpasses
                if cblk.numnewpasses <= 0:
                    break
                segno += 1
                cblk.numsegs += 1
    return decoded


def decode_tile(image, tcp, tileno: int, data: bytes, headers: Headers | None) -> list:
    """Each component's int32 samples [h, w] over the tile (opj_tcd_decode_tile)."""
    tile = Tile(image, tcp, tileno)
    decoded = read_packets(image, tcp, tile, data, headers)
    out = []
    for compno, tc in enumerate(tile.comps):
        tccp = tcp.tccps[compno]
        reversible = tccp.qmfbid == 1
        if decoded[compno] != len(tc.resolutions) - 1:
            raise ValueError("a component's packets stop short of its highest resolution")
        w, h = tc.x1 - tc.x0, tc.y1 - tc.y0
        coef = np.zeros((h, w), np.int32 if reversible else np.float32)
        for resno, res in enumerate(tc.resolutions):
            for band in res.bands:
                if band.empty():
                    continue
                for prc in band.precincts:
                    for cblk in prc.cblks:
                        cw, ch = cblk.x1 - cblk.x0, cblk.y1 - cblk.y0
                        if cw <= 0 or ch <= 0 or not cblk.chunks:
                            continue
                        segs = [(s.len, s.real_num_passes) for s in cblk.segs[: cblk.numsegs]]
                        vals = j2k_t1.decode_block(b"".join(cblk.chunks), segs, cw, ch, cblk.numbps,
                                                   tccp.roishift, band.bandno, tccp.cblksty)
                        v = np.array(vals, np.int64).reshape(ch, cw)
                        x, y = cblk.x0 - band.x0, cblk.y0 - band.y0
                        if band.bandno & 1:
                            prev = tc.resolutions[resno - 1]
                            x += prev.x1 - prev.x0
                        if band.bandno & 2:
                            prev = tc.resolutions[resno - 1]
                            y += prev.y1 - prev.y0
                        if reversible:
                            coef[y : y + ch, x : x + cw] = (np.sign(v) * (np.abs(v) >> 1)).astype(np.int32)
                        else:
                            coef[y : y + ch, x : x + cw] = v.astype(np.int32).astype(np.float32) * \
                                np.float32(np.float32(0.5) * band.stepsize)
        out.append(j2k_dwt.idwt(coef, [(r.x0, r.y0, r.x1, r.y1) for r in tc.resolutions], reversible))
    if tcp.mct and len(out) >= 3:
        if out[0].shape != out[1].shape or out[0].shape != out[2].shape or \
                len({len(tile.comps[c].resolutions) for c in range(3)}) != 1:
            raise ValueError("tiles don't all have the same dimension (MCT)")
        if tcp.tccps[0].qmfbid != tcp.tccps[1].qmfbid or tcp.tccps[0].qmfbid != tcp.tccps[2].qmfbid:
            raise ValueError("a component transform over mixed wavelets")
        out[0], out[1], out[2] = (j2k_dwt.rct if tcp.tccps[0].qmfbid == 1 else j2k_dwt.ict)(out[0], out[1], out[2])
    for compno, (dx, dy, prec, sgnd) in enumerate(image.comps):
        out[compno] = j2k_dwt.level_shift(out[compno], prec, sgnd, tcp.tccps[compno].qmfbid == 1)
    return out
