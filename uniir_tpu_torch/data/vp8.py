"""The VP8 key frame (RFC 6386), read as libwebp 1.6 reads it: the lossy
half of `data.webp`.  `decode` gives the frame's Y, U and V planes after the
loop filter, cropped to the frame's size.

  * the frame tag (a key frame, shown, profile <= 3; the first partition's
    length within the data), the start code and the 14-bit width and
    height, whose scale bits are ignored;
  * the boolean decoder as libwebp runs it: a partition that has to load a
    byte past its end is refused (partition 0 is checked after the
    segment and filter headers and after each macroblock row's modes, a
    token partition after each macroblock);
  * the header: colour space and clamping (read, unused), segmentation
    (absolute or delta quantiser and filter values, the map's three
    probabilities), the filter type, level and sharpness, the loop-filter
    deltas (only the first reference and the first mode delta apply to a
    key frame), 1 / 2 / 4 / 8 token partitions (a size past the data is
    cut to what is left, and the last partition must not be empty), the
    quantiser indices and their five deltas, the coefficient probability
    updates and the skip probability;
  * per macroblock: the segment id, the skip flag, 16x16 or B_PRED modes
    (a sub-block's probabilities chosen by the modes above and to its left,
    a 16x16 macroblock counting as its mode in every sub-block), the
    chroma mode; the tokens, each block's first context the number of
    non-zero neighbours above and to the left (Y2's its own; a skipped
    macroblock clears them, but a skipped B_PRED one keeps Y2's);
  * dequantisation: Y2's DC x 2, Y2's AC x 155 / 100 and at least 8, the
    chroma DC index at most 117 (a factor of at most 132);
  * the inverse WHT and DCT (20091 / 35468, RFC 6386 section 14) added to
    the prediction and clipped;
  * intra prediction over unfiltered pixels, with libwebp's edges: 127
    above the frame, 129 left of it, the top-left 127 in the first row and
    129 in the first column below it; DC without top, left or both; TM
    clipped; B_PRED's above-right pixels those of the macroblock above and
    to the right, replicated from the macroblock above's last pixel in the
    last column, 127 in the first row, and the same four pixels for the
    right-hand sub-blocks of rows 1-3;
  * the loop filter, simple or normal, over the macroblock-aligned frame in
    macroblock order (left edge, inner vertical edges, top edge, inner
    horizontal edges), none when the frame's level is 0: each macroblock's
    level from its segment plus the first reference delta and, for
    B_PRED, the first mode delta, clipped to 0..63; the interior limit
    from sharpness; the high-edge-variance threshold 0 / 1 / 2 from the
    level; inner edges skipped for a macroblock whose coefficients are all
    zero (skipped or not) unless it is B_PRED.

Anything libwebp refuses raises ValueError; the caller names the file.
The C++ decoder in `csrc/webp.cu` holds the same function.
"""

from __future__ import annotations

import numpy as np

B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU = range(10)  # libwebp's order; 16x16: DC TM V H
ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
CAT_PROBS = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
             (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
DC_TABLE = (
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17, 18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26,
    27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 46, 47, 48, 49, 50, 51, 52,
    53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 76, 77, 78, 79,
    80, 81, 82, 83, 84, 85, 86, 87, 88, 89, 91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116,
    118, 122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157)
AC_TABLE = (
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33,
    34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 60, 62, 64,
    66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108, 110, 112, 114, 116,
    119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152, 155, 158, 161, 164, 167, 170, 173, 177, 181, 185,
    189, 193, 197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284)
# RFC 6386 section 13: default token probabilities and their update probabilities, [type][band][context][11],
# and section 11.5: B_PRED sub-block mode probabilities [above][left][9] (modes in libwebp's order above)
COEFF_PROBS = np.frombuffer(bytes.fromhex(
    "808080808080808080808080808080808080808080808080808080808080808080fd88feffe4db8080808080bd81f2ffe3d5"
    "ffdb8080806a7ee3fcd6d1ffff8080800162f8ffece2ffff808080b585eefeddeaff9a8080804e86caf7c6b4ffdb80808001"
    "b9f9fff3ff8080808080b896f7ffece080808080804d6ed8ffece680808080800165fbfff1ff8080808080aa8bf1fcecd1ff"
    "ff8080802574c4f3e4ffffff80808001ccfefff5ff8080808080cfa0faffee8080808080806667e7ffd3ab80808080800198"
    "fcfff0ff8080808080b187f3ffeae180808080805081d3ffc2e080808080800101ff8080808080808080f601ff8080808080"
    "808080ff80808080808080808080c623eddfc1bba2a0919b3e832dc6ddacb0dc9dfcdd01442f92d095a7dda2ffdf800195f1"
    "ffdde0ffff808080b88deafddedcffc78080805163b5f2b0bef9caffff800181e8fdd6c5f2c4ffff806379d2fac9c6ffca80"
    "8080175ba3f2aabbf7d2ffff8001c8f6ffeaff80808080806db2f1ffe7f5ffff8080802c82c9fdcdc0ffff8080800184effb"
    "dbd1ffa58080805e88e1fbdabeffff8080801664aef5baa1ffc780808001b6f9ffe8eb80808080807c8ff1ffe3ea80808080"
    "80234db5fbc1d3ffcd808080019df7ffece7ffff808080798debffe1e3ffff8080802d63bcfbc3d9ffe08080800101fbffd5"
    "ff8080808080cb01f8ffff8080808080808901b1ffe0ff8080808080fd09f8fbcfd0ffc0808080af0de0f3c1b9f9c6ffff80"
    "4911abdda1b3eca7ffea80015ff7fdd4b7ffff808080ef5af4fad3d1ffff8080809b4dc3f8bcc3ffff8080800118effbdadb"
    "ffcd808080c933dbffc4ba8080808080452ebeefc9daffe480808001bffbffff808080808080dfa5f9ffd5ff80808080808d"
    "7cf8ffff8080808080800110f8ffff808080808080be24e6ffecff80808080809501ff808080808080808001e2ff80808080"
    "80808080f7c0ff8080808080808080f080ff80808080808080800186fcffff808080808080d53efaffff808080808080375d"
    "ff8080808080808080808080808080808080808080808080808080808080808080808080808080808080ca18d5ebbabfdca0"
    "f0afff7e26b6e8a9b8e4aeffbb803d2e8adb97b2f0aaffd8800170e6fac7bff79fffff80a66de4fcd3d7ffae808080274da2"
    "e8acb4f5b2ffff800134dcf6c6c7f9dcffff807c4abff3b7c1faddffff80184782db9aaaf3b6ffff8001b6e1f9dbf0ffe080"
    "80809596e2fcd8cdffab8080801c6caaf2b7c2fedfffff800151e6fccccbffc08080807b66d1f7bcc4ffe9808080145f99f3"
    "a4adffcb80808001def8ffd8d58080808080a8aff6fcebcdffff8080802f74d7ffd3d4ffff8080800179ecfdd4d6ffff8080"
    "808d54d5fcc9caffdb8080802a50a0f0a2b9ffcd8080800101ff8080808080808080f401ff8080808080808080ee01ff8080"
    "808080808080"
), np.uint8).reshape(4, 8, 3, 11)
COEFF_UPDATE_PROBS = np.frombuffer(bytes.fromhex(
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffb0f6ffffffffffffffffffdff1fcffffff"
    "fffffffffff9fdfdfffffffffffffffffff4fcffffffffffffffffeafefefffffffffffffffffdffffffffffffffffffffff"
    "f6feffffffffffffffffeffdfefffffffffffffffffefffefffffffffffffffffff8fefffffffffffffffffbfffeffffffff"
    "fffffffffffffffffffffffffffffffffdfefffffffffffffffffbfefefffffffffffffffffefffefffffffffffffffffffe"
    "fdfffefffffffffffffafffefffefffffffffffffeffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffd9ffffffffffffffffffffe1fcf1fdfffffeffffffffeafaf1fafdfffdfefffffffffeff"
    "ffffffffffffffffdffefeffffffffffffffffeefdfefefffffffffffffffff8fefffffffffffffffff9feffffffffffffff"
    "fffffffffffffffffffffffffffffdfffffffffffffffffff7fefffffffffffffffffffffffffffffffffffffffffffdfeff"
    "fffffffffffffffcfffffffffffffffffffffffffffffffffffffffffffffefefffffffffffffffffdffffffffffffffffff"
    "fffffffffffffffffffffffffffefdfffffffffffffffffafffffffffffffffffffffeffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffbafbfaffffffffffffffffeafbf4feffffffffffffff"
    "fbfbf3fdfefffefffffffffffdfeffffffffffffffffecfdfefffffffffffffffffbfdfdfefefffffffffffffffefeffffff"
    "fffffffffffefefefffffffffffffffffffffffffffffffffffffffffefffffffffffffffffffefefffffffffffffffffffe"
    "fffffffffffffffffffffffffffffffffffffffffffeffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "fffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff8ffffffffffffff"
    "fffffffafefcfefffffffffffffff8fef9fdfffffffffffffffffdfdfffffffffffffffff6fdfdfffffffffffffffffcfefb"
    "fefefffffffffffffffefcfffffffffffffffff8fefdfffffffffffffffffdfffefefffffffffffffffffbfeffffffffffff"
    "fffff5fbfefffffffffffffffffdfdfefffffffffffffffffffbfdfffffffffffffffffcfdfefffffffffffffffffffeffff"
    "fffffffffffffffffcfffffffffffffffffff9fffefffffffffffffffffffffefffffffffffffffffffffdffffffffffffff"
    "fffafffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffeffffffffffffffffffffffffffffff"
    "ffffffffffff"
), np.uint8).reshape(4, 8, 3, 11)
BMODE_PROBS = np.frombuffer(bytes.fromhex(
    "e7783059737178987098b3407eaa762e465faf458f505552489b67383a0aabdabd110d98721a11a32cc3150aad791850c31a"
    "3e2c405590470a26abd590221aaa2e371388a021ce473f14087272d00c09e251280b60b6541d102486b7598962656aa59448"
    "bb64829d6f204b504266a7634a3e28ea80293509b2f18d1a086b4a2b1a9249a631179d412669a033341f7380684f0c1bd9ff"
    "5711075744472c72330fba172f290e6eb6b71511c2422d1966c5bd171216585893962a2e2dc4cd2b61b775552623b33d2735"
    "c8571a152be8ab3822336872661d5d4d271c55ab3aa55a6240221674ce17222ba6496b36201a3301512b1f44196a1640ab24"
    "e1722213156684bc104c7c3e124e5f5539323033c165239fd76f592e6f3c941facdbe415126f70714d55b3ff267872282a01"
    "c4f5d10a196d582b1d8ca6d5252b9a3d3f1e9b432d4401d16450082b9a01331a478e4e4e10ff8022c5ab29280566d3b70401"
    "dd333211a8d1c01719528a1f24ab1ba6262ce543573aa952731a3bb33f3b5ab43ba65d499a282815748fd12227af2f0f10b7"
    "22df312db72e1121b706620f20b7392e16188001361125412049731c801780cd2803097333c01206df572509733b4d40152f"
    "68372cda09363582e2405a46cd2829171a39363970b8052926a6d51e221a8598740a2086271335dd1a722049ff1f0941ea02"
    "0f0176494b200c33c0ffa02b33581f2343665537ba553815176f3bcd2d25c03726467c49660122627d622a58685575af525f"
    "543559806471652d4b4f7b2f338051ab0139110547663935293126210d7939491a0155290a438a4d6e5a2f727315020a66ff"
    "a61706651d100a558065c41a39120a6666d522142b75140f24a38044011a663d472522351ff3c0453c472649771cde25442d"
    "8022012f0bf5ab3e1113469255373e46252b259a64a355a0013f095c881c4020c9554b0f090940ffb8771056061c0540ff19"
    "f8013808118489ff3774803a0f145287391a7928a4321f899a851923da33672c83837b1f069e5628408794e02db780161a11"
    "83f09a0e01d12d10155b40de0701c53815279b3c8a1766d5530c0d36c0ff442f1c551a555580802092ab120b073f90ab0404"
    "f6231b0a92aeab0c1a80be502363b4507e362d557e2f57b033291420654b808b769274805538290fb0ec5525093e471e1177"
    "76ff11128a65263c8a37462b1a8e9224131eabff611b148a2d3d3edb0151bc4020291475978e1415a370130c3dc380300418"
), np.uint8).reshape(10, 10, 9)
START_CODE = b"\x9d\x01\x2a"
_BMODES = BMODE_PROBS.tolist()


class BoolReader:
    """libwebp's VP8BitReader, a byte at a time: `value` holds the unread
    bits above position `bits`, `range` is the range minus one."""

    __slots__ = ("buf", "n", "pos", "value", "bits", "range", "eof")

    def __init__(self, data: bytes):
        self.buf, self.n, self.pos = data, len(data), 0
        self.value, self.bits, self.range, self.eof = 0, -8, 254, False
        self._load()

    def _load(self) -> None:
        if self.pos < self.n:
            self.value = (self.value << 8) | self.buf[self.pos]
            self.pos += 1
            self.bits += 8
        elif not self.eof:
            self.value <<= 8
            self.bits += 8
            self.eof = True
        else:
            self.bits = 0

    def bit(self, prob: int) -> int:  # VP8GetBit
        if self.bits < 0:
            self._load()
        rng = self.range
        split = (rng * prob) >> 8
        if (self.value >> self.bits) > split:
            rng -= split
            self.value -= (split + 1) << self.bits
            bit = 1
        else:
            rng = split + 1
            bit = 0
        shift = 8 - rng.bit_length()
        self.range = (rng << shift) - 1
        self.bits -= shift
        return bit

    def value_bits(self, nbits: int) -> int:  # VP8GetValue
        v = 0
        for k in range(nbits - 1, -1, -1):
            v |= self.bit(128) << k
        return v

    def signed(self, nbits: int) -> int:  # VP8GetSignedValue
        v = self.value_bits(nbits)
        return -v if self.bit(128) else v


class Frame:
    """What the header says."""

    def __init__(self, width, height):
        self.width, self.height = width, height
        self.mb_w, self.mb_h = (width + 15) >> 4, (height + 15) >> 4
        self.use_segment = self.update_map = False
        self.absolute_delta = True
        self.seg_quant, self.seg_filter = [0] * 4, [0] * 4
        self.seg_probs = [255, 255, 255]
        self.simple = False
        self.level = self.sharpness = 0
        self.use_lf_delta = False
        self.ref_delta, self.mode_delta = [0] * 4, [0] * 4
        self.skip_prob = None


def info(data: bytes, chunk_size: int):
    """(width, height) of a VP8 key frame (VP8GetInfo); None where libwebp refuses it."""
    if len(data) < 10 or data[3:6] != START_CODE:
        return None
    bits = data[0] | data[1] << 8 | data[2] << 16
    w, h = (data[6] | data[7] << 8) & 0x3FFF, (data[8] | data[9] << 8) & 0x3FFF
    if bits & 1 or ((bits >> 1) & 7) > 3 or not (bits >> 4) & 1 or (bits >> 5) >= chunk_size or not w or not h:
        return None
    return w, h


def _parse_header(data: bytes):
    """VP8GetHeaders: the frame, partition 0's reader, the token partitions, the
    per-segment dequantisation factors and the token probabilities."""
    bits = data[0] | data[1] << 8 | data[2] << 16
    part0 = bits >> 5
    f = Frame((data[6] | data[7] << 8) & 0x3FFF, (data[8] | data[9] << 8) & 0x3FFF)
    if part0 > len(data) - 10:
        raise ValueError("VP8: bad partition length")
    br = BoolReader(data[10 : 10 + part0])
    br.bit(128), br.bit(128)  # colour space, clamping type
    f.use_segment = br.bit(128)
    if f.use_segment:
        f.update_map = br.bit(128)
        if br.bit(128):
            f.absolute_delta = br.bit(128)
            f.seg_quant = [br.signed(7) if br.bit(128) else 0 for _ in range(4)]
            f.seg_filter = [br.signed(6) if br.bit(128) else 0 for _ in range(4)]
        if f.update_map:
            f.seg_probs = [br.value_bits(8) if br.bit(128) else 255 for _ in range(3)]
    if br.eof:
        raise ValueError("VP8: cannot parse segment header")
    f.simple, f.level, f.sharpness = br.bit(128), br.value_bits(6), br.value_bits(3)
    f.use_lf_delta = br.bit(128)
    if f.use_lf_delta and br.bit(128):
        for deltas in (f.ref_delta, f.mode_delta):
            for i in range(4):
                if br.bit(128):
                    deltas[i] = br.signed(6)
    if br.eof:
        raise ValueError("VP8: cannot parse filter header")
    rest = data[10 + part0 :]
    last = (1 << br.value_bits(2)) - 1
    if len(rest) < 3 * last:
        raise ValueError("VP8: cannot parse partitions")
    start, left, parts = 3 * last, len(rest) - 3 * last, []
    for p in range(last):
        size = min(rest[3 * p] | rest[3 * p + 1] << 8 | rest[3 * p + 2] << 16, left)
        parts.append(BoolReader(rest[start : start + size]))
        start += size
        left -= size
    if start >= len(rest):
        raise ValueError("VP8: cannot parse partitions (the last one is empty)")
    parts.append(BoolReader(rest[start:]))
    base = br.value_bits(7)
    d = [br.signed(4) if br.bit(128) else 0 for _ in range(5)]  # y1 dc, y2 dc, y2 ac, uv dc, uv ac
    def clip(v, m):
        return 0 if v < 0 else m if v > m else v

    quant = []
    for s in range(4):
        q = f.seg_quant[s] + (0 if f.absolute_delta else base) if f.use_segment else base
        y2_ac = AC_TABLE[clip(q + d[2], 127)] * 101581 >> 16
        quant.append(((DC_TABLE[clip(q + d[0], 127)], AC_TABLE[clip(q, 127)]),
                      (DC_TABLE[clip(q + d[1], 127)] * 2, max(y2_ac, 8)),
                      (DC_TABLE[clip(q + d[3], 117)], AC_TABLE[clip(q + d[4], 127)])))
    br.bit(128)  # refresh entropy probabilities: one key frame, nothing to keep
    probs = np.empty_like(COEFF_PROBS)
    for t in range(4):
        for b in range(8):
            for c in range(3):
                for p in range(11):
                    probs[t, b, c, p] = (br.value_bits(8) if br.bit(int(COEFF_UPDATE_PROBS[t, b, c, p]))
                                         else COEFF_PROBS[t, b, c, p])
    if br.bit(128):
        f.skip_prob = br.value_bits(8)
    # per type, per coefficient position 0..16: the band's three context rows
    bands = [[[probs[t, BANDS[n], c].tolist() for c in range(3)] for n in range(17)] for t in range(4)]
    return f, br, parts, quant, bands


def _large_value(br: BoolReader, p) -> int:  # GetLargeValue
    if not br.bit(p[3]):
        return 2 if not br.bit(p[4]) else 3 + br.bit(p[5])
    if not br.bit(p[6]):
        if not br.bit(p[7]):
            return 5 + br.bit(159)
        v = 7 + 2 * br.bit(165)
        return v + br.bit(145)
    bit1 = br.bit(p[8])
    cat = 2 * bit1 + br.bit(p[9 + bit1])
    v = 0
    for prob in CAT_PROBS[cat]:
        v = v + v + br.bit(prob)
    return v + 3 + (8 << cat)


def _coeffs(br: BoolReader, prob, ctx: int, dq, n: int, out: list, base: int) -> int:
    """GetCoeffs: one block's tokens from position n into out[base:base+16];
    returns the position after the last one read (0..16)."""
    p = prob[n][ctx]
    while n < 16:
        if not br.bit(p[0]):
            return n
        while not br.bit(p[1]):
            n += 1
            if n == 16:
                return 16
            p = prob[n][0]
        nxt = prob[n + 1]
        if not br.bit(p[2]):
            v, p = 1, nxt[1]
        else:
            v, p = _large_value(br, p), nxt[2]
        out[base + ZIGZAG[n]] = _int16((-v if br.bit(128) else v) * dq[n > 0])
        n += 1
    return 16


def _int16(v: int) -> int:  # libwebp keeps coefficients in int16_t
    return ((v + 32768) & 0xFFFF) - 32768


def _wht(dc: list) -> list:  # TransformWHT: the 16 Y blocks' DC values
    tmp = [0] * 16
    for i in range(4):
        a0, a1 = dc[i] + dc[12 + i], dc[4 + i] + dc[8 + i]
        a2, a3 = dc[4 + i] - dc[8 + i], dc[i] - dc[12 + i]
        tmp[i], tmp[8 + i], tmp[4 + i], tmp[12 + i] = a0 + a1, a0 - a1, a3 + a2, a3 - a2
    out = [0] * 16
    for i in range(4):
        dcv = tmp[4 * i] + 3
        a0, a1 = dcv + tmp[4 * i + 3], tmp[4 * i + 1] + tmp[4 * i + 2]
        a2, a3 = tmp[4 * i + 1] - tmp[4 * i + 2], dcv - tmp[4 * i + 3]
        out[4 * i : 4 * i + 4] = [_int16((a0 + a1) >> 3), _int16((a3 + a2) >> 3), _int16((a0 - a1) >> 3),
                                  _int16((a3 - a2) >> 3)]
    return out


def _parse_modes(br: BoolReader, f: Frame, top: list, left: list):
    """ParseIntraMode: (segment, skip, 16x16 mode or None, 16 sub-block modes, chroma mode)."""
    segment = 0
    if f.update_map:
        segment = 2 + br.bit(f.seg_probs[2]) if br.bit(f.seg_probs[0]) else br.bit(f.seg_probs[1])
    skip = br.bit(f.skip_prob) if f.skip_prob is not None else 0
    if br.bit(145):
        ymode = (B_TM if br.bit(128) else B_HE) if br.bit(156) else (B_VE if br.bit(163) else B_DC)
        top[:] = [ymode] * 4
        left[:] = [ymode] * 4
        sub = None
    else:
        ymode, sub = None, []
        for y in range(4):
            m = left[y]
            for x in range(4):
                p = _BMODES[top[x]][m]
                if not br.bit(p[0]):
                    m = B_DC
                elif not br.bit(p[1]):
                    m = B_TM
                elif not br.bit(p[2]):
                    m = B_VE
                elif not br.bit(p[3]):
                    m = B_HE if not br.bit(p[4]) else (B_RD if not br.bit(p[5]) else B_VR)
                elif not br.bit(p[6]):
                    m = B_LD
                elif not br.bit(p[7]):
                    m = B_VL
                else:
                    m = B_HD if not br.bit(p[8]) else B_HU
                top[x] = m
            sub += top
            left[y] = m
    uv = B_DC if not br.bit(142) else B_VE if not br.bit(114) else (B_TM if br.bit(183) else B_HE)
    return segment, skip, ymode, sub, uv


def _mulhi(x: np.ndarray, k: int) -> np.ndarray:  # _mm_mulhi_epi16
    return ((x.astype(np.int32) * k) >> 16).astype(np.int16)


def _transform_sse2(c: np.ndarray) -> np.ndarray:
    """libwebp's Transform_SSE2 over blocks, every sum wrapping at 16 bits as its lanes do (equal to
    TransformOne for coefficients in VP8's range): int16 [..., 16] -> residuals [..., 4, 4]."""
    c = c.reshape(*c.shape[:-1], 4, 4).astype(np.int16)
    k1, k2 = 20091, -30068  # 20091 / 65536 and 35468 / 65536 - 1

    def butterfly(i0, i1, i2, i3):
        a, b = i0 + i2, i0 - i2
        cc = (i1 - i3) + (_mulhi(i1, k2) - _mulhi(i3, k1))
        d = (i1 + i3) + (_mulhi(i1, k1) + _mulhi(i3, k2))
        return a + d, b + cc, b - cc, a - d

    with np.errstate(over="ignore"):
        cols = np.stack(butterfly(c[..., 0, :], c[..., 1, :], c[..., 2, :], c[..., 3, :]), axis=-1)  # [.., col, k]
        t = [cols[..., j, :] for j in range(4)]
        out = butterfly(t[0] + np.int16(4), t[1], t[2], t[3])
        return np.stack([v >> 3 for v in out], axis=-1).astype(np.int64)  # [..., row, x]


def _transform_ac3(c: np.ndarray) -> np.ndarray:
    """TransformAC3 (C, 32-bit): a block whose coefficients past zigzag position 2 are zero."""
    c = c.astype(np.int64)

    def mul1(a):
        return ((a * 20091) >> 16) + a

    def mul2(a):
        return (a * 35468) >> 16

    a = c[..., 0] + 4
    d1, c1, c4, d4 = mul1(c[..., 1]), mul2(c[..., 1]), mul2(c[..., 4]), mul1(c[..., 4])
    rows = np.stack([a + d4, a + c4, a - c4, a - d4], axis=-1)[..., :, None]
    return (rows + np.stack([d1, c1, -c1, -d1], axis=-1)[..., None, :]) >> 3


def _residuals(coeffs: np.ndarray, codes: np.ndarray) -> np.ndarray:
    """Each block's residual by the transform libwebp's DoTransform picks from its code (3: more than
    three coefficients read, the SSE2 transform; 2: two or three, TransformAC3; 1: the DC alone,
    TransformDC; 0: none): int [n, 16] coefficients -> int [n, 4, 4]."""
    out = np.zeros((len(coeffs), 4, 4), np.int64)
    for code, fn in ((3, _transform_sse2), (2, _transform_ac3)):
        sel = codes == code
        if sel.any():
            out[sel] = fn(coeffs[sel])
    sel = codes == 1
    out[sel] = ((coeffs[sel, 0].astype(np.int64) + 4) >> 3)[:, None, None]
    return out


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _avg2(a, b):
    return (a + b + 1) >> 1


def _pred4(mode: int, top: list, left: list) -> list:
    """A 4x4 sub-block's prediction, rows of 4: top = [X, A..H] (the corner, above, above-right), left = [I..L]."""
    X, A, B, C, D, E, F, G, H = top
    I, J, K, L = left
    if mode == B_DC:
        v = (A + B + C + D + I + J + K + L + 4) >> 3
        return [[v] * 4 for _ in range(4)]
    if mode == B_TM:
        return [[min(255, max(0, left[y] + t - X)) for t in (A, B, C, D)] for y in range(4)]
    if mode == B_VE:
        row = [_avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E)]
        return [row[:] for _ in range(4)]
    if mode == B_HE:
        return [[v] * 4 for v in (_avg3(X, I, J), _avg3(I, J, K), _avg3(J, K, L), _avg3(K, L, L))]
    o = [[0] * 4 for _ in range(4)]  # o[y][x]

    def put(v, *xy):
        for x, y in xy:
            o[y][x] = v

    if mode == B_RD:
        put(_avg3(J, K, L), (0, 3))
        put(_avg3(I, J, K), (1, 3), (0, 2))
        put(_avg3(X, I, J), (2, 3), (1, 2), (0, 1))
        put(_avg3(A, X, I), (3, 3), (2, 2), (1, 1), (0, 0))
        put(_avg3(B, A, X), (3, 2), (2, 1), (1, 0))
        put(_avg3(C, B, A), (3, 1), (2, 0))
        put(_avg3(D, C, B), (3, 0))
    elif mode == B_LD:
        put(_avg3(A, B, C), (0, 0))
        put(_avg3(B, C, D), (1, 0), (0, 1))
        put(_avg3(C, D, E), (2, 0), (1, 1), (0, 2))
        put(_avg3(D, E, F), (3, 0), (2, 1), (1, 2), (0, 3))
        put(_avg3(E, F, G), (3, 1), (2, 2), (1, 3))
        put(_avg3(F, G, H), (3, 2), (2, 3))
        put(_avg3(G, H, H), (3, 3))
    elif mode == B_VR:
        put(_avg2(X, A), (0, 0), (1, 2))
        put(_avg2(A, B), (1, 0), (2, 2))
        put(_avg2(B, C), (2, 0), (3, 2))
        put(_avg2(C, D), (3, 0))
        put(_avg3(K, J, I), (0, 3))
        put(_avg3(J, I, X), (0, 2))
        put(_avg3(I, X, A), (0, 1), (1, 3))
        put(_avg3(X, A, B), (1, 1), (2, 3))
        put(_avg3(A, B, C), (2, 1), (3, 3))
        put(_avg3(B, C, D), (3, 1))
    elif mode == B_VL:
        put(_avg2(A, B), (0, 0))
        put(_avg2(B, C), (1, 0), (0, 2))
        put(_avg2(C, D), (2, 0), (1, 2))
        put(_avg2(D, E), (3, 0), (2, 2))
        put(_avg3(A, B, C), (0, 1))
        put(_avg3(B, C, D), (1, 1), (0, 3))
        put(_avg3(C, D, E), (2, 1), (1, 3))
        put(_avg3(D, E, F), (3, 1), (2, 3))
        put(_avg3(E, F, G), (3, 2))
        put(_avg3(F, G, H), (3, 3))
    elif mode == B_HD:
        put(_avg2(I, X), (0, 0), (2, 1))
        put(_avg2(J, I), (0, 1), (2, 2))
        put(_avg2(K, J), (0, 2), (2, 3))
        put(_avg2(L, K), (0, 3))
        put(_avg3(A, B, C), (3, 0))
        put(_avg3(X, A, B), (2, 0))
        put(_avg3(I, X, A), (1, 0), (3, 1))
        put(_avg3(J, I, X), (1, 1), (3, 2))
        put(_avg3(K, J, I), (1, 2), (3, 3))
        put(_avg3(L, K, J), (1, 3))
    else:  # B_HU
        put(_avg2(I, J), (0, 0))
        put(_avg2(J, K), (2, 0), (0, 1))
        put(_avg2(K, L), (2, 1), (0, 2))
        put(_avg3(I, J, K), (1, 0))
        put(_avg3(J, K, L), (3, 0), (1, 1))
        put(_avg3(K, L, L), (3, 1), (1, 2))
        put(L, (3, 2), (2, 2), (0, 3), (1, 3), (2, 3), (3, 3))
    return o


def _pred_block(mode: int, buf: np.ndarray, size: int, mb_x: int, mb_y: int) -> np.ndarray:
    """16x16 or 8x8 prediction from buf's row 0 (corner, above) and column 0 (left)."""
    top, left, corner = buf[0, 1 : size + 1], buf[1 : size + 1, 0], int(buf[0, 0])
    if mode == B_DC:
        shift = 4 if size == 8 else 5
        if mb_x and mb_y:
            v = (int(top.sum()) + int(left.sum()) + (1 << (shift - 1))) >> shift
        elif mb_x:  # no row above: the left column alone
            v = (int(left.sum()) + (1 << (shift - 2))) >> (shift - 1)
        elif mb_y:  # no column to the left: the row above alone
            v = (int(top.sum()) + (1 << (shift - 2))) >> (shift - 1)
        else:
            v = 128
        return np.full((size, size), v, np.int64)
    if mode == B_TM:
        return np.clip(left[:, None].astype(np.int64) + top[None, :] - corner, 0, 255)
    if mode == B_VE:
        return np.broadcast_to(top[None, :], (size, size)).astype(np.int64)
    return np.broadcast_to(left[:, None], (size, size)).astype(np.int64)


def _reconstruct(f: Frame, mbs: list, residual: np.ndarray):
    """Predict and add the residuals, macroblock by macroblock, over unfiltered pixels."""
    W, H = 16 * f.mb_w, 16 * f.mb_h
    Y = np.zeros((H, W), np.int64)
    UV = [np.zeros((H // 2, W // 2), np.int64) for _ in range(2)]
    for i, (mb_y, mb_x, ymode, sub, uvmode) in enumerate(mbs):
        y0, x0 = 16 * mb_y, 16 * mb_x
        buf = np.zeros((17, 21), np.int64)
        if mb_y == 0:
            buf[0, :] = 127
        else:
            buf[0, 0] = 129 if mb_x == 0 else Y[y0 - 1, x0 - 1]
            buf[0, 1:17] = Y[y0 - 1, x0 : x0 + 16]
            buf[0, 17:21] = Y[y0 - 1, x0 + 15] if mb_x == f.mb_w - 1 else Y[y0 - 1, x0 + 16 : x0 + 20]
        buf[1:, 0] = 129 if mb_x == 0 else Y[y0 : y0 + 16, x0 - 1]
        res = residual[i]
        if ymode is None:
            buf[4, 17:21] = buf[8, 17:21] = buf[12, 17:21] = buf[0, 17:21]
            rows = buf.tolist()
            for n in range(16):
                r, c = 1 + 4 * (n >> 2), 1 + 4 * (n & 3)
                pred = _pred4(sub[n], rows[r - 1][c - 1 : c + 8], [rows[r + k][c - 1] for k in range(4)])
                blk = np.clip(np.array(pred) + res[n], 0, 255).tolist()
                for k in range(4):
                    rows[r + k][c : c + 4] = blk[k]
            buf = np.array(rows)
        else:
            pred = _pred_block(ymode, buf, 16, mb_x, mb_y)
            r16 = res[:16].reshape(4, 4, 4, 4).transpose(0, 2, 1, 3).reshape(16, 16)
            buf[1:17, 1:17] = np.clip(pred + r16, 0, 255)
        Y[y0 : y0 + 16, x0 : x0 + 16] = buf[1:17, 1:17]
        for k, plane in enumerate(UV):
            cy, cx = 8 * mb_y, 8 * mb_x
            cb = np.zeros((9, 9), np.int64)
            if mb_y == 0:
                cb[0, :] = 127
            else:
                cb[0, 0] = 129 if mb_x == 0 else plane[cy - 1, cx - 1]
                cb[0, 1:9] = plane[cy - 1, cx : cx + 8]
            cb[1:, 0] = 129 if mb_x == 0 else plane[cy : cy + 8, cx - 1]
            r8 = res[16 + 4 * k : 20 + 4 * k].reshape(2, 2, 4, 4).transpose(0, 2, 1, 3).reshape(8, 8)
            plane[cy : cy + 8, cx : cx + 8] = np.clip(_pred_block(uvmode, cb, 8, mb_x, mb_y) + r8, 0, 255)
    return Y, UV[0], UV[1]


# --- the loop filter ----------------------------------------------------------


def _filter2(s, p1, p0, q0, q1, m):  # DoFilter2 on the lines where m
    a = 3 * (s[q0] - s[p0]) + np.clip(s[p1] - s[q1], -128, 127)
    a1 = np.clip((a + 4) >> 3, -16, 15)
    a2 = np.clip((a + 3) >> 3, -16, 15)
    s[p0] = np.where(m, np.clip(s[p0] + a2, 0, 255), s[p0])
    s[q0] = np.where(m, np.clip(s[q0] - a1, 0, 255), s[q0])


def _edge(s: np.ndarray, thresh: int, ilevel: int, hev_t: int, mb_edge: bool) -> None:
    """FilterLoop26 (macroblock edge) / FilterLoop24 (inner edge) on s[8, lines]: p3 p2 p1 p0 q0 q1 q2 q3."""
    p3, p2, p1, p0, q0, q1, q2, q3 = s
    t2 = 2 * thresh + 1
    need = (4 * np.abs(p0 - q0) + np.abs(p1 - q1)) <= t2
    for a, b in ((p3, p2), (p2, p1), (p1, p0), (q3, q2), (q2, q1), (q1, q0)):
        need &= np.abs(a - b) <= ilevel
    hev = (np.abs(p1 - p0) > hev_t) | (np.abs(q1 - q0) > hev_t)
    soft = need & ~hev
    if mb_edge:
        a = np.clip(3 * (q0 - p0) + np.clip(p1 - q1, -128, 127), -128, 127)
        a1, a2, a3 = (27 * a + 63) >> 7, (18 * a + 63) >> 7, (9 * a + 63) >> 7
        new = (p2 + a3, p1 + a2, p0 + a1, q0 - a1, q1 - a2, q2 - a3)
        for k, v in zip(range(1, 7), new):
            s[k] = np.where(soft, np.clip(v, 0, 255), s[k])
    else:
        a = 3 * (q0 - p0)
        a1, a2 = np.clip((a + 4) >> 3, -16, 15), np.clip((a + 3) >> 3, -16, 15)
        a3 = (a1 + 1) >> 1
        new = (p1 + a3, p0 + a2, q0 - a1, q1 - a3)
        for k, v in zip(range(2, 6), new):
            s[k] = np.where(soft, np.clip(v, 0, 255), s[k])
    _filter2(s, 2, 3, 4, 5, need & hev)


def _simple_edge(s: np.ndarray, thresh: int) -> None:
    need = (4 * np.abs(s[1] - s[2]) + np.abs(s[0] - s[3])) <= 2 * thresh + 1
    _filter2(s, 0, 1, 2, 3, need)


def _filter_plane_edges(plane, y0, x0, size, left, inner, top, f_limit, ilevel, hev_t, simple):
    """One macroblock's edges of one plane, in libwebp's order."""
    steps = range(4, size, 4)

    def vertical(x, limit, mb_edge):  # an edge between columns x-1 and x, across rows
        if simple:
            s = plane[y0 : y0 + size, x - 2 : x + 2].T.copy()
            _simple_edge(s, limit)
            plane[y0 : y0 + size, x - 2 : x + 2] = s.T
        else:
            s = plane[y0 : y0 + size, x - 4 : x + 4].T.copy()
            _edge(s, limit, ilevel, hev_t, mb_edge)
            plane[y0 : y0 + size, x - 4 : x + 4] = s.T

    def horizontal(y, limit, mb_edge):
        if simple:
            s = plane[y - 2 : y + 2, x0 : x0 + size].copy()
            _simple_edge(s, limit)
            plane[y - 2 : y + 2, x0 : x0 + size] = s
        else:
            s = plane[y - 4 : y + 4, x0 : x0 + size].copy()
            _edge(s, limit, ilevel, hev_t, mb_edge)
            plane[y - 4 : y + 4, x0 : x0 + size] = s

    if left:
        vertical(x0, f_limit + 4, True)
    if inner:
        for k in (steps if size == 16 else (4,)):
            vertical(x0 + k, f_limit, False)
    if top:
        horizontal(y0, f_limit + 4, True)
    if inner:
        for k in (steps if size == 16 else (4,)):
            horizontal(y0 + k, f_limit, False)


def _strengths(f: Frame):
    """PrecomputeFilterStrengths: [segment][is_i4x4] -> (limit, interior limit, hev threshold); limit 0: none."""
    out = []
    for s in range(4):
        base = f.seg_filter[s] + (0 if f.absolute_delta else f.level) if f.use_segment else f.level
        row = []
        for i4 in (0, 1):
            level = base
            if f.use_lf_delta:
                level += f.ref_delta[0] + (f.mode_delta[0] if i4 else 0)
            level = 0 if level < 0 else 63 if level > 63 else level
            if level == 0:
                row.append((0, 0, 0))
                continue
            ilevel = level
            if f.sharpness > 0:
                ilevel >>= 2 if f.sharpness > 4 else 1
                ilevel = min(ilevel, 9 - f.sharpness)
            ilevel = max(ilevel, 1)
            row.append((2 * level + ilevel, ilevel, 2 if level >= 40 else 1 if level >= 15 else 0))
        out.append(row)
    return out


def decode(data: bytes):
    """(Y [H, W], U, V [(H+1)/2, (W+1)/2]) uint8 planes of a VP8 key frame
    (the chunk's payload, pad byte included; `info` accepted it)."""
    f, br, parts, quant, bands = _parse_header(data)
    mbs, coeffs, codes, inner, segs = [], [], [], [], []
    intra_t = [B_DC] * (4 * f.mb_w)
    nz_top, nz_dc_top = [0] * f.mb_w, [0] * f.mb_w
    for mb_y in range(f.mb_h):
        intra_l = [B_DC] * 4
        modes = []
        for mb_x in range(f.mb_w):
            top = intra_t[4 * mb_x : 4 * mb_x + 4]
            modes.append(_parse_modes(br, f, top, intra_l))
            intra_t[4 * mb_x : 4 * mb_x + 4] = top
        if br.eof:
            raise ValueError("VP8: premature end of partition 0")
        tok = parts[mb_y & (len(parts) - 1)]
        nz_left = nz_dc_left = 0
        for mb_x, (segment, skip, ymode, sub, uvmode) in enumerate(modes):
            out = [0] * 384
            code = [0] * 24  # each block's transform (`_residuals`)
            if not skip:
                q_y, q_y2, q_uv = quant[segment]
                tnz, lnz = nz_top[mb_x], nz_left
                if ymode is not None:
                    dc = [0] * 16
                    nz = _coeffs(tok, bands[1], nz_dc_top[mb_x] + nz_dc_left, q_y2, 0, dc, 0)
                    nz_dc_top[mb_x] = nz_dc_left = int(nz > 0)
                    for k, v in enumerate(_wht(dc)):
                        out[16 * k] = v
                    first, ac = 1, bands[0]
                else:
                    first, ac = 0, bands[3]
                t, lft = tnz & 0xF, lnz & 0xF
                for y in range(4):
                    lbit = (lft >> y) & 1
                    for x in range(4):
                        nz = _coeffs(tok, ac, lbit + ((t >> x) & 1), q_y, first, out, 16 * (4 * y + x))
                        lbit = int(nz > first)
                        code[4 * y + x] = 3 if nz > 3 else 2 if nz > 1 else int(out[16 * (4 * y + x)] != 0)
                        t = (t & ~(1 << x)) | (lbit << x)
                    lft = (lft & ~(1 << y)) | (lbit << y)
                new_t, new_l = t, lft
                for ch in (0, 1):
                    t, lft = (tnz >> (4 + 2 * ch)) & 3, (lnz >> (4 + 2 * ch)) & 3
                    for y in range(2):
                        lbit = (lft >> y) & 1
                        for x in range(2):
                            base = 16 * (16 + 4 * ch + 2 * y + x)
                            nz = _coeffs(tok, bands[2], lbit + ((t >> x) & 1), q_uv, 0, out, base)
                            lbit = int(nz > 0)
                            code[16 + 4 * ch + 2 * y + x] = 3 if nz > 3 else 2 if nz > 1 else int(out[base] != 0)
                            t = (t & ~(1 << x)) | (lbit << x)
                        lft = (lft & ~(1 << y)) | (lbit << y)
                    new_t |= t << (4 + 2 * ch)
                    new_l |= lft << (4 + 2 * ch)
                    plane = code[16 + 4 * ch : 20 + 4 * ch]  # TransformUV if any block has AC, else TransformDCUV
                    if max(plane) >= 2:
                        code[16 + 4 * ch : 20 + 4 * ch] = [3] * 4
                nz_top[mb_x], nz_left = new_t, new_l
            else:
                nz_top[mb_x] = nz_left = 0
                if ymode is not None:
                    nz_dc_top[mb_x] = nz_dc_left = 0
            if tok.eof:
                raise ValueError("VP8: premature end of a token partition")
            mbs.append((mb_y, mb_x, ymode, sub, uvmode))
            coeffs.append(out)
            codes.append(code)
            inner.append(ymode is None or any(code))
            segs.append(segment)
    residual = _residuals(np.array(coeffs, np.int64).reshape(-1, 16), np.array(codes).reshape(-1)).reshape(-1, 24, 4, 4)
    Y, U, V = _reconstruct(f, mbs, residual)
    if f.level:
        strengths = _strengths(f)
        for (mb_y, mb_x, ymode, _, _), seg, inn in zip(mbs, segs, inner):
            limit, ilevel, hev_t = strengths[seg][ymode is None]
            if limit == 0:
                continue
            _filter_plane_edges(Y, 16 * mb_y, 16 * mb_x, 16, mb_x > 0, inn, mb_y > 0, limit, ilevel, hev_t, f.simple)
            if not f.simple:
                for plane in (U, V):
                    _filter_plane_edges(plane, 8 * mb_y, 8 * mb_x, 8, mb_x > 0, inn, mb_y > 0, limit, ilevel, hev_t,
                                        False)
    cw, ch = (f.width + 1) // 2, (f.height + 1) // 2
    return (Y[: f.height, : f.width].astype(np.uint8), U[:ch, :cw].astype(np.uint8), V[:ch, :cw].astype(np.uint8))
