"""The VP8L lossless bitstream (RFC 9649 sections 3-5), read as libwebp 1.6
reads it: the lossless half of `data.webp`, and the coder of its alpha
planes.

  * the header: the signature byte 0x2f, 14-bit width - 1 and height - 1,
    the alpha hint and a 3-bit version that must be 0;
  * the transforms, each at most once, undone in the reverse order of
    reading: the predictor (14 modes a tile, modes 14 and 15 black; the
    top-left pixel black, the rest of the first row from the left, the
    first column from above, the top-right of the last column the row's
    first pixel; per-byte arithmetic mod 256), the cross-colour transform
    (green-to-red, green-to-blue and red-to-blue deltas `(s8 * s8) >> 5`,
    red-to-blue on the decoded red), subtract-green, and colour indexing
    (a delta-coded palette; at <= 16 colours 2 / 4 / 8 indices a byte,
    which narrows the coded width; an index past the palette is 0);
  * the entropy image: a meta-Huffman image of group indices (red and green
    bytes) over tiles of 2^(2..9) pixels, and five prefix codes a group
    (green + length + cache, red, blue, alpha, distance), each group read
    up to the largest index whether a tile uses it or not;
  * prefix codes: simple (one or two symbols, the first in 1 or 8 bits, a
    symbol past the alphabet ignored) or normal (code-length codes in the
    order 17, 18, 0, 1, ..., an optional count of lengths to read, repeat
    codes 16 / 17 / 18, 16 repeating the last non-zero length, which starts
    at 8); one used symbol is a code that reads no bits; otherwise the code
    must be complete, or the stream is refused;
  * LZ77 copies with the 120-entry distance map (a distance below 1 taken
    as 1) and the colour cache (`0x1e35a7bd * argb >> (32 - bits)`, 1-11
    bits), a copy before the start or past the end refused;
  * libwebp's bit reader to the bit: the bytes past the end read as zeros,
    and a stream that read past its end is refused, save that an alpha
    plane coded through colour indexing alone (libwebp's 8-bit path) may
    end inside its last symbol.

Anything libwebp refuses raises ValueError; the caller names the file.
The C++ decoder in `csrc/webp.cu` holds the same function.
"""

from __future__ import annotations

import numpy as np

MAGIC = 0x2F
NUM_LITERAL = 256
NUM_LENGTH = 24
NUM_DIST = 40
MAX_CACHE_BITS = 11
ALPHABET = (NUM_LITERAL + NUM_LENGTH, 256, 256, 256, NUM_DIST)  # green, red, blue, alpha, distance
CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
# distance codes 1..120 -> (dy << 4) | (8 - dx) of the short-distance map (libwebp's kCodeToPlane)
CODE_TO_PLANE = bytes([
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1A, 0x26, 0x2A, 0x38, 0x05, 0x37, 0x39, 0x15, 0x1B,
    0x36, 0x3A, 0x25, 0x2B, 0x48, 0x04, 0x47, 0x49, 0x14, 0x1C, 0x35, 0x3B, 0x46, 0x4A, 0x24, 0x2C, 0x58, 0x45,
    0x4B, 0x34, 0x3C, 0x03, 0x57, 0x59, 0x13, 0x1D, 0x56, 0x5A, 0x23, 0x2D, 0x44, 0x4C, 0x55, 0x5B, 0x33, 0x3D,
    0x68, 0x02, 0x67, 0x69, 0x12, 0x1E, 0x66, 0x6A, 0x22, 0x2E, 0x54, 0x5C, 0x43, 0x4D, 0x65, 0x6B, 0x32, 0x3E,
    0x78, 0x01, 0x77, 0x79, 0x53, 0x5D, 0x11, 0x1F, 0x64, 0x6C, 0x42, 0x4E, 0x76, 0x7A, 0x21, 0x2F, 0x75, 0x7B,
    0x31, 0x3F, 0x63, 0x6D, 0x52, 0x5E, 0x00, 0x74, 0x7C, 0x41, 0x4F, 0x10, 0x20, 0x62, 0x6E, 0x30, 0x73, 0x7D,
    0x51, 0x5F, 0x40, 0x72, 0x7E, 0x61, 0x6F, 0x50, 0x71, 0x7F, 0x60, 0x70,
])
PREDICTOR, CROSS_COLOR, SUBTRACT_GREEN, COLOR_INDEXING = range(4)
ROOT_BITS = 8  # libwebp's HUFFMAN_TABLE_BITS: longer codes go through a second-level table
LENGTHS_ROOT_BITS = 7


class BitReader:
    """libwebp's VP8LBitReader: a 64-bit window `val` over the bytes, `bit_pos`
    bits of it consumed.  Past the end it reads zeros; once a read has gone
    past the end, `eos` is set and the window is read from its bottom again."""

    __slots__ = ("buf", "n", "pos", "val", "bit_pos", "eos")

    def __init__(self, data: bytes):
        self.buf, self.n = data, len(data)
        k = min(8, self.n)
        self.val = int.from_bytes(data[:k], "little")
        self.pos, self.bit_pos, self.eos = k, 0, False

    def at_end(self) -> bool:  # VP8LIsEndOfStream
        return self.eos or (self.pos == self.n and self.bit_pos > 64)

    def _shift(self) -> None:  # ShiftBytes
        while self.bit_pos >= 8 and self.pos < self.n:
            self.val = (self.val >> 8) | (self.buf[self.pos] << 56)
            self.pos += 1
            self.bit_pos -= 8
        if self.at_end():
            self.eos, self.bit_pos = True, 0

    def read(self, nbits: int) -> int:  # VP8LReadBits
        if self.eos:
            self.bit_pos = 0
            return 0
        v = (self.val >> (self.bit_pos & 63)) & ((1 << nbits) - 1)
        self.bit_pos += nbits
        self._shift()
        return v

    def fill(self) -> None:  # VP8LFillBitWindow
        if self.bit_pos >= 32:
            self._shift()


def _reverse(code: int, length: int) -> int:
    return int(format(code, f"0{length}b")[::-1], 2) if length else 0


def build_table(lengths, root_bits: int = ROOT_BITS):
    """The decoding table of a prefix code given each symbol's length, as
    libwebp's BuildHuffmanTable lays it out (a root of 2^root_bits entries
    (bits, symbol), a longer code's entry (root_bits + sub-table bits, index
    of its sub-table)), with its sub-tables; None where libwebp refuses the
    lengths (no symbol, or two or more that are not a complete code)."""
    used = sorted((ln, s) for s, ln in enumerate(lengths) if ln)
    size = 1 << root_bits
    if not used:
        return None
    if len(used) == 1:
        return [(0, used[0][1])] * size, []
    if sum(1 << (15 - ln) for ln, _ in used) != 1 << 15:
        return None
    root: list = [None] * size
    long_codes: dict = {}
    code, prev = 0, used[0][0]
    for ln, s in used:
        code <<= ln - prev
        prev = ln
        rev = _reverse(code, ln)
        if ln <= root_bits:
            for k in range(rev, size, 1 << ln):
                root[k] = (ln, s)
        else:
            long_codes.setdefault(rev & (size - 1), []).append((ln - root_bits, rev >> root_bits, s))
        code += 1
    subs = []
    for key, codes in long_codes.items():
        bits = max(ln for ln, _, _ in codes)
        sub: list = [None] * (1 << bits)
        for ln, rest, s in codes:
            for k in range(rest, 1 << bits, 1 << ln):
                sub[k] = (ln, s)
        root[key] = (root_bits + bits, len(subs))
        subs.append(sub)
    return root, subs


def read_symbol(table, br: BitReader) -> int:  # ReadSymbol
    root, subs = table
    val = br.val >> (br.bit_pos & 63)
    bits, value = root[val & 0xFF]
    if bits > ROOT_BITS:
        br.bit_pos += ROOT_BITS
        val = br.val >> (br.bit_pos & 63)
        bits, value = subs[value][val & ((1 << (bits - ROOT_BITS)) - 1)]
    br.bit_pos += bits
    return value


def _read_code_lengths(br: BitReader, cl_lengths, num_symbols: int) -> list:
    """ReadHuffmanCodeLengths: the symbols' code lengths through the code-length code."""
    table = build_table(cl_lengths, LENGTHS_ROOT_BITS)
    if table is None:
        raise ValueError("VP8L: invalid code-length code")
    root = table[0]
    if br.read(1):
        max_symbol = 2 + br.read(2 + 2 * br.read(3))
        if max_symbol > num_symbols:
            raise ValueError("VP8L: code-length count past the alphabet")
    else:
        max_symbol = num_symbols
    lengths = [0] * num_symbols
    symbol, prev = 0, 8
    while symbol < num_symbols:
        if max_symbol == 0:
            break
        max_symbol -= 1
        br.fill()
        bits, ln = root[(br.val >> (br.bit_pos & 63)) & 0x7F]
        br.bit_pos += bits
        if ln < 16:
            lengths[symbol] = ln
            symbol += 1
            if ln:
                prev = ln
        else:
            extra, offset = ((2, 3), (3, 3), (7, 11))[ln - 16]
            repeat = br.read(extra) + offset
            if symbol + repeat > num_symbols:
                raise ValueError("VP8L: code-length repeat past the alphabet")
            value = prev if ln == 16 else 0
            lengths[symbol : symbol + repeat] = [value] * repeat
            symbol += repeat
    return lengths


def read_code(br: BitReader, alphabet: int):
    """ReadHuffmanCode: one prefix code of the alphabet, (table, lengths)."""
    if br.read(1):  # simple code
        lengths = [0] * alphabet
        two = br.read(1)
        first = br.read(8 if br.read(1) else 1)
        if first < alphabet:
            lengths[first] = 1
        if two:
            second = br.read(8)
            if second < alphabet:
                lengths[second] = 1
    else:
        cl_lengths = [0] * 19
        for i in range(br.read(4) + 4):
            cl_lengths[CODE_LENGTH_ORDER[i]] = br.read(3)
        lengths = _read_code_lengths(br, cl_lengths, alphabet)
    table = None if br.eos else build_table(lengths)
    if table is None:
        raise ValueError("VP8L: invalid prefix code")
    return table, lengths


class Group:
    """One meta-Huffman group: its five tables, and libwebp's shortcuts
    (red / blue / alpha of one symbol each: a literal reads green alone; all
    five of one symbol and green a literal: a pixel reads no bits)."""

    __slots__ = ("tables", "trivial_literal", "literal", "trivial_code", "one_symbol")

    def __init__(self, tables):
        self.tables = tables
        self.one_symbol = [t[0][0][0] == 0 for t in tables]
        g, r, b, a = (t[0][0][1] for t in tables[:4])
        self.trivial_literal = all(self.one_symbol[1:4])
        self.literal = (a << 24) | (r << 16) | b
        self.trivial_code = all(self.one_symbol) and g < NUM_LITERAL
        if self.trivial_code:
            self.literal |= g << 8


def subsample(size: int, bits: int) -> int:
    return (size + (1 << bits) - 1) >> bits


def _prefix_value(symbol: int, br: BitReader) -> int:  # GetCopyDistance / GetCopyLength
    if symbol < 4:
        return symbol + 1
    extra = (symbol - 2) >> 1
    return ((2 + (symbol & 1)) << extra) + br.read(extra) + 1


def plane_to_distance(xsize: int, code: int) -> int:
    if code > 120:
        return code - 120
    d = CODE_TO_PLANE[code - 1]
    dist = (d >> 4) * xsize + 8 - (d & 0xF)
    return dist if dist >= 1 else 1


def _read_codes(br: BitReader, xsize: int, ysize: int, cache_bits: int, allow_meta: bool):
    """ReadHuffmanCodes: the entropy image (or None) and the groups."""
    meta = None
    num_groups = 1
    if allow_meta and br.read(1):
        bits = 2 + br.read(3)
        mx, my = subsample(xsize, bits), subsample(ysize, bits)
        image = decode_image_stream(br, mx, my, False)
        index = [(p >> 8) & 0xFFFF for p in image]
        num_groups = max(index) + 1
        meta = (bits, mx, index)
    if br.eos:
        raise ValueError("VP8L: stream ends in its entropy image")
    groups = []
    for _ in range(num_groups):
        tables = []
        for j in range(5):
            alphabet = ALPHABET[j] + ((1 << cache_bits) if j == 0 and cache_bits else 0)
            tables.append(read_code(br, alphabet)[0])
        groups.append(Group(tables))
    return meta, groups


def _read_cache_bits(br: BitReader) -> int:
    if not br.read(1):
        return 0
    bits = br.read(4)
    if not 1 <= bits <= MAX_CACHE_BITS:
        raise ValueError(f"VP8L: colour cache of {bits} bits")
    return bits


def decode_pixels(br: BitReader, width: int, height: int, meta, groups, cache_bits: int) -> list:
    """DecodeImageData: width * height ARGB ints (libwebp's 32-bit path)."""
    data = [0] * (width * height)
    end = width * height
    pos = col = row = 0
    cache = [0] * (1 << cache_bits) if cache_bits else None
    shift = 32 - cache_bits
    cached = 0  # pixels [0, cached) are in the cache: libwebp inserts them all before a lookup
    if meta is not None:
        mbits, mxsize, mindex = meta
    group = groups[0]
    while pos < end:
        if meta is not None:
            group = groups[mindex[(row >> mbits) * mxsize + (col >> mbits)]]
        if group.trivial_code:
            code = -1
            data[pos] = group.literal
        else:
            tables = group.tables
            br.fill()
            code = read_symbol(tables[0], br)
            if br.at_end():
                break
        if code < NUM_LITERAL:
            if code >= 0:
                if group.trivial_literal:
                    data[pos] = group.literal | (code << 8)
                else:
                    red = read_symbol(tables[1], br)
                    br.fill()
                    blue = read_symbol(tables[2], br)
                    alpha = read_symbol(tables[3], br)
                    if br.at_end():
                        break
                    data[pos] = (alpha << 24) | (red << 16) | (code << 8) | blue
            pos += 1
            col += 1
            if col >= width:
                col = 0
                row += 1
        elif code < NUM_LITERAL + NUM_LENGTH:
            length = _prefix_value(code - NUM_LITERAL, br)
            dist_symbol = read_symbol(tables[4], br)
            br.fill()
            dist = plane_to_distance(width, _prefix_value(dist_symbol, br))
            if br.at_end():
                break
            if pos < dist or end - pos < length:
                raise ValueError("VP8L: backward reference outside the image")
            for k in range(pos, pos + length):
                data[k] = data[k - dist]
            pos += length
            col += length
            while col >= width:
                col -= width
                row += 1
        else:
            if cache is None:
                raise ValueError("VP8L: colour cache code without a cache")
            while cached < pos:
                p = data[cached]
                cache[((p * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = p
                cached += 1
            data[pos] = cache[code - NUM_LITERAL - NUM_LENGTH]
            pos += 1
            col += 1
            if col >= width:
                col = 0
                row += 1
    if br.at_end():
        raise ValueError("VP8L: stream ends before the image")
    return data


def decode_alpha8(br: BitReader, width: int, height: int, meta, groups) -> list:
    """DecodeAlphaData: libwebp's 8-bit path for an alpha plane coded through
    colour indexing alone (no cache; red, blue and alpha of one symbol): the
    indices as green bytes; the stream may end inside the last symbol."""
    data = [0] * (width * height)
    end = width * height
    pos = col = row = 0
    if meta is not None:
        mbits, mxsize, mindex = meta
    group = groups[0]
    while not br.eos and pos < end:
        if meta is not None:
            group = groups[mindex[(row >> mbits) * mxsize + (col >> mbits)]]
        tables = group.tables
        br.fill()
        code = read_symbol(tables[0], br)
        if code < NUM_LITERAL:
            data[pos] = code << 8
            pos += 1
            col += 1
            if col >= width:
                col = 0
                row += 1
        elif code < NUM_LITERAL + NUM_LENGTH:
            length = _prefix_value(code - NUM_LITERAL, br)
            dist_symbol = read_symbol(tables[4], br)
            br.fill()
            dist = plane_to_distance(width, _prefix_value(dist_symbol, br))
            if not (pos >= dist and end - pos >= length):
                raise ValueError("VP8L: backward reference outside the alpha plane")
            for k in range(pos, pos + length):
                data[k] = data[k - dist]
            pos += length
            col += length
            while col >= width:
                col -= width
                row += 1
        else:
            raise ValueError("VP8L: invalid alpha code")
        br.eos = br.at_end()
    if br.at_end() and pos < end:
        raise ValueError("VP8L: alpha stream ends before the plane")
    return data


def decode_image_stream(br: BitReader, xsize: int, ysize: int, level0: bool, transforms=None):
    """DecodeImageStream.  A sub-image (entropy or transform image) is decoded
    here and returned as a list of ARGB ints; at level 0 the transforms are
    appended to `transforms` and (coded width, meta, groups, cache bits) is
    returned for the caller to decode the pixels."""
    if level0:
        seen = set()
        while br.read(1):
            kind = br.read(2)
            if kind in seen:
                raise ValueError("VP8L: a transform used twice")
            seen.add(kind)
            if kind in (PREDICTOR, CROSS_COLOR):
                bits = br.read(3) + 2
                image = decode_image_stream(br, subsample(xsize, bits), subsample(ysize, bits), False)
                transforms.append((kind, xsize, ysize, bits, image))
            elif kind == COLOR_INDEXING:
                num_colors = br.read(8) + 1
                bits = 0 if num_colors > 16 else 1 if num_colors > 4 else 2 if num_colors > 2 else 3
                palette = decode_image_stream(br, num_colors, 1, False)
                transforms.append((kind, xsize, ysize, bits, _expand_palette(palette, bits)))
                xsize = subsample(xsize, bits)
            else:
                transforms.append((kind, xsize, ysize, 0, None))
    cache_bits = _read_cache_bits(br)
    meta, groups = _read_codes(br, xsize, ysize, cache_bits, level0)
    if level0:
        return xsize, meta, groups, cache_bits
    data = decode_pixels(br, xsize, ysize, meta, groups, cache_bits)
    if br.eos:
        raise ValueError("VP8L: stream ends in a sub-image")
    return data


def _expand_palette(palette: list, bits: int) -> np.ndarray:
    """ExpandColorMap: the delta-coded palette summed byte-wise, zeros past it."""
    final = 1 << (8 >> bits)
    raw = np.zeros((max(final, len(palette)), 4), np.uint8)
    raw[: len(palette)] = np.array(palette, np.uint32).view(np.uint8).reshape(-1, 4)
    raw[: len(palette)] = np.cumsum(raw[: len(palette)], axis=0, dtype=np.uint8)
    return raw[:final].copy().view(np.uint32).reshape(-1)


def _add(a: int, b: int) -> int:  # VP8LAddPixels
    return (((a & 0xFF00FF00) + (b & 0xFF00FF00)) & 0xFF00FF00) | (((a & 0x00FF00FF) + (b & 0x00FF00FF)) & 0x00FF00FF)


def _avg2(a: int, b: int) -> int:
    return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)


def _clip255(v: int) -> int:
    return 0 if v < 0 else 255 if v > 255 else v


def _select(t: int, left: int, tl: int) -> int:
    d = 0
    for s in (24, 16, 8, 0):
        a, b, c = (t >> s) & 0xFF, (left >> s) & 0xFF, (tl >> s) & 0xFF
        d += abs(b - c) - abs(a - c)
    return t if d <= 0 else left


def _full(left: int, t: int, tl: int) -> int:
    out = 0
    for s in (24, 16, 8, 0):
        out |= _clip255(((left >> s) & 0xFF) + ((t >> s) & 0xFF) - ((tl >> s) & 0xFF)) << s
    return out


def _half(left: int, t: int, tl: int) -> int:
    avg, out = _avg2(left, t), 0
    for s in (24, 16, 8, 0):
        a, b = (avg >> s) & 0xFF, (tl >> s) & 0xFF
        d = a - b
        out |= _clip255(a + (abs(d) // 2 if d >= 0 else -(abs(d) // 2))) << s
    return out


def _predict(mode: int, left: int, t: int, tr: int, tl: int) -> int:
    if mode == 1:
        return left
    if mode == 2:
        return t
    if mode == 3:
        return tr
    if mode == 4:
        return tl
    if mode == 5:
        return _avg2(_avg2(left, tr), t)
    if mode == 6:
        return _avg2(left, tl)
    if mode == 7:
        return _avg2(left, t)
    if mode == 8:
        return _avg2(tl, t)
    if mode == 9:
        return _avg2(t, tr)
    if mode == 10:
        return _avg2(_avg2(left, tl), _avg2(t, tr))
    if mode == 11:
        return _select(t, left, tl)
    if mode == 12:
        return _full(left, t, tl)
    if mode == 13:
        return _half(left, t, tl)
    return 0xFF000000  # modes 0, 14 and 15


def _inverse_predictor(pix: list, width: int, height: int, bits: int, image: list) -> list:
    tiles = subsample(width, bits)
    out = pix[:]
    out[0] = _add(out[0], 0xFF000000)
    for x in range(1, width):
        out[x] = _add(out[x], out[x - 1])
    for y in range(1, height):
        row, up = y * width, (y - 1) * width
        out[row] = _add(out[row], out[up])
        modes = [(image[(y >> bits) * tiles + (x >> bits)] >> 8) & 0xF for x in range(width)]
        for x in range(1, width):
            tr = out[up + x + 1] if x + 1 < width else out[row]
            out[row + x] = _add(out[row + x], _predict(modes[x], out[row + x - 1], out[up + x], tr, out[up + x - 1]))
    return out


def _inverse_cross_color(argb: np.ndarray, width: int, height: int, bits: int, image: list) -> np.ndarray:
    tiles = np.array(image, np.uint32).reshape(subsample(height, bits), subsample(width, bits))
    code = np.repeat(np.repeat(tiles, 1 << bits, axis=0), 1 << bits, axis=1)[:height, :width].reshape(-1)
    g2r = (code & 0xFF).astype(np.uint8).view(np.int8).astype(np.int32)
    g2b = ((code >> 8) & 0xFF).astype(np.uint8).view(np.int8).astype(np.int32)
    r2b = ((code >> 16) & 0xFF).astype(np.uint8).view(np.int8).astype(np.int32)
    green = ((argb >> 8) & 0xFF).astype(np.uint8).view(np.int8).astype(np.int32)
    red = (((argb >> 16) & 0xFF).astype(np.int32) + ((g2r * green) >> 5)) & 0xFF
    blue = (argb & 0xFF).astype(np.int32) + ((g2b * green) >> 5)
    blue = (blue + ((r2b * red.astype(np.uint8).view(np.int8).astype(np.int32)) >> 5)) & 0xFF
    return (argb & np.uint32(0xFF00FF00)) | (red.astype(np.uint32) << 16) | blue.astype(np.uint32)


def inverse_transforms(pix: list, transforms: list) -> np.ndarray:
    """The transforms undone in the reverse order of reading: uint32 ARGB of
    the last transform's full width (the image's width)."""
    argb = np.array(pix, np.uint32)
    for kind, width, height, bits, image in reversed(transforms):
        if kind == PREDICTOR:
            argb = np.array(_inverse_predictor(argb.tolist(), width, height, bits, image), np.uint32)
        elif kind == CROSS_COLOR:
            argb = _inverse_cross_color(argb, width, height, bits, image)
        elif kind == SUBTRACT_GREEN:
            g = (argb >> 8) & 0xFF
            argb = (argb & np.uint32(0xFF00FF00)) | (((argb >> 16) + g) & 0xFF) << 16 | ((argb + g) & 0xFF)
        else:
            coded = subsample(width, bits)
            idx = ((argb >> 8) & 0xFF).reshape(height, coded)
            if bits:
                per = 1 << bits
                depth = 8 >> bits
                shifts = (np.arange(per) * depth).astype(np.uint32)
                idx = ((idx[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(height, coded * per)[:, :width]
            argb = image[idx.reshape(-1)]
    return argb


def _read_header(data: bytes):
    """A reader past the header and (width, height, alpha hint) (VP8LGetInfo); None where libwebp refuses it."""
    if len(data) < 5 or data[0] != MAGIC or data[4] >> 5:
        return None
    br = BitReader(data)
    br.read(8)
    w, h = br.read(14) + 1, br.read(14) + 1
    alpha = br.read(1)
    if br.read(3) != 0 or br.eos:
        return None
    return br, (w, h, alpha)


def header(data: bytes):
    """(width, height, alpha hint) of a VP8L stream; None where libwebp refuses it."""
    read = _read_header(data)
    return None if read is None else read[1]


def decode(data: bytes) -> np.ndarray:
    """uint8 [H, W, 4] RGBA of a VP8L stream (the chunk's payload, pad byte included)."""
    read = _read_header(data)
    if read is None:
        raise ValueError("VP8L: bad header")
    br, (width, height, _) = read
    transforms: list = []
    xsize, meta, groups, cache_bits = decode_image_stream(br, width, height, True, transforms)
    argb = inverse_transforms(decode_pixels(br, xsize, height, meta, groups, cache_bits), transforms)
    return to_rgba(argb, width, height)


def to_rgba(argb: np.ndarray, width: int, height: int) -> np.ndarray:
    a = argb.reshape(height, width)
    return np.stack([(a >> 16) & 0xFF, (a >> 8) & 0xFF, a & 0xFF, a >> 24], axis=2).astype(np.uint8)


def decode_alpha_plane(data: bytes, width: int, height: int) -> np.ndarray:
    """uint8 [H, W]: the green channel of a headerless VP8L stream of the
    image's size (an ALPH chunk's compression 1), before its filter."""
    br = BitReader(data)
    transforms: list = []
    xsize, meta, groups, cache_bits = decode_image_stream(br, width, height, True, transforms)
    eight_bit = (len(transforms) == 1 and transforms[0][0] == COLOR_INDEXING and cache_bits == 0
                 and all(all(g.one_symbol[1:4]) for g in groups))
    if eight_bit:
        pix = decode_alpha8(br, xsize, height, meta, groups)
    else:
        pix = decode_pixels(br, xsize, height, meta, groups, cache_bits)
    argb = inverse_transforms(pix, transforms)
    return ((argb >> 8) & 0xFF).astype(np.uint8).reshape(height, width)
