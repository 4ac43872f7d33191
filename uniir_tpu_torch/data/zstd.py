"""Zstandard (RFC 8878) decoding as libzstd 1.5.7 does it, without libzstd.

A TIFF strip of compression 50000 is one or more Zstandard frames, which
Pillow's libtiff 4.7 inflates with `ZSTD_decompressStream` (tif_zstd.c's
ZSTDDecode).  This module is the port's decoder of them, in two readings:

  * `decompress(data)` is `ZSTD_decompress`: every frame of the data in turn
    (skippable frames skipped), the output of each frame independent of the
    others, trailing bytes an error;
  * `decode_stream(data, size)` is ZSTDDecode: `size` bytes streamed out of
    the first frame.  libzstd decodes block by block and stops once the
    output is full (a block that fills it exactly is followed by one more
    block, or the checksum, which are decoded and checked); a frame that
    ends, or data that ends, before the output is full is an error, and so
    are a skippable frame and a second frame, which the stream never reaches
    (libtiff stops when `ZSTD_decompressStream` returns 0).  Where the frame
    gives its content size and the whole frame lies in the data, libzstd
    decodes it in one pass instead (its single-pass shortcut), which checks
    the whole frame.

Both follow libzstd's decoder and its checks, which decide whether damaged
data decodes or fails: the frame header (magic, reserved bit, window
descriptor up to 2^31, dictionary ID -- a frame that names one fails, as
there is no dictionary --, content size, single segment); raw, RLE and
compressed blocks up to min(window, 128 KiB); literals raw, RLE or Huffman
coded in 1 or 4 streams, with a table of direct or FSE-coded weights, or
the last table again; sequences with predefined, RLE, FSE-coded or repeated
tables (FSE_readNCount read as libzstd reads it), the three repeat offsets
and their rules for a literal length of 0, offsets reaching before the
frame's start, bitstreams that must end exactly at their marker bit; the
content size; and the XXH64 checksum.  Huffman streams decode symbol by
symbol; where libzstd would decode four streams with its double-symbol
table (HUF_selectDecoder), its looser test of a stream's last symbol is
kept.  Corrupt or truncated data raises ValueError naming the file.

`csrc/zstd.cuh` is the native twin (host C++, the TIFF decoder's codec on a
CUDA run's host, `uniir_zstd_decompress` in `csrc/tiff.cu`).
"""

from __future__ import annotations

MAGIC = 0xFD2FB528
SKIPPABLE = 0x184D2A50  # skippable frames: this magic with its low 4 bits any value
BLOCK_MAX = 128 * 1024
WINDOW_LOG_MAX = 31
STREAM_WINDOW_MAX = 1 << 27  # ZSTD_decompressStream's default window limit (ZSTD_WINDOWLOG_LIMIT_DEFAULT)

# the sequence codes: baseline and extra bits of each literal-length, match-length and offset code (libzstd's
# OF_base folds RFC 8878's "offset value minus 3" into the baselines)
LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384,
                             32768, 65536]
LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
ML_BASE = [c + 3 for c in range(32)] + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099,
                                        8195, 16387, 32771, 65539]
ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
OF_BASE = [0, 1, 1, 5] + [(1 << c) - 3 for c in range(4, 32)]
OF_BITS = list(range(32))
# the predefined distributions (RFC 8878 3.1.1.3.2.2)
LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1]
              + [-1] * 4, 6)
ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7, 6)
OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2] + [1] * 15 + [-1] * 5, 5)
MAX_LL, MAX_ML, MAX_OF = 35, 52, 31
LL_LOG, ML_LOG, OF_LOG = 9, 9, 8  # the largest tableLog of a coded table

# HUF_selectDecoder's timings: (table time, time per 256 symbols) of the single- and double-symbol decoders by
# the quantised compression ratio
_ALGO_TIME = [((0, 0), (1, 1)), ((0, 0), (1, 1)), ((150, 216), (381, 119)), ((170, 205), (514, 112)),
              ((177, 199), (539, 110)), ((197, 194), (644, 107)), ((221, 192), (735, 107)), ((256, 189), (881, 106)),
              ((359, 188), (1167, 109)), ((582, 187), (1570, 114)), ((688, 187), (1712, 122)),
              ((825, 186), (1965, 136)), ((976, 185), (2131, 150)), ((1180, 186), (2070, 175)),
              ((1377, 185), (1731, 202)), ((1412, 185), (1695, 202))]

M64 = (1 << 64) - 1


class _Corrupt(Exception):
    """An error libzstd returns; the message names it."""


# --- XXH64


_P1, _P2, _P3, _P4, _P5 = (11400714785074694791, 14029467366897019727, 1609587929392839161, 9650029242287828579,
                           2870177450012600261)


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & M64


def _round(acc: int, lane: int) -> int:
    return _rotl((acc + lane * _P2) & M64, 31) * _P1 & M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of `data` (the frame checksum is its low 32 bits)."""
    n, p = len(data), 0
    if n >= 32:
        v = [(seed + _P1 + _P2) & M64, (seed + _P2) & M64, seed, (seed - _P1) & M64]
        words = memoryview(data)[: n - n % 32].cast("Q")
        for i in range(0, len(words), 4):
            v = [_round(v[k], words[i + k]) for k in range(4)]
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12) + _rotl(v[3], 18)) & M64
        for lane in v:
            h = ((h ^ _round(0, lane)) * _P1 + _P4) & M64
        p = n - n % 32
    else:
        h = (seed + _P5) & M64
    h = (h + n) & M64
    while p + 8 <= n:
        h = (_rotl(h ^ _round(0, int.from_bytes(data[p:p + 8], "little")), 27) * _P1 + _P4) & M64
        p += 8
    if p + 4 <= n:
        h = (_rotl(h ^ (int.from_bytes(data[p:p + 4], "little") * _P1 & M64), 23) * _P2 + _P3) & M64
        p += 4
    while p < n:
        h = _rotl(h ^ (data[p] * _P5 & M64), 11) * _P1 & M64
        p += 1
    h ^= h >> 33
    h = h * _P2 & M64
    h ^= h >> 29
    h = h * _P3 & M64
    return h ^ (h >> 32)


# --- bitstreams


class _Backward:
    """A bitstream read from its end (FSE / Huffman streams): the bits below the highest set bit of the last byte,
    most significant first; reading past its start gives zeros.  `pos` is the number of bits not read yet (below
    zero once read past the start, which libzstd's end checks reject)."""

    __slots__ = ("src", "pos")

    def __init__(self, src: bytes):
        if not src:
            raise _Corrupt("empty bitstream")
        if src[-1] == 0:
            raise _Corrupt("bitstream without its end mark")
        self.src = src + b"\0\0\0\0\0"
        self.pos = 8 * (len(src) - 1) + src[-1].bit_length() - 1

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        p = self.pos - n
        self.pos = p
        if p >= 0:
            at = p >> 3
            return (int.from_bytes(self.src[at: at + 5], "little") >> (p & 7)) & ((1 << n) - 1)
        if p + n <= 0:
            return 0
        return (int.from_bytes(self.src[:5], "little") << -p) & ((1 << n) - 1)

    def peek(self, n: int) -> int:
        v = self.read(n)
        self.pos += n
        return v


def read_ncount(src: bytes, max_symbol: int) -> tuple:
    """FSE_readNCount: (normalized counts, tableLog, bytes read) of an FSE table description, read as libzstd
    reads it (a description of fewer than 8 bytes read from a zero-padded copy, and refused if it needed more)."""
    if len(src) < 8:
        norm, log, used = read_ncount(bytes(src) + bytes(8 - len(src)), max_symbol)
        if used > len(src):
            raise _Corrupt("FSE table description past its data")
        return norm, log, used
    buf = bytes(src)
    iend = len(buf)

    def le32(at: int) -> int:
        return int.from_bytes(buf[at: at + 4], "little")

    ip = 0
    bit_stream = le32(0)
    nb_bits = (bit_stream & 0xF) + 5
    if nb_bits > 15:
        raise _Corrupt("FSE tableLog too large")
    table_log = nb_bits
    bit_stream >>= 4
    bit_count = 4
    remaining = (1 << nb_bits) + 1
    threshold = 1 << nb_bits
    nb_bits += 1
    max_sv1 = max_symbol + 1
    norm = [0] * max_sv1
    charnum, previous0 = 0, False

    def advance() -> None:
        nonlocal ip, bit_count, bit_stream
        if ip <= iend - 7 or ip + (bit_count >> 3) <= iend - 4:
            ip += bit_count >> 3
            bit_count &= 7
        else:
            bit_count -= 8 * (iend - 4 - ip)
            bit_count &= 31
            ip = iend - 4
        bit_stream = le32(ip) >> bit_count

    while True:
        if previous0:
            repeats = _ctz((~bit_stream | 0x80000000) & 0xFFFFFFFF) >> 1
            while repeats >= 12:
                charnum += 3 * 12
                if ip <= iend - 7:
                    ip += 3
                else:
                    bit_count -= 8 * (iend - 7 - ip)
                    bit_count &= 31
                    ip = iend - 4
                bit_stream = le32(ip) >> bit_count
                repeats = _ctz((~bit_stream | 0x80000000) & 0xFFFFFFFF) >> 1
            charnum += 3 * repeats
            bit_stream >>= 2 * repeats
            bit_count += 2 * repeats
            charnum += bit_stream & 3
            bit_count += 2
            if charnum >= max_sv1:
                break
            advance()
        mx = (2 * threshold - 1) - remaining
        if (bit_stream & (threshold - 1)) < mx:
            count = bit_stream & (threshold - 1)
            bit_count += nb_bits - 1
        else:
            count = bit_stream & (2 * threshold - 1)
            if count >= threshold:
                count -= mx
            bit_count += nb_bits
        count -= 1
        remaining -= count if count >= 0 else -count
        norm[charnum] = count
        charnum += 1
        previous0 = count == 0
        if remaining < threshold:
            if remaining <= 1:
                break
            nb_bits = remaining.bit_length()
            threshold = 1 << (nb_bits - 1)
        if charnum >= max_sv1:
            break
        advance()
    if remaining != 1:
        raise _Corrupt("FSE table description does not sum up")
    if charnum > max_sv1:
        raise _Corrupt("FSE table description names too many symbols")
    if bit_count > 32:
        raise _Corrupt("FSE table description read past its end")
    ip += (bit_count + 7) >> 3
    return norm[:charnum], table_log, ip


def _ctz(v: int) -> int:
    return (v & -v).bit_length() - 1


def fse_table(norm: list, table_log: int) -> list:
    """The FSE decoding table of normalized counts: (symbol, bits read, next state base) for each state (the
    symbols spread as FSE_buildDTable spreads them, low-probability ones at the top)."""
    size = 1 << table_log
    symbols = [0] * size
    high = size - 1
    nxt = []
    for s, c in enumerate(norm):
        if c == -1:
            symbols[high] = s
            high -= 1
            nxt.append(1)
        else:
            nxt.append(c)
    step, mask, pos = (size >> 1) + (size >> 3) + 3, size - 1, 0
    for s, c in enumerate(norm):
        for _ in range(max(c, 0)):
            symbols[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    if pos != 0:
        raise _Corrupt("FSE table does not cover its states")
    table = []
    for u in range(size):
        s = symbols[u]
        state = nxt[s]
        nxt[s] += 1
        nb = table_log - (state.bit_length() - 1)
        table.append((s, nb, (state << nb) - size))
    return table


# --- Huffman literals


def _huffman_weights(src: bytes) -> tuple:
    """HUF_readStats: (weights of all symbols with the implied last one, tableLog, bytes read)."""
    if not src:
        raise _Corrupt("Huffman table description missing")
    size = src[0]
    if size >= 128:
        n = size - 127
        size = (n + 1) // 2
        if size + 1 > len(src):
            raise _Corrupt("Huffman table description past its data")
        weights = []
        for k in range(0, n, 2):
            b = src[1 + k // 2]
            weights += [b >> 4, b & 15]
        weights = weights[:n]
    else:
        if size + 1 > len(src):
            raise _Corrupt("Huffman table description past its data")
        weights = _fse_weights(src[1: 1 + size])
    if any(w > 12 for w in weights):
        raise _Corrupt("Huffman weight above 12")
    total = sum((1 << w) >> 1 for w in weights)
    if total == 0:
        raise _Corrupt("Huffman weights all zero")
    table_log = total.bit_length()
    if table_log > 12:
        raise _Corrupt("Huffman tableLog above 12")
    rest = (1 << table_log) - total
    if rest & (rest - 1):
        raise _Corrupt("Huffman weights leave no power of 2")
    weights.append(rest.bit_length())
    ones = weights.count(1)
    if ones < 2 or ones & 1:
        raise _Corrupt("Huffman weights: an odd count of the longest codes")
    return weights, table_log, size + 1


def _fse_weights(src: bytes) -> list:
    """FSE_decompress_wksp of the Huffman weights (tableLog at most 6, at most 255 weights): two states
    interleaved until the bitstream is used up, then the other state's symbol."""
    norm, log, used = read_ncount(src, 255)
    if log > 6:
        raise _Corrupt("Huffman weights' FSE tableLog above 6")
    table = fse_table(norm, log)
    bits = _Backward(src[used:])
    s1, s2 = bits.read(log), bits.read(log)
    if bits.pos < 0:
        raise _Corrupt("Huffman weights' bitstream too short")
    out = []
    states = [s1, s2]
    k = 0
    while True:
        if len(out) > 253:
            raise _Corrupt("too many Huffman weights")
        sym, nb, base = table[states[k]]
        out.append(sym)
        states[k] = base + bits.read(nb)
        if bits.pos < 0:
            out.append(table[states[1 - k]][0])
            return out
        k = 1 - k


class HuffmanTable:
    """A literals table: per tableLog-bit window the symbol and its code length; `double`: whether libzstd
    built its double-symbol table (HUF_selectDecoder), whose window is 11 bits (12 for a 12-bit table)."""

    __slots__ = ("log", "sym", "nbits", "double")

    def __init__(self, weights: list, log: int, double: bool):
        self.log, self.double = log, double
        size = 1 << log
        self.sym, self.nbits = [0] * size, [0] * size
        rank_start, start = {}, 0
        for w in range(1, log + 1):
            rank_start[w] = start
            start += weights.count(w) << (w - 1)
        for s, w in enumerate(weights):
            if w == 0:
                continue
            at = rank_start[w]
            for u in range(at, at + (1 << (w - 1))):
                self.sym[u], self.nbits[u] = s, log + 1 - w
            rank_start[w] = at + (1 << (w - 1))

    def decode(self, src: bytes, count: int) -> bytes:
        """`count` symbols of one stream, which must end exactly at its marker.  The double-symbol decoder reads
        two symbols a window where both codes fit in it, and when one symbol is left, HUF_decodeLastSymbolX2
        skips the bits of the whole entry it finds and cuts the skip at the stream's end: a stream whose last
        symbol ends anywhere within that entry (or that was used up before it, the symbol then read from libzstd's
        stale bit container) passes."""
        bits = _Backward(src)
        log, sym, nbits, s = self.log, self.sym, self.nbits, bits.src
        mask = (1 << log) - 1
        out = bytearray(count)
        lens = [0] * count if self.double else None
        left = 0
        for i in range(count):
            left = p = bits.pos
            p -= log
            if p >= 0:
                v = (int.from_bytes(s[p >> 3: (p >> 3) + 3], "little") >> (p & 7)) & mask
            else:
                v = bits.peek(log)
            out[i] = sym[v]
            bits.pos = left - nbits[v]
            if lens is not None:
                lens[i] = nbits[v]
        if self.double and count:
            window = 12 if log == 12 else 11
            i = 0
            while i < count - 1:
                i += 2 if lens[i] + lens[i + 1] <= window else 1
            if i == count - 1:
                if left == 0:
                    c = int.from_bytes(src[:8], "little")
                    v = c >> (64 - log)  # a stream under 8 bytes has zeros at the container's top
                    n1 = nbits[v]
                    v2 = ((c << n1) & M64) >> (64 - log)
                else:
                    bits.pos = left
                    v = bits.peek(log)
                    n1 = nbits[v]
                    bits.pos = left - n1
                    v2 = bits.peek(log)
                out[count - 1] = sym[v]
                n2 = nbits[v2]
                if n1 + n2 > window:
                    ok = left == n1
                else:
                    ok = 0 <= left <= n1 + n2
                if not ok:
                    raise _Corrupt("Huffman stream does not end at its marker")
                return bytes(out)
        if bits.pos != 0:
            raise _Corrupt("Huffman stream does not end at its marker")
        return bytes(out)


def _select_double(dst_size: int, src_size: int) -> bool:
    """HUF_selectDecoder: whether libzstd decodes four streams with its double-symbol table."""
    q = 15 if src_size >= dst_size else src_size * 16 // dst_size
    d256 = dst_size >> 8
    t0 = _ALGO_TIME[q][0][0] + _ALGO_TIME[q][0][1] * d256
    t1 = _ALGO_TIME[q][1][0] + _ALGO_TIME[q][1][1] * d256
    t1 += t1 >> 5
    return t1 < t0


def _window(buf: bytes, pos: int, n: int, stale: int) -> int:
    """n bits [pos - n, pos) of a literals buffer read from its end, as libzstd's bit container gives them once
    it holds the buffer's first 8 bytes (`stale`): zeros below bit 0, and where every bit was read (pos <= 0) the
    container's shifted-round top bits."""
    p = pos - n
    if p >= 0:
        at = p >> 3
        return (int.from_bytes(buf[at: at + 5], "little") >> (p & 7)) & ((1 << n) - 1)
    if pos > 0:
        return (int.from_bytes(buf[:5], "little") << -p) & ((1 << n) - 1)
    return ((stale << ((64 - pos) & 63)) & M64) >> (64 - n)


def _fast(table: HuffmanTable, src: bytes, count: int, lengths: tuple) -> bytes:
    """libzstd's fast four-stream decoder (HUF_decompress4X{1,2}_usingDTable_internal_fast, x86-64 with BMI2):
    each stream read from its end down through the bytes before it (the earlier streams and the jump table), all
    four in lock step while each has 7 bytes of input and 5 (10) symbols of output to spare, then each finished
    alone with the buffer's start as its floor.  No stream has to end at its marker: the only check is that the
    lock-step loop read no more than 8 bytes below a stream's start."""
    log, sym, nbits, double = table.log, table.sym, table.nbits, table.double
    shift = 11 - log  # the 11-bit window's first symbol is decided by its top `log` bits
    stale = int.from_bytes(src[:8], "little")
    starts = [6, 6 + lengths[0], 6 + lengths[0] + lengths[1], 6 + lengths[0] + lengths[1] + lengths[2]]
    ends = starts[1:] + [len(src)]
    seg = (count + 3) // 4
    segs = [seg, seg, seg, count - 3 * seg]
    pos, ip = [], []
    for s in range(4):
        last = src[ends[s] - 1]
        pos.append(8 * (ends[s] - 1) + last.bit_length() - 1 if last else 8 * ends[s])
        ip.append(ends[s] - 8)
    outs = [bytearray() for _ in range(4)]

    def lookup(s: int, room: int) -> None:
        """One table lookup of stream s: one symbol, or two where both codes fit in the window (and room)."""
        w = _window(src, pos[s], 11, stale)
        v = w >> shift
        n1 = nbits[v]
        outs[s].append(sym[v])
        if double and room >= 2:
            v2 = ((w << n1) & 0x7FF) >> shift
            n2 = nbits[v2]
            if n1 + n2 <= 11:
                outs[s].append(sym[v2])
                pos[s] -= n1 + n2
                return
        pos[s] -= n1

    while True:
        if double:
            iters = min([ip[0] // 7] + [(segs[s] - len(outs[s])) // 10 for s in range(4)])
        else:
            iters = min(ip[0] // 7, (segs[3] - len(outs[3])) // 5)
        if iters == 0 or ip[1] < ip[0] or ip[2] < ip[1] or ip[3] < ip[2]:
            break
        olimit = len(outs[3]) + 5 * iters
        while True:
            for s in range(4):
                for _ in range(5):
                    lookup(s, 2)
                ip[s] = -(-pos[s] // 8) - 8
            if len(outs[3]) >= olimit:
                break
    for s in range(4):
        if ip[s] < starts[s] - 8:
            raise _Corrupt("Huffman stream read past its neighbour")
        while len(outs[s]) < segs[s]:
            left = segs[s] - len(outs[s])
            if double and left == 1:  # HUF_decodeLastSymbolX2: one symbol of the entry
                w = _window(src, pos[s], 11, stale)
                outs[s].append(sym[w >> shift])
                break
            lookup(s, left)
    return b"".join(outs)


def decode_streams(table: HuffmanTable, src: bytes, count: int, four: bool) -> bytes:
    """The literals of one or four Huffman streams (a 6-byte jump table before four): through libzstd's fast
    decoder where it takes them (a table of at most 11 bits, each stream at least 8 bytes, output for the
    fourth), else stream by stream."""
    if not four:
        return table.decode(src, count)
    if len(src) < 10:
        raise _Corrupt("four Huffman streams in fewer than 10 bytes")
    l1, l2, l3 = (int.from_bytes(src[k: k + 2], "little") for k in (0, 2, 4))
    l4 = len(src) - 6 - l1 - l2 - l3
    seg = (count + 3) // 4
    if count and table.log <= 11 and min(l1, l2, l3, l4) >= 8 and 3 * seg < count:
        return _fast(table, src, count, (l1, l2, l3, l4))
    if l4 < 0:
        raise _Corrupt("Huffman jump table past its data")
    if 3 * seg > count:
        raise _Corrupt("too few literals for four streams")
    at, out = 6, []
    for length, n in zip((l1, l2, l3, l4), (seg, seg, seg, count - 3 * seg)):
        out.append(table.decode(src[at: at + length], n))
        at += length
    return b"".join(out)


# --- blocks


_PREDEFINED = {}


def _predefined(kind: int) -> tuple:
    """(table, log) of the predefined distribution of LL (0), OF (1) or ML (2)."""
    if kind not in _PREDEFINED:
        norm, log = (LL_DEFAULT, OF_DEFAULT, ML_DEFAULT)[kind]
        _PREDEFINED[kind] = (fse_table(norm, log), log)
    return _PREDEFINED[kind]


class _Context:
    """What one frame's blocks share (ZSTD_decompressBegin resets it for each frame): the block size limit,
    the repeat offsets, the last Huffman table (litEntropy) and the last sequence tables (fseEntropy)."""

    __slots__ = ("block_max", "rep", "huffman", "tables")

    def __init__(self, block_max: int):
        self.block_max, self.rep, self.huffman, self.tables = block_max, [1, 4, 8], None, None


def _literals(ctx: _Context, src: bytes, room: int) -> tuple:
    """ZSTD_decodeLiteralsBlock: (literals, bytes read)."""
    if len(src) < 2:
        raise _Corrupt("block too short for its literals")
    kind, fmt = src[0] & 3, (src[0] >> 2) & 3
    limit = min(ctx.block_max, room)
    if kind >= 2:  # Huffman coded, or coded with the last table (3)
        if kind == 3 and ctx.huffman is None:
            raise _Corrupt("treeless literals without an earlier Huffman table")
        if len(src) < 5:
            raise _Corrupt("block too short for its literals header")
        lhc = int.from_bytes(src[:4], "little")
        if fmt < 2:
            lh, size, csize = 3, (lhc >> 4) & 0x3FF, (lhc >> 14) & 0x3FF
        elif fmt == 2:
            lh, size, csize = 4, (lhc >> 4) & 0x3FFF, lhc >> 18
        else:
            lh, size, csize = 5, (lhc >> 4) & 0x3FFFF, (lhc >> 22) + (src[4] << 10)
        four = fmt != 0
        if size > ctx.block_max:
            raise _Corrupt("literals larger than a block")
        if four and size < 6:
            raise _Corrupt("fewer than 6 literals in four streams")
        if csize + lh > len(src):
            raise _Corrupt("literals past the block's end")
        if limit < size:
            raise _Corrupt("literals larger than the output")
        data = src[lh: lh + csize]
        if kind == 3:
            return decode_streams(ctx.huffman, data, size, four), lh + csize
        if four and (size == 0 or csize == 0):
            raise _Corrupt("empty Huffman literals")
        weights, log, used = _huffman_weights(data)
        if used >= csize:
            raise _Corrupt("Huffman table fills the literals")
        table = HuffmanTable(weights, log, four and _select_double(size, csize))
        ctx.huffman = table
        return decode_streams(table, data[used:], size, four), lh + csize
    if fmt == 1:
        lh, size = 2, int.from_bytes(src[:2], "little") >> 4
    elif fmt == 3:
        if len(src) < (3 if kind == 0 else 4):
            raise _Corrupt("block too short for its literals header")
        lh, size = 3, int.from_bytes(src[:3], "little") >> 4
    else:
        lh, size = 1, src[0] >> 3
    if kind == 1 and fmt == 1 and len(src) < 3:
        raise _Corrupt("block too short for its literals header")
    if size > ctx.block_max:
        raise _Corrupt("literals larger than a block")
    if limit < size:
        raise _Corrupt("literals larger than the output")
    if kind == 1:
        return bytes([src[lh]]) * size, lh + 1
    if lh + size > len(src):
        raise _Corrupt("literals past the block's end")
    return src[lh: lh + size], lh + size


def _sequence_tables(ctx: _Context, src: bytes) -> tuple:
    """ZSTD_decodeSeqHeaders: (number of sequences, bytes read, the LL / OF / ML tables as (table, log))."""
    if not src:
        raise _Corrupt("block without its sequences section")
    nb, ip = src[0], 1
    if nb > 0x7F:
        if nb == 0xFF:
            if ip + 2 > len(src):
                raise _Corrupt("sequences header past the block's end")
            nb, ip = int.from_bytes(src[1:3], "little") + 0x7F00, 3
        else:
            if ip >= len(src):
                raise _Corrupt("sequences header past the block's end")
            nb, ip = ((nb - 0x80) << 8) + src[1], 2
    if nb == 0:
        if ip != len(src):
            raise _Corrupt("data after an empty sequences section")
        return 0, ip, None
    if ip + 1 > len(src):
        raise _Corrupt("sequences header past the block's end")
    modes = src[ip]
    if modes & 3:
        raise _Corrupt("reserved bits of the sequence modes set")
    ip += 1
    tables = []
    for k, (shift, top, max_log, base) in enumerate(((6, MAX_LL, LL_LOG, LL_BASE), (4, MAX_OF, OF_LOG, OF_BASE),
                                                      (2, MAX_ML, ML_LOG, ML_BASE))):
        mode = (modes >> shift) & 3
        if mode == 0:
            tables.append(_predefined(k))
        elif mode == 1:
            if ip >= len(src):
                raise _Corrupt("RLE sequence code past the block's end")
            if src[ip] > top:
                raise _Corrupt("RLE sequence code out of range")
            tables.append(([(src[ip], 0, 0)], 0))
            ip += 1
        elif mode == 2:
            norm, log, used = read_ncount(src[ip:], top)
            if log > max_log:
                raise _Corrupt("sequence table's tableLog too large")
            tables.append((fse_table(norm, log), log))
            ip += used
        else:
            if ctx.tables is None:
                raise _Corrupt("repeated sequence table without an earlier one")
            tables.append(ctx.tables[k])
    return nb, ip, tables


def _block(ctx: _Context, src: bytes, out: bytearray, start: int, room: int) -> None:
    """One compressed block appended to `out` (the frame's output begins at `start`), at most `room` bytes."""
    if len(src) > ctx.block_max:
        raise _Corrupt("compressed block larger than the block size limit")
    lits, used = _literals(ctx, src, room)
    nb, used2, tables = _sequence_tables(ctx, src[used:])
    at0 = len(out)
    if nb:
        ctx.tables = tables
        (llt, llog), (oft, olog), (mlt, mlog) = tables
        bits = _Backward(src[used + used2:])
        sll, sof, sml = bits.read(llog), bits.read(olog), bits.read(mlog)
        rep = list(ctx.rep)
        lp = 0
        for i in range(nb):
            lsym, lnb, lnext = llt[sll]
            osym, onb, onext = oft[sof]
            msym, mnb, mnext = mlt[sml]
            of_bits = OF_BITS[osym]
            ll0 = lsym == 0
            if of_bits > 1:
                offset = OF_BASE[osym] + bits.read(of_bits)
                rep[2], rep[1], rep[0] = rep[1], rep[0], offset
            elif of_bits == 0:
                offset = rep[1] if ll0 else rep[0]
                rep[1] = rep[0] if ll0 else rep[1]
                rep[0] = offset
            else:
                idx = 1 + ll0 + bits.read(1)
                temp = ((rep[0] - 1) & M64) if idx == 3 else rep[idx]
                if temp == 0:
                    temp = M64  # 0 is no offset: libzstd makes it one that fails below
                if idx != 1:
                    rep[2] = rep[1]
                rep[1], rep[0] = rep[0], temp
                offset = temp
            ml = ML_BASE[msym] + bits.read(ML_BITS[msym])
            ll = LL_BASE[lsym] + bits.read(LL_BITS[lsym])
            if i != nb - 1:
                sll = lnext + bits.read(lnb)
                sml = mnext + bits.read(mnb)
                sof = onext + bits.read(onb)
            if ll + ml > room - (len(out) - at0):
                raise _Corrupt("a sequence past the output's end")
            if ll > len(lits) - lp:
                raise _Corrupt("a sequence reads past its literals")
            out += lits[lp: lp + ll]
            lp += ll
            if offset > len(out) - start:
                raise _Corrupt("an offset before the frame's start")
            at = len(out) - offset
            if offset >= ml:
                out += out[at: at + ml]
            else:
                piece = out[at:]
                out += (piece * (ml // offset + 1))[:ml]
        if bits.pos != 0:
            raise _Corrupt("sequences bitstream does not end at its marker")
        ctx.rep = rep
        lits = lits[lp:]
    if len(lits) > room - (len(out) - at0):
        raise _Corrupt("literals past the output's end")
    out += lits
    if len(out) - at0 > ctx.block_max:
        raise _Corrupt("decompressed block larger than the block size limit")


# --- frames


class Header:
    """A frame header: its size in bytes, window size, block size limit, content size (None: not given),
    checksum flag and dictionary ID."""

    __slots__ = ("size", "window", "block_max", "content", "checksum", "dict_id")


def _header_size(data: bytes, at: int) -> int:
    fhd = data[at + 4]
    single = (fhd >> 5) & 1
    return 5 + (not single) + (0, 1, 2, 4)[fhd & 3] + (0, 2, 4, 8)[fhd >> 6] + (single and not fhd >> 6)


def _header(data: bytes, at: int) -> Header:
    """ZSTD_getFrameHeader of the complete header at `at`."""
    fhd = data[at + 4]
    if fhd & 0x08:
        raise _Corrupt("reserved bit of the frame header set")
    h = Header()
    h.size = _header_size(data, at)
    pos = at + 5
    single = (fhd >> 5) & 1
    window = 0
    if not single:
        wl = data[pos]
        pos += 1
        log = (wl >> 3) + 10
        if log > WINDOW_LOG_MAX:
            raise _Corrupt("window too large")
        window = (1 << log) + ((1 << log) >> 3) * (wl & 7)
    did = (0, 1, 2, 4)[fhd & 3]
    h.dict_id = int.from_bytes(data[pos: pos + did], "little")
    pos += did
    fcs = fhd >> 6
    if fcs == 0:
        h.content = data[pos] if single else None
    elif fcs == 1:
        h.content = int.from_bytes(data[pos: pos + 2], "little") + 256
    else:
        h.content = int.from_bytes(data[pos: pos + (4 if fcs == 2 else 8)], "little")
    if single:
        window = h.content
    h.window, h.block_max = window, min(window, BLOCK_MAX)
    h.checksum = (fhd >> 2) & 1
    return h


def _frame(data: bytes, at: int, out: bytearray, capacity: int) -> int:
    """ZSTD_decompressFrame: one frame at `at` appended to `out` (at most `capacity` bytes in all); the offset past
    it."""
    n = len(data)
    if n - at < 9:
        raise _Corrupt("frame too short")
    if int.from_bytes(data[at: at + 4], "little") != MAGIC:
        raise _Corrupt("unknown frame magic")
    size = _header_size(data, at)
    if n - at < size + 3:
        raise _Corrupt("frame header past the data's end")
    h = _header(data, at)
    if h.dict_id:
        raise _Corrupt("frame needs a dictionary")
    ctx = _Context(h.block_max)
    start, p = len(out), at + size
    while True:
        if n - p < 3:
            raise _Corrupt("block header past the data's end")
        bh = int.from_bytes(data[p: p + 3], "little")
        last, kind, bsize = bh & 1, (bh >> 1) & 3, bh >> 3
        p += 3
        if kind == 3:
            raise _Corrupt("reserved block type")
        csize = 1 if kind == 1 else bsize
        if csize > n - p:
            raise _Corrupt("block past the data's end")
        room = capacity - len(out)
        if kind == 2:
            _block(ctx, data[p: p + csize], out, start, room)
        elif bsize > room:
            raise _Corrupt("block past the output's end")
        else:
            out += data[p: p + bsize] if kind == 0 else bytes([data[p]]) * bsize
        p += csize
        if last:
            break
    if h.content is not None and len(out) - start != h.content:
        raise _Corrupt("frame content size differs from its header")
    if h.checksum:
        if n - p < 4:
            raise _Corrupt("checksum past the data's end")
        if int.from_bytes(data[p: p + 4], "little") != xxh64(bytes(out[start:])) & 0xFFFFFFFF:
            raise _Corrupt("checksum mismatch")
        p += 4
    return p


def _frames(data: bytes, capacity: int) -> bytes:
    out, at, n = bytearray(), 0, len(data)
    while n - at >= 5:
        magic = int.from_bytes(data[at: at + 4], "little")
        if magic & 0xFFFFFFF0 == SKIPPABLE:
            if n - at < 8:
                raise _Corrupt("skippable frame header past the data's end")
            skip = int.from_bytes(data[at + 4: at + 8], "little") + 8
            if skip > 0xFFFFFFFF or skip > n - at:
                raise _Corrupt("skippable frame past the data's end")
            at += skip
            continue
        at = _frame(data, at, out, capacity)
    if at != n:
        raise _Corrupt("data after the last frame")
    return bytes(out)


def decompress(data: bytes, capacity: int = 1 << 62, name: str = "<bytes>") -> bytes:
    """`ZSTD_decompress(dst, capacity, data)`: every frame's content in turn (module docstring)."""
    try:
        return _frames(bytes(data), capacity)
    except _Corrupt as err:
        raise ValueError(f"{name}: corrupt ZSTD data ({err})") from None


def _stream(data: bytes, size: int) -> bytes:
    """What ZSTDDecode's loop of ZSTD_decompressStream calls writes into a buffer of `size` bytes."""
    n = len(data)
    if n < 5:
        head = data + MAGIC.to_bytes(4, "little")[n:] if n < 4 else data[:4]
        head2 = data + SKIPPABLE.to_bytes(4, "little")[n:] if n < 4 else data[:4]
        if n and int.from_bytes(head[:4], "little") != MAGIC and (
                int.from_bytes(head2[:4], "little") & 0xFFFFFFF0) != SKIPPABLE:
            raise _Corrupt("unknown frame magic")
        return b""
    magic = int.from_bytes(data[:4], "little")
    if magic & 0xFFFFFFF0 == SKIPPABLE:
        return b""  # skipped, and the stream reports the frame's end
    if magic != MAGIC:
        raise _Corrupt("unknown frame magic")
    if n < _header_size(data, 0):
        return b""
    h = _header(data, 0)
    if h.content is not None and size >= h.content:  # libzstd's single-pass shortcut, when the frame is all there
        total = _frame_extent(data, h)
        if total is not None:
            out = bytearray()
            _frame(data[:total], 0, out, size)
            return bytes(out)
    if h.dict_id:
        raise _Corrupt("frame needs a dictionary")
    if max(h.window, 1024) > STREAM_WINDOW_MAX:
        raise _Corrupt("window larger than the streaming limit")
    ctx = _Context(h.block_max)
    frame, flushed, p = bytearray(), 0, h.size
    while True:
        if n - p < 3:
            return bytes(frame[:flushed])
        bh = int.from_bytes(data[p: p + 3], "little")
        last, kind, bsize = bh & 1, (bh >> 1) & 3, bh >> 3
        if kind == 3:
            raise _Corrupt("reserved block type")
        csize = 1 if kind == 1 else bsize
        if csize > h.block_max:
            raise _Corrupt("block larger than the block size limit")
        p += 3
        before = len(frame)
        if csize:
            if kind == 0:
                take = min(csize, n - p)
                if take == 0:
                    return bytes(frame[:flushed])
                frame += data[p: p + take]
                p += take
                if take < csize:  # the rest of a raw block never comes
                    return bytes(frame[: min(len(frame), size)])
            else:
                if n - p < csize:
                    return bytes(frame[:flushed])
                if kind == 1:
                    if bsize > h.block_max:
                        raise _Corrupt("RLE block larger than the block size limit")
                    frame += bytes([data[p]]) * bsize
                else:
                    _block(ctx, data[p: p + csize], frame, 0, h.block_max)
                p += csize
            if last and h.content is not None and len(frame) != h.content:
                raise _Corrupt("frame content size differs from its header")
        take = min(size - flushed, len(frame) - before)
        flushed += take
        if take < len(frame) - before:
            return bytes(frame[:flushed])
        if last:
            break
    if h.checksum:
        if n - p < 4:
            return bytes(frame[:flushed])
        if int.from_bytes(data[p: p + 4], "little") != xxh64(bytes(frame)) & 0xFFFFFFFF:
            raise _Corrupt("checksum mismatch")
    return bytes(frame[:flushed])


def _frame_extent(data: bytes, h: Header):
    """ZSTD_findFrameCompressedSize: the frame's bytes, or None where its blocks or checksum run past the data."""
    n, p = len(data), h.size
    while True:
        if n - p < 3:
            return None
        bh = int.from_bytes(data[p: p + 3], "little")
        if (bh >> 1) & 3 == 3:
            return None
        csize = 1 if (bh >> 1) & 3 == 1 else bh >> 3
        if 3 + csize > n - p:
            return None
        p += 3 + csize
        if bh & 1:
            break
    if h.checksum:
        if n - p < 4:
            return None
        p += 4
    return p


def decode_stream(data: bytes, size: int, name: str = "<bytes>") -> bytes:
    """libtiff's ZSTDDecode of one strip or tile into `size` bytes (module docstring).  Its one call of
    ZSTD_decompressStream either fails, which reports no output, or stops where the data ends: what a failure
    leaves is zeros from the output position on (ChunkError)."""
    from uniir_tpu_torch.data.tiff import ChunkError

    try:
        out = _stream(bytes(data), size)
    except _Corrupt as err:  # the one call's progress is not reported: ZSTDDecode zeroes all it asked for
        raise ChunkError(f"{name}: corrupt ZSTD data ({err})", bytes(size)) from None
    if len(out) < size:
        raise ChunkError(f"{name}: ZSTD stream ends before the strip is full (not enough data)",
                         out + bytes(size - len(out)))
    return out


# --- the native decoder (csrc/zstd.cuh, in the TIFF library)


def _native(data: bytes, capacity: int, stream: int, name: str) -> bytes:
    import ctypes

    from uniir_tpu_torch import _build

    lib = _build.load("tiff")
    data = bytes(data)
    out = ctypes.create_string_buffer(max(capacity, 1))
    size = ctypes.c_size_t(0)
    err = ctypes.create_string_buffer(256)
    if lib.uniir_zstd_decompress(data, len(data), out, capacity, stream, ctypes.byref(size), err, len(err)) != 0:
        if stream:  # ZSTDDecode zeroes all it asked for (`decode_stream`)
            from uniir_tpu_torch.data.tiff import ChunkError

            raise ChunkError(f"{name}: {err.value.decode()}", bytes(capacity))
        raise ValueError(f"{name}: {err.value.decode()}")
    return out.raw[: size.value]


def decompress_native(data: bytes, capacity: int, name: str = "<bytes>") -> bytes:
    """`decompress` through csrc/zstd.cuh (host C++ in the TIFF library, built on first use)."""
    return _native(data, capacity, 0, name)


def decode_stream_native(data: bytes, size: int, name: str = "<bytes>") -> bytes:
    """`decode_stream` through csrc/zstd.cuh, failing as it does (ChunkError with what the call leaves)."""
    from uniir_tpu_torch.data.tiff import ChunkError

    out = _native(data, size, 1, name)
    if len(out) < size:
        raise ChunkError(f"{name}: ZSTD stream ends before the strip is full (not enough data)",
                         out + bytes(size - len(out)))
    return out
