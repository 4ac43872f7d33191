"""JPEG encoding with Pillow's bytes, without Pillow.

The JAX package's image pass (`data/preprocessing/io_utils.py`) writes every
image with `img.save(path, "JPEG")`: Pillow 12.1 over libjpeg-turbo 3.1 at
its defaults.  This module writes the same file, byte for byte, from the
uint8 [H, W, 3] RGB array and the source's comment:

  * SOI; APP0 JFIF 1.01, density unit 0, 1:1; a COM marker with the comment
    when there is one (Pillow's `info["comment"]`, which `convert` and
    `resize` carry over); two DQT markers (luma, chroma); SOF0, 8 bits, Y
    sampled 2x2 and Cb / Cr 1x1 (4:2:0); four DHT markers, DC 0, AC 0, DC 1,
    AC 1, with the Annex K tables (not optimised); one interleaved SOS; EOI;
  * `jccolor.c`'s rgb_ycc_convert: fixed point with SCALEBITS 16, Y rounded
    by ONE_HALF, Cb / Cr by ONE_HALF - 1 around CENTERJSAMPLE;
  * `jcprepct.c` / `jcsample.c`: an odd last row repeated at full size,
    `h2v2_downsample` of 2 x 2 sums with the alternating bias 1, 2, 1, 2 (no
    smoothing), the right edge repeated out to whole blocks
    (`expand_right_edge`), the downsampled planes' last row repeated down to
    a whole iMCU (`expand_bottom_edge`);
  * `jccoefct.c`'s dummy blocks: where the luma plane's blocks do not fill
    the last MCU column or row, the missing blocks carry no AC and the
    quantised DC of the block to their left (right edge) or of the MCU's
    top-right block (bottom edge);
  * `jfdctint.c`'s integer DCT (JDCT_ISLOW: CONST_BITS 13, PASS1_BITS 2) of
    the samples less 128, then `jcdctmgr.c`'s quantisation by the divisors
    quantval << 3 through `compute_reciprocal` (16-bit DCTELEM: a
    reciprocal, a correction, a shift);
  * `jcparam.c`'s quality 75: the Annex K tables scaled by 50 %, rounded,
    clamped to 1 ... 255 (baseline);
  * `jchuff.c`'s sequential Huffman coding: DC differences per component,
    AC runs with ZRL and EOB, 0xFF followed by a stuffed 0x00, the last byte
    padded with 1-bits.

A greyscale image never reaches the encoder (the image pass converts to RGB
first), so it writes RGB alone.  Two encoders compute that function:
`encode_twin`, numpy over all blocks at once (the entropy coder too), and
`encode_native`, host C++ in `csrc/jpeg_encode.cu` built by `_build` like
the decoders and called through ctypes.  `encoder_for(device)` picks one by
the run's device, as `jpeg.decoder_for` does.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Callable, Optional

import numpy as np

from uniir_tpu_torch.data.jpeg import ANNEX_K, ZIGZAG

_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
], np.int64)
_CHROMA_Q = np.full(64, 99, np.int64)
_CHROMA_Q[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]

# Annex K Huffman tables: (counts of codes of length 1 ... 16, symbols)
_DC_LUMA, _AC_LUMA, _DC_CHROMA, _AC_CHROMA = (ANNEX_K[(0, 0)], ANNEX_K[(1, 0)], ANNEX_K[(0, 1)], ANNEX_K[(1, 1)])

SCALEBITS, CENTER = 16, 128
ONE_HALF, CBCR_OFFSET = 1 << (SCALEBITS - 1), CENTER << SCALEBITS


def _fix(x: float) -> int:
    return int(x * (1 << SCALEBITS) + 0.5)


# jpeg_add_quant_table at quality 75 (jpeg_quality_scaling: 50 %), force_baseline; natural order
QUANT = tuple(np.clip((basic * 50 + 50) // 100, 1, 255) for basic in (_LUMA_Q, _CHROMA_Q))


def _reciprocals(q: np.ndarray):
    """compute_reciprocal of each divisor q << 3 with a 16-bit DCTELEM:
    (reciprocal, correction, right shift) arrays [64]."""
    recip, corr, shift = [], [], []
    for d in (q << 3).tolist():
        b = d.bit_length() - 1
        r = 16 + b
        fq, fr = divmod(1 << r, d)
        c = d // 2
        if fr == 0:
            fq >>= 1
            r -= 1
        elif fr <= d // 2:
            c += 1
        else:
            fq += 1
        recip.append(fq)
        corr.append(c)
        shift.append(r)
    return np.array(recip, np.int64), np.array(corr, np.int64), np.array(shift, np.int64)


_DIVISORS = tuple(_reciprocals(q) for q in QUANT)


def _code_table(spec) -> tuple:
    """jpeg_make_c_derived_tbl: (code, length) arrays [256] by symbol."""
    counts, symbols = spec
    code, k = 0, 0
    ehufco, ehufsi = np.zeros(256, np.int64), np.zeros(256, np.int64)
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            ehufco[symbols[k]], ehufsi[symbols[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return ehufco, ehufsi


_DC_CODES = (_code_table(_DC_LUMA), _code_table(_DC_CHROMA))
_AC_CODES = (_code_table(_AC_LUMA), _code_table(_AC_CHROMA))


def rgb_to_ycc(rgb: np.ndarray) -> np.ndarray:
    """int64 [3, H, W]: rgb_ycc_convert of uint8 [H, W, 3]."""
    r, g, b = (rgb[..., k].astype(np.int64) for k in range(3))
    y = (_fix(0.299) * r + _fix(0.587) * g + _fix(0.114) * b + ONE_HALF) >> SCALEBITS
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b + CBCR_OFFSET + ONE_HALF - 1) >> SCALEBITS
    cr = (_fix(0.5) * r - _fix(0.41869) * g - _fix(0.08131) * b + CBCR_OFFSET + ONE_HALF - 1) >> SCALEBITS
    return np.stack([y, cb, cr])


def h2v2_downsample(plane: np.ndarray) -> np.ndarray:
    """[2h, 2w] -> [h, w]: 2 x 2 sums plus the bias 1, 2, 1, 2, ... along each row, >> 2."""
    s = plane[0::2, 0::2] + plane[0::2, 1::2] + plane[1::2, 0::2] + plane[1::2, 1::2]
    bias = np.tile(np.array([1, 2], np.int64), s.shape[1] // 2 + 1)[: s.shape[1]]
    return (s + bias) >> 2


# jfdctint.c constants (CONST_BITS 13)
_C = {"0_298631336": 2446, "0_390180644": 3196, "0_541196100": 4433, "0_765366865": 6270, "0_899976223": 7373,
      "1_175875602": 9633, "1_501321110": 12299, "1_847759065": 15137, "1_961570560": 16069,
      "2_053119869": 16819, "2_562915447": 20995, "3_072711026": 25172}
CONST_BITS, PASS1_BITS = 13, 2


def _descale(x, n: int):
    return (x + (1 << (n - 1))) >> n


def _fdct_pass(d: list, even_shift: int, odd_shift: int) -> list:
    """One pass of jpeg_fdct_islow over 8 arrays (the 8 samples of every row
    or column); `even_shift` < 0 means outputs 0 and 4 are shifted left."""
    tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
    tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
    tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
    tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    out = [None] * 8
    if even_shift < 0:
        out[0], out[4] = (tmp10 + tmp11) << -even_shift, (tmp10 - tmp11) << -even_shift
    else:
        out[0], out[4] = _descale(tmp10 + tmp11, even_shift), _descale(tmp10 - tmp11, even_shift)
    z1 = (tmp12 + tmp13) * _C["0_541196100"]
    out[2] = _descale(z1 + tmp13 * _C["0_765366865"], odd_shift)
    out[6] = _descale(z1 + tmp12 * -_C["1_847759065"], odd_shift)
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * _C["1_175875602"]
    tmp4 = tmp4 * _C["0_298631336"]
    tmp5 = tmp5 * _C["2_053119869"]
    tmp6 = tmp6 * _C["3_072711026"]
    tmp7 = tmp7 * _C["1_501321110"]
    z1 = z1 * -_C["0_899976223"]
    z2 = z2 * -_C["2_562915447"]
    z3 = z3 * -_C["1_961570560"] + z5
    z4 = z4 * -_C["0_390180644"] + z5
    out[7] = _descale(tmp4 + z1 + z3, odd_shift)
    out[5] = _descale(tmp5 + z2 + z4, odd_shift)
    out[3] = _descale(tmp6 + z2 + z3, odd_shift)
    out[1] = _descale(tmp7 + z1 + z4, odd_shift)
    return out


def fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """int64 [N, 64] (natural order, scaled by 8) of jpeg_fdct_islow over
    sample blocks [N, 8, 8] (rows, columns) already less CENTERJSAMPLE."""
    rows = _fdct_pass([blocks[:, :, k] for k in range(8)], -PASS1_BITS, CONST_BITS - PASS1_BITS)
    ws = np.stack(rows, axis=2)  # [block, row, u]
    cols = _fdct_pass([ws[:, k, :] for k in range(8)], PASS1_BITS, CONST_BITS + PASS1_BITS)
    return np.stack(cols, axis=1).reshape(-1, 64)  # [block, v, u]


def quantize(coef: np.ndarray, table: int) -> np.ndarray:
    """jcdctmgr.c's quantize of [N, 64] DCT outputs by table 0 (luma) or 1."""
    recip, corr, shift = _DIVISORS[table]
    q = ((np.abs(coef) + corr) * recip) >> shift
    return np.where(coef < 0, -q, q)


def _blocks(plane: np.ndarray) -> np.ndarray:
    """[R * 8, C * 8] -> [R, C, 8, 8]."""
    r, c = plane.shape[0] // 8, plane.shape[1] // 8
    return plane.reshape(r, 8, c, 8).transpose(0, 2, 1, 3)


def coefficients(rgb: np.ndarray):
    """Quantised zigzag coefficients of the scan's blocks: luma [2 mcuy, 2
    mcux, 64] (dummy blocks filled in), Cb and Cr [mcuy, mcux, 64]."""
    h, w = rgb.shape[:2]
    mcux, mcuy = -(-w // 16), -(-h // 16)
    ycc = rgb_to_ycc(rgb)
    # full-size planes: an odd last row repeated, the right edge out to whole MCUs
    full = np.pad(ycc, ((0, 0), (0, h % 2), (0, 16 * mcux - w)), mode="edge")
    luma = np.pad(full[0], ((0, 16 * mcuy - full.shape[1]), (0, 0)), mode="edge")
    out = []
    for c, plane in enumerate([luma] + [h2v2_downsample(full[k]) for k in (1, 2)]):
        if c:
            plane = np.pad(plane, ((0, 8 * mcuy - plane.shape[0]), (0, 0)), mode="edge")
        blocks = _blocks(plane)
        nr, nc = blocks.shape[:2]
        coef = quantize(fdct_islow(blocks.reshape(-1, 8, 8) - CENTER), min(c, 1))
        out.append(coef[:, ZIGZAG].reshape(nr, nc, 64))
    y = out[0]
    wb, hb = -(-w // 8), -(-h // 8)
    if wb < 2 * mcux:  # the right edge's dummy blocks: no AC, the DC of the block to the left
        y[:, wb:] = 0
        y[:, wb, 0] = y[:, wb - 1, 0]
    if hb < 2 * mcuy:  # the bottom's: the DC of the MCU's top-right block
        y[hb:] = 0
        y[hb, :, 0] = np.repeat(y[hb - 1, 1::2, 0], 2)
    return out


def _scan_order(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> tuple:
    """[6 * mcus, 64] blocks in scan order (Y TL, TR, BL, BR, Cb, Cr per MCU) and each one's component."""
    mr, mc = cb.shape[:2]
    ymcu = y.reshape(mr, 2, mc, 2, 64).transpose(0, 2, 1, 3, 4).reshape(mr, mc, 4, 64)
    order = np.concatenate([ymcu, cb[:, :, None], cr[:, :, None]], axis=2).reshape(-1, 64)
    comp = np.tile(np.array([0, 0, 0, 0, 1, 2]), mr * mc)
    return order, comp


def _nbits(v: np.ndarray) -> np.ndarray:
    """Bit length of |v| (0 for 0)."""
    a = np.abs(v)
    n = np.zeros(a.shape, np.int64)
    while (a >> n).any():
        n += (a >> n) > 0
    return n


def _extra(v: np.ndarray, n: np.ndarray) -> np.ndarray:
    """The n low bits jchuff emits after a magnitude category: v, or v - 1 for v < 0."""
    return np.where(v < 0, v - 1, v) & ((1 << n) - 1)


def entropy_code(blocks: np.ndarray, comp: np.ndarray) -> bytes:
    """jchuff.c's encode_one_block over [N, 64] zigzag blocks in scan order:
    the scan's bytes, 0xFF stuffed, padded with 1-bits."""
    n = blocks.shape[0]
    table = np.minimum(comp, 1)
    dc = blocks[:, 0]
    diff = np.empty(n, np.int64)
    for c in range(3):
        sel = comp == c
        d = dc[sel]
        diff[sel] = d - np.concatenate([[0], d[:-1]])
    dc_n = _nbits(diff)
    dc_code = np.where(table == 0, _DC_CODES[0][0][dc_n], _DC_CODES[1][0][dc_n])
    dc_len = np.where(table == 0, _DC_CODES[0][1][dc_n], _DC_CODES[1][1][dc_n])
    dc_val = (dc_code << dc_n) | _extra(diff, dc_n)
    dc_bits = dc_len + dc_n

    bi, k = np.nonzero(blocks[:, 1:])
    k = k + 1
    v = blocks[bi, k]
    first = np.ones(len(bi), bool)
    first[1:] = bi[1:] != bi[:-1]
    prev = np.where(first, 0, np.concatenate([[0], k[:-1]]))
    run = k - prev - 1
    zrl, r = run >> 4, run & 15
    an = _nbits(v)
    sym = (r << 4) | an
    tb = table[bi]
    ac_code = np.where(tb == 0, _AC_CODES[0][0][sym], _AC_CODES[1][0][sym])
    ac_len = np.where(tb == 0, _AC_CODES[0][1][sym], _AC_CODES[1][1][sym])
    ac_val = (ac_code << an) | _extra(v, an)
    ac_bits = ac_len + an
    last = np.full(n, 0, np.int64)
    np.maximum.at(last, bi, k)
    eob = last < 63

    # emissions per block: DC, then each coefficient's ZRLs and symbol, then EOB
    per_ac = zrl + 1
    counts = 1 + np.bincount(bi, weights=per_ac, minlength=n).astype(np.int64) + eob
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    total = int(counts.sum())
    vals = np.empty(total, np.int64)
    lens = np.empty(total, np.int64)
    vals[start], lens[start] = dc_val, dc_bits
    cs = np.cumsum(per_ac)
    group = np.maximum.accumulate(np.where(first, np.arange(len(bi)), 0))
    within = cs - (cs - per_ac)[group]  # a symbol's place after its block's DC
    sym_at = start[bi] + within
    vals[sym_at], lens[sym_at] = ac_val, ac_bits
    z_at = np.repeat(sym_at, zrl) - (np.arange(int(zrl.sum())) - np.repeat(np.cumsum(zrl) - zrl, zrl)) - 1
    zt = np.repeat(tb, zrl)
    vals[z_at] = np.where(zt == 0, _AC_CODES[0][0][0xF0], _AC_CODES[1][0][0xF0])
    lens[z_at] = np.where(zt == 0, _AC_CODES[0][1][0xF0], _AC_CODES[1][1][0xF0])
    e_at = (start + counts - 1)[eob]
    et = table[eob]
    vals[e_at] = np.where(et == 0, _AC_CODES[0][0][0], _AC_CODES[1][0][0])
    lens[e_at] = np.where(et == 0, _AC_CODES[0][1][0], _AC_CODES[1][1][0])
    return _pack(vals, lens)


def _pack(vals: np.ndarray, lens: np.ndarray) -> bytes:
    nbits = int(lens.sum())
    offs = np.repeat(np.cumsum(lens) - lens, lens)
    shift = np.repeat(lens, lens) - 1 - (np.arange(nbits) - offs)
    bits = ((np.repeat(vals, lens) >> shift) & 1).astype(np.uint8)
    bits = np.concatenate([bits, np.ones(-nbits % 8, np.uint8)])
    data = np.packbits(bits)
    ff = np.nonzero(data == 0xFF)[0]
    return np.insert(data, ff + 1, 0).tobytes()


def _segment(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") + payload


def headers(width: int, height: int, comment: Optional[bytes] = None) -> bytes:
    """Every byte before the scan's entropy-coded data."""
    out = b"\xff\xd8" + _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if comment:
        out += _segment(0xFE, comment)
    for t, q in enumerate(QUANT):
        out += _segment(0xDB, bytes([t]) + bytes(q[ZIGZAG].tolist()))
    out += _segment(0xC0, bytes([8]) + height.to_bytes(2, "big") + width.to_bytes(2, "big")
                    + bytes([3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1]))
    for cls, t, (counts, symbols) in ((0, 0, _DC_LUMA), (1, 0, _AC_LUMA), (0, 1, _DC_CHROMA), (1, 1, _AC_CHROMA)):
        out += _segment(0xC4, bytes([cls << 4 | t]) + counts + symbols)
    return out + _segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))


def _check(rgb: np.ndarray, comment) -> tuple:
    rgb = np.ascontiguousarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"the encoder takes uint8 [H, W, 3] RGB, not {rgb.dtype} {list(rgb.shape)}")
    h, w = rgb.shape[:2]
    if not (0 < w <= 65535 and 0 < h <= 65535):
        raise ValueError(f"cannot write a {w} x {h} image as JPEG")
    if isinstance(comment, str):
        comment = comment.encode()  # Pillow's encoder takes a str comment as UTF-8
    # Pillow hands libjpeg a buffer of max(65536, 4 W) bytes, which SOI, APP0 and the whole COM segment must
    # leave a byte of (jpeg_write_marker cannot suspend): a longer comment fails its save
    if comment is not None and len(comment) + 25 > max(65536, 4 * w):
        raise ValueError(f"a comment of {len(comment)} bytes does not fit Pillow's JPEG writer's buffer "
                         "(broken data stream when writing image file)")
    return rgb, comment or None


def encode_twin(rgb: np.ndarray, comment=None) -> bytes:
    """`Image.fromarray(rgb).save(buf, "JPEG", comment=comment)`'s bytes (module docstring)."""
    rgb, comment = _check(rgb, comment)
    y, cb, cr = coefficients(rgb)
    blocks, comp = _scan_order(y, cb, cr)
    return headers(rgb.shape[1], rgb.shape[0], comment) + entropy_code(blocks, comp) + b"\xff\xd9"


# --- the native encoder --------------------------------------------------------


def _max_size(width: int, height: int, comment: Optional[bytes]) -> int:
    """Bytes enough for any image of this size: 64 coefficients of 27 bits a block, every byte stuffed."""
    blocks = 6 * -(-width // 16) * -(-height // 16)
    return 1024 + len(comment or b"") + blocks * 64 * 27 * 2 // 8


def encode_native(rgb: np.ndarray, comment=None) -> bytes:
    """`encode_twin` through csrc/jpeg_encode.cu's host encoder (built on first use)."""
    from uniir_tpu_torch import _build

    lib = _build.load("jpeg_encode")
    rgb, comment = _check(rgb, comment)
    h, w = rgb.shape[:2]
    out = ctypes.create_string_buffer(_max_size(w, h, comment))
    size = ctypes.c_size_t()
    err = ctypes.create_string_buffer(256)
    com = comment or b""
    if lib.uniir_jpeg_encode(rgb.ctypes.data, w, h, com, len(com), out, len(out), ctypes.byref(size), err,
                             len(err)) != 0:
        raise ValueError(f"JPEG encoder: {err.value.decode()}")
    with _calls_lock:
        encode_native.calls += 1
    return out.raw[: size.value]


encode_native.calls = 0  # encodes that went through the native library (read by chip_smoke.py)
_calls_lock = threading.Lock()


def encoder_for(device) -> Callable[..., bytes]:
    """The encoder a run on `device` uses: the native one on a CUDA run's
    host, the twin on a CPU run."""
    from uniir_tpu_torch import _build

    return encode_native if _build.is_cuda(device) else encode_twin
