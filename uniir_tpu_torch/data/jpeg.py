"""Image decoding with Pillow's pixels, without Pillow: JPEG here; PNG
(`data.png`), GIF (`data.gif`), BMP (`data.bmp`), WebP (`data.webp`), TIFF
(`data.tiff`), ICO / CUR (`data.ico`) and Netpbm (`data.netpbm`) picked by
the file's signature in `decode_image` / `read_image`.

M-BEIR stores its images as JPEG files that Pillow wrote, and the JAX
package reads any image with `PIL.Image.open(path).convert("RGB")`, which
runs libjpeg-turbo 3.1 at its defaults for a JPEG file.  This module gives
the same uint8 [H, W, 3] array, bit for bit:

  * jdhuff.c's sequential (SOF0, SOF1) and jdphuff.c's progressive (SOF2)
    Huffman decoding (DC first and refinement scans, AC first scans with EOB
    runs, AC refinement scans, restart intervals in either) into one
    coefficient buffer over all scans, each component's quantisation table
    latched at its first scan as jdinput.c does;
  * jdarith.c's arithmetic decoding (SOF9 sequential, SOF10 progressive):
    the QM coder of T.81 Annex D with jaricom.c's probability table (checked
    against Pillow's libjpeg), DAC conditioning (defaults L = 0, U = 1,
    Kx = 5), the statistics reset at every restart; a bad code (a magnitude
    or spectral overflow) leaves the rest of its restart interval undecoded,
    as libjpeg's ct = -1 does;
  * jdcoefct.c's block smoothing (decompress_smooth_data), which libjpeg
    applies to a progressive image whose scans leave one of zigzag 1-9 not
    final: estimates of those coefficients where zero from the DC values of
    the 5 x 5 block neighbourhood (with DC interpolation, and positions 6-9,
    where no AC coefficient is known), capped by the progression's Al;
    the rows of that neighbourhood as Pillow's libjpeg-turbo reads them
    (`smooth_blocks`, found by probing it);
  * lossless SOF3 (jdlhuff.c, jdlossls.c): Huffman-coded differences, the
    seven predictors and the first row's and first column's, the point
    transform, restarts (a multiple of the MCU row), box upsampling, damaged
    data decoded on as jddiffct.c / jdlhuff.c do; a lossless YCbCr or YCCK
    frame raises, as libjpeg refuses to convert it;
  * the integer IDCT (JDCT_ISLOW: CONST_BITS 13, PASS1_BITS 2) as
    libjpeg-turbo's x86-64 SIMD code computes it (jidctint-sse2 / -avx2,
    which Pillow's wheels run): 16-bit products and sums that wrap, each
    pass packed to 16 bits with saturation, a first-row-only block's
    shortcut, the result saturated around 128 (`idct_islow`); on
    coefficients whose products stay in 8-bit samples' range this is
    jidctint.c's result;
  * fancy upsampling (`jdsample.c`: the triangle filters
    `h2v1_fancy_upsample`, `h1v2_fancy_upsample`, `h2v2_fancy_upsample` with
    their alternating rounding bias, edges replicated; box replication where
    a 2x-wide component is at most 2 samples wide, as libjpeg-turbo does),
    for every component whatever its colour space;
  * the colour space libjpeg's default_decompress_parms picks: 3
    components are YCbCr under a JFIF marker, RGB under an Adobe marker of
    transform 0, YCbCr under any other Adobe transform, and without either
    marker RGB when the component ids are 'R' 'G' 'B', else YCbCr; 4
    components are CMYK under an Adobe marker of transform 0 or without one,
    YCCK under any other transform;
  * `jdcolor.c`'s fixed-point YCbCr -> RGB tables; RGB copied; YCCK turned
    into CMYK by the same tables (C = 255 - R, range-limited, K as stored);
  * Pillow's reading of CMYK: it always takes the samples as Adobe's
    inverted CMYK (raw mode `CMYK;I`, marker or not), and `convert("RGB")`
    is Convert.c's cmyk2rgb, R = K - K * (255 - C) / 255 rounded as MULDIV255
    does (K, C as stored);
  * a greyscale file copied into three channels; no EXIF rotation.

Accepted: SOF0-3, SOF9 and SOF10 at 8 bits, 1, 3 or 4 components, each
component's sampling 1 or 2 times finer in each direction than the largest
(4:4:4, 4:2:2, 4:4:0, 4:2:0), at most 10 blocks in an interleaved scan's MCU
(libjpeg's limit), any DQT / DHT / DAC tables (one between scans holds for
the scans after it; a missing Huffman table 0 or 1 is Annex K's), DRI with
RSTn markers, APPn, COM and DNL segments skipped, several scans.

Damaged data decodes where Pillow 12.1's libjpeg-turbo decodes it with a
warning, to its pixels: bytes between markers skipped (`_next_marker`); a
bad Huffman code read as symbol 0 after 17 bits; DC categories up to 15; a
run past coefficient 63 or a progressive band's end written where it
reaches (`NATURAL`); data that ends at a marker inside a scan read as zeros
to the end of that MCU, the interval's later MCUs left as they are (zero
blocks, or an earlier scan's coefficients); restart markers missing,
repeated or out of order resynchronised as jpeg_resync_to_restart does
(`_scan_segments`); a sequential scan's band and approximation ignored;
block smoothing after a scan cut short as libjpeg-turbo's
last_good_iMCU_row has it; a single-scan file whose markers after its scan
end with the data.  What libjpeg or Pillow's marker walk (`open_header`)
refuses raises ValueError naming the file and the marker: SOF5-7, SOF11
and SOF13-15, 2 components, 12- and 16-bit samples (Pillow: "cannot
handle 12-bit layers"), data that ends before EOI (Pillow: "image file is
truncated"), an unknown marker or a second SOI, frame or (in a single-scan
file) scan, a bad table (the all-ones Huffman code, a DC symbol above 15),
a bad progression.  A damaged lossless (SOF3) scan decodes as jddiffct.c
decodes it, a row of MCUs at a time (`_lossless_planes`).
`decode_samples` gives libjpeg's output before Pillow reads it (the TIFF
decoder's JPEG strips, with libtiff's colour space and, with `libtiff`,
libtiff's leniency past the scan).

Two decoders compute that function: `decode_twin`, plain Python for the
markers and entropy decoding and numpy over all blocks at once for the rest
(the same integer arithmetic), and `decode_native`, host C++ in
`csrc/jpeg.cu` built by `_build` like the kernels and called through ctypes
(which releases the GIL, so the loader's threads decode in parallel).
`decoder_for(device)` picks one by the run's device: the card's host runs
the native decoder, a CPU run the twin; a native library that does not
build or load raises.

`read_image` reads a file by its first bytes, never by its name: JPEG
(FF D8), PNG (the eight-byte PNG signature), GIF (GIF87a / GIF89a), BMP
(BM), WebP (RIFF / WEBP with a first chunk `VP8 `, `VP8L` or `VP8X`, as
Pillow's `_accept` takes it), TIFF (Pillow's six prefixes), ICO / CUR and
Netpbm (P and one of 0-6, f, y) are decoded, and so are the formats of
`_DECODED` (JPEG 2000 among them) found in Image.open's order; the other
formats Pillow's Image.open identifies (EPS, BUFR, ...)
raise `UnsupportedImageFormat`, a ValueError naming the file and the format,
told apart from corrupt data, which raises the decoders' own ValueError, as
does a file no format names ("unknown"), which Image.open cannot identify.

The image pass of the M-BEIR construction needs two more readings of a
file as Pillow opens it: `open_header` walks a JPEG file's markers up to
its first scan as `JpegImageFile._open` does (`is_jpeg`: what
`Image.open(...).format == "JPEG"` says, MPO files excluded), and
`image_comment` finds the `info["comment"]` Pillow's JPEG writer carries
over from a JPEG, GIF or PNG source.
"""

from __future__ import annotations

import ctypes
import functools
import re
import threading
from typing import Callable, NamedTuple

import numpy as np

from uniir_tpu_torch.data import bmp, dds, gif, icns, ico, im, msp, netpbm, pcx, png, psd, qoi, raster, sgi, sun
from uniir_tpu_torch.data import blp, ftex, gbr, imt, jpeg2000, mcidas, pixar, spider, tga, tiff, webp, xbm, xpm
from uniir_tpu_torch.data import avif, fits, fli, iptc, pcd, xvthumb

# natural-order index of each zigzag position
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21,
    28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61,
    54, 47, 55, 62, 63,
], np.int64)
ZIGZAG_LIST = ZIGZAG.tolist()
# jutils.c's jpeg_natural_order with its 16 extra entries: a corrupt run that carries past position 63 (or past
# a progressive band's end) writes its coefficient at the index it reached, 63 for every index past the block
NATURAL = ZIGZAG_LIST + [63] * 16

# The Annex K Huffman tables, (class, id) -> (counts of codes of length 1 ... 16, symbols): what libjpeg-turbo's
# jpeg_std_huff_table puts in place of a table 0 or 1 a scan uses and no DHT defined (Motion-JPEG frames)
ANNEX_K = {
    (0, 0): (bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]), bytes(range(12))),
    (0, 1): (bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]), bytes(range(12))),
    (1, 0): (bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]), bytes.fromhex(
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a161718191a25262728292a3435"
        "363738393a434445464748494a535455565758595a636465666768696a737475767778797a838485868788898a92939495969798"
        "999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4"
        "f5f6f7f8f9fa")),
    (1, 1): (bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]), bytes.fromhex(
        "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434e125f11718191a262728292a"
        "35363738393a434445464748494a535455565758595a636465666768696a737475767778797a82838485868788898a9293949596"
        "9798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4"
        "f5f6f7f8f9fa")),
}

# frame headers decoded: marker -> (progressive, arithmetic, lossless)
_SOF_KINDS = {0xC0: (False, False, False), 0xC1: (False, False, False), 0xC2: (True, False, False),
              0xC3: (False, False, True), 0xC9: (False, True, False), 0xCA: (True, True, False)}
# markers refused, by name
_SOF_NAMES = {
    0xC5: "SOF5 (differential sequential)", 0xC6: "SOF6 (differential progressive)", 0xC7: "SOF7 (differential lossless)",
    0xCB: "SOF11 (arithmetic lossless)", 0xCD: "SOF13 (arithmetic differential sequential)",
    0xCE: "SOF14 (arithmetic differential progressive)", 0xCF: "SOF15 (arithmetic differential lossless)",
    0xC8: "JPG", 0xDC: "DNL",
}
# jaricom.c's jpeg_aritab (T.81 Table D.2), as libjpeg packs it: Qe << 16 | Next_Index_MPS << 8 |
# Switch_MPS << 7 | Next_Index_LPS
ARITAB = [
    0x5A1D0181, 0x2586020E, 0x11140310, 0x080B0412, 0x03D80514, 0x01DA0617, 0x00E50719, 0x006F081C, 0x0036091E,
    0x001A0A21, 0x000D0B23, 0x00060C09, 0x00030D0A, 0x00010D0C, 0x5A7F0F8F, 0x3F251024, 0x2CF21126, 0x207C1227,
    0x17B91328, 0x1182142A, 0x0CEF152B, 0x09A1162D, 0x072F172E, 0x055C1830, 0x04061931, 0x03031A33, 0x02401B34,
    0x01B11C36, 0x01441D38, 0x00F51E39, 0x00B71F3B, 0x008A203C, 0x0068213E, 0x004E223F, 0x003B2320, 0x002C0921,
    0x5AE125A5, 0x484C2640, 0x3A0D2741, 0x2EF12843, 0x261F2944, 0x1F332A45, 0x19A82B46, 0x15182C48, 0x11772D49,
    0x0E742E4A, 0x0BFB2F4B, 0x09F8304D, 0x0861314E, 0x0706324F, 0x05CD3330, 0x04DE3432, 0x040F3532, 0x03633633,
    0x02D43734, 0x025C3835, 0x01F83936, 0x01A43A37, 0x01603B38, 0x01253C39, 0x00F63D3A, 0x00CB3E3B, 0x00AB3F3D,
    0x008F203D, 0x5B1241C1, 0x4D044250, 0x412C4351, 0x37D84452, 0x2FE84553, 0x293C4654, 0x23794756, 0x1EDF4857,
    0x1AA94957, 0x174E4A48, 0x14244B48, 0x119C4C4A, 0x0F6B4D4A, 0x0D514E4B, 0x0BB64F4D, 0x0A40304D, 0x583251D0,
    0x4D1C5258, 0x438E5359, 0x3BDD545A, 0x34EE555B, 0x2EAE565C, 0x299A575D, 0x25164756, 0x557059D8, 0x4CA95A5F,
    0x44D95B60, 0x3E225C61, 0x38245D63, 0x32B45E63, 0x2E17565D, 0x56A860DF, 0x4F466165, 0x47E56266, 0x41CF6367,
    0x3C3D6468, 0x375E5D63, 0x52316669, 0x4C0F676A, 0x4639686B, 0x415E6367, 0x56276AE9, 0x50E76B6C, 0x4B85676D,
    0x55976D6E, 0x504F6B6F, 0x5A106FEE, 0x55226D70, 0x59EB6FF0, 0x5A1D7171,
]


class _Frame:
    """What the markers say: size, components, tables, restart interval, and
    each scan's entropy-coded bytes."""

    def __init__(self):
        self.width = self.height = 0
        self.progressive = False
        self.components = []  # [id, h, v, quant table id]
        self.qt = {}
        self.latched = {}  # component index -> its quantisation table as its first scan found it
        self.huff = {}  # (class, id) -> (counts, symbols) as the last DHT defined it
        self.restart = 0
        self.scans = []  # _Scan
        self.jfif = False
        self.adobe_transform = None
        self.colour = "grey"  # grey, ycbcr, rgb, cmyk or ycck: libjpeg's jpeg_color_space
        self.arith = False  # arithmetic coding (SOF9 / SOF10)
        self.lossless = False  # SOF3
        # DAC conditioning of the 16 arithmetic tables: DC L and U, AC Kx (jdmarker.c get_soi's defaults)
        self.dac = ([0] * 16, [1] * 16, [5] * 16)


class _Scan(NamedTuple):
    """One scan: its components, their DC / AC lookup lists as the scan
    found them (None where the scan reads none; for arithmetic coding the
    table numbers, with the DAC conditioning (L, U, Kx) of each), the
    restart interval, the entropy-coded bytes of each restart interval
    (`_scan_segments`; None: zeros only), and the spectral band and
    successive approximation bits (0, 63, 0, 0 in a sequential frame; the
    predictor, 0, 0 and the point transform in a lossless one)."""

    comps: list
    dc: list
    ac: list
    restart: int
    segments: list
    ss: int
    se: int
    ah: int
    al: int


@functools.lru_cache(maxsize=64)
def _huffman_lut(counts: bytes, symbols: bytes, dc_limit) -> list:
    """65536 entries: (code length << 8) | symbol for every 16-bit window
    that starts with a code of the table; 0 where none does (a bad code).
    None where jdhuff.c's jpeg_make_d_derived_tbl, which libjpeg runs when a
    scan starts using the table, refuses it: a code that does not fit its
    length or the all-ones code used, or a DC table's symbol above `dc_limit`
    (None for an AC table)."""
    if dc_limit is not None and any(sym > dc_limit for sym in symbols):
        return None
    lut = [0] * 65536
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            code += 1
            if code > (1 << length):
                return None
            lo, hi = (code - 1) << (16 - length), code << (16 - length)
            lut[lo:hi] = [(length << 8) | symbols[k]] * (hi - lo)
            k += 1
        if code >= (1 << length):
            return None
        code <<= 1
    return lut


_STUFFING = re.compile(b"\xff+\x00")


def _next_marker(data: bytes, i: int, name: str) -> tuple:
    """jdmarker.c's next_marker from offset i: (code, offset of its first FF, offset past it) of the first
    marker -- an FF, any fill FFs, a byte other than 00 -- skipping any other bytes and FF 00 pairs, as
    libjpeg-turbo skips extraneous data (JWRN_EXTRANEOUS_DATA); ValueError where the data ends first (Pillow's
    decoder asks for more and finds the file truncated)."""
    n = len(data)
    while True:
        j = data.find(b"\xff", i)
        k = j + 1
        while 0 < k < n and data[k] == 0xFF:
            k += 1
        if j < 0 or k >= n:
            raise ValueError(f"{name}: truncated JPEG stream (no EOI marker)")
        if data[k]:
            return data[k], j, k + 1
        i = k + 1


def _scan_segments(data: bytes, start: int, n_intervals: int, name: str) -> tuple:
    """A scan's entropy-coded data as libjpeg-turbo reads it: for each restart interval the unstuffed bytes from
    where it starts to the next marker (past them the decoder reads zeros), or None where the marker found at
    the interval's restart is left unread (the interval then reads zeros only); and (code, offset past it) of
    the marker the scan ends at.  At each restart (jdhuff.c process_restart, jdmarker.c read_restart_marker and
    jpeg_resync_to_restart) the next marker is taken if it is the expected RSTn; otherwise a marker below SOF0 or
    one of the two RSTn before the expected one is discarded and the next marker is looked at, any other marker
    and the next two RSTn are left unread, and the rest (the expected RSTn among them) discarded."""
    segments, marker, pos, expected = [], None, start, 0
    for k in range(n_intervals):
        if k:
            code, after = marker
            if code == 0xD0 + expected:
                marker, pos = None, after
            else:
                while True:
                    rst = 0xD0 <= code <= 0xD7
                    if code < 0xC0 or rst and (code - 0xD0 - expected) % 8 in (6, 7):
                        code, _, after = _next_marker(data, after, name)
                        continue
                    if not rst or (code - 0xD0 - expected) % 8 in (1, 2):
                        marker = (code, after)
                    else:
                        marker, pos = None, after
                    break
            expected = (expected + 1) & 7
        if marker is None:
            code, at, after = _next_marker(data, pos, name)
            segments.append(_STUFFING.sub(b"\xff", data[pos:at]))
            marker = (code, after)
        else:
            segments.append(None)
    return segments, marker


def parse(data: bytes, name: str = "<bytes>", libtiff: bool = False) -> _Frame:
    """The frame of a JPEG file as libjpeg-turbo's marker reader (jdmarker.c read_markers) walks it to EOI:
    bytes between markers skipped, RSTn and TEM outside a scan ignored, a DNL, APPn or COM segment skipped, each
    scan's restart intervals as `_scan_segments` finds them.  ValueError for anything outside the accepted forms
    (module docstring) and where libjpeg stops with an error: a second SOI or frame header, a marker it does not
    know, a second scan in a single-scan file, a bad table or segment, data that ends before EOI.  `libtiff`: as
    libtiff's JPEG codec reads a strip, which ignores any error past a single-scan frame's scan (its
    jpeg_finish_decompress)."""
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{name}: not a JPEG file (no SOI marker)")
    frame, i, n, pending = _Frame(), 2, len(data), None
    multiscan = False  # jdinput.c's has_multiple_scans, set at the first scan
    while True:
        # past a single-scan file's scan, libjpeg reads the markers up to EOI once Pillow has all the rows: data
        # that ends first only suspends it, which Pillow takes as the end (an error still fails the file)
        finished = frame.scans and not multiscan
        try:
            if pending is None:
                try:
                    marker, _, i = _next_marker(data, i, name)
                except ValueError:
                    if finished:
                        break
                    raise
            else:
                (marker, i), pending = pending, None
            if marker == 0xD9:
                break
            if 0xD0 <= marker <= 0xD7 or marker == 0x01:  # parameterless
                continue
            where = f"{name}: marker 0xFF{marker:02X}"
            skipped = 0xE0 <= marker <= 0xEF or marker in (0xFE, 0xDC)  # APPn, COM, DNL: read as far as they say
            # the errors libjpeg raises before it reads a segment's length
            if marker == 0xD8:
                raise ValueError(f"{where}: a second SOI")
            if marker in _SOF_NAMES and marker != 0xDC:
                raise ValueError(f"{where}: {_SOF_NAMES[marker]} is not supported (SOF0-3, SOF9 and SOF10 only)")
            if marker in _SOF_KINDS and frame.components:
                raise ValueError(f"{where}: a second frame header")
            if not (skipped or marker in _SOF_KINDS or marker in (0xC4, 0xCC, 0xDA, 0xDB, 0xDD)):
                raise ValueError(f"{where}: unexpected marker")
            if i + 2 > n:
                if finished:
                    break
                raise ValueError(f"{name}: truncated JPEG stream (marker 0xFF{marker:02X})")
            length = (data[i] << 8) | data[i + 1]
            if length < 2 and not skipped:
                raise ValueError(f"{name}: truncated JPEG stream (marker 0xFF{marker:02X})")
            length = max(length, 2)
            seg = data[i + 2 : i + length]
            try:
                if marker in (0xC4, 0xCC, 0xDB, 0xDD):
                    _TABLE_READERS[marker](frame, seg, length - 2, where)
                elif len(seg) != length - 2:
                    if marker == 0xDA and finished and seg:  # get_sos's checks of the part that is there
                        ids = [c[0] for c in frame.components]
                        if length != 6 + 2 * seg[0] or not 1 <= seg[0] <= 4 or any(
                                seg[k] not in ids for k in range(1, min(len(seg), 1 + 2 * seg[0]), 2)):
                            raise ValueError(f"{where}: bad scan header")
                    raise _Suspended
            except _Suspended:
                if finished:
                    break
                raise ValueError(f"{name}: truncated JPEG stream (marker 0xFF{marker:02X})") from None
            if marker in _SOF_KINDS:
                frame.progressive, frame.arith, frame.lossless = _SOF_KINDS[marker]
                if len(seg) < 6:
                    raise ValueError(f"{where}: truncated frame header")
                precision, frame.height, frame.width, nc = seg[0], (seg[1] << 8) | seg[2], (seg[3] << 8) | seg[4], seg[5]
                if precision != 8:
                    raise ValueError(f"{where}: {precision}-bit samples are not supported (8 only)")
                if nc not in (1, 3, 4):
                    raise ValueError(f"{where}: {nc} components are not supported (1, 3 or 4)")
                if frame.height == 0 or frame.width == 0:
                    raise ValueError(f"{where}: image size {frame.width} x {frame.height} (DNL is not supported)")
                if len(seg) != 6 + 3 * nc:
                    raise ValueError(f"{where}: bad frame header length")
                for c in range(nc):
                    cid, hv, tq = seg[6 + 3 * c], seg[7 + 3 * c], seg[8 + 3 * c]
                    h, v = hv >> 4, hv & 15
                    if not (1 <= h <= 4 and 1 <= v <= 4) or tq > 3:
                        raise ValueError(f"{where}: bad sampling factors or table id")
                    frame.components.append([cid, h, v, tq])
                hmax = max(c[1] for c in frame.components)
                vmax = max(c[2] for c in frame.components)
                for cid, h, v, _ in frame.components:
                    if hmax // h not in (1, 2) or vmax // v not in (1, 2) or hmax % h or vmax % v:
                        raise ValueError(f"{where}: sampling {h}x{v} against {hmax}x{vmax} is not supported")
            elif marker == 0xDA:
                frame.scans.append(_read_scan(frame, seg, multiscan, where))
                if len(frame.scans) == 1:  # jdapimin.c: the colour space and the scan mode, as the first scan finds them
                    multiscan = frame.progressive or len(frame.scans[0].comps) < len(frame.components)
                    frame.colour = colour_space(len(frame.components), frame.jfif, frame.adobe_transform,
                                                tuple(c[0] for c in frame.components))
                segments, pending = _scan_segments(data, i + length, _intervals(frame, frame.scans[-1]), name)
                frame.scans[-1] = frame.scans[-1]._replace(segments=segments)
                continue
            elif marker in (0xE0, 0xEE) and seg[:5 if marker == 0xEE else 4] in (b"JFIF", b"Adobe") and len(seg) < 7:
                if not frame.scans:
                    raise ValueError(f"{where}: truncated {seg[:5].decode('latin-1')} segment")  # Pillow reads its version
            elif marker == 0xE0 and seg[:5] == b"JFIF\x00" and len(seg) >= 14:
                frame.jfif = True
            elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
                frame.adobe_transform = seg[11]
            i += length
        except ValueError:
            if finished and libtiff:  # libtiff ignores what jpeg_finish_decompress raises (CALLJPEG's -1)
                break
            raise
    if not frame.components or not frame.scans:
        raise ValueError(f"{name}: no frame or no scan before EOI")
    return frame


class _Suspended(Exception):
    """A marker segment the data ends inside: libjpeg suspends there, waiting for bytes that do not come."""


def _take(seg: bytes, k: int, n: int) -> bytes:
    if k + n > len(seg):
        raise _Suspended
    return seg[k : k + n]


def _read_dqt(frame: _Frame, seg: bytes, size: int, where: str) -> None:
    """jdmarker.c get_dqt over the segment's `size` bytes (`seg` may hold fewer): a table id below 4, a
    precision nibble other than 0 for 16-bit values, a table cut short by the length read as far as it goes
    (the rest 1)."""
    k = 0
    while size > 0:
        size -= 1
        b = _take(seg, k, 1)[0]
        prec, tq, k = b >> 4, b & 15, k + 1
        if tq >= 4:
            raise ValueError(f"{where}: bad quantisation table id {tq}")
        count = 64 if size >= (128 if prec else 64) else (size >> 1 if prec else size)
        raw = np.frombuffer(_take(seg, k, count * (2 if prec else 1)), ">u2" if prec else np.uint8).astype(np.int64)
        table = np.ones(64, np.int64) if count < 64 else np.zeros(64, np.int64)
        table[ZIGZAG[:count]] = raw
        frame.qt[tq] = table
        k += count * (2 if prec else 1)
        size -= count * (2 if prec else 1)
    if size:
        raise ValueError(f"{where}: bad quantisation table length")


def _read_dht(frame: _Frame, seg: bytes, size: int, where: str) -> None:
    """jdmarker.c get_dht: tables of at most 256 codes that fit the length, class 0 or 1 and id 0-3 (checked
    further when a scan uses them, `_huffman_lut`)."""
    k = 0
    while size > 16:
        head = _take(seg, k, 17)
        index, counts, total = head[0], head[1:], sum(head[1:])
        size -= 17
        if total > 256 or total > size:
            raise ValueError(f"{where}: bad Huffman table")
        symbols = _take(seg, k + 17, total)
        size -= total
        k += 17 + total
        if index & 0x10:
            index -= 0x10
        if index > 3:
            raise ValueError(f"{where}: bad Huffman table id")
        frame.huff[(head[0] >> 4 & 1, index)] = (bytes(counts), bytes(symbols))
    if size:
        raise ValueError(f"{where}: bad Huffman table length")


def _read_dac(frame: _Frame, seg: bytes, size: int, where: str) -> None:
    """jdmarker.c get_dac: pairs of a table index (DC 0-15, AC 16-31) and its conditioning."""
    k = 0
    while size > 0:
        index, val = _take(seg, k, 2)
        k, size = k + 2, size - 2
        if index >= 32:
            raise ValueError(f"{where}: bad arithmetic table index {index} (DAC)")
        if index >= 16:
            frame.dac[2][index - 16] = val
        else:
            if (val & 15) > (val >> 4):
                raise ValueError(f"{where}: bad DC conditioning {val} (DAC)")
            frame.dac[0][index], frame.dac[1][index] = val & 15, val >> 4
    if size:
        raise ValueError(f"{where}: bad arithmetic conditioning length (DAC)")


def _read_dri(frame: _Frame, seg: bytes, size: int, where: str) -> None:
    """jdmarker.c get_dri: a length of 4, then the interval."""
    if size != 2:
        raise ValueError(f"{where}: bad restart interval")
    hi, lo = _take(seg, 0, 2)
    frame.restart = hi << 8 | lo


_TABLE_READERS = {0xDB: _read_dqt, 0xC4: _read_dht, 0xCC: _read_dac, 0xDD: _read_dri}


def _read_scan(frame: _Frame, seg: bytes, multiscan: bool, where: str) -> _Scan:
    """A scan header (SOS) checked as jdmarker.c's get_sos and the entropy decoders' start_pass check it, with
    the tables it uses as they stand now (a later DHT may redefine them for a later scan); its segments are
    filled in by the caller."""
    if not frame.components:
        raise ValueError(f"{where}: a scan before the frame header")
    if frame.scans and not multiscan:
        raise ValueError(f"{where}: a second scan in a single-scan file (EOI expected)")
    ns = seg[0] if seg else 0
    if not 1 <= ns <= len(frame.components) or len(seg) != 4 + 2 * ns:
        raise ValueError(f"{where}: bad scan header")
    ids = [c[0] for c in frame.components]
    comps, dc_ids, ac_ids = [], [], []
    for s in range(ns):
        cid, t = seg[1 + 2 * s], seg[2 + 2 * s]
        if cid not in ids:
            raise ValueError(f"{where}: scan names an unknown component {cid}")
        comps.append(ids.index(cid))
        dc_ids.append(t >> 4)
        ac_ids.append(t & 15)
    if ns > 1 and sum(frame.components[c][1] * frame.components[c][2] for c in comps) > 10:
        raise ValueError(f"{where}: more than 10 blocks in an MCU (sampling factors too large for an "
                         "interleaved scan)")
    ss, se, ah, al = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns] >> 4, seg[3 + 2 * ns] & 15
    if frame.lossless:  # jdlossls.c start_pass_lossless
        if not 1 <= ss <= 7 or se or ah or al >= 8:
            raise ValueError(f"{where}: bad lossless scan: predictor {ss}, {se} / point transform {ah}, {al}")
    elif not frame.progressive:  # other values only warn (JWRN_NOT_SEQUENTIAL): a sequential scan reads 0..63
        ss, se, ah, al = 0, 63, 0, 0
    if frame.progressive and ((se != 0 if ss == 0 else (ss > se or se > 63 or ns != 1))
                              or (ah and al != ah - 1) or al > 13):  # jdphuff.c's checks
        raise ValueError(f"{where}: bad progression: spectral selection {ss}..{se} / approximation {ah}, {al}")
    needs_dc = frame.lossless or (ss == 0 and ah == 0)  # a DC refinement scan reads no table
    needs_ac = se > 0 and not frame.lossless
    if frame.arith:  # the table numbers and the conditioning as they stand now
        dc = [(t, frame.dac[0][t], frame.dac[1][t]) if needs_dc else None for t in dc_ids]
        ac = [(16 + t, frame.dac[2][t]) if needs_ac else None for t in ac_ids]
    else:
        luts = {}
        for cls, table_ids, needed in ((0, dc_ids, needs_dc), (1, ac_ids, needs_ac)):
            for t in table_ids if needed else ():
                if (cls, t) not in frame.huff:  # jpeg_std_huff_table: tables 0 and 1 default to Annex K's
                    if (cls, t) not in ANNEX_K:
                        raise ValueError(f"{where}: scan uses an undefined {('DC', 'AC')[cls]} Huffman table {t}")
                    frame.huff[(cls, t)] = ANNEX_K[(cls, t)]
                lut = _huffman_lut(*frame.huff[(cls, t)], None if cls else (16 if frame.lossless else 15))
                if lut is None:
                    raise ValueError(f"{where}: bad Huffman table ({('DC', 'AC')[cls]} {t})")
                luts[(cls, t)] = lut
        dc = [luts[(0, t)] if needs_dc else None for t in dc_ids]
        ac = [luts[(1, t)] if needs_ac else None for t in ac_ids]
    for c in comps if not frame.lossless else ():  # libjpeg latches a component's table at its first scan
        if c not in frame.latched:
            tq = frame.components[c][3]
            if tq not in frame.qt:
                raise ValueError(f"{where}: component uses an undefined quantisation table {tq}")
            frame.latched[c] = frame.qt[tq].copy()
    return _Scan(comps, dc, ac, frame.restart, None, ss, se, ah, al)


def _intervals(frame: _Frame, scan: _Scan) -> int:
    """The number of restart intervals of a scan: its MCUs (a non-interleaved scan's over the component's own
    blocks, or samples in a lossless frame) over the restart interval."""
    unit = 1 if frame.lossless else 8
    hmax = max(c[1] for c in frame.components)
    vmax = max(c[2] for c in frame.components)
    if len(scan.comps) == 1:
        _, h, v, _ = frame.components[scan.comps[0]]
        cw, ch = -(-frame.width * h // hmax), -(-frame.height * v // vmax)
        mcus = -(-cw // unit) * -(-ch // unit)
    else:
        mcus = -(-frame.width // (unit * hmax)) * -(-frame.height // (unit * vmax))
    return -(-mcus // scan.restart) if scan.restart else 1


def colour_space(nc: int, jfif: bool, adobe_transform, ids: tuple) -> str:
    """jdapimin.c's default_decompress_parms: the colour space of the samples."""
    if nc == 1:
        return "grey"
    if nc == 4:
        return "cmyk" if adobe_transform in (None, 0) else "ycck"
    if jfif:
        return "ycbcr"
    if adobe_transform is not None:
        return "rgb" if adobe_transform == 0 else "ycbcr"
    return "rgb" if ids == (82, 71, 66) else "ycbcr"


def _geometry(frame: _Frame):
    """Per component: (sampled width, sampled height, block columns, block
    rows) of its padded grid, and the MCU grid."""
    hmax = max(c[1] for c in frame.components)
    vmax = max(c[2] for c in frame.components)
    mcux, mcuy = -(-frame.width // (8 * hmax)), -(-frame.height // (8 * vmax))
    geo = []
    for _, h, v, _ in frame.components:
        cw, ch = -(-frame.width * h // hmax), -(-frame.height * v // vmax)
        geo.append((cw, ch, mcux * h, mcuy * v))
    return geo, mcux, mcuy


class _Bits:
    """An MSB-first reader over one restart interval's unstuffed bytes;
    past the end it reads zeros, as libjpeg does once it meets a marker
    (jdhuff.c jpeg_fill_bit_buffer), and `over` says it did."""

    def __init__(self, segment: bytes):
        self.buf = segment + bytes(8)
        self.nbits = 8 * len(segment)
        self.pos = 0

    def pad(self, nbits: int = 20480) -> None:
        """Zeros enough for `nbits` more read past the end (by default one MCU: 10 blocks of at most 64 codes of
        17 + 15 bits)."""
        if self.pos + nbits + 64 > 8 * len(self.buf):
            self.buf += bytes(nbits // 8 + 16)

    def peek(self) -> int:
        b = self.pos >> 3
        return (int.from_bytes(self.buf[b : b + 5], "big") >> (8 - (self.pos & 7))) & 0xFFFFFFFF

    def get(self, n: int) -> int:
        if not n:
            return 0
        v = self.peek() >> (32 - n)
        self.pos += n
        return v

    def huff(self, lut: list) -> int:
        """The next symbol; a bad code (none of 16 bits or fewer) reads 17 bits and gives symbol 0, as
        jdhuff.c's jpeg_huff_decode and HUFF_DECODE_FAST do (JWRN_HUFF_BAD_CODE)."""
        e = lut[self.peek() >> 16]
        if not e:
            self.pos += 17
            return 0
        self.pos += e >> 8
        return e & 0xFF

    def over(self) -> bool:
        return self.pos > self.nbits


def _extend(v: int, s: int) -> int:
    return v + 1 - (1 << s) if v < (1 << (s - 1)) else v


def _int16(v: int) -> int:
    return ((v + 32768) & 0xFFFF) - 32768  # JCOEF is 16-bit


def _baseline_block(bits: _Bits, dc_lut: list, ac_lut: list, pred: int, row: list) -> int:
    """One sequential block (jdhuff.c decode_mcu) into `row`; returns the new
    DC predictor.  A bad code is symbol 0 after 17 bits (a DC difference of
    0, an end of block); a run past position 63 writes at 63.  The bit reads
    are inlined: this is the twin's hot loop."""
    buf, pos = bits.buf, bits.pos
    b = pos >> 3
    window = (int.from_bytes(buf[b : b + 5], "big") >> (8 - (pos & 7))) & 0xFFFFFFFF
    e = dc_lut[window >> 16]
    if e:
        length, s = e >> 8, e & 0xFF
        if s:
            diff = (window >> (32 - length - s)) & ((1 << s) - 1)
            pred += diff + 1 - (1 << s) if diff < (1 << (s - 1)) else diff
        pos += length + s
    else:
        pos += 17
    row[0] = ((pred + 32768) & 0xFFFF) - 32768  # JCOEF is 16-bit
    k = 1
    while k < 64:
        b = pos >> 3
        window = (int.from_bytes(buf[b : b + 5], "big") >> (8 - (pos & 7))) & 0xFFFFFFFF
        e = ac_lut[window >> 16]
        if not e:
            pos += 17
            break
        length, rs = e >> 8, e & 0xFF
        run, s = rs >> 4, rs & 15
        if s:
            k += run
            val = (window >> (32 - length - s)) & ((1 << s) - 1)
            row[NATURAL[k]] = val + 1 - (1 << s) if val < (1 << (s - 1)) else val
            pos += length + s
            k += 1
        else:
            pos += length
            if run != 15:
                break
            k += 16
    bits.pos = pos
    return pred


def _refine(bits: _Bits, row: list, pos: int, p1: int) -> None:
    """A correction bit of an already-nonzero coefficient (jdphuff.c)."""
    if bits.get(1) and not row[pos] & p1:
        row[pos] = _int16(row[pos] + (p1 if row[pos] >= 0 else -p1))


def _ac_first(bits: _Bits, lut: list, scan: _Scan, row: list, eobrun: int) -> int:
    """decode_mcu_AC_first of jdphuff.c over one block; returns the EOB run left.  A run past the band's end
    writes where it reached (`NATURAL`)."""
    if eobrun:
        return eobrun - 1
    k = scan.ss
    while k <= scan.se:
        rs = bits.huff(lut)
        r, s = rs >> 4, rs & 15
        if s:
            k += r
            row[NATURAL[k]] = _int16(_extend(bits.get(s), s) << scan.al)
        elif r == 15:
            k += 15
        else:
            return (1 << r) + bits.get(r) - 1
        k += 1
    return 0


def _ac_refine(bits: _Bits, lut: list, scan: _Scan, row: list, eobrun: int) -> int:
    """decode_mcu_AC_refine of jdphuff.c over one block; returns the EOB run left.  A newly nonzero coefficient
    whose run passes the band's end is written just past it (`NATURAL`)."""
    p1 = 1 << scan.al
    k = scan.ss
    if not eobrun:
        while k <= scan.se:
            rs = bits.huff(lut)
            r, s = rs >> 4, rs & 15
            if s:  # a newly nonzero coefficient of magnitude 1 (libjpeg warns when s != 1)
                s = p1 if bits.get(1) else -p1
            elif r != 15:
                eobrun = (1 << r) + bits.get(r)
                break
            while k <= scan.se:  # past already-nonzero coefficients (correcting them) and r zero ones
                pos = ZIGZAG_LIST[k]
                if row[pos]:
                    _refine(bits, row, pos, p1)
                else:
                    r -= 1
                    if r < 0:
                        break
                k += 1
            if s:
                row[NATURAL[k]] = s
            k += 1
    if eobrun:
        while k <= scan.se:  # the band's rest after the end of block: corrections only
            if row[ZIGZAG_LIST[k]]:
                _refine(bits, row, ZIGZAG_LIST[k], p1)
            k += 1
        eobrun -= 1
    return eobrun


class _Arith:
    """jdarith.c's decoder (the QM coder of T.81 Annex D) over one restart
    interval's unstuffed bytes, reading zeros past their end as libjpeg does
    once it meets a marker; `dead` is libjpeg's ct = -1 after a bad code,
    which leaves the rest of the interval undecoded."""

    def __init__(self, segment: bytes):
        self.buf, self.pos = segment, 0
        self.c, self.a, self.ct = 0, 0, -16  # ct -16: two bytes to read into C first
        self.dead = False

    def decode(self, st: bytearray, i: int) -> int:
        a, c, ct = self.a, self.c, self.ct
        while a < 0x8000:  # renormalisation and data input (D.2.6)
            ct -= 1
            if ct < 0:
                c = (c << 8) | (self.buf[self.pos] if self.pos < len(self.buf) else 0)
                self.pos += 1
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:
                        a = 0x8000
            a <<= 1
        sv = st[i]
        qe = ARITAB[sv & 0x7F]
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        a -= qe
        temp = a << ct
        if c >= temp:
            c -= temp
            if a < qe:
                st[i] = (sv & 0x80) ^ nm
            else:
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            a = qe
        elif a < 0x8000:
            if a < qe:
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            else:
                st[i] = (sv & 0x80) ^ nm
        self.a, self.c, self.ct = a, c, ct
        return sv >> 7


def _arith_dc(d: _Arith, st: bytearray, ctx: int, lo: int, hi: int):
    """Decode_DC_DIFF (F.19, F.21-F.24): (difference, next context), or None
    on a magnitude overflow."""
    if not d.decode(st, ctx):
        return 0, 0
    sign = d.decode(st, ctx + 1)
    p = ctx + 2 + sign
    m = d.decode(st, p)
    if m:
        p = 20
        while d.decode(st, p):
            m <<= 1
            if m == 0x8000:
                return None
            p += 1
    ctx = 0 if m < (1 << lo) >> 1 else (12 if m > (1 << hi) >> 1 else 4) + 4 * sign
    v, p = m, p + 14
    m >>= 1
    while m:
        if d.decode(st, p):
            v |= m
        m >>= 1
    return (-(v + 1) if sign else v + 1), ctx


def _arith_ac_first(d: _Arith, st: bytearray, fixed: bytearray, ss: int, se: int, al: int, kx: int,
                    row: list) -> bool:
    """decode_mcu's AC part and decode_mcu_AC_first over one block; False on
    a spectral or magnitude overflow."""
    k = ss
    while k <= se:
        p = 3 * (k - 1)
        if d.decode(st, p):  # end of block
            break
        while not d.decode(st, p + 1):
            p += 3
            k += 1
            if k > se:
                return False
        sign = d.decode(fixed, 0)
        p += 2
        m = d.decode(st, p)
        if m and d.decode(st, p):
            m <<= 1
            p = 189 if k <= kx else 217
            while d.decode(st, p):
                m <<= 1
                if m == 0x8000:
                    return False
                p += 1
        v, p = m, p + 14
        m >>= 1
        while m:
            if d.decode(st, p):
                v |= m
            m >>= 1
        v += 1
        row[ZIGZAG_LIST[k]] = _int16((-v if sign else v) << al)
        k += 1
    return True


def _arith_ac_refine(d: _Arith, st: bytearray, fixed: bytearray, ss: int, se: int, al: int, row: list) -> bool:
    """decode_mcu_AC_refine over one block; False on a spectral overflow."""
    p1, m1 = 1 << al, -1 << al
    kex = se  # the previous stage's end of block
    while kex > 0 and not row[ZIGZAG_LIST[kex]]:
        kex -= 1
    k = ss
    while k <= se:
        p = 3 * (k - 1)
        if k > kex and d.decode(st, p):
            break
        while True:
            pos = ZIGZAG_LIST[k]
            if row[pos]:  # a correction bit of an already-nonzero coefficient
                if d.decode(st, p + 2):
                    row[pos] = _int16(row[pos] + (m1 if row[pos] < 0 else p1))
                break
            if d.decode(st, p + 1):  # newly nonzero
                row[pos] = m1 if d.decode(fixed, 0) else p1
                break
            p += 3
            k += 1
            if k > se:
                return False
        k += 1
    return True


def _arith_interval(frame: _Frame, scan: _Scan, segment: bytes, mcus: list) -> None:
    """One restart interval of an arithmetic-coded scan (jdarith.c): the
    statistics and DC predictions start afresh, a bad code leaves the rest of
    the interval as it was."""
    d = _Arith(segment)
    fixed = bytearray([113])  # the fixed 0.5 estimate
    dc_first = not frame.progressive or (scan.ss == 0 and scan.ah == 0)
    stats = {}
    for i in range(len(scan.comps)):
        if dc_first:
            stats[scan.dc[i][0]] = bytearray(64)
        if not frame.progressive or scan.ss:
            stats[scan.ac[i][0]] = bytearray(256)
    pred, ctx = [0] * len(scan.comps), [0] * len(scan.comps)
    for mcu in mcus:
        for i, row in mcu:
            if not frame.progressive or dc_first:
                t, lo, hi = scan.dc[i]
                got = _arith_dc(d, stats[t], ctx[i], lo, hi)
                if got is None:
                    return
                pred[i] = (pred[i] + got[0]) & 0xFFFF
                ctx[i] = got[1]
                row[0] = _int16(pred[i] << (scan.al if frame.progressive else 0))
                if frame.progressive:
                    continue
            elif scan.ss == 0:  # DC refinement: the next bit, at the fixed estimate
                if d.decode(fixed, 0):
                    row[0] = _int16(row[0] | (1 << scan.al))
                continue
            t, kx = scan.ac[i]
            if scan.ah and frame.progressive:
                ok = _arith_ac_refine(d, stats[t], fixed, scan.ss, scan.se, scan.al, row)
            else:
                ss, se = (scan.ss, scan.se) if frame.progressive else (1, 63)
                ok = _arith_ac_first(d, stats[t], fixed, ss, se, scan.al, kx, row)
            if not ok:
                return


def _scan_layout(frame: _Frame, scan: _Scan, geo, mcux: int, mcuy: int, blocks: list) -> list:
    """The blocks of each MCU of a scan in decoding order: [[(index of the
    component in the scan, block row list), ...], ...]."""
    comps = scan.comps
    if len(comps) == 1:  # non-interleaved: one block an MCU, over the component's own blocks
        c = comps[0]
        gw = geo[c][2]
        return [[(0, blocks[c][r * gw + q])] for r in range(-(-geo[c][1] // 8)) for q in range(-(-geo[c][0] // 8))]
    layout = [(i, c, h, v, y, x) for i, c in enumerate(comps) for h, v in [frame.components[c][1:3]]
              for y in range(v) for x in range(h)]
    return [[(i, blocks[c][(r * v + y) * geo[c][2] + q * h + x]) for i, c, h, v, y, x in layout]
            for r in range(mcuy) for q in range(mcux)]


def _decode_coefficients(frame: _Frame, name: str) -> list:
    """Each component's quantised coefficients, [block rows, block columns,
    64] int64 in natural order, over all scans, smoothed where libjpeg
    smooths a progressive image's blocks."""
    geo, mcux, mcuy = _geometry(frame)
    blocks = [[[0] * 64 for _ in range(g[2] * g[3])] for g in geo]
    coef_bits = [[-1] * 64 for _ in frame.components]  # jdphuff.c: the last Al each coefficient was sent at
    prev_bits = [[-1] * 10 for _ in frame.components]  # and zigzag 0-9 as they were before the latest scan
    last_good = mcuy - 1  # jdcoefct.c's last_good_iMCU_row: the iMCU row of the last MCU decoded with data left
    for n, scan in enumerate(frame.scans):
        mcus = _scan_layout(frame, scan, geo, mcux, mcuy, blocks)
        for c in scan.comps if frame.progressive else ():
            for k in range(min(scan.ss, 1), 10):
                prev_bits[c][k] = coef_bits[c][k] if n else 0
            for k in range(scan.ss, scan.se + 1):
                coef_bits[c][k] = scan.al
        interval = scan.restart or len(mcus)
        if frame.arith:
            for k, segment in enumerate(scan.segments):
                _arith_interval(frame, scan, segment or b"", mcus[k * interval: (k + 1) * interval])
            continue
        # an MCU's iMCU row: a row of MCUs, or of v block rows of a non-interleaved scan's component
        per_row = mcux if len(scan.comps) > 1 else -(-geo[scan.comps[0]][0] // 8) * frame.components[scan.comps[0]][2]
        dc_first = frame.progressive and scan.ss == 0 and scan.ah == 0
        dc_refine = frame.progressive and scan.ss == 0 and scan.ah
        ac = (_ac_refine if scan.ah else _ac_first) if scan.ss else None
        # libjpeg's insufficient_data: once an MCU has read past its interval's data (zeros), the interval's
        # later MCUs are left as they are; the next restart clears it unless its marker was left unread
        short = False
        for k, segment in enumerate(scan.segments):
            bits = _Bits(segment or b"")
            pred = [0] * len(scan.comps)  # DC predictions and the EOB run restart with each interval
            eobrun = 0
            for j in range(k * interval, min((k + 1) * interval, len(mcus))):
                if not short:  # tested before decode_mcu, whose restart may clear the flag
                    last_good = j // per_row
                if j == k * interval:
                    short = short and segment is None
                if short:
                    break
                bits.pad()
                for i, row in mcus[j]:
                    if not frame.progressive:
                        pred[i] = _baseline_block(bits, scan.dc[i], scan.ac[i], pred[i], row)
                    elif dc_first:
                        s = bits.huff(scan.dc[i])
                        pred[i] += _extend(bits.get(s), s) if s else 0
                        row[0] = _int16(pred[i] << scan.al)
                    elif dc_refine:
                        if bits.get(1):
                            row[0] = _int16(row[0] | (1 << scan.al))
                    else:
                        eobrun = ac(bits, scan.ac[i], scan, row, eobrun)
                short = bits.over()
    coefs = [np.array(b, np.int64).reshape(g[3], g[2], 64) for b, g in zip(blocks, geo)]
    if frame.progressive and _smooths(frame, coef_bits):
        # decompress_smooth_data takes the Al of zigzag 1-9 as they were before each component's latest scan
        # for the iMCU rows past last_good (where that scan's data ran out), as after the last scan elsewhere
        for c, g in enumerate(geo):
            v = frame.components[c][2]
            args = (coefs[c], -(-g[0] // 8), -(-g[1] // 8), v, mcuy, frame.latched[c])
            out = smooth_blocks(*args, coef_bits[c][:10])
            if last_good < mcuy - 1:
                rows = np.arange(out.shape[0]) // v > last_good
                out[rows] = smooth_blocks(*args, prev_bits[c] if len(frame.scans) > 1 else [-1] * 10)[rows]
            coefs[c] = out
    return coefs


def _smooths(frame: _Frame, coef_bits: list) -> bool:
    """jdcoefct.c's smoothing_ok after the last scan: libjpeg-turbo smooths a
    progressive image's blocks when every component's table was latched with
    its first ten zigzag quantisers nonzero, every DC is at least partly
    known, and some coefficient of zigzag positions 1..9 is not final."""
    for c in range(len(frame.components)):
        q = frame.latched.get(c)
        if q is None or not all(q[ZIGZAG_LIST[k]] for k in range(10)) or coef_bits[c][0] < 0:
            return False
    return any(bits[k] != 0 for bits in coef_bits for k in range(1, 10))


# decompress_smooth_data's estimates (libjpeg-turbo 2.1+): for zigzag positions 1-9, the weights of the 5 x 5
# DC neighbourhood (rows top to bottom) with DC interpolation (every AC unknown) and without (positions 1-5)
_SMOOTH_DC = np.array([[-2, -6, -8, -6, -2], [-6, 6, 42, 6, -6], [-8, 42, 152, 42, -8], [-6, 6, 42, 6, -6],
                       [-2, -6, -8, -6, -2]], np.int64)
_SMOOTH_AC = {  # zigzag position: (weights with DC interpolation, weights without)
    1: ([[-1, -1, 0, 1, 1], [-3, 13, 0, -13, 3], [-3, 38, 0, -38, 3], [-3, 13, 0, -13, 3], [-1, -1, 0, 1, 1]],
        [[0] * 5, [0] * 5, [-7, 50, 0, -50, 7], [0] * 5, [0] * 5]),
    2: ([[-1, -3, -3, -3, -1], [-1, 13, 38, 13, -1], [0] * 5, [1, -13, -38, -13, 1], [1, 3, 3, 3, 1]],
        [[0, 0, -7, 0, 0], [0, 0, 50, 0, 0], [0] * 5, [0, 0, -50, 0, 0], [0, 0, 7, 0, 0]]),
    3: ([[0, 0, 1, 0, 0], [0, 2, 7, 2, 0], [0, -5, -14, -5, 0], [0, 2, 7, 2, 0], [0, 0, 1, 0, 0]],
        [[0, 0, -1, 0, 0], [0, 0, 13, 0, 0], [0, 0, -24, 0, 0], [0, 0, 13, 0, 0], [0, 0, -1, 0, 0]]),
    4: ([[-1, 0, 0, 0, 1], [0, 9, 0, -9, 0], [0] * 5, [0, -9, 0, 9, 0], [1, 0, 0, 0, -1]],
        [[0, -1, 0, 1, 0], [-1, 10, 0, -10, 1], [0] * 5, [1, -10, 0, 10, -1], [0, 1, 0, -1, 0]]),
    5: ([[0] * 5, [0, 2, -5, 2, 0], [1, 7, -14, 7, 1], [0, 2, -5, 2, 0], [0] * 5],
        [[0] * 5, [0] * 5, [-1, 13, -24, 13, -1], [0] * 5, [0] * 5]),
    6: ([[0] * 5, [0, 1, 0, -1, 0], [0, 2, 0, -2, 0], [0, 1, 0, -1, 0], [0] * 5], None),
    7: ([[0] * 5, [0, 1, -3, 1, 0], [0] * 5, [0, -1, 3, -1, 0], [0] * 5], None),
    8: ([[0] * 5, [0, 1, 0, -1, 0], [0, -3, 0, 3, 0], [0, 1, 0, -1, 0], [0] * 5], None),
    9: ([[0] * 5, [0, 1, 2, 1, 0], [0] * 5, [0, -1, -2, -1, 0], [0] * 5], None),
}


def smooth_blocks(coef: np.ndarray, wb: int, hb: int, v: int, imcu_rows: int, q: np.ndarray, bits: list) -> np.ndarray:
    """jdcoefct.c's decompress_smooth_data over one component's blocks
    [rows, columns, 64]: each block of the hb x wb that hold samples gets,
    for zigzag positions 1-9 that are zero and not known exactly (`bits`,
    the progression's Al, nonzero), an estimate from the DC values of its
    5 x 5 neighbourhood, at most 2^Al - 1 in magnitude; where no AC
    coefficient has been sent at all, the DC too is re-estimated (and
    positions 6-9).  Columns are replicated at the edges.  Rows are as
    Pillow's libjpeg-turbo 3.1 reads them (found by probing it with files
    cut after each scan, 4:2:0 at heights 9-96): the row above and the row
    below replicated at the edges; the row two below read from the MCU
    padding rows where the component's v block rows an iMCU row hold one,
    else the row below; the row two above the row above where the image's
    two iMCU rows end in a partial one (a component of v > 1)."""
    r = np.arange(hb)
    up1 = np.maximum(r - 1, 0)
    up2 = np.where(r > 1, r - 2, up1)
    if hb % v and imcu_rows == 2:
        up2 = np.where(r == v, up1, up2)
    dn1 = np.minimum(r + 1, hb - 1)
    dn2 = np.where(r + 2 < -(-hb // v) * v, r + 2, dn1)
    dc = np.pad(coef[:, :wb, 0], ((0, 0), (2, 2)), mode="edge")
    win = [[dc[rows, x: x + wb] for x in range(5)] for rows in (up2, up1, r, dn1, dn2)]
    out = coef.copy()
    change_dc = all(bits[k] == -1 for k in range(1, 10))
    q00 = int(q[0])
    for k in range(1, 10):
        weights = _SMOOTH_AC[k][0 if change_dc else 1]
        al = bits[k]
        if weights is None or al == 0:
            continue
        pos = ZIGZAG_LIST[k]
        qk = int(q[pos])
        num = q00 * sum(w * win[y][x] for y, row in enumerate(weights) for x, w in enumerate(row) if w)
        pred = ((qk << 7) + np.abs(num)) // (qk << 8)
        if al > 0:
            pred = np.minimum(pred, (1 << al) - 1)
        region = out[:hb, :wb, pos]
        region[...] = np.where(region == 0, _int16_array(np.where(num >= 0, pred, -pred)), region)
    if change_dc:
        num = q00 * sum(w * win[y][x] for y in range(5) for x in range(5) for w in [int(_SMOOTH_DC[y, x])])
        pred = ((q00 << 7) + np.abs(num)) // (q00 << 8)
        out[:hb, :wb, 0] = _int16_array(np.where(num >= 0, pred, -pred))
    return out


def _int16_array(v: np.ndarray) -> np.ndarray:
    return ((v + 32768) & 0xFFFF) - 32768  # stored as JCOEF


# libjpeg-turbo's x86-64 SIMD islow IDCT (jidctint-sse2.asm / -avx2.asm, which give the same pixels): jidctint.c's
# CONST_BITS 13 / PASS1_BITS 2 products regrouped into pairs of 16-bit inputs times 16-bit constants (pmaddwd),
# e.g. tmp3 = z2 * (F_0_541 + F_0_765) + z3 * F_0_541
_SIMD = {"f130": 10703, "f054": 4433, "mf130": -10704, "mf078": -6436, "f117": 9633, "f078": 6437, "mf060": -4927,
         "mf089": -7373, "f060": 4926, "mf050": -4176, "mf256": -20995, "f050": 4177}
CONST_BITS, PASS1_BITS = 13, 2


def _wrap16(v: np.ndarray) -> np.ndarray:
    return ((v + 32768) & 0xFFFF) - 32768  # a 16-bit lane's wrapping add / multiply / shift


def _idct_pass(x: list, shift: int) -> list:
    """One pass of the SIMD islow IDCT over 8 int16-valued inputs (arrays): in0 +- in4, in3 + in7 and in1 + in5
    summed in 16-bit lanes, the products and the rest in 32 bits (they cannot overflow there), each output
    DESCALEd by `shift` and packed to 16 bits with saturation (packssdw)."""
    c = _SIMD
    tmp3 = x[2] * c["f130"] + x[6] * c["f054"]
    tmp2 = x[2] * c["f054"] + x[6] * c["mf130"]
    tmp0 = _wrap16(x[0] + x[4]) << CONST_BITS
    tmp1 = _wrap16(x[0] - x[4]) << CONST_BITS
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    z3, z4 = _wrap16(x[3] + x[7]), _wrap16(x[1] + x[5])
    z3, z4 = z3 * c["mf078"] + z4 * c["f117"], z3 * c["f117"] + z4 * c["f078"]
    t0 = x[7] * c["mf060"] + x[1] * c["mf089"] + z3
    t3 = x[7] * c["mf089"] + x[1] * c["f060"] + z4
    t1 = x[5] * c["mf050"] + x[3] * c["mf256"] + z4
    t2 = x[5] * c["mf256"] + x[3] * c["f050"] + z3
    half = 1 << (shift - 1)
    return [np.clip((v + half) >> shift, -32768, 32767) for v in (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                                                                  tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def idct_islow(coef: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """uint8 [N, 8, 8] of libjpeg-turbo's x86-64 SIMD jsimd_idct_islow over N blocks of quantised coefficients
    [N, 64] (natural order) and their table [64]: the dequantising product kept to 16 bits (pmullw, which
    wraps); pass 1 over the columns, or where every coefficient outside the first row is zero the shortcut
    in0 << PASS1_BITS in 16 bits (psllw, which wraps where the full pass saturates); pass 2 over the rows; the
    result packed to 8 bits with saturation and offset by 128 (packsswb, paddb).  On coefficients whose
    products stay in 8-bit samples' range this is jidctint.c's result."""
    d = _wrap16(coef.astype(np.int64) * qt).reshape(-1, 8, 8)  # [block, row v, column u]
    ws = np.stack(_idct_pass([d[:, k, :] for k in range(8)], CONST_BITS - PASS1_BITS), axis=1)  # [block, y, u]
    first_row = ~d[:, 1:, :].any(axis=(1, 2))
    ws = np.where(first_row[:, None, None], _wrap16(d[:, :1, :] << PASS1_BITS), ws)
    x = np.stack(_idct_pass([ws[:, :, k] for k in range(8)], CONST_BITS + PASS1_BITS + 3), axis=2)  # [block, y, x]
    return (np.clip(x, -128, 127) + 128).astype(np.uint8)


def _plane(frame: _Frame, coefs: list, c: int, geo) -> np.ndarray:
    """Component c's samples, cropped to its sampled size, int32."""
    blocks = coefs[c]
    bh, bw = blocks.shape[:2]
    cw, ch = geo[c][0], geo[c][1]
    # decode only the blocks that hold samples (the rest are MCU padding)
    nbw, nbh = -(-cw // 8), -(-ch // 8)
    # a component no scan named has no table: libjpeg multiplies by zeros
    px = idct_islow(blocks[:nbh, :nbw].reshape(-1, 64), frame.latched.get(c, np.zeros(64, np.int64)))
    px = px.reshape(nbh, nbw, 8, 8).transpose(0, 2, 1, 3).reshape(nbh * 8, nbw * 8)
    return px[:ch, :cw].astype(np.int32)


def _fancy_h(p: np.ndarray) -> np.ndarray:
    """h2v1_fancy_upsample along the last axis: 3/4 nearer + 1/4 further,
    biases 1 (left output) and 2 (right output), edges replicated."""
    left = np.concatenate([p[..., :1], p[..., :-1]], axis=-1)
    right = np.concatenate([p[..., 1:], p[..., -1:]], axis=-1)
    out = np.empty(p.shape[:-1] + (2 * p.shape[-1],), np.int32)
    out[..., 0::2] = (3 * p + left + 1) >> 2
    out[..., 1::2] = (3 * p + right + 2) >> 2
    return out


def _upsample(p: np.ndarray, fx: int, fy: int) -> np.ndarray:
    """libjpeg-turbo's upsampling of one component by (fx, fy) in {1, 2}."""
    if fx == 1 and fy == 1:
        return p
    above = np.concatenate([p[:1], p[:-1]], axis=0)
    below = np.concatenate([p[1:], p[-1:]], axis=0)
    if fy == 1:  # h2v1
        return _fancy_h(p) if p.shape[1] > 2 else np.repeat(p, 2, axis=1)
    if fx == 1:  # h1v2 (always fancy)
        out = np.empty((2 * p.shape[0], p.shape[1]), np.int32)
        out[0::2] = (3 * p + above + 1) >> 2
        out[1::2] = (3 * p + below + 2) >> 2
        return out
    if p.shape[1] <= 2:  # h2v2 box
        return np.repeat(np.repeat(p, 2, axis=0), 2, axis=1)
    out = np.empty((2 * p.shape[0], 2 * p.shape[1]), np.int32)
    for r0, near in ((0, above), (1, below)):
        s = 3 * p + near  # column sums with the nearer row weighted 3
        last = np.concatenate([s[:, :1], s[:, :-1]], axis=1)
        nxt = np.concatenate([s[:, 1:], s[:, -1:]], axis=1)
        out[r0::2, 0::2] = (3 * s + last + 8) >> 4
        out[r0::2, 1::2] = (3 * s + nxt + 7) >> 4
    return out


def _ycc_tables():
    """jdcolor.c build_ycc_rgb_table (SCALEBITS 16)."""
    x = np.arange(256, dtype=np.int64) - 128
    one_half = 1 << 15

    def fix(v):
        return int(v * (1 << 16) + 0.5)

    cr_r = (fix(1.40200) * x + one_half) >> 16
    cb_b = (fix(1.77200) * x + one_half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + one_half
    return cr_r, cb_b, cr_g, cb_g


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def _lossless_planes(frame: _Frame, name: str) -> list:
    """Each component's samples, int32 [height, width] of its sampled size,
    of a lossless (SOF3) frame: jdlhuff.c's Huffman-coded differences (16:
    32768), undone by jdlossls.c's predictors (the first row of the image
    and of each restart interval from its left neighbour, starting at
    2^(7 - Pt); the first column from above), then shifted left by the
    point transform and kept to 8 bits.

    Damaged data decodes as jddiffct.c / jdlhuff.c decode it: a bad code
    reads 17 bits as difference 0; the MCU row in which the data runs out
    reads zeros to its end; every later MCU row of the interval (all of
    them past a restart marker left unread) has differences 0 and restarts
    the undifferencer, as decode_mcus' insufficient_data path does.  A
    restart of the undifferencer, at a restart marker or there, takes
    effect at the first sample row of the component's iMCU row."""
    hmax = max(c[1] for c in frame.components)
    vmax = max(c[2] for c in frame.components)
    mcux, mcuy = -(-frame.width // hmax), -(-frame.height // vmax)
    dims = [(-(-frame.width * h // hmax), -(-frame.height * v // vmax)) for _, h, v, _ in frame.components]
    diffs = [np.zeros((mcuy * v, mcux * h), np.int64) for _, h, v, _ in frame.components]
    planes = [None] * len(frame.components)
    for scan in frame.scans:
        if len(scan.comps) == 1:
            c = scan.comps[0]
            cols, n_rows = dims[c]
            units = [[(0, c, r, q)] for r in range(n_rows) for q in range(cols)]
        else:
            cols = mcux
            units = [[(i, c, r * v + y, q * h + x) for i, c in enumerate(scan.comps)
                      for h, v in [frame.components[c][1:3]] for y in range(v) for x in range(h)]
                     for r in range(mcuy) for q in range(mcux)]
        interval = scan.restart or len(units)
        if interval % cols:
            raise ValueError(f"{name}: marker 0xFFDD: restart interval {interval} is not a multiple of the "
                             f"{cols} MCUs of a row (lossless)")
        rows_per_interval = interval // cols
        # the sample rows where jdlossls.c's undifferencer restarts: the first of each iMCU row (v rows of the
        # component) in which the scan starts, a restart marker is read or an MCU row runs short
        resets = {c: np.zeros(diffs[c].shape[0], bool) for c in scan.comps}

        def reset(row: int) -> None:
            for _, c, _, _ in units[row * cols]:
                v = frame.components[c][2]
                resets[c][(row // v if len(scan.comps) == 1 else row) * v] = True

        # jdhuff.c's insufficient_data, which jdlhuff.c's decode_mcus tests once an MCU row (jddiffct.c calls it
        # a row at a time)
        short, bits = False, None
        for row in range(len(units) // cols):
            if row % rows_per_interval == 0:
                segment = scan.segments[row // rows_per_interval]
                bits = _Bits(segment or b"")
                short = short and segment is None  # the restart clears it unless its marker was left unread
                reset(row)
            if short:  # the differences stay 0 (the buffer starts zeroed) and the undifferencer restarts
                reset(row)
                continue
            row_units = units[row * cols: (row + 1) * cols]
            bits.pad(32 * sum(len(u) for u in row_units))
            for unit in row_units:
                for i, c, r, q in unit:
                    s = bits.huff(scan.dc[i])
                    diffs[c][r, q] = 32768 if s == 16 else (_extend(bits.get(s), s) if s else 0)
            short = bits.over()
        for c in scan.comps:
            cw, ch = dims[c]
            planes[c] = _undifference(diffs[c][:ch, :cw], scan.ss, scan.al, resets[c][:ch])
    if any(p is None for p in planes):
        raise ValueError(f"{name}: marker 0xFFDA: a component no scan names (lossless)")
    return planes


def _undifference(diff: np.ndarray, psv: int, pt: int, first: np.ndarray) -> np.ndarray:
    """jdlossls.c's undifferencing of one component (`first`: the rows undone by jpeg_undifference_first_row)
    and the point transform."""
    h, w = diff.shape
    d = diff.tolist()
    out = [[0] * w for _ in range(h)]
    prev = None
    for y in range(h):
        row, dy = out[y], d[y]
        if prev is None or first[y]:  # jpeg_undifference_first_row
            ra = (dy[0] + (1 << (7 - pt))) & 0xFFFF
            row[0] = ra
            for x in range(1, w):
                ra = (dy[x] + ra) & 0xFFFF
                row[x] = ra
        else:
            rb = prev[0]
            ra = (dy[0] + rb) & 0xFFFF  # the first column predicts from above
            row[0] = ra
            for x in range(1, w):
                rc, rb = rb, prev[x]
                if psv == 1:
                    p = ra
                elif psv == 2:
                    p = rb
                elif psv == 3:
                    p = rc
                elif psv == 4:
                    p = ra + rb - rc
                elif psv == 5:
                    p = ra + ((rb - rc) >> 1)
                elif psv == 6:
                    p = rb + ((ra - rc) >> 1)
                else:
                    p = (ra + rb) >> 1
                ra = (dy[x] + p) & 0xFFFF
                row[x] = ra
        prev = row
    return (np.array(out, np.int64).reshape(h, w) << pt & 0xFF).astype(np.int32)


def decode_samples(data: bytes, name: str = "<bytes>", colour: str = None, libtiff: bool = False) -> np.ndarray:
    """uint8 [H, W, 3 or 1 or 4]: what libjpeg hands its caller, upsampled and
    colour-converted: RGB for a YCbCr / RGB frame, one channel for grey, the
    CMYK samples as stored for CMYK and YCCK.  `colour` overrides the colour
    space the markers name ("unknown": every component as it is, as libtiff
    asks for a JPEG-compressed TIFF strip that is not YCbCr); `libtiff`: the markers past a single-scan
    frame's scan read as libtiff reads them (`parse`)."""
    frame = parse(bytes(data), name, libtiff)
    if colour is not None:
        frame.colour = colour
    if frame.colour == "ycbcr" and len(frame.components) != 3:  # jdcolor.c: JERR_BAD_J_COLORSPACE
        raise ValueError(f"{name}: a frame of {len(frame.components)} components read as YCbCr (3 only)")
    hmax = max(c[1] for c in frame.components)
    vmax = max(c[2] for c in frame.components)
    if frame.lossless:
        if frame.colour in ("ycbcr", "ycck"):  # jdcolor.c refuses a lossy conversion of lossless samples
            raise ValueError(f"{name}: marker 0xFFC3: a lossless {frame.colour.upper()} frame, which libjpeg "
                             "does not convert (lossless RGB, CMYK or grey only)")
        # jdsample.c's int_upsample: lossless output is never fancy-upsampled
        planes = [np.repeat(np.repeat(p, vmax // v, axis=0), hmax // h, axis=1)[: frame.height, : frame.width]
                  for p, (_, h, v, _) in zip(_lossless_planes(frame, name), frame.components)]
    else:
        coefs = _decode_coefficients(frame, name)
        geo, _, _ = _geometry(frame)
        planes = [_upsample(_plane(frame, coefs, c, geo), hmax // h, vmax // v)[: frame.height, : frame.width]
                  for c, (_, h, v, _) in enumerate(frame.components)]
    if frame.colour in ("ycbcr", "ycck"):  # YCbCr, or the YCC of YCCK: R = 255 - C there, range-limited
        y, cb, cr = (p.astype(np.int64) for p in planes[:3])
        rgb = np.clip(np.stack([y + _CR_R[cr], y + ((_CB_G[cb] + _CR_G[cr]) >> 16), y + _CB_B[cb]], axis=2), 0, 255)
        if frame.colour == "ycbcr":
            return rgb.astype(np.uint8)
        return np.concatenate([255 - rgb, planes[3][:, :, None]], axis=2).astype(np.uint8)
    return np.stack(planes, axis=2).astype(np.uint8)


def cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """Pillow's Convert.c cmyk2rgb of uint8 [..., 4] CMYK: each of R, G, B
    is (255 - K) - MULDIV255(C, 255 - K)."""
    nk = 255 - cmyk[..., 3:4].astype(np.int64)
    t = cmyk[..., :3].astype(np.int64) * nk + 128
    return (nk - (((t >> 8) + t) >> 8)).astype(np.uint8)


def decode_twin(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """uint8 [H, W, 3]: `PIL.Image.open(...).convert("RGB")` of a JPEG file (module docstring): the markers up
    to the first scan as Pillow's `Image.open` reads them (`open_header`), then libjpeg's samples."""
    open_header(data, name)
    px = decode_samples(data, name)
    if px.shape[2] == 1:
        return np.repeat(px, 3, axis=2)
    if px.shape[2] == 4:  # Pillow reads every CMYK JPEG as Adobe's inverted CMYK (raw mode CMYK;I)
        return cmyk_to_rgb(255 - px)
    return px


# --- the native decoder --------------------------------------------------------


def _native_error(name: str, err) -> ValueError:
    """The exception of a csrc/jpeg.cu error message: "unsupported: " ones UnsupportedImageFormat."""
    msg = err.value.decode()
    if msg.startswith("unsupported: "):
        return UnsupportedImageFormat(f"{name}: {msg.removeprefix('unsupported: ')}")
    return ValueError(f"{name}: {msg}")


def decode_native(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """`decode_twin` through csrc/jpeg.cu's host decoder (built on first use)."""
    from uniir_tpu_torch import _build

    lib = _build.load("jpeg")
    data = bytes(data)
    open_header(data, name)
    err = ctypes.create_string_buffer(256)
    size = (ctypes.c_int * 2)()
    if lib.uniir_jpeg_info(data, len(data), size, err, len(err)) != 0:
        raise _native_error(name, err)
    out = np.empty((size[1], size[0], 3), np.uint8)
    if lib.uniir_jpeg_decode(data, len(data), out.ctypes.data, size[0], size[1], err, len(err)) != 0:
        raise _native_error(name, err)
    with _calls_lock:
        decode_native.calls += 1
    return out


decode_native.calls = 0  # decodes that went through the native library (read by chip_smoke.py)

_COLOUR_CODES = {None: -1, "ycbcr": 1, "unknown": 2}  # csrc/jpeg.cu's Decoder::Colour (kRGB: components as stored)


def decode_samples_native(data: bytes, name: str = "<bytes>", colour: str = None, libtiff: bool = False) -> np.ndarray:
    """`decode_samples` through csrc/jpeg.cu (the TIFF decoder's JPEG strips on a CUDA run's host)."""
    from uniir_tpu_torch import _build

    lib = _build.load("jpeg")
    data = bytes(data)
    err = ctypes.create_string_buffer(256)
    size = (ctypes.c_int * 3)()
    code = _COLOUR_CODES[colour]
    if lib.uniir_jpeg_samples_info(data, len(data), code, size, err, len(err)) != 0:
        raise _native_error(name, err)
    out = np.empty((size[1], size[0], size[2]), np.uint8)
    if lib.uniir_jpeg_decode_samples(data, len(data), code, int(libtiff), out.ctypes.data, size[0], size[1], size[2],
                                     err, len(err)) != 0:
        raise _native_error(name, err)
    return out
_calls_lock = threading.Lock()  # the loader's threads decode at once


def decoder_for(device) -> Callable[[bytes, str], np.ndarray]:
    """The decoder a run on `device` uses: the native one on a CUDA run's
    host, the twin on a CPU run."""
    from uniir_tpu_torch import _build

    return decode_native if _build.is_cuda(device) else decode_twin


# the formats Pillow 12.1's Image.open identifies that the port does not decode (the others are `_DECODED`'s,
# below): each plugin's _accept test of the file's first bytes; EPS needs Ghostscript, and BUFR, GRIB, HDF5,
# MPEG and WMF are stubs that Image.open names and cannot load.  A file none of Image.open's readers takes is
# one it cannot identify: the decoders call it corrupt, as Pillow does.
_REFUSED = (
    (lambda d: d[:4] in (b"BUFR", b"ZCZC"), "BUFR"),
    (lambda d: d[:4] in (b"%!PS", b"\xc5\xd0\xd3\xc6"), "EPS"),
    (lambda d: len(d) >= 8 and d[:4] == b"GRIB" and d[7] == 1, "GRIB"),
    (lambda d: d[:4] == b"\x89HDF", "HDF5"),
    (lambda d: d[:4] == b"\x00\x00\x01\xb3", "MPEG"),
    (lambda d: d[:6] == b"\xd7\xcd\xc6\x9a\x00\x00" or d[:4] == b"\x01\x00\x00\x00", "WMF"),
)


# the readers after Pillow's first six (BMP, DIB, GIF, JPEG, PPM, PNG), in Image.ID's order: the refused formats
# and the ones decoded here (WebP, TIFF and ICO / CUR are tested before them: no reader before theirs takes
# their signatures); a decoded reader's `parse` is its _open's header test
_ORDER = ("avif", "blp", "BUFR", "pcx", "dcx", "dds", "EPS", "fits", "fli", "ftex", "gbr", "GRIB", "HDF5",
          "jpeg2000", "icns", "im", "imt", "iptc", "mcidas", "MPEG", "msp", "pcd", "pixar", "psd", "qoi", "sgi",
          "spider", "sun", "tga", "WMF", "xbm", "xpm", "xvthumb")
_DECODED = {
    "avif": (avif.accepts, avif.open_header),
    "fits": (fits.accepts, fits.parse), "fli": (fli.accepts, fli.parse), "iptc": (iptc.accepts, iptc.parse),
    "pcd": (pcd.accepts, pcd.parse),
    "blp": (blp.accepts, blp.parse), "ftex": (ftex.accepts, ftex.parse), "gbr": (gbr.accepts, gbr.parse),
    "imt": (imt.accepts, imt.parse), "mcidas": (mcidas.accepts, mcidas.parse),
    "pixar": (pixar.accepts, pixar.parse), "spider": (spider.accepts, spider.parse),
    "xvthumb": (xvthumb.accepts, xvthumb.parse),
    "pcx": (pcx.accepts, pcx.parse),
    "dcx": (pcx.dcx_accepts, lambda d: pcx.parse(d, at=pcx.dcx_first_page(d))),
    "dds": (dds.accepts, dds.parse), "icns": (icns.accepts, icns.parse),
    "jpeg2000": (jpeg2000.accepts, jpeg2000.open_header),
    "im": (im.accepts, im.parse), "msp": (msp.accepts, msp.parse), "psd": (psd.accepts, psd.parse),
    "qoi": (qoi.accepts, qoi.parse), "sgi": (sgi.accepts, sgi.parse), "sun": (sun.accepts, sun.parse),
    "tga": (tga.accepts, tga.parse), "xbm": (xbm.accepts, xbm.parse), "xpm": (xpm.accepts, xpm.parse),
}


def _takes(kind: str, d: bytes) -> bool:
    """Whether Image.open keeps the reader of `kind` for `d`: its _accept takes the bytes, and its `_open`
    keeps the file (an image, or an error Image.open raises) rather than raising what makes Image.open try
    its next reader."""
    if kind not in _DECODED:
        return next(test for test, label in _REFUSED if label == kind)(d)
    accepts, parse = _DECODED[kind]
    if not accepts(d):
        return False
    try:
        parse(d)
    except raster.NotThisFormat:
        return False
    except ValueError:
        pass
    return True


_SKIPPED = {0xC4, 0xCC, 0xDA, 0xDC, 0xDD, 0xDF}  # DHT, DAC, SOS, DNL, DRI, EXP: a length and bytes


def open_header(data: bytes, name: str = "<bytes>") -> tuple:
    """(width, height, comment, mpo) as Pillow 12.1's `Image.open` reads a JPEG file's markers up to its
    first SOS (JpegImageFile._open and jpeg_factory): the last COM segment's bytes (None without one), and
    whether an MPF segment names more than one image, which makes the file "MPO".  Raises ValueError where
    Image.open raises: no FF D8 FF, a byte pair that is no marker, a segment cut short, a frame of other
    than 8 bits or 1 / 3 / 4 components, a DQT of too few bytes, no frame before the scan, more pixels than
    the decompression bomb limit."""
    if data[:3] != b"\xff\xd8\xff":
        raise ValueError(f"{name}: not a JPEG file (no SOI marker and marker after it)")
    pos, s = 3, b"\xff"
    size, comment, mpf, hdr_gain = None, None, None, False

    def segment() -> bytes:
        nonlocal pos
        if pos + 2 > len(data):
            raise ValueError(f"{name}: truncated JPEG marker segment")
        n = (data[pos] << 8 | data[pos + 1]) - 2
        body = data[pos + 2 : pos + 2 + max(n, 0)]
        if len(body) < n:
            raise ValueError(f"{name}: truncated JPEG marker segment (truncated file read)")
        pos += 2 + max(n, 0)
        return body

    while True:
        if s[0] != 0xFF:
            s = data[pos : pos + 1]
            pos += len(s)
            if not s:
                raise ValueError(f"{name}: no JPEG start of scan")
            continue
        if pos >= len(data):
            raise ValueError(f"{name}: no JPEG start of scan")
        marker = data[pos]
        pos += 1
        if 0xC0 <= marker <= 0xFE:
            if marker in (0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF, 0xDE):
                body = segment()
                if len(body) < 6:
                    raise ValueError(f"{name}: truncated JPEG frame header")
                if body[0] != 8:
                    raise ValueError(f"{name}: marker 0xFF{marker:02X}: {body[0]}-bit samples are not supported "
                                     f"(8 only; Pillow: cannot handle {body[0]}-bit layers)")
                if body[5] not in (1, 3, 4):
                    raise ValueError(f"{name}: marker 0xFF{marker:02X}: {body[5]} components are not supported "
                                     f"(1, 3 or 4; Pillow: cannot handle {body[5]}-layer images)")
                size = (body[3] << 8 | body[4], body[1] << 8 | body[2])
            elif marker == 0xDB:
                body = segment()
                while body:
                    length = 1 + (1 if body[0] // 16 == 0 else 2) * 64
                    if len(body) < length:
                        raise ValueError(f"{name}: bad quantization table marker")
                    body = body[length:]
            elif marker == 0xFE:
                comment = segment()
            elif 0xE0 <= marker <= 0xEF:
                body = segment()
                if (marker, body[:4]) == (0xE0, b"JFIF") and len(body) < 7 or \
                        (marker, body[:5]) == (0xEE, b"Adobe") and len(body) < 7:
                    raise ValueError(f"{name}: marker 0xFF{marker:02X}: truncated {body[:5].decode('latin-1')} "
                                     "segment")
                if marker == 0xE2 and body.startswith(b"MPF\0"):
                    mpf = body[4:]
                elif marker == 0xE1 and b' hdrgm:Version="' in body:
                    hdr_gain = True
            elif marker in _SKIPPED:
                segment()
            if marker == 0xDA:
                break
            s = data[pos : pos + 1]
            pos += len(s)
            if not s:
                raise ValueError(f"{name}: no JPEG start of scan")
        elif marker == 0xFF:
            s = b"\xff"
        elif marker == 0x00:
            s = data[pos : pos + 1]
            pos += len(s)
            if not s:
                raise ValueError(f"{name}: no JPEG start of scan")
        else:
            raise ValueError(f"{name}: no marker found")
    if size is None or size[0] <= 0 or size[1] <= 0:
        raise ValueError(f"{name}: no JPEG frame before the scan (not identified)")
    if size[0] * size[1] > bmp.MAX_PIXELS:
        raise ValueError(f"{name}: {size[0] * size[1]} pixels (decompression bomb)")
    return size[0], size[1], comment, _mp_images(mpf, name) > 1 and not hdr_gain


_TIFF_UNITS = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8, 13: 4, 16: 8, 17: 8, 18: 8}


def _mp_images(mp: bytes, name: str) -> int:
    """jpeg_factory's reading of the last MPF segment: its index's NumberOfImages (tag 0xB001) where the
    directory, that count and each image's MP entry (tag 0xB002) read as Pillow reads them, else 0 (Pillow
    then keeps the file a JPEG); ValueError where an MP entry is cut short, which fails Image.open itself."""
    if mp is None or mp[:4] not in (b"MM\x00\x2a", b"II\x2a\x00"):
        return 0
    order = "big" if mp[:2] == b"MM" else "little"

    def u(at: int, n: int) -> int:
        return int.from_bytes(mp[at : at + n], order)

    at = u(4, 4)
    if len(mp) < at + 2:
        return 0
    tags = {}
    for k in range(u(at, 2)):
        e = at + 2 + 12 * k
        if len(mp) < e + 12:
            return 0
        tag, typ, count = u(e, 2), u(e + 2, 2), u(e + 4, 4)
        if typ not in _TIFF_UNITS:
            continue
        size = _TIFF_UNITS[typ] * count
        data = mp[e + 8 : e + 8 + size] if size <= 4 else mp[u(e + 8, 4) : u(e + 8, 4) + size]
        if len(data) == size:
            tags[tag] = (typ, count, data)
    quant, entries = tags.get(0xB001), tags.get(0xB002)
    if quant is None or quant[0] not in (3, 4) or quant[1] != 1 or entries is None or entries[0] != 7:
        return 0
    count = int.from_bytes(quant[2], order)
    for k in range(count):
        entry = entries[2][16 * k : 16 * k + 16]
        if len(entry) < 16:
            raise ValueError(f"{name}: MP index entry {k} cut short")
        if (int.from_bytes(entry[:4], order) >> 24) & 7:
            return 0  # "unsupported picture format in MPO": Pillow keeps the JPEG
    return count


def is_jpeg(data: bytes) -> bool:
    """True where `PIL.Image.open(...).format == "JPEG"`: the markers read as Pillow reads them, and not an
    MPO file."""
    try:
        return not open_header(data)[3]
    except ValueError:
        return False


def image_comment(data: bytes, name: str = "<bytes>"):
    """The comment Pillow keeps in `info["comment"]` and its JPEG writer carries over: a JPEG file's last
    COM segment before the scan, a GIF's comment extensions before the first image joined by newlines, a
    PNG's last text chunk keyed "comment" (a str, written as UTF-8), a JPEG 2000 file's first COM segment of
    its main header after its Rcom, a GIMP brush's comment; None for every other file."""
    kind = image_format(data)
    if kind == "jpeg":
        return open_header(data, name)[2]
    if kind == "jpeg2000":
        return jpeg2000.open_header(data, name).comment
    if kind == "gif":
        return gif.parse(data, name).comment or None
    if kind == "png":
        return png.comment(data, name)
    if kind == "gbr":
        return gbr.comment(data, name) or None
    return None


class UnsupportedImageFormat(ValueError):
    """A file in a format the port does not decode yet (Pillow may read it): not corrupt data, which raises
    the decoders' own ValueError."""


def image_format(data: bytes) -> str:
    """The format a file's first bytes name, as Image.open tries its readers: "jpeg", "png", "gif", "bmp",
    "dib", "webp", "tiff", "ico", "cur", "netpbm", "pcx", "dcx", "dds", "icns", "im", "jpeg2000", "msp", "psd",
    "qoi", "sgi", "sun", "tga", "xbm", "xpm", "blp", "ftex", "gbr", "imt", "mcidas", "pixar", "spider", "xvthumb",
    "fits", "fli", "iptc", "pcd", "avif" (Pillow's `format`, lower-case), or the name of another format
    Pillow's Image.open identifies ("EPS", "BUFR", ...), or "unknown"."""
    if data[:2] == b"\xff\xd8":
        return "jpeg"
    if data[:8] == png.SIGNATURE:
        return "png"
    if data[:6] in gif.SIGNATURES:
        return "gif"
    if data[:2] == bmp.SIGNATURE:
        return "bmp"
    if bmp.dib_accepts(data) and bmp.dib_opens(data):
        return "dib"
    if webp.accepts(data):
        return "webp"
    if tiff.accepts(data):
        return "tiff"
    # Pillow tries the next reader on an icon of no entries (a TGA file), or one cut short before its count
    if data[:4] == ico.ICO_SIGNATURE and len(data) >= 6 and data[4:6] != b"\0\0" and ico.ico_opens(data):
        return "ico"
    if data[:4] == ico.CUR_SIGNATURE and len(data) >= 6 and data[4:6] != b"\0\0" and ico.cur_opens(data):
        return "cur"
    if netpbm.accepts(data):
        return "netpbm"
    return next((kind for kind in _ORDER if _takes(kind, data)), "unknown")


DECODED = ("JPEG, PNG, GIF, BMP, DIB, WebP, TIFF, ICO / CUR, Netpbm, PCX / DCX, DDS, ICNS, IM, JPEG 2000, MSP, "
           "PSD, QOI, SGI, Sun raster, TGA, XBM, XPM, BLP, FTEX, GBR, IMT, McIdas, PIXAR, SPIDER, XVThumb, FITS, "
           "FLI / FLC, IPTC, PCD and AVIF")


def decode_image(data: bytes, name: str, device) -> np.ndarray:
    """uint8 [H, W, 3] of an image file's bytes, told apart by its signature (or, for TGA, IM and the
    plugins without one, its header) and decoded as a run on `device` decodes (BMP, DIB, ICO / CUR's DIBs,
    Netpbm, IM, XBM, XPM, GBR, IMT, McIdas, PIXAR, SPIDER, XVThumb, FITS, PCD and AVIF have one decoder,
    numpy; a PSD, DDS or ICNS file's raw pixels too, and a BLP file's but a BLP1 JPEG; an IPTC file's image is
    decoded as this function decodes a file).  A format the port does not decode raises
    UnsupportedImageFormat; an empty file or one of no format Image.open identifies, and corrupt data, raise
    ValueError."""
    if not data:
        raise ValueError(f"{name}: empty file (cannot identify image file)")
    kind = image_format(data)
    if kind == "jpeg":
        return decoder_for(device)(data, name)
    if kind in ("png", "gif", "webp", "tiff", "pcx", "msp", "qoi", "sgi", "sun", "tga", "dds", "icns", "psd",
                "jpeg2000", "ftex", "blp", "fli", "iptc", "avif"):
        modules = {"png": png, "gif": gif, "webp": webp, "tiff": tiff, "pcx": pcx, "msp": msp, "qoi": qoi,
                   "sgi": sgi, "sun": sun, "tga": tga, "dds": dds, "icns": icns, "psd": psd, "jpeg2000": jpeg2000,
                   "ftex": ftex, "blp": blp, "fli": fli, "iptc": iptc, "avif": avif}
        return modules[kind].decoder_for(device)(data, name)
    if kind == "dcx":
        return pcx.dcx_decoder_for(device)(data, name)
    if kind in ("bmp", "dib", "netpbm", "im", "xbm", "xpm", "gbr", "imt", "mcidas", "pixar", "spider", "xvthumb",
                "fits", "pcd"):
        return {"bmp": bmp.decode, "dib": bmp.decode_dib, "netpbm": netpbm.decode, "im": im.decode,
                "xbm": xbm.decode, "xpm": xpm.decode, "gbr": gbr.decode, "imt": imt.decode, "mcidas": mcidas.decode,
                "pixar": pixar.decode, "spider": spider.decode, "xvthumb": xvthumb.decode, "fits": fits.decode,
                "pcd": pcd.decode}[kind](data, name)
    if kind == "ico":
        return ico.decode_ico(data, name, device)
    if kind == "cur":
        return ico.decode_cur(data, name)
    if kind == "unknown":
        raise ValueError(f"{name}: unknown image (no format's signature or header): cannot identify image file")
    raise UnsupportedImageFormat(f"{name}: {kind} image (by its signature): only {DECODED} files are decoded")


def read_image(path: str, device) -> np.ndarray:
    """uint8 [H, W, 3] of the image file at `path` (`decode_image`)."""
    with open(path, "rb") as f:
        return decode_image(f.read(), path, device)
