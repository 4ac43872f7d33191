"""TIFF decoding with Pillow's pixels, without Pillow.

The JAX package reads every image with `PIL.Image.open(path).convert("RGB")`.
For a TIFF file that is the first image (IFD) of the file, read as Pillow
12.1's `TiffImagePlugin` reads it, and this module gives the same uint8
[H, W, 3] array, bit for bit:

  * the six signatures Pillow accepts (classic and BigTIFF in either byte
    order, and the two "invalid" headers II 00 2A / MM 2A 00, read in the
    byte order their first two bytes name); the first IFD's tags as
    Pillow's `ImageFileDirectory_v2` loads them (a tag whose data lies past
    the end of the file is skipped; an IFD cut short keeps the tags read);
  * the mode and raw mode of `TiffImageFile._setup`: Pillow's OPEN_INFO
    table keyed by (byte order, photometric, sample format, fill order, bits
    per sample, extra samples), with its fix-ups (old-style JPEG forces
    photometric 6; the bits-per-sample tuple stretched or cut to
    SamplesPerPixel; a per-band SampleFormat of all 1s read as (1,)); a key
    it lacks raises as "unknown pixel mode" does;
  * uncompressed data (compression 1) through Pillow's own raw decoder:
    strip by strip or tile by tile, each band layer of planar configuration
    2 in turn, FillOrder 2 by the raw modes ending in R, the edge tiles read
    with the stride rule of `_setup`, the data in the file's byte order;
  * every other compression as Pillow's `TiffDecode.c` runs libtiff 4.7:
    strips or tiles decoded into native-order samples (16- and 32-bit
    samples swapped to little-endian, which the raw modes ending in N read
    as such and the others read as they stand -- Pillow's own reading of a
    big-endian signed or float file), FillOrder 2 undone on the compressed
    bytes (not for JPEG), the predictor undone (2: horizontal, 8/16/32-bit;
    3: floating point, float samples only), contiguous YCbCr + JPEG decoded
    to RGB (JPEGCOLORMODE_RGB), and YCbCr under any other compression (JPEG
    planes too) through TIFFRGBAImage: data units of 1x1 ... 4x4
    subsampling as its putcontig8bitYCbCr routines place them (partial
    blocks at the edges, a clipped 4x4 tile skipped by the 4x2 unit's size,
    an odd 4x4 unit row read short into a zeroed buffer), planes at 1x1,
    libtiff's YCbCr -> RGB tables from the file's coefficients and
    ReferenceBlackWhite; uncompressed YCbCr as Pillow's raw decoder reads it
    (raw mode RGBX, no conversion);
  * the codecs: PackBits (32773), LZW (5; the MSB-first code with early
    change, a clear code first, and the old LSB-first "compat" code libtiff
    detects by its first two bytes), Deflate (8 and 32946, stdlib zlib), LZMA (34925,
    stdlib lzma), ZSTD (50000, `data.zstd`: libtiff's ZSTDDecode over
    libzstd's ZSTD_decompressStream), CCITT for bilevel images (2: modified
    Huffman rows, byte aligned; 3: T.4 1-D or 2-D rows after EOL codes per
    T4Options, and libtiff 4.7's retry without EOLs where a strip ends
    inside an EOL; 4: T.6), and JPEG (7: each strip or tile its own
    abbreviated stream, completed by the JPEGTables tag and decoded by
    `data.jpeg` at libjpeg's defaults as libtiff reads it -- a fake EOI
    where its data ends, errors past a single scan ignored --, no colour
    conversion unless YCbCr; separate planes one component each);
  * `convert("RGB")` as Pillow's Convert.c does it: "1" 0 / 255, L copied,
    I;16 clamped to 255, I clipped to 0..255, F truncated toward zero then
    clipped (NaN becomes 0), LA / RGBA / RGBX
    without their extra band (associated alpha unpremultiplied first, as
    the raw mode RGBa unpacks it), P by the ColorMap (each 16-bit entry //
    256), CMYK by cmyk2rgb, CIELAB by LittleCMS's transform (`data.lab`;
    contiguous LAB bytes as they stand, a plane's a and b with their sign
    bit flipped, as Pillow stores them);
  * the Orientation tag applied after decoding, as `exif_transpose` does in
    `load_end` (2-8; 5-8 swap width and height).

Damaged contiguous YCbCr under TIFFRGBAImage, which Pillow begins with
stop = 0, reads on past a strip or tile that fails with the buffer as the
failure left it: LZW's, PackBits' and Deflate's output and zeros after it
(`ChunkError.written`), zeros for ZSTD and for a tile libtiff cannot read;
the horizontal predictor runs over PredictorSetup's rows of data units, or
fails and leaves the differences.  Refused with UnsupportedImageFormat (kept
by the image pass): what Pillow reads from what this module does not model
-- a Group 4 strip that ends before its last row (libtiff leaves the later
rows as Pillow's buffer held them, uninitialised memory for the first
strip), damaged YCbCr planes, JPEG planes or LZMA chunks under
TIFFRGBAImage.  Refused with ValueError naming the
file: what Pillow refuses as well (old-style JPEG 6, WebP 50001, NeXT,
ThunderScan, SGILog, JBIG, LERC, layouts outside OPEN_INFO, a raw mode
Pillow has no unpacker for, a predictor libtiff's PredictorSetup refuses,
YCbCr TIFFRGBAImage has no put routine for, a big-endian BigTIFF, which
Pillow reads as classic, a compressed file under an "invalid" header, which
libtiff refuses); and any stream that is truncated or corrupt where libtiff
reports an error.  Bad
CCITT code words and rows of the wrong length are patched up as libtiff
does; libtiff's padding of its bit accumulator with zeros at the end of the
data is kept (a short last row can read shifted bits).

Both decoders parse the IFD and walk one plan of strips and tiles (`plan`:
where each chunk's bytes are and its rows go, and Pillow's raw mode for
them).  `decode_twin` executes it in Python and numpy; `decode_native` in
one call of host C++ (`csrc/tiff.cu`, built by `_build` like the kernels
and called through ctypes, which releases the GIL): LZW, PackBits, CCITT,
ZSTD (`csrc/zstd.cuh`), the predictors, the unpacking (the raw modes as
`native_spec` encodes them, YCbCr data units), the conversion to RGB and
the orientation, with zlib and lzma chunks inflated by the stdlib first and
CIELAB converted by `data.lab` after.  JPEG strips go through the JPEG decoders.
`decoder_for(device)` picks one by the run's device.
"""

from __future__ import annotations

import ctypes
import lzma
import struct
import threading
import zlib
from typing import Callable, NamedTuple

import numpy as np

from uniir_tpu_torch.data import zstd
from uniir_tpu_torch.data.lab import lab_to_rgb

PREFIXES = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a", b"MM\x00\x2b", b"II\x2b\x00")
MAX_PIXELS = 2 * (1024 * 1024 * 1024 // 4 // 3)  # Image.open's decompression bomb limit

# tags
WIDTH, HEIGHT, BPS, COMPRESSION, PHOTOMETRIC, FILLORDER = 256, 257, 258, 259, 262, 266
STRIPOFFSETS, ORIENTATION, SPP, ROWSPERSTRIP, STRIPBYTECOUNTS, PLANAR = 273, 274, 277, 278, 279, 284
T4OPTIONS, PREDICTOR, COLORMAP = 292, 317, 320
TILEWIDTH, TILELENGTH, TILEOFFSETS, TILEBYTECOUNTS = 322, 323, 324, 325
EXTRASAMPLES, SAMPLEFORMAT, JPEGTABLES = 338, 339, 347
YCBCRCOEFFICIENTS, YCBCRSUBSAMPLING, REFBLACKWHITE = 529, 530, 532

COMPRESSIONS = {1: "raw", 2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4", 5: "LZW", 6: "old-style JPEG",
                7: "JPEG", 8: "Deflate", 32771: "raw (word-aligned)", 32773: "PackBits", 32809: "ThunderScan",
                32946: "Deflate", 34676: "SGILog", 34677: "SGILog24", 34925: "LZMA", 50000: "ZSTD", 50001: "WebP",
                32766: "NeXT", 34661: "JBIG", 34887: "LERC"}
DECODED = (1, 2, 3, 4, 5, 7, 8, 32773, 32946, 34925, 50000)
PREDICTED = (5, 8, 32946, 34925, 50000)  # the codecs that call libtiff's TIFFPredictorInit

# TiffImagePlugin.OPEN_INFO: (photometric, sample format, fill order, bits per sample, extra samples) ->
# (mode, raw mode), the same in both byte orders except where a key is given for one ("II" / "MM") only
_OPEN_INFO_BOTH = {
    (0, (1,), 1, (1,), ()): ("1", "1;I"), (0, (1,), 2, (1,), ()): ("1", "1;IR"),
    (1, (1,), 1, (1,), ()): ("1", "1"), (1, (1,), 2, (1,), ()): ("1", "1;R"),
    (0, (1,), 1, (2,), ()): ("L", "L;2I"), (0, (1,), 2, (2,), ()): ("L", "L;2IR"),
    (1, (1,), 1, (2,), ()): ("L", "L;2"), (1, (1,), 2, (2,), ()): ("L", "L;2R"),
    (0, (1,), 1, (4,), ()): ("L", "L;4I"), (0, (1,), 2, (4,), ()): ("L", "L;4IR"),
    (1, (1,), 1, (4,), ()): ("L", "L;4"), (1, (1,), 2, (4,), ()): ("L", "L;4R"),
    (0, (1,), 1, (8,), ()): ("L", "L;I"), (0, (1,), 2, (8,), ()): ("L", "L;IR"),
    (1, (1,), 1, (8,), ()): ("L", "L"), (1, (2,), 1, (8,), ()): ("L", "L"), (1, (1,), 2, (8,), ()): ("L", "L;R"),
    (1, (1,), 1, (8, 8), (2,)): ("LA", "LA"),
    (2, (1,), 1, (8, 8, 8), ()): ("RGB", "RGB"), (2, (1,), 2, (8, 8, 8), ()): ("RGB", "RGB;R"),
    (2, (1,), 1, (8, 8, 8, 8), ()): ("RGBA", "RGBA"), (2, (1,), 1, (8, 8, 8, 8), (0,)): ("RGB", "RGBX"),
    (2, (1,), 1, (8, 8, 8, 8, 8), (0, 0)): ("RGB", "RGBXX"),
    (2, (1,), 1, (8, 8, 8, 8, 8, 8), (0, 0, 0)): ("RGB", "RGBXXX"),
    (2, (1,), 1, (8, 8, 8, 8), (1,)): ("RGBA", "RGBa"), (2, (1,), 1, (8, 8, 8, 8, 8), (1, 0)): ("RGBA", "RGBaX"),
    (2, (1,), 1, (8, 8, 8, 8, 8, 8), (1, 0, 0)): ("RGBA", "RGBaXX"),
    (2, (1,), 1, (8, 8, 8, 8), (2,)): ("RGBA", "RGBA"), (2, (1,), 1, (8, 8, 8, 8, 8), (2, 0)): ("RGBA", "RGBAX"),
    (2, (1,), 1, (8, 8, 8, 8, 8, 8), (2, 0, 0)): ("RGBA", "RGBAXX"),
    (2, (1,), 1, (8, 8, 8, 8), (999,)): ("RGBA", "RGBA"),
    (3, (1,), 1, (1,), ()): ("P", "P;1"), (3, (1,), 2, (1,), ()): ("P", "P;1R"),
    (3, (1,), 1, (2,), ()): ("P", "P;2"), (3, (1,), 2, (2,), ()): ("P", "P;2R"),
    (3, (1,), 1, (4,), ()): ("P", "P;4"), (3, (1,), 2, (4,), ()): ("P", "P;4R"),
    (3, (1,), 1, (8,), ()): ("P", "P"), (3, (1,), 1, (8, 8), (0,)): ("P", "PX"),
    (3, (1,), 1, (8, 8), (2,)): ("PA", "PA"), (3, (1,), 2, (8,), ()): ("P", "P;R"),
    (5, (1,), 1, (8, 8, 8, 8), ()): ("CMYK", "CMYK"), (5, (1,), 1, (8, 8, 8, 8, 8), (0,)): ("CMYK", "CMYKX"),
    (5, (1,), 1, (8, 8, 8, 8, 8, 8), (0, 0)): ("CMYK", "CMYKXX"),
    (6, (1,), 1, (8,), ()): ("L", "L"), (6, (1,), 1, (8, 8, 8), ()): ("RGB", "RGBX"),
    (8, (1,), 1, (8, 8, 8), ()): ("LAB", "LAB"),
}
_OPEN_INFO_ORDER = {
    "II": {(1, (1,), 1, (12,), ()): ("I;16", "I;12"), (0, (1,), 1, (16,), ()): ("I;16", "I;16"),
           (1, (1,), 1, (16,), ()): ("I;16", "I;16"), (1, (1,), 2, (16,), ()): ("I;16", "I;16R"),
           (1, (2,), 1, (16,), ()): ("I", "I;16S"), (0, (3,), 1, (32,), ()): ("F", "F;32F"),
           (1, (1,), 1, (32,), ()): ("I", "I;32N"), (1, (2,), 1, (32,), ()): ("I", "I;32S"),
           (1, (3,), 1, (32,), ()): ("F", "F;32F"), (2, (1,), 1, (16, 16, 16), ()): ("RGB", "RGB;16L"),
           (2, (1,), 1, (16, 16, 16, 16), ()): ("RGBA", "RGBA;16L"),
           (2, (1,), 1, (16, 16, 16, 16), (0,)): ("RGB", "RGBX;16L"),
           (2, (1,), 1, (16, 16, 16, 16), (1,)): ("RGBA", "RGBa;16L"),
           (2, (1,), 1, (16, 16, 16, 16), (2,)): ("RGBA", "RGBA;16L"),
           (5, (1,), 1, (16, 16, 16, 16), ()): ("CMYK", "CMYK;16L")},
    "MM": {(1, (1,), 1, (16,), ()): ("I;16B", "I;16B"), (1, (2,), 1, (16,), ()): ("I", "I;16BS"),
           (0, (3,), 1, (32,), ()): ("F", "F;32BF"), (1, (2,), 1, (32,), ()): ("I", "I;32BS"),
           (1, (3,), 1, (32,), ()): ("F", "F;32BF"), (2, (1,), 1, (16, 16, 16), ()): ("RGB", "RGB;16B"),
           (2, (1,), 1, (16, 16, 16, 16), ()): ("RGBA", "RGBA;16B"),
           (2, (1,), 1, (16, 16, 16, 16), (0,)): ("RGB", "RGBX;16B"),
           (2, (1,), 1, (16, 16, 16, 16), (1,)): ("RGBA", "RGBa;16B"),
           (2, (1,), 1, (16, 16, 16, 16), (2,)): ("RGBA", "RGBA;16B"),
           (5, (1,), 1, (16, 16, 16, 16), ()): ("CMYK", "CMYK;16B")},
}
MAX_SAMPLES = 6  # the longest bits-per-sample tuple of OPEN_INFO

# bits of one pixel of the raw modes (Unpack.c) that are not 8 per band: 1, 2, 4 and 12-bit packed
_BITS = {"1": 1, "1;I": 1, "1;R": 1, "1;IR": 1, "L;2": 2, "L;2I": 2, "L;2R": 2, "L;2IR": 2, "L;4": 4, "L;4I": 4,
         "L;4R": 4, "L;4IR": 4, "P;1": 1, "P;1R": 1, "P;2": 2, "P;2R": 2, "P;4": 4, "P;4R": 4, "I;12": 12, "L^": 8}


def _raw_bits(rawmode: str) -> int:
    """Bits of one pixel of a raw mode: 16 / 32 per sample where its name says so, else 8 per band letter."""
    if rawmode in _BITS:
        return _BITS[rawmode]
    base, _, size = rawmode.partition(";")
    if base in ("I", "F") and size:
        return int(size[:2])
    return (16 if size.startswith("16") else 8) * len(base)


_BIT_REVERSED = {"1;R": "1", "1;IR": "1;I", "L;2R": "L;2", "L;2IR": "L;2I", "L;4R": "L;4", "L;4IR": "L;4I",
                 "L;IR": "L;I", "L;R": "L", "RGB;R": "RGB", "P;1R": "P;1", "P;2R": "P;2", "P;4R": "P;4", "P;R": "P",
                 "I;16R": "I;16"}
_REVERSE = np.array([int(f"{b:08b}"[::-1], 2) for b in range(256)], np.uint8)  # bit order of each byte reversed


class Tiff(NamedTuple):
    """The first IFD as the decoders use it."""

    order: str  # "II" or "MM"
    tags: dict  # tag -> tuple of values
    width: int
    height: int
    compression: int
    photometric: int
    planar: int
    fillorder: int
    bps: tuple
    extra: tuple
    spp: int
    mode: str
    rawmode: str
    orientation: int


# --- the IFD

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8, 13: 4, 16: 8, 17: 8, 18: 8}


def _values(typ: int, raw: bytes, e: str):
    if typ in (1, 7):
        return tuple(raw) if typ == 1 else raw
    if typ == 2:
        return raw
    fmt = {3: "H", 4: "L", 6: "b", 8: "h", 9: "l", 11: "f", 12: "d", 13: "L", 16: "Q", 17: "q", 18: "Q"}.get(typ)
    if fmt:
        return struct.unpack(f"{e}{len(raw) // struct.calcsize(e + fmt)}{fmt}", raw)
    pairs = struct.unpack(f"{e}{len(raw) // 4}{'L' if typ == 5 else 'l'}", raw)
    return tuple(float("nan") if d == 0 else n / d for n, d in zip(pairs[::2], pairs[1::2]))


def read_ifd(data: bytes, name: str):
    """(byte order, tags) of the first IFD, as ImageFileDirectory_v2.load reads it."""
    if data[:4] not in PREFIXES:
        raise ValueError(f"{name}: not a TIFF file")
    order = data[:2].decode()
    e = "<" if order == "II" else ">"
    big = data[2] == 43
    if big:
        if len(data) < 16:
            raise ValueError(f"{name}: truncated TIFF header")
        offset = struct.unpack(f"{e}Q", data[8:16])[0]
    else:
        if len(data) < 8:
            raise ValueError(f"{name}: truncated TIFF header")
        offset = struct.unpack(f"{e}L", data[4:8])[0]
    if offset == 0:
        raise ValueError(f"{name}: no image in the TIFF file (no IFD)")
    tags = {}
    head, entry = (8, 20) if big else (2, 12)
    if offset + head > len(data):
        raise ValueError(f"{name}: truncated TIFF file (the IFD lies past its end)")
    count = struct.unpack(f"{e}{'Q' if big else 'H'}", data[offset: offset + head])[0]
    pos = offset + head
    for _ in range(count):
        if pos + entry > len(data):
            break  # Pillow warns and keeps the tags read so far
        if big:
            tag, typ, n = struct.unpack(f"{e}HHQ", data[pos: pos + 12])
            inline = data[pos + 12: pos + 20]
        else:
            tag, typ, n = struct.unpack(f"{e}HHL", data[pos: pos + 8])
            inline = data[pos + 8: pos + 12]
        pos += entry
        if typ not in _TYPE_SIZES:
            continue
        size = n * _TYPE_SIZES[typ]
        if size > len(inline):
            at = struct.unpack(f"{e}{'Q' if big else 'L'}", inline)[0]
            raw = data[at: at + size]
            if len(raw) != size:
                break  # ImageFile._safe_read raises inside Pillow's try: the tags read so far stand
        else:
            raw = inline[:size]
        if not raw:
            continue
        tags[tag] = _values(typ, raw, e)
    return order, tags


def _one(tags: dict, tag: int, default=None):
    v = tags.get(tag)
    if v is None:
        return default
    return v[0] if len(v) == 1 else v


def parse(data: bytes, name: str = "<bytes>") -> Tiff:
    """The first IFD and the mode Pillow opens it in; ValueError where Pillow raises, or for a form this
    module does not decode (module docstring)."""
    data = bytes(data)
    order, tags = read_ifd(data, name)
    if 0xBC01 in tags:
        raise ValueError(f"{name}: Windows Media Photo in a TIFF file is not supported (Pillow refuses it)")
    compression = _one(tags, COMPRESSION, 1)
    if compression not in COMPRESSIONS:
        raise ValueError(f"{name}: unknown TIFF compression {compression} (Pillow refuses it)")
    planar = _one(tags, PLANAR, 1)
    photometric = _one(tags, PHOTOMETRIC, 0)
    if compression == 6:
        photometric = 6
    fillorder = _one(tags, FILLORDER, 1)
    width, height = _one(tags, WIDTH), _one(tags, HEIGHT)
    if width is None or height is None:
        raise ValueError(f"{name}: TIFF without image dimensions (Pillow: missing dimensions)")
    if not isinstance(width, int) or not isinstance(height, int):
        raise ValueError(f"{name}: invalid TIFF dimensions")
    orientation = _one(tags, ORIENTATION, 1)
    sample_format = tuple(tags.get(SAMPLEFORMAT, (1,)))
    if len(sample_format) > 1 and max(sample_format) == min(sample_format) == 1:
        sample_format = (1,)
    bps = tuple(tags.get(BPS, (1,)))
    extra = tuple(tags.get(EXTRASAMPLES, ()))
    spp = _one(tags, SPP, 3 if compression == 6 and photometric in (2, 6) else 1)
    if not isinstance(spp, int) or spp > MAX_SAMPLES:
        raise ValueError(f"{name}: invalid SamplesPerPixel {spp}")
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp:
        raise ValueError(f"{name}: unknown TIFF data organization (bits per sample {bps}, {spp} samples)")
    key = (photometric, sample_format, fillorder, bps, extra)
    info = _OPEN_INFO_BOTH.get(key) or _OPEN_INFO_ORDER[order].get(key)
    if info is None:
        raise ValueError(f"{name}: unknown TIFF pixel mode (photometric {photometric}, sample format "
                         f"{sample_format}, fill order {fillorder}, bits {bps}, extra samples {extra})")
    mode, rawmode = info
    if compression not in DECODED:
        raise ValueError(f"{name}: TIFF compression {compression} ({COMPRESSIONS[compression]}) is not supported")
    if compression != 1 and data[2:4] in (b"\x00\x2a", b"\x2a\x00") and data[:4] not in PREFIXES[:2]:
        raise ValueError(f"{name}: a compressed TIFF under the header {data[:4]!r}, which libtiff refuses (bad "
                         "magic number)")
    if width * height > MAX_PIXELS:
        raise ValueError(f"{name}: image of {width * height} pixels exceeds the decompression bomb limit")
    if compression != 1:  # libtiff: the fill order is undone before decoding
        if fillorder == 2:
            mode, rawmode = _OPEN_INFO_BOTH.get(key[:2] + (1,) + key[3:]) or _OPEN_INFO_ORDER[order][key[:2] + (1,)
                                                                                                   + key[3:]]
        if photometric == 6 and compression == 7 and planar == 1:
            rawmode = "RGB"
        elif rawmode == "I;16":
            rawmode = "I;16N"
        elif rawmode.endswith((";16B", ";16L")):
            rawmode = rawmode[:-1] + "N"
    return Tiff(order, tags, width, height, compression, photometric, planar, fillorder, bps, extra, spp, mode,
                rawmode, orientation)


# --- unpacking (Unpack.c) into Pillow's modes, and convert("RGB") (Convert.c)


def _bits(rows: np.ndarray, bits: int, width: int) -> np.ndarray:
    """[rows, width] values of `bits`-bit samples packed MSB first in each byte."""
    b = np.unpackbits(rows, axis=1)[:, : width * bits]
    b = b.reshape(rows.shape[0], width, bits).astype(np.int64)
    return (b << np.arange(bits - 1, -1, -1)).sum(axis=2)


# raw modes of OPEN_INFO (and single bands of planar configuration 2) for which Pillow has no unpacker: a file
# that needs one raises "unknown raw mode" in Pillow
_NO_UNPACKER = {("L", "L;IR"), ("P", "P;1R"), ("P", "P;2R"), ("P", "P;4R"), ("RGB", "X"), ("RGBA", "a"),
                ("RGBA", "X"), ("CMYK", "X"), ("LA", "L"), ("LA", "A"), ("PA", "P"), ("PA", "A"), ("L", "X"),
                ("P", "X")}


def unpack(rawmode: str, rows: np.ndarray, width: int) -> np.ndarray:
    """Pillow's unpacker of `rawmode` over uint8 [n, row bytes]: [n, width, bands] in the mode's storage (uint8
    bands, or uint16 / int32 / float32 for I;16 / I / F)."""
    if rawmode in _BIT_REVERSED:  # FillOrder 2 read by Pillow's own decoder: each byte's bits reversed
        rows, rawmode = _REVERSE[rows], _BIT_REVERSED[rawmode]
    n = rows.shape[0]
    if rawmode in ("1", "1;I"):
        v = _bits(rows, 1, width)
        v = (v if rawmode == "1" else 1 - v) * 255
        return v.astype(np.uint8)[:, :, None]
    if rawmode in ("P;1", "P;2", "P;4"):
        return _bits(rows, int(rawmode[2]), width).astype(np.uint8)[:, :, None]
    if rawmode in ("L;2", "L;2I", "L;4", "L;4I"):
        bits = int(rawmode[2])
        v = _bits(rows, bits, width)
        if rawmode.endswith("I"):
            v = ~v & ((1 << bits) - 1)
        return (v * (0x55 if bits == 2 else 0x11)).astype(np.uint8)[:, :, None]
    if rawmode == "I;12":
        v = _bits(rows, 12, width)
        return v.astype(np.uint16)[:, :, None]
    if rawmode in ("I;16", "I;16N", "I;16B", "I;16S", "I;16BS"):
        dt = {"I;16": "<u2", "I;16N": "<u2", "I;16B": ">u2", "I;16S": "<i2", "I;16BS": ">i2"}[rawmode]
        v = rows[:, : 2 * width].copy().view(dt).reshape(n, width)
        return (v.astype(np.uint16) if rawmode in ("I;16", "I;16N", "I;16B") else v.astype(np.int32))[:, :, None]
    if rawmode in ("I;32N", "I;32S", "I;32BS"):
        v = rows[:, : 4 * width].copy().view(">i4" if rawmode == "I;32BS" else "<i4").reshape(n, width)
        return v.astype(np.int32)[:, :, None]
    if rawmode in ("F;32F", "F;32BF"):
        v = rows[:, : 4 * width].copy().view(">f4" if rawmode == "F;32BF" else "<f4").reshape(n, width)
        return v.astype(np.float32)[:, :, None]
    if ";16" in rawmode:  # RGB;16L / RGBA;16B / CMYK;16N ...: the high byte of each sample
        base, end = rawmode.split(";16")
        bands = len(base.replace("a", "A"))
        hi = 1 if end == "L" or end == "N" else 0
        v = rows[:, : 2 * bands * width].reshape(n, width, bands, 2)[..., hi]
        return _premultiplied(v, base)
    if rawmode in ("L", "L;I", "P", "L^"):  # L^: a LAB plane's a or b, stored offset by 128
        v = rows[:, :width]
        return (255 - v if rawmode == "L;I" else v ^ 0x80 if rawmode == "L^" else v)[:, :, None]
    if rawmode in ("LA", "PA", "PX", "RGB", "RGBX", "RGBXX", "RGBXXX", "RGBA", "RGBa", "RGBaX", "RGBaXX", "RGBAX",
                   "RGBAXX", "CMYK", "CMYKX", "CMYKXX", "LAB"):  # Pillow 12.1 keeps a TIFF's LAB bytes as they are
        bands = len(rawmode)
        v = rows[:, : bands * width].reshape(n, width, bands)
        return _premultiplied(v, rawmode)
    raise ValueError(f"raw mode {rawmode} is not supported")


def _premultiplied(v: np.ndarray, rawmode: str) -> np.ndarray:
    """The bands of mode pixels from a raw mode's bands: RGBa unpremultiplied (each of R, G, B times 255 //
    alpha, clipped; all zero where alpha is 0), X bands dropped."""
    keep = [i for i, c in enumerate(rawmode) if c != "X"]
    v = v[..., keep]
    if "a" in rawmode:
        a = v[..., 3:4].astype(np.int64)
        rgb = np.where(a == 0, 0, np.where(a == 255, v[..., :3], np.minimum(v[..., :3].astype(np.int64) * 255
                                                                              // np.maximum(a, 1), 255)))
        v = np.concatenate([rgb, np.where(a == 0, 0, a)], axis=-1).astype(np.uint8)
    return v


def to_rgb(px: np.ndarray, mode: str, palette: np.ndarray = None) -> np.ndarray:
    """convert("RGB") of mode pixels [H, W, bands] (Convert.c)."""
    if mode in ("1", "L", "LA"):
        g = px[..., 0]
        return np.repeat(g[:, :, None], 3, axis=2).astype(np.uint8)
    if mode in ("I;16", "I;16B"):
        g = np.minimum(px[..., 0].astype(np.int64), 255)
        return np.repeat(g[:, :, None], 3, axis=2).astype(np.uint8)
    if mode == "I":
        g = np.clip(px[..., 0].astype(np.int64), 0, 255)
        return np.repeat(g[:, :, None], 3, axis=2).astype(np.uint8)
    if mode == "F":
        with np.errstate(invalid="ignore"):  # a signalling NaN of float32 warns as it widens
            f = px[..., 0].astype(np.float64)  # Convert.c: <= 0 -> 0, >= 255 -> 255, else truncated; NaN -> 0
        g = np.where(np.isnan(f), 0, np.trunc(np.clip(np.nan_to_num(f, nan=0.0), 0, 255)))
        return np.repeat(g[:, :, None], 3, axis=2).astype(np.uint8)
    if mode in ("P", "PA"):
        return palette[px[..., 0]]
    if mode in ("RGB", "RGBA"):
        return px[..., :3].astype(np.uint8)
    if mode == "CMYK":
        nk = 255 - px[..., 3:4].astype(np.int64)
        t = px[..., :3].astype(np.int64) * nk + 128
        return (nk - (((t >> 8) + t) >> 8)).astype(np.uint8)
    if mode == "LAB":
        return lab_to_rgb(px[..., :3].astype(np.uint8))
    raise ValueError(f"mode {mode} is not supported")


_TRANSPOSE = {
    2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1],
    5: lambda a: a.transpose(1, 0, 2), 6: lambda a: np.rot90(a, -1), 7: lambda a: a[::-1, ::-1].transpose(1, 0, 2),
    8: lambda a: np.rot90(a, 1),
}


def orient(rgb: np.ndarray, orientation) -> np.ndarray:
    """ImageOps.exif_transpose of the decoded image."""
    fn = _TRANSPOSE.get(orientation) if isinstance(orientation, int) else None
    return np.ascontiguousarray(fn(rgb)) if fn else rgb


# --- the codecs


class ChunkError(ValueError):
    """A chunk libtiff's codec fails on, with what the failed call leaves in the first `size` bytes of the
    caller's buffer (`written`; the bytes past it stay as they were), which TIFFRGBAImage reads on with."""

    def __init__(self, msg: str, written: bytes = b""):
        super().__init__(msg)
        self.written = written


def lzw_decode(src: bytes, size: int, name: str) -> bytes:
    """libtiff's LZWDecode (MSB-first codes, early change) or LZWDecodeCompat (LSB-first, the old style,
    chosen by the stream's first two bytes) into `size` bytes; on an error the bytes decoded so far and zeros
    to `size` (its memset of the rest), in ChunkError."""
    out = bytearray()
    try:
        _lzw(src, size, name, out)
    except ValueError as err:
        raise ChunkError(str(err), bytes(out[:size]) + bytes(max(0, size - len(out)))) from None
    return bytes(out[:size])


def _lzw(src: bytes, size: int, name: str, out: bytearray) -> None:
    compat = len(src) >= 2 and src[0] == 0 and src[1] & 1
    prefix = list(range(258)) + [0] * 4096
    suffix = list(range(256)) + [0, 0] + [0] * 4096
    first = list(range(256)) + [0, 0] + [0] * 4096
    length = [1] * 258 + [0] * 4096
    strings = [bytes([i]) for i in range(256)] + [b"", b""]
    nbits, free, old = 9, 258, -2  # -2: before the first clear code, where LZWPreDecode leaves no free entry
    acc, nacc, pos = 0, 0, 0
    n = len(src)
    while len(out) < size:
        while nacc < nbits:
            if pos >= n:
                raise ValueError(f"{name}: LZW stream ends before the strip is full (not enough data)")
            if compat:
                acc |= src[pos] << nacc
            else:
                acc = (acc << 8) | src[pos]
            pos += 1
            nacc += 8
        if compat:
            code = acc & ((1 << nbits) - 1)
            acc >>= nbits
        else:
            code = (acc >> (nacc - nbits)) & ((1 << nbits) - 1)
            acc &= (1 << (nacc - nbits)) - 1
        nacc -= nbits
        if code == 257:
            break
        if code == 256:
            del strings[258:]
            nbits, free, old = 9, 258, -1
            continue
        if old == -2:  # libtiff 4.7's "Using code not yet in table"
            raise ValueError(f"{name}: corrupted LZW table (code {code} before the first clear code)")
        if old < 0:
            if code >= 256:
                raise ValueError(f"{name}: corrupted LZW table (a code above 255 after a clear)")
            out += strings[code]
            old = code
            continue
        if code < free:
            s = strings[code]
            entry = strings[old] + s[:1]
        elif code == free:
            entry = strings[old] + strings[old][:1]
            s = entry
        else:
            raise ValueError(f"{name}: corrupted LZW table (code {code} past the next free entry {free})")
        if free >= 4096:
            raise ValueError(f"{name}: corrupted LZW table (more than 4096 entries)")
        strings.append(entry)
        free += 1
        out += s
        old = code
        if free + (0 if compat else 1) >= (1 << nbits) and nbits < 12:
            nbits += 1
    if len(out) < size:
        raise ValueError(f"{name}: LZW stream ends before the strip is full (not enough data)")


def packbits_decode(src: bytes, size: int, name: str) -> bytes:
    """libtiff's PackBitsDecode into `size` bytes: a run cut short by the data's end is dropped (a literal run
    whole), and short data fails with the rest zeroed (ChunkError)."""
    out = bytearray()
    i, n = 0, len(src)
    while i < n and len(out) < size:
        c = src[i]
        i += 1
        if c >= 128:
            if c == 128:
                continue
            if i >= n:
                break
            out += bytes([src[i]]) * min(257 - c, size - len(out))
            i += 1
        else:
            take = min(c + 1, size - len(out))
            if i + take > n:
                break
            out += src[i: i + take]
            i += take
    if len(out) < size:
        raise ChunkError(f"{name}: PackBits stream ends before the strip is full (not enough data)",
                         bytes(out) + bytes(size - len(out)))
    return bytes(out)


def deflate_decode(src: bytes, size: int, name: str) -> bytes:
    """libtiff's ZIPDecode into `size` bytes; a failure leaves what inflate wrote before it and zeros to `size`
    (ChunkError)."""
    try:
        out = zlib.decompressobj().decompress(src, size)
    except zlib.error as err:
        raise ChunkError(f"{name}: corrupt Deflate data ({err})", _inflated_before_error(src, size)) from None
    if len(out) < size:
        raise ChunkError(f"{name}: Deflate stream ends before the strip is full (not enough data)",
                         out + bytes(size - len(out)))
    return out


def _huffman_decoder(lengths: list, incomplete_ok: bool):
    """zlib's inflate_table of code `lengths`: {(length, code): symbol}, None where it refuses the set (over-
    subscribed, or incomplete unless `incomplete_ok` and the set is a single code of length 1); a set of no code
    is taken, and no code decodes by it."""
    counts = [0] * 16
    for n in lengths:
        counts[n] += 1
    counts[0] = 0
    left, top = 1, max(lengths, default=0)
    if not top:
        return {}
    for n in range(1, 16):
        left = 2 * left - counts[n]
        if left < 0:
            return None
    if left > 0 and not (incomplete_ok and top == 1):
        return None
    code, nxt = 0, [0] * 16
    for n in range(1, 16):
        code = (code + counts[n - 1]) << 1
        nxt[n] = code
    table = {}
    for sym, n in enumerate(lengths):
        if n:
            table[(n, nxt[n])] = sym
            nxt[n] += 1
    return table


_LEN_BASE = [3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195,
             227, 258]
_LEN_EXTRA = [0] * 8 + [1] * 4 + [2] * 4 + [3] * 4 + [4] * 4 + [5] * 4 + [0]
_DIST_BASE = [1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193, 257, 385, 513, 769, 1025, 1537, 2049, 3073,
              4097, 6145, 8193, 12289, 16385, 24577]
_DIST_EXTRA = [0, 0, 0, 0] + [k // 2 for k in range(2, 28)]
_ORDER = [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15]


class _InflateStop(Exception):
    """Where zlib's inflate stops on a stream: a check it fails, or the data's end."""


def _inflated_before_error(src: bytes, size: int) -> bytes:
    """The `size` bytes libtiff's buffer holds after zlib's inflate fails on `src` (a zlib stream): the output of
    every symbol before the one zlib rejects, zeros after it.  zlib's checks: the header, the block types, the
    stored lengths, the code length sets (over-subscribed or incomplete ones refused, a single distance or
    literal code of length 1 allowed), the literal / length symbols 286-287 and distance symbols 30-31, a
    distance past the output, and the checksum (which fails after all the output)."""
    out = bytearray()
    pos = 0  # bit position

    def bits(n: int) -> int:
        nonlocal pos
        v = 0
        for k in range(n):
            if pos >> 3 >= len(src):
                raise _InflateStop("the data ends")
            v |= ((src[pos >> 3] >> (pos & 7)) & 1) << k
            pos += 1
        return v

    def symbol(table: dict) -> int:
        code = 0
        for n in range(1, 16):
            code = (code << 1) | bits(1)
            if (n, code) in table:
                return table[(n, code)]
        raise _InflateStop("invalid code")

    try:
        if len(src) < 2 or ((src[0] << 8) | src[1]) % 31 or src[0] & 15 != 8 or src[0] >> 4 > 7 or src[1] & 0x20:
            raise _InflateStop("bad header")
        pos = 16
        final = False
        while not final and len(out) < size:
            final, kind = bits(1), bits(2)
            if kind == 0:
                pos = (pos + 7) & ~7
                n, nn = bits(16), bits(16)
                if n != nn ^ 0xFFFF:
                    raise _InflateStop("invalid stored block lengths")
                for _ in range(n):
                    out.append(bits(8))
                continue
            if kind == 3:
                raise _InflateStop("invalid block type")
            if kind == 1:
                lit = _huffman_decoder([8] * 144 + [9] * 112 + [7] * 24 + [8] * 8, False)
                dist = _huffman_decoder([5] * 32, False)
            else:
                nlen, ndist, ncode = bits(5) + 257, bits(5) + 1, bits(4) + 4
                if nlen > 286 or ndist > 30:
                    raise _InflateStop("too many length or distance symbols")
                lens = [0] * 19
                for k in range(ncode):
                    lens[_ORDER[k]] = bits(3)
                codes = _huffman_decoder(lens, False)
                if codes is None:
                    raise _InflateStop("invalid code lengths set")
                lengths = []
                while len(lengths) < nlen + ndist:
                    sym = symbol(codes)
                    if sym < 16:
                        lengths.append(sym)
                        continue
                    if sym == 16:
                        if not lengths:
                            raise _InflateStop("invalid bit length repeat")
                        rep, value = 3 + bits(2), lengths[-1]
                    else:
                        rep, value = (3 + bits(3), 0) if sym == 17 else (11 + bits(7), 0)
                    if len(lengths) + rep > nlen + ndist:
                        raise _InflateStop("invalid bit length repeat")
                    lengths += [value] * rep
                if not lengths[256]:
                    raise _InflateStop("invalid code -- missing end-of-block")
                lit = _huffman_decoder(lengths[:nlen], True)
                if lit is None:
                    raise _InflateStop("invalid literal/lengths set")
                dist = _huffman_decoder(lengths[nlen:], True)
                if dist is None:
                    raise _InflateStop("invalid distances set")
            while True:
                sym = symbol(lit)
                if sym < 256:
                    out.append(sym)
                    continue
                if sym == 256:
                    break
                if sym > 285:
                    raise _InflateStop("invalid literal/length code")
                length = _LEN_BASE[sym - 257] + bits(_LEN_EXTRA[sym - 257])
                d = symbol(dist)
                if d > 29:
                    raise _InflateStop("invalid distance code")
                d = _DIST_BASE[d] + bits(_DIST_EXTRA[d])
                if d > len(out):
                    raise _InflateStop("invalid distance too far back")
                for _ in range(length):
                    out.append(out[-d])
    except _InflateStop:  # what inflate wrote before the symbol it rejects stays
        pass
    return bytes(out[:size]) + bytes(max(0, size - len(out)))


def lzma_decode(src: bytes, size: int, name: str) -> bytes:
    try:
        out = lzma.LZMADecompressor().decompress(src, size)
    except lzma.LZMAError as err:
        raise ValueError(f"{name}: corrupt LZMA data ({err})") from None
    if len(out) < size:
        raise ValueError(f"{name}: LZMA stream ends before the strip is full (not enough data)")
    return out


# T.4 modified Huffman codes: (code bits as a string) -> run length, for white and black; the makeup codes
# of 1792-2560 are shared
_WHITE_TERM = (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 001000 000011 110100 110101 101010 "
    "101011 0100111 0001100 0001000 0010111 0000011 0000100 0101000 0101011 0010011 0100100 0011000 00000010 "
    "00000011 00011010 00011011 00010010 00010011 00010100 00010101 00010110 00010111 00101000 00101001 00101010 "
    "00101011 00101100 00101101 00000100 00000101 00001010 00001011 01010010 01010011 01010100 01010101 00100100 "
    "00100101 01011000 01011001 01011010 01011011 01001010 01001011 00110010 00110011 00110100").split()
_WHITE_MAKEUP = (
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 01101000 01100111 011001100 011001101 011010010 "
    "011010011 011010100 011010101 011010110 011010111 011011000 011011001 011011010 011011011 010011000 010011001 "
    "010011010 011000 010011011").split()
_BLACK_TERM = (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 0000111 00000100 00000111 000011000 "
    "0000010111 0000011000 0000001000 00001100111 00001101000 00001101100 00000110111 00000101000 00000010111 "
    "00000011000 000011001010 000011001011 000011001100 000011001101 000001101000 000001101001 000001101010 "
    "000001101011 000011010010 000011010011 000011010100 000011010101 000011010110 000011010111 000001101100 "
    "000001101101 000011011010 000011011011 000001010100 000001010101 000001010110 000001010111 000001100100 "
    "000001100101 000001010010 000001010011 000000100100 000000110111 000000111000 000000100111 000000101000 "
    "000001011000 000001011001 000000101011 000000101100 000001011010 000001100110 000001100111").split()
_BLACK_MAKEUP = (
    "0000001111 000011001000 000011001001 000001011011 000000110011 000000110100 000000110101 0000001101100 "
    "0000001101101 0000001001010 0000001001011 0000001001100 0000001001101 0000001110010 0000001110011 "
    "0000001110100 0000001110101 0000001110110 0000001110111 0000001010010 0000001010011 0000001010100 "
    "0000001010101 0000001011010 0000001011011 0000001100100 0000001100101").split()
_EXT_MAKEUP = ("00000001000 00000001100 00000001101 000000010010 000000010011 000000010100 000000010101 000000010110 "
               "000000010111 000000011100 000000011101 000000011110 000000011111").split()


def _run_table(term: list, makeup: list) -> dict:
    table = {(len(c), int(c, 2)): i for i, c in enumerate(term)}
    table.update({(len(c), int(c, 2)): 64 * (i + 1) for i, c in enumerate(makeup)})
    table.update({(len(c), int(c, 2)): 1792 + 64 * i for i, c in enumerate(_EXT_MAKEUP)})
    return table


RUN_CODES = (_run_table(_WHITE_TERM, _WHITE_MAKEUP), _run_table(_BLACK_TERM, _BLACK_MAKEUP))


# tif_fax3sm.c's lookup tables, rebuilt from the codes: indexed by the next 7 / 12 / 13 bits of the stream
# (the first bit lowest), each entry (state, code width, parameter); states as in tif_fax3.h.  EOL is any
# window that starts with 11 zeros (7 in the 2-D mode table), consuming them
S_NULL, S_PASS, S_HORIZ, S_V0, S_VR, S_VL, S_EXT, S_TERMW, S_TERMB, S_MAKEUPW, S_MAKEUPB, S_MAKEUP, S_EOL = range(13)


def _fax_table(bits: int, codes: list) -> list:
    """[(state, width, param)] over every `bits`-bit window: the entry of the code its first bits spell."""
    table = [(S_NULL, 0, 0)] * (1 << bits)
    for code, state, param in codes:
        n = len(code)
        base = int(code[::-1], 2)
        for high in range(1 << (bits - n)):
            table[base | (high << n)] = (state, n, param)
    return table


MAIN_TABLE = _fax_table(7, [("0001", S_PASS, 0), ("001", S_HORIZ, 0), ("1", S_V0, 0), ("011", S_VR, 1),
                            ("000011", S_VR, 2), ("0000011", S_VR, 3), ("010", S_VL, 1), ("000010", S_VL, 2),
                            ("0000010", S_VL, 3), ("0000001", S_EXT, 0), ("0000000", S_EOL, 0)])
WHITE_TABLE = _fax_table(12, [(c, S_TERMW, i) for i, c in enumerate(_WHITE_TERM)]
                         + [(c, S_MAKEUPW, 64 * (i + 1)) for i, c in enumerate(_WHITE_MAKEUP)]
                         + [(c, S_MAKEUP, 1792 + 64 * i) for i, c in enumerate(_EXT_MAKEUP)]
                         + [("00000000000", S_EOL, 0)])
BLACK_TABLE = _fax_table(13, [(c, S_TERMB, i) for i, c in enumerate(_BLACK_TERM)]
                         + [(c, S_MAKEUPB, 64 * (i + 1)) for i, c in enumerate(_BLACK_MAKEUP)]
                         + [(c, S_MAKEUP, 1792 + 64 * i) for i, c in enumerate(_EXT_MAKEUP)]
                         + [("00000000000", S_EOL, 0)])


class _FaxEOF(Exception):
    """libtiff's premature EOF: a bit was needed and none was left."""


class _FaxError(Exception):
    """An error return of libtiff's decoders (a run array overflow)."""


class _NoEOL(Exception):
    """SYNC_EOL found 11 zeros but no 1 after them before the data ended (libtiff's noEOLFound)."""


class _Fax:
    """tif_fax3.c's decoder state over one strip: the bit accumulator (the stream's bits, first bit lowest,
    loaded a byte at a time; at the end of the data a request for more bits than are left pads with zeros
    -- BitsAvail = n -- and one with none left is a premature EOF), the row's runs (thisrun / pa / a0 /
    RunLength) and the reference row's (refruns / pb / b1), both in libtiff's two run arrays of nruns
    entries, which keep what earlier rows and strips left in them."""

    def __init__(self, src: bytes, runs: list, nruns: int, lastx: int):
        self.src, self.cp, self.acc, self.avail = src, 0, 0, 0
        self.arrays, self.nruns, self.lastx = runs, nruns, lastx
        self.cur, self.ref = 0, 1  # which array holds thisrun / refruns
        self.eol = 0  # EOLcnt

    # --- bits
    def need(self, n: int, two: bool) -> None:
        if self.avail >= n:
            return
        if self.cp >= len(self.src):
            if self.avail == 0:
                raise _FaxEOF
            self.avail = n
            return
        self.acc |= int(_REVERSE[self.src[self.cp]]) << self.avail
        self.cp += 1
        self.avail += 8
        if two and self.avail < n:
            if self.cp >= len(self.src):
                self.avail = n
            else:
                self.acc |= int(_REVERSE[self.src[self.cp]]) << self.avail
                self.cp += 1
                self.avail += 8

    def get(self, n: int) -> int:
        return self.acc & ((1 << n) - 1)

    def clr(self, n: int) -> None:
        self.avail -= n
        self.acc >>= n

    def lookup(self, table: list, n: int, two: bool = True):
        self.need(n, two)
        entry = table[self.get(n)]
        self.clr(entry[1])
        return entry

    # --- runs
    def start_row(self) -> None:
        self.pa, self.a0, self.run_length = 0, 0, 0

    def setvalue(self, x: int) -> None:  # SETVALUE
        if self.pa >= self.nruns:
            raise _FaxError("run array overflow")
        self.arrays[self.cur][self.pa] = self.run_length + x
        self.pa += 1
        self.a0 += x
        self.run_length = 0

    def cleanup(self) -> None:  # CLEANUP_RUNS: a row of another length cut or padded with white
        lastx, runs = self.lastx, self.arrays[self.cur]
        if self.run_length:
            self.setvalue(0)
        if self.a0 != lastx:
            while self.a0 > lastx and self.pa > 0:
                self.pa -= 1
                self.a0 -= runs[self.pa]
            if self.a0 < lastx:
                if self.a0 < 0:
                    self.a0 = 0
                if self.pa & 1:
                    self.setvalue(0)
                self.setvalue(lastx - self.a0)
            elif self.a0 > lastx:
                self.setvalue(lastx)
                self.setvalue(0)

    def fill(self) -> np.ndarray:
        """_TIFFFax3fillruns: the row's bits (1 black) from its runs, each cut at lastx."""
        lastx, runs, erun = self.lastx, self.arrays[self.cur], self.pa
        if erun & 1:  # a local copy of pa in libtiff: the caller's stays
            runs[erun] = 0
            erun += 1
        row = np.zeros(lastx, np.uint8)
        x = 0
        for k in range(0, erun, 2):
            for j, colour in ((k, 0), (k + 1, 1)):
                run = runs[j]
                if x + run > lastx or run > lastx:
                    run = runs[j] = lastx - x
                if run:
                    if colour:
                        row[x: x + run] = 1
                    x += run
        return row

    # --- rows
    def expand_1d(self) -> None:
        """EXPAND1D; an EOL code, a bad code word or a full row ends it."""
        lastx = self.lastx
        runs = self.arrays[self.cur]
        while True:
            for table, width, term, makeup in ((WHITE_TABLE, 12, S_TERMW, S_MAKEUPW),
                                               (BLACK_TABLE, 13, S_TERMB, S_MAKEUPB)):
                while True:
                    state, _, param = self.lookup(table, width)
                    if state == S_EOL:
                        self.eol = 1
                        self.cleanup()
                        return
                    if state == term:
                        self.setvalue(param)
                        break
                    if state in (makeup, S_MAKEUP):
                        self.a0 += param
                        self.run_length += param
                        continue
                    self.cleanup()  # a bad code word
                    return
                if self.a0 >= lastx:
                    self.cleanup()
                    return
            if self.pa >= 2 and runs[self.pa - 1] == 0 and runs[self.pa - 2] == 0:
                self.pa -= 2

    def expand_2d(self) -> None:
        """EXPAND2D against refruns."""
        lastx = self.lastx
        ref = self.arrays[self.ref]
        pb, b1 = 1, ref[0]

        def check_b1():
            nonlocal pb, b1
            if self.pa != 0:
                while b1 <= self.a0 and b1 < lastx:
                    if pb + 1 >= self.nruns:
                        raise _FaxError("reference run array overflow")
                    b1 += ref[pb] + ref[pb + 1]
                    pb += 2

        while self.a0 < lastx:
            if self.pa >= self.nruns:
                raise _FaxError("run array overflow")
            state, _, param = self.lookup(MAIN_TABLE, 7, two=False)
            if state == S_PASS:
                check_b1()
                if pb >= self.nruns:
                    raise _FaxError("reference run array overflow")
                b1 += ref[pb]
                pb += 1
                self.run_length += b1 - self.a0
                self.a0 = b1
                b1 += ref[pb]
                pb += 1
            elif state == S_HORIZ:
                order = ((WHITE_TABLE, 12, S_TERMW, S_MAKEUPW), (BLACK_TABLE, 13, S_TERMB, S_MAKEUPB))
                if self.pa & 1:
                    order = order[::-1]
                for table, width, term, makeup in order:
                    while True:
                        s2, _, p2 = self.lookup(table, width)
                        if s2 == term:
                            self.setvalue(p2)
                            break
                        if s2 in (makeup, S_MAKEUP):
                            self.a0 += p2
                            self.run_length += p2
                            continue
                        self.cleanup()  # a bad code word
                        return
                check_b1()
            elif state in (S_V0, S_VR):
                check_b1()
                self.setvalue(b1 - self.a0 + (param if state == S_VR else 0))
                if pb >= self.nruns:
                    raise _FaxError("reference run array overflow")
                b1 += ref[pb]
                pb += 1
            elif state == S_VL:
                check_b1()
                if b1 < self.a0 + param:
                    self.cleanup()  # unexpected VL
                    return
                self.setvalue(b1 - self.a0 - param)
                pb -= 1
                b1 -= ref[pb]
            elif state == S_EXT:
                self.arrays[self.cur][self.pa] = lastx - self.a0
                self.pa += 1
                self.cleanup()
                return
            elif state == S_EOL:
                self.arrays[self.cur][self.pa] = lastx - self.a0
                self.pa += 1
                self.need(4, False)
                self.clr(4)
                self.eol = 1
                self.cleanup()
                return
            else:
                self.cleanup()
                return
        if self.run_length:
            if self.run_length + self.a0 < lastx:  # a final V0 is expected
                self.need(1, False)
                if not self.get(1):
                    self.cleanup()
                    return
                self.clr(1)
            self.setvalue(0)
        self.cleanup()

    def sync_eol(self) -> None:
        """SYNC_EOL: to and past the next EOL (searching for 11 zeros unless an EOL code was just read); _NoEOL
        where the data ends before the EOL's 1."""
        if self.eol == 0:
            while True:
                self.need(11, True)
                if self.get(11) == 0:
                    break
                self.clr(1)
        while True:
            try:
                self.need(8, False)
            except _FaxEOF:
                raise _NoEOL from None
            if self.get(8):
                break
            self.clr(8)
        while self.get(1) == 0:
            self.clr(1)
        self.clr(1)
        self.eol = 0

    def end_row(self) -> None:
        """The row's runs, with libtiff's imaginary change, become the reference row."""
        if self.pa < self.nruns:
            self.setvalue(0)
        self.cur, self.ref = self.ref, self.cur


def fax_runs(width: int, needs_ref: bool) -> tuple:
    """libtiff's two run arrays (zeroed, as Fax3SetupState allocates them), nruns (doubled where rows are 2-D
    coded), and its mode bits, which FAXMODE_NOEOL joins for the rest of the image ([noeol])."""
    nruns = -(-(width + 1) // 32) * 32 * (2 if needs_ref else 1)
    return [[0] * nruns, [0] * nruns], nruns, [False]


def ccitt_decode(src: bytes, width: int, rows: int, compression: int, options: int, name: str,
                 runs: list = None) -> bytes:
    """One strip as libtiff 4.7's Fax3DecodeRLE (2), Fax3Decode1D / Fax3Decode2D (3, by T4Options bit 0) and
    Fax4Decode (4) decode it: `rows` rows of 1-bit pixels (1 = black, MSB first, each row padded to a byte).
    Bad code words and rows of the wrong length are patched up as libtiff does.  Where a Group 3 row's EOL
    search runs out of data after its zeros (noEOLFound), libtiff retries without EOLs: FAXMODE_NOEOL is set for
    the rest of the image and the strip is read again from its first bit (its retry label comes before
    CACHE_STATE), the rows written on from the one it stopped at.  Any other premature end of the data raises
    (libtiff fails the strip), except that Fax4Decode keeps the rows it has decoded when it has decoded any --
    whole only when the row it stopped in is the strip's last; earlier it leaves later rows as Pillow's strip
    buffer held them, uninitialised memory for the first strip, which raises UnsupportedImageFormat here.
    `runs` carries libtiff's run arrays and mode from strip to strip."""
    arrays, nruns, mode = runs if runs is not None else fax_runs(width, compression == 4 or bool(
        compression == 3 and options & 1))
    fx = _Fax(src, arrays, nruns, width)
    arrays[fx.ref][0], arrays[fx.ref][1] = width, 0  # Fax3PreDecode: an all-white reference row
    out = []
    try:
        while len(out) < rows:
            fx.start_row()
            try:
                if compression == 2:
                    fx.expand_1d()
                    fx.clr(fx.avail & 7)
                elif compression == 3:
                    if not mode[0]:
                        try:
                            fx.sync_eol()
                        except _NoEOL:
                            mode[0] = True
                            fx.cp, fx.acc, fx.avail, fx.eol = 0, 0, 0, 0
                            continue
                    if options & 1:
                        fx.need(1, False)
                        is_1d = fx.get(1)
                        fx.clr(1)
                        fx.expand_1d() if is_1d else fx.expand_2d()
                    else:
                        fx.expand_1d()
                else:
                    fx.expand_2d()
                    if fx.eol:
                        raise _FaxEOF
            except _FaxEOF:
                if compression == 4 and 0 < len(out) == rows - 1:  # Fax4Decode: the last row filled, success
                    fx.cleanup()
                    out.append(fx.fill())
                    break
                if compression == 4 and out:
                    from uniir_tpu_torch.data.jpeg import UnsupportedImageFormat

                    raise UnsupportedImageFormat(f"{name}: a Group 4 strip that ends at row {len(out)} of {rows}: "
                                                 "libtiff leaves the later rows as Pillow's buffer held them, which "
                                                 "the port does not know") from None
                raise ValueError(f"{name}: CCITT data ends before the strip is full (premature EOF at row "
                                 f"{len(out)})") from None
            out.append(fx.fill())
            if compression in (3, 4) and (options & 1 or compression == 4):
                fx.end_row()
    except _FaxError as err:
        raise ValueError(f"{name}: corrupt CCITT data at row {len(out)} ({err})") from None
    px = np.array(out, np.uint8).reshape(rows, width)
    return np.packbits(px, axis=1).tobytes()


def _predictor2(buf: np.ndarray, rows: int, width: int, spp: int, bits: int) -> np.ndarray:
    """Horizontal differencing undone on native-order samples, per row and sample."""
    dt = {8: np.uint8, 16: np.uint16, 32: np.uint32}[bits]
    v = buf.view(dt).reshape(rows, width, spp)
    return np.cumsum(v, axis=1, dtype=dt).reshape(-1).view(np.uint8)


def _predictor3(buf: np.ndarray, rows: int, width: int, spp: int, bits: int) -> np.ndarray:
    """libtiff's fpAcc: the bytes of each row summed with stride spp, then the byte planes (most significant
    first) interleaved into native (little-endian) values."""
    nb = bits // 8
    r = buf.reshape(rows, width * spp * nb)
    acc = np.cumsum(r.reshape(rows, width * nb, spp), axis=1, dtype=np.uint8).reshape(rows, -1)
    planes = acc.reshape(rows, nb, width * spp)
    return planes[:, ::-1, :].transpose(0, 2, 1).reshape(-1).copy()


# --- decoding


class _Layout(NamedTuple):
    """The chunks (strips or tiles) of the image: offsets, byte counts, and for chunk k its place: band
    layer, x, y, and its width and height in the file."""

    offsets: tuple
    counts: tuple
    tiled: bool
    cw: int
    ch: int


def _layout(t: Tiff, name: str) -> _Layout:
    if TILEOFFSETS in t.tags:
        tw, th = _one(t.tags, TILEWIDTH), _one(t.tags, TILELENGTH)
        if not isinstance(tw, int) or not isinstance(th, int) or tw <= 0 or th <= 0:
            raise ValueError(f"{name}: invalid TIFF tile dimensions")
        return _Layout(tuple(t.tags[TILEOFFSETS]), tuple(t.tags.get(TILEBYTECOUNTS, ())), True, tw, th)
    if STRIPOFFSETS in t.tags:
        rps = _one(t.tags, ROWSPERSTRIP, t.height)
        if not isinstance(rps, int) or rps <= 0:
            rps = t.height
        return _Layout(tuple(t.tags[STRIPOFFSETS]), tuple(t.tags.get(STRIPBYTECOUNTS, ())), False, t.width,
                       min(rps, t.height))
    raise ValueError(f"{name}: unknown TIFF data organization (no strips or tiles)")


def _palette(t: Tiff, name: str) -> np.ndarray:
    """The ColorMap as Pillow's palette: each 16-bit entry // 256, 256 entries (missing ones black)."""
    cmap = t.tags.get(COLORMAP)
    if cmap is None:
        raise ValueError(f"{name}: palette TIFF without a ColorMap")
    n = len(cmap) // 3
    pal = np.zeros((256, 3), np.uint8)
    v = np.array(cmap[: 3 * n], np.int64) // 256
    pal[: min(n, 256)] = (v.reshape(3, n).T & 0xFF)[:256]
    return pal


def _bands(mode: str) -> int:
    return {"1": 1, "L": 1, "P": 1, "I;16": 1, "I;16B": 1, "I": 1, "F": 1, "LA": 2, "PA": 2, "RGB": 3,
            "RGBA": 4, "CMYK": 4, "LAB": 3}[mode]


def _chunk_bytes(data: bytes, lay: _Layout, k: int, name: str) -> bytes:
    off = lay.offsets[k]
    if k >= len(lay.counts):
        raise ValueError(f"{name}: TIFF strip or tile {k} has no byte count")
    raw = data[off: off + lay.counts[k]]
    if len(raw) < lay.counts[k]:
        raise ValueError(f"{name}: truncated TIFF file (strip or tile {k} is cut short; read error)")
    return raw


def _plane_rawmode(t: Tiff, p: int, name: str) -> str:
    """TiffDecode.c's unpacker of plane p of a separate-planes image: band p of the mode, from 8-bit samples
    or the high byte of 16-bit ones (a plane past the mode's bands has none)."""
    if p >= _bands(t.mode) or t.bps[p] not in (8, 16):
        raise ValueError(f"{name}: no unpacker for plane {p} ({t.bps[p]} bits) of a {t.mode} TIFF with separate "
                         "planes (Pillow: decoder error)")
    return "L" if t.bps[p] == 8 else "L;16N"


class Plan(NamedTuple):
    """The strips and tiles of an image, as both decoders walk them: a row of `CHUNK_FIELDS` each, Pillow's
    raw modes the rows index, zlib / lzma chunks inflated beforehand (`pre`), and whether a separate-planes
    RGBA image is unpremultiplied at the end (TiffDecode.c's RGBa shuffle)."""

    chunks: list
    rawmodes: list
    pre: bytes
    premult: bool


# a chunk's row: kind (0: rows as they stand in the file, Pillow's raw decoder; 1: `Plan.pre` bytes; 2: the
# compressed bytes of the file), offset, length, x0, y0, width unpacked, rows, row stride, band (-1: every
# band), raw mode index, decoded size (kind 0: one row's bytes), chunk width
CHUNK_FIELDS = ("kind", "offset", "length", "x0", "y0", "width", "rows", "stride", "band", "rawmode", "size", "cw")


def plan(data: bytes, t: Tiff, name: str, inflate: bool) -> Plan:
    """The walk over strips and tiles of `_setup`'s tile list (compression 1: Pillow's raw decoder, planar
    layers by band letter, edge tiles by the stride rule) or TiffDecode.c's (every other compression: each
    plane's strips or tiles, libtiff's unpackers), with their refusals; `inflate`: zlib / lzma chunks
    decoded here."""
    rawmodes, chunks, pre = [], [], bytearray()

    def spec_of(rawmode: str) -> int:
        rawmodes.append(rawmode)
        return len(rawmodes) - 1

    lay = _layout(t, name)
    if t.compression == 1:
        offsets = lay.offsets
        w, h = lay.cw, lay.ch
        if w == t.width and h == t.height and t.planar != 2:
            offsets = offsets[-1:]
        layers = len(t.rawmode) if t.planar == 2 else 1
        x = y = layer = 0
        for offset in offsets:
            if layer >= layers:
                break
            rawmode = t.rawmode[layer] if t.planar == 2 else t.rawmode
            if (t.mode, rawmode) in _NO_UNPACKER:
                raise ValueError(f"{name}: unknown raw mode {rawmode} for a {t.mode} TIFF (Pillow has no unpacker)")
            band = -1
            if t.planar == 2:
                if rawmode not in ("R", "G", "B", "A", "C", "M", "Y", "K", "L", "P", "X"):
                    raise ValueError(f"{name}: unknown raw mode {rawmode} for a {t.mode} TIFF's planes (Pillow has "
                                     "no unpacker)")
                band = ("RGBA".index(rawmode.upper()) if t.mode in ("RGB", "RGBA") and rawmode in "RGBAa" else
                        "CMYK".index(rawmode) if t.mode == "CMYK" and rawmode in "CMYK" else
                        "LAB".index(rawmode) if t.mode == "LAB" else
                        0 if rawmode in ("L", "P") else 1 if rawmode == "A" else 99)
                if band >= _bands(t.mode):
                    band = -2  # a band the mode has not: read, not stored
                rawmode = "L^" if t.mode == "LAB" and band in (1, 2) else "L"
            x1, y1 = min(x + w, t.width), min(y + h, t.height)
            cw = x1 - x
            row_bytes = (cw * _raw_bits(rawmode) + 7) // 8
            stride = int(w * sum(t.bps) / 8) if x + w > t.width else 0
            if t.planar == 2:
                stride = int(stride / len(t.bps))
            if stride and stride < row_bytes:
                raise ValueError(f"{name}: TIFF tile stride {stride} below its row's {row_bytes} bytes")
            need = (stride or row_bytes) * (y1 - y - 1) + row_bytes
            if offset >= len(data) or len(data) - offset < need:
                raise ValueError(f"{name}: truncated TIFF file (image file is truncated)")
            if band != -2:
                chunks.append([0, offset, 0, x, y, cw, y1 - y, stride or row_bytes, band, spec_of(rawmode), row_bytes,
                               cw])
            x += w
            if x >= t.width:
                x, y = 0, y + h
                if y >= t.height:
                    y = 0
                    layer += 1
        return Plan(chunks, rawmodes, bytes(pre), False)
    if t.compression in (2, 3, 4) and t.bps != (1,):
        raise ValueError(f"{name}: CCITT compression needs 1 bit per sample")
    planar = t.planar == 2 and t.spp > 1
    planes = t.spp if planar else 1
    cw = lay.cw
    units = ycbcr_units(t, name) if t.photometric == 6 and t.compression != 7 else None
    if units:
        return _unit_plan(data, t, lay, name, units, inflate, spec_of, rawmodes)
    if planar:
        for p in range(planes):
            _plane_rawmode(t, p, name)
        row_bytes = (cw * max(t.bps) + 7) // 8
        plane_specs = [spec_of("L^" if t.mode == "LAB" and p in (1, 2) else "L" if t.bps[p] == 8 else "L;16N")
                       for p in range(planes)]
    else:
        row_bytes = (cw * sum(t.bps) + 7) // 8
        whole = spec_of("RGB" if t.photometric == 6 else t.rawmode)  # 1x1 YCbCr: Y, Cb, Cr as they stand
    across = -(-t.width // cw) if lay.tiled else 1
    down = -(-t.height // lay.ch)
    for p in range(planes):
        for j in range(down):
            for i in range(across):
                k = p * across * down + j * across + i
                if k >= len(lay.offsets):
                    raise ValueError(f"{name}: TIFF has fewer strips or tiles than its size needs")
                rows = lay.ch if lay.tiled else min(lay.ch, t.height - j * lay.ch)
                x0, y0 = i * cw, j * lay.ch
                x1 = min(x0 + cw, t.width)
                size = row_bytes * rows
                raw = _chunk_bytes(data, lay, k, name)
                kind, off, count = 2, lay.offsets[k], len(raw)
                if inflate and t.compression in (8, 32946, 34925):  # zlib / lzma here, releasing the GIL
                    if t.fillorder == 2:
                        raw = _REVERSE[np.frombuffer(raw, np.uint8)].tobytes()
                    try:
                        out = (deflate_decode if t.compression != 34925 else lzma_decode)(raw, size, name)
                    except ChunkError as err:  # outside TIFFRGBAImage a failed chunk fails the file
                        raise ValueError(str(err)) from None
                    kind, off, count = 1, len(pre), size
                    pre += out[:size]
                chunks.append([kind, off, count, x0, y0, x1 - x0, rows, row_bytes, p if planar else -1,
                               plane_specs[p] if planar else whole, size, cw])
    # libtiff names a missing ExtraSamples tag's fourth sample unspecified: unpremultiplied too
    premult = planar and t.mode == "RGBA" and t.extra[:1] in ((), (0,), (1,))
    return Plan(chunks, rawmodes, bytes(pre), premult)


def subsampling(t: Tiff) -> tuple:
    """YCbCrSubSampling as libtiff defaults it (2, 2)."""
    sub = tuple(t.tags.get(YCBCRSUBSAMPLING, (2, 2)))
    return sub if len(sub) == 2 else (sub + (2, 2))[:2]


# TIFFRGBAImage's put routines for contiguous YCbCr by subsampling, and the bytes each skips for a data unit left
# of a clipped tile's edge: 4x4 skips by the 4x2 unit's size (putcontig8bitYCbCr44tile's "(4 * 2 + 2)")
_PUT_SKIP = {(4, 4): 10, (4, 2): 10, (4, 1): 6, (2, 2): 6, (2, 1): 4, (1, 2): 4, (1, 1): 3}


def ycbcr_units(t: Tiff, name: str):
    """(horizontal, vertical) subsampling of contiguous YCbCr, which libtiff's TIFFRGBAImage reads in data units
    (each h x v block's Y samples, then Cb and Cr; 1x1: the samples as they stand), None for planes; ValueError
    where TIFFRGBAImage has no put routine (Pillow: decoder error)."""
    sub = subsampling(t)
    if t.bps != (8, 8, 8):
        raise ValueError(f"{name}: YCbCr with bits {t.bps} (TIFFRGBAImage reads 8-bit YCbCr only)")
    if t.planar == 2:
        if sub != (1, 1):
            raise ValueError(f"{name}: YCbCr in separate planes with subsampling {sub} (TIFFRGBAImage "
                             "reads planes at 1x1 only)")
        return None
    if sub not in _PUT_SKIP:
        raise ValueError(f"{name}: YCbCr subsampling {sub} (TIFFRGBAImage has no put routine for it)")
    return sub


def _unit_plan(data: bytes, t: Tiff, lay: _Layout, name: str, sub: tuple, inflate: bool, spec_of, rawmodes) -> Plan:
    """The chunks of contiguous YCbCr as TIFFRGBAImage reads them: a strip decoded to ceil(rows / v) rows of data
    units (a tile to its whole height), only the bytes gtStripContig asks for (its rows rounded up to v, times
    TIFFScanlineSize, which cuts an odd 4x4 unit row short; the rest of its buffer zeros); row r of units `stride`
    bytes after row r - 1 (a clipped tile skips the units right of its edge as `_PUT_SKIP` says).  A chunk
    libtiff cannot read (TIFFFillStrip / TIFFFillTile: no byte count, or bytes past the file's end) is kind 3
    (zeros where it does not fail the file); with `inflate`, a zlib chunk that fails is kind 4, its `pre` bytes
    what the failed call leaves."""
    sh, sv = sub
    unit = sh * sv + 2
    spec = spec_of(f"YCC;{sh}{sv}")
    across = -(-t.width // lay.cw) if lay.tiled else 1
    down = -(-t.height // lay.ch)
    row_units = -(-lay.cw // sh) * unit  # the bytes of one row of data units (a tile's, or the image's)
    chunks, pre = [], bytearray()
    for j in range(down):
        for i in range(across):
            k = j * across + i
            if k >= len(lay.offsets):
                raise ValueError(f"{name}: TIFF has fewer strips or tiles than its size needs")
            rows = lay.ch if lay.tiled else min(lay.ch, t.height - j * lay.ch)
            full = row_units * -(-rows // sv)
            size = full if lay.tiled else min(full, -(-rows // sv) * sv * (row_units // sv))
            x0, y0 = i * lay.cw, j * lay.ch
            vis = min(x0 + lay.cw, t.width) - x0
            stride = -(-vis // sh) * unit + (lay.cw - vis) // sh * _PUT_SKIP[sub]
            if k >= len(lay.counts) or not lay.counts[k] or lay.offsets[k] + lay.counts[k] > len(data):
                chunks.append([3, 0, 0, x0, y0, vis, rows, stride, -1, spec, size, lay.cw])
                continue
            raw = _chunk_bytes(data, lay, k, name)
            kind, off, count = 2, lay.offsets[k], len(raw)
            if inflate and t.compression in (8, 32946, 34925):
                if t.fillorder == 2:
                    raw = _REVERSE[np.frombuffer(raw, np.uint8)].tobytes()
                try:
                    out, kind = (deflate_decode if t.compression != 34925 else lzma_decode)(raw, size, name), 1
                except ChunkError as err:
                    out, kind = err.written, 4
                off, count = len(pre), size
                pre += out[:size]
            chunks.append([kind, off, count, x0, y0, vis, rows, stride, -1, spec, size, lay.cw])
    return Plan(chunks, rawmodes, bytes(pre), False)


def decode_twin(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """uint8 [H, W, 3]: `PIL.Image.open(...).convert("RGB")` of a TIFF file (module docstring)."""
    return _decode(bytes(data), name, native=False)


def _pixels_twin(data: bytes, t: Tiff, name: str, p: Plan) -> np.ndarray:
    """Mode pixels [H, W, bands] (uint8, or int32 / float32 for I;16, I and F) of the plan's chunks."""
    dtype = {"I;16": np.int32, "I;16B": np.int32, "I": np.int32, "F": np.float32}.get(t.mode, np.uint8)
    img = np.zeros((t.height, t.width, 3 if t.photometric == 6 else _bands(t.mode)), dtype)
    codec = _codec_for(t, name) if t.compression != 1 else None
    whole = np.frombuffer(data, np.uint8)

    def pre_or_codec(kind: int, off: int, count: int, size: int, rows: int, cw: int) -> bytes:
        return p.pre[off: off + size] if kind == 1 else codec(data[off: off + count], size, rows, cw)

    for kind, off, count, x0, y0, w, rows, stride, band, r, size, cw in p.chunks:
        rows = min(rows, t.height - y0)
        if p.rawmodes[r].startswith("YCC;"):
            sh, sv = int(p.rawmodes[r][4]), int(p.rawmodes[r][5])
            # gtStripContig's / gtTileContig's buffer: every call writes all `size` bytes it asks for, a chunk
            # that cannot be read zeros (TIFFReadEncodedTile's memset), so nothing of an earlier chunk shows
            held = bytearray(_strip_buffer(t, name))
            if kind != 3:
                try:
                    dec = pre_or_codec(kind, off, count, size, rows, cw)
                except ChunkError as err:  # TIFFRGBAImage reads on (Pillow passes stop = 0)
                    dec = err.written
                held[: len(dec)] = dec
            img[y0:y0 + rows, x0:x0 + w] = _units(held, sh, sv, stride, rows, w)
            continue
        if kind == 0:
            rows_arr = np.lib.stride_tricks.as_strided(whole[off:], (rows, size), (stride, 1))
        else:
            try:
                dec = codec(data[off: off + count], size, size // stride, cw)
            except ChunkError as err:  # outside TIFFRGBAImage a failed chunk fails the file
                raise ValueError(str(err)) from None
            rows_arr = np.frombuffer(dec, np.uint8)[: stride * rows].reshape(rows, stride)
        px = unpack(p.rawmodes[r], rows_arr, w)
        if band >= 0:
            img[y0:y0 + rows, x0:x0 + w, band] = px[..., 0]
        else:
            img[y0:y0 + rows, x0:x0 + w] = px
    return _premultiplied(img, "RGBa") if p.premult else img


def _strip_buffer(t: Tiff, name: str) -> int:
    """TIFFStripSize (TIFFTileSize) of contiguous YCbCr: the buffer TIFFRGBAImage decodes every strip into."""
    sub = ycbcr_units(t, name) if is_rgba_image(t) and t.compression != 7 else None
    if not sub:
        return 0
    lay = _layout(t, name)
    return -(-lay.cw // sub[0]) * (sub[0] * sub[1] + 2) * -(-lay.ch // sub[1])


def _unit_rowsize(t: Tiff, name: str) -> int:
    """The row size libtiff's PredictorSetup takes for contiguous YCbCr: TIFFScanlineSize of a strip (a row of
    data units over v, rounded down) or TIFFTileRowSize of a tile (its width times 3, subsampling ignored)."""
    lay = _layout(t, name)
    sh, sv = ycbcr_units(t, name)
    return lay.cw * 3 if lay.tiled else -(-t.width // sh) * (sh * sv + 2) // sv


def _predictor2_units(buf: np.ndarray, rowsize: int, name: str) -> np.ndarray:
    """tif_predict.c's PredictorDecodeTile with horAcc8 over contiguous YCbCr data units: sums of every third
    byte within each `rowsize` bytes; a chunk not a whole number of rows, or rows not of whole 3-byte strides,
    fails with the bytes left undifferenced (ChunkError)."""
    if buf.size % rowsize or rowsize % 3:
        raise ChunkError(f"{name}: horizontal differencing over rows of {rowsize} bytes in a chunk of {buf.size} "
                         "(libtiff's predictor fails)", buf.tobytes())
    return np.cumsum(buf.reshape(-1, rowsize // 3, 3), axis=1, dtype=np.uint8).reshape(-1)


def _units(buf, sh: int, sv: int, stride: int, rows: int, width: int) -> np.ndarray:
    """[rows, width, 3] Y, Cb, Cr of data units as TIFFRGBAImage's putcontig8bitYCbCr routines place them: each
    pixel the Y of its place in its h x v block and the block's Cb and Cr."""
    unit = sh * sv + 2
    y, x = np.mgrid[0:rows, 0:width]
    at = (y // sv) * stride + (x // sh) * unit
    b = np.frombuffer(bytes(buf), np.uint8)
    return np.stack([b[at + (y % sv) * sh + x % sh], b[at + sh * sv], b[at + sh * sv + 1]], axis=2)


def _predictor(t: Tiff, name: str) -> int:
    """The predictor libtiff undoes: only its LZW, Deflate, LZMA and ZSTD codecs call TIFFPredictorInit; the others
    ignore the tag."""
    predictor = _one(t.tags, PREDICTOR, 1) if t.compression in PREDICTED else 1
    sample_bits = t.bps[0]
    if predictor not in (1, 2, 3):
        raise ValueError(f"{name}: TIFF predictor {predictor} (libtiff's PredictorSetup refuses it)")
    if predictor == 2 and sample_bits not in (8, 16, 32):
        raise ValueError(f"{name}: horizontal differencing with {sample_bits}-bit samples (libtiff's PredictorSetup "
                         "refuses it)")
    if predictor == 3 and (sample_bits not in (16, 24, 32, 64) or tuple(t.tags.get(SAMPLEFORMAT, (1,)))[0] != 3):
        raise ValueError(f"{name}: floating point predictor with {sample_bits}-bit samples of sample format "
                         f"{tuple(t.tags.get(SAMPLEFORMAT, (1,)))[0]} (libtiff's PredictorSetup refuses it)")
    return predictor


def _codec_for(t: Tiff, name: str):
    """The chunk decoder of t's compression: raw bytes -> the decoded chunk, FillOrder and predictor undone."""
    predictor = _predictor(t, name)
    spp = 1 if t.planar == 2 else t.spp
    sample_bits = t.bps[0]
    unit_rowsize = _unit_rowsize(t, name) if predictor == 2 and _strip_buffer(t, name) else 0
    swap = t.order == "MM" and sample_bits in (16, 32) and all(b == sample_bits for b in t.bps)
    fax = None  # libtiff's CCITT run arrays, which live from strip to strip

    def codec(raw: bytes, size: int, rows: int, width: int) -> bytes:
        nonlocal fax
        if t.fillorder == 2 and t.compression != 7:
            raw = _REVERSE[np.frombuffer(raw, np.uint8)].tobytes()
        if t.compression in (8, 32946):
            out = deflate_decode(raw, size, name)
        elif t.compression == 34925:
            out = lzma_decode(raw, size, name)
        elif t.compression == 5:
            out = lzw_decode(raw, size, name)
        elif t.compression == 32773:
            out = packbits_decode(raw, size, name)
        elif t.compression == 50000:
            out = zstd.decode_stream(raw, size, name)
        elif t.compression in (2, 3, 4):
            options = _one(t.tags, T4OPTIONS, 0) or 0
            if fax is None:
                fax = fax_runs(width, t.compression == 4 or bool(t.compression == 3 and options & 1))
            out = ccitt_decode(raw, width, rows, t.compression, options, name, fax)
        else:
            raise ValueError(f"{name}: TIFF compression {t.compression} has no chunk decoder")
        buf = np.frombuffer(out, np.uint8)[:size].copy()
        if swap and predictor != 3:  # libtiff's postdecode: samples to native (little-endian) order
            buf = buf.view(f">u{sample_bits // 8}").astype(f"<u{sample_bits // 8}").view(np.uint8)
        if unit_rowsize:
            buf = _predictor2_units(buf, unit_rowsize, name)
        elif predictor == 2:
            buf = _predictor2(buf, rows, width, spp, sample_bits)
        elif predictor == 3:
            buf = _predictor3(buf, rows, width, spp, sample_bits)
        return buf.tobytes()

    return codec


def _jpeg_chunks(data: bytes, t: Tiff, name: str, native: bool) -> np.ndarray:
    """JPEG (7) strips or tiles: each an abbreviated stream completed by JPEGTables, decoded at libjpeg's
    defaults, YCbCr converted to RGB only for contiguous photometric 6 (JPEGCOLORMODE_RGB), each plane of
    separate planes a one-component stream.  libtiff's source manager gives a fake EOI where a strip's data
    ends, and its codec ignores errors past a single-scan frame's scan (`jpeg.parse`'s libtiff reading)."""
    from uniir_tpu_torch.data import jpeg

    tables = bytes(t.tags.get(JPEGTABLES, b""))
    if tables and (tables[:2] != b"\xff\xd8" or tables[-2:] != b"\xff\xd9"):
        raise ValueError(f"{name}: bad JPEGTables tag")
    planes = t.spp if t.planar == 2 and t.spp > 1 else 1
    colour = "ycbcr" if t.photometric == 6 and planes == 1 else "unknown"
    decode = jpeg.decode_samples_native if native else jpeg.decode_samples
    lay = _layout(t, name)
    across = -(-t.width // lay.cw) if lay.tiled else 1
    down = -(-t.height // lay.ch)
    img = None
    for p in range(planes):
        for j in range(down):
            for i in range(across):
                k = (p * down + j) * across + i
                if k >= len(lay.offsets):
                    raise ValueError(f"{name}: TIFF has fewer strips or tiles than its size needs")
                raw = _chunk_bytes(data, lay, k, name)
                if raw[:2] != b"\xff\xd8":
                    raise ValueError(f"{name}: JPEG strip or tile {k} does not start with SOI")
                stream = ((tables[:-2] + raw[2:]) if tables else raw) + b"\xff\xd9"
                rows = lay.ch if lay.tiled else min(lay.ch, t.height - j * lay.ch)
                px = decode(stream, f"{name}: JPEG strip or tile {k}", colour, libtiff=True)
                if px.shape[0] < rows or px.shape[1] < lay.cw:
                    raise ValueError(f"{name}: JPEG strip or tile {k} is {px.shape[1]} x {px.shape[0]}, smaller "
                                     f"than {lay.cw} x {rows}")
                x0, y0 = i * lay.cw, j * lay.ch
                x1, y1 = min(x0 + lay.cw, t.width), min(y0 + rows, t.height)
                if planes > 1 and px.shape[2] != 1:
                    raise ValueError(f"{name}: JPEG plane {p} of {px.shape[2]} components")
                if img is None:
                    img = np.zeros((t.height, t.width, px.shape[2] * planes), np.uint8)
                if planes > 1:
                    img[y0:y1, x0:x1, p] = px[: y1 - y0, : x1 - x0, 0]
                    continue
                if px.shape[2] != img.shape[2]:
                    raise ValueError(f"{name}: JPEG strips with different component counts")
                img[y0:y1, x0:x1] = px[: y1 - y0, : x1 - x0]
    if t.rawmode == "RGB" or t.mode == "L":
        need = 3 if t.rawmode == "RGB" else 1
    else:
        need = {"RGB": 3, "CMYK": 4}.get(t.mode, 0)
    if img.shape[2] != need:
        raise ValueError(f"{name}: JPEG strips of {img.shape[2]} components for a {t.mode} TIFF")
    return img


def ycbcr_tables(luma, ref):
    """tif_color.c's TIFFYCbCrToRGBInit: (Y, Cr->R, Cb->B, Cr->G, Cb->G) tables over the 256 codes, in
    libtiff's float32 arithmetic."""
    f32 = np.float32
    lr, lg, lb = (f32(v) for v in luma)
    rb = [f32(v) for v in ref]

    def fix(x):  # FIX: (int32)(x * 65536 + 0.5), x clamped to [0, 2]
        x = min(max(x, f32(0)), f32(2))
        return int(float(f32(x * f32(65536))) + 0.5)

    f1 = f32(2) - f32(2) * lr
    d1 = fix(f1)
    d2 = -fix(f32(f32(lr * f1) / lg))
    f3 = f32(2) - f32(2) * lb
    d3 = fix(f3)
    d4 = -fix(f32(f32(lb * f3) / lg))

    def code2v(c, black, white, cr):
        denom = f32(white - black) if white - black != 0 else f32(1)
        return f32(f32(f32(c) - black) * f32(cr)) / denom

    def clampw(v, lo, hi):
        return lo if not v >= lo else (hi if v > hi else v)

    y_tab, crr, cbb, crg, cbg = [], [], [], [], []
    for i in range(256):
        x = i - 128
        cr = int(clampw(code2v(x, rb[4] - f32(128), rb[5] - f32(128), 127), f32(-128 * 32), f32(128 * 32)))
        cb = int(clampw(code2v(x, rb[2] - f32(128), rb[3] - f32(128), 127), f32(-128 * 32), f32(128 * 32)))
        crr.append((d1 * cr + 32768) >> 16)
        cbb.append((d3 * cb + 32768) >> 16)
        crg.append(d2 * cr)
        cbg.append(d4 * cb + 32768)
        y_tab.append(int(clampw(code2v(x + 128, rb[0], rb[1], 255), f32(-128 * 32), f32(128 * 32))))
    return tuple(np.array(v, np.int64) for v in (y_tab, crr, cbb, crg, cbg))


def _decode(data: bytes, name: str, native: bool) -> np.ndarray:
    t = parse(data, name)
    palette = _palette(t, name) if t.mode in ("P", "PA") else None
    if t.compression == 7 and not is_rgba_image(t):
        return orient(to_rgb(_jpeg_chunks(data, t, name, native), t.mode, palette), t.orientation)
    if is_rgba_image(t):
        return _rgba_image(data, t, name, native)
    p = plan(data, t, name, inflate=native)
    if native:
        return _decode_native(data, t, name, p, palette)
    return orient(to_rgb(_pixels_twin(data, t, name, p), t.mode, palette), t.orientation)


def is_rgba_image(t: Tiff) -> bool:
    """Whether Pillow reads the image through libtiff's TIFFRGBAImage: YCbCr under a codec other than JPEG, or
    JPEG in separate planes (an uncompressed one goes through Pillow's own raw decoder, raw mode RGBX, no
    conversion; contiguous JPEG through libjpeg's own conversion)."""
    return t.photometric == 6 and t.compression != 1 and (t.compression != 7 or t.planar == 2)


def _rgba_image(data: bytes, t: Tiff, name: str, native: bool) -> np.ndarray:
    """RGB of YCbCr as TIFFRGBAImage gives it (data units or planes, libtiff's YCbCr -> RGB tables), then
    Pillow's exif_transpose (TIFFRGBAImage itself flips nothing for Pillow).  Pillow begins it with stop = 0, so
    gtStripContig / gtTileContig read on past a contiguous chunk that fails to decode, with their buffer as the
    failure left it (`_pixels_twin`); a chunk that cannot be read fails the file where it starts one of Pillow's
    calls (a strip, or a row of tiles), whose buffer is then not yet allocated.  Damage elsewhere -- planes,
    JPEG planes, LZMA chunks -- raises UnsupportedImageFormat: gtStripSeparate's buffer and libjpeg's and
    liblzma's partial output are not modelled."""
    from uniir_tpu_torch.data.jpeg import UnsupportedImageFormat

    ycbcr_units(t, name)
    _predictor(t, name)
    _chunk_bytes(data, _layout(t, name), 0, name)

    def unmodelled(err: ValueError) -> UnsupportedImageFormat:
        return UnsupportedImageFormat(f"{name}: damaged YCbCr TIFF data, which libtiff's TIFFRGBAImage decodes on "
                                      f"past ({str(err).removeprefix(name + ': ')})")

    try:
        if t.compression == 7:  # JPEG planes, YCbCr 1x1 (ycbcr_units)
            px = _jpeg_chunks(data, t, name, native)
        else:
            p = plan(data, t, name, inflate=native)
    except UnsupportedImageFormat:
        raise
    except ValueError as err:
        raise unmodelled(err) from None
    if t.compression != 7:
        unread = [k for k, c in enumerate(p.chunks) if c[0] == 3 and c[3] == 0]
        if unread:
            raise ValueError(f"{name}: truncated TIFF file (strip or tile {unread[0]} cannot be read; read error)")
        try:
            if native:
                return _decode_native(data, t, name, p, None)  # converted and transposed there
            px = _pixels_twin(data, t, name, p)
        except UnsupportedImageFormat:
            raise
        except ValueError as err:
            raise unmodelled(err) from None
    y_tab, cr_r, cb_b, cr_g, cb_g = _ycc_of(t)
    y, cb, cr = (px[..., k].astype(np.int64) for k in range(3))
    rgb = np.stack([y_tab[y] + cr_r[cr], y_tab[y] + ((cb_g[cb] + cr_g[cr]) >> 16), y_tab[y] + cb_b[cb]], axis=2)
    return orient(np.clip(rgb, 0, 255).astype(np.uint8), t.orientation)


def _ycc_of(t: Tiff) -> tuple:
    """libtiff's YCbCr -> RGB tables for the file's coefficients and ReferenceBlackWhite."""
    luma = tuple(t.tags.get(YCBCRCOEFFICIENTS, (0.299, 0.587, 0.114)))
    ref = tuple(t.tags.get(REFBLACKWHITE, (0.0, 255.0, 128.0, 255.0, 128.0, 255.0)))
    return ycbcr_tables(luma, ref)


# --- the native decoder

# csrc/tiff.cu's unpacking ops (`Op`) and conversions (`Mode`)
_OP = {"packed": 0, "bytes": 1, "high16": 2, "u16": 3, "s16": 4, "s32": 5, "f32": 6, "u12": 7, "units": 8}
# (LAB is unpacked natively, its samples kept as RGB, and converted by `lab_to_rgb` after the call)
_NATIVE_MODE = {"1": 0, "L": 0, "LA": 0, "I;16": 1, "I;16B": 1, "I": 2, "F": 3, "P": 4, "PA": 4, "RGB": 5, "RGBA": 5,
                "CMYK": 6, "LAB": 5}
_SINGLE = {"I;16": ("u16", 0), "I;16N": ("u16", 0), "I;16B": ("u16", 1), "I;16S": ("s16", 0), "I;16BS": ("s16", 1),
           "I;32N": ("s32", 0), "I;32S": ("s32", 0), "I;32BS": ("s32", 1), "F;32F": ("f32", 0),
           "F;32BF": ("f32", 1), "I;12": ("u12", 0)}


def native_spec(rawmode: str) -> list:
    """csrc/tiff.cu's Spec of one of Pillow's raw modes, as `unpack` reads it: op, bits of a pixel, input bands,
    the kept bands (4 bits each, 15 ends), invert, bit-reversed bytes, big-endian, RGBa, scale."""
    if rawmode.startswith("YCC;"):  # data units: h, v, the unit's bytes
        sh, sv = int(rawmode[4]), int(rawmode[5])
        return [_OP["units"], sh, sv, 0xFFFF, 0, 0, 0, 0, sh * sv + 2]
    reverse = rawmode in _BIT_REVERSED
    raw = _BIT_REVERSED.get(rawmode, rawmode)
    bits = _raw_bits(raw)
    if raw in ("1", "1;I", "L;2", "L;2I", "L;4", "L;4I", "P;1", "P;2", "P;4"):
        scale = 1 if raw[0] == "P" else {1: 255, 2: 0x55, 4: 0x11}[bits]
        return [_OP["packed"], bits, 1, 0xFFF0, int(raw.endswith("I")), int(reverse), 0, 0, scale]
    if raw in _SINGLE:
        op, big = _SINGLE[raw]
        return [_OP[op], bits, 1, 0xFFF0, 0, int(reverse), big, 0, 1]
    base, _, size = raw.partition(";")
    if raw == "L^":  # invert 2: the sign bit flipped
        return [_OP["bytes"], 8, 1, 0xFFF0, 2, 0, 0, 0, 1]
    if base in ("L", "P") and size in ("", "I"):
        return [_OP["bytes"], 8, 1, 0xFFF0, int(size == "I"), int(reverse), 0, 0, 1]
    keep = [i for i, c in enumerate(base) if c != "X"][:4]
    packed = sum(b << (4 * i) for i, b in enumerate(keep)) | (0xFFFF << (4 * len(keep)) & 0xFFFF)
    op = "high16" if size.startswith("16") else "bytes"
    return [_OP[op], bits, len(base), packed, 0, int(reverse), int(size == "16B"), int("a" in base), 1]


def _decode_native(data: bytes, t: Tiff, name: str, p: Plan, palette) -> np.ndarray:
    from uniir_tpu_torch import _build

    lib = _build.load("tiff")
    if is_rgba_image(t):
        ycc = np.concatenate(_ycc_of(t)).astype(np.int64)
        mode, storage, bands = 7, 0, 3
    else:
        ycc = np.zeros(5 * 256, np.int64)
        mode = _NATIVE_MODE[t.mode]
        storage = {"I;16": 1, "I;16B": 1, "I": 1, "F": 2}.get(t.mode, 0)
        bands = _bands(t.mode)
    predictor = _predictor(t, name)
    sample_bits = t.bps[0]
    swap = (sample_bits // 8 if t.compression != 1 and t.order == "MM" and sample_bits in (16, 32)
            and all(b == sample_bits for b in t.bps) and predictor != 3 else 0)
    orientation = t.orientation if t.orientation in range(2, 9) else 1
    params = np.array([t.width, t.height, bands, storage, mode, t.compression, _one(t.tags, T4OPTIONS, 0) or 0,
                       predictor, t.fillorder, swap, 1 if t.planar == 2 else t.spp, max(sample_bits // 8, 1),
                       orientation, int(p.premult), _strip_buffer(t, name),
                       _unit_rowsize(t, name) if predictor == 2 and _strip_buffer(t, name) else 0], np.int32)
    chunk_arr = np.array(p.chunks, np.int64).reshape(-1, len(CHUNK_FIELDS))
    spec_arr = np.array([native_spec(r) for r in p.rawmodes], np.int32).reshape(-1, 9)
    palette = palette.tobytes() if palette is not None else bytes(768)
    h, w = (t.width, t.height) if orientation >= 5 else (t.height, t.width)
    out = np.empty((h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(256)
    if lib.uniir_tiff_decode(data, len(data), chunk_arr.ctypes.data, len(chunk_arr), spec_arr.ctypes.data,
                             len(spec_arr), params.ctypes.data, p.pre, len(p.pre), palette, ycc.ctypes.data,
                             out.ctypes.data, err, len(err)) != 0:
        msg = err.value.decode()
        if msg.startswith("unsupported: "):
            from uniir_tpu_torch.data.jpeg import UnsupportedImageFormat

            raise UnsupportedImageFormat(f"{name}: {msg.removeprefix('unsupported: ')}")
        raise ValueError(f"{name}: {msg}")
    return lab_to_rgb(out) if t.mode == "LAB" else out


def decode_native(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """`decode_twin` through csrc/tiff.cu (built on first use), one call an image; JPEG strips through the
    native JPEG decoder."""
    out = _decode(bytes(data), name, native=True)
    with _calls_lock:
        decode_native.calls += 1
    return out


decode_native.calls = 0  # decodes that went through the native library (read by chip_smoke.py)
_calls_lock = threading.Lock()  # the loader's threads decode at once


def decoder_for(device) -> Callable[[bytes, str], np.ndarray]:
    """The decoder a run on `device` uses: the native one on a CUDA run's host, the twin on a CPU run."""
    from uniir_tpu_torch import _build

    return decode_native if _build.is_cuda(device) else decode_twin


def accepts(data: bytes) -> bool:
    """TiffImagePlugin._accept: one of the six prefixes."""
    return data[:4] in PREFIXES
