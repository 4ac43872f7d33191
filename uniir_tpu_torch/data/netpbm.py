"""Netpbm (PBM / PGM / PPM / PFM) decoding with Pillow's pixels, without Pillow.

The JAX package reads every image with `PIL.Image.open(path).convert("RGB")`.
For a Netpbm file this module gives the same uint8 [H, W, 3] array as
Pillow 12.1's `PpmImagePlugin`:

  * the header as Pillow tokenises it: a magic of at most 6 bytes ended by
    whitespace (P1 - P6, Pf, and Pillow's own P0CMYK, PyP, PyRGBA,
    PyCMYK; anything else, PF included, is not a file Pillow opens), then
    width, height and maxval (a scale for Pf) as tokens of at most 10 bytes
    read by `int` / `float`, `#` skipping to the end of its line *inside*
    a token as between tokens, the data right after the one whitespace byte
    that ends the last token;
  * P4 / P5 / P6 at maxval 255 (and P5 at 65535, big-endian `I;16B`) as raw
    rows: 1-bit rows padded to bytes, 1 black; too little data raises
    ("image file is truncated");
  * other maxvals through `PpmDecoder`: one byte a sample below 256, two
    (big-endian) from 256, each scaled by round(v / maxval * 255) (65535
    for greyscale above 255, which Pillow holds as mode `I`), clamped;
  * plain P1 / P2 / P3 through `PpmPlainDecoder`: `#` comments cut out to
    the end of their line before tokenising (so a comment inside a number
    joins its halves), P1 one digit a pixel with or without whitespace,
    values above maxval or negative raise, too few values raise;
  * Pf: float32 rows bottom-up, little-endian when the scale is negative;
  * `convert("RGB")`: greyscale repeated, mode `I` clamped to 0 ... 255, `F`
    truncated and clamped (NaN to 0), CMYK by Pillow's cmyk2rgb, RGBA's
    alpha dropped, PyP's palette-less indices black.

Anything Pillow refuses raises ValueError naming the file.  numpy only.
"""

from __future__ import annotations

import math

import numpy as np

from uniir_tpu_torch.data import bmp, tiff

WHITESPACE = b"\x20\x09\x0a\x0b\x0c\x0d"
MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L", b"P6": "RGB", b"P0CMYK": "CMYK",
         b"Pf": "F", b"PyP": "P", b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}
BANDS = {"1": 1, "L": 1, "I": 1, "F": 1, "P": 1, "RGB": 3, "RGBA": 4, "CMYK": 4}


def accepts(data: bytes) -> bool:
    """PpmImagePlugin._accept."""
    return len(data) >= 2 and data[:1] == b"P" and data[1] in b"0123456fy"


class _Header:
    def __init__(self, data: bytes, name: str):
        self.data, self.name, self.pos = data, name, 0

    def read(self) -> bytes:
        c = self.data[self.pos : self.pos + 1]
        self.pos += len(c)
        return c

    def magic(self) -> bytes:
        out = b""
        for _ in range(6):
            c = self.read()
            if not c or c in WHITESPACE:
                break
            out += c
        return out

    def token(self) -> bytes:
        tok = b""
        while len(tok) <= 10:
            c = self.read()
            if not c:
                break
            if c in WHITESPACE:
                if not tok:
                    continue
                break
            if c == b"#":
                while self.read() not in b"\r\n":  # b"" (the end) is in it too
                    pass
                continue
            tok += c
        if not tok:
            raise ValueError(f"{self.name}: reached EOF while reading the Netpbm header")
        if len(tok) > 10:
            raise ValueError(f"{self.name}: token too long in the Netpbm header")
        return tok


def _int(tok: bytes, name: str) -> int:
    try:
        return int(tok)
    except ValueError as e:
        raise ValueError(f"{name}: bad Netpbm header token {tok!r}") from e


def _strip_comments(block: bytes) -> bytes:
    """PpmPlainDecoder._ignore_comments over the whole data: '#' to the first CR or LF, both cut."""
    out, pos = bytearray(), 0
    while True:
        start = block.find(b"#", pos)
        if start < 0:
            return bytes(out + block[pos:])
        out += block[pos:start]
        ends = [e for e in (block.find(b"\n", start), block.find(b"\r", start)) if e >= 0]
        if not ends:
            return bytes(out)
        pos = min(ends) + 1


def _plain(data: bytes, mode: str, maxval: int, count: int, name: str) -> np.ndarray:
    """The `count` samples of a plain file, as PpmPlainDecoder scales them."""
    block = _strip_comments(data)
    if mode == "1":
        digits = b"".join(block.split())
        bad = digits[:count].translate(None, b"01")
        if bad:
            raise ValueError(f"{name}: invalid token for a plain PBM: {bad[:1]!r}")
        if len(digits) < count:
            raise ValueError(f"{name}: not enough image data")
        return np.where(np.frombuffer(digits[:count], np.uint8) == ord("1"), 0, 255).astype(np.int64)
    out_max = 65535 if mode == "I" else 255
    values = []
    for tok in block.split():
        if len(tok) > 10:
            raise ValueError(f"{name}: token too long in the data: {tok[:11]!r}")
        v = _int(tok, name)
        if v < 0 or v > maxval:
            raise ValueError(f"{name}: channel value {v} outside 0 ... {maxval}")
        values.append(round(v / maxval * out_max))
        if len(values) == count:
            break
    if len(values) < count:
        raise ValueError(f"{name}: not enough image data")
    return np.array(values, np.int64)


def _scaled(data: bytes, mode: str, maxval: int, count: int, name: str) -> np.ndarray:
    """PpmDecoder: samples of one or two big-endian bytes, scaled to 255 (65535 for mode I), clamped."""
    width = 1 if maxval < 256 else 2
    raw = np.frombuffer(data[: count * width], np.uint8 if width == 1 else ">u2")
    if raw.size < count:
        raise ValueError(f"{name}: not enough image data")
    out_max = 65535 if mode == "I" else 255
    return np.minimum(out_max, np.rint(raw.astype(np.float64) / maxval * out_max)).astype(np.int64)


def mode(data: bytes, name: str = "<bytes>") -> str:
    """The mode Pillow opens a Netpbm file in (its header alone)."""
    return _open(bytes(data), name)[0]


def _open(data: bytes, name: str) -> tuple:
    """PpmImageFile._open: (mode, width, height, maxval, scale, the data's offset, plain)."""
    h = _Header(data, name)
    magic = h.magic()
    if magic not in MODES:
        raise ValueError(f"{name}: not a PPM file (magic {magic!r}; cannot identify image file)")
    mode = MODES[magic]
    width, height = _int(h.token(), name), _int(h.token(), name)
    if width <= 0 or height <= 0:
        raise ValueError(f"{name}: Netpbm image of size {width} x {height}")
    plain = magic in (b"P1", b"P2", b"P3")
    maxval, scale = 255, 0.0
    if mode == "F":
        tok = h.token()
        try:
            scale = float(tok)
        except ValueError as e:
            raise ValueError(f"{name}: bad Netpbm scale {tok!r}") from e
        if scale == 0.0 or not math.isfinite(scale):
            raise ValueError(f"{name}: scale must be finite and non-zero")
    elif mode != "1":
        maxval = _int(h.token(), name)
        if not 0 < maxval < 65536:
            raise ValueError(f"{name}: maxval must be greater than 0 and less than 65536")
        if maxval > 255 and mode == "L":
            mode = "I"
    if width * height > bmp.MAX_PIXELS:
        raise ValueError(f"{name}: Netpbm image of size {width} x {height} (decompression bomb)")
    return mode, width, height, maxval, scale, h.pos, plain


def decode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """uint8 [H, W, 3]: `PIL.Image.open(...).convert("RGB")` of a Netpbm file."""
    data = bytes(data)
    mode, width, height, maxval, scale, pos, plain = _open(data, name)
    body = data[pos:]
    bands = BANDS[mode]
    count = width * height * bands
    if plain:
        px = _plain(body, mode, maxval, count, name).reshape(height, width, bands)
    elif mode == "1":  # 1;I: rows padded to bytes, a set bit black
        stride = -(-width // 8)
        if len(body) < stride * height:
            raise ValueError(f"{name}: image file is truncated")
        bits = np.unpackbits(np.frombuffer(body[: stride * height], np.uint8).reshape(height, stride), axis=1)
        px = np.where(bits[:, :width, None] == 1, 0, 255).astype(np.int64)
    elif mode == "F":
        dtype = "<f4" if scale < 0 else ">f4"
        if len(body) < 4 * width * height:
            raise ValueError(f"{name}: image file is truncated")
        px = np.frombuffer(body[: 4 * width * height], dtype).reshape(height, width, 1)[::-1]
        return tiff.to_rgb(px.astype(np.float32), "F")
    elif maxval == 255 or (maxval == 65535 and mode == "I"):  # the raw decoder
        wide = maxval == 65535
        need = count * (2 if wide else 1)
        if len(body) < need:
            raise ValueError(f"{name}: image file is truncated")
        px = np.frombuffer(body[:need], ">u2" if wide else np.uint8).astype(np.int64).reshape(height, width, bands)
    else:
        px = _scaled(body, mode, maxval, count, name).reshape(height, width, bands)
    if mode == "P":
        return np.zeros((height, width, 3), np.uint8)  # no palette: every index is black
    return tiff.to_rgb(px, mode)
