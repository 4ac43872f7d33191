"""FITS decoding with Pillow's pixels, without Pillow.

The JAX package reads every image with `PIL.Image.open(path).convert("RGB")`.
For a FITS file this module gives the same uint8 [H, W, 3] array as Pillow
12.1 (`FitsImagePlugin`), whose reading differs from the FITS standard's:

  * the header loop as written: cards of 80 bytes; a card's keyword is its
    first 8 bytes stripped, its value what follows up to the first "/",
    stripped, less a leading "="; the first card must be SIMPLE = T; after
    END the file is read on from the next multiple of 2880; a header of
    NAXIS 0 leaves the image to a later header (an XTENSION), whose cards
    join the same dictionary; once a header names the image, later headers
    are read past; the data starts where the first card after the last
    header would have been read from, so a data part shorter than a card
    starts that much earlier;
  * NAXIS 1 is a size of (1, NAXIS1); NAXIS 2 or more (or below 0) is
    (NAXIS1, NAXIS2), and only the first plane is read;
  * BITPIX 8 is mode L, 16 I;16 and 32 I, both read little-endian, and
    -32 and -64 are both F, read as 4-byte little-endian floats; rows are
    read bottom-up (the raw decoder's orientation -1), packed;
  * the tiled form (XTENSION = 'BINTABLE', ZIMAGE = T, ZCMPTYPE =
    'GZIP_1  '): ZNAXIS / ZBITPIX give the image; everything from the
    table's NAXIS1 * NAXIS2 * (BITPIX // 8) bytes past the data's start to
    the file's end goes through `gzip.decompress`, each 4 bytes of it keep
    their last min(ZBITPIX // 8, 4) bytes (none for a negative ZBITPIX),
    the rows are reversed and read top-down in the file's mode;
  * then Convert.c's conversion to RGB (`tiff.to_rgb`).

A file whose first card is not SIMPLE = T, a card missing where Pillow
reads it (KeyError), another BITPIX, or a size of 0, is not a FITS file to
Image.open (it tries its next reader); a file that ends inside its header
("Truncated FITS file"), a header that names no image ("No image data"),
a number Python's int() refuses, and pixel data cut short raise ValueError
naming the file.
"""

from __future__ import annotations

import gzip
import math
import zlib

import numpy as np

from uniir_tpu_torch.data import raster, tiff

SIGNATURE = b"SIMPLE"
CARD = 80
BLOCK = 2880
_MODES = {8: "L", 16: "I;16", 32: "I", -32: "F", -64: "F"}
_DTYPES = {"L": np.uint8, "I;16": "<u2", "I": "<i4", "F": "<f4"}


def accepts(data: bytes) -> bool:
    return data[:6] == SIGNATURE


def _number(headers: dict, key: bytes, name: str) -> int:
    try:
        value = headers[key]
    except KeyError:
        raise raster.NotThisFormat(f"{name}: FITS card {key.decode()} missing") from None
    try:
        return int(value)
    except ValueError:
        raise ValueError(f"{name}: FITS card {key.decode()} = {value!r} is not an integer") from None


def _size(headers: dict, prefix: bytes, name: str):
    naxis = _number(headers, prefix + b"NAXIS", name)
    if naxis == 0:
        return None
    if naxis == 1:
        return 1, _number(headers, prefix + b"NAXIS1", name)
    return _number(headers, prefix + b"NAXIS1", name), _number(headers, prefix + b"NAXIS2", name)


def _image(headers: dict, name: str):
    """FitsImageFile._parse_headers: (codec, offset, size, mode, bits), or None where no header names an image
    yet."""
    prefix, codec, offset = b"", "raw", 0
    if headers.get(b"XTENSION") == b"'BINTABLE'" and headers.get(b"ZIMAGE") == b"T":
        if b"ZCMPTYPE" not in headers:
            raise raster.NotThisFormat(f"{name}: FITS card ZCMPTYPE missing")
        if headers[b"ZCMPTYPE"] == b"'GZIP_1  '":
            table = _size(headers, b"", name) or (0, 0)
            offset = table[0] * table[1] * (_number(headers, b"BITPIX", name) // 8)
            prefix, codec = b"Z", "gzip"
    size = _size(headers, prefix, name)
    if not size:
        return None
    bits = _number(headers, prefix + b"BITPIX", name)
    return codec, offset, size, _MODES.get(bits, ""), bits


def parse(data: bytes, name: str = "<bytes>") -> dict:
    """FitsImageFile._open: mode, size, codec and where the data lies; raises raster.NotThisFormat where
    Image.open tries its next reader."""
    if not accepts(data):
        raise raster.NotThisFormat(f"{name}: not a FITS file")
    headers, in_progress, image, pos = {}, False, None, 0
    while True:
        card = data[pos : pos + CARD]
        pos += len(card)
        if not card:
            raise ValueError(f"{name}: truncated FITS file (its header runs to the file's end)")
        keyword = card[:8].strip()
        if keyword in (b"SIMPLE", b"XTENSION"):
            in_progress = True
        elif headers and not in_progress:
            break
        elif keyword == b"END":
            pos = math.ceil(pos / BLOCK) * BLOCK
            if image is None:
                image = _image(headers, name)
            in_progress = False
            continue
        if image is not None:
            continue
        value = card[8:].split(b"/")[0].strip()
        if value.startswith(b"="):
            value = value[1:].strip()
        if not headers and (not keyword.startswith(SIGNATURE) or value != b"T"):
            raise raster.NotThisFormat(f"{name}: not a FITS file (its first card is not SIMPLE = T)")
        headers[keyword] = value
    if image is None:
        raise ValueError(f"{name}: no image data in the FITS headers")
    codec, offset, size, mode, bits = image
    if not mode:
        raise raster.NotThisFormat(f"{name}: FITS BITPIX {bits}")
    raster.check_size(*size, name)
    return {"codec": codec, "offset": offset + pos - CARD, "size": size, "mode": mode, "bits": bits}


def _gzip_rows(data: bytes, p: dict, name: str) -> np.ndarray:
    """FitsGzipDecoder: uint8 [H, W * bytes] rows top-down, from the decompressed tiles."""
    (width, height), keep = p["size"], min(p["bits"] // 8, 4)
    if p["offset"] < 0:
        raise ValueError(f"{name}: FITS data offset {p['offset']} (a negative seek)")
    try:
        value = gzip.decompress(data[p["offset"] :])
    except (OSError, EOFError, zlib.error) as err:
        raise ValueError(f"{name}: FITS GZIP_1 data: {err}") from None
    pixels = width * height
    if keep <= 0 or len(value) < 4 * pixels:
        raise ValueError(f"{name}: FITS GZIP_1 data of {len(value)} bytes for {pixels} pixels (not enough image "
                         "data)")
    groups = np.frombuffer(value, np.uint8, 4 * pixels).reshape(height, width, 4)[:, :, 4 - keep :]
    return groups[::-1].reshape(height, width * keep)


def decode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """uint8 [H, W, 3]: `PIL.Image.open(path).convert("RGB")` of a FITS file."""
    data = bytes(data)
    p = parse(data, name)
    (width, height), mode = p["size"], p["mode"]
    dtype = np.dtype(_DTYPES[mode])
    if p["codec"] == "gzip":
        rows = _gzip_rows(data, p, name)
    else:
        rows = raster.raw_rows(data, p["offset"], height, width * dtype.itemsize, name)[::-1]
    px = np.ascontiguousarray(rows).view(dtype).reshape(height, width, 1)
    return tiff.to_rgb(px, mode)
