"""SPIDER image decoding with Pillow's pixels, without Pillow.

The JAX package reads every image with `PIL.Image.open(path).convert("RGB")`.
For a SPIDER file this module gives the same uint8 [H, W, 3] array as Pillow
12.1 (`SpiderImagePlugin`): a header of 27 floats, big-endian or else
little-endian, whose counts are whole numbers that agree (labrec times
lenbyt is the header's bytes), of a 2D image (iform 1); a single image after
the header, or a stack's first after two headers; float32 pixels in the
header's byte order (mode F), converted to RGB through L as Image.convert
retries it (Convert.c: truncated toward zero, clipped, NaN 0).

A header that is not SPIDER's, of another iform, of inconsistent stack
values or of a size of 0 is not a SPIDER file to Image.open (it tries its
next reader); a stack value that is not a number, a stack's image read
alone or pixel data cut short raise ValueError naming the file.
"""

from __future__ import annotations

import math
import struct

import numpy as np

from uniir_tpu_torch.data import raster, tiff

IFORMS = (1, 3, -11, -12, -21, -22)


def _whole(f: float) -> bool:
    """SpiderImagePlugin.isInt."""
    return math.isfinite(f) and f == int(f)


def header_bytes(t: tuple) -> int:
    """isSpiderHeader: the header's bytes, 0 where the values are not a SPIDER header's."""
    h = (99,) + t
    if not all(_whole(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)) or int(h[5]) not in IFORMS:
        return 0
    return int(h[22]) if int(h[22]) == int(h[13]) * int(h[23]) else 0


def _int(f: float, i: int, name: str) -> int:
    """int() of header value i, which raises in Pillow's _open (and so in Image.open) for NaN or infinity."""
    if not math.isfinite(f):
        raise ValueError(f"{name}: SPIDER header value {i} is {f}")
    return int(f)


def accepts(data: bytes) -> bool:
    return len(data) >= 108


def parse(data: bytes, name: str = "<bytes>") -> dict:
    """SpiderImageFile._open: size, offset and byte order; raises raster.NotThisFormat where Image.open
    tries its next reader."""
    if len(data) < 108:
        raise raster.NotThisFormat(f"{name}: SPIDER header cut short")
    for order in ">", "<":
        t = struct.unpack(order + "27f", data[:108])
        hdrlen = header_bytes(t)
        if hdrlen:
            break
    else:
        raise raster.NotThisFormat(f"{name}: not a SPIDER header")
    h = (99,) + t
    if int(h[5]) != 1:
        raise raster.NotThisFormat(f"{name}: not a SPIDER 2D image (iform {int(h[5])})")
    size = int(h[12]), int(h[2])
    stack, number = _int(h[24], 24, name), _int(h[27], 27, name)
    if stack == 0 and number == 0:
        offset = hdrlen
    elif stack > 0 and number == 0:
        _int(h[26], 26, name)  # the stack's image count
        offset = 2 * hdrlen  # the stack's first image
    elif stack == 0 and number > 0:
        raise ValueError(f"{name}: a SPIDER stack's image read alone (Pillow's _open has no stack offset)")
    else:
        raise raster.NotThisFormat(f"{name}: inconsistent SPIDER stack header values")
    raster.check_size(*size, name)
    return {"size": size, "offset": offset, "order": order}


def decode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """uint8 [H, W, 3]: `PIL.Image.open(...).convert("RGB")` of a SPIDER file."""
    data = bytes(data)
    p = parse(data, name)
    (width, height), offset = p["size"], p["offset"]
    rows = raster.raw_rows(data, offset, height, 4 * width, name)
    return tiff.to_rgb(rows.view(p["order"] + "f4").reshape(height, width, 1), "F")
