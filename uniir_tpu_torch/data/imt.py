"""IM Tools (IMT) decoding with Pillow's pixels, without Pillow.

The JAX package reads every image with `PIL.Image.open(path).convert("RGB")`.
For an IMT file this module gives the same uint8 [H, W, 3] array as Pillow
12.1 (`ImtImagePlugin`): a newline among the first 100 bytes, then the
header read as its _open reads it, byte by byte and line by line ("key
value" lines; "*" a comment; "width" and "height" through Python's int();
"pixel n8" the mode L) up to a form feed, after which the L pixels start,
one byte each; a line it cannot read ends the header without pixels.

No newline in the first 100 bytes, no "pixel n8" before the pixels, or a
size of 0 is not an IMT file to Image.open (it tries its next reader); a
width or height that is not a number, a header that ends without a form
feed, or pixel data cut short raises ValueError naming the file.
"""

from __future__ import annotations

import io
import re

import numpy as np

from uniir_tpu_torch.data import raster

_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def accepts(data: bytes) -> bool:
    return b"\n" in data[:100]


def parse(data: bytes, name: str = "<bytes>") -> tuple:
    """ImtImageFile._open: (width, height, where the pixels start, or None where no form feed starts them);
    raises raster.NotThisFormat where Image.open tries its next reader."""
    if not accepts(data):
        raise raster.NotThisFormat(f"{name}: no newline in an IMT header's first 100 bytes")
    fp = io.BytesIO(data)
    buffer = fp.read(100)
    xsize = ysize = 0
    size, mode, offset = (0, 0), None, None
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s = fp.read(1)
        if not s:
            break
        if s == b"\x0c":
            offset = fp.tell() - len(buffer)
            break
        if b"\n" not in buffer:
            buffer += fp.read(100)
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord(b"*"):
            continue
        m = _FIELD.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        try:
            if k == b"width":
                xsize = int(v)
                size = xsize, ysize
            elif k == b"height":
                ysize = int(v)
                size = xsize, ysize
        except ValueError as err:  # Image.open raises it
            raise ValueError(f"{name}: bad IMT {k.decode()} {v[:20]!r} ({err})") from None
        if k == b"pixel" and v == b"n8":
            mode = "L"
    if mode is None:
        raise raster.NotThisFormat(f"{name}: IMT header without its pixel mode")
    raster.check_size(*size, name)
    return size[0], size[1], offset


def decode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """uint8 [H, W, 3]: `PIL.Image.open(...).convert("RGB")` of an IMT file."""
    data = bytes(data)
    width, height, offset = parse(data, name)
    if offset is None:
        raise ValueError(f"{name}: IMT header ends without a form feed (cannot load this image)")
    px = raster.raw_rows(data, offset, height, width, name)
    return np.repeat(px[:, :, None], 3, axis=2)
