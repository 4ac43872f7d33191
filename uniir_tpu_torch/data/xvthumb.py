"""XV thumbnail decoding with Pillow's pixels, without Pillow.

The JAX package reads every image with `PIL.Image.open(path).convert("RGB")`.
For an XV thumbnail this module gives the same uint8 [H, W, 3] array as
Pillow 12.1 (`XVThumbImagePlugin`): "P7 332", the rest of that line, any
lines that start with "#", then a line whose first two words are the width
and height (Python's int() of each); one byte a pixel after that line, an
index into the 3-3-2 palette (r * 255 // 7, g * 255 // 7, b * 255 // 3).

No line after the comments, or a size of 0, is not an XV thumbnail to
Image.open (it tries its next reader); a size line without two numbers or
pixel data cut short raises ValueError naming the file.
"""

from __future__ import annotations

import io

import numpy as np

from uniir_tpu_torch.data import raster

SIGNATURE = b"P7 332"
PALETTE = np.array([[r * 255 // 7, g * 255 // 7, b * 255 // 3] for r in range(8) for g in range(8) for b in range(4)],
                   np.uint8)


def accepts(data: bytes) -> bool:
    return data[:6] == SIGNATURE


def parse(data: bytes, name: str = "<bytes>") -> tuple:
    """XVThumbImageFile._open: (width, height, where the pixels start); raises raster.NotThisFormat where
    Image.open tries its next reader."""
    if not accepts(data):
        raise raster.NotThisFormat(f"{name}: not an XV thumbnail")
    fp = io.BytesIO(data)
    fp.read(6)
    fp.readline()
    while True:
        s = fp.readline()
        if not s:
            raise raster.NotThisFormat(f"{name}: XV thumbnail header ends before its size")
        if s[0] != 35:
            break
    words = s.strip().split(maxsplit=2)[:2]
    try:
        width, height = (int(v) for v in words)
    except ValueError as err:  # Image.open raises it
        raise ValueError(f"{name}: bad XV thumbnail size line {s[:40]!r} ({err})") from None
    raster.check_size(width, height, name)
    return width, height, fp.tell()


def decode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """uint8 [H, W, 3]: `PIL.Image.open(...).convert("RGB")` of an XV thumbnail."""
    data = bytes(data)
    width, height, offset = parse(data, name)
    return PALETTE[raster.raw_rows(data, offset, height, width, name)]
