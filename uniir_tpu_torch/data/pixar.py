"""PIXAR raster decoding with Pillow's pixels, without Pillow.

The JAX package reads every image with `PIL.Image.open(path).convert("RGB")`.
For a PIXAR file this module gives the same uint8 [H, W, 3] array as Pillow
12.1 (`PixarImagePlugin`): a 512-byte header whose little-endian words at
418 / 416 give the width and height and at 424 / 426 the channels and
depth, of which Pillow reads (14, 2) alone, as RGB; the pixels "dumped",
packed RGB at offset 1024.

A header cut short, another channel / depth pair or a size of 0 is not a
PIXAR file to Image.open (it tries its next reader); pixel data cut short
raises ValueError naming the file.
"""

from __future__ import annotations

import numpy as np

from uniir_tpu_torch.data import raster

SIGNATURE = b"\x80\xe8\x00\x00"


def accepts(data: bytes) -> bool:
    return data[:4] == SIGNATURE


def parse(data: bytes, name: str = "<bytes>") -> tuple:
    """PixarImageFile._open: (width, height); raises raster.NotThisFormat where Image.open tries its next
    reader."""
    if not accepts(data) or len(data) < 428:
        raise raster.NotThisFormat(f"{name}: PIXAR header cut short")
    width, height, channels, depth = (int.from_bytes(data[k: k + 2], "little") for k in (418, 416, 424, 426))
    if (channels, depth) != (14, 2):
        raise raster.NotThisFormat(f"{name}: PIXAR channels / depth {channels} / {depth} (no mode)")
    raster.check_size(width, height, name)
    return width, height


def decode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """uint8 [H, W, 3]: `PIL.Image.open(...).convert("RGB")` of a PIXAR file."""
    data = bytes(data)
    width, height = parse(data, name)
    return raster.raw_rows(data, 1024, height, 3 * width, name).reshape(height, width, 3)
