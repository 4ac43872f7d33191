"""McIdas area file decoding with Pillow's pixels, without Pillow.

The JAX package reads every image with `PIL.Image.open(path).convert("RGB")`.
For a McIdas area file this module gives the same uint8 [H, W, 3] array as
Pillow 12.1 (`McIdasImagePlugin`): a 256-byte directory of 64 big-endian
words (word 11: bytes a pixel, 1 / 2 / 4; words 9 / 10: height / width;
words 34 + 15: the data's offset, word 15 also a row's prefix; word 14 the
bands in a row's stride), rows read as L, I;16B or I;32B, converted to RGB
as Convert.c does (I;16B through L, 255 where the high byte is set; I
clipped to 0..255).

Image.open maps a path's L and I;16B pixels (ImageFile.load's mmap) where
the offset plus height rows of the stride fit the file: the rows are then
`stride` bytes apart even where that is below a row's bytes (they overlap);
elsewhere Pillow's raw decoder reads them and fails on such a stride.  The
JAX package opens paths, so the mapped reading is the one modelled.

A directory cut short, another pixel size or a size of 0 is not a McIdas
file to Image.open (it tries its next reader); pixel data cut short raises
ValueError naming the file.
"""

from __future__ import annotations

import numpy as np

from uniir_tpu_torch.data import raster, tiff

SIGNATURE = b"\x00\x00\x00\x00\x00\x00\x00\x04"
_MODES = {1: "L", 2: "I;16B", 4: "I"}


def accepts(data: bytes) -> bool:
    return data[:8] == SIGNATURE


def parse(data: bytes, name: str = "<bytes>") -> dict:
    """McIdasImageFile._open: mode, size, offset and stride; raises raster.NotThisFormat where Image.open
    tries its next reader."""
    if not accepts(data) or len(data) < 256:
        raise raster.NotThisFormat(f"{name}: McIdas directory cut short")
    w = [0, *np.frombuffer(data[:256], ">i4").tolist()]
    if w[11] not in _MODES:
        raise raster.NotThisFormat(f"{name}: McIdas pixels of {w[11]} bytes")
    raster.check_size(w[10], w[9], name)
    return {"mode": _MODES[w[11]], "size": (w[10], w[9]), "offset": w[34] + w[15],
            "stride": w[15] + w[10] * w[11] * w[14], "bytes": w[11]}


def decode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """uint8 [H, W, 3]: `PIL.Image.open(path).convert("RGB")` of a McIdas area file."""
    data = bytes(data)
    p = parse(data, name)
    (width, height), offset, stride, mode = p["size"], p["offset"], p["stride"], p["mode"]
    row_bytes = width * p["bytes"]
    if offset < 0:
        raise ValueError(f"{name}: McIdas data offset {offset} (Pillow: tile offset cannot be negative)")
    if mode != "I" and offset + height * stride <= len(data):  # mapped: ImageFile.load's mmap, map_buffer
        step = stride if stride > 0 else row_bytes
        if offset + height * step > len(data):
            raise ValueError(f"{name}: McIdas pixel data cut short (buffer is not large enough)")
        if offset + (height - 1) * step + row_bytes > len(data):
            from uniir_tpu_torch.data.jpeg import UnsupportedImageFormat

            raise UnsupportedImageFormat(f"{name}: McIdas rows of {row_bytes} bytes {step} apart run past the "
                                         "file, where Pillow's mapped image reads memory after it")
        rows = np.lib.stride_tricks.as_strided(np.frombuffer(data, np.uint8, offset=offset), (height, row_bytes),
                                               (step, 1))
    else:
        rows = raster.raw_rows(data, offset, height, row_bytes, name, stride)
    px = np.ascontiguousarray(rows).view({"L": np.uint8, "I;16B": ">u2", "I": ">i4"}[mode]).reshape(height, width, 1)
    return tiff.to_rgb(px, mode)
