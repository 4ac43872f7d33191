"""Sun raster decoding with Pillow's pixels, without Pillow.

The JAX package reads every image with `PIL.Image.open(path).convert("RGB")`.
For a Sun raster file this module gives the same uint8 [H, W, 3] array as
Pillow 12.1 (`SunImagePlugin`, its raw unpackers and `SunRleDecode.c`):

  * the 32-byte big-endian header: depths 1 (a set bit black), 4 and 8
    (grey, 4-bit samples times 17), 24 and 32 (BGR / BGRX, RGB / RGBX for
    type 3); another depth is not a Sun raster file to Image.open;
  * a colour map of type 1, up to 1024 bytes, read as planar R, G, B
    thirds: it makes a 4- or 8-bit image colour-mapped (an index past it
    black); more than 256 entries raise, as does a map on a 1, 24 or
    32-bit image (Pillow cannot put one there);
  * types 0, 1, 3, 4 and 5: rows padded to 16 bits; type 2: RLE by
    `raster.sun_rle_twin` or its native twin (the 0x80 escape, runs into
    the next rows, rows of the unpadded width, as Pillow reads them);
    another type is not a Sun raster file to Image.open.

A header cut short, or a size of 0, is not a Sun raster file to Image.open;
pixels cut short raise ValueError naming the file.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np

from uniir_tpu_torch.data import raster

SIGNATURE = b"\x59\xa6\x6a\x95"


class Sun(NamedTuple):
    width: int
    height: int
    depth: int
    rawmode: str
    rle: bool
    offset: int
    palette: Optional[np.ndarray]  # [n, 3]


def accepts(data: bytes) -> bool:
    return data[:4] == SIGNATURE


def parse(data: bytes, name: str = "<bytes>") -> Sun:
    """SunImageFile._open: raises raster.NotThisFormat where Image.open tries its next reader."""
    if not accepts(data) or len(data) < 32:
        raise raster.NotThisFormat(f"{name}: Sun raster header cut short")
    width, height, depth, _, kind, map_type, map_length = (int.from_bytes(data[k : k + 4], "big")
                                                           for k in range(4, 32, 4))
    rawmode = {1: "1;I", 4: "L;4", 8: "L", 24: "RGB" if kind == 3 else "BGR",
               32: "RGBX" if kind == 3 else "BGRX"}.get(depth)
    if rawmode is None:
        raise raster.NotThisFormat(f"{name}: Sun raster depth {depth}")
    palette = None
    if map_length:
        if map_length > 1024 or map_type != 1:
            raise raster.NotThisFormat(f"{name}: Sun raster colour map of type {map_type}, {map_length} bytes")
        raw = data[32 : 32 + map_length]
        n = len(raw) // 3
        palette = np.frombuffer(raw[: 3 * n], np.uint8).reshape(3, n).T
        rawmode = rawmode.replace("L", "P")
    if kind not in (0, 1, 2, 3, 4, 5):
        raise raster.NotThisFormat(f"{name}: Sun raster type {kind}")
    raster.check_size(width, height, name)
    return Sun(width, height, depth, rawmode, kind == 2, 32 + map_length, palette)


def decode(data: bytes, name: str = "<bytes>", native: bool = False) -> np.ndarray:
    """uint8 [H, W, 3]: `PIL.Image.open(...).convert("RGB")` of a Sun raster file."""
    data = bytes(data)
    s = parse(data, name)
    w, h = s.width, s.height
    if s.palette is not None:
        if s.depth not in (4, 8):
            raise ValueError(f"{name}: Sun raster colour map on a {s.depth}-bit image (unrecognized image mode)")
        if len(s.palette) > 256:
            raise ValueError(f"{name}: Sun raster colour map of {len(s.palette)} entries (invalid palette size)")
    row_bytes = (w * s.depth + 7) // 8
    if s.rle:
        px = raster.expander("sun_rle", native)(data, s.offset, row_bytes, h, name)
        rows = np.frombuffer(px, np.uint8).reshape(h, row_bytes)
    else:
        stride = (w * s.depth + 15) // 16 * 2
        if len(data) < s.offset + stride * (h - 1) + row_bytes:
            raise ValueError(f"{name}: Sun raster image data cut short (image file is truncated)")
        block = data[s.offset : s.offset + stride * h].ljust(stride * h, b"\0")
        rows = np.frombuffer(block, np.uint8).reshape(h, stride)[:, :row_bytes]
    if s.depth == 1:
        v = (1 - np.unpackbits(rows, axis=1)[:, :w]) * np.uint8(255)
    elif s.depth == 4:
        v = np.stack([rows >> 4, rows & 15], axis=2).reshape(h, -1)[:, :w]
        v = v if s.palette is not None else v * np.uint8(17)
    elif s.depth == 8:
        v = rows[:, :w]
    else:
        k = s.depth // 8
        px = rows[:, : k * w].reshape(h, w, k)
        return np.ascontiguousarray(px[:, :, :3] if s.rawmode.startswith("RGB") else px[:, :, 2::-1])
    if s.palette is not None:
        table = np.zeros((256, 3), np.uint8)
        table[: len(s.palette)] = s.palette
        return table[v]
    return np.repeat(np.ascontiguousarray(v)[:, :, None], 3, axis=2)


def decode_twin(data: bytes, name: str = "<bytes>") -> np.ndarray:
    return decode(data, name)


def decode_native(data: bytes, name: str = "<bytes>") -> np.ndarray:
    return decode(data, name, native=True)


def decoder_for(device) -> Callable[[bytes, str], np.ndarray]:
    """The decoder a run on `device` uses: the native one on a CUDA run's host, the twin on a CPU run."""
    from uniir_tpu_torch import _build

    return decode_native if _build.is_cuda(device) else decode_twin
