"""GIMP brush decoding with Pillow's pixels, without Pillow.

The JAX package reads every image with `PIL.Image.open(path).convert("RGB")`.
For a GIMP brush (GBR) this module gives the same uint8 [H, W, 3] array as
Pillow 12.1 (`GbrImagePlugin`): a big-endian header of its size, version
(1, or 2 with the magic "GIMP" and a spacing), width, height and bytes a
pixel (1: L, 4: RGBA, alpha dropped), a comment to the header's end, then
the pixels (`frombytes` of width * height * depth bytes).  A version-2
header shorter than 28 bytes reads its comment to the file's end (Python's
read of a negative count), which leaves no pixels.

A header its _open refuses is not a GBR file to Image.open (it tries its next
reader); pixel data cut short raises ValueError naming the file.
"""

from __future__ import annotations

import numpy as np

from uniir_tpu_torch.data import raster


def _u32(data: bytes, at: int) -> int:
    return int.from_bytes(data[at: at + 4], "big")


def accepts(data: bytes) -> bool:
    """GbrImagePlugin._accept."""
    return len(data) >= 8 and _u32(data, 0) >= 20 and _u32(data, 4) in (1, 2)


def parse(data: bytes, name: str = "<bytes>") -> dict:
    """GbrImageFile._open: size, bytes a pixel and where the pixels start; raises raster.NotThisFormat
    where Image.open tries its next reader."""
    if not accepts(data) or len(data) < 20:
        raise raster.NotThisFormat(f"{name}: not a GIMP brush header")
    header, version, width, height, depth = (_u32(data, k) for k in range(0, 20, 4))
    if width == 0 or height == 0 or depth not in (1, 4):
        raise raster.NotThisFormat(f"{name}: GIMP brush of size {width} x {height}, depth {depth}")
    if version == 2 and (data[20:24] != b"GIMP" or len(data) < 28):
        raise raster.NotThisFormat(f"{name}: GIMP brush without its magic number")
    raster.check_size(width, height, name)
    start = header if version == 1 or header >= 28 else len(data)
    return {"size": (width, height), "depth": depth, "offset": min(start, len(data))}


def decode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """uint8 [H, W, 3]: `PIL.Image.open(...).convert("RGB")` of a GIMP brush."""
    data = bytes(data)
    p = parse(data, name)
    (width, height), depth = p["size"], p["depth"]
    need = width * height * depth
    if len(data) - p["offset"] < need:
        raise ValueError(f"{name}: GIMP brush pixel data cut short (not enough image data)")
    px = np.frombuffer(data, np.uint8, count=need, offset=p["offset"]).reshape(height, width, depth)
    return np.repeat(px, 3, axis=2) if depth == 1 else np.ascontiguousarray(px[..., :3])


def comment(data: bytes, name: str = "<bytes>") -> bytes:
    """info["comment"]: the comment's bytes but its last (version 2 under 28 header bytes: the rest of the
    file's), which Pillow's JPEG writer carries over."""
    data = bytes(data)
    parse(data, name)
    header, version = _u32(data, 0), _u32(data, 4)
    start = 20 if version == 1 else 28
    end = header if version == 1 or header >= 28 else len(data)
    return data[start:max(start, end)][:-1]
