"""TGA decoding with Pillow's pixels, without Pillow.

The JAX package reads every image with `PIL.Image.open(path).convert("RGB")`.
For a Targa file this module gives the same uint8 [H, W, 3] array as Pillow
12.1 (`TgaImagePlugin`, its raw unpackers and `TgaRleDecode.c`):

  * no signature: the 18-byte header's fields name the file, as Pillow's
    `_open` tests them (a colour map type of 0 or 1, a size above 0, a
    depth of 1, 8, 16, 24 or 32, an image type of 1, 2, 3, 9, 10 or 11,
    a colour map depth of 16, 24 or 32 where there is a map); a file that
    fails them is not a TGA file to Image.open, which tries its next
    reader;
  * the image-ID field skipped; the colour map read as `colormap_first`
    zero entries and then `colormap_length` BGR (24), BGRA (32) or
    5-5-5 (16) entries, which the image uses where it is colour-mapped
    (type 1 / 9, 8-bit) and where it is grey (type 3 / 11 at 8 or 16
    bits: Pillow puts the map on the grey image), an index past the map
    black; more than 256 entries raise, as do 32-bit entries (Pillow has
    no BGRA palette unpacker) and a map on an RGB or 1-bit image;
  * pixels: 1-bit, 8-bit grey or index, 16-bit grey + alpha, 16-bit
    5-5-5 (each field v * 255 // 31), 24-bit BGR, 32-bit BGRA (alpha
    dropped by `convert("RGB")`); another depth for the image type raises;
  * rows bottom-up unless the descriptor's bit 5 says top-down, columns
    mirrored where bit 4 says right-to-left;
  * RLE (types 9 / 10 / 11) by `raster.tga_rle_twin` or its native twin:
    a run may not pass its row's end (an overrun), a literal goes on into
    the next rows, and a 1-bit RLE image never fills, as in Pillow.

Uncompressed pixels cut short, and anything else Pillow refuses, raise
ValueError naming the file.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np

from uniir_tpu_torch.data import raster

# (image type & 7, depth) -> raw mode (TgaImagePlugin.MODES)
MODES = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA", (2, 16): "BGRA;15Z", (2, 24): "BGR",
         (2, 32): "BGRA"}
RAW_BITS = {"P": 8, "1": 1, "L": 8, "LA": 16, "BGRA;15Z": 16, "BGR": 24, "BGRA": 32}


class Tga(NamedTuple):
    width: int
    height: int
    mode: str  # the image's mode: 1, L, LA, P, RGB, RGBA
    rawmode: Optional[str]  # None: no decoder for the type and depth
    rle: bool
    top_down: bool
    mirrored: bool
    depth: int
    offset: int
    palette: Optional[np.ndarray]  # [n, 3] entries, n <= 256 not checked here
    map_depth: int


def accepts(data: bytes) -> bool:
    """The header fields TgaImagePlugin._open tests before it reads the colour map."""
    return (len(data) >= 18 and data[1] in (0, 1) and data[12] | data[13] << 8 > 0 and data[14] | data[15] << 8 > 0
            and data[16] in (1, 8, 16, 24, 32) and data[2] in (1, 2, 3, 9, 10, 11))


def _palette(raw: bytes, depth: int) -> np.ndarray:
    k = depth // 8
    entries = np.frombuffer(raw[: len(raw) // k * k], np.uint8).reshape(-1, k)
    if depth == 16:
        p = entries[:, 0].astype(np.uint32) | entries[:, 1].astype(np.uint32) << 8
        return np.stack([(p >> s & 31) * 255 // 31 for s in (10, 5, 0)], axis=1).astype(np.uint8)
    return np.ascontiguousarray(entries[:, 2::-1])


def parse(data: bytes, name: str = "<bytes>") -> Tga:
    """TgaImageFile._open: raises raster.NotThisFormat where Image.open tries its next reader."""
    if not accepts(data):
        raise raster.NotThisFormat(f"{name}: not a TGA header")
    id_len, cmap_type, image_type, depth, flags = data[0], data[1], data[2], data[16], data[17]
    width, height = data[12] | data[13] << 8, data[14] | data[15] << 8
    if image_type in (3, 11):
        mode = {1: "1", 16: "LA"}.get(depth, "L")
    elif image_type in (1, 9):
        mode = "P" if cmap_type else "L"
    else:
        mode = "RGB" if depth == 24 else "RGBA"
    pos = 18 + id_len
    palette, map_depth = None, 0
    if cmap_type:
        start, size, map_depth = data[3] | data[4] << 8, data[5] | data[6] << 8, data[7]
        if map_depth not in (16, 24, 32):
            raise raster.NotThisFormat(f"{name}: unknown TGA map depth {map_depth}")
        k = map_depth // 8
        palette = _palette(bytes(k * start) + data[pos : pos + k * size], map_depth)
        pos += k * size
    raster.check_size(width, height, name)
    return Tga(width, height, mode, MODES.get((image_type & 7, depth)), bool(image_type & 8), bool(flags & 0x20),
               bool(flags & 0x10), depth, min(pos, len(data)), palette, map_depth)


def decode(data: bytes, name: str = "<bytes>", native: bool = False) -> np.ndarray:
    """uint8 [H, W, 3]: `PIL.Image.open(...).convert("RGB")` of a TGA file."""
    data = bytes(data)
    t = parse(data, name)
    if t.rawmode is None:
        raise ValueError(f"{name}: TGA image type {data[2]} of {t.depth}-bit pixels (cannot load this image)")
    if t.mode == "L" and t.rawmode == "P":
        raise ValueError(f"{name}: TGA colour-mapped pixels without a colour map (unknown raw mode)")
    if t.palette is not None:
        if t.mode in ("1", "RGB", "RGBA"):
            raise ValueError(f"{name}: TGA colour map on a {t.mode} image (unrecognized image mode)")
        if len(t.palette) > 256:
            raise ValueError(f"{name}: TGA colour map of {len(t.palette)} entries (invalid palette size)")
        if t.map_depth == 32:
            raise ValueError(f"{name}: TGA colour map of 32-bit entries (unrecognized raw mode)")
    row_bytes = (RAW_BITS[t.rawmode] * t.width + 7) // 8
    if t.rle:
        px = raster.expander("tga_rle", native)(data, t.offset, row_bytes, t.height, t.depth // 8, name)
    else:
        px = data[t.offset : t.offset + row_bytes * t.height]
        if len(px) < row_bytes * t.height:
            raise ValueError(f"{name}: TGA image data cut short (image file is truncated)")
    rows = np.frombuffer(px, np.uint8).reshape(t.height, row_bytes)
    if not t.top_down:
        rows = rows[::-1]
    rgb = _unpack(rows, t.rawmode, t.width, t.palette)
    return np.ascontiguousarray(rgb[:, ::-1] if t.mirrored else rgb)


def _unpack(rows: np.ndarray, rawmode: str, width: int, palette: Optional[np.ndarray]) -> np.ndarray:
    if rawmode == "1":
        v = np.unpackbits(rows, axis=1)[:, :width] * np.uint8(255)
    elif rawmode in ("P", "L"):
        v = rows[:, :width]
    elif rawmode == "LA":
        v = rows[:, : 2 * width : 2]
    elif rawmode == "BGRA;15Z":
        p = rows[:, : 2 * width : 2].astype(np.uint32) | rows[:, 1 : 2 * width : 2].astype(np.uint32) << 8
        return np.stack([(p >> s & 31) * 255 // 31 for s in (10, 5, 0)], axis=2).astype(np.uint8)
    else:
        k = 3 if rawmode == "BGR" else 4
        return np.ascontiguousarray(rows[:, : k * width].reshape(rows.shape[0], width, k)[:, :, 2::-1])
    if palette is not None:
        table = np.zeros((256, 3), np.uint8)
        table[: len(palette)] = palette
        return table[v]
    return np.repeat(v[:, :, None], 3, axis=2)


def decode_twin(data: bytes, name: str = "<bytes>") -> np.ndarray:
    return decode(data, name)


def decode_native(data: bytes, name: str = "<bytes>") -> np.ndarray:
    return decode(data, name, native=True)


def decoder_for(device) -> Callable[[bytes, str], np.ndarray]:
    """The decoder a run on `device` uses: the native one on a CUDA run's host, the twin on a CPU run."""
    from uniir_tpu_torch import _build

    return decode_native if _build.is_cuda(device) else decode_twin
