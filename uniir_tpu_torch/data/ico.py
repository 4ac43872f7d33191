"""ICO and CUR decoding with Pillow's pixels, without Pillow.

The JAX package reads every image with `PIL.Image.open(path).convert("RGB")`.
For a Windows icon or cursor this module gives the same uint8 [H, W, 3]
array as Pillow 12.1 (`IcoImagePlugin`, `CurImagePlugin`):

  * ICO: the directory's entries sorted by colour depth (the entry's bpp, or
    ceil(log2) of its colour count, or 256), then by area, largest first
    (both sorts stable), and the first taken.  Its data is a PNG file
    (decoded by `png.decoder_for(device)`, at the PNG's own size) or a DIB:
    a BMP without its file header, twice the image's height (the colour
    rows, then a 1-bit AND mask), decoded by `bmp.decode` with the height
    halved.  The mask (or, where the entry says 32 bits, the fourth byte of
    each pixel) becomes alpha, which `convert("RGB")` drops, but Pillow
    reads it all the same: too few bytes for it raises, as in Pillow;
  * CUR: the first entry, replaced by each later one larger in both raw
    width and height bytes; always a DIB with the height halved, no mask.

Anything Pillow refuses raises ValueError naming the file.  numpy only: the
pixels are BMP's or PNG's decoders' work.
"""

from __future__ import annotations

from math import ceil, log

import numpy as np

from uniir_tpu_torch.data import bmp, png

ICO_SIGNATURE, CUR_SIGNATURE = b"\x00\x00\x01\x00", b"\x00\x00\x02\x00"


def _u16(b: bytes, at: int) -> int:
    return b[at] | b[at + 1] << 8


def _u32(b: bytes, at: int) -> int:
    return int.from_bytes(b[at : at + 4], "little")


def _entries(data: bytes, name: str) -> list:
    """The directory: (width, height, colours, bpp, size, offset) per entry, as read."""
    count = _u16(data, 4)
    out = []
    for k in range(count):
        e = data[6 + 16 * k : 22 + 16 * k]
        if len(e) < 16:
            raise ValueError(f"{name}: truncated icon directory")
        out.append((e[0], e[1], e[2], _u16(e, 6), _u32(e, 8), _u32(e, 12)))
    if not out:
        raise ValueError(f"{name}: icon file without an image")
    return out


def _dib(data: bytes, at: int, name: str) -> tuple:
    """RGB [h / 2, w, 3] of the DIB at `at` (a BMP file built around it for `bmp.decode`) and its geometry."""
    header_size, width, height, bits, top_down, pixels = bmp.dib_geometry(data, at, name)
    if width * height > bmp.MAX_PIXELS:
        raise ValueError(f"{name}: DIB of size {width} x {height} (decompression bomb)")
    half = height // 2
    dib = bytearray(data[at:])
    field = (2**32 - half) if top_down else half
    dib[(6 if header_size == 12 else 8) : (8 if header_size == 12 else 12)] = \
        field.to_bytes(2 if header_size == 12 else 4, "little")
    offset = 14 + pixels - at
    head = bmp.SIGNATURE + (14 + len(dib)).to_bytes(4, "little") + bytes(4) + offset.to_bytes(4, "little")
    return bmp.decode(head + bytes(dib), name), (width, half, pixels)


def ico_opens(data: bytes) -> bool:
    """Whether Image.open keeps its ICO reader for an icon of one or more entries: not where an entry of the
    directory is cut short (Pillow's IcoFile indexes past it, and Image.open tries its next reader)."""
    return len(data) >= 6 + 16 * _u16(data, 4)


def cur_opens(data: bytes) -> bool:
    """Whether Image.open keeps its CUR reader for a cursor of one or more entries: CurImageFile._open picks
    an entry by indexing each one as read, cut short or not, then reads a DIB header at its offset; where that
    indexing, the offset or the DIB's header falls short (or its halved height is 0) Image.open tries its
    next reader."""
    best = b""
    for k in range(_u16(data, 4)):
        e = data[6 + 16 * k : 22 + 16 * k]
        if not best:
            best = e
        elif len(e) < 1 or e[0] > best[0] and (len(e) < 2 or len(best) < 2):
            return False
        elif e[0] > best[0] and e[1] > best[1]:
            best = e
    return len(best) >= 16 and bmp.dib_opens(data, _u32(best, 12), halved=True)


def _largest(entries: list) -> tuple:
    """IcoFile's entry[0]: the entries sorted by colour depth, then by area, largest first."""
    def depth(e):
        return e[3] or (e[2] != 0 and ceil(log(e[2], 2))) or 256

    by_depth = sorted(entries, key=depth)
    return sorted(by_depth, key=lambda e: (e[0] or 256) * (e[1] or 256), reverse=True)[0]


def decode_ico(data: bytes, name: str, device) -> np.ndarray:
    """uint8 [H, W, 3]: `PIL.Image.open(...).convert("RGB")` of an ICO file."""
    _, _, _, bpp, size, offset = _largest(_entries(data, name))
    if data[offset : offset + 8] == png.SIGNATURE:
        return png.decoder_for(device)(data[offset:], name)
    rgb, (width, height, pixels) = _dib(data, offset, name)
    if bpp == 32:  # alpha: the fourth byte of each pixel from the data's start
        if len(data[pixels : pixels + width * height * 4][3::4]) < width * height:
            raise ValueError(f"{name}: not enough image data for the icon's alpha")
    else:  # the AND mask: rows of whole 32-bit words at the entry's end, read up to the last row's last byte
        stride = -(-width // 32) * 4
        mask_at = offset + size - stride * height
        if mask_at < 0 or len(data) - mask_at < stride * (height - 1) + -(-width // 8):
            raise ValueError(f"{name}: not enough image data for the icon's mask")
    return rgb


def decode_cur(data: bytes, name: str) -> np.ndarray:
    """uint8 [H, W, 3]: `PIL.Image.open(...).convert("RGB")` of a CUR file."""
    count = _u16(data, 4)
    best = b""
    for k in range(count):
        e = data[6 + 16 * k : 22 + 16 * k]
        if len(e) < 16:
            raise ValueError(f"{name}: truncated cursor directory")
        if not best or (e[0] > best[0] and e[1] > best[1]):
            best = e
    if not best:
        raise ValueError(f"{name}: no cursors were found")
    return _dib(data, _u32(best, 12), name)[0]
