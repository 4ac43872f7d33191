"""BMP decoding with Pillow's pixels, without Pillow.

The JAX package reads every image with `PIL.Image.open(path).convert("RGB")`.
For a BMP file this module gives the same uint8 [H, W, 3] array, bit for
bit, as Pillow 12.1 gives it (`BmpImagePlugin`, its raw unpackers and its
RLE decoder), including where Pillow departs from the format's letter:

  * headers: the 12-byte core header (16-bit sizes, BGR palette entries)
    and the 40, 52, 56, 64, 108 and 124-byte ones (BGRX entries); rows
    bottom-up, or top-down when the height's top byte is 0xFF; rows padded
    to 4 bytes; the data at the file header's offset, moved past the
    palette when the offset points at the palette;
  * 1 / 4 / 8-bit palettes of `biClrUsed` entries (the bit depth's count
    when 0); an index past the palette is black.  A palette that is all
    grey ramp (entry i = (i, i, i); for 2 entries black and white) makes
    Pillow read the rows as `L` (8-bit samples) or `1` (bits) whatever the
    bit depth, as it does;
  * 16-bit 5-5-5 by default and `BI_BITFIELDS` 5-6-5 / 5-5-5, each field
    widened as Pillow's unpackers do: v * 255 // 31 and v * 255 // 63;
    24-bit BGR; 32-bit BGRX, and the eight 32-bit `BI_BITFIELDS` layouts
    Pillow names, alpha dropped by `convert("RGB")`; any other bit-field
    layout raises, as in Pillow;
  * RLE8 and RLE4 through Pillow's decoder: encoded runs clipped at the
    row's end (nothing more until an end of line), an end of line padding
    the row with index 0, an end of bitmap, a delta that reads four bytes
    (two it drops, then right and up) and fills what it skips with index 0,
    absolute runs of RLE4 reading count // 2 bytes, and word alignment by
    the position in the file; too little data for the image raises.

Anything Pillow refuses raises ValueError naming the file.  The decoder is
numpy but for the RLE escapes, a loop over runs rather than pixels, so no
native twin is needed.
"""

from __future__ import annotations

import numpy as np

SIGNATURE = b"BM"
RGB, RLE8, RLE4, BITFIELDS = 0, 1, 2, 3
# bits -> (mode, raw mode) without bit fields (BmpImagePlugin.BIT2MODE)
BIT2MODE = {1: ("P", "P;1"), 4: ("P", "P;4"), 8: ("P", "P"), 16: ("RGB", "BGR;15"), 24: ("RGB", "BGR"),
            32: ("RGB", "BGRX")}
# (bits, masks) -> raw mode of the BI_BITFIELDS layouts Pillow reads
MASK_MODES = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}
MAX_PIXELS = 2 * (1024 * 1024 * 1024 // 4 // 3)  # Image.open's decompression bomb limit
RAW_BITS = {"P;1": 1, "P;4": 4, "P": 8, "1": 1, "L": 8, "BGR;15": 16, "BGR;16": 16, "BGR": 24}


def _u16(b: bytes, at: int) -> int:
    return b[at] | b[at + 1] << 8


def _u32(b: bytes, at: int) -> int:
    return int.from_bytes(b[at : at + 4], "little")


def _samples(rows: np.ndarray, raw: str, width: int) -> np.ndarray:
    """[h, width, k] of rows of raw bytes: indices or grey [h, width, 1],
    RGB [h, width, 3] (the unpackers of Pillow's Unpack.c)."""
    if raw in ("P;1", "1", "P;4"):
        depth = 4 if raw == "P;4" else 1
        per = 8 // depth
        shifts = (8 - depth * (np.arange(per) + 1)).astype(np.uint8)
        vals = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(rows.shape[0], -1)[:, :width]
        return (vals * 255 if raw == "1" else vals).astype(np.uint8)[:, :, None]
    if raw in ("P", "L"):
        return rows[:, :width, None]
    if raw in ("BGR;15", "BGR;16"):
        p = rows[:, : 2 * width].astype(np.uint32).reshape(rows.shape[0], width, 2)
        p = p[..., 0] | p[..., 1] << 8
        if raw == "BGR;15":
            r, g = (p >> 10) & 31, ((p >> 5) & 31) * 255 // 31
        else:
            r, g = p >> 11 & 31, ((p >> 5) & 63) * 255 // 63
        return np.stack([r * 255 // 31, g, (p & 31) * 255 // 31], axis=2).astype(np.uint8)
    order = raw if len(raw) == 4 else raw + "X"  # BGR, BGRX, XBGR, ... RGBA: one byte a letter
    px = rows[:, : len(raw) * width].reshape(rows.shape[0], width, len(raw))
    return np.stack([px[:, :, order.index(c)] for c in "RGB"], axis=2)


def _rle(data: bytes, start: int, width: int, height: int, four: bool, name: str) -> bytes:
    """BmpRleDecoder.decode: the indices, first row first, as Pillow builds them."""
    out = bytearray()
    pos, x, need = start, 0, width * height

    def read(k: int) -> bytes:
        nonlocal pos
        chunk = data[pos : pos + k]
        pos += len(chunk)
        return chunk

    while len(out) < need:
        pair = read(2)
        if len(pair) < 2:
            break
        count, value = pair
        if count:  # encoded mode, clipped at the row's end
            count = min(count, max(0, width - x))
            if four:
                out += bytes((value >> 4, value & 15)) * (count // 2) + bytes((value >> 4,)) * (count % 2)
            else:
                out += bytes((value,)) * count
            x += count
        elif value == 0:  # end of line
            out += b"\x00" * (-len(out) % width)
            x = 0
        elif value == 1:  # end of bitmap
            break
        elif value == 2:  # delta: two bytes dropped, then right and up
            if len(read(2)) < 2:
                break
            step = read(2)
            if len(step) < 2:
                raise ValueError(f"{name}: truncated RLE delta")
            skip = step[0] + step[1] * width
            if len(out) + skip >= need:  # the image is full: the rest is never read
                out += b"\x00" * (need - len(out))
                break
            out += b"\x00" * skip
            x = len(out) % width
        else:  # absolute mode
            want = value // 2 if four else value
            got = read(want)
            if four:
                out += bytes(v for b in got for v in (b >> 4, b & 15))
            else:
                out += got
            if len(got) < want:
                break
            x += value
            if pos % 2:  # word alignment by the position in the file
                pos += 1
    return bytes(out)


def decode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """uint8 [H, W, 3]: `PIL.Image.open(...).convert("RGB")` of a BMP file."""
    data = bytes(data)
    if data[:2] != SIGNATURE:
        raise ValueError(f"{name}: not a BMP file (no BM signature)")
    if len(data) < 18:
        raise ValueError(f"{name}: truncated BMP header")
    offset, header_size = _u32(data, 10), _u32(data, 14)
    hd = data[18 : 14 + header_size]
    if len(hd) < header_size - 4:
        raise ValueError(f"{name}: truncated BMP header")
    pos = 14 + header_size
    masks = None
    if header_size == 12:
        width, height, bits = _u16(hd, 0), _u16(hd, 2), _u16(hd, 6)
        compression, colors, padding, top_down = RGB, 0, 3, False
    elif header_size in (40, 52, 56, 64, 108, 124):
        top_down = hd[7] == 0xFF
        width, height = _u32(hd, 0), (2**32 - _u32(hd, 4)) if top_down else _u32(hd, 4)
        bits, compression, colors, padding = _u16(hd, 10), _u32(hd, 12), _u32(hd, 28), 4
        if compression == BITFIELDS:
            if len(hd) >= 48:
                masks = tuple(_u32(hd, 36 + 4 * k) for k in range(4 if len(hd) >= 52 else 3))
                masks += (0,) * (4 - len(masks))
            else:  # a 40-byte header: three masks follow it
                if len(data) < pos + 12:
                    raise ValueError(f"{name}: truncated BMP bit-field masks")
                masks = (*(_u32(data, pos + 4 * k) for k in range(3)), 0)
                pos += 12
    else:
        raise ValueError(f"{name}: unsupported BMP header type ({header_size})")
    colors = colors or (1 << bits)
    if offset == 14 + header_size and bits <= 8:
        offset += 4 * colors
    if bits not in BIT2MODE:
        raise ValueError(f"{name}: unsupported BMP pixel depth ({bits})")
    mode, raw = BIT2MODE[bits]
    if compression == BITFIELDS:
        key = (bits, masks) if bits == 32 else (bits, masks[:3])
        if key not in MASK_MODES:
            raise ValueError(f"{name}: unsupported BMP bitfields layout ({bits} bits, masks {masks})")
        raw = MASK_MODES[key]
    elif compression not in (RGB, RLE8, RLE4):
        raise ValueError(f"{name}: unsupported BMP compression ({compression})")
    palette = None
    if mode == "P":
        if not 0 < colors <= 65536:
            raise ValueError(f"{name}: unsupported BMP palette size ({colors})")
        table = data[pos : pos + padding * colors]
        indices = (0, 255) if colors == 2 else range(colors)
        if all(table[i * padding : i * padding + 3] == bytes((v & 255,)) * 3 for i, v in enumerate(indices)):
            mode = raw = "1" if colors == 2 else "L"
        else:
            if len(table) // padding > 256:
                raise ValueError(f"{name}: invalid palette size ({len(table) // padding} entries)")
            entries = np.frombuffer(table[: len(table) // padding * padding], np.uint8).reshape(-1, padding)
            palette = np.zeros((256, 3), np.uint8)
            palette[: len(entries)] = entries[:, 2::-1]
    if not (width and height) or width * height > MAX_PIXELS:
        raise ValueError(f"{name}: BMP image of size {width} x {height}")
    if compression in (RLE8, RLE4):
        if mode not in ("P", "L"):
            raise ValueError(f"{name}: RLE data for a {mode} image (unknown raw mode for given image mode)")
        pixels = _rle(data, offset, width, height, compression == RLE4, name)
        if len(pixels) < width * height:
            raise ValueError(f"{name}: not enough image data ({len(pixels)} of {width * height} pixels)")
        rows, raw = np.frombuffer(pixels[: width * height], np.uint8).reshape(height, width), mode
    else:
        stride = ((width * bits + 31) >> 3) & ~3
        row_bytes = (RAW_BITS.get(raw, 32) * width + 7) // 8
        if stride < row_bytes:
            raise ValueError(f"{name}: {raw} rows of {row_bytes} bytes in a stride of {stride} "
                             "(codec configuration error)")
        if len(data) < offset + stride * (height - 1) + row_bytes:
            raise ValueError(f"{name}: truncated BMP image data (image file is truncated)")
        block = np.frombuffer(data, np.uint8, count=stride * height, offset=offset) \
            if len(data) >= offset + stride * height else \
            np.frombuffer(data[offset:].ljust(stride * height, b"\x00"), np.uint8)
        rows = block.reshape(height, stride)
    if not top_down:
        rows = rows[::-1]
    px = _samples(np.ascontiguousarray(rows), raw, width)
    if palette is not None:
        return palette[px[:, :, 0]]
    return np.ascontiguousarray(np.repeat(px, 3, axis=2) if px.shape[2] == 1 else px)


def dib_geometry(data: bytes, at: int, name: str) -> tuple:
    """(header size, width, height, bits, top_down, pixel data offset) of the DIB at `at` (a BMP without its
    file header, alone or in an icon): its data follows the header, a 40-byte header's BI_BITFIELDS masks
    and the palette, as Pillow's `_bitmap` reads them."""
    if len(data) < at + 16:
        raise ValueError(f"{name}: truncated DIB header")
    header_size = _u32(data, at)
    if header_size == 12:
        width, height, bits = _u16(data, at + 4), _u16(data, at + 6), _u16(data, at + 10)
        compression, colors, padding, top_down = RGB, 0, 3, False
    elif header_size in (40, 52, 56, 64, 108, 124):
        if len(data) < at + 36:
            raise ValueError(f"{name}: truncated DIB header")
        top_down = data[at + 11] == 0xFF
        raw_height = _u32(data, at + 8)
        width, height = _u32(data, at + 4), (2**32 - raw_height) if top_down else raw_height
        bits, compression, colors, padding = _u16(data, at + 14), _u32(data, at + 16), _u32(data, at + 32), 4
    else:
        raise ValueError(f"{name}: unsupported BMP header type ({header_size})")
    pixels = at + header_size
    if compression == BITFIELDS and header_size == 40:
        pixels += 12
    if bits <= 8:
        pixels += padding * (colors or (1 << bits))
    return header_size, width, height, bits, top_down, pixels


DIB_HEADER_SIZES = (12, 40, 52, 56, 64, 108, 124)


def dib_accepts(data: bytes) -> bool:
    """DibImageFile's _accept: the first 4 bytes are a header size Pillow reads."""
    return len(data) >= 4 and _u32(data, 0) in DIB_HEADER_SIZES


def dib_opens(data: bytes, at: int = 0, halved: bool = False) -> bool:
    """Whether Image.open keeps the reader of the DIB at `at` (an image, or an error it raises): not where
    its header size is cut short, a 40-byte header's BI_BITFIELDS masks are, or the size (with the height
    halved, as a cursor's is) is 0, where Image.open tries its next reader."""
    if len(data) < at + 4:
        return False
    header_size = _u32(data, at)
    if header_size not in DIB_HEADER_SIZES or len(data) < at + header_size:
        return True  # Pillow raises on the header
    if header_size == 12:
        width, height = _u16(data, at + 4), _u16(data, at + 6)
    else:
        if _u32(data, at + 16) == BITFIELDS and header_size == 40 and len(data) < at + 52:
            return False
        raw_height = _u32(data, at + 8)
        width, height = _u32(data, at + 4), (2**32 - raw_height) if data[at + 11] == 0xFF else raw_height
    return width > 0 and (height // 2 if halved else height) > 0


def decode_dib(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """uint8 [H, W, 3]: `PIL.Image.open(...).convert("RGB")` of a DIB file (a BMP without its 14-byte file
    header; Pillow's `DibImageFile`), decoded by `decode` behind a file header that points at its pixels."""
    data = bytes(data)
    pixels = min(14 + dib_geometry(data, 0, name)[5], 2**32 - 1)  # past 4 bytes only with a palette decode refuses
    head = SIGNATURE + (14 + len(data)).to_bytes(4, "little") + bytes(4) + pixels.to_bytes(4, "little")
    return decode(head + data, name)
