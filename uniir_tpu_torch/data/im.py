"""IFUNC IM decoding with Pillow's pixels, without Pillow.

The JAX package reads every image with `PIL.Image.open(path).convert("RGB")`.
For an IM file (the IFUNC image memory format) this module gives the same
uint8 [H, W, 3] array as Pillow 12.1 (`ImImagePlugin`, its raw unpackers,
`BitDecode.c` and `convert("RGB")`):

  * the text header read as Pillow reads it: "key: value" lines of up to
    100 bytes up to a 0x00 or 0x1A byte or the file's end, carriage
    returns dropped, "Image size (x*y)" read as numbers, "Image type" as a
    mode and raw mode (`OPEN`, Pillow's table), "Lut" as a 768-byte planar
    table after the 0x1A byte that ends the header;
  * the table makes an L / P image colour-mapped and an LA image PA unless
    it is grey; it changes nothing else (Pillow keeps it aside);
  * pixels: rows bottom-up in every raw mode of the table (1-bit, 2 / 4-bit
    indices, 8-bit, planar RGB / RGBA / RGBX / CMYK / LA / PA rows,
    RGB;T's three planes, 16-bit, 32-bit integer and float, 8 / 16 / 32-bit
    samples read as float, and the other widths of `L*n` through Pillow's
    bit decoder, least significant bits first);
  * `convert("RGB")` from each mode as `tiff.to_rgb` computes it (Convert.c;
    an index past the table, or any index of a P image without one, black),
    and from YCbCr as `ycbcr_to_rgb` does (ConvertYCbCr.c's fixed-point
    tables).

A raw mode Pillow has no unpacker for (RLB, PA without a table, a mode
name the table does not hold) raises, as in Pillow.

A header Pillow does not read as IM is not an IM file to Image.open (it
tries its next reader); anything else Pillow refuses raises ValueError
naming the file.
"""

from __future__ import annotations

import re

import numpy as np

from uniir_tpu_torch.data import raster, tiff

COMMENT, FRAMES, LUT, SCALE, SIZE, MODE = ("Comment", "File size (no of images)", "Lut", "Scale (x,y)",
                                           "Image size (x*y)", "Image type")
TAGS = {COMMENT, "Date", "Digitalization equipment", FRAMES, LUT, "Name", SCALE, SIZE, MODE}

# Image type -> (mode, raw mode): ImImagePlugin.OPEN, built the same way
OPEN = {
    "0 1 image": ("1", "1"), "L 1 image": ("1", "1"), "Greyscale image": ("L", "L"), "Grayscale image": ("L", "L"),
    "RGB image": ("RGB", "RGB;L"), "RLB image": ("RGB", "RLB"), "RYB image": ("RGB", "RLB"),
    "B1 image": ("1", "1"), "B2 image": ("P", "P;2"), "B4 image": ("P", "P;4"), "X 24 image": ("RGB", "RGB"),
    "L 32 S image": ("I", "I;32"), "L 32 F image": ("F", "F;32"), "RGB3 image": ("RGB", "RGB;T"),
    "RYB3 image": ("RGB", "RYB;T"), "LA image": ("LA", "LA;L"), "PA image": ("LA", "PA;L"),
    "RGBA image": ("RGBA", "RGBA;L"), "RGBX image": ("RGB", "RGBX;L"), "CMYK image": ("CMYK", "CMYK;L"),
    "YCC image": ("YCbCr", "YCbCr;L"),
}
for _i in ["8", "8S", "16", "16S", "32", "32F"]:
    OPEN[f"L {_i} image"] = ("F", f"F;{_i}")
    OPEN[f"L*{_i} image"] = ("F", f"F;{_i}")
for _i in ["16", "16L", "16B"]:
    OPEN[f"L {_i} image"] = (f"I;{_i}", f"I;{_i}")
    OPEN[f"L*{_i} image"] = (f"I;{_i}", f"I;{_i}")
OPEN["L 32S image"] = OPEN["L*32S image"] = ("I", "I;32S")
for _j in range(2, 33):
    OPEN[f"L*{_j} image"] = ("F", f"F;{_j}")

SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")

# (mode, raw mode) pairs Pillow unpacks: bytes a pixel (bits for the packed ones) and numpy's reading
_PLANAR = {"RGB;L": 3, "RGBX;L": 4, "RGBA;L": 4, "CMYK;L": 4, "LA;L": 2, "PA;L": 2, "YCbCr;L": 3}
_SCALAR = {"F;8": "u1", "F;8S": "i1", "F;16": "<u2", "F;16S": "<i2", "F;32": "<u4", "F;32F": "<f4",
           "I;32": "<i4", "I;32S": "<i4", "I;16": "<u2", "I;16L": "<u2", "I;16B": ">u2"}
_VALID = ({("1", "1"), ("L", "L"), ("P", "P"), ("P", "P;2"), ("P", "P;4"), ("RGB", "RGB"), ("LA", "LA;L"),
           ("PA", "PA;L"), ("RGBA", "RGBA;L"), ("RGB", "RGBX;L"), ("RGB", "RGB;L"), ("CMYK", "CMYK;L"),
           ("YCbCr", "YCbCr;L"), ("RGB", "RGB;T"), ("RGB", "RYB;T"), ("I", "I;32"), ("I", "I;32S"),
           ("I;16", "I;16"), ("I;16L", "I;16L"), ("I;16B", "I;16B")}
          | {("F", f"F;{k}") for k in ["8", "8S", "16", "16S", "32", "32F"] + [str(j) for j in range(2, 32)]})


def _ycbcr_table(k: float) -> np.ndarray:
    """One of ImagingConvertYCbCr2RGB's tables (SCALE 6): k * 64 * (i - 128) + 0.5 over the 256 codes, cut
    toward zero as C's integer conversion cuts; these four equal Pillow's over all 2^24 (Y, Cb, Cr) triples
    (scripts/check_ycbcr_tables.py)."""
    return np.trunc(k * 64 * (np.arange(256) - 128) + 0.5).astype(np.int64)


R_CR, G_CB, G_CR, B_CB = (_ycbcr_table(k) for k in (1.40200, -0.34414, -0.71414, 1.77200))


def ycbcr_to_rgb(px: np.ndarray) -> np.ndarray:
    """uint8 [..., 3] RGB of uint8 [..., 3] (Y, Cb, Cr) samples, as Pillow's convert("RGB") computes it:
    Y plus each table's value shifted right by 6 (an arithmetic shift), clipped to 0..255."""
    y, cb, cr = (px[..., i].astype(np.int64) for i in range(3))
    rgb = np.stack([y + (R_CR[cr] >> 6), y + ((G_CB[cb] + G_CR[cr]) >> 6), y + (B_CB[cb] >> 6)], axis=-1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _number(s: str):
    try:
        return int(s)
    except ValueError:
        return float(s)


def accepts(data: bytes) -> bool:
    """ImImagePlugin has no _accept: its _open's first test, a line feed in the first 100 bytes."""
    return b"\n" in data[:100]


def parse(data: bytes, name: str = "<bytes>") -> dict:
    """ImImageFile._open: {"size", "mode", "rawmode", "offset", "palette"}; raises raster.NotThisFormat
    where Image.open tries its next reader."""
    if not accepts(data):
        raise raster.NotThisFormat(f"{name}: not an IM file")
    info = {MODE: "L", SIZE: (512, 512), FRAMES: 1}
    rawmode, tags, pos, n = "L", 0, 0, len(data)
    s = b""
    while True:
        s = data[pos : pos + 1]
        pos += len(s)
        if s == b"\r":
            continue
        if not s or s in (b"\0", b"\x1a"):
            break
        end = data.find(b"\n", pos)
        end = n if end < 0 else end + 1
        s, pos = s + data[pos:end], end
        if len(s) > 100:
            raise raster.NotThisFormat(f"{name}: IM header line over 100 bytes")
        s = s[:-2] if s.endswith(b"\r\n") else s[:-1] if s.endswith(b"\n") else s
        m = SPLIT.match(s)
        if not m:
            raise raster.NotThisFormat(f"{name}: syntax error in IM header")
        k, v = (g.decode("latin-1", "replace") for g in m.group(1, 2))
        if k in (FRAMES, SCALE, SIZE):
            try:
                v = tuple(_number(x) for x in v.replace("*", ",").split(","))
            except ValueError:
                raise ValueError(f"{name}: IM header value {v!r} for {k!r} is no number") from None
            v = v[0] if len(v) == 1 else v
        elif k == MODE and v in OPEN:
            v, rawmode = OPEN[v]
        info[k] = v
        if k in TAGS:
            tags += 1
    if not tags:
        raise raster.NotThisFormat(f"{name}: not an IM file (no IM header key)")
    size, mode = info[SIZE], info[MODE]
    while s and s[:1] != b"\x1a":
        s = data[pos : pos + 1]
        pos += len(s)
    if not s:
        raise raster.NotThisFormat(f"{name}: IM file truncated before its data")
    palette = None
    if LUT in info:
        lut = data[pos : pos + 768]
        pos += len(lut)
        if len(lut) < 768:
            for i in range(256):  # Pillow's test of each entry, which indexes past a table cut short
                if i + 256 >= len(lut) or lut[i] == lut[i + 256] and i + 512 >= len(lut):
                    raise raster.NotThisFormat(f"{name}: IM lookup table cut short")
            lut += bytes(768 - len(lut))  # not reached with pixels after it: the pixels are cut short too
        t = np.frombuffer(lut, np.uint8).reshape(3, 256)
        grey = bool((t[0] == t[1]).all() and (t[1] == t[2]).all())
        if mode in ("L", "LA", "P", "PA") and not grey:
            mode, rawmode = ("P", "P") if mode in ("L", "P") else ("PA", "PA;L")
            palette = np.ascontiguousarray(t.T)
    if not mode or not isinstance(size, tuple):
        raise raster.NotThisFormat(f"{name}: IM image of size {size!r}, mode {mode!r}")
    raster.check_size(size[0], size[1], name)
    if len(size) != 2 or not all(isinstance(x, int) for x in size):
        raise ValueError(f"{name}: IM image of size {size!r} (cannot be created)")
    return {"size": size, "mode": mode, "rawmode": rawmode, "offset": pos, "palette": palette}


def _bits(data: bytes, offset: int, width: int, height: int, bits: int, name: str) -> np.ndarray:
    """BitDecode.c with ImImagePlugin's arguments (pad 8, fill 3, unsigned): float32 [height, width], the
    first row read the bottom one."""
    mask, buffer, count, pos = (1 << bits) - 1, 0, 0, offset
    out = np.zeros((height, width), np.float32)
    x, y = 0, height - 1
    while True:
        if pos >= len(data):
            raise ValueError(f"{name}: IM image data cut short (image file is truncated)")
        byte = data[pos]
        pos += 1
        buffer = (buffer | byte << count) & 0xFFFFFFFFFFFFFFFF
        count += 8
        while count >= bits:
            value = buffer & mask
            buffer = byte >> (8 - (count - bits)) if count > 32 else buffer >> bits
            count -= bits
            out[y, x] = value
            x += 1
            if x >= width:
                y -= 1
                if y < 0:
                    return out
                x, count = 0, 0


def decode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """uint8 [H, W, 3]: `PIL.Image.open(...).convert("RGB")` of an IM file."""
    data = bytes(data)
    p = parse(data, name)
    (width, height), mode, rawmode, offset = p["size"], p["mode"], p["rawmode"], p["offset"]
    if (mode, rawmode) not in _VALID:
        raise ValueError(f"{name}: IM {mode} image of raw mode {rawmode} (unknown raw mode for given image mode)")
    if rawmode.startswith("F;") and rawmode[2:].isdigit() and int(rawmode[2:]) not in (8, 16, 32):
        px = _bits(data, offset, width, height, int(rawmode[2:]), name)[:, :, None]
        return tiff.to_rgb(px, "F")
    if rawmode in ("RGB;T", "RYB;T"):
        need = 3 * width * height
        if len(data) < offset + need:
            raise ValueError(f"{name}: IM image data cut short (image file is truncated)")
        g, r, b = np.frombuffer(data, np.uint8, count=need, offset=offset).reshape(3, height, width)[:, ::-1]
        return np.ascontiguousarray(np.stack([r, g, b], axis=2))
    if rawmode in _PLANAR:
        k = _PLANAR[rawmode]
        row_bytes = k * width
    elif rawmode in _SCALAR:
        row_bytes = np.dtype(_SCALAR[rawmode]).itemsize * width
    else:
        row_bytes = ({"1": 1, "P;2": 2, "P;4": 4}.get(rawmode, 8 * (3 if rawmode == "RGB" else 1)) * width + 7) // 8
    if len(data) < offset + row_bytes * height:
        raise ValueError(f"{name}: IM image data cut short (image file is truncated)")
    rows = np.frombuffer(data, np.uint8, count=row_bytes * height, offset=offset).reshape(height, row_bytes)[::-1]
    if rawmode in _PLANAR:
        px = rows.reshape(height, k, width).transpose(0, 2, 1)
        if mode == "YCbCr":
            return ycbcr_to_rgb(px)
        base = "RGB" if mode == "RGB" else mode
        return tiff.to_rgb(np.ascontiguousarray(px), base, _table(p["palette"]))
    if rawmode in _SCALAR:
        v = np.ascontiguousarray(rows).view(_SCALAR[rawmode]).reshape(height, width)
        v = v.astype(np.float32) if mode == "F" else v.astype(np.int64)
        return tiff.to_rgb(v[:, :, None], "F" if mode == "F" else "I")
    px = tiff.unpack(rawmode, np.ascontiguousarray(rows), width)
    return tiff.to_rgb(px, mode, _table(p["palette"]))


def _table(palette) -> np.ndarray:
    table = np.zeros((256, 3), np.uint8)
    if palette is not None:
        table[: len(palette)] = palette
    return table
