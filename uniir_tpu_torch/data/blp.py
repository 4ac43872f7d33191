"""BLP (Blizzard mipmap) decoding with Pillow's pixels, without Pillow.

The JAX package reads every image with `PIL.Image.open(path).convert("RGB")`.
For a BLP file this module gives the same uint8 [H, W, 3] array as Pillow
12.1 (`BlpImagePlugin`, whose decoders are Python): the header (BLP1: the
compression, an alpha flag, the size, the encoding; BLP2: the compression,
encoding, alpha flag and alpha encoding, the size), the mode RGBA with
alpha, else RGB (alpha dropped by `convert`), and after the header sixteen
mipmap offsets and sixteen lengths, of which the first are read:

  * BLP1, compression 0: a JPEG header (its length, then its bytes) put in
    front of the first mipmap's bytes (read from its offset, or on from the
    header where that offset lies before it), decoded as Pillow's JPEG
    reader does (`data.jpeg`; the plugin's re-tag of a CMYK frame makes
    libjpeg take a YCCK frame's components as CMYK, unconverted), and the
    RGB bytes read as BGR: red and blue swapped;
  * BLP1, compression 1, encoding 4 or 5: a palette of 256 BGRA entries,
    then the first mipmap's length in indices read on from the palette (its
    offset unread);
  * BLP2, compression 1: the palette always read first, then from the first
    mipmap's offset its indices (encoding 1) or DXT1 / DXT3 / DXT5 blocks
    (encoding 2, alpha encoding 0 / 1 / 7), decoded as the plugin's
    `decode_dxt1` / `decode_dxt3` / `decode_dxt5` compute them: 5-6-5
    colours shifted, not bit-replicated; the third and fourth colours by
    integer division (DXT1's three-colour form where colour 0 <= colour 1,
    its fourth transparent black); DXT3's 4-bit alpha times 17; DXT5's
    interpolated alpha (six-value form with 0 and 255);
  * the pixel bytes handed to Pillow's raw decoder row by row of the image's
    width: DXT rows are whole blocks wide and DXT3 / DXT5 pixels 4 bytes
    even in mode RGB, so a width that is not a multiple of 4, or an RGB
    image of DXT3 / DXT5 blocks, reads them shifted, as Pillow does.

A header cut short, or a size of 0, is not a BLP file to Image.open (it tries
its next reader); what Pillow's decoders refuse (another compression or
encoding -- BLP2's raw BGRA encoding 3 among them --, data cut short, too
few pixels) raises ValueError naming the file.
"""

from __future__ import annotations

import struct
from typing import Callable

import numpy as np

from uniir_tpu_torch.data import raster


def accepts(data: bytes) -> bool:
    return data[:4] in (b"BLP1", b"BLP2")


def parse(data: bytes, name: str = "<bytes>") -> dict:
    """BlpImageFile._open: version, compression, encodings, alpha, size and where the decoder starts; raises
    raster.NotThisFormat where Image.open tries its next reader."""
    blp1 = data[:4] == b"BLP1"
    if not accepts(data) or len(data) < (24 if blp1 else 20):
        raise raster.NotThisFormat(f"{name}: BLP header cut short")
    compression = struct.unpack_from("<i", data, 4)[0]
    if blp1:
        alpha = struct.unpack_from("<I", data, 8)[0] != 0
        encoding, alpha_encoding = struct.unpack_from("<i", data, 20)[0], None
    else:
        encoding, alpha, alpha_encoding = struct.unpack_from("<bbb", data, 8)
        alpha = alpha != 0
    width, height = struct.unpack_from("<II", data, 12)
    raster.check_size(width, height, name)
    return {"blp1": blp1, "compression": compression, "encoding": encoding, "alpha": alpha,
            "alpha_encoding": alpha_encoding, "size": (width, height), "offset": 28 if blp1 else 20}


class _Reader:
    """ImageFile._safe_read over the file from a position: exactly n bytes, or ValueError."""

    def __init__(self, data: bytes, pos: int, name: str):
        self.data, self.pos, self.name = data, pos, name

    def read(self, n: int) -> bytes:
        if n <= 0:
            return b""
        if self.pos + n > len(self.data):
            raise ValueError(f"{self.name}: BLP data cut short (Truncated File Read)")
        self.pos += n
        return self.data[self.pos - n: self.pos]


def _unpack_565(c: np.ndarray) -> np.ndarray:
    """[..., 3] of BlpImagePlugin.unpack_565: each field shifted to 8 bits, its low bits 0."""
    return np.stack([(c >> 11 & 0x1F) << 3, (c >> 5 & 0x3F) << 2, (c & 0x1F) << 3], axis=-1)


def dxt_pixels(blocks: np.ndarray, kind: str, alpha: bool) -> bytes:
    """The bytes decode_dxt1 / decode_dxt3 / decode_dxt5 append for blocks uint8 [rows, columns, 8 | 16]:
    4 rows of pixels a block row, each pixel R, G, B (and A: DXT1 with alpha, DXT3, DXT5)."""
    b = blocks.astype(np.int64)
    colour = b[..., 8:] if kind != "dxt1" else b
    c0 = colour[..., 0] | colour[..., 1] << 8
    c1 = colour[..., 2] | colour[..., 3] << 8
    code = colour[..., 4] | colour[..., 5] << 8 | colour[..., 6] << 16 | colour[..., 7] << 24
    p0, p1 = _unpack_565(c0), _unpack_565(c1)
    four = (c0 > c1)[..., None] if kind == "dxt1" else np.ones(c0.shape + (1,), bool)
    p2 = np.where(four, (2 * p0 + p1) // 3, (p0 + p1) // 2)
    p3 = np.where(four, (2 * p1 + p0) // 3, 0)
    table = np.stack([p0, p1, p2, p3], axis=-2)  # [rows, columns, 4, 3]
    sel = code[..., None] >> (2 * np.arange(16)) & 3  # [rows, columns, 16]
    rgb = np.take_along_axis(table, sel[..., None], axis=-2)
    if kind == "dxt1":
        a = np.where(~four & (sel == 3), 0, 255)
    elif kind == "dxt3":
        nib = b[..., np.arange(16) // 2] >> (4 * (np.arange(16) % 2)) & 0xF
        a = nib * 17
    else:
        a0, a1 = b[..., 0:1], b[..., 1:2]
        bits = sum(b[..., 2 + k] << (8 * k) for k in range(6))
        ac = bits[..., None] >> (3 * np.arange(16)) & 7
        eight = ((8 - ac) * a0 + (ac - 1) * a1) // 7
        six = np.where(ac == 6, 0, np.where(ac == 7, 255, ((6 - ac) * a0 + (ac - 1) * a1) // 5))
        a = np.where(ac == 0, a0, np.where(ac == 1, a1, np.where(a0 > a1, eight, six)))
    px = np.concatenate([rgb, a[..., None]], axis=-1) if kind != "dxt1" or alpha else rgb
    rows, cols = blocks.shape[:2]
    return px.reshape(rows, cols, 4, 4, -1).transpose(0, 2, 1, 3, 4).astype(np.uint8).tobytes()


def _palette(r: _Reader) -> np.ndarray:
    """_read_palette: 256 BGRA entries as [256, 4] R, G, B, A."""
    bgra = np.frombuffer(r.read(1024), np.uint8).reshape(256, 4)
    return bgra[:, [2, 1, 0, 3]]


def _jpeg_rgb(data: bytes, name: str, native: bool) -> np.ndarray:
    """JpegImageFile(data).convert("RGB") after the plugin's re-tag of a CMYK frame: its jpegmode "CMYK" sets
    libjpeg's input colour space, so a YCCK frame's four components come out as they are stored, then are
    inverted (raw mode CMYK;I) and converted as any CMYK JPEG is."""
    from uniir_tpu_torch.data import jpeg

    if len(jpeg.parse(data, name).components) != 4:
        return (jpeg.decode_native if native else jpeg.decode_twin)(data, name)
    jpeg.open_header(data, name)
    samples = (jpeg.decode_samples_native if native else jpeg.decode_samples)(data, name, "cmyk")
    return jpeg.cmyk_to_rgb(255 - samples)


def decode(data: bytes, name: str = "<bytes>", native: bool = False) -> np.ndarray:
    """uint8 [H, W, 3]: `PIL.Image.open(...).convert("RGB")` of a BLP file."""
    data = bytes(data)
    p = parse(data, name)
    (width, height), alpha = p["size"], p["alpha"]
    bands = 4 if alpha else 3
    r = _Reader(data, p["offset"], name)
    offsets = struct.unpack("<16I", r.read(64))
    lengths = struct.unpack("<16I", r.read(64))
    compression, encoding = p["compression"], p["encoding"]
    swap = False
    if p["blp1"] and compression == 0:
        header = r.read(struct.unpack("<I", r.read(4))[0])
        r.read(offsets[0] - r.pos)
        rgb = _jpeg_rgb(header + r.read(lengths[0]), name, native)
        raw, bands, swap = rgb.tobytes(), 3, True
    elif p["blp1"]:
        if compression != 1 or encoding not in (4, 5):
            raise ValueError(f"{name}: unsupported BLP1 compression {compression} / encoding {encoding}")
        palette = _palette(r)
        raw = palette[np.frombuffer(r.read(lengths[0]), np.uint8)][:, :bands].tobytes()
    else:
        palette = _palette(r)
        r.pos = offsets[0]
        if compression != 1 or encoding not in (1, 2):
            raise ValueError(f"{name}: unsupported BLP2 compression {compression} / encoding {encoding} (Pillow "
                             "decodes compression 1, encodings 1 and 2)")
        if encoding == 1:
            raw = palette[np.frombuffer(r.read(lengths[0]), np.uint8)][:, :bands].tobytes()
        else:
            kind = {0: "dxt1", 1: "dxt3", 7: "dxt5"}.get(p["alpha_encoding"])
            if kind is None:
                raise ValueError(f"{name}: unsupported BLP2 alpha encoding {p['alpha_encoding']}")
            cols, rows = (width + 3) // 4, (height + 3) // 4
            size = 8 if kind == "dxt1" else 16
            blocks = np.frombuffer(r.read(cols * rows * size), np.uint8).reshape(rows, cols, size)
            raw = dxt_pixels(blocks, kind, alpha)
    need = width * height * bands
    if len(raw) < need:
        raise ValueError(f"{name}: BLP pixel data of {len(raw)} bytes for {need} (not enough image data)")
    px = np.frombuffer(raw, np.uint8, count=need).reshape(height, width, bands)
    return np.ascontiguousarray(px[..., 2::-1] if swap else px[..., :3])


def decode_twin(data: bytes, name: str = "<bytes>") -> np.ndarray:
    return decode(data, name)


def decode_native(data: bytes, name: str = "<bytes>") -> np.ndarray:
    return decode(data, name, native=True)


def decoder_for(device) -> Callable[[bytes, str], np.ndarray]:
    """The decoder a run on `device` uses: the JPEG of a BLP1 file through the native JPEG decoder on a CUDA
    run's host, the twin on a CPU run; the rest is numpy either way."""
    from uniir_tpu_torch import _build

    return decode_native if _build.is_cuda(device) else decode_twin
