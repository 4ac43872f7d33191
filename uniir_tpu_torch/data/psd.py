"""PSD (Adobe Photoshop) decoding with Pillow's pixels, without Pillow.

The JAX package reads every image with `PIL.Image.open(path).convert("RGB")`.
For a PSD file this module gives the same uint8 [H, W, 3] array as Pillow
12.1 (`PsdImagePlugin`, its raw and PackBits tiles and `convert("RGB")`):
the merged image only, as Image.open shows it.

  * the 26-byte header: version 1, the (colour mode, bits) pair in Pillow's
    MODES (bitmap at 1 bit, grey, indexed, RGB, CMYK, multichannel,
    duotone and Lab at 8 bits) and the channels that mode needs; RGB with
    exactly four channels is RGBA;
  * the colour mode data (an indexed image's palette where it is 768 bytes,
    planar: 256 reds, greens, blues; none otherwise, which shows black),
    the image resources (walked as Pillow walks them, which may end past
    their length) and the layer and mask section (skipped by its length);
  * the image data: raw (compression 0, each channel's plane at width x
    height bytes from the last) or PackBits (1; each channel from the sum
    of the row byte counts before it, decoded by `raster.packbits` on
    however many bytes its rows take); any other compression opens and
    cannot load, as in Pillow;
  * CMYK read inverted (Pillow's ";I" raw modes), then Convert.c's cmyk2rgb;
    Lab's a and b read as Pillow stores them and converted to RGB by
    `lab_to_rgb` (LittleCMS's Lab -> sRGB transform, `data/lab.py`); bitmap's
    1 bits white.

A header Pillow does not read (another version, a mode or depth outside
MODES, sections cut short before the image data) is not a PSD file to
Image.open (it tries its next reader); too few channels, a compression other
than raw or PackBits and data cut short raise ValueError naming the file,
as Pillow's open or load raises.
"""

from __future__ import annotations

import struct
from typing import Callable

import numpy as np

from uniir_tpu_torch.data import raster, tiff
from uniir_tpu_torch.data.lab import lab_to_rgb

SIGNATURE = b"8BPS"
# (colour mode, bits) -> (mode, channels it needs): PsdImagePlugin.MODES
MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1), (2, 8): ("P", 1), (3, 8): ("RGB", 3),
         (4, 8): ("CMYK", 4), (7, 8): ("L", 1), (8, 8): ("L", 1), (9, 8): ("LAB", 3)}


def accepts(data: bytes) -> bool:
    return data[:4] == SIGNATURE


class _Reader:
    """A file's reads as Pillow makes them: a read past the end returns what is left; a seek may pass it."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos

    def read(self, n: int) -> bytes:
        out = self.data[self.pos : self.pos + max(n, 0)]
        self.pos += len(out)
        return out

    def u(self, n: int) -> int:
        """A big-endian unsigned number of n bytes; struct.error (Image.open's next reader) where cut short."""
        b = self.read(n)
        if len(b) < n:
            raise raster.NotThisFormat("PSD header cut short")
        return int.from_bytes(b, "big")


def parse(data: bytes, name: str = "<bytes>") -> dict:
    """PsdImageFile._open: {"size", "mode", "channels", "palette", "compression", "offsets" (each channel's
    data), "row_bytes"}; raises raster.NotThisFormat where Image.open tries its next reader, ValueError
    where it raises."""
    s = data[:26]
    if not accepts(s) or len(s) < 26:
        raise raster.NotThisFormat(f"{name}: PSD header cut short")
    version, psd_channels, height, width, bits, psd_mode = struct.unpack(">H6xHIIHH", s[4:26])
    if version != 1:
        raise raster.NotThisFormat(f"{name}: not a PSD file (version {version})")
    if (psd_mode, bits) not in MODES:
        raise raster.NotThisFormat(f"{name}: PSD mode {psd_mode} at {bits} bits")
    mode, channels = MODES[(psd_mode, bits)]
    if channels > psd_channels:
        raise ValueError(f"{name}: PSD image of {psd_channels} channels (not enough channels)")
    if mode == "RGB" and psd_channels == 4:
        mode, channels = "RGBA", 4
    f = _Reader(data, 26)
    try:
        size = f.u(4)  # colour mode data
        palette = None
        if size:
            block = f.read(size)
            if mode == "P" and size == 768:
                palette = np.frombuffer(block.ljust(768, b"\0"), np.uint8).reshape(3, 256).T.copy()
        size = f.u(4)  # image resources
        if size:
            end = f.pos + size
            while f.pos < end:
                f.read(4)
                f.u(2)
                n = f.read(1)
                if not n:
                    raise raster.NotThisFormat("PSD resource cut short")
                if not len(f.read(n[0])) & 1:
                    f.read(1)
                if len(f.read(f.u(4))) & 1:
                    f.read(1)
        size = f.u(4)  # layer and mask information
        if size:
            end = f.pos + size
            f.u(4)
            f.pos = end
        compression = f.u(2)
        row_bytes = (width + 7) // 8 if mode == "1" else width
        offsets = []
        if compression == 0:
            offsets = [f.pos + c * width * height for c in range(channels)]
        elif compression == 1:
            counts = f.read(channels * height * 2)
            if len(counts) < channels * height * 2:
                raise raster.NotThisFormat("PSD row byte counts cut short")
            sums = np.concatenate([[0], np.cumsum(np.frombuffer(counts, ">u2").astype(np.int64))])
            offsets = [f.pos + int(sums[c * height]) for c in range(channels)]
    except raster.NotThisFormat as e:
        raise raster.NotThisFormat(f"{name}: {e}") from None
    raster.check_size(width, height, name)
    return {"size": (width, height), "mode": mode, "channels": channels, "palette": palette,
            "compression": compression, "offsets": offsets, "row_bytes": row_bytes}


# --- the image -------------------------------------------------------------------


def decode(data: bytes, name: str = "<bytes>", native: bool = False) -> np.ndarray:
    """uint8 [H, W, 3]: `PIL.Image.open(...).convert("RGB")` of a PSD file."""
    data = bytes(data)
    p = parse(data, name)
    (width, height), mode, channels, row_bytes = p["size"], p["mode"], p["channels"], p["row_bytes"]
    if p["compression"] == 0:
        planes = []
        for at in p["offsets"]:  # Pillow reads the tiles in the order of their offsets, which rise
            if len(data) - at < row_bytes * height:
                raise ValueError(f"{name}: PSD image data cut short (image file is truncated)")
            planes.append(np.frombuffer(data, np.uint8, count=row_bytes * height, offset=at))
        rows = np.stack(planes).reshape(channels, height, row_bytes)
    elif p["compression"] == 1:
        rows = raster.expander("packbits", native)(data, tuple(p["offsets"]), row_bytes, height, name)
        rows = np.frombuffer(rows, np.uint8).reshape(channels, height, row_bytes)
    else:
        raise ValueError(f"{name}: PSD compression {p['compression']} (cannot load this image)")
    if mode == "1":
        bits = np.unpackbits(rows[0], axis=1)[:, :width]
        return np.repeat((bits * 255)[:, :, None], 3, axis=2)
    px = rows.transpose(1, 2, 0)
    if mode == "P":
        table = np.zeros((256, 3), np.uint8) if p["palette"] is None else p["palette"]
        return table[px[..., 0]]
    if mode == "CMYK":
        return tiff.to_rgb(255 - px, "CMYK")
    if mode == "LAB":  # Pillow's "A" / "B" raw modes store a and b offset by 128, which `lab_to_rgb` takes
        return lab_to_rgb(px ^ np.array([0, 0x80, 0x80], np.uint8))
    return tiff.to_rgb(np.ascontiguousarray(px), "RGB" if mode == "RGBA" else mode)


def decode_twin(data: bytes, name: str = "<bytes>") -> np.ndarray:
    return decode(data, name)


def decode_native(data: bytes, name: str = "<bytes>") -> np.ndarray:
    return decode(data, name, native=True)


def decoder_for(device) -> Callable[[bytes, str], np.ndarray]:
    """The decoder a run on `device` uses: the native one on a CUDA run's host, the twin on a CPU run."""
    from uniir_tpu_torch import _build

    return decode_native if _build.is_cuda(device) else decode_twin
