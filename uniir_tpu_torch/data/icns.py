"""ICNS (Mac OS icon) decoding with Pillow's pixels, without Pillow.

The JAX package reads every image with `PIL.Image.open(path).convert("RGB")`.
For an ICNS file this module gives the same uint8 [H, W, 3] array as Pillow
12.1 (`IcnsImagePlugin`):

  * the resource list: an 8-byte header ("icns", the file's length), then
    entries of a type and a length (header included) up to that length,
    the last of a type kept;
  * the size Pillow shows, `bestsize`: the largest (width, height, scale)
    of SIZES that names an entry present, a mask alone included;
  * every entry of that size read in SIZES' order: a PNG entry decoded by
    `data/png.py` from its offset on, a JPEG 2000 entry (a codestream or a
    JP2 file) by `data/jpeg2000.py` over the entry's bytes (either one's
    size must be one Pillow allows for the file's sizes); `it32` (after its
    4 zero bytes), `ih32`, `il32` and `is32` read raw where their length is 3 x the pixels, else as three
    RLE channels by `raster.icns_rle`; the `*8mk` masks read (only for their
    errors: convert("RGB") drops the alpha they give);
  * a PNG or JPEG 2000 entry wins over the RLE one of its size.

A JPEG 2000 form the port does not decode raises UnsupportedImageFormat, as
a plain JPEG 2000 file does.  A header or resource list cut short, an entry of
length 0 or no entry of a size Pillow knows is not an ICNS file to
Image.open (it tries its next reader); anything Pillow's load refuses (an
unknown entry signature, an RLE channel that misses its size, data cut
short, a PNG or JPEG 2000 image of a size it does not allow, a mask alone, a
JPEG 2000 entry Pillow's plugin refuses) raises ValueError
naming the file.
"""

from __future__ import annotations

import struct
from typing import Callable

import numpy as np

from uniir_tpu_torch.data import jpeg2000, png, raster

SIGNATURE = b"icns"
# (width, height, scale) -> [(entry type, reader)], in IcnsFile.SIZES' order
SIZES = {
    (512, 512, 2): [(b"ic10", "png")], (512, 512, 1): [(b"ic09", "png")], (256, 256, 2): [(b"ic14", "png")],
    (256, 256, 1): [(b"ic08", "png")], (128, 128, 2): [(b"ic13", "png")],
    (128, 128, 1): [(b"ic07", "png"), (b"it32", "rle_lead"), (b"t8mk", "mask")], (64, 64, 1): [(b"icp6", "png")],
    (32, 32, 2): [(b"ic12", "png")], (48, 48, 1): [(b"ih32", "rle"), (b"h8mk", "mask")],
    (32, 32, 1): [(b"icp5", "png"), (b"il32", "rle"), (b"l8mk", "mask")], (16, 16, 2): [(b"ic11", "png")],
    (16, 16, 1): [(b"icp4", "png"), (b"is32", "rle"), (b"s8mk", "mask")],
}
JPEG2000 = (b"\xff\x4f\xff\x51", b"\x0d\x0a\x87\x0a")


def accepts(data: bytes) -> bool:
    return data[:4] == SIGNATURE


def parse(data: bytes, name: str = "<bytes>") -> dict:
    """IcnsFile and IcnsImageFile._open: {"entries": {type: (offset, length)}, "sizes", "best"}; raises
    raster.NotThisFormat where Image.open tries its next reader."""
    if not accepts(data) or len(data) < 8:
        raise raster.NotThisFormat(f"{name}: not an ICNS file")
    filesize = struct.unpack_from(">I", data, 4)[0]
    entries, i = {}, 8
    while i < filesize:  # the file's position is i throughout
        if i + 8 > len(data):
            raise raster.NotThisFormat(f"{name}: ICNS resource list cut short")
        kind, blocksize = struct.unpack_from(">4sI", data, i)
        if blocksize <= 0:
            raise raster.NotThisFormat(f"{name}: invalid ICNS block header")
        entries[kind] = (i + 8, blocksize - 8)
        i += blocksize
    sizes = [size for size, readers in SIZES.items() if any(kind in entries for kind, _ in readers)]
    if not sizes:
        raise raster.NotThisFormat(f"{name}: no 32bit icon resources found")
    return {"entries": entries, "sizes": sizes, "best": max(sizes)}


def _allowed(sizes: list, width: int, height: int) -> bool:
    """IcnsImageFile's size setter: a size of the file's, or one that a whole scale of one gives."""
    for w, h, scale in sizes:
        if height and (h * scale) / height == (w * scale) // width:
            return True
    return False


def decode(data: bytes, name: str = "<bytes>", native: bool = False) -> np.ndarray:
    """uint8 [H, W, 3]: `PIL.Image.open(...).convert("RGB")` of an ICNS file."""
    data = bytes(data)
    p = parse(data, name)
    best = p["best"]
    w, h = best[0] * best[2], best[1] * best[2]
    pixels = w * h
    rgba, rgb = None, None
    for kind, reader in SIZES[best]:
        if kind not in p["entries"]:
            continue
        start, length = p["entries"][kind]
        if reader == "png":
            sig = data[start : start + 12]
            if sig.startswith(png.SIGNATURE):
                rgba = start
            elif sig.startswith(JPEG2000) or sig == jpeg2000.JP2_SIGNATURE:
                # Pillow opens the entry's bytes as a JPEG 2000 file and converts it to RGBA at once
                entry = data[start : start + length]
                try:
                    rgba = (jpeg2000.decode_native if native else jpeg2000.decode_twin)(entry, name)
                except raster.NotThisFormat as e:
                    raise ValueError(f"{name}: ICNS entry {kind.decode('latin-1')}: {e}") from None
            else:
                raise ValueError(f"{name}: ICNS entry {kind.decode('latin-1')}: unsupported icon subimage format")
        elif reader == "mask":
            if len(data) - start < pixels:
                raise ValueError(f"{name}: ICNS mask {kind.decode('latin-1')} cut short (not enough image data)")
        else:
            if reader == "rle_lead":
                if data[start : start + 4] != b"\0\0\0\0":
                    raise ValueError(f"{name}: ICNS entry it32: unknown signature, expecting 0x00000000")
                start, length = start + 4, length - 4
            if length == 3 * pixels:
                if len(data) - start < length:
                    raise ValueError(f"{name}: ICNS entry {kind.decode('latin-1')} cut short (not enough image data)")
                rgb = np.frombuffer(data, np.uint8, count=length, offset=start).reshape(h, w, 3)
            else:
                planes = raster.expander("icns_rle", native)(data, start, pixels, name)
                rgb = np.frombuffer(planes, np.uint8).reshape(3, h, w).transpose(1, 2, 0)
    if rgba is not None:
        if isinstance(rgba, int):
            decoder = png.decode_native if native else png.decode_twin
            out = decoder(data[rgba:], name)
        else:
            out = rgba
        if not _allowed(p["sizes"], out.shape[1], out.shape[0]):
            raise ValueError(f"{name}: ICNS image of {out.shape[1]} x {out.shape[0]} (not one of the allowed sizes)")
        return out
    if rgb is None:
        raise ValueError(f"{name}: ICNS size {best} holds a mask and no image")
    return np.ascontiguousarray(rgb)


def decode_twin(data: bytes, name: str = "<bytes>") -> np.ndarray:
    return decode(data, name)


def decode_native(data: bytes, name: str = "<bytes>") -> np.ndarray:
    return decode(data, name, native=True)


def decoder_for(device) -> Callable[[bytes, str], np.ndarray]:
    """The decoder a run on `device` uses: the native one on a CUDA run's host, the twin on a CPU run."""
    from uniir_tpu_torch import _build

    return decode_native if _build.is_cuda(device) else decode_twin
