"""FTEX (IW2:EOC texture) decoding with Pillow's pixels, without Pillow.

The JAX package reads every image with `PIL.Image.open(path).convert("RGB")`.
For an FTEX file this module gives the same uint8 [H, W, 3] array as Pillow
12.1 (`FtexImagePlugin`): "FTEX", a version, the width and height, the
mipmap and format counts (one format only), the format and where its first
mipmap lies; there a length and the mipmap's bytes (to the file's end for a
negative length).  Format 0 is BC1 through Pillow's `bcn` decoder (mode
RGBA, alpha dropped): `data.dds`'s block decoder, its numpy twin on a CPU
run and `csrc/bcn.cu` on a CUDA run's host; format 1 is packed RGB.

A header cut short, or a size of 0, is not an FTEX file to Image.open (it
tries its next reader); a format count other than 1, a negative offset,
another format or mipmap data cut short raise ValueError naming the file.
"""

from __future__ import annotations

import struct
from typing import Callable

import numpy as np

from uniir_tpu_torch.data import dds, raster

SIGNATURE = b"FTEX"


def accepts(data: bytes) -> bool:
    return data[:4] == SIGNATURE


def parse(data: bytes, name: str = "<bytes>") -> dict:
    """FtexImageFile._open: size, format and the mipmap's bytes; raises raster.NotThisFormat where Image.open
    tries its next reader."""
    if not accepts(data) or len(data) < 24:
        raise raster.NotThisFormat(f"{name}: FTEX header cut short")
    width, height, _, formats = struct.unpack_from("<4i", data, 8)
    if formats != 1:  # Pillow's assert: Image.open raises it
        raise ValueError(f"{name}: FTEX file of {formats} formats (one only)")
    if len(data) < 32:
        raise raster.NotThisFormat(f"{name}: FTEX format entry cut short")
    fmt, where = struct.unpack_from("<2i", data, 24)
    if where < 0:
        raise ValueError(f"{name}: FTEX mipmap at offset {where}")
    if len(data) < where + 4:
        raise raster.NotThisFormat(f"{name}: FTEX mipmap length past the file's end")
    length = struct.unpack_from("<i", data, where)[0]
    mip = data[where + 4:] if length < 0 else data[where + 4: where + 4 + length]
    if fmt not in (0, 1):
        raise ValueError(f"{name}: invalid FTEX texture compression format {fmt}")
    raster.check_size(width, height, name)
    return {"size": (width, height), "format": fmt, "mip": mip}


def decode(data: bytes, name: str = "<bytes>", native: bool = False) -> np.ndarray:
    """uint8 [H, W, 3]: `PIL.Image.open(...).convert("RGB")` of an FTEX file."""
    p = parse(bytes(data), name)
    (width, height), mip = p["size"], p["mip"]
    if p["format"] == 0:
        return (dds.NATIVES if native else dds.TWINS)["bc1"](mip, 0, width, height, 0, name)
    return raster.raw_rows(mip, 0, height, 3 * width, name).reshape(height, width, 3)


def decode_twin(data: bytes, name: str = "<bytes>") -> np.ndarray:
    return decode(data, name)


def decode_native(data: bytes, name: str = "<bytes>") -> np.ndarray:
    return decode(data, name, native=True)


def decoder_for(device) -> Callable[[bytes, str], np.ndarray]:
    """The decoder a run on `device` uses: the native one on a CUDA run's host, the twin on a CPU run."""
    from uniir_tpu_torch import _build

    return decode_native if _build.is_cuda(device) else decode_twin
