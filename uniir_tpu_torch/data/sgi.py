"""SGI decoding with Pillow's pixels, without Pillow.

The JAX package reads every image with `PIL.Image.open(path).convert("RGB")`.
For an SGI file this module gives the same uint8 [H, W, 3] array as Pillow
12.1 (`SgiImagePlugin`, its `SGI16Decoder` and `SgiRleDecode.c`):

  * the 512-byte header: the magic 474, the storage (0 verbatim, 1 RLE),
    1 or 2 bytes a sample, and the (dimension, channels) pairs Pillow
    reads: 1 channel (dimension 1 or 2) as L, 3 as RGB, 4 as RGBA (alpha
    dropped by `convert("RGB")`); another pair raises;
  * 2-byte samples are big-endian and keep their high byte, as Pillow's
    `;16B` raw modes do on the way to 8-bit bands;
  * verbatim: each channel a plane of rows, bottom row first;
  * RLE: the row start and length tables, each row expanded by
    `raster.sgi_rle_twin` or its native twin; a chunk the decoder stops at
    leaves the rows after it black, without an error, as in Pillow.

A header cut short, or a size of 0, is not an SGI file to Image.open (it
tries its next reader); pixels cut short, offsets past the data and any
other storage raise ValueError naming the file.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np

from uniir_tpu_torch.data import raster

# (bytes a sample, dimension, channels) -> bands (SgiImagePlugin.MODES)
MODES = {(1, 1, 1): 1, (1, 2, 1): 1, (2, 1, 1): 1, (2, 2, 1): 1, (1, 3, 3): 3, (2, 3, 3): 3, (1, 3, 4): 4,
         (2, 3, 4): 4}


class Sgi(NamedTuple):
    width: int
    height: int
    bands: int
    bpc: int
    compression: int


def accepts(data: bytes) -> bool:
    return data[:2] == b"\x01\xda"


def parse(data: bytes, name: str = "<bytes>") -> Sgi:
    """SgiImageFile._open: raises raster.NotThisFormat where Image.open tries its next reader."""
    if not accepts(data) or len(data) < 12:
        raise raster.NotThisFormat(f"{name}: SGI header cut short")
    compression, bpc = data[2], data[3]
    dimension, width, height, channels = (int.from_bytes(data[k : k + 2], "big") for k in (4, 6, 8, 10))
    if (bpc, dimension, channels) not in MODES:
        raise ValueError(f"{name}: unsupported SGI image mode ({bpc} bytes a sample, dimension {dimension}, "
                         f"{channels} channels)")
    raster.check_size(width, height, name)
    return Sgi(width, height, MODES[(bpc, dimension, channels)], bpc, compression)


def decode(data: bytes, name: str = "<bytes>", native: bool = False) -> np.ndarray:
    """uint8 [H, W, 3]: `PIL.Image.open(...).convert("RGB")` of an SGI file."""
    data = bytes(data)
    s = parse(data, name)
    w, h, bands, bpc = s.width, s.height, s.bands, s.bpc
    if s.compression == 0:
        page = w * h * bpc
        if len(data) < 512 + bands * page:
            raise ValueError(f"{name}: SGI image data cut short (image file is truncated)")
        planes = np.frombuffer(data, np.uint8, count=bands * page, offset=512).reshape(bands, h, w, bpc)[..., 0]
        px = planes.transpose(1, 2, 0)
    elif s.compression == 1:
        rows = raster.expander("sgi_rle", native)(data, w, h, bands, bpc, name)
        px = np.frombuffer(rows, np.uint8).reshape(h, w, bands, bpc)[..., 0]
    else:
        raise ValueError(f"{name}: SGI storage {s.compression} (cannot load this image)")
    px = px[::-1]
    return np.ascontiguousarray(np.repeat(px, 3, axis=2) if bands == 1 else px[:, :, :3])


def decode_twin(data: bytes, name: str = "<bytes>") -> np.ndarray:
    return decode(data, name)


def decode_native(data: bytes, name: str = "<bytes>") -> np.ndarray:
    return decode(data, name, native=True)


def decoder_for(device) -> Callable[[bytes, str], np.ndarray]:
    """The decoder a run on `device` uses: the native one on a CUDA run's host, the twin on a CPU run."""
    from uniir_tpu_torch import _build

    return decode_native if _build.is_cuda(device) else decode_twin
