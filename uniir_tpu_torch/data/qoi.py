"""QOI decoding with Pillow's pixels, without Pillow.

The JAX package reads every image with `PIL.Image.open(path).convert("RGB")`.
For a QOI file this module gives the same uint8 [H, W, 3] array as Pillow
12.1 (`QoiImagePlugin` and its Python `QoiDecoder`): the 14-byte header's
big-endian width and height, a channel count of 3 read as RGB and any other
as RGBA (alpha dropped by `convert("RGB")`), the colorspace byte ignored;
the op stream (`INDEX`, `DIFF`, `LUMA`, `RUN`, `RGB`, `RGBA`) decoded by
`raster.qoi_twin` or its native twin in `csrc/raster.cu`.

A header cut short, or a size of 0, is not a QOI file to Image.open (it
tries its next reader); a stream cut short raises ValueError naming the
file, as Pillow's load raises.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from uniir_tpu_torch.data import raster

SIGNATURE = b"qoif"


def accepts(data: bytes) -> bool:
    return data[:4] == SIGNATURE


def parse(data: bytes, name: str = "<bytes>") -> tuple:
    """QoiImageFile._open: (width, height); raises raster.NotThisFormat where Image.open tries its next reader
    (it reads the channel count too, which only decides whether the image has an alpha band)."""
    if not accepts(data) or len(data) < 13:
        raise raster.NotThisFormat(f"{name}: QOI header cut short")
    width, height = int.from_bytes(data[4:8], "big"), int.from_bytes(data[8:12], "big")
    raster.check_size(width, height, name)
    return width, height


def decode(data: bytes, name: str = "<bytes>", native: bool = False) -> np.ndarray:
    """uint8 [H, W, 3]: `PIL.Image.open(...).convert("RGB")` of a QOI file."""
    data = bytes(data)
    width, height = parse(data, name)
    px = raster.expander("qoi", native)(data, 14, width, height, 3, name)
    return np.frombuffer(px, np.uint8).reshape(height, width, 3)


def decode_twin(data: bytes, name: str = "<bytes>") -> np.ndarray:
    return decode(data, name)


def decode_native(data: bytes, name: str = "<bytes>") -> np.ndarray:
    return decode(data, name, native=True)


def decoder_for(device) -> Callable[[bytes, str], np.ndarray]:
    """The decoder a run on `device` uses: the native one on a CUDA run's host, the twin on a CPU run."""
    from uniir_tpu_torch import _build

    return decode_native if _build.is_cuda(device) else decode_twin
