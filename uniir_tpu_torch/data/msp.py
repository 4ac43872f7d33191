"""MSP (Windows Paint) decoding with Pillow's pixels, without Pillow.

The JAX package reads every image with `PIL.Image.open(path).convert("RGB")`.
For an MSP file this module gives the same uint8 [H, W, 3] array as Pillow
12.1 (`MspImagePlugin` and its Python `MspDecoder`): a 32-byte header whose
16 little-endian words XOR to 0, then for version 1 (`DanM`) raw 1-bit rows,
for version 2 (`LinS`) a map of each row's encoded length and the rows'
runs, decoded by `raster.msp_rle_twin` or its native twin.  A set bit is
white.

A header cut short, a bad checksum or a size of 0 is not an MSP file to
Image.open (it tries its next reader); data cut short or corrupt runs raise
ValueError naming the file.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from uniir_tpu_torch.data import raster


def accepts(data: bytes) -> bool:
    return data[:4] in (b"DanM", b"LinS")


def parse(data: bytes, name: str = "<bytes>") -> tuple:
    """MspImageFile._open: (width, height); raises raster.NotThisFormat where Image.open tries its next
    reader."""
    if not accepts(data) or len(data) < 32:
        raise raster.NotThisFormat(f"{name}: MSP header cut short")
    words = np.frombuffer(data[:32], "<u2")
    if np.bitwise_xor.reduce(words):
        raise raster.NotThisFormat(f"{name}: bad MSP checksum")
    width, height = int(words[2]), int(words[3])
    raster.check_size(width, height, name)
    return width, height


def decode(data: bytes, name: str = "<bytes>", native: bool = False) -> np.ndarray:
    """uint8 [H, W, 3]: `PIL.Image.open(...).convert("RGB")` of an MSP file."""
    data = bytes(data)
    width, height = parse(data, name)
    stride = (width + 7) // 8
    if data[:4] == b"DanM":
        px = data[32 : 32 + stride * height]
        if len(px) < stride * height:
            raise ValueError(f"{name}: MSP image data cut short (image file is truncated)")
    else:
        px = raster.expander("msp_rle", native)(data, width, height, name)
    bits = np.unpackbits(np.frombuffer(px, np.uint8).reshape(height, stride), axis=1)[:, :width]
    return np.repeat((bits * np.uint8(255))[:, :, None], 3, axis=2)


def decode_twin(data: bytes, name: str = "<bytes>") -> np.ndarray:
    return decode(data, name)


def decode_native(data: bytes, name: str = "<bytes>") -> np.ndarray:
    return decode(data, name, native=True)


def decoder_for(device) -> Callable[[bytes, str], np.ndarray]:
    """The decoder a run on `device` uses: the native one on a CUDA run's host, the twin on a CPU run."""
    from uniir_tpu_torch import _build

    return decode_native if _build.is_cuda(device) else decode_twin
