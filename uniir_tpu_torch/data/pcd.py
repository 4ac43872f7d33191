"""Kodak PhotoCD (PCD) decoding with Pillow's pixels, without Pillow.

The JAX package reads every image with `PIL.Image.open(path).convert("RGB")`.
For a PhotoCD file this module gives the same uint8 [H, W, 3] array as
Pillow 12.1 (`PcdImagePlugin`, its `pcd` decoder): "PCD_" at byte 2048,
the orientation in the low two bits of byte 2048 + 1538, and the 768 x 512
base image from byte 96 * 2048 on, in chunks of 3 * 768 bytes: two rows of
luma, then 384 Cb and 384 Cr samples that both rows share, a sample for
each two columns.  Each pixel goes through Pillow's Photo YCC unpacker:

    L  = 1.3584 * Y,  C1 = 2.2179 * (Cb - 156),  C2 = 1.8215 * (Cr - 137)
    R  = L + C2,  G = L - 0.194 * C1 - 0.509 * C2,  B = L + C1

with each of the five terms a table of (int)(v + 0.5) over the byte's 256
values (C's cast: toward zero after the half is added) and each sum
clipped to 0..255.  Found by probes: every (Y, Cb, Cr) triple through
Pillow gives these tables' sums.  Orientation 1 and 3 rotate the image by
90 and 270 degrees (Image.rotate with expand, a transposition).

A file too short to hold the orientation byte is not a PCD file to
Image.open (it tries its next reader); one cut short of the base image
raises ValueError naming the file, as ImageFile.load does.
"""

from __future__ import annotations

import numpy as np

from uniir_tpu_torch.data import raster

SIGNATURE = b"PCD_"
WIDTH, HEIGHT = 768, 512
OFFSET = 96 * 2048
CHUNK = 3 * WIDTH


def _table(scale: float, centre: int) -> np.ndarray:
    return np.trunc((np.arange(256) - centre) * scale + 0.5).astype(np.int32)


_L = _table(1.3584, 0)
_CB = _table(2.2179, 156)
_CR = _table(1.8215, 137)
_GB = _table(-0.194 * 2.2179, 156)
_GR = _table(-0.509 * 1.8215, 137)


def accepts(data: bytes) -> bool:
    return data[2048:2052] == SIGNATURE


def parse(data: bytes, name: str = "<bytes>") -> dict:
    """PcdImageFile._open: the orientation and the size; raises raster.NotThisFormat where Image.open tries
    its next reader."""
    if not accepts(data):
        raise raster.NotThisFormat(f"{name}: not a PCD file")
    if len(data) < 2048 + 1539:
        raise raster.NotThisFormat(f"{name}: PCD header cut short")
    orientation = data[2048 + 1538] & 3
    return {"orientation": orientation, "size": (HEIGHT, WIDTH) if orientation in (1, 3) else (WIDTH, HEIGHT)}


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """uint8 [..., 3]: Pillow's Photo YCC unpacker of uint8 samples of one shape."""
    luma = _L[y]
    rgb = np.stack([luma + _CR[cr], luma + _GB[cb] + _GR[cr], luma + _CB[cb]], axis=-1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def decode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """uint8 [H, W, 3]: `PIL.Image.open(...).convert("RGB")` of a PhotoCD file."""
    data = bytes(data)
    p = parse(data, name)
    need = OFFSET + HEIGHT // 2 * CHUNK
    if len(data) < need:
        raise ValueError(f"{name}: PCD base image cut short ({len(data)} of {need} bytes; image file is truncated)")
    chunks = np.frombuffer(data, np.uint8, HEIGHT // 2 * CHUNK, OFFSET).reshape(HEIGHT // 2, CHUNK)
    y = chunks[:, : 2 * WIDTH].reshape(HEIGHT, WIDTH)
    cb = np.repeat(np.repeat(chunks[:, 2 * WIDTH : 2 * WIDTH + WIDTH // 2], 2, axis=1), 2, axis=0)
    cr = np.repeat(np.repeat(chunks[:, 2 * WIDTH + WIDTH // 2 :], 2, axis=1), 2, axis=0)
    rgb = ycc_to_rgb(y, cb, cr)
    if p["orientation"] in (1, 3):
        rgb = np.ascontiguousarray(np.rot90(rgb, 1 if p["orientation"] == 1 else -1))
    return rgb
