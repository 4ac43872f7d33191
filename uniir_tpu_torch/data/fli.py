"""FLI / FLC (Autodesk animation) decoding with Pillow's pixels, without Pillow.

The JAX package reads every image with `PIL.Image.open(path).convert("RGB")`
(the image pass through RGBA first, the same pixels: no transparency).  For
an FLI or FLC file this module gives the same uint8 [H, W, 3] array as
Pillow 12.1 (`FliImagePlugin`, `FliDecode.c`), the first frame only:

  * the 128-byte header: magic 0xAF11 or 0xAF12, flags 0 or 3, the
    reserved bytes zero, at least one frame, the width and height;
  * the palette: a grey ramp, unless the chunk after the header (after a
    0xF100 prefix chunk, skipped by its size) is a frame (0xF1FA) whose
    subchunks, walked by their sizes, hold a COLOR_256 (4) or COLOR_64 (11)
    chunk before one of size 0: its packets (skip, count, count * 3 bytes;
    a count of 0 is 256) replace entries, COLOR_64's shifted left by 2 and
    kept to 8 bits;
  * the pixels: the frame at byte 128 (whatever the prefix chunk: Pillow
    seeks there for frame 0) through `raster.fli_twin` or its native entry
    in csrc/raster.cu, which read it as ImageFile.load feeds FliDecode.c.

A header Pillow does not take, a palette or frame header cut short, or a
file that ends at byte 128 ("missing frame size"), is not an FLI file to
Image.open (it tries its next reader); frame data cut short, a chunk
Pillow's decoder refuses and packets past their line or the frame's bytes
raise ValueError naming the file.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from uniir_tpu_torch.data import raster

MAGICS = (0xAF11, 0xAF12)


def _u16(data: bytes, at: int, name: str) -> int:
    if at < 0 or len(data) < at + 2:
        raise raster.NotThisFormat(f"{name}: FLI header cut short")
    return data[at] | data[at + 1] << 8


def _u32(data: bytes, at: int, name: str) -> int:
    if at < 0 or len(data) < at + 4:
        raise raster.NotThisFormat(f"{name}: FLI header cut short")
    return int.from_bytes(data[at : at + 4], "little")


def accepts(data: bytes) -> bool:
    return len(data) >= 16 and data[4] | data[5] << 8 in MAGICS and data[14:16] in (b"\0\0", b"\3\0")


def _palette(data: bytes, pos: int, shift: int, name: str) -> np.ndarray:
    """FliImageFile._palette from `pos`: the grey ramp with the chunk's packets written over it."""
    palette = np.repeat(np.arange(256, dtype=np.int64)[:, None], 3, axis=1)
    i = 0
    packets, pos = _u16(data, pos, name), pos + 2
    for _ in range(packets):
        s = data[pos : pos + 2]
        pos += len(s)
        if len(s) < 2:
            raise raster.NotThisFormat(f"{name}: FLI palette packet cut short")
        i += s[0]
        s = data[pos : pos + 3 * (s[1] or 256)]
        pos += len(s)
        for k in range(0, len(s), 3):
            if k + 3 > len(s) or i >= 256:
                raise raster.NotThisFormat(f"{name}: FLI palette entries cut short or past 256")
            palette[i] = [s[k] << shift, s[k + 1] << shift, s[k + 2] << shift]
            i += 1
    return (palette & 0xFF).astype(np.uint8)


def parse(data: bytes, name: str = "<bytes>") -> dict:
    """FliImageFile._open and its seek to frame 0: size, palette and the first frame's offset and size;
    raises raster.NotThisFormat where Image.open tries its next reader."""
    head = data[:128]
    if not (accepts(head) and head[20:22] == b"\0\0" and head[42:80] == bytes(38) and head[88:] == bytes(40)):
        raise raster.NotThisFormat(f"{name}: not an FLI / FLC file")
    frames, width, height = _u16(head, 6, name), _u16(head, 8, name), _u16(head, 10, name)
    palette = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
    pos = 128
    if _u16(data[pos : pos + 16], 4, name) == 0xF100:  # a prefix chunk
        pos = 128 + _u32(data, pos, name)
    if _u16(data[pos : pos + 16], 4, name) == 0xF1FA:
        subchunks, pos, size = _u16(data[pos : pos + 16], 6, name), pos + 16, None
        for _ in range(subchunks):
            if size is not None:
                pos += size - 6
            s = data[pos : pos + 6]
            pos += len(s)
            kind = _u16(s, 4, name)
            if kind in (4, 11):
                palette = _palette(data, pos, 2 if kind == 11 else 0, name)
                break
            size = _u32(s, 0, name)
            if not size:
                break
    if frames == 0:
        raise raster.NotThisFormat(f"{name}: FLI file of no frames (attempt to seek outside sequence)")
    s = data[128:132]
    if not s:
        raise raster.NotThisFormat(f"{name}: FLI file without a frame (missing frame size)")
    block = _u32(s, 0, name)
    raster.check_size(width, height, name)
    return {"size": (width, height), "palette": palette, "offset": 128, "block": block}


def decode(data: bytes, name: str = "<bytes>", native: bool = False) -> np.ndarray:
    """uint8 [H, W, 3]: `PIL.Image.open(path).convert("RGB")` of an FLI / FLC file's first frame."""
    data = bytes(data)
    p = parse(data, name)
    (width, height) = p["size"]
    indices = raster.expander("fli", native)(data, p["offset"], p["block"], width, height, name)
    return np.take(p["palette"], np.frombuffer(indices, np.uint8).reshape(height, width), axis=0)


def decode_twin(data: bytes, name: str = "<bytes>") -> np.ndarray:
    return decode(data, name)


def decode_native(data: bytes, name: str = "<bytes>") -> np.ndarray:
    return decode(data, name, native=True)


def decoder_for(device) -> Callable[[bytes, str], np.ndarray]:
    """The decoder a run on `device` uses: the native one on a CUDA run's host, the twin on a CPU run."""
    from uniir_tpu_torch import _build

    return decode_native if _build.is_cuda(device) else decode_twin
