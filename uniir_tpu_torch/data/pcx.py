"""PCX and DCX decoding with Pillow's pixels, without Pillow.

The JAX package reads every image with `PIL.Image.open(path).convert("RGB")`.
For a PCX file, and for a DCX file (a directory of PCX pages, of which
Image.open reads the first), this module gives the same uint8 [H, W, 3]
array as Pillow 12.1 (`PcxImagePlugin`, `DcxImagePlugin`, `PcxDecode.c`):

  * the 128-byte header: version 0, 2, 3 or 5, the window's corners, the
    bits a plane and the planes; 1 bit x 1 plane is black and white, 1 bit
    x 2 or 4 planes indexes the header's 16-entry palette (an index past
    it black), and at version 5, 8 bits x 1 plane is grey unless the file
    ends in a 769-byte block that starts with 12 and is not the grey ramp
    (then it is that palette), and 8 bits x 3 planes is RGB; any other
    form raises;
  * the line length: the width's bytes, made even where the header's
    length differs from it (Pillow does not trust the header's), times
    the planes; an 8-bit file shorter than the 769-byte block raises (its
    `_open` seeks before the file's start);
  * RLE by `raster.pcx_rle_twin` or its native twin, with the planes moved
    together as `PcxDecode.c` moves them, and read as Pillow's unpackers
    read them (planes of ceil(width / 8) bytes for the bit planes, of
    `width` bytes for RGB): where the decoder does not move a padded line's
    planes (RGB of width 1 or 3), the unpacker reads the padding, as in
    Pillow.

A header cut short, a window of no pixels, or a DCX directory cut short or
empty, is not such a file to Image.open (it tries its next reader); data cut
short and runs past a line raise ValueError naming the file.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np

from uniir_tpu_torch.data import raster

DCX_SIGNATURE = (987654321).to_bytes(4, "little")
RAW_BITS = {"1": 1, "P;2L": 2, "P;4L": 4, "L": 8, "P": 8, "RGB;L": 24}


class Pcx(NamedTuple):
    width: int
    height: int
    rawmode: str
    row_bytes: int  # planes * the line length
    offset: int
    palette: Optional[np.ndarray]  # [n, 3]


def accepts(data: bytes) -> bool:
    return len(data) > 1 and data[0] == 10 and data[1] in (0, 2, 3, 5)


def dcx_accepts(data: bytes) -> bool:
    return data[:4] == DCX_SIGNATURE


def parse(data: bytes, name: str = "<bytes>", at: int = 0) -> Pcx:
    """PcxImageFile._open of the PCX header at `at`: raises raster.NotThisFormat where Image.open tries its
    next reader."""
    s = data[at : at + 68]
    if not accepts(s) or len(s) < 68:
        raise raster.NotThisFormat(f"{name}: not a PCX header")

    def u16(k: int) -> int:
        return s[k] | s[k + 1] << 8

    x0, y0, x1, y1 = u16(4), u16(6), u16(8) + 1, u16(10) + 1
    if x1 <= x0 or y1 <= y0:
        raise raster.NotThisFormat(f"{name}: bad PCX image size")
    version, bits, planes, given_stride = s[1], s[3], s[65], u16(66)
    palette = None
    if bits == 1 and planes == 1:
        rawmode = "1"
    elif bits == 1 and planes in (2, 4):
        rawmode, palette = f"P;{planes}L", np.frombuffer(s[16:64], np.uint8).reshape(16, 3)
    elif version == 5 and bits == 8 and planes == 1:
        rawmode = "L"
        if len(data) < 769:
            raise ValueError(f"{name}: PCX file of {len(data)} bytes (its palette seek is before the file's start)")
        tail = data[-769:]
        if tail[0] == 12 and tail[1:] != bytes(np.repeat(np.arange(256, dtype=np.uint8), 3)):
            rawmode, palette = "P", np.frombuffer(tail[1:], np.uint8).reshape(256, 3)
    elif version == 5 and bits == 8 and planes == 3:
        rawmode = "RGB;L"
    else:
        raise ValueError(f"{name}: unknown PCX mode ({bits} bits x {planes} planes, version {version})")
    width, height = x1 - x0, y1 - y0
    raster.check_size(width, height, name)
    stride = (width * bits + 7) // 8
    if given_stride != stride:
        stride += stride % 2
    return Pcx(width, height, rawmode, planes * stride, at + 128, palette)


def dcx_first_page(data: bytes, name: str = "<bytes>") -> int:
    """DcxImageFile._open: the first page's offset; raises raster.NotThisFormat where Image.open tries its
    next reader."""
    if not dcx_accepts(data):
        raise raster.NotThisFormat(f"{name}: not a DCX file")
    first = data[4:8]
    if len(first) < 4:
        raise raster.NotThisFormat(f"{name}: DCX directory cut short")
    offset = int.from_bytes(first, "little")
    if not offset:
        raise raster.NotThisFormat(f"{name}: DCX directory without a page")
    for k in range(1, 1024):  # Pillow reads the whole directory before the first page
        entry = data[4 + 4 * k : 8 + 4 * k]
        if len(entry) < 4:
            raise raster.NotThisFormat(f"{name}: DCX directory cut short")
        if entry == bytes(4):
            break
    return offset


def _pixels(data: bytes, p: Pcx, name: str, native: bool) -> np.ndarray:
    rows = raster.expander("pcx_rle", native)(data, p.offset, p.width, RAW_BITS[p.rawmode], p.row_bytes, p.height,
                                              name)
    line = np.frombuffer(rows, np.uint8).reshape(p.height, p.row_bytes)
    w = p.width
    if p.rawmode in ("1", "P;2L", "P;4L"):
        s = (w + 7) // 8
        planes = 1 if p.rawmode == "1" else int(p.rawmode[2])
        bits = sum(np.unpackbits(line[:, k * s : (k + 1) * s], axis=1)[:, :w].astype(np.uint8) << k
                   for k in range(planes))
        if p.rawmode == "1":
            return np.repeat((bits * 255).astype(np.uint8)[:, :, None], 3, axis=2)
        idx = bits
    elif p.rawmode == "RGB;L":
        return np.ascontiguousarray(line[:, : 3 * w].reshape(p.height, 3, w).transpose(0, 2, 1))
    else:
        idx = line[:, :w]
    if p.palette is None:
        return np.repeat(idx[:, :, None], 3, axis=2)
    table = np.zeros((256, 3), np.uint8)
    table[: len(p.palette)] = p.palette
    return table[idx]


def decode(data: bytes, name: str = "<bytes>", native: bool = False) -> np.ndarray:
    """uint8 [H, W, 3]: `PIL.Image.open(...).convert("RGB")` of a PCX file."""
    data = bytes(data)
    return _pixels(data, parse(data, name), name, native)


def decode_dcx(data: bytes, name: str = "<bytes>", native: bool = False) -> np.ndarray:
    """uint8 [H, W, 3]: `PIL.Image.open(...).convert("RGB")` of a DCX file (its first page)."""
    data = bytes(data)
    return _pixels(data, parse(data, name, dcx_first_page(data, name)), name, native)


def decode_twin(data: bytes, name: str = "<bytes>") -> np.ndarray:
    return decode(data, name)


def decode_native(data: bytes, name: str = "<bytes>") -> np.ndarray:
    return decode(data, name, native=True)


def decoder_for(device) -> Callable[[bytes, str], np.ndarray]:
    """The decoder a run on `device` uses: the native one on a CUDA run's host, the twin on a CPU run."""
    from uniir_tpu_torch import _build

    return decode_native if _build.is_cuda(device) else decode_twin


def dcx_decoder_for(device) -> Callable[[bytes, str], np.ndarray]:
    """`decoder_for` of a DCX file."""
    from uniir_tpu_torch import _build

    native = _build.is_cuda(device)
    return lambda data, name="<bytes>": decode_dcx(data, name, native)
