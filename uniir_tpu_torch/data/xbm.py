"""XBM (X11 bitmap) decoding with Pillow's pixels, without Pillow.

The JAX package reads every image with `PIL.Image.open(path).convert("RGB")`.
For an XBM file this module gives the same uint8 [H, W, 3] array as Pillow
12.1 (`XbmImagePlugin` and `XbmDecode.c`): the `#define ..._width` /
`_height` lines (and an optional hotspot) matched by Pillow's own pattern in
the first 512 bytes, then from the last `_bits[]` there, one byte for each
`x` found, read from the two characters after it (a character that is not a
hex digit counts as 0), rows of ceil(width / 8) bytes, least significant bit
first, a set bit white.

A header the pattern does not match, or a size of 0, is not an XBM file to
Image.open (it tries its next reader); too few bytes raise ValueError
naming the file.
"""

from __future__ import annotations

import re

import numpy as np

from uniir_tpu_torch.data import raster

HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    b"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    b"(?P<hotspot>"
    b"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    b"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    b")?"
    rb"[\000-\377]*_bits\[]"
)
_BYTE = re.compile(rb"x[\000-\377]{2}")
_HEX = np.zeros(256, np.uint8)
for _c in b"0123456789abcdefABCDEF":
    _HEX[_c] = int(chr(_c), 16)


def accepts(data: bytes) -> bool:
    return data.lstrip()[:7] == b"#define"


def parse(data: bytes, name: str = "<bytes>") -> tuple:
    """XbmImageFile._open: (width, height, where the bytes start); raises raster.NotThisFormat where
    Image.open tries its next reader."""
    m = HEAD.match(data[:512]) if accepts(data) else None
    if not m:
        raise raster.NotThisFormat(f"{name}: not an XBM header")
    width, height = int(m["width"]), int(m["height"])
    raster.check_size(width, height, name)
    return width, height, m.end()


def decode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """uint8 [H, W, 3]: `PIL.Image.open(...).convert("RGB")` of an XBM file."""
    data = bytes(data)
    width, height, start = parse(data, name)
    need = (width + 7) // 8 * height
    pairs = np.frombuffer(b"".join(m[0][1:] for m in _BYTE.finditer(data, start)), np.uint8)[: 2 * need]
    if len(pairs) < 2 * need:
        raise ValueError(f"{name}: XBM data cut short ({len(pairs) // 2} of {need} bytes)")
    rows = (_HEX[pairs[0::2]] << 4 | _HEX[pairs[1::2]]).reshape(height, -1)
    bits = np.unpackbits(rows, axis=1, bitorder="little")[:, :width]
    return np.repeat((bits * np.uint8(255))[:, :, None], 3, axis=2)
