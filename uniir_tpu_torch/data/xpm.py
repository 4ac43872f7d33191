"""XPM (X11 pixmap) decoding with Pillow's pixels, without Pillow.

The JAX package reads every image with `PIL.Image.open(path).convert("RGB")`.
For an XPM file this module gives the same uint8 [H, W, 3] array as Pillow
12.1 (`XpmImagePlugin` and its Python `XpmDecoder`), read line by line as
Pillow reads it:

  * the first line that starts with `"w h colours chars-a-pixel` (Pillow's
    pattern) after the `/* XPM */` signature;
  * one colour line each: its key (the characters a pixel), then the value
    of its first `c` key, `#rrggbb` (read as one hex number, as Pillow
    reads it) or `None` (transparent: not in the palette); another value,
    or no `c` key, raises;
  * up to 256 colours the image is colour-mapped: each pixel's key is its
    entry's place among the colours (a repeated key keeps its first place
    and its last value); past 256 each pixel is its colour's value;
  * the pixel lines: what lies between each line's first and last `"`,
    cut into keys; a `/* pixels */` line skipped once; lines read until
    the image is full.  A key that is no colour's raises, as do too few.

A header Pillow cannot find is not an XPM file to Image.open (it tries its
next reader); anything else Pillow refuses raises ValueError naming the
file.
"""

from __future__ import annotations

import re

import numpy as np

from uniir_tpu_torch.data import raster

SIGNATURE = b"/* XPM */"
HEAD = re.compile(b'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')


def accepts(data: bytes) -> bool:
    return data[:9] == SIGNATURE


class _Lines:
    """A binary file's `readline`: up to and with the next b"\\n", b"" at the end."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.pos = data, pos

    def readline(self) -> bytes:
        end = self.data.find(b"\n", self.pos)
        end = len(self.data) if end < 0 else end + 1
        line, self.pos = self.data[self.pos : end], end
        return line


def parse(data: bytes, name: str = "<bytes>") -> tuple:
    """XpmImageFile._open: (width, height, bpp, palette {key: rgb bytes}, pixel lines); raises
    raster.NotThisFormat where Image.open tries its next reader."""
    if not accepts(data):
        raise raster.NotThisFormat(f"{name}: not an XPM file")
    lines = _Lines(data, 9)
    while True:
        line = lines.readline()
        if not line:
            raise raster.NotThisFormat(f"{name}: broken XPM file (no header)")
        m = HEAD.match(line)
        if m:
            break
    try:
        width, height, colours, bpp = (int(g) for g in m.groups())
    except ValueError:
        raise ValueError(f"{name}: XPM header {line[:40]!r} has an empty number") from None
    palette = {}
    for _ in range(colours):
        line = lines.readline().rstrip()
        key, fields = line[1 : bpp + 1], line[bpp + 1 : -2].split()
        for i in range(0, len(fields), 2):
            if fields[i] == b"c":
                if i + 1 >= len(fields):
                    raise raster.NotThisFormat(f"{name}: XPM colour key without a value")
                rgb = fields[i + 1]
                if rgb.startswith(b"#"):
                    try:
                        v = int(rgb[1:], 16)
                    except ValueError:
                        raise ValueError(f"{name}: XPM colour {rgb!r} (cannot read this XPM file)") from None
                    palette[key] = bytes(((v >> 16) & 255, (v >> 8) & 255, v & 255))
                elif rgb != b"None":
                    raise ValueError(f"{name}: XPM colour {rgb!r} (cannot read this XPM file)")
                break
        else:
            raise ValueError(f"{name}: XPM colour line without a c key (cannot read this XPM file)")
    raster.check_size(width, height, name)
    return width, height, bpp, palette, colours > 256, lines


def decode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """uint8 [H, W, 3]: `PIL.Image.open(...).convert("RGB")` of an XPM file."""
    data = bytes(data)
    width, height, bpp, palette, direct, lines = parse(data, name)
    index = {key: i for i, key in enumerate(palette)}  # a colour's place among the colours
    need = width * height
    out = []
    header_seen = False
    while len(out) < need:
        line = lines.readline()
        if not line:
            break
        if line.rstrip() == b"/* pixels */" and not header_seen:
            header_seen = True
            continue
        line = b'"'.join(line.split(b'"')[1:-1])
        if line and bpp == 0:
            raise ValueError(f"{name}: XPM of 0 characters a pixel")
        keys = [line[i : i + bpp] for i in range(0, len(line), bpp)] if line else []
        table = palette if direct else index
        missing = next((k for k in keys if k not in table), None)
        if missing is not None:
            raise ValueError(f"{name}: XPM pixel key {missing!r} is no colour's")
        out += [table[k] for k in keys]
    if len(out) < need:
        raise ValueError(f"{name}: not enough XPM image data ({len(out)} of {need} pixels)")
    if direct:
        return np.frombuffer(b"".join(out[:need]), np.uint8).reshape(height, width, 3).copy()
    colours = np.zeros((256, 3), np.uint8)
    if palette:
        colours[: len(palette)] = np.frombuffer(b"".join(palette.values()), np.uint8).reshape(-1, 3)
    return colours[np.array(out[:need], np.int64).reshape(height, width)]
