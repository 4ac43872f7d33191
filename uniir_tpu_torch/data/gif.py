"""GIF decoding with Pillow's pixels, without Pillow.

The JAX package reads every image with `PIL.Image.open(path).convert("RGB")`.
For a GIF file that is the first frame, and this module gives the same uint8
[H, W, 3] array, bit for bit, as Pillow 12.1 gives it (`GifImagePlugin` and
its C decoder, `GifDecode.c`):

  * the image is the logical screen, grown to hold the first frame where the
    frame reaches past it; outside the frame it holds the transparency index
    of the frame's graphic control extension, or index 0 without one (not
    the background index);
  * the frame's local colour table, else the global one, as read (2^n
    entries); an index past its end is black.  A table that is the grey ramp
    (entry i = (i, i, i) for every entry) makes Pillow open the image as
    mode `L`, where a pixel is its index: an index past such a table is
    grey, not black.  Without any table the image is `L` too;
  * `convert("RGB")` keeps the palette colour of the transparent index;
  * four interlace passes (rows 0, 4, 2, 1 each eighth, fourth, second);
  * LZW as `GifDecode.c` reads it: the minimum code size byte as it is (0 to
    12; a size of 1 starts at 2-bit codes whose width never grows, since the
    first free entry, 4, is past the first code mask, 3), the width grown
    after the entry 2^width - 1 is added, up to 12 bits, no entry added past
    4096 (a "deferred clear": the codes go on from the full table), a first
    code after a clear above the clear code or a later code past the next
    free entry refused as broken, a literal above 255 kept modulo 256;
  * the frame ends when its last row is written: codes after that, and
    bytes after the trailer, are not read; the data is read as length-
    prefixed blocks from the minimum code size byte on, past a block
    terminator too, so a stream that ends before the frame is full raises;
  * an end-of-information code before the frame is full raises as
    truncated, as Pillow does, unless Pillow's reader had 64 KiB chunks of
    the file left to read when the decoder met it (it then reads on and the
    decoder goes on past the code).

Anything Pillow refuses -- a bad signature, a header, descriptor or
extension cut short, no image before the trailer, a code size above 12, a
broken or truncated stream -- raises ValueError naming the file.

Two decoders compute that function: `decode_twin`, plain Python for the
LZW codes and numpy for the rest, and `decode_native`, which parses the
blocks the same way and runs the code loop and the palette lookup in host
C++ (`csrc/gif.cu`, built by `_build` like the kernels and called through
ctypes, which releases the GIL).  `decoder_for(device)` picks one by the
run's device, as `data.png` does.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Callable, NamedTuple

import numpy as np

SIGNATURES = (b"GIF87a", b"GIF89a")
CHUNK = 65536  # ImageFile.load's read size: the bytes the decoder is given at a time
MAX_BITS = 12
MAX_PIXELS = 2 * (1024 * 1024 * 1024 // 4 // 3)  # Image.open's decompression bomb limit


class Gif(NamedTuple):
    """The first frame: canvas and frame geometry, the LZW stream's offset
    and minimum code size, the colour lookup (768 RGB bytes, zeros past the
    table; None: grey, a pixel is its index) and the canvas fill index."""

    width: int
    height: int
    x0: int
    y0: int
    frame_width: int
    frame_height: int
    interlace: bool
    bits: int
    offset: int
    palette: bytes
    fill: int
    comment: bytes = b""  # the comment extensions before the image, joined by newlines (Pillow's info)


def _palette_needed(p: bytes, name: str) -> bool:
    """GifImagePlugin._is_palette_needed: False for the grey ramp."""
    if len(p) % 3:
        raise ValueError(f"{name}: truncated GIF colour table")
    return any(not (i // 3 == p[i] == p[i + 1] == p[i + 2]) for i in range(0, len(p), 3))


def parse(data: bytes, name: str = "<bytes>") -> Gif:
    """The first frame of a GIF file as Pillow's `_open` / `_seek(0)` read
    it; ValueError where Pillow refuses the file."""
    if data[:6] not in SIGNATURES or len(data) < 13:
        raise ValueError(f"{name}: not a GIF file (no GIF87a / GIF89a header)")
    width, height, flags = data[6] | data[7] << 8, data[8] | data[9] << 8, data[10]
    pos = 13
    palette = None  # the global table if it is not the grey ramp
    if flags & 128:
        p = data[pos : pos + (3 << ((flags & 7) + 1))]
        pos += len(p)
        if _palette_needed(p, name):
            palette = p

    def read(k: int) -> bytes:
        nonlocal pos
        out = data[pos : pos + k]
        pos += len(out)
        return out

    def sub_block():
        s = read(1)
        return read(s[0]) if s and s[0] else None

    s = read(1)
    if not s or s == b";":
        raise ValueError(f"{name}: GIF file without an image")
    transparency, comment = None, None
    while True:
        if not s:
            s = read(1)
        if not s or s == b";":
            raise ValueError(f"{name}: GIF file without an image (image not found in GIF frame)")
        if s == b"!":
            label = read(1)
            block = sub_block()
            if not label:
                raise ValueError(f"{name}: truncated GIF extension")
            if label[0] == 249 and block is not None:
                if len(block) < 3 or (block[0] & 1 and len(block) < 4):
                    raise ValueError(f"{name}: truncated GIF graphic control extension")
                if block[0] & 1:
                    transparency = block[3]
            elif label[0] == 254:
                text = b""
                while block:
                    text += block
                    block = sub_block()
                comment = text if comment is None else comment + b"\n" + text
                s = b""
                continue
            elif label[0] == 255 and block is not None and block.startswith(b"NETSCAPE2.0"):
                sub_block()
            while sub_block():
                pass
        elif s == b",":
            desc = read(9)
            if len(desc) < 9:
                raise ValueError(f"{name}: truncated GIF image descriptor")
            x0, y0, fw, fh = (desc[k] | desc[k + 1] << 8 for k in (0, 2, 4, 6))
            frame_flags = desc[8]
            if frame_flags & 128:
                p = read(3 << ((frame_flags & 7) + 1))
                palette = p if _palette_needed(p, name) else None
            code_size = read(1)
            if not code_size:
                raise ValueError(f"{name}: truncated GIF image descriptor")
            break
        s = b""
    if code_size[0] > MAX_BITS:
        raise ValueError(f"{name}: LZW minimum code size {code_size[0]} (codec configuration error)")
    width, height = max(width, x0 + fw), max(height, y0 + fh)
    if not (width and height and fw and fh) or width * height > MAX_PIXELS:
        raise ValueError(f"{name}: GIF image of size {width} x {height}, frame {fw} x {fh}")
    lookup = palette[:768].ljust(768, b"\x00") if palette is not None else None
    return Gif(width, height, x0, y0, fw, fh, bool(frame_flags & 64), code_size[0], pos, lookup,
               transparency if transparency is not None else 0, comment or b"")


def row_order(height: int, interlace: bool) -> list:
    """The frame's rows in the order the stream fills them (NEWLINE of GifDecode.c)."""
    if not interlace:
        return list(range(height))
    return [r for first, step in ((0, 8), (4, 8), (2, 4), (1, 2)) for r in range(first, height, step)]


def _lzw(data: bytes, gif: Gif, name: str) -> bytes:
    """The frame's fw * fh indices, in stream order: GifDecode.c's code loop."""
    need = gif.frame_width * gif.frame_height
    clear, pos, n = 1 << gif.bits, gif.offset, len(data)
    end = clear + 1
    out = bytearray()
    acc = nbits = 0
    block_left, block_end = 0, pos
    table: list = []
    state = 1  # 1: a clear is due, 2: the first code after it, 3: the rest
    width = mask = next_code = last = 0
    while True:
        if state == 1:
            table = [bytes([i & 255]) for i in range(clear)] + [b"", b""]
            next_code, width = clear + 2, gif.bits + 1
            mask, state = (1 << width) - 1, 2
        while nbits < width:
            if block_left:
                acc |= data[pos] << nbits
                nbits += 8
                pos += 1
                block_left -= 1
            else:  # the next block, whole, or the stream is cut short
                if pos >= n or pos + 1 + data[pos] > n:
                    raise ValueError(f"{name}: truncated GIF image data (image file is truncated)")
                block_left, pos = data[pos], pos + 1
                block_end = pos + block_left
        c = acc & mask
        acc >>= width
        nbits -= width
        if c == clear:
            if state != 2:
                state = 1
            continue
        if c == end:
            chunks = -(-(block_end - gif.offset) // CHUNK)
            if gif.offset + chunks * CHUNK >= n:
                raise ValueError(f"{name}: truncated GIF image data (end of information after "
                                 f"{len(out)} of {need} pixels)")
            continue
        if state == 2:
            if c > clear:
                raise ValueError(f"{name}: broken GIF data stream (first code {c} after a clear code)")
            string, state = table[c], 3
        else:
            if c > next_code:
                raise ValueError(f"{name}: broken GIF data stream (code {c} past the next entry {next_code})")
            prev = table[last]
            string = prev + prev[:1] if c == next_code else table[c]
            if next_code < 4096:
                table.append(prev + string[:1])
                if next_code == mask and width < MAX_BITS:
                    width += 1
                    mask = (1 << width) - 1
                next_code += 1
        last = c
        out += string
        if len(out) >= need:
            return bytes(out[:need])


def to_rgb(canvas: np.ndarray, palette) -> np.ndarray:
    """Pillow's `convert("RGB")` of the P (or L) canvas."""
    if palette is None:
        return np.repeat(canvas[:, :, None], 3, axis=2)
    return np.frombuffer(palette, np.uint8).reshape(256, 3)[canvas]


def decode_twin(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """uint8 [H, W, 3]: `PIL.Image.open(...).convert("RGB")` of a GIF file."""
    data = bytes(data)
    gif = parse(data, name)
    stream = np.frombuffer(_lzw(data, gif, name), np.uint8).reshape(gif.frame_height, gif.frame_width)
    canvas = np.full((gif.height, gif.width), gif.fill, np.uint8)
    frame = np.empty_like(stream)
    frame[row_order(gif.frame_height, gif.interlace)] = stream
    canvas[gif.y0 : gif.y0 + gif.frame_height, gif.x0 : gif.x0 + gif.frame_width] = frame
    return to_rgb(canvas, gif.palette)


# --- the native decoder --------------------------------------------------------


def decode_native(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """`decode_twin` with the code loop and the lookup in csrc/gif.cu (built on first use)."""
    from uniir_tpu_torch import _build

    lib = _build.load("gif")
    data = bytes(data)
    gif = parse(data, name)
    out = np.empty((gif.height, gif.width, 3), np.uint8)
    err = ctypes.create_string_buffer(256)
    grey = gif.palette is None
    if lib.uniir_gif_decode(data, len(data), gif.offset, gif.bits, gif.width, gif.height, gif.x0, gif.y0,
                            gif.frame_width, gif.frame_height, int(gif.interlace), gif.fill,
                            None if grey else gif.palette, out.ctypes.data, err, len(err)) != 0:
        raise ValueError(f"{name}: {err.value.decode()}")
    with _calls_lock:
        decode_native.calls += 1
    return out


decode_native.calls = 0  # decodes that went through the native library (read by chip_smoke.py)
_calls_lock = threading.Lock()  # the loader's threads decode at once


def decoder_for(device) -> Callable[[bytes, str], np.ndarray]:
    """The decoder a run on `device` uses: the native one on a CUDA run's
    host, the twin on a CPU run."""
    from uniir_tpu_torch import _build

    return decode_native if _build.is_cuda(device) else decode_twin
