"""PNG decoding with Pillow's pixels, without Pillow.

The JAX package reads every image with `PIL.Image.open(path).convert("RGB")`.
For a PNG file this module gives the same uint8 [H, W, 3] array, bit for
bit, as Pillow 12 gives it:

  * every colour type and bit depth the standard allows: grey (1 / 2 / 4 /
    8 / 16 bits), RGB (8 / 16), palette (1 / 2 / 4 / 8), grey + alpha and
    RGBA (8 / 16); Adam7 interlacing; the five scanline filters;
  * 1 / 2 / 4-bit grey scaled to 0..255 as Pillow's `1` / `L;2` / `L;4` raw
    modes do (x 255, x 85, x 17);
  * 16-bit grey opened as `I;16`, whose conversion to RGB clips at 255;
    16-bit RGB and the 16-bit forms with alpha keep each sample's high byte;
  * a palette index past the end of `PLTE` (or an image with no `PLTE`)
    gives black; `tRNS` is read but changes no pixel; alpha is dropped, not
    composited; no gamma, colour profile or `sBIT` is applied.

Pillow's checks are kept: every chunk before the image data has its CRC
checked (those of `IDAT` and of the chunks after it are not, as in Pillow);
the `IDAT` chunks must follow one another; a bad signature, header, filter
type, palette of more than 256 entries, or a zlib stream that is corrupt or
too short raises ValueError naming the file and the chunk.

Inflating is the stdlib's `zlib`.  Undoing the filters and expanding the
samples is done by one of two functions of the same arithmetic:
`decode_twin`, Python for the byte-serial filters (Average, Paeth) and
numpy for the rest, and `decode_native`, host C++ in `csrc/png.cu` built by
`_build` like the kernels and called through ctypes, which releases the GIL.
`decoder_for(device)` picks one by the run's device, as `data.jpeg` does.
"""

from __future__ import annotations

import ctypes
import struct
import threading
import zlib
from typing import Callable, NamedTuple

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
# (bit depth, colour type) -> samples a pixel: the forms Pillow opens (PngImagePlugin._MODES)
CHANNELS = {(1, 0): 1, (2, 0): 1, (4, 0): 1, (8, 0): 1, (16, 0): 1, (8, 2): 3, (16, 2): 3, (1, 3): 1, (2, 3): 1,
            (4, 3): 1, (8, 3): 1, (8, 4): 2, (16, 4): 2, (8, 6): 4, (16, 6): 4}


class Png(NamedTuple):
    """What the chunks say: the header, the palette (768 bytes, zeros past
    `PLTE`) and the inflated scanlines."""

    width: int
    height: int
    bit_depth: int
    color_type: int
    interlace: bool
    palette: bytes
    raw: bytes


def passes(width: int, height: int, interlace: bool) -> list:
    """(x0, y0, dx, dy, pass width, pass height) of each non-empty pass."""
    out = []
    for x0, y0, dx, dy in ADAM7 if interlace else ((0, 0, 1, 1),):
        pw, ph = -(-(width - x0) // dx), -(-(height - y0) // dy)
        if pw > 0 and ph > 0:
            out.append((x0, y0, dx, dy, pw, ph))
    return out


def row_bytes(pass_width: int, bits_per_pixel: int) -> int:
    return -(-pass_width * bits_per_pixel // 8)


def parse(data: bytes, name: str = "<bytes>") -> Png:
    """The header, palette and inflated image data of a PNG file;
    ValueError for anything Pillow refuses (module docstring)."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"{name}: not a PNG file (no PNG signature)")
    pos, n = 8, len(data)
    header, palette, idat = None, None, []
    while True:
        if pos + 8 > n:
            if idat:
                break  # no IEND: Pillow reads the image all the same
            raise ValueError(f"{name}: truncated PNG stream (no image data)")
        length, kind = struct.unpack(">I", data[pos : pos + 4])[0], data[pos + 4 : pos + 8]
        label = kind.decode("latin-1")
        body = data[pos + 8 : pos + 8 + length]
        if idat and kind != b"IDAT":
            break  # the image data ends; what follows is not read
        if kind == b"IDAT":
            if header is None:
                raise ValueError(f"{name}: chunk IDAT: image data before the IHDR header")
            idat.append(body)
            if len(body) != length:
                break  # a truncated file: the inflated size below decides
            pos += 12 + length
            continue
        crc = data[pos + 8 + length : pos + 12 + length]
        if len(crc) != 4:
            raise ValueError(f"{name}: chunk {label}: truncated PNG stream")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{name}: chunk {label}: bad CRC (broken PNG file)")
        if kind == b"IHDR":
            if length < 13:
                raise ValueError(f"{name}: chunk IHDR: truncated header")
            w, h, depth, ctype, _, filt, interlace = struct.unpack(">IIBBBBB", body[:13])
            if (depth, ctype) not in CHANNELS:
                raise ValueError(f"{name}: chunk IHDR: bit depth {depth} with colour type {ctype} is not a PNG form")
            if filt != 0 or interlace > 1:
                raise ValueError(f"{name}: chunk IHDR: unknown filter method {filt} or interlace method {interlace}")
            if w == 0 or h == 0:
                raise ValueError(f"{name}: chunk IHDR: image size {w} x {h}")
            header = (w, h, depth, ctype, bool(interlace))
        elif kind == b"PLTE" and header is not None and header[3] == 3:  # Pillow reads it for a palette image
            if length // 3 > 256:
                raise ValueError(f"{name}: chunk PLTE: {length // 3} entries (invalid palette size)")
            palette = body[: length - length % 3]
        elif kind == b"IEND":
            raise ValueError(f"{name}: chunk IEND: no image data")
        pos += 12 + length
    w, h, depth, ctype, interlace = header
    bpp = depth * CHANNELS[(depth, ctype)]
    need = sum(ph * (1 + row_bytes(pw, bpp)) for *_, pw, ph in passes(w, h, interlace))
    try:  # Pillow's ZipDecode stops once the rows are full: data past them, the checksum's too, is not read
        raw = zlib.decompressobj().decompress(b"".join(idat), need)
    except zlib.error as e:
        raise ValueError(f"{name}: chunk IDAT: corrupt zlib stream ({e})") from None
    if len(raw) < need:
        raise ValueError(f"{name}: chunk IDAT: truncated PNG stream ({len(raw)} of {need} bytes)")
    return Png(w, h, depth, ctype, interlace, (palette or b"")[:768].ljust(768, b"\x00"), raw[:need])


def _unfilter_row(ftype: int, line: bytes, prior: bytearray, bpp: int, name: str) -> bytearray:
    """One scanline with its filter undone (prior: the row above, unfiltered)."""
    if ftype in (0, 1, 2):
        x = np.frombuffer(line, np.uint8)
        if ftype == 1:  # each byte adds the one bpp before it, decoded: a running sum in each of bpp lanes
            x = np.cumsum(x.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:
            x = x + np.frombuffer(bytes(prior), np.uint8)
        return bytearray(x.tobytes())
    line, n = bytearray(line), len(line)
    if ftype == 3:
        for i in range(n):
            left = line[i - bpp] if i >= bpp else 0
            line[i] = (line[i] + ((left + prior[i]) >> 1)) & 255
    elif ftype == 4:
        for i in range(n):
            a = line[i - bpp] if i >= bpp else 0
            b = prior[i]
            c = prior[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            line[i] = (line[i] + (a if pa <= pb and pa <= pc else b if pb <= pc else c)) & 255
    else:
        raise ValueError(f"{name}: chunk IDAT: unknown filter type {ftype}")
    return line


def _samples(rows: bytes, pw: int, ph: int, depth: int, channels: int) -> np.ndarray:
    """uint16 [ph, pw, channels] of unfiltered scanlines (filter bytes removed)."""
    stride = row_bytes(pw, depth * channels)
    b = np.frombuffer(rows, np.uint8).reshape(ph, stride)
    if depth == 16:
        return b.view(">u2").astype(np.uint16).reshape(ph, pw, channels)
    if depth == 8:
        return b.astype(np.uint16).reshape(ph, pw, channels)
    per = 8 // depth  # samples a byte, most significant first
    shifts = (8 - depth * (np.arange(per) + 1)).astype(np.uint8)
    vals = (b[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(ph, stride * per)[:, :pw].astype(np.uint16)[:, :, None]


def to_rgb(img: np.ndarray, depth: int, ctype: int, palette: bytes) -> np.ndarray:
    """Pillow's `convert("RGB")` of the samples, uint16 [H, W, channels]."""
    if ctype == 3:
        return np.frombuffer(palette, np.uint8).reshape(256, 3)[img[:, :, 0]]
    if depth == 16:
        # Pillow opens 16-bit grey as I;16, which clips; the other 16-bit forms keep the high byte
        first = np.minimum(img[:, :, :3], 255) if ctype == 0 else img[:, :, :3] >> 8
    elif depth < 8:
        first = img * (255 // ((1 << depth) - 1))
    else:
        first = img[:, :, :3]
    first = first.astype(np.uint8)
    if ctype in (0, 4):
        return np.repeat(first[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(first)


def decode_twin(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """uint8 [H, W, 3]: `PIL.Image.open(...).convert("RGB")` of a PNG file."""
    png = parse(bytes(data), name)
    channels = CHANNELS[(png.bit_depth, png.color_type)]
    bpp_bits = png.bit_depth * channels
    bpp = max(1, bpp_bits // 8)
    img = np.zeros((png.height, png.width, channels), np.uint16)
    at = 0
    for x0, y0, dx, dy, pw, ph in passes(png.width, png.height, png.interlace):
        stride = row_bytes(pw, bpp_bits)
        prior, rows = bytearray(stride), bytearray()
        for _ in range(ph):
            line = _unfilter_row(png.raw[at], png.raw[at + 1 : at + 1 + stride], prior, bpp, name)
            rows += line
            prior = line
            at += 1 + stride
        img[y0::dy, x0::dx] = _samples(bytes(rows), pw, ph, png.bit_depth, channels)
    return to_rgb(img, png.bit_depth, png.color_type, png.palette)


MAX_TEXT_CHUNK, MAX_TEXT_MEMORY = 65536, 64 * 65536  # PngImagePlugin's limits on text


def _inflate_text(body: bytes, name: str):
    """_safe_zlib_decompress: None where zlib fails (Pillow then reads the text as empty or skips it)."""
    d = zlib.decompressobj()
    try:
        out = d.decompress(body, MAX_TEXT_CHUNK)
    except zlib.error:
        return None
    if d.unconsumed_tail:
        raise ValueError(f"{name}: decompressed text chunk too large")
    return out


def comment(data: bytes, name: str = "<bytes>"):
    """The str Pillow keeps as `info["comment"]`: the last tEXt / zTXt / iTXt chunk keyed "comment"
    before IEND (text chunks after the image data included, which `load` reads), or None.  Raises where
    Pillow's text handlers raise: a zTXt of a compression method other than 0, text past its limits."""
    pos, out, memory = 8, None, 0
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I", data[pos : pos + 4])[0], data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        if kind == b"IEND" or len(body) < length:
            break
        pos += 12 + length
        value = None
        if kind in (b"tEXt", b"zTXt"):
            key, _, v = body.partition(b"\0")
            if kind == b"zTXt":
                if v and v[0] != 0:
                    raise ValueError(f"{name}: unknown compression method {v[0]} in zTXt chunk")
                v = _inflate_text(v[1:], name) or b""
            if key:
                value = (key, v.decode("latin-1"))
        elif kind == b"iTXt":
            key, sep, r = body.partition(b"\0")
            if not sep or len(r) < 2:
                continue
            flag, method, r = r[0], r[1], r[2:]
            parts = r.split(b"\0", 2)
            if len(parts) < 3:
                continue
            v = parts[2]
            if flag:
                v = _inflate_text(v, name) if method == 0 else None
                if v is None:
                    continue
            try:
                value = (key, v.decode("utf-8"), parts[0].decode("utf-8"), parts[1].decode("utf-8"))[:2]
            except UnicodeDecodeError:
                continue
        if value is None:
            continue
        memory += len(value[1])
        if memory > MAX_TEXT_MEMORY:
            raise ValueError(f"{name}: too much memory used in text chunks")
        if value[0] == b"comment":
            out = value[1]
    return out


# --- the native decoder --------------------------------------------------------


def decode_native(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """`decode_twin` with the filters and samples done by csrc/png.cu (built on first use)."""
    from uniir_tpu_torch import _build

    lib = _build.load("png")
    png = parse(bytes(data), name)
    out = np.empty((png.height, png.width, 3), np.uint8)
    err = ctypes.create_string_buffer(256)
    if lib.uniir_png_decode(png.raw, len(png.raw), png.width, png.height, png.bit_depth, png.color_type,
                            int(png.interlace), png.palette, out.ctypes.data, err, len(err)) != 0:
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
