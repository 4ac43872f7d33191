"""WebP decoding with Pillow's pixels, without Pillow.

The JAX package reads every image with `PIL.Image.open(path).convert("RGB")`.
Pillow 12.1 opens a WebP file through libwebp 1.6's animation decoder, and
the image is the canvas after the first frame.  This module gives the same
uint8 [H, W, 3] array, bit for bit:

  * Pillow takes a file whose first chunk is `VP8 `, `VP8L` or `VP8X`
    (`accepts`); libwebp's demuxer then reads the whole RIFF: its size no
    larger than the file (bytes past it ignored) and at least one chunk,
    every chunk padded to an even size and inside the RIFF, nothing but a
    whole chunk header or the end after each;
  * the simple forms, a `VP8 ` or `VP8L` chunk (what follows the image is
    not read), and the extended form `VP8X` (reserved flag bits refused; a
    canvas below 2^32 pixels): `ICCP` / `EXIF` / `XMP ` and unknown chunks
    skipped, as `convert` applies none of them; a still image of exactly
    the canvas's size, its `ALPH` chunk kept only under the alpha flag; or,
    under the animation flag and after `ANIM`, frames in `ANMF` chunks whose
    bitstreams lie inside the canvas at their offsets (x 2), the first of
    them drawn on a canvas that starts zero-filled (black outside the
    frame; the frame's blend and dispose bits and `ANIM`'s background do not
    show in the first frame); every frame complete, `ALPH` before `VP8 `
    and never before `VP8L`;
  * `VP8L` (`data.vp8l`): its ARGB copied as it is; alpha never reaches RGB;
  * `VP8 ` (`data.vp8`): the planes turned to RGB through libwebp's "fancy"
    upsampler (the 9-3-3-1 kernel on row pairs with its rounding, the first
    row and an even height's last row from one chroma row, an even width's
    last pixel from one chroma column) and VP8YUVToR / G / B (14-bit fixed
    point);
  * `ALPH` beside `VP8 `: compression 0 (raw, at least width x height
    bytes) or 1 (a headerless VP8L stream whose green is the alpha), filter
    0-3 (none, horizontal, vertical, gradient), pre-processing 0-1, the
    reserved bits 0; the plane is decoded, so a broken chunk is refused as
    libwebp refuses it, and then dropped by `convert`.

A canvas past Pillow's decompression bomb limit, and anything libwebp
refuses, raises ValueError naming the file.

Two decoders compute that function: `decode_twin`, plain Python for the
entropy decoding and numpy for the rest, and `decode_native`, host C++ in
`csrc/webp.cu` built by `_build` like the kernels and called through ctypes
(which releases the GIL, so the loader's threads decode in parallel).
`decoder_for(device)` picks one by the run's device, as `data.png` does.
"""

from __future__ import annotations

import ctypes
import struct
import threading
from typing import Callable, NamedTuple

import numpy as np

from uniir_tpu_torch.data import vp8, vp8l

SIGNATURE = b"RIFF"
FIRST_CHUNKS = (b"VP8 ", b"VP8L", b"VP8X")  # Pillow's _accept
MAX_CHUNK_PAYLOAD = 0xFFFFFFF6
MAX_IMAGE_AREA = 1 << 32
MAX_PIXELS = 2 * (1024 * 1024 * 1024 // 4 // 3)  # Image.open's decompression bomb limit
ALPHA_FLAG, ANIMATION_FLAG, VALID_FLAGS = 0x10, 0x02, 0x3E


def accepts(data: bytes) -> bool:
    """Pillow's `WebPImagePlugin._accept`."""
    return data[:4] == SIGNATURE and data[8:12] == b"WEBP" and data[12:16] in FIRST_CHUNKS


def _check_accepted(data: bytes, name: str) -> None:
    if not accepts(data):
        raise ValueError(f"{name}: not a WebP file Pillow opens (RIFF / WEBP / VP8, VP8L or VP8X)")


class Frame:
    """A frame as the demuxer stores it: offsets, the image and alpha chunks
    (offset, size with header and padding), the bitstream's size."""

    def __init__(self):
        self.x = self.y = self.width = self.height = 0
        self.image = self.alpha = None
        self.number = 0
        self.complete = False


class WebP(NamedTuple):
    """What `parse` found: the canvas and the first frame, its bitstream's
    payload (pad byte included), whether it is lossless, and the payload of
    its ALPH chunk (the declared size) or None."""

    width: int
    height: int
    x: int
    y: int
    frame_width: int
    frame_height: int
    lossless: bool
    payload: bytes
    alpha: bytes | None


class _Refused(Exception):
    pass


def _features(chunk: bytes):
    """WebPGetFeatures on one `VP8 ` / `VP8L` chunk: (width, height, alpha hint) or None."""
    if len(chunk) < 12:
        return None
    size = struct.unpack("<I", chunk[4:8])[0]
    payload = chunk[8:]
    if chunk[:4] == b"VP8 ":
        wh = vp8.info(payload, size)
        return None if wh is None else (*wh, 0)
    return vp8l.header(payload)


class _Demux:
    """libwebp's WebPDemux over a whole file (`run`): the canvas and the frames,
    refusals raised as _Refused.  `pos` walks the RIFF, whose end is `end`."""

    def __init__(self, data: bytes):
        self.data, self.pos, self.end = data, 12, 0
        self.flags, self.anim, self.ext = 0, 0, False
        self.width = self.height = 0
        self.frames: list = []

    def left(self) -> int:
        return self.end - self.pos

    def chunk_header(self):
        """(start, fourcc, padded payload size) of the chunk at `pos`, which moves past the header."""
        start = self.pos
        size = struct.unpack("<I", self.data[start + 4 : start + 8])[0]
        self.pos = start + 8
        if size > MAX_CHUNK_PAYLOAD:
            raise _Refused("chunk size")
        padded = size + (size & 1)
        if padded > self.left():
            raise _Refused(f"chunk {self.data[start : start + 4]!r} past the RIFF end")
        return start, self.data[start : start + 4], padded

    def store_frame(self, number: int, min_size: int, frame: Frame) -> None:
        """StoreFrame: an ALPH chunk and an image chunk, up to the first other chunk."""
        if self.left() < 8 or self.left() < min_size:
            raise _Refused("truncated frame")
        alphas = images = 0
        while True:
            start, fourcc, padded = self.chunk_header()
            if fourcc == b"ALPH" and alphas == 0:
                alphas = 1
                frame.alpha = (start, 8 + padded)
            elif fourcc in (b"VP8 ", b"VP8L") and images == 0:
                if fourcc == b"VP8L" and alphas:
                    raise _Refused("ALPH before VP8L")
                feats = _features(self.data[start : start + 8 + padded])
                if feats is None:
                    raise _Refused("the image chunk's header (VP8GetInfo / VP8LGetInfo)")
                images = 1
                frame.image = (start, 8 + padded)
                frame.width, frame.height = feats[:2]
                frame.complete = True
            else:
                self.pos = start
                return
            frame.number = number
            self.pos += padded
            if self.pos == self.end:
                return
            if self.left() < 8:
                raise _Refused("truncated chunk header")

    def add_frame(self, frame: Frame) -> None:
        if self.frames and not self.frames[-1].complete:
            raise _Refused("a frame after an incomplete one")
        self.frames.append(frame)

    def single_image(self) -> None:
        if self.frames:
            raise _Refused("a second image")
        if self.left() < 8:
            raise _Refused("truncated")
        frame = Frame()
        self.store_frame(1, 0, frame)
        if not self.flags & ALPHA_FLAG:
            frame.alpha = None
        if not self.ext and frame.width > 0 and frame.height > 0:
            self.width, self.height = frame.width, frame.height
        self.add_frame(frame)

    def animation_frame(self, chunk_size: int) -> None:
        if 16 > self.left() or chunk_size < 16:
            raise _Refused("ANMF chunk too small")
        head = self.data[self.pos : self.pos + 16]
        frame = Frame()
        frame.x, frame.y = 2 * int.from_bytes(head[0:3], "little"), 2 * int.from_bytes(head[3:6], "little")
        w, h = 1 + int.from_bytes(head[6:9], "little"), 1 + int.from_bytes(head[9:12], "little")
        self.pos += 16  # the duration, and dispose and blend, which do not show in the first frame
        if w * h >= MAX_IMAGE_AREA:
            raise _Refused("frame too large")
        start = self.pos
        self.store_frame(len(self.frames) + 1, chunk_size - 16, frame)
        if self.pos - start > chunk_size - 16:
            raise _Refused("ANMF sub-chunks past the frame")
        if self.flags & ANIMATION_FLAG and frame.number > 0:
            self.add_frame(frame)

    def run(self) -> None:
        data = self.data
        if len(data) < 20 or data[:4] != SIGNATURE or data[8:12] != b"WEBP":
            raise _Refused("no RIFF / WEBP header")
        riff_size = struct.unpack("<I", data[4:8])[0]
        if riff_size < 8 or riff_size > MAX_CHUNK_PAYLOAD:
            raise _Refused(f"RIFF size {riff_size}")
        self.end = riff_size + 8
        if len(data) < self.end:
            raise _Refused(f"truncated: the RIFF size says {self.end} bytes, the file has {len(data)}")
        if data[12:16] in (b"VP8 ", b"VP8L"):
            self.single_image()
            if not self.frames or self.width <= 0 or self.frames[0].width <= 0:
                raise _Refused("no image")
            return
        if data[12:16] != b"VP8X":
            raise _Refused(f"first chunk {data[12:16]!r}")
        self.ext = True
        vp8x = struct.unpack("<I", data[16:20])[0]
        self.pos = 20
        if vp8x > MAX_CHUNK_PAYLOAD or vp8x < 10:
            raise _Refused("VP8X size")
        vp8x += vp8x & 1
        if vp8x > self.left():
            raise _Refused("VP8X past the RIFF end")
        self.flags = data[20]
        self.width, self.height = 1 + int.from_bytes(data[24:27], "little"), 1 + int.from_bytes(data[27:30], "little")
        if self.width * self.height >= MAX_IMAGE_AREA:
            raise _Refused("canvas too large")
        self.pos += vp8x
        if self.left() < 8:
            raise _Refused("no chunk after VP8X")
        animation = bool(self.flags & ANIMATION_FLAG)
        while True:
            start, fourcc, padded = self.chunk_header()
            if fourcc == b"VP8X":
                raise _Refused("a second VP8X")
            if fourcc in (b"ALPH", b"VP8 ", b"VP8L"):
                if self.anim or animation:
                    raise _Refused("a still image in an animation")
                self.pos = start
                self.single_image()
            elif fourcc == b"ANIM":
                if padded < 6:
                    raise _Refused("ANIM chunk too small")
                self.anim += 1
                self.pos += padded  # background colour and loop count: not shown in the first frame
            elif fourcc == b"ANMF":
                if not self.anim:
                    raise _Refused("ANMF before ANIM")
                self.animation_frame(padded)
            else:
                self.pos += padded
            if self.pos == self.end:
                break
            if self.left() < 8:
                raise _Refused("truncated chunk header")
        if not self.frames:
            raise _Refused("no frame")
        if self.flags & ~VALID_FLAGS:
            raise _Refused(f"VP8X flags {self.flags:#x}")
        for f in self.frames:
            if not animation and f.number > 1:
                raise _Refused("frames in a still image")
            if not f.complete:
                raise _Refused("an incomplete frame")
            if f.alpha is not None and f.alpha[0] > f.image[0]:
                raise _Refused("ALPH after the image")
            if f.width <= 0 or f.height <= 0:
                raise _Refused("empty frame")
            if not animation and (f.x or f.y or f.width != self.width or f.height != self.height):
                raise _Refused(f"image {f.width} x {f.height} on a canvas of {self.width} x {self.height}")
            if animation and (f.x + f.width > self.width or f.y + f.height > self.height):
                raise _Refused("a frame past the canvas")


def parse(data: bytes, name: str = "<bytes>") -> WebP:
    """The canvas and the first frame of a WebP file as libwebp's demuxer
    reads it; ValueError where it (or Pillow) refuses the file."""
    _check_accepted(data, name)
    dm = _Demux(data)
    try:
        dm.run()
    except _Refused as e:
        raise ValueError(f"{name}: WebP demuxer refuses the file ({e})") from None
    cw, ch = dm.width, dm.height
    if cw * ch > MAX_PIXELS:
        raise ValueError(f"{name}: WebP canvas of {cw} x {ch} pixels (decompression bomb)")
    f = dm.frames[0]
    img_at, img_size = f.image
    fourcc = data[img_at : img_at + 4]
    alpha = None
    if f.alpha is not None and fourcc == b"VP8 ":
        at = f.alpha[0]
        alpha = data[at + 8 : at + 8 + struct.unpack("<I", data[at + 4 : at + 8])[0]]
    return WebP(cw, ch, f.x, f.y, f.width, f.height, fourcc == b"VP8L", data[img_at + 8 : img_at + img_size], alpha)


# --- the arithmetic the two decoders share ---------------------------------------------------


def unfilter_alpha(deltas: np.ndarray, method: int) -> np.ndarray:
    """uint8 [H, W]: libwebp's WebPUnfilters (0 none, 1 horizontal, 2 vertical,
    3 gradient); the first row is horizontal from 0 for every filter, a later
    row's first pixel predicted from the one above."""
    h, w = deltas.shape
    if method == 0:
        return deltas.copy()
    out = np.zeros((h, w), np.uint8)
    out[0] = np.cumsum(deltas[0], dtype=np.uint8)
    for y in range(1, h):
        prev = out[y - 1]
        if method == 1:
            out[y] = np.cumsum(np.concatenate([[prev[0]], deltas[y]]), dtype=np.uint8)[1:]
        elif method == 2:
            out[y] = prev + deltas[y]
        else:
            row = out[y]
            left, tl = int(prev[0]), int(prev[0])
            for x in range(w):
                top = int(prev[x])
                g = left + top - tl
                left = (int(deltas[y, x]) + (g if 0 <= g <= 255 else 0 if g < 0 else 255)) & 255
                tl = top
                row[x] = left
    return out


def decode_alpha(alpha: bytes, width: int, height: int) -> np.ndarray:
    """uint8 [H, W]: an ALPH chunk's plane (ALPHInit / ALPHDecode); ValueError where libwebp refuses it."""
    if len(alpha) <= 1:
        raise ValueError("ALPH chunk without data")
    head = alpha[0]
    method, filt, pre, reserved = head & 3, (head >> 2) & 3, (head >> 4) & 3, head >> 6
    if method > 1 or pre > 1 or reserved:
        raise ValueError(f"ALPH header {head:#04x}")
    if method == 0:
        if len(alpha) - 1 < width * height:
            raise ValueError("ALPH chunk shorter than the plane")
        plane = np.frombuffer(alpha, np.uint8, width * height, 1).reshape(height, width)
    else:
        plane = vp8l.decode_alpha_plane(alpha[1:], width, height)
    return unfilter_alpha(plane, filt)


def _fancy_rows(top: np.ndarray, cur: np.ndarray, width: int, upper: np.ndarray) -> np.ndarray:
    """UpsampleRgbLinePair's chroma for rows whose chroma rows are top / cur
    (int [rows, cw]); upper: the row is the pair's upper one (nearer top)."""
    near = np.where(upper[:, None], top, cur)
    far = np.where(upper[:, None], cur, top)
    out = np.empty((top.shape[0], width), np.int64)
    out[:, 0] = (3 * near[:, 0] + far[:, 0] + 2) >> 2
    pairs = (width - 1) >> 1
    if pairs:
        tl, t, lft, c = top[:, :pairs], top[:, 1 : pairs + 1], cur[:, :pairs], cur[:, 1 : pairs + 1]
        avg = tl + t + lft + c + 8
        diag_12 = (avg + 2 * (t + lft)) >> 3
        diag_03 = (avg + 2 * (tl + c)) >> 3
        up = upper[:, None]
        out[:, 1 : 2 * pairs : 2] = np.where(up, (diag_12 + tl) >> 1, (diag_03 + lft) >> 1)
        out[:, 2 : 2 * pairs + 1 : 2] = np.where(up, (diag_03 + t) >> 1, (diag_12 + c) >> 1)
    if not width & 1:
        last = width // 2 - 1
        out[:, width - 1] = (3 * near[:, last] + far[:, last] + 2) >> 2
    return out


def upsample(u: np.ndarray, v: np.ndarray, width: int, height: int):
    """libwebp's fancy upsampling of 4:2:0 chroma to [H, W] (EmitFancyRGB)."""
    r = np.arange(height)
    k = (r + 1) >> 1  # output row r lies between chroma rows k - 1 and k (row 0: row 0 alone)
    top_i = np.maximum(k - 1, 0)
    cur_i = np.minimum(k, (height + 1) // 2 - 1)
    upper = (r == 0) | (r & 1 == 1)
    lone = (r == 0) | ((r == height - 1) & (height % 2 == 0))
    top_i = np.where(r == 0, 0, top_i)
    cur_i = np.where(lone, top_i, cur_i)
    out = []
    for plane in (u, v):
        p = plane.astype(np.int64)
        out.append(_fancy_rows(p[top_i], p[cur_i], width, upper))
    return out


def yuv_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """VP8YUVToR / G / B: uint8 [H, W, 3]."""
    y, u, v = (a.astype(np.int64) for a in (y, u, v))

    def clip8(x):
        return np.where((x & ~16383) == 0, x >> 6, np.where(x < 0, 0, 255))

    yy = (y * 19077) >> 8
    r = clip8(yy + ((v * 26149) >> 8) - 14234)
    g = clip8(yy - ((u * 6419) >> 8) - ((v * 13320) >> 8) + 8708)
    b = clip8(yy + ((u * 33050) >> 8) - 17685)
    return np.stack([r, g, b], axis=2).astype(np.uint8)


def decode_twin(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """uint8 [H, W, 3]: `PIL.Image.open(...).convert("RGB")` of a WebP file."""
    data = bytes(data)
    img = parse(data, name)
    try:
        if img.lossless:
            rgb = vp8l.decode(img.payload)[:, :, :3]
        else:
            y, u, v = vp8.decode(img.payload)
            if img.alpha is not None:
                decode_alpha(img.alpha, img.frame_width, img.frame_height)
            uu, vv = upsample(u, v, img.frame_width, img.frame_height)
            rgb = yuv_to_rgb(y, uu, vv)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
    out = np.zeros((img.height, img.width, 3), np.uint8)
    out[img.y : img.y + img.frame_height, img.x : img.x + img.frame_width] = rgb
    return out


# --- the native decoder --------------------------------------------------------


def decode_native(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """`decode_twin` through csrc/webp.cu's host decoder (built on first use)."""
    from uniir_tpu_torch import _build

    lib = _build.load("webp")
    data = bytes(data)
    _check_accepted(data, name)
    err = ctypes.create_string_buffer(256)
    size = (ctypes.c_int * 2)()
    if lib.uniir_webp_info(data, len(data), size, err, len(err)) != 0:
        raise ValueError(f"{name}: {err.value.decode()}")
    out = np.empty((size[1], size[0], 3), np.uint8)
    if lib.uniir_webp_decode(data, len(data), out.ctypes.data, size[0], size[1], err, len(err)) != 0:
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
