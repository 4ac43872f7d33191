"""DDS (DirectDraw Surface) decoding with Pillow's pixels, without Pillow.

The JAX package reads every image with `PIL.Image.open(path).convert("RGB")`.
For a DDS file this module gives the same uint8 [H, W, 3] array as Pillow
12.1 (`DdsImagePlugin`, its Python `DdsRgbDecoder` and `BcnDecode.c`), the
first mip level only:

  * the 124-byte `DDS_HEADER` and its pixel format: RGB (with or without
    ALPHAPIXELS) through DdsRgbDecoder's masks, whatever they are (each
    pixel's bytes little-endian, each mask's bits scaled to 0..255 through
    a double and cut toward zero, zeros read past the file's end);
    LUMINANCE at 8 bits (L) or 16 bits with ALPHAPIXELS (LA); PAL8 (a
    1024-byte RGBA palette); FOURCC DXT1 / DXT3 / DXT5, BC4U / ATI1,
    BC5U / ATI2 and BC5S, or DX10 and its header's DXGI format: BC1-BC5
    (typeless and unorm), BC5 snorm, BC6H UF16 / SF16, BC7 (typeless,
    unorm, sRGB) and R8G8B8A8 (typeless, unorm, sRGB) raw;
  * the block decoders (`bc1`-`bc7`): BC1's 3-colour mode and its
    transparent black, BC2 / BC3's colours always in 4-colour mode, BC5's
    blue 0 (128 for BC5S, whose endpoints Pillow offsets by 128), BC6H's
    14 modes with Pillow's unquantization, its unsigned-looking signed
    delta sums and its half -> 8-bit rounding (x 255, cut), BC7's 8 modes
    with partitions, p-bits, rotation and the index selector, a zero mode
    byte black; pixels past a width or height that is no multiple of 4
    dropped;
  * `convert("RGB")`: alpha dropped, L grey, P through the palette.

Every other pixel format raises as Pillow's _open raises (not a next
reader): a header size other than 124, a header cut short, a luminance
depth other than 8 / 16-with-alpha, an unknown FourCC or DXGI format (BC4
signed, the sRGB forms of BC1-BC3 ...).  Block or raw data cut short
raises (Pillow's "image file is truncated").  Fewer than 8 bytes, or a
DX10 header cut before its format, or a size of 0, is not a DDS file to
Image.open (it tries its next reader).

The block decoders and the mask decoder are vectorized numpy here (the
twins, the reference) and host C++ in `csrc/bcn.cu` (built by `_build` like
the kernels, called through ctypes, which releases the GIL);
`decoder_for(device)` picks the native one on a CUDA run's host.  Each native
entry counts its calls in `native_calls`.
"""

from __future__ import annotations

import ctypes
import struct
import threading
from typing import Callable

import numpy as np

from uniir_tpu_torch.data import raster

SIGNATURE = b"DDS "
RGB, LUMINANCE, PAL8, FOURCC, ALPHAPIXELS = 0x40, 0x20000, 0x20, 0x4, 0x1
# FourCC / DXGI format -> (block decoder, signed)
FOURCCS = {b"DXT1": ("bc1", 0), b"DXT3": ("bc2", 0), b"DXT5": ("bc3", 0), b"BC4U": ("bc4", 0),
           b"ATI1": ("bc4", 0), b"BC5S": ("bc5", 1), b"BC5U": ("bc5", 0), b"ATI2": ("bc5", 0)}
DXGI = {70: ("bc1", 0), 71: ("bc1", 0), 73: ("bc2", 0), 74: ("bc2", 0), 76: ("bc3", 0), 77: ("bc3", 0),
        79: ("bc4", 0), 80: ("bc4", 0), 82: ("bc5", 0), 83: ("bc5", 0), 84: ("bc5", 1), 95: ("bc6h", 0),
        96: ("bc6h", 1), 97: ("bc7", 0), 98: ("bc7", 0), 99: ("bc7", 0), 27: ("raw", "RGBA"),
        28: ("raw", "RGBA"), 29: ("raw", "RGBA")}
BLOCK_BYTES = {"bc1": 8, "bc2": 16, "bc3": 16, "bc4": 8, "bc5": 16, "bc6h": 16, "bc7": 16}
KINDS = (*BLOCK_BYTES, "rgb_masks")


def accepts(data: bytes) -> bool:
    return data[:4] == SIGNATURE


def parse(data: bytes, name: str = "<bytes>") -> dict:
    """DdsImageFile._open: {"size", "kind" (a block decoder, "rgb_masks" or "raw"), "offset" (where the
    pixels start), and "sign", "bitcount" / "masks", "rawmode", "palette" as the kind needs}; raises
    raster.NotThisFormat where Image.open tries its next reader, ValueError where it raises."""
    if not accepts(data) or len(data) < 8:
        raise raster.NotThisFormat(f"{name}: not a DDS file")
    header_size = struct.unpack_from("<I", data, 4)[0]
    if header_size != 124:
        raise ValueError(f"{name}: unsupported DDS header size {header_size}")
    header = data[8:128]
    if len(header) != 120:
        raise ValueError(f"{name}: incomplete DDS header: {len(header)} bytes")
    height, width = struct.unpack_from("<2I", header, 4)
    pfflags, fourcc, bitcount = struct.unpack_from("<I4sI", header, 72)
    out = {"size": (width, height), "offset": 128}
    if pfflags & RGB:
        count = 4 if pfflags & ALPHAPIXELS else 3
        out.update(kind="rgb_masks", bitcount=bitcount, masks=struct.unpack_from(f"<{count}I", header, 84))
    elif pfflags & LUMINANCE:
        if bitcount == 8:
            out.update(kind="raw", rawmode="L")
        elif bitcount == 16 and pfflags & ALPHAPIXELS:
            out.update(kind="raw", rawmode="LA")
        else:
            raise ValueError(f"{name}: unsupported DDS luminance bit count {bitcount} for flags {pfflags}")
    elif pfflags & PAL8:
        palette = data[128:1152]
        out.update(kind="raw", rawmode="P", palette=palette, offset=128 + len(palette))
    elif pfflags & FOURCC:
        if fourcc == b"DX10":
            if len(data) < 132:
                raise raster.NotThisFormat(f"{name}: DDS DX10 header cut short")
            dxgi = struct.unpack_from("<I", data, 128)[0]
            if dxgi not in DXGI:
                raise ValueError(f"{name}: unimplemented DXGI format {dxgi}")
            kind, arg = DXGI[dxgi]
            out.update({"kind": kind, "rawmode" if kind == "raw" else "sign": arg, "offset": min(148, len(data))})
        elif fourcc in FOURCCS:
            out.update(kind=FOURCCS[fourcc][0], sign=FOURCCS[fourcc][1])
        else:
            raise ValueError(f"{name}: unimplemented DDS pixel format {int.from_bytes(fourcc, 'little')!r}")
    else:
        raise ValueError(f"{name}: unknown DDS pixel format flags {pfflags}")
    raster.check_size(width, height, name)
    return out


# --- the twins -------------------------------------------------------------------


def _blocks(data: bytes, pos: int, width: int, height: int, nbytes: int, name: str) -> np.ndarray:
    """uint8 [blocks high, blocks wide, nbytes] from `pos`, or ValueError where the data ends first."""
    bw, bh = (width + 3) // 4, (height + 3) // 4
    if pos > len(data) or (len(data) - pos) // nbytes < bw * bh:
        raise ValueError(f"{name}: DDS block data cut short (image file is truncated)")
    return np.frombuffer(data, np.uint8, count=bw * bh * nbytes, offset=pos).reshape(bh, bw, nbytes)


def _image(px: np.ndarray, width: int, height: int) -> np.ndarray:
    """uint8 [H, W, 3] of per-block pixels [bh, bw, 16, >= 3], cropped to the image."""
    bh, bw = px.shape[:2]
    img = px[..., :3].reshape(bh, bw, 4, 4, 3).transpose(0, 2, 1, 3, 4).reshape(bh * 4, bw * 4, 3)
    return np.ascontiguousarray(img[:height, :width])


def _le(b: np.ndarray) -> np.ndarray:
    """int64 little-endian values of the last axis' bytes."""
    return (b.astype(np.int64) << (8 * np.arange(b.shape[-1]))).sum(-1)


def _565(c: np.ndarray) -> np.ndarray:
    r, g, b = (c & 0xF800) >> 8, (c & 0x7E0) >> 3, (c & 0x1F) << 3
    return np.stack([r | r >> 5, g | g >> 6, b | b >> 5], axis=-1)


def _bc1_colours(b: np.ndarray, four_always: bool) -> np.ndarray:
    """int64 [..., 16, 3] of BC1 colour blocks b [..., 8]."""
    c0, c1 = _le(b[..., 0:2]), _le(b[..., 2:4])
    p0, p1 = _565(c0), _565(c1)
    four = (c0 > c1)[..., None] | four_always
    p2 = np.where(four, (2 * p0 + p1) // 3, (p0 + p1) // 2)
    p3 = np.where(four, (p0 + 2 * p1) // 3, 0)
    lut = _le(b[..., 4:8])
    sel = (lut[..., None] >> (2 * np.arange(16))) & 3
    palette = np.stack([p0, p1, p2, p3], axis=-2)  # [..., 4, 3]
    return np.take_along_axis(palette, np.broadcast_to(sel[..., None], sel.shape + (3,)), axis=-2)


def _bc3_channel(b: np.ndarray, sign: int) -> np.ndarray:
    """int64 [..., 16] of an interpolated channel b [..., 8] (BC3's alpha, BC4, each half of BC5)."""
    e = b[..., :2].astype(np.int64)
    if sign:
        e = np.where(e > 127, e - 256, e) + 128
    a0, a1 = e[..., 0:1], e[..., 1:2]
    k = np.arange(1, 7)
    eight = ((7 - k) * a0 + k * a1) // 7
    k5 = np.arange(1, 5)
    six = np.concatenate([((5 - k5) * a0 + k5 * a1) // 5, np.zeros_like(a0), np.full_like(a0, 255)], axis=-1)
    levels = np.concatenate([a0, a1, np.where(a0 > a1, eight, six)], axis=-1)
    lut = np.concatenate([(_le(b[..., 2:5])[..., None] >> (3 * np.arange(8))) & 7,
                          (_le(b[..., 5:8])[..., None] >> (3 * np.arange(8))) & 7], axis=-1)
    return np.take_along_axis(levels, lut, axis=-1)


def _bits(b: np.ndarray) -> np.ndarray:
    """uint8 [..., 128] of each 16-byte block's bits, least significant first."""
    return np.unpackbits(b, axis=-1, bitorder="little")


def _field(bits: np.ndarray, start, count: int) -> np.ndarray:
    """int64 [n] of `count` bits from `start` (an int or an int array [n]), least significant first."""
    n = bits.shape[0]
    start = np.broadcast_to(np.asarray(start), (n,))
    value = np.zeros(n, np.int64)
    for j in range(count):
        value |= bits[np.arange(n), start + j].astype(np.int64) << j
    return value


def _indices(bits: np.ndarray, start: int, widths: np.ndarray) -> np.ndarray:
    """int64 [n, 16] of the pixels' indices, read one after the other from `start` at `widths` [n, 16]."""
    n = bits.shape[0]
    offsets = start + np.concatenate([np.zeros((n, 1), np.int64), np.cumsum(widths, axis=1)[:, :-1]], axis=1)
    value = np.zeros((n, 16), np.int64)
    for j in range(int(widths.max(initial=0))):
        on = widths > j
        at = np.where(on, offsets + j, 0)
        value |= np.where(on, np.take_along_axis(bits, at, axis=1).astype(np.int64), 0) << j
    return value


# BC7 / BC6H tables (BcnDecode.c): the subset of each pixel (2 subsets: a bit a pixel; 3: two bits), the
# anchor pixels of the second subset of two and the second and third of three, the interpolation weights
P2 = np.array([
    0xcccc, 0x8888, 0xeeee, 0xecc8, 0xc880, 0xfeec, 0xfec8, 0xec80, 0xc800, 0xffec, 0xfe80, 0xe800, 0xffe8,
    0xff00, 0xfff0, 0xf000, 0xf710, 0x008e, 0x7100, 0x08ce, 0x008c, 0x7310, 0x3100, 0x8cce, 0x088c, 0x3110,
    0x6666, 0x366c, 0x17e8, 0x0ff0, 0x718e, 0x399c, 0xaaaa, 0xf0f0, 0x5a5a, 0x33cc, 0x3c3c, 0x55aa, 0x9696,
    0xa55a, 0x73ce, 0x13c8, 0x324c, 0x3bdc, 0x6996, 0xc33c, 0x9966, 0x0660, 0x0272, 0x04e4, 0x4e40, 0x2720,
    0xc936, 0x936c, 0x39c6, 0x639c, 0x9336, 0x9cc6, 0x817e, 0xe718, 0xccf0, 0x0fcc, 0x7744, 0xee22])
P3 = np.array([
    0xaa685050, 0x6a5a5040, 0x5a5a4200, 0x5450a0a8, 0xa5a50000, 0xa0a05050, 0x5555a0a0, 0x5a5a5050,
    0xaa550000, 0xaa555500, 0xaaaa5500, 0x90909090, 0x94949494, 0xa4a4a4a4, 0xa9a59450, 0x2a0a4250,
    0xa5945040, 0x0a425054, 0xa5a5a500, 0x55a0a0a0, 0xa8a85454, 0x6a6a4040, 0xa4a45000, 0x1a1a0500,
    0x0050a4a4, 0xaaa59090, 0x14696914, 0x69691400, 0xa08585a0, 0xaa821414, 0x50a4a450, 0x6a5a0200,
    0xa9a58000, 0x5090a0a8, 0xa8a09050, 0x24242424, 0x00aa5500, 0x24924924, 0x24499224, 0x50a50a50,
    0x500aa550, 0xaaaa4444, 0x66660000, 0xa5a0a5a0, 0x50a050a0, 0x69286928, 0x44aaaa44, 0x66666600,
    0xaa444444, 0x54a854a8, 0x95809580, 0x96969600, 0xa85454a8, 0x80959580, 0xaa141414, 0x96960000,
    0xaaaa1414, 0xa05050a0, 0xa0a5a5a0, 0x96000000, 0x40804080, 0xa9a8a9a8, 0xaaaaaa44, 0x2a4a5254])
SUBSETS = {1: np.zeros((64, 16), np.int64), 2: (P2[:, None] >> np.arange(16)) & 1,
           3: (P3[:, None] >> (2 * np.arange(16))) & 3}
A2 = np.array([15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 2, 8, 2, 2, 8, 8, 15, 2, 8, 2, 2,
               8, 8, 2, 2, 15, 15, 6, 8, 2, 8, 15, 15, 2, 8, 2, 2, 2, 15, 15, 6, 6, 2, 6, 8, 15, 15, 2, 2, 15, 15,
               15, 15, 15, 2, 2, 15])
A3B = np.array([3, 3, 15, 15, 8, 3, 15, 15, 8, 8, 6, 6, 6, 5, 3, 3, 3, 3, 8, 15, 3, 3, 6, 10, 5, 8, 8, 6, 8, 5, 15,
                15, 8, 15, 3, 5, 6, 10, 8, 15, 15, 3, 15, 5, 15, 15, 15, 15, 3, 15, 5, 5, 5, 8, 5, 10, 5, 10, 8, 13,
                15, 12, 3, 3])
A3C = np.array([15, 8, 8, 3, 15, 15, 3, 8, 15, 15, 15, 15, 15, 15, 15, 8, 15, 8, 15, 3, 15, 8, 15, 8, 3, 15, 6, 10,
                15, 15, 10, 8, 15, 3, 15, 10, 10, 8, 9, 10, 6, 15, 8, 15, 3, 6, 6, 8, 15, 3, 15, 15, 15, 15, 15, 15,
                15, 15, 15, 15, 3, 15, 15, 8])
WEIGHTS = {2: np.array([0, 21, 43, 64]), 3: np.array([0, 9, 18, 27, 37, 46, 55, 64]),
           4: np.array([0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64])}


def _anchored(ns: int, partition: np.ndarray, width: int) -> np.ndarray:
    """int64 [n, 16] index widths: `width`, one less at pixel 0 and at each subset's anchor."""
    k = np.arange(16)
    anchor = k == 0
    if ns == 2:
        anchor = anchor | (k == A2[partition][:, None])
    elif ns == 3:
        sub = SUBSETS[3][partition]
        anchor = anchor | ((sub == 1) & (k == A3B[partition][:, None])) | ((sub == 2) & (k == A3C[partition][:, None]))
    return width - np.broadcast_to(anchor, (len(partition), 16)).astype(np.int64)


# (subsets, partition bits, rotation bits, index-selector bit, colour bits, alpha bits, p-bit an endpoint,
#  p-bit a subset, index bits, second index bits) of BC7's modes 0-7
BC7_MODES = ((3, 4, 0, 0, 4, 0, 1, 0, 3, 0), (2, 6, 0, 0, 6, 0, 0, 1, 3, 0), (3, 6, 0, 0, 5, 0, 0, 0, 2, 0),
             (2, 6, 0, 0, 7, 0, 1, 0, 2, 0), (1, 0, 2, 1, 5, 6, 0, 0, 2, 3), (1, 0, 2, 0, 7, 8, 0, 0, 2, 2),
             (1, 0, 0, 0, 7, 7, 1, 0, 4, 0), (2, 6, 0, 0, 5, 5, 1, 0, 2, 0))


def _bc7_mode(bits: np.ndarray, mode: int) -> np.ndarray:
    """int64 [n, 16, 4] RGBA of BC7 blocks of one mode."""
    ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2 = BC7_MODES[mode]
    n = bits.shape[0]
    bit = mode + 1
    partition = _field(bits, bit, pb)
    rotation = _field(bits, bit + pb, rb)
    index_sel = _field(bits, bit + pb + rb, isb)
    bit += pb + rb + isb
    numep = 2 * ns
    ep = np.zeros((n, numep, 4), np.int64)
    for c in range(3):
        for i in range(numep):
            ep[:, i, c] = _field(bits, bit, cb)
            bit += cb
    for i in range(numep):
        ep[:, i, 3] = _field(bits, bit, ab) if ab else 255
        bit += ab
    chans = 4 if ab else 3
    for per, on in ((1, epb), (2, spb)):  # a p-bit an endpoint, or one a subset shared by its two endpoints
        if on:
            cb += 1
            ab += 1 if ab else 0
            for i in range(0, numep, per):
                p = bits[:, bit].astype(np.int64)
                bit += 1
                for j in range(per):
                    ep[:, i + j, :chans] = (ep[:, i + j, :chans] << 1 | p[:, None]) & 0xFF

    def expand(v, b):
        v = (v << (8 - b)) & 0xFF
        return v | v >> b

    ep[..., :3] = expand(ep[..., :3], cb)
    if ab:
        ep[..., 3] = expand(ep[..., 3], ab)
    sub = SUBSETS[ns][partition]
    widths = _anchored(ns, partition, ib)
    i0 = _indices(bits, bit, widths)
    cw, aw = WEIGHTS[ib], WEIGHTS[ib2 if ab and ib2 else ib]
    if ab and ib2:
        widths2 = np.full((n, 16), ib2, np.int64)
        widths2[:, 0] -= 1
        i1 = _indices(bits, bit + 16 * ib - ns, widths2)
        sel = index_sel[:, None].astype(bool)
        s_colour = np.where(sel, aw[i1], cw[i0])
        s_alpha = np.where(sel, cw[i0], aw[i1])
    else:
        s_colour = s_alpha = cw[i0]
    e0 = np.take_along_axis(ep, (2 * sub)[..., None].repeat(4, -1), axis=1)
    e1 = np.take_along_axis(ep, (2 * sub + 1)[..., None].repeat(4, -1), axis=1)
    s = np.concatenate([np.repeat(s_colour[..., None], 3, -1), s_alpha[..., None]], axis=-1)
    col = ((64 - s) * e0 + s * e1 + 32) >> 6
    for r in (1, 2, 3):  # rotation swaps alpha with red, green or blue
        on = rotation == r
        col[on, :, r - 1], col[on, :, 3] = col[on, :, 3].copy(), col[on, :, r - 1].copy()
    return col


def bc7_pixels(b: np.ndarray) -> np.ndarray:
    """int64 [..., 16, 4] of BC7 blocks b [..., 16]."""
    flat = b.reshape(-1, 16)
    out = np.zeros((len(flat), 16, 4), np.int64)
    out[..., 3] = 255  # a zero mode byte: black (what is left of every other mode is overwritten below)
    first = flat[:, 0].astype(np.int64)
    mode = np.where(first == 0, 8, np.log2(np.maximum(first & -first, 1)).astype(np.int64))
    for m in range(8):
        sel = np.nonzero(mode == m)[0]
        if len(sel):
            out[sel] = _bc7_mode(_bits(flat[sel]), m)
    return out.reshape(b.shape[:-1] + (16, 4))


# (subsets, transformed, partition bits, endpoint bits, delta bits r / g / b) of BC6H's 14 modes, and the
# order of the endpoint bits after each mode's bits ("rw9:0": red of endpoint w, bits 9 down to 0 stored
# lowest first; "rw10:15": bits 15 down to 10 stored highest first; w x y z: endpoints 0-3)
BC6_MODES = ((2, 1, 5, 10, 5, 5, 5), (2, 1, 5, 7, 6, 6, 6), (2, 1, 5, 11, 5, 4, 4), (2, 1, 5, 11, 4, 5, 4),
             (2, 1, 5, 11, 4, 4, 5), (2, 1, 5, 9, 5, 5, 5), (2, 1, 5, 8, 6, 5, 5), (2, 1, 5, 8, 5, 6, 5),
             (2, 1, 5, 8, 5, 5, 6), (2, 0, 5, 6, 6, 6, 6), (1, 0, 0, 10, 10, 10, 10), (1, 1, 0, 11, 9, 9, 9),
             (1, 1, 0, 12, 8, 8, 8), (1, 1, 0, 16, 4, 4, 4))
BC6_LAYOUTS = (
    "gy4 by4 bz4 rw9:0 gw9:0 bw9:0 rx4:0 gz4 gy3:0 gx4:0 bz0 gz3:0 bx4:0 bz1 by3:0 ry4:0 bz2 rz4:0 bz3",
    "gy5 gz4 gz5 rw6:0 bz0 bz1 by4 gw6:0 by5 bz2 gy4 bw6:0 bz3 bz5 bz4 rx5:0 gy3:0 gx5:0 gz3:0 bx5:0 by3:0 ry5:0 "
    "rz5:0",
    "rw9:0 gw9:0 bw9:0 rx4:0 rw10 gy3:0 gx3:0 gw10 bz0 gz3:0 bx3:0 bw10 bz1 by3:0 ry4:0 bz2 rz4:0 bz3",
    "rw9:0 gw9:0 bw9:0 rx3:0 rw10 gz4 gy3:0 gx4:0 gw10 gz3:0 bx3:0 bw10 bz1 by3:0 ry3:0 bz0 bz2 rz3:0 gy4 bz3",
    "rw9:0 gw9:0 bw9:0 rx3:0 rw10 by4 gy3:0 gx3:0 gw10 bz0 gz3:0 bx4:0 bw10 by3:0 ry3:0 bz1 bz2 rz3:0 bz4 bz3",
    "rw8:0 by4 gw8:0 gy4 bw8:0 bz4 rx4:0 gz4 gy3:0 gx4:0 bz0 gz3:0 bx4:0 bz1 by3:0 ry4:0 bz2 rz4:0 bz3",
    "rw7:0 gz4 by4 gw7:0 bz2 gy4 bw7:0 bz3 bz4 rx5:0 gy3:0 gx4:0 bz0 gz3:0 bx4:0 bz1 by3:0 ry5:0 rz5:0",
    "rw7:0 bz0 by4 gw7:0 gy5 gy4 bw7:0 gz5 bz4 rx4:0 gz4 gy3:0 gx5:0 gz3:0 bx4:0 bz1 by3:0 ry4:0 bz2 rz4:0 bz3",
    "rw7:0 bz1 by4 gw7:0 by5 gy4 bw7:0 bz5 bz4 rx4:0 gz4 gy3:0 gx4:0 bz0 gz3:0 bx5:0 by3:0 ry4:0 bz2 rz4:0 bz3",
    "rw5:0 gz4 bz0 bz1 by4 gw5:0 gy5 by5 bz2 gy4 bw5:0 gz5 bz3 bz5 bz4 rx5:0 gy3:0 gx5:0 gz3:0 bx5:0 by3:0 ry5:0 "
    "rz5:0",
    "rw9:0 gw9:0 bw9:0 rx9:0 gx9:0 bx9:0",
    "rw9:0 gw9:0 bw9:0 rx8:0 rw10 gx8:0 gw10 bx8:0 bw10",
    "rw9:0 gw9:0 bw9:0 rx7:0 rw10:11 gx7:0 gw10:11 bx7:0 bw10:11",
    "rw9:0 gw9:0 bw9:0 rx3:0 rw10:15 gx3:0 gw10:15 bx3:0 bw10:15",
)


def bc6_packing(mode: int) -> list:
    """[(endpoint value 0-11: r0 g0 b0 r1 ... b3, bit)] of the mode's endpoint bits in the order stored."""
    out = []
    for token in BC6_LAYOUTS[mode].split():
        value = "wxyz".index(token[1]) * 3 + "rgb".index(token[0])
        hi, _, lo = token[2:].partition(":")
        hi, lo = int(hi), int(lo or hi)
        out += [(value, b) for b in (range(lo, hi + 1) if hi >= lo else range(lo, hi - 1, -1))]
    return out


def _sign_extend(v: np.ndarray, prec: int) -> np.ndarray:
    v = v & 0xFFFF
    return np.where(v & (1 << (prec - 1)), (v | (-1 << prec)) & 0xFFFF, v)


def _bc6_unquantize(v: np.ndarray, prec: int, sign: int) -> np.ndarray:
    if not sign:
        if prec >= 15:
            return v
        return np.where(v == 0, 0, np.where(v == (1 << prec) - 1, 0xFFFF, ((v << 15) + 0x4000) >> (prec - 1)))
    x = np.where(v >= 0x8000, v - 0x10000, v)
    if prec >= 16:
        return x
    a = np.abs(x)
    a = np.where(a == 0, 0, np.where(a >= (1 << (prec - 1)) - 1, 0x7FFF, ((a << 15) + 0x4000) >> (prec - 1)))
    return np.where(x < 0, -a, a)


def _bc6_to_8bit(v: np.ndarray, sign: int) -> np.ndarray:
    """Pillow's bc6_finalize and bc6_clamp: 31/64 (31/32 signed) of the value as a half float, x 255 in
    float32, cut; below 0 -> 0, above 1 -> 255."""
    if sign:
        half = np.where(v < 0, 0x8000 | ((-v) * 31) // 32, (v * 31) // 32)
    else:
        half = (v * 31) // 64
    f = half.astype(np.uint16).view(np.float16).astype(np.float32)
    scaled = (np.clip(f, 0, 1) * np.float32(255)).astype(np.int64)
    return np.where(f < 0, 0, np.where(f > 1, 255, scaled))


def _bc6_mode(bits: np.ndarray, mode: int, sign: int) -> np.ndarray:
    """int64 [n, 16, 3] RGB of BC6H blocks of one mode."""
    ns, tr, pb, epb, rb, gb, bb = BC6_MODES[mode]
    n = bits.shape[0]
    bit, ib = (2, 3) if mode < 2 else (5, 3) if mode < 10 else (5, 4)
    numep = 12 if ns == 2 else 6
    ep = np.zeros((n, 12), np.int64)
    packing = bc6_packing(mode)
    for i, (value, b) in enumerate(packing):
        ep[:, value] |= bits[:, bit + i].astype(np.int64) << b
    bit += len(packing)
    partition = _field(bits, bit, pb)
    bit += pb
    if sign:
        ep[:, :3] = _sign_extend(ep[:, :3], epb)
    if sign or tr:
        for i in range(3, numep, 3):
            for c, prec in enumerate((rb, gb, bb)):
                ep[:, i + c] = _sign_extend(ep[:, i + c], prec)
    if tr:  # the deltas' sums are masked and not sign-extended again, as in Pillow
        for i in range(3, numep):
            ep[:, i] = (ep[:, i] + ep[:, i % 3]) & ((1 << epb) - 1)
    ue = _bc6_unquantize(ep[:, :numep], epb, sign)
    sub = SUBSETS[ns][partition]
    w = WEIGHTS[ib][_indices(bits, bit, _anchored(2 if ns == 2 else 1, partition, ib))]
    rows = np.arange(n)[:, None, None]
    e0, e1 = ue[rows, (6 * sub)[:, :, None] + np.arange(3)], ue[rows, (6 * sub + 3)[:, :, None] + np.arange(3)]
    return _bc6_to_8bit((e0 * (64 - w[..., None]) + e1 * w[..., None]) >> 6, sign)


def bc6h_pixels(b: np.ndarray, sign: int) -> np.ndarray:
    """int64 [..., 16, 3] of BC6H blocks b [..., 16]; the reserved modes decode to black."""
    flat = b.reshape(-1, 16)
    m = flat[:, 0].astype(np.int64) & 0x1F
    mode = np.where(m & 3 < 2, m & 3, np.where(m & 3 == 2, 2 + (m >> 2), 10 + (m >> 2)))
    out = np.zeros((len(flat), 16, 3), np.int64)
    for k in range(14):
        sel = np.nonzero(mode == k)[0]
        if len(sel):
            out[sel] = _bc6_mode(_bits(flat[sel]), k, sign)
    return out.reshape(b.shape[:-1] + (16, 3))


def _bc_twin(kind: str):
    def twin(data: bytes, pos: int, width: int, height: int, sign: int, name: str) -> np.ndarray:
        b = _blocks(data, pos, width, height, BLOCK_BYTES[kind], name)
        if kind == "bc1":
            px = _bc1_colours(b, False)
        elif kind in ("bc2", "bc3"):
            px = _bc1_colours(b[..., 8:], True)
        elif kind == "bc4":
            px = np.repeat(_bc3_channel(b, 0)[..., None], 3, -1)
        elif kind == "bc5":
            rg = np.stack([_bc3_channel(b[..., :8], sign), _bc3_channel(b[..., 8:], sign)], axis=-1)
            px = np.concatenate([rg, np.full(rg.shape[:-1] + (1,), 128 if sign else 0)], axis=-1)
        elif kind == "bc6h":
            px = bc6h_pixels(b, sign)
        else:
            px = bc7_pixels(b)
        return _image(px.astype(np.uint8), width, height)

    return twin


def rgb_masks_twin(data: bytes, pos: int, width: int, height: int, bytecount: int, masks: tuple,
                   name: str) -> np.ndarray:
    """DdsRgbDecoder: uint8 [H, W, 3] of each pixel's `bytecount` bytes from `pos` read little-endian (the
    low 32 bits are all a mask sees; bytes past the file's end read as zeros), each of the first three masks'
    bits shifted down and scaled, int(v / (mask >> shift) * 255)."""
    pixels = width * height
    buf = np.frombuffer(data, np.uint8)
    at = pos + bytecount * np.arange(pixels, dtype=np.int64)
    value = np.zeros(pixels, np.int64)
    for k in range(min(bytecount, 4)):
        inside = at + k < len(buf)
        byte = np.zeros(pixels, np.int64)
        byte[inside] = buf[at[inside] + k]
        value |= byte << (8 * k)
    out = np.zeros((pixels, 3), np.uint8)
    for c, mask in enumerate(masks[:3]):
        if mask:
            shift = (mask & -mask).bit_length() - 1
            total = mask >> shift
            out[:, c] = (((value & mask) >> shift) / total * 255).astype(np.int64)
    return out.reshape(height, width, 3)


TWINS = {**{kind: _bc_twin(kind) for kind in BLOCK_BYTES}, "rgb_masks": rgb_masks_twin}


# --- the native entries ----------------------------------------------------------


native_calls = dict.fromkeys(KINDS, 0)  # entries of csrc/bcn.cu called (read by chip_smoke.py)
_calls_lock = threading.Lock()  # the loader's threads decode at once


def _run(kind: str, width: int, height: int, name: str, args: tuple) -> np.ndarray:
    from uniir_tpu_torch import _build

    lib = _build.load("bcn")
    out = ctypes.create_string_buffer(max(width * height * 3, 1))
    err = ctypes.create_string_buffer(256)
    if getattr(lib, f"uniir_bcn_{kind}")(*args, out, err, len(err)) != 0:
        raise ValueError(f"{name}: {err.value.decode()}")
    with _calls_lock:
        native_calls[kind] += 1
    return np.frombuffer(out.raw, np.uint8, count=width * height * 3).reshape(height, width, 3)


def _bc_native(kind: str):
    def native(data: bytes, pos: int, width: int, height: int, sign: int, name: str) -> np.ndarray:
        return _run(kind, width, height, name, (data, len(data), pos, width, height, sign))

    return native


def rgb_masks_native(data: bytes, pos: int, width: int, height: int, bytecount: int, masks: tuple,
                     name: str) -> np.ndarray:
    m = (ctypes.c_uint32 * 4)(*masks)
    return _run("rgb_masks", width, height, name, (data, len(data), pos, width, height, bytecount, m, len(masks)))


NATIVES = {**{kind: _bc_native(kind) for kind in BLOCK_BYTES}, "rgb_masks": rgb_masks_native}


# --- the image -------------------------------------------------------------------


def decode(data: bytes, name: str = "<bytes>", native: bool = False) -> np.ndarray:
    """uint8 [H, W, 3]: `PIL.Image.open(...).convert("RGB")` of a DDS file."""
    data = bytes(data)
    p = parse(data, name)
    (width, height), kind, pos = p["size"], p["kind"], p["offset"]
    stages = NATIVES if native else TWINS
    if kind == "rgb_masks":
        return stages[kind](data, pos, width, height, p["bitcount"] // 8, p["masks"], name)
    if kind != "raw":
        return stages[kind](data, pos, width, height, p["sign"], name)
    bands = {"L": 1, "LA": 2, "P": 1, "RGBA": 4}[p["rawmode"]]
    need = width * height * bands
    if len(data) - pos < need:
        raise ValueError(f"{name}: DDS pixel data cut short (image file is truncated)")
    px = np.frombuffer(data, np.uint8, count=need, offset=pos).reshape(height, width, bands)
    if p["rawmode"] == "P":
        table = np.zeros((256, 3), np.uint8)
        entries = np.frombuffer(p["palette"][: len(p["palette"]) // 4 * 4], np.uint8).reshape(-1, 4)
        table[: len(entries)] = entries[:, :3]
        return table[px[..., 0]]
    if bands < 3:
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def decode_twin(data: bytes, name: str = "<bytes>") -> np.ndarray:
    return decode(data, name)


def decode_native(data: bytes, name: str = "<bytes>") -> np.ndarray:
    return decode(data, name, native=True)


def decoder_for(device) -> Callable[[bytes, str], np.ndarray]:
    """The decoder a run on `device` uses: the native one on a CUDA run's host, the twin on a CPU run."""
    from uniir_tpu_torch import _build

    return decode_native if _build.is_cuda(device) else decode_twin
