"""JPEG 2000 files for the tests of data/jpeg2000.py and for scripts/make_jpeg2000_files.py.

  * `pillow_file`: what Pillow 12.1's JPEG 2000 plugin writes for a mode and its save options;
  * `opj_file`: what OpenJPEG's encoder writes (tests/openjpeg_ctypes.py) for the forms Pillow's save does
    not pass on: code-block styles, SOP / EPH, tile-parts, POC, RGN, subsampled components, precisions;
  * codestream surgery on those files: `split` / `join` over the main header's markers and the tile-parts,
    packet headers moved into PPT or PPM (`to_ppt`, `to_ppm`, from a file whose packets carry SOP and EPH),
    markers inserted, JP2 boxes rebuilt (`rebuild_jp2`), and the byte positions a cut is made at
    (`boundaries`);
  * `pillow_rgb`: Image.open(path).convert("RGB") from a file, as the JAX package reads it.
"""

from __future__ import annotations

import atexit
import io
import os
import shutil
import struct
import tempfile

import numpy as np

import openjpeg_ctypes as opj

_DIR = tempfile.mkdtemp(prefix="jpeg2000_files_")  # Pillow reads a file, as the JAX package does
atexit.register(shutil.rmtree, _DIR, True)


def image(seed: int, h: int, w: int, bands: int) -> np.ndarray:
    """A smooth gradient with seeded noise (what a photograph's tiles look like to the coder)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(xx * 7 + yy * 3 + 40 * k) for k in range(bands)], -1)
    return ((base + rng.integers(0, 48, (h, w, bands))) % 256).astype(np.uint8)


def pillow_file(mode: str, h: int = 24, w: int = 20, seed: int = 0, **options) -> bytes:
    """Pillow's JPEG 2000 save of an image of `mode` (L, LA, RGB, RGBA or I;16)."""
    from PIL import Image

    if mode == "I;16":
        a = image(seed, h, w, 1)[..., 0].astype(np.uint16) * 257 // 3
        img = Image.fromarray(a).convert("I;16")
    else:
        img = Image.fromarray(image(seed, h, w, 4)).convert(mode)
    buf = io.BytesIO()
    img.save(buf, "JPEG2000", **options)
    return buf.getvalue()


def planes(n: int, h: int, w: int, prec: int, seed: int = 0, sub=None, x0: int = 0, y0: int = 0, signed=False):
    """Integer planes for opj.encode: component c subsampled by sub[c] on an h x w image at (x0, y0)."""
    rng = np.random.default_rng(seed)
    out = []
    for c in range(n):
        dx, dy = sub[c] if sub else (1, 1)
        hh, ww = opj.component_shape(h, w, dx, dy, x0, y0)
        base = np.add.outer(np.arange(hh), np.arange(ww)) * 3 + c * 50
        a = (base + rng.integers(0, 1 << max(prec - 3, 1), (hh, ww))) % (1 << prec)
        if signed:
            a -= 1 << (prec - 1)
        out.append(a.astype(np.int32))
    return out


def opj_file(n: int = 3, h: int = 21, w: int = 19, prec: int = 8, seed: int = 0, sub=None, x0: int = 0,
             y0: int = 0, signed: bool = False, **options) -> bytes:
    """OpenJPEG's encoder on `planes(...)`: a J2K codestream unless options name codec=CODEC_JP2."""
    dx = [s[0] for s in sub] if sub else 1
    dy = [s[1] for s in sub] if sub else 1
    return opj.encode(planes(n, h, w, prec, seed, sub, x0, y0, signed), prec=prec, sgnd=signed, dx=dx, dy=dy,
                      x0=x0, y0=y0, width=w, height=h, **options)


def pillow_rgb(data: bytes):
    """uint8 [H, W, 3] of Image.open(path).convert("RGB"), or the exception Pillow raises."""
    from PIL import Image

    fd, path = tempfile.mkstemp(dir=_DIR)
    with os.fdopen(fd, "wb") as f:
        f.write(data)
    try:
        with Image.open(path) as img:
            return np.asarray(img.convert("RGB"))
    except Exception as e:  # noqa: BLE001 - any failure of Pillow's is the outcome compared
        return e
    finally:
        os.unlink(path)


# --- codestream surgery --------------------------------------------------------------------------------


def codestream_start(data: bytes) -> int:
    """Where the codestream begins: 0 for J2K, after the jp2c box header for JP2."""
    if data[:4] == b"\xff\x4f\xff\x51":
        return 0
    return data.index(b"jp2c") + 4


def split(data: bytes):
    """(prefix, main header [(marker, body)], tile-parts [(SOT body, [(marker, body)], data)], suffix) of a
    well-formed file whose tile-parts all carry their Psot."""
    start = codestream_start(data)
    pos = start + 2
    main = []
    while True:
        marker = struct.unpack(">H", data[pos : pos + 2])[0]
        if marker == 0xFF90:
            break
        length = struct.unpack(">H", data[pos + 2 : pos + 4])[0]
        main.append((marker, data[pos + 4 : pos + 2 + length]))
        pos += 2 + length
    parts = []
    while struct.unpack(">H", data[pos : pos + 2])[0] == 0xFF90:
        sot = data[pos + 4 : pos + 12]
        psot = struct.unpack(">I", sot[2:6])[0]
        end = pos + psot
        p = pos + 12
        markers = []
        while struct.unpack(">H", data[p : p + 2])[0] != 0xFF93:
            length = struct.unpack(">H", data[p + 2 : p + 4])[0]
            markers.append((struct.unpack(">H", data[p : p + 2])[0], data[p + 4 : p + 2 + length]))
            p += 2 + length
        parts.append((sot, markers, data[p + 2 : end]))
        pos = end
    return data[:start], main, parts, data[pos:]


def segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">HH", marker, len(body) + 2) + body


def join(prefix: bytes, main: list, parts: list, suffix: bytes = b"\xff\xd9") -> bytes:
    """The file of `split`'s pieces, each tile-part's Psot recomputed (JP2 box lengths are left: jp2c is the
    last box and OpenJPEG reads the codestream to its end)."""
    out = bytearray(prefix + b"\xff\x4f")
    for marker, body in main:
        out += segment(marker, body)
    for sot, markers, data in parts:
        head = b"".join(segment(m, b) for m, b in markers)
        psot = 12 + len(head) + 2 + len(data)
        out += segment(0xFF90, sot[:2] + struct.pack(">I", psot) + sot[6:]) + head + b"\xff\x93" + data
    out += suffix
    if prefix:
        at = prefix.rindex(b"jp2c") - 4
        out[at : at + 4] = struct.pack(">I", len(out) - at)
    return bytes(out)


def packets(data: bytes) -> list:
    """A tile-part's packets as (header, body), from data whose packets carry SOP and EPH markers."""
    starts = [i for i in range(len(data) - 1) if data[i] == 0xFF and data[i + 1] == 0x91]
    out = []
    for k, s in enumerate(starts):
        end = starts[k + 1] if k + 1 < len(starts) else len(data)
        eph = data.index(b"\xff\x92", s + 6)
        out.append((data[s + 6 : eph + 2], data[eph + 2 : end]))
    return out


def _sop(n: int) -> bytes:
    return b"\xff\x91\x00\x04" + struct.pack(">H", n % 65536)


def to_ppt(data: bytes, keep_sop: bool = True) -> bytes:
    """Every packet header moved into PPT markers of its tile-part (EPH with it), the bodies left behind
    SOP markers (or bare, with Scod's SOP and EPH bits cleared when `keep_sop` is False)."""
    prefix, main, parts, suffix = split(data)
    if not keep_sop:
        main = [(m, bytes([b[0] & ~6]) + b[1:]) if m == 0xFF52 else (m, b) for m, b in main]
    out = []
    n = 0
    zppt = {}  # a tile's Zppt counts on across its tile-parts
    for sot, markers, body in parts:
        pk = packets(body)
        headers = b"".join(h if keep_sop else h[:-2] for h, _ in pk)
        chunks = [headers[i : i + 60000] for i in range(0, len(headers), 60000)] or [b""]
        first = zppt.get(sot[:2], 0)
        zppt[sot[:2]] = first + len(chunks)
        ppts = [(0xFF61, bytes([first + z]) + c) for z, c in enumerate(chunks)]
        new_body = b"".join((_sop(n + i) if keep_sop else b"") + b for i, (_, b) in enumerate(pk))
        n += len(pk)
        out.append((sot, markers + ppts, new_body))
    return join(prefix, main, out, suffix)


def to_ppm(data: bytes, chunk: int = 40) -> bytes:
    """Every packet header moved into PPM markers of the main header (Nppm per tile-part), split into
    markers of `chunk` bytes so an Ippm crosses from one PPM to the next."""
    prefix, main, parts, suffix = split(data)
    stream = bytearray()
    out = []
    n = 0
    for sot, markers, body in parts:
        pk = packets(body)
        headers = b"".join(h for h, _ in pk)
        stream += struct.pack(">I", len(headers)) + headers
        out.append((sot, markers, b"".join(_sop(n + i) + b for i, (_, b) in enumerate(pk))))
        n += len(pk)
    ppms = [(0xFF60, bytes([z]) + bytes(stream[i : i + chunk])) for z, i in enumerate(range(0, len(stream), chunk))]
    return join(prefix, main + ppms, out, suffix)


def insert_main(data: bytes, marker: int, body: bytes, at: int = -1) -> bytes:
    """A marker segment inserted into the main header (after SIZ at the earliest)."""
    prefix, main, parts, suffix = split(data)
    index = len(main) if at < 0 else max(1, at)
    return join(prefix, main[:index] + [(marker, body)] + main[index:], parts, suffix)


def tlm(data: bytes) -> bytes:
    """A TLM marker listing every tile-part (Ttlm one byte, Ptlm four)."""
    _, _, parts, _ = split(data)
    body = bytearray(b"\x00\x50")
    for sot, markers, tile_data in parts:
        head = sum(4 + len(b) for _, b in markers)
        body += bytes([struct.unpack(">H", sot[:2])[0] % 256]) + struct.pack(">I", 12 + head + 2 + len(tile_data))
    return insert_main(data, 0xFF55, bytes(body))


def boundaries(data: bytes) -> list:
    """Every marker and packet boundary of the codestream: where a marker or an SOP begins, and one byte in."""
    start = codestream_start(data)
    out = set()
    for i in range(start, len(data) - 1):
        if data[i] == 0xFF and data[i + 1] in (0x4F, 0x51, 0x52, 0x53, 0x5C, 0x5D, 0x5E, 0x5F, 0x90, 0x91, 0x92,
                                               0x93, 0x64, 0xD9, 0x55, 0x57, 0x58, 0x60, 0x61, 0x63):
            out.update((i, i + 1, i + 2))
    return sorted(p for p in out if p < len(data))


def box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body) + 8) + kind + body


def boxes(data: bytes, at: int = 0, end: int | None = None) -> list:
    end = len(data) if end is None else end
    out = []
    while at < end:
        length, kind = struct.unpack(">I4s", data[at : at + 8])
        length = length or end - at
        out.append((kind, data[at + 8 : at + length]))
        at += length
    return out


def rebuild_jp2(data: bytes, header=None, before_codestream=()) -> bytes:
    """A JP2 file with jp2h's boxes replaced by header(list of (kind, body)) and boxes put before jp2c."""
    out = b""
    for kind, body in boxes(data):
        if kind == b"jp2h" and header is not None:
            body = b"".join(box(k, b) for k, b in header(boxes(body)))
        if kind == b"jp2c":
            out += b"".join(box(k, b) for k, b in before_codestream)
        out += box(kind, body)
    return out


def colr(enumcs: int | None = None, method: int = 1, icc: bytes = b"") -> tuple:
    return b"colr", bytes([method, 0, 0]) + (struct.pack(">I", enumcs) if method == 1 else icc)


def palette_file(entries: list, channels: int, seed: int = 0, with_cmap: bool = True, enumcs: int = 16) -> bytes:
    """A JP2 file of palette indices with `pclr` (and `cmap`) boxes of `entries` (tuples of `channels`)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    idx = rng.integers(0, min(len(entries), 256), (12, 14)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(idx, "L").save(buf, "JPEG2000")
    pclr = (b"pclr", struct.pack(">HB", len(entries), channels) + bytes([7] * channels)
            + b"".join(bytes(e) for e in entries))
    cmap = (b"cmap", b"".join(struct.pack(">HBB", 0, 1, i) for i in range(channels)))
    return rebuild_jp2(buf.getvalue(), lambda sub: [sub[0], colr(enumcs), pclr] + ([cmap] if with_cmap else []))
