"""AVIF files for the tests of data/avif.py and for scripts/make_avif_files.py.

  * `photo`: a natural-looking picture (smooth fields with seeded noise), what Pillow's AVIF save codes as a
    photograph;
  * `pillow_file`: what Pillow 12.1's AVIF save (libavif 1.3.0 with aom 3.12.1) writes for a mode and its
    save options;
  * box surgery on those files: `boxes` / `build` over a file's top-level boxes and `meta`'s children, with
    the `iloc` extents moved with `mdat`; `set_colr`, `drop_property`, `add_property` and `to_idat`;
  * `pillow_rgb`: Image.open(path).convert("RGB") from a file, as the JAX package reads it (or the
    exception Pillow raises).
"""

from __future__ import annotations

import atexit
import io
import os
import shutil
import struct
import tempfile

import numpy as np

_DIR = tempfile.mkdtemp(prefix="avif_files_")  # Pillow reads a file, as the JAX package does
atexit.register(shutil.rmtree, _DIR, True)


def photo(seed: int, h: int, w: int) -> np.ndarray:
    """uint8 [h, w, 3]: three smooth waves per channel and seeded Gaussian noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    a = np.stack([128 + 60 * np.sin(xx / 7.0 + c + seed) + 40 * np.cos(yy / 5.0 - c) for c in range(3)], -1)
    return np.clip(a + rng.normal(0, 12, (h, w, 3)), 0, 255).astype(np.uint8)


def image(mode: str, h: int, w: int, seed: int = 0):
    """A PIL image of `mode` (L, LA, RGB, RGBA, P, ...) from `photo`, alpha a seeded ramp with noise."""
    from PIL import Image

    rgb = photo(seed, h, w)
    if mode in ("RGBA", "LA", "PA"):
        rng = np.random.default_rng(seed + 1)
        alpha = (np.arange(w)[None, :] * 255 // max(w - 1, 1) + rng.integers(-40, 40, (h, w))).clip(0, 255)
        return Image.fromarray(np.dstack([rgb, alpha.astype(np.uint8)])).convert(mode)
    return Image.fromarray(rgb).convert(mode)


def pillow_file(mode: str = "RGB", h: int = 24, w: int = 20, seed: int = 0, **options) -> bytes:
    """Pillow's AVIF save of an image of `mode`; `frames` (an option here) appends that many more images
    with save_all."""
    frames = options.pop("frames", 0)
    img = image(mode, h, w, seed)
    if frames:
        options = dict(options, save_all=True, append_images=[image(mode, h, w, seed + k + 1) for k in range(frames)])
    buf = io.BytesIO()
    img.save(buf, "AVIF", **options)
    return buf.getvalue()


def pillow_rgb(data: bytes):
    """Image.open(...).convert("RGB") of `data` written to a file, or the exception Pillow raises."""
    from PIL import Image

    path = os.path.join(_DIR, "f.avif")
    with open(path, "wb") as f:
        f.write(data)
    try:
        with Image.open(path) as img:
            return np.asarray(img.convert("RGB"))
    except Exception as e:  # noqa: BLE001 - the test compares the failure
        return e


# ---- box surgery -------------------------------------------------------------------------------------------

def boxes(data: bytes) -> list:
    """[(type, payload)] of the top-level boxes, `meta`'s payload as [(type, payload)] after its 4-byte
    version / flags (kept as ("", header))."""
    out, pos = [], 0
    while pos < len(data):
        size, kind = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + size]
        if kind == b"meta":
            out.append((kind, [(b"", body[:4])] + _children(body[4:])))
        else:
            out.append((kind, body))
        pos += size
    return out


def _children(data: bytes) -> list:
    out, pos = [], 0
    while pos < len(data):
        size, kind = struct.unpack(">I4s", data[pos : pos + 8])
        out.append((kind, data[pos + 8 : pos + size]))
        pos += size
    return out


def _box(kind: bytes, body) -> bytes:
    if isinstance(body, list):
        body = b"".join(b if k == b"" else _box(k, b) for k, b in body)
    return struct.pack(">I", 8 + len(body)) + kind + body


def build(tree: list, old: bytes = None) -> bytes:
    """The file of `tree`; where `old` is given, iloc's construction-method-0 extents follow mdat's move."""
    data = b"".join(_box(k, b) for k, b in tree)
    if old is None:
        return data
    delta = data.find(b"mdat") - old.find(b"mdat")
    if delta == 0:
        return data
    tree = [(k, [(ck, _shift_iloc(cb, delta) if ck == b"iloc" else cb) for ck, cb in b] if k == b"meta" else b)
            for k, b in tree]
    return b"".join(_box(k, b) for k, b in tree)


def _shift_iloc(body: bytes, delta: int) -> bytes:
    """Pillow's iloc (version 0, 4-byte offsets and lengths, no base offset) with every offset + delta."""
    assert body[0] == 0 and body[4] == 0x44 and body[5] == 0x00, "only Pillow's iloc layout"
    out = bytearray(body)
    count = struct.unpack(">H", body[6:8])[0]
    pos = 8
    for _ in range(count):
        extents = struct.unpack(">H", body[pos + 4 : pos + 6])[0]
        pos += 6
        for _ in range(extents):
            off = struct.unpack(">I", body[pos : pos + 4])[0]
            out[pos : pos + 4] = struct.pack(">I", off + delta)
            pos += 8
    return bytes(out)


def meta_child(tree: list, kind: bytes):
    meta = next(b for k, b in tree if k == b"meta")
    return next((b for k, b in meta if k == kind), None)


def replace_meta_child(tree: list, kind: bytes, body) -> list:
    return [(k, [(ck, body if ck == kind else cb) for ck, cb in b] if k == b"meta" else b) for k, b in tree]


def set_colr(data: bytes, primaries=1, transfer=13, matrix=6, full=True) -> bytes:
    """The file with its nclx colour property rewritten (same size: no offset moves)."""
    at = data.find(b"colrnclx") + 8
    return data[:at] + struct.pack(">HHHB", primaries, transfer, matrix, 0x80 if full else 0) + data[at + 7 :]


def _iprp(tree):
    iprp = _children(meta_child(tree, b"iprp"))
    ipco = _children(next(b for k, b in iprp if k == b"ipco"))
    ipma = next(b for k, b in iprp if k == b"ipma")
    return ipco, ipma


def _ipma_entries(ipma: bytes) -> list:
    flags = int.from_bytes(ipma[1:4], "big")
    pos, out = 8, []
    for _ in range(struct.unpack(">I", ipma[4:8])[0]):
        item = struct.unpack(">H", ipma[pos : pos + 2])[0]
        n = ipma[pos + 2]
        pos += 3
        assoc = []
        for _ in range(n):
            if flags & 1:
                x = struct.unpack(">H", ipma[pos : pos + 2])[0]
                pos += 2
                assoc.append((x & 0x7FFF, x >> 15))
            else:
                assoc.append((ipma[pos] & 0x7F, ipma[pos] >> 7))
                pos += 1
        out.append((item, assoc))
    return out


def _ipma_bytes(entries: list) -> bytes:
    body = b"\x00\x00\x00\x00" + struct.pack(">I", len(entries))
    for item, assoc in entries:
        body += struct.pack(">HB", item, len(assoc)) + bytes((e << 7) | i for i, e in assoc)
    return body


def _set_iprp(tree, ipco, entries):
    body = [(b"ipco", ipco), (b"ipma", _ipma_bytes(entries))]
    return replace_meta_child(tree, b"iprp", b"".join(_box(k, b) for k, b in body))


def drop_property(data: bytes, kind: bytes, item: int = 1) -> bytes:
    """The file with item `item`'s association to its `kind` property removed."""
    tree = boxes(data)
    ipco, ipma = _iprp(tree)
    entries = [(i, [(p, e) for p, e in assoc if not (i == item and ipco[p - 1][0] == kind)])
               for i, assoc in _ipma_entries(ipma)]
    return build(_set_iprp(tree, ipco, entries), data)


def add_property(data: bytes, kind: bytes, body: bytes, item: int = 1, essential: bool = False) -> bytes:
    """The file with a new property `kind` (its payload `body`) associated with item `item`."""
    tree = boxes(data)
    ipco, ipma = _iprp(tree)
    ipco = ipco + [(kind, body)]
    entries = [(i, assoc + ([(len(ipco), int(essential))] if i == item else [])) for i, assoc in _ipma_entries(ipma)]
    return build(_set_iprp(tree, ipco, entries), data)


def to_idat(data: bytes) -> bytes:
    """The file with every item's bytes moved from mdat into an idat box (iloc version 1, construction
    method 1), as libavif reads items of small images."""
    tree = boxes(data)
    iloc = meta_child(tree, b"iloc")
    count = struct.unpack(">H", iloc[6:8])[0]
    pos, items = 8, []
    for _ in range(count):
        item, _, extents = struct.unpack(">HHH", iloc[pos : pos + 6])
        pos += 6
        payload = b""
        for _ in range(extents):
            off, length = struct.unpack(">II", iloc[pos : pos + 8])
            payload += data[off : off + length]
            pos += 8
        items.append((item, payload))
    idat, body = b"", b"\x01\x00\x00\x00\x44\x00" + struct.pack(">H", count)
    for item, payload in items:
        body += struct.pack(">HHHHII", item, 1, 0, 1, len(idat), len(payload))
        idat += payload
    tree = replace_meta_child(tree, b"iloc", body)
    tree = [(k, b + [(b"idat", idat)] if k == b"meta" else b) for k, b in tree if k != b"mdat"]
    return build(tree)
