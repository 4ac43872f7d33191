"""AVIF decoding with Pillow's pixels, without Pillow.

The JAX package reads every image with `PIL.Image.open(path).convert("RGB")`.  Pillow 12.1 opens an AVIF
file through libavif 1.3.0 with dav1d 1.5.1, and converts the decoded YUV to 8-bit RGB(A) with libavif's
libyuv path.  This module gives the same uint8 [H, W, 3] array, bit for bit:

  * the container as libavif reads it with its default strictness: `ftyp` (an `avif` or `avis` brand),
    `meta` (`hdlr` "pict" first, `pitm`, `iloc` in construction methods 0 and 1 with `idat`, `iinf` /
    `infe`, `iref` `auxl` / `prem`, `iprp` / `ipco` / `ipma` with `ispe`, `av1C`, `pixi`, `colr`, `auxC`,
    `irot`, `imir`, `clap`), and for an `avis` file whose tracks libavif's AUTO source picks, the first
    sample of the colour track (`moov` / `trak` / `stsd` / `stco` / `co64` / `stsz` / `stsc`);
  * the AV1 payload (`av1_obu`, `av1_block`, `av1_filters`): the first frame, intra;
  * libavif's YUV -> RGB through libyuv: chroma upsampled by libyuv's bilinear filter (4:2:0) or linear
    one (4:2:2), the matrix's fixed-point constants (BT.601 / unspecified, BT.470BG, BT.709, BT.2020 NCL
    in full or limited range; identity for 4:4:4), 4:0:0 as grey; a `prem` alpha item un-premultiplies
    the colour as libyuv's ARGBUnattenuate does.  Pillow's RGBA -> `convert("RGB")` drops the alpha.

`irot`, `imir` and `clap` move no pixel: Pillow returns the decoded frame as coded (the orientation goes
to its EXIF info).  Forms the port does not decode raise UnsupportedImageFormat naming them (10- and
12-bit samples, grid items, other matrices, the AV1 tools av1_obu names); a file libavif refuses raises
ValueError.  One decoder serves both hosts.
"""

from __future__ import annotations

import struct
from types import SimpleNamespace
from typing import Callable

import numpy as np

from uniir_tpu_torch.data import av1_block, av1_filters, av1_obu, bmp, raster

BRANDS = (b"avif", b"avis", b"mif1", b"msf1")
_ALPHA_URNS = (b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha", b"urn:mpeg:hevc:2015:auxid:1")
_SIZE_LIMIT = 16384 * 16384  # libavif's default imageSizeLimit
_DIMENSION_LIMIT = 32768  # and imageDimensionLimit


class Malformed(ValueError):
    """What libavif reports as a BMFF parse failure, truncated data or an invalid ftyp: Pillow's plugin
    raises SyntaxError, so Image.open tries its next reader."""


def _unsupported(name: str, what: str):
    from uniir_tpu_torch.data.jpeg import UnsupportedImageFormat

    return UnsupportedImageFormat(f"{name}: AVIF {what} is not decoded")


def accepts(data: bytes) -> bool:
    """Pillow's AvifImagePlugin._accept: an `ftyp` box whose major brand is an AVIF or HEIF one."""
    return data[4:8] == b"ftyp" and data[8:12] in BRANDS


def _boxes(data: bytes, start: int, end: int, name: str):
    """(type, body start, body end, version, flags) of each box in data[start:end]."""
    pos = start
    while pos < end:
        if end - pos < 8:
            raise Malformed(f"{name}: AVIF box header cut short")
        size, kind = struct.unpack(">I4s", data[pos : pos + 8])
        head = 8
        if size == 1:
            if end - pos < 16:
                raise Malformed(f"{name}: AVIF box header cut short")
            size = struct.unpack(">Q", data[pos + 8 : pos + 16])[0]
            head = 16
        elif size == 0:
            size = end - pos
        if size < head or pos + size > end:
            raise Malformed(f"{name}: AVIF box '{kind.decode('latin-1')}' of {size} bytes cut short")
        yield kind, pos + head, pos + size
        pos += size


def _full(data: bytes, s: int, e: int, name: str, versions=None, kind: str = "full"):
    """(version, flags, payload start) of a full box; Malformed where its version is not among `versions`
    (libavif's avifROStreamReadAndEnforceVersion)."""
    if e - s < 4:
        raise Malformed(f"{name}: AVIF full box cut short")
    if versions is not None and data[s] not in versions:
        raise Malformed(f"{name}: AVIF {kind} box version {data[s]}")
    return data[s], int.from_bytes(data[s + 1 : s + 4], "big"), s + 4


class _Reader:
    def __init__(self, data, s, e, name):
        self.data, self.pos, self.end, self.name = data, s, e, name

    def u(self, n: int) -> int:
        if n == 0:
            return 0
        if self.pos + n > self.end:
            raise Malformed(f"{self.name}: AVIF box field cut short")
        v = int.from_bytes(self.data[self.pos : self.pos + n], "big")
        self.pos += n
        return v

    def string(self) -> bytes:
        z = self.data.find(b"\0", self.pos, self.end)
        if z < 0:
            raise Malformed(f"{self.name}: AVIF string without its terminator")
        v = self.data[self.pos : z]
        self.pos = z + 1
        return v


def _parse_meta(data, s, e, name) -> SimpleNamespace:
    _, _, s = _full(data, s, e, name, (0,), "meta")
    m = SimpleNamespace(primary=None, iloc={}, items={}, props=[], assoc={}, refs=[], idat=None)
    seen = set()
    first = True
    for kind, bs, be in _boxes(data, s, e, name):
        if first and kind != b"hdlr":
            raise Malformed(f"{name}: AVIF meta's first box is not hdlr")
        if kind in seen and kind in (b"hdlr", b"pitm", b"iloc", b"iinf", b"iprp", b"iref", b"idat"):
            raise Malformed(f"{name}: AVIF meta holds two {kind.decode()} boxes")
        seen.add(kind)
        first = False
        if kind == b"hdlr":
            _, _, p = _full(data, bs, be, name, (0,), "hdlr")
            if be - p < 20 or data[p : p + 4] != bytes(4) or data[p + 4 : p + 8] != b"pict":
                raise Malformed(f"{name}: AVIF meta handler is not pict (or its pre_defined is not 0)")
            _Reader(data, p + 20, be, name).string()  # the handler's name, null-terminated
        elif kind == b"pitm":
            v, _, p = _full(data, bs, be, name, (0, 1), "pitm")
            m.primary = _Reader(data, p, be, name).u(2 if v == 0 else 4)
        elif kind == b"iloc":
            _parse_iloc(data, bs, be, name, m)
        elif kind == b"iinf":
            v, _, p = _full(data, bs, be, name, (0, 1), "iinf")
            r = _Reader(data, p, be, name)
            count = r.u(2 if v == 0 else 4)
            entries = list(_boxes(data, r.pos, be, name))
            if len(entries) < count:
                raise Malformed(f"{name}: AVIF iinf names {count} items and holds {len(entries)}")
            for ik, ibs, ibe in entries[:count]:
                if ik != b"infe":
                    raise Malformed(f"{name}: AVIF iinf holds a {ik!r} box")
                iv, flags, ip = _full(data, ibs, ibe, name, (2, 3), "infe")
                ir = _Reader(data, ip, ibe, name)
                item = ir.u(2 if iv == 2 else 4)
                if not item:
                    raise Malformed(f"{name}: AVIF infe names item 0")
                ir.u(2)
                item_type = ir.u(4).to_bytes(4, "big")
                ir.string()  # item_name
                if item_type == b"mime":
                    ir.string()  # content_type
                m.items[item] = SimpleNamespace(type=item_type, hidden=flags & 1)
        elif kind == b"iprp":
            _parse_iprp(data, bs, be, name, m)
        elif kind == b"iref":
            v, _, p = _full(data, bs, be, name)  # version 0: 16-bit item IDs, 1: 32-bit, other: passed over
            for rk, rbs, rbe in _boxes(data, p, be, name) if v in (0, 1) else ():
                r = _Reader(data, rbs, rbe, name)
                n = 2 if v == 0 else 4
                src, count = r.u(n), r.u(2)
                if not src or not count:
                    raise Malformed(f"{name}: AVIF iref {rk!r} from item {src} to {count} items")
                for _ in range(count):
                    dst = r.u(n)
                    if not dst:
                        raise Malformed(f"{name}: AVIF iref {rk!r} to item 0")
                    m.refs.append((rk, src, dst))
        elif kind == b"idat":
            m.idat = (bs, be)
    if b"hdlr" not in seen:
        raise Malformed(f"{name}: AVIF meta without hdlr")
    return m


def _parse_iloc(data, s, e, name, m):
    v, _, p = _full(data, s, e, name, (0, 1, 2), "iloc")
    r = _Reader(data, p, e, name)
    b = r.u(1)
    off_size, len_size = b >> 4, b & 15
    b = r.u(1)
    base_size, index_size = b >> 4, (b & 15) if v in (1, 2) else 0
    for size in (off_size, len_size, base_size, index_size):
        if size not in (0, 4, 8):
            raise Malformed(f"{name}: AVIF iloc field size {size}")
    count = r.u(2 if v < 2 else 4)
    for _ in range(count):
        item = r.u(2 if v < 2 else 4)
        if not item:
            raise Malformed(f"{name}: AVIF iloc names item 0")
        method = r.u(2) & 15 if v in (1, 2) else 0
        r.u(2)  # data_reference_index
        base = r.u(base_size)
        extents = []
        for _ in range(r.u(2)):
            r.u(index_size)
            extents.append((base + r.u(off_size), r.u(len_size)))
        if item in m.iloc:
            raise Malformed(f"{name}: AVIF iloc names item {item} twice")
        m.iloc[item] = (method, extents)


def _parse_iprp(data, s, e, name, m):
    for kind, bs, be in _boxes(data, s, e, name):
        if kind == b"ipco":
            for pk, pbs, pbe in _boxes(data, bs, be, name):
                m.props.append(_property(data, pk, pbs, pbe, name))
        elif kind == b"ipma":
            v, flags, p = _full(data, bs, be, name, (0, 1), "ipma")
            r = _Reader(data, p, be, name)
            for _ in range(r.u(4)):
                item = r.u(2 if v < 1 else 4)
                assoc = []
                for _ in range(r.u(1)):
                    if flags & 1:
                        x = r.u(2)
                        assoc.append((x & 0x7FFF, x >> 15))
                    else:
                        x = r.u(1)
                        assoc.append((x & 0x7F, x >> 7))
                if item in m.assoc:
                    raise Malformed(f"{name}: AVIF ipma names item {item} twice")
                for index, _ in assoc:
                    if index > len(m.props):
                        raise Malformed(f"{name}: AVIF ipma names property {index} of {len(m.props)}")
                m.assoc[item] = assoc
            if r.pos != be:
                raise Malformed(f"{name}: AVIF ipma holds {be - r.pos} bytes past its entries")


def _property(data, kind, s, e, name):
    p = SimpleNamespace(kind=kind)
    r = _Reader(data, s, e, name)
    if kind in (b"ispe", b"pixi", b"auxC"):
        _full(data, s, e, name, (0,), kind.decode())
    if kind == b"ispe":
        r.u(4)
        p.width, p.height = r.u(4), r.u(4)
    elif kind == b"pixi":
        r.u(4)
        p.depths = [r.u(1) for _ in range(r.u(1))]
    elif kind == b"av1C":
        b = r.u(1)
        if b >> 7 != 1 or b & 0x7F != 1:
            raise Malformed(f"{name}: AVIF av1C marker / version {b:#x}")
        b = r.u(1)
        p.profile, p.level = b >> 5, b & 31
        b = r.u(1)
        p.tier, p.high_bitdepth, p.twelve_bit, p.mono = b >> 7, b >> 6 & 1, b >> 5 & 1, b >> 4 & 1
        p.ss_x, p.ss_y, p.csp = b >> 3 & 1, b >> 2 & 1, b & 3
        r.u(1)
    elif kind == b"colr":
        p.colour_type = r.u(4).to_bytes(4, "big")
        if p.colour_type == b"nclx":
            p.primaries, p.transfer, p.matrix = r.u(2), r.u(2), r.u(2)
            b = r.u(1)
            if b & 0x7F:
                raise Malformed(f"{name}: AVIF colr nclx reserved bits {b & 0x7F:#x}")
            p.full_range = b >> 7
    elif kind == b"auxC":
        r.u(4)
        p.urn = r.string()
    elif kind == b"irot":
        p.angle = r.u(1) & 3
    elif kind == b"imir":
        p.axis = r.u(1) & 1
    elif kind == b"clap":
        p.values = [r.u(4) for _ in range(8)]
    return p


_KNOWN = (b"ispe", b"av1C", b"pixi", b"colr", b"auxC", b"clap", b"irot", b"imir", b"pasp", b"a1op", b"lsel",
          b"a1lx", b"clli", b"mdcv", b"cclv", b"amve", b"tmap", b"altt", b"reve", b"ndwt")
_TRANSFORMS = (b"clap", b"irot", b"imir")


def _item_props(m, item, name) -> dict:
    """The item's properties by type, the first of each (an ICC colr under "colr-icc"); Malformed where
    libavif's parse fails (a property index past ipco, a transformative property not marked essential),
    ValueError for an essential property libavif does not know (it drops the item)."""
    out = {}
    for index, essential in m.assoc.get(item, []):
        if index == 0:
            continue
        if index > len(m.props):
            raise Malformed(f"{name}: AVIF ipma names property {index} of {len(m.props)}")
        prop = m.props[index - 1]
        if prop.kind in _TRANSFORMS and not essential:
            raise Malformed(f"{name}: AVIF item {item}'s {prop.kind.decode()} property is not marked essential")
        if essential and prop.kind not in _KNOWN:
            raise ValueError(f"{name}: AVIF item {item} has an essential {prop.kind!r} property (missing or empty "
                             "image item)")
        if prop.kind == b"colr" and getattr(prop, "colour_type", None) != b"nclx":
            out.setdefault(b"colr-icc", prop)
            continue
        out.setdefault(prop.kind, prop)
    return out


def _item_bytes(data, m, item, name) -> bytes:
    if item not in m.iloc:
        raise ValueError(f"{name}: AVIF item {item} has no location")
    method, extents = m.iloc[item]
    if method == 2:
        raise ValueError(f"{name}: AVIF iloc construction method 2")
    if method == 1:
        if m.idat is None:
            raise ValueError(f"{name}: AVIF item {item} in an absent idat")
        base, end = m.idat
    else:
        base, end = 0, len(data)
    out = b""
    for off, length in extents:
        if length == 0:
            length = end - base - off
        if off < 0 or base + off + length > end or length < 0:
            raise Malformed(f"{name}: AVIF item {item} extent past the end of the file (truncated)")
        out += data[base + off : base + off + length]
    return out


def _tracks(data, s, e, name) -> list:
    """The tracks of `moov`: each one's boxes by type (its `found`), track ID, references by type and the
    fault of its sample tables (None); what libavif checks of the boxes it reads (versions, sizes, the sample
    tables' sense)."""
    tracks = []
    for kind, bs, be in _boxes(data, s, e, name):
        if kind != b"trak":
            continue
        found = {}
        edts = []

        def walk(a, b):
            for k, cs, ce in _boxes(data, a, b, name):
                if k == b"edts":
                    edts.append((cs, ce))
                if k in (b"mdia", b"minf", b"stbl", b"edts"):
                    walk(cs, ce)
                elif k in (b"tkhd", b"mdhd", b"hdlr", b"stsd", b"stco", b"co64", b"stsz", b"stsc", b"stts", b"stss",
                           b"elst", b"tref"):
                    found[k] = (cs, ce)

        walk(bs, be)
        if edts and b"elst" not in found:
            raise Malformed(f"{name}: AVIF edts without elst")
        for k, versions in ((b"tkhd", (0, 1)), (b"mdhd", (0, 1)), (b"elst", (0, 1)), (b"stsd", (0, 1)),
                            (b"hdlr", (0,)), (b"stts", (0,)), (b"stsc", (0,)), (b"stsz", (0,)), (b"stco", (0,)),
                            (b"co64", (0,)), (b"stss", (0,))):
            if k in found:
                _full(data, *found[k], name, versions, k.decode())
        for need in (b"tkhd", b"mdhd", b"stsd", b"stsz", b"stsc"):
            if need not in found:
                raise Malformed(f"{name}: AVIF track without {need.decode()}")
        v, _, p = _full(data, *found[b"mdhd"], name)
        if not _Reader(data, p + (16 if v == 1 else 8), found[b"mdhd"][1], name).u(4):
            raise Malformed(f"{name}: AVIF track of time scale 0")
        error = _check_sample_tables(data, found, name)
        v, _, p = _full(data, *found[b"tkhd"], name)
        track_id = _Reader(data, p + (16 if v == 1 else 8), found[b"tkhd"][1], name).u(4)
        if not track_id:
            raise Malformed(f"{name}: AVIF track ID 0")
        refs = {}
        if b"tref" in found:
            for k, cs, ce in _boxes(data, *found[b"tref"], name):
                refs[k] = [int.from_bytes(data[i : i + 4], "big") for i in range(cs, ce - 3, 4)]
        if b"hdlr" in found:
            _, _, p = _full(data, *found[b"hdlr"], name)
            if data[p : p + 4] != bytes(4):
                raise Malformed(f"{name}: AVIF track handler's pre_defined is not 0")
            _Reader(data, p + 20, found[b"hdlr"][1], name).string()  # the handler's name, null-terminated
        tracks.append(SimpleNamespace(found=found, id=track_id, refs=refs, error=error))
    return tracks


def _first_sample(data, found, name):
    """(av1C, nclx colr or None, first sample's bytes, width, height (tkhd's)) of a track."""
    v, _, p = _full(data, *found[b"tkhd"], name)
    r = _Reader(data, p + (84 if v == 1 else 72), found[b"tkhd"][1], name)
    width, height = r.u(4) >> 16, r.u(4) >> 16
    _, _, p = _full(data, *found[b"stsd"], name)
    entries = list(_boxes(data, p + 4, found[b"stsd"][1], name))
    if not entries or entries[0][0] != b"av01":
        raise ValueError(f"{name}: AVIF track's sample entry is not av01")
    _, es, ee = entries[0]
    av1c = colr = None
    for k, cs, ce in _boxes(data, es + 78, ee, name):
        if k == b"av1C" and av1c is None:
            av1c = _property(data, k, cs, ce, name)
        elif k == b"colr" and colr is None:
            colr = _property(data, k, cs, ce, name)
            colr = colr if colr.colour_type == b"nclx" else None
    if av1c is None:
        raise Malformed(f"{name}: AVIF track without av1C")
    _, _, p = _full(data, *found[b"stsz"], name)
    r = _Reader(data, p, found[b"stsz"][1], name)
    uniform, count = r.u(4), r.u(4)
    if count == 0:
        raise ValueError(f"{name}: AVIF track without samples")
    sizes = [uniform] * count if uniform else [r.u(4) for _ in range(count)]
    kind = b"stco" if b"stco" in found else b"co64" if b"co64" in found else None
    if kind is None:
        raise Malformed(f"{name}: AVIF track without stco")
    _, _, p = _full(data, *found[kind], name)
    r = _Reader(data, p, found[kind][1], name)
    chunks = [r.u(4 if kind == b"stco" else 8) for _ in range(r.u(4))]
    _, _, p = _full(data, *found[b"stsc"], name)
    r = _Reader(data, p, found[b"stsc"][1], name)
    runs = [(r.u(4), r.u(4), r.u(4)) for _ in range(r.u(4))]
    # every sample's extent (libavif checks them all at parse): chunk k holds the samples its stsc run gives
    offsets, sample = [], 0
    for k, chunk in enumerate(chunks):
        per = next((n for first, n, _ in reversed(runs) if first <= k + 1), 0)
        at = chunk
        for _ in range(per):
            if sample == count:
                break
            offsets.append(at)
            at += sizes[sample]
            sample += 1
    if not offsets:
        raise Malformed(f"{name}: AVIF track without chunks")
    for at, size in zip(offsets, sizes):
        if at + size > len(data):
            raise Malformed(f"{name}: AVIF sample past the end of the file (truncated)")
    return av1c, colr, data[offsets[0] : offsets[0] + sizes[0]], width, height


def _track_info(data, s, e, name) -> SimpleNamespace:
    """`parse`'s info from an `avis` file's tracks, as libavif's AUTO source reads them: the first colour track
    (no `auxl` reference) and the auxiliary track that references it, `prem` from the colour track's
    references."""
    tracks = _tracks(data, s, e, name)
    colour = next((t for t in tracks if b"auxl" not in t.refs), None)
    if colour is None:
        raise Malformed(f"{name}: AVIF moov without a colour track")
    if colour.error is not None:
        raise colour.error
    info = SimpleNamespace(alpha=None, premultiplied=False, item_pixi=None)
    info.av1c, info.colr, info.payload, info.width, info.height = _first_sample(data, colour.found, name)
    alpha = next((t for t in tracks if colour.id in t.refs.get(b"auxl", ())), None)
    if alpha is not None and alpha.error is None:
        try:  # an alpha track libavif cannot read a sample of is passed over
            info.alpha = _first_sample(data, alpha.found, name)[2]
        except ValueError:
            return info
        info.premultiplied = alpha.id in colour.refs.get(b"prem", ())
    return info


def _check_sample_tables(data, found, name):
    """What libavif checks of a track's sample tables: each table's entries fit its box, stsc's first chunks
    start at 1 and rise with samples in each, one stsd entry at least (Malformed raised); and the fault
    that fails a colour track but only drops an alpha one, the chunks holding other than stsz's samples
    (returned, else None)."""
    def table(kind, width, skip=0):
        if kind not in found:
            return []
        _, _, p = _full(data, *found[kind], name)
        r = _Reader(data, p + skip, found[kind][1], name)
        count = r.u(4)
        if count * width > found[kind][1] - r.pos:
            raise Malformed(f"{name}: AVIF {kind.decode()} of {count} entries cut short")
        return [[r.u(4) for _ in range(width // 4)] for _ in range(count)]

    table(b"stts", 8)
    runs = table(b"stsc", 12)
    if not runs or runs[0][0] != 1 or any(b[0] <= a[0] for a, b in zip(runs, runs[1:])) or \
            any(c[1] == 0 for c in runs):
        raise Malformed(f"{name}: AVIF stsc entries {runs[:4]}")
    chunks = len(table(b"stco", 4) or table(b"co64", 8))
    table(b"stss", 4)
    if b"elst" in found:
        v, _, _ = _full(data, *found[b"elst"], name)
        edits = table(b"elst", 20 if v == 1 else 12)
        duration = (edits[0][0] << 32 | edits[0][1]) if v == 1 and edits else edits[0][0] if edits else 0
        if len(edits) != 1 or not duration:
            raise Malformed(f"{name}: AVIF elst of other than one edit of some duration")
    _, _, p = _full(data, *found[b"stsd"], name)
    count = _Reader(data, p, found[b"stsd"][1], name).u(4)
    if count == 0 or len(list(_boxes(data, p + 4, found[b"stsd"][1], name))) < count:
        raise Malformed(f"{name}: AVIF stsd of {count} entries")
    # the samples the chunks hold, by stsc's runs, are the samples stsz sizes
    _, _, p = _full(data, *found[b"stsz"], name)
    r = _Reader(data, p, found[b"stsz"][1], name)
    r.u(4)
    sizes = r.u(4)
    held = sum(next(n for first, n, _ in reversed(runs) if first <= k + 1) for k in range(chunks))
    if held != sizes:
        return Malformed(f"{name}: AVIF chunks hold {held} samples, stsz sizes {sizes}")
    return None


def parse(data: bytes, name: str = "<bytes>") -> SimpleNamespace:
    """What libavif's avifDecoderParse reads (and Pillow's _open from it): the colour item's (or track
    sample's) AV1 bytes, size, av1C, nclx colour, and the alpha item with its `prem` flag.  ValueError where
    libavif (so Image.open) fails."""
    ftyp = None
    meta = moov = None
    first = True
    for kind, s, e in _boxes(data, 0, len(data), name):
        if first and kind != b"ftyp":
            raise Malformed(f"{name}: AVIF file does not begin with ftyp")
        first = False
        if kind == b"ftyp":
            if e - s < 8 or (e - s) % 4:
                raise Malformed(f"{name}: AVIF ftyp of {e - s} bytes")
            ftyp = [data[s : s + 4]] + [data[i : i + 4] for i in range(s + 8, e, 4)]
        elif kind == b"meta":
            if meta is not None:
                raise Malformed(f"{name}: AVIF file holds two meta boxes")
            meta = _parse_meta(data, s, e, name)
        elif kind == b"moov":
            moov = (s, e)
        # libavif stops reading top-level boxes once it holds what the brands need (mdat is read by offset)
        if meta is not None and (b"avis" not in ftyp or moov is not None):
            break
    if ftyp is None or not (b"avif" in ftyp or b"avis" in ftyp):
        raise Malformed(f"{name}: AVIF ftyp has no avif / avis brand")
    if (b"avif" in ftyp and meta is None) or (b"avis" in ftyp and moov is None):
        raise Malformed(f"{name}: AVIF file without the meta / moov box its brands need")
    if b"avis" in ftyp:
        # libavif reads the tracks; of the items it checks the primary's ispe, its size's limits and (once
        # the track's frame is decoded) its pixi
        info = _check_size(_track_info(data, *moov, name), name)
        item = meta.items.get(meta.primary) if meta is not None else None
        try:
            props = _item_props(meta, meta.primary, name) if item is not None and item.type == b"av01" else None
        except Malformed:
            raise
        except ValueError:  # an unknown essential property: libavif passes the item over
            props = None
        if props is not None:
            if b"ispe" not in props:
                raise Malformed(f"{name}: AVIF item {meta.primary} lacks its mandatory ispe property")
            _check_size(SimpleNamespace(width=props[b"ispe"].width, height=props[b"ispe"].height), name)
            info.item_pixi = props.get(b"pixi")
        return info
    info = _item_info(data, meta, name) if meta is not None else None
    if info is None:
        raise ValueError(f"{name}: AVIF file without an image item or track")
    return info


def _item_info(data, meta, name) -> SimpleNamespace:
    """The primary item's info (what `parse` returns), read and checked as libavif reads a meta box (also
    where an `avis` file's track is decoded)."""
    info = SimpleNamespace(alpha=None, premultiplied=False)
    if meta.primary is None:
        raise ValueError(f"{name}: AVIF meta without pitm")
    item = meta.items.get(meta.primary)
    if item is None:
        raise ValueError(f"{name}: AVIF primary item {meta.primary} not in iinf")
    if item.type == b"grid":
        raise _unsupported(name, "grid image")
    if item.type != b"av01":
        raise ValueError(f"{name}: AVIF primary item is of type {item.type!r} (no AV1 item)")
    props = _item_props(meta, meta.primary, name)
    for need in (b"ispe", b"av1C"):
        if need not in props:
            raise Malformed(f"{name}: AVIF item {meta.primary} lacks its mandatory {need.decode()} property")
    info.width, info.height = props[b"ispe"].width, props[b"ispe"].height
    info.av1c, info.colr, info.item_pixi = props[b"av1C"], props.get(b"colr"), props.get(b"pixi")
    _check_depth(info.av1c, info.item_pixi, name)
    info.payload = _item_bytes(data, meta, meta.primary, name)
    for kind, src, dst in meta.refs:
        # libavif's alpha item: an av1 item of data with no unknown essential property, auxl to the colour
        # item, its auxC the alpha URN (others it passes over)
        if kind != b"auxl" or dst != meta.primary or src not in meta.items or meta.items[src].type != b"av01":
            continue
        try:
            aprops = _item_props(meta, src, name)
            alpha = _item_bytes(data, meta, src, name) if src in meta.iloc else b""
        except Malformed:
            raise
        except ValueError:
            continue
        if b"ispe" not in aprops or b"av1C" not in aprops:
            raise Malformed(f"{name}: AVIF auxiliary item {src} lacks ispe / av1C")
        if not alpha or b"auxC" not in aprops or aprops[b"auxC"].urn not in _ALPHA_URNS:
            continue
        if (aprops[b"ispe"].width, aprops[b"ispe"].height) != (info.width, info.height):
            raise ValueError(f"{name}: AVIF alpha item's size differs from the colour item's")
        _check_depth(aprops[b"av1C"], aprops.get(b"pixi"), name)
        info.alpha = alpha
        info.premultiplied = any(k == b"prem" and s_ == meta.primary and d == src for k, s_, d in meta.refs)
        break
    return _check_size(info, name)


def _check_size(info, name):
    w, h = info.width, info.height
    if not w or not h or w > _DIMENSION_LIMIT or h > _DIMENSION_LIMIT or w * h > _SIZE_LIMIT:
        raise ValueError(f"{name}: AVIF size {w} x {h} past libavif's limits")
    if w * h > bmp.MAX_PIXELS:
        raise ValueError(f"{name}: {w * h} pixels (decompression bomb)")
    return info


def open_header(data: bytes, name: str = "<bytes>") -> SimpleNamespace:
    """`parse` as Image.open sees it: raster.NotThisFormat where Pillow's plugin raises SyntaxError."""
    try:
        return parse(data, name)
    except Malformed as e:
        raise raster.NotThisFormat(str(e)) from e


def _check_depth(av1c, pixi, name: str):
    """libavif's check of an item's pixi against its av1C: one depth or more, each av1C's bit depth."""
    depth = 12 if av1c.twelve_bit and av1c.high_bitdepth else 10 if av1c.high_bitdepth else 8
    if pixi is not None and (not pixi.depths or any(d != depth for d in pixi.depths)):
        raise Malformed(f"{name}: AVIF pixi depths {pixi.depths} for av1C's {depth}-bit samples")


def decode_yuv(payload: bytes, name: str):
    """(sequence header, frame header, planes cut to the frame) of the first frame of `payload`."""
    seq, hdr, tiles = av1_obu.parse(payload, name)
    if seq.bit_depth != 8:
        raise _unsupported(name, f"{seq.bit_depth}-bit samples")
    frame = av1_block.decode_frame(seq, hdr, tiles, name)
    av1_filters.deblock(frame)
    av1_filters.cdef(frame)
    av1_filters.loop_restore(frame)
    planes = []
    for p, img in enumerate(frame.planes):
        sx = seq.ss_x if p else 0
        sy = seq.ss_y if p else 0
        planes.append(img[: (hdr.height + sy) >> sy, : (hdr.upscaled_width + sx) >> sx].astype(np.int64))
    return seq, hdr, planes


# libyuv's YuvConstants: (YG, YB, UB, UG, VG, VR) by matrix and range (row_common.cc, MAKEYUVCONSTANTS)
_JPEG = (16320, 32, 113, 22, 46, 90)
_I601 = (18997, -1160, 128, 25, 52, 102)
_F709 = (16320, 32, 119, 12, 30, 101)
_H709 = (18997, -1160, 128, 14, 34, 115)
_V2020 = (16320, 32, 120, 11, 37, 94)
_2020 = (19003, -1160, 128, 12, 42, 107)
# the other matrices libavif converts in its own float path (Pillow decodes them; the port refuses them by
# name), and the ones it cannot convert at all (Pillow fails)
_FLOAT_MATRICES = (4, 7, 8, 12, 15)
_CONSTANTS = {(1, 1): _F709, (1, 0): _H709, (2, 1): _JPEG, (2, 0): _I601, (5, 1): _JPEG, (5, 0): _I601,
              (6, 1): _JPEG, (6, 0): _I601, (9, 1): _V2020, (9, 0): _2020}


def _up_linear(s: np.ndarray, w: int) -> np.ndarray:
    """libyuv's ScaleRowUp2_Linear_Any on the last axis: [..., (w + 1) / 2] -> [..., w]."""
    out = np.empty(s.shape[:-1] + (w,), np.int64)
    out[..., 0] = s[..., 0]
    n = ((w - 1) & ~1) // 2
    if n:
        a, b = s[..., :n], s[..., 1 : n + 1]
        out[..., 1 : 2 * n + 1 : 2] = (3 * a + b + 2) >> 2
        out[..., 2 : 2 * n + 2 : 2] = (a + 3 * b + 2) >> 2
    out[..., w - 1] = s[..., (w - 1) // 2]
    return out


def _up_bilinear(s0: np.ndarray, s1: np.ndarray, w: int):
    """libyuv's ScaleRowUp2_Bilinear_Any: two chroma rows -> the two luma rows between them."""
    d = np.empty(s0.shape[:-1] + (w,), np.int64)
    e = np.empty_like(d)
    d[..., 0] = (3 * s0[..., 0] + s1[..., 0] + 2) >> 2
    e[..., 0] = (s0[..., 0] + 3 * s1[..., 0] + 2) >> 2
    n = ((w - 1) & ~1) // 2
    if n:
        a, b, c, f = s0[..., :n], s0[..., 1 : n + 1], s1[..., :n], s1[..., 1 : n + 1]
        d[..., 1 : 2 * n + 1 : 2] = (9 * a + 3 * b + 3 * c + f + 8) >> 4
        d[..., 2 : 2 * n + 2 : 2] = (3 * a + 9 * b + c + 3 * f + 8) >> 4
        e[..., 1 : 2 * n + 1 : 2] = (3 * a + b + 9 * c + 3 * f + 8) >> 4
        e[..., 2 : 2 * n + 2 : 2] = (a + 3 * b + 3 * c + 9 * f + 8) >> 4
    k = (w - 1) // 2
    d[..., w - 1] = (3 * s0[..., k] + s1[..., k] + 2) >> 2
    e[..., w - 1] = (s0[..., k] + 3 * s1[..., k] + 2) >> 2
    return d, e


def _up420(c: np.ndarray, h: int, w: int) -> np.ndarray:
    """I420ToARGBMatrixBilinear's chroma: the first and (for an even height) last rows linear, the rows
    between bilinear from the two chroma rows around them."""
    out = np.empty((h, w), np.int64)
    out[0] = _up_linear(c[0], w)
    rows = (h - 1) // 2
    if rows:
        d, e = _up_bilinear(c[:rows], c[1 : rows + 1], w)
        out[1 : 2 * rows + 1 : 2] = d
        out[2 : 2 * rows + 2 : 2] = e
    if h % 2 == 0:
        out[h - 1] = _up_linear(c[(h - 1) // 2], w)
    return out


def yuv_to_rgb(seq, y: np.ndarray, u, v, matrix: int, full: bool, name: str, rgba: bool = False) -> np.ndarray:
    """libavif's avifImageYUVToRGB for 8-bit samples as Pillow calls it (RGBA where the image has alpha,
    else RGB): uint8 [H, W, 3]."""
    h, w = y.shape
    if matrix not in (0, 1, 2, 5, 6, 9) + _FLOAT_MATRICES or (matrix == 8 and not full):
        raise ValueError(f"{name}: AVIF matrix_coefficients {matrix} (libavif: conversion from YUV failed)")
    if seq.num_planes == 1 and (not rgba or (matrix, int(full)) not in _CONSTANTS):
        # libyuv has no grey -> RGB24 row: libavif's own grey path (avifImageYUV8ToRGB8Mono), in float32
        bias, span = (0, 255) if full else (16, 219)
        unorm = (y.astype(np.float32) - np.float32(bias)) / np.float32(span)
        g = (np.float32(0.5) + np.clip(unorm, np.float32(0), np.float32(1)) * np.float32(255)).astype(np.uint8)
        return np.stack([g, g, g], -1)
    if matrix == 0:
        if seq.num_planes == 1 or seq.ss_x or seq.ss_y:
            raise ValueError(f"{name}: AVIF identity matrix on subsampled or grey samples")
        if not full:
            raise _unsupported(name, "identity matrix in limited range")
        return np.stack([v, y, u], -1).astype(np.uint8)
    if (matrix, int(full)) not in _CONSTANTS:
        if matrix in _FLOAT_MATRICES and not (matrix == 8 and not full):
            raise _unsupported(name, f"matrix_coefficients {matrix}")
        raise ValueError(f"{name}: AVIF matrix_coefficients {matrix} (libavif: conversion from YUV failed)")
    yg, yb, ub, ug, vg, vr = _CONSTANTS[(matrix, int(full))]
    y1 = ((y * 0x0101) * yg) >> 16
    if seq.num_planes == 1:  # I400ToARGBMatrix
        g = np.clip((y1 + yb) >> 6, 0, 255).astype(np.uint8)
        return np.stack([g, g, g], -1)
    if seq.ss_x and seq.ss_y:
        u, v = _up420(u, h, w), _up420(v, h, w)
    elif seq.ss_x:
        u, v = _up_linear(u, w), _up_linear(v, w)
    b = (y1 + ub * (u - 128) + yb) >> 6
    g = (y1 - ug * (u - 128) - vg * (v - 128) + yb) >> 6
    r = (y1 + vr * (v - 128) + yb) >> 6
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _unattenuate(rgb: np.ndarray, alpha: np.ndarray) -> np.ndarray:
    """libyuv's ARGBUnattenuateRow as its x86 SIMD rows compute it: each colour (widened to 16 bits,
    c * 257) times the 8.8 fixed-point inverse of its alpha (fixed_invtbl8), the high 16 bits, clamped."""
    a = alpha.astype(np.int64)
    inv = np.where(a >= 2, (0x10000 // np.maximum(a, 1)) & 0xFFFF, np.where(a == 1, 0xFFFF, 0))
    inv = np.where(a == 255, 0x100, inv)  # the table's last entry is 1.0
    v = (rgb.astype(np.int64) * 257 * inv[..., None]) >> 16
    # the x86 rows pack the 16-bit products as signed words: 32768 and above saturate to 0, not 255
    return np.where(v > 32767, 0, np.minimum(v, 255)).astype(np.uint8)


def decode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """uint8 [H, W, 3] of an AVIF file, equal to `Image.open(...).convert("RGB")`."""
    info = parse(data, name)
    seq, hdr, planes = decode_yuv(info.payload, name)
    pixi = info.item_pixi
    if pixi is not None and (not pixi.depths or any(d != seq.bit_depth for d in pixi.depths)):
        raise ValueError(f"{name}: AVIF pixi depths {pixi.depths} for {seq.bit_depth}-bit samples")
    if (hdr.upscaled_width, hdr.height) != (info.width, info.height):
        raise _unsupported(name, f"item of {info.width} x {info.height} holding a {hdr.upscaled_width} x "
                                 f"{hdr.height} AV1 frame")
    colr = info.colr
    if colr is not None:
        matrix, full = colr.matrix, bool(colr.full_range)
    else:
        matrix, full = seq.matrix, bool(seq.color_range)
    y = planes[0]
    u, v = (planes[1], planes[2]) if seq.num_planes == 3 else (None, None)
    rgb = yuv_to_rgb(seq, y, u, v, matrix, full, name, rgba=info.alpha is not None)
    if info.alpha is not None:
        _, ahdr, aplanes = decode_yuv(info.alpha, name)
        if (ahdr.upscaled_width, ahdr.height) != (info.width, info.height):
            raise _unsupported(name, f"alpha frame of {ahdr.upscaled_width} x {ahdr.height} in an image of "
                                     f"{info.width} x {info.height}")
        if info.premultiplied:
            rgb = _unattenuate(rgb, aplanes[0])
    return rgb


def decoder_for(device) -> Callable[[bytes, str], np.ndarray]:
    """The one decoder both hosts run (numpy)."""
    return decode
