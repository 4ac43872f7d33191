"""JPEG 2000 decoding with Pillow's pixels, without Pillow.

The JAX package reads every image with `PIL.Image.open(path).convert("RGB")`.  Pillow 12.1 opens a
JPEG 2000 file (a J2K codestream or a JP2 file) through OpenJPEG 2.5.4, tile by tile, and unpacks each
tile into the image mode its plugin chose.  This module gives the same uint8 [H, W, 3] array, bit for bit:

  * Pillow's `_open`: a codestream (FF4F FF51) takes its size from SIZ (Xsiz - XOsiz, Ysiz - YOsiz) and its
    mode from Csiz (1: L, or I;16 past 8 bits; 2: LA; 3: RGB; 4: RGBA); a JP2 file is walked box by box to
    `jp2h`, whose `ihdr` gives size and mode, a `colr` of enumerated space 12 on four components CMYK, and
    a `pclr` on L / LA of at most 8-bit entries P / PA with the palette Pillow builds from it (`getcolor`,
    which merges equal entries); what makes `_open` raise SyntaxError / struct.error / IndexError makes
    Image.open try its next reader (raster.NotThisFormat); the decompression-bomb limit on the size;
  * OpenJPEG's reading of the JP2 boxes (signature, file type, header with `ihdr`, `colr` method 1 / 2,
    `bpcc`, `pclr`, `cmap`, `cdef`, then `jp2c`) and of the codestream: SIZ (its size equal to ihdr's),
    COD / COC, QCD / QCC, RGN, POC, PPM, TLM, PLM, CRG and COM in the main header, unknown markers
    skipped as OpenJPEG skips them; tile-parts (SOT, their COD / COC / QCD / QCC / RGN / POC / PPT / PLT /
    COM, SOD), a tile decoded once its last tile-part is read, the next two bytes then SOT or EOC;
    anything OpenJPEG refuses raises ValueError (Pillow's "broken data stream");
  * each tile through tier 2 and tier 1, dequantisation, the inverse DWT, the component transform and the
    level shift (`j2k_t2`, `j2k_t1`, `j2k_dwt`);
  * Pillow's unpackers (Jpeg2KDecode.c): each sample shifted to 8 bits (16 for I;16) with its rounding
    offset and the signed offset, stored in a byte (so an overflow wraps), subsampled components read
    with Pillow's strides from the buffer OpenJPEG fills, the colour space from `colr` (sRGB, grey,
    sYCC through Pillow's YCbCr table, CMYK, unknown as unspecified: grey or sRGB by component count),
    a combination with no unpacker refused; then `convert("RGB")`: L / LA replicated, P / PA through the
    palette, CMYK by Convert.c's cmyk2rgb, I;16 clipped at 255.

High-throughput code-blocks (Part 15: a CAP marker or the HT style bit) and Part 2's multi-component
transforms and component bit depths (MCT, MCC, MCO, CBD markers) raise UnsupportedImageFormat naming them.

Two decoders compute that function: `decode_twin`, plain Python and numpy, and `decode_native`, host C++
in `csrc/jpeg2000.cu` built by `_build` like the kernels and fed the plan this module parses, one call an
image, which releases the GIL so the loader's threads decode in parallel.  `decoder_for(device)` picks one
by the run's device, as `data.png` does.
"""

from __future__ import annotations

import copy
import ctypes
import struct
import threading
from typing import Callable, NamedTuple

import numpy as np

from uniir_tpu_torch.data import bmp, im, j2k_t2, raster

J2K_SIGNATURE = b"\xff\x4f\xff\x51"
JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"
MAX_RESOLUTIONS, MAX_BANDS = 33, 97
SOC, SOT, SOD, EOC = 0xFF4F, 0xFF90, 0xFF93, 0xFFD9
SIZ, COD, COC, RGN, QCD, QCC, POC = 0xFF51, 0xFF52, 0xFF53, 0xFF5E, 0xFF5C, 0xFF5D, 0xFF5F
TLM, PLM, PLT, PPM, PPT, SOP, CRG, COM = 0xFF55, 0xFF57, 0xFF58, 0xFF60, 0xFF61, 0xFF91, 0xFF63, 0xFF64
CAP, CPF, CBD, MCT, MCC, MCO = 0xFF50, 0xFF59, 0xFF78, 0xFF74, 0xFF75, 0xFF77
MH, TPH, TPHSOT = 1, 2, 4  # the decoder's states a marker may appear in
MARKER_STATES = {SOT: MH | TPHSOT, COD: MH | TPH, COC: MH | TPH, RGN: MH | TPH, QCD: MH | TPH, QCC: MH | TPH,
                 POC: MH | TPH, SIZ: 0, TLM: MH, PLM: MH, PLT: TPH, PPM: MH, PPT: TPH, SOP: 0, CRG: MH,
                 COM: MH | TPH, MCT: MH | TPH, CBD: MH, CAP: MH, CPF: MH, MCC: MH | TPH, MCO: MH | TPH}
# OpenJPEG's colour spaces, as opj_jp2_read_header maps colr's enumerated space
UNSPECIFIED, SRGB, GRAY, SYCC, EYCC, CMYK = 0, 1, 2, 3, 4, 5
ENUMCS = {16: SRGB, 17: GRAY, 18: SYCC, 24: EYCC, 12: CMYK}
# Jpeg2KDecode.c's j2k_unpackers: (mode, colour space, components) -> (unpacker, takes subsampling)
UNPACKERS = {
    ("L", GRAY, 1): ("gray_l", 0), ("P", SRGB, 1): ("gray_l", 0), ("PA", SRGB, 2): ("graya_la", 0),
    ("I;16", GRAY, 1): ("gray_i", 0), ("LA", GRAY, 2): ("graya_la", 0), ("RGB", GRAY, 1): ("gray_rgb", 0),
    ("RGB", GRAY, 2): ("gray_rgb", 0), ("RGB", SRGB, 3): ("srgb_rgb", 1), ("RGB", SYCC, 3): ("sycc_rgb", 1),
    ("RGB", SRGB, 4): ("srgb_rgb", 1), ("RGB", SYCC, 4): ("sycc_rgb", 1), ("RGBA", GRAY, 1): ("gray_rgb", 0),
    ("RGBA", GRAY, 2): ("graya_la", 0), ("RGBA", SRGB, 3): ("srgb_rgb", 1), ("RGBA", SYCC, 3): ("sycc_rgb", 1),
    ("RGBA", GRAY, 4): ("srgba_rgba", 1), ("RGBA", SRGB, 4): ("srgba_rgba", 1),
    ("RGBA", SYCC, 4): ("sycca_rgba", 1), ("CMYK", CMYK, 4): ("srgba_rgba", 1),
}
UNPACKER_CODES = {"gray_l": 0, "gray_i": 1, "gray_rgb": 2, "graya_la": 3, "srgb_rgb": 4, "sycc_rgb": 5,
                  "srgba_rgba": 6, "sycca_rgba": 7}


class Unsupported(ValueError):
    """A JPEG 2000 form the port does not decode (HT code-blocks, Part 2 transforms)."""


def accepts(data: bytes) -> bool:
    """Pillow's `Jpeg2KImagePlugin._accept`."""
    return data[:4] == J2K_SIGNATURE or data[:12] == JP2_SIGNATURE


# --- Pillow's _open ---------------------------------------------------------------------------------


class _Reader:
    """Pillow's BoxReader over bytes: `pos` is the file position, `length` -1 for a file of unknown length
    (the outer reader), `remaining` -1 outside a box."""

    def __init__(self, data: bytes, pos: int, length: int):
        self.data, self.pos, self.length, self.remaining = data, pos, length, -1
        self.base = pos

    def _can_read(self, n: int) -> bool:
        if self.length >= 0 and self.pos - self.base + n > self.length:
            return False
        return n <= self.remaining if self.remaining >= 0 else True

    def read(self, n: int) -> bytes:
        if not self._can_read(n):
            raise raster.NotThisFormat("Not enough data in header")
        out = self.data[self.pos : self.pos + n]
        if len(out) < n:
            raise ValueError(f"Expected to read {n} bytes but only got {len(out)}.")
        self.pos += n
        if self.remaining > 0:
            self.remaining -= n
        return out

    def fields(self, fmt: str) -> tuple:
        return struct.unpack(fmt, self.read(struct.calcsize(fmt)))

    def sub(self) -> "_Reader":
        n = self.remaining
        self.read(n)
        return _Reader(self.data, self.pos - n, n)

    def has_next(self) -> bool:
        return self.pos - self.base + self.remaining < self.length if self.length >= 0 else True

    def next_type(self) -> bytes:
        if self.remaining > 0:
            self.pos += self.remaining
        self.remaining = -1
        lbox, tbox = self.fields(">I4s")
        hlen = 8
        if lbox == 1:
            lbox = self.fields(">Q")[0]
            hlen = 16
        if lbox < hlen or not self._can_read(lbox - hlen):
            raise raster.NotThisFormat("Invalid header length")
        self.remaining = lbox - hlen
        return tbox


class Palette(NamedTuple):
    """A P / PA image's palette as Pillow holds it: its mode and raw bytes (getcolor's)."""

    mode: str
    raw: bytes


def _getcolor_palette(mode: str, colours: list) -> Palette:
    """ImagePalette.getcolor over `colours` in order, on a fresh palette of `mode` (RGB or RGBA): a colour
    already held keeps its index, a new one takes index len(palette) // len(mode)."""
    raw = bytearray()
    seen = {}
    size = len(mode)
    for colour in colours:
        colour = tuple(colour)
        if mode == "RGB" and len(colour) == 4:
            if colour[3] != 255:
                raise ValueError("cannot add non-opaque RGBA color to RGB palette")
            colour = colour[:3]
        elif mode == "RGBA" and len(colour) == 3:
            colour += (255,)
        if colour in seen:
            continue
        index = len(raw) // size
        if index >= 256:
            raise ValueError("cannot allocate more than 256 colors")
        seen[colour] = index
        if index * size < len(raw):
            raw = raw[: index * size] + bytes(colour) + raw[index * size + size :]
        else:
            raw += bytes(colour)
    return Palette(mode, bytes(raw))


class Header(NamedTuple):
    """What Pillow's `_open` found: the codec, size, mode, palette and `info["comment"]` (or None)."""

    codec: str
    width: int
    height: int
    mode: str
    palette: Palette | None
    comment: bytes | None = None


def _parse_comment(data: bytes, pos: int):
    """Jpeg2KImageFile._parse_comment: the first COM segment's text after its Rcom, or None; raises
    raster.NotThisFormat where it raises IndexError / struct.error (Image.open tries the next reader)."""
    while True:
        marker = data[pos : pos + 2]
        pos += len(marker)
        if not marker:
            return None
        if len(marker) < 2:
            raise raster.NotThisFormat("marker cut short")
        if marker[1] in (0x90, 0xD9):
            return None
        hdr = data[pos : pos + 2]
        pos += len(hdr)
        if len(hdr) < 2:
            raise raster.NotThisFormat("marker length cut short")
        length = hdr[0] << 8 | hdr[1]
        if marker[1] == 0x64:
            return data[pos : pos + length - 2 if length >= 2 else len(data)][2:]
        pos = max(pos + length - 2, 0)


def open_header(data: bytes, name: str = "<bytes>") -> Header:
    """Jpeg2KImageFile._open and Image.open's decompression bomb check."""
    if data[:4] == J2K_SIGNATURE:
        hdr = data[4:6]
        if len(hdr) < 2:
            raise raster.NotThisFormat(f"{name}: SIZ cut short")
        lsiz = hdr[0] << 8 | hdr[1]
        end = 4 + lsiz if lsiz >= 2 else len(data)  # fp.read(lsiz - 2) reads to the end when negative
        siz = hdr + data[6:end]
        if len(siz) < 38:
            raise raster.NotThisFormat(f"{name}: SIZ cut short")
        _, _, xsiz, ysiz, xosiz, yosiz, _, _, _, _, csiz = struct.unpack_from(">HHIIIIIIIIH", siz)
        width, height = xsiz - xosiz, ysiz - yosiz
        if csiz == 1:
            if len(siz) < 39:
                raise raster.NotThisFormat(f"{name}: SIZ cut short")
            mode = "I;16" if (siz[38] & 0x7F) + 1 > 8 else "L"
        elif csiz in (2, 3, 4):
            mode = {2: "LA", 3: "RGB", 4: "RGBA"}[csiz]
        else:
            raise raster.NotThisFormat(f"{name}: unable to determine J2K image mode")
        header = Header("j2k", width, height, mode, None, _parse_comment(data, end))
    elif data[:12] == JP2_SIGNATURE:
        after, header = _parse_jp2_header(data, name)
        if data[after : after + 12].endswith(b"jp2c\xff\x4f\xff\x51"):
            hdr = data[after + 12 : after + 14]
            if len(hdr) < 2:
                raise raster.NotThisFormat(f"{name}: SIZ length cut short")
            header = header._replace(comment=_parse_comment(data, after + 12 + (hdr[0] << 8 | hdr[1])))
    else:
        raise raster.NotThisFormat(f"{name}: not a JPEG 2000 file")
    if header.width <= 0 or header.height <= 0:
        raise raster.NotThisFormat(f"{name}: JPEG 2000 size {header.width} x {header.height} (not identified)")
    if header.width * header.height > bmp.MAX_PIXELS:
        raise ValueError(f"{name}: {header.width * header.height} pixels (decompression bomb)")
    return header


def _parse_jp2_header(data: bytes, name: str):
    """_parse_jp2_header: (the file position after jp2h, Header)."""
    reader = _Reader(data, 12, -1)
    header = None
    while reader.has_next():
        tbox = reader.next_type()
        if tbox == b"jp2h":
            header = reader.sub()
            break
        if tbox == b"ftyp":
            reader.fields(">4s")
    if header is None:
        raise ValueError(f"{name}: no JP2 header box")
    after = reader.pos
    size = mode = nc = palette = None
    while header.has_next():
        tbox = header.next_type()
        if tbox == b"ihdr":
            height, width, nc, bpc = header.fields(">IIHB")
            size = (width, height)
            mode = ("I;16" if (bpc & 0x7F) > 8 else "L") if nc == 1 else \
                {2: "LA", 3: "RGB", 4: "RGBA"}.get(nc, mode)
        elif tbox == b"colr" and nc == 4:
            meth, _, _, enumcs = header.fields(">BBBI")
            if meth == 1 and enumcs == 12:
                mode = "CMYK"
        elif tbox == b"pclr" and mode in ("L", "LA"):
            ne, npc = header.fields(">HB")
            depths = header.fields(">" + "B" * npc)
            if max(depths, default=0) <= 8:
                colours = [header.fields(">" + "B" * npc) for _ in range(ne)]
                palette = _getcolor_palette("RGBA" if npc == 4 else "RGB", colours)
                mode = "P" if mode == "L" else "PA"
        elif tbox == b"res ":
            res = header.sub()
            while res.has_next():
                if res.next_type() == b"resc":
                    res.fields(">HHHHBB")
                    break
    if size is None or mode is None:
        raise raster.NotThisFormat(f"{name}: Malformed JP2 header")
    return after, Header("jp2", size[0], size[1], mode, palette)


# --- OpenJPEG's reading of the file -----------------------------------------------------------------


class Tccp:
    """A tile-component's coding parameters (opj_tccp_t)."""

    def __init__(self):
        self.csty = self.numresolutions = self.cblkw = self.cblkh = self.cblksty = self.qmfbid = 0
        self.qntsty = self.numgbits = self.roishift = 0
        self.prcw = [15] * MAX_RESOLUTIONS
        self.prch = [15] * MAX_RESOLUTIONS
        self.stepsizes = [(0, 0)] * MAX_BANDS


class Tcp:
    """A tile's coding parameters (opj_tcp_t) and what its tile-parts brought."""

    def __init__(self, numcomps: int):
        self.csty = self.prg = self.numlayers = self.mct = 0
        self.tccps = [Tccp() for _ in range(numcomps)]
        self.pocs = []
        self.cod = self.qcd = False
        self.ppt = {}
        self.data = None
        self.nb_parts = 0
        self.part = -1


class Codestream:
    """The image and tiles as OpenJPEG read them: `tiles` lists (tile number, Tcp, tile data, PPT headers or
    None) in the order OpenJPEG decodes them; `ppm` the merged PPM headers or None."""

    def __init__(self):
        self.x0 = self.y0 = self.x1 = self.y1 = 0
        self.tx0 = self.ty0 = self.tdx = self.tdy = self.tw = self.th = 0
        self.comps = []
        self.default = None
        self.ppm_markers = {}
        self.ppm = None
        self.tiles = []


def _u(b: bytes, at: int, n: int) -> int:
    return int.from_bytes(b[at : at + n], "big")


def _read_siz(cs: Codestream, body: bytes, ihdr) -> None:
    if len(body) < 36 or (len(body) - 36) % 3:
        raise ValueError("Error with SIZ marker size")
    cs.x1, cs.y1, cs.x0, cs.y0 = _u(body, 2, 4), _u(body, 6, 4), _u(body, 10, 4), _u(body, 14, 4)
    cs.tdx, cs.tdy, cs.tx0, cs.ty0 = _u(body, 18, 4), _u(body, 22, 4), _u(body, 26, 4), _u(body, 30, 4)
    numcomps = _u(body, 34, 2)
    if numcomps >= 16385 or numcomps != (len(body) - 36) // 3:
        raise ValueError("Error with SIZ marker: number of components")
    if cs.x0 >= cs.x1 or cs.y0 >= cs.y1:
        raise ValueError("Error with SIZ marker: negative or zero image size")
    if cs.tdx == 0 or cs.tdy == 0:
        raise ValueError("Error with SIZ marker: invalid tile size")
    if cs.tx0 > cs.x0 or cs.ty0 > cs.y0 or min(cs.tx0 + cs.tdx, 0xFFFFFFFF) <= cs.x0 or \
            min(cs.ty0 + cs.tdy, 0xFFFFFFFF) <= cs.y0:
        raise ValueError("Error with SIZ marker: illegal tile offset")
    if 0xFFFFFFFF // cs.x1 < cs.y1:
        raise ValueError("Prevent buffer overflow")
    if ihdr is not None and (ihdr[0] != cs.x1 - cs.x0 or ihdr[1] != cs.y1 - cs.y0):
        raise ValueError("Error with SIZ marker: IHDR size differs from SIZ")
    for i in range(numcomps):
        ssiz, dx, dy = body[36 + 3 * i], body[37 + 3 * i], body[38 + 3 * i]
        if dx < 1 or dy < 1:
            raise ValueError("Invalid values for comp: dx / dy")
        prec = (ssiz & 0x7F) + 1
        if prec > 31:
            raise ValueError("Invalid values for comp: prec")
        cs.comps.append((dx, dy, prec, ssiz >> 7))
    cs.tw = j2k_t2.ceildiv(cs.x1 - cs.tx0, cs.tdx)
    cs.th = j2k_t2.ceildiv(cs.y1 - cs.ty0, cs.tdy)
    if cs.tw == 0 or cs.th == 0 or cs.tw > 65535 // cs.th:
        raise ValueError("Invalid number of tiles")
    cs.default = Tcp(numcomps)


def _read_spcod(tccp: Tccp, body: bytes, at: int) -> int:
    """opj_j2k_read_SPCod_SPCoc: the bytes read."""
    if len(body) - at < 5:
        raise ValueError("Error reading SPCod SPCoc element")
    tccp.numresolutions = body[at] + 1
    if tccp.numresolutions > MAX_RESOLUTIONS:
        raise ValueError("Invalid value for numresolutions")
    tccp.cblkw, tccp.cblkh = body[at + 1] + 2, body[at + 2] + 2
    if tccp.cblkw > 10 or tccp.cblkh > 10 or tccp.cblkw + tccp.cblkh > 12:
        raise ValueError("Error reading SPCod SPCoc element, Invalid cblkw/cblkh combination")
    tccp.cblksty = body[at + 3]
    if tccp.cblksty & 0x40:
        raise Unsupported("JPEG 2000 HT (high-throughput code-blocks)")
    tccp.qmfbid = body[at + 4]
    if tccp.qmfbid > 1:
        raise ValueError("Error reading SPCod SPCoc element, Invalid transformation found")
    n = 5
    if tccp.csty & 1:
        if len(body) - at - 5 < tccp.numresolutions:
            raise ValueError("Error reading SPCod SPCoc element")
        for i in range(tccp.numresolutions):
            v = body[at + 5 + i]
            if i and ((v & 0xF) == 0 or (v >> 4) == 0):
                raise ValueError("Invalid precinct size")
            tccp.prcw[i], tccp.prch[i] = v & 0xF, v >> 4
        n += tccp.numresolutions
    else:
        tccp.prcw = [15] * MAX_RESOLUTIONS
        tccp.prch = [15] * MAX_RESOLUTIONS
    return n


def _read_sqcd(tccp: Tccp, body: bytes, at: int) -> int:
    """opj_j2k_read_SQcd_SQcc: the bytes read."""
    if len(body) - at < 1:
        raise ValueError("Error reading SQcd or SQcc element")
    tccp.qntsty, tccp.numgbits = body[at] & 0x1F, body[at] >> 5
    rest = len(body) - at - 1
    if tccp.qntsty == 1:
        nbands = 1
    else:
        nbands = rest if tccp.qntsty == 0 else rest // 2
    steps = list(tccp.stepsizes)
    if tccp.qntsty == 0:
        if rest < nbands:
            raise ValueError("Error reading SQcd or SQcc element")
        for b in range(nbands):
            if b < MAX_BANDS:
                steps[b] = (body[at + 1 + b] >> 3, 0)
        used = nbands
    else:
        if rest < 2 * nbands:
            raise ValueError("Error reading SQcd or SQcc element")
        for b in range(nbands):
            v = _u(body, at + 1 + 2 * b, 2)
            if b < MAX_BANDS:
                steps[b] = (v >> 11, v & 0x7FF)
        used = 2 * nbands
    if tccp.qntsty == 1:
        e0, m0 = steps[0]
        for b in range(1, MAX_BANDS):
            steps[b] = (max(e0 - (b - 1) // 3, 0), m0)
    tccp.stepsizes = steps
    return 1 + used


def _comp_index(cs: Codestream, body: bytes, what: str) -> tuple:
    room = 1 if len(cs.comps) <= 256 else 2
    if len(body) < room:
        raise ValueError(f"Error reading {what} marker")
    return _u(body, 0, room), room


def _read_marker(cs: Codestream, tcp: Tcp, marker: int, body: bytes) -> None:
    """One marker segment of the main or a tile-part header."""
    if marker == COD:
        if tcp.cod:
            raise ValueError("COD marker already read")
        tcp.cod = True
        if len(body) < 5:
            raise ValueError("Error reading COD marker")
        tcp.csty = body[0]
        if tcp.csty & ~7:
            raise ValueError("Unknown Scod value in COD marker")
        tcp.prg = body[1]
        tcp.numlayers = _u(body, 2, 2)
        if tcp.numlayers < 1:
            raise ValueError("Invalid number of layers in COD marker")
        tcp.mct = body[4]
        if tcp.mct > 1:
            raise ValueError("Invalid multiple component transformation")
        for t in tcp.tccps:
            t.csty = tcp.csty & 1
        ref = tcp.tccps[0]
        if _read_spcod(ref, body, 5) != len(body) - 5:
            raise ValueError("Error reading COD marker")
        for t in tcp.tccps[1:]:
            t.numresolutions, t.cblkw, t.cblkh = ref.numresolutions, ref.cblkw, ref.cblkh
            t.cblksty, t.qmfbid = ref.cblksty, ref.qmfbid
            t.prcw, t.prch = list(ref.prcw), list(ref.prch)
    elif marker == COC:
        compno, room = _comp_index(cs, body, "COC")
        if len(body) < room + 1:
            raise ValueError("Error reading COC marker")
        if compno >= len(cs.comps):
            raise ValueError("Error reading COC marker (bad number of components)")
        tccp = tcp.tccps[compno]
        tccp.csty = body[room]
        if _read_spcod(tccp, body, room + 1) != len(body) - room - 1:
            raise ValueError("Error reading COC marker")
    elif marker == QCD:
        tcp.qcd = True
        ref = tcp.tccps[0]
        if _read_sqcd(ref, body, 0) != len(body):
            raise ValueError("Error reading QCD marker")
        for t in tcp.tccps[1:]:
            t.qntsty, t.numgbits, t.stepsizes = ref.qntsty, ref.numgbits, list(ref.stepsizes)
    elif marker == QCC:
        compno, room = _comp_index(cs, body, "QCC")
        if compno >= len(cs.comps):
            raise ValueError("Invalid component number in QCC")
        if _read_sqcd(tcp.tccps[compno], body, room) != len(body) - room:
            raise ValueError("Error reading QCC marker")
    elif marker == RGN:
        room = 1 if len(cs.comps) <= 256 else 2
        if len(body) != 2 + room:
            raise ValueError("Error reading RGN marker")
        compno = _u(body, 0, room)
        if compno >= len(cs.comps):
            raise ValueError("bad component number in RGN")
        tcp.tccps[compno].roishift = body[room + 1]
    elif marker == POC:
        room = 1 if len(cs.comps) <= 256 else 2
        chunk = 5 + 2 * room
        if len(body) < chunk or len(body) % chunk:
            raise ValueError("Error reading POC marker")
        if len(tcp.pocs) + len(body) // chunk >= 32:
            raise ValueError("Too many POCs")
        for at in range(0, len(body), chunk):
            resno0, compno0 = body[at], _u(body, at + 1, room)
            layno1, resno1 = _u(body, at + 1 + room, 2), body[at + 3 + room]
            compno1, prg = _u(body, at + 4 + room, room), body[at + 4 + 2 * room]
            tcp.pocs.append((resno0, compno0, layno1, resno1, min(compno1, len(cs.comps)), prg))
    elif marker == PPM:
        if len(body) < 2:
            raise ValueError("Error reading PPM marker")
        if body[0] in cs.ppm_markers:
            raise ValueError("Zppm already read")
        cs.ppm_markers[body[0]] = body[1:]
    elif marker == PPT:
        if cs.ppm is not None:
            raise ValueError("Error reading PPT marker: packet headers in the main header (PPM)")
        if len(body) < 2:
            raise ValueError("Error reading PPT marker")
        if body[0] in tcp.ppt:
            raise ValueError("Zppt already read")
        tcp.ppt[body[0]] = body[1:]
    elif marker == TLM:
        if len(body) < 2:
            raise ValueError("Error reading TLM marker")
    elif marker in (PLM, PLT):
        if len(body) < 1:
            raise ValueError("Error reading PLM / PLT marker")
        if marker == PLT:
            length = 0
            for b in body[1:]:
                length |= b & 0x7F
                length = length << 7 if b & 0x80 else 0
            if length:
                raise ValueError("Error reading PLT marker")
    elif marker == CRG:
        if len(body) != 4 * len(cs.comps):
            raise ValueError("Error reading CRG marker")
    elif marker in (CAP, CPF):
        raise Unsupported("JPEG 2000 HT (a Part 15 capabilities marker)")
    elif marker in (CBD, MCT, MCC, MCO):
        raise Unsupported("JPEG 2000 Part 2 multi-component transform")


def _merge_ppm(cs: Codestream) -> None:
    """opj_j2k_merge_ppm: the Ippm bytes of every PPM (by Zppm), without their Nppm counts."""
    if not cs.ppm_markers:
        return
    out = bytearray()
    remaining = 0
    for z in sorted(cs.ppm_markers):
        chunk = cs.ppm_markers[z]
        at = 0
        take = min(remaining, len(chunk))
        out += chunk[:take]
        remaining -= take
        at = take
        while at < len(chunk):
            if len(chunk) - at < 4:
                raise ValueError("Not enough bytes to read Nppm")
            n = _u(chunk, at, 4)
            at += 4
            take = min(n, len(chunk) - at)
            out += chunk[at : at + take]
            at += take
            remaining = n - take
    if remaining:
        raise ValueError("Corrupted PPM markers")
    cs.ppm = bytes(out)


def read_codestream(data: bytes, start: int, ihdr=None) -> Codestream:
    """opj_read_header and opj_read_tile_header over the codestream from `start` to the file's end:
    the image and its tiles in decode order; ValueError where OpenJPEG fails."""
    cs = Codestream()
    end = len(data)
    pos = start

    def read2() -> int:
        nonlocal pos
        if end - pos < 2:
            raise ValueError("Stream too short")
        pos += 2
        return _u(data, pos - 2, 2)

    if read2() != SOC:
        raise ValueError("Expected a SOC marker")
    marker = read2()
    state = 0  # MHSIZ
    while marker != SOT:
        if marker < 0xFF00:
            raise ValueError(f"A marker ID was expected (0xff--) instead of {marker:#x}")
        if marker not in MARKER_STATES:
            while True:
                marker = read2()
                if marker >= 0xFF00:
                    if marker in MARKER_STATES:
                        break
            if marker == SOT:
                break
        allowed = MARKER_STATES[marker] if marker != SIZ else 8
        if not (allowed & (8 if state == 0 else MH)):
            raise ValueError("Marker is not compliant with its position")
        size = read2()
        if size < 2:
            raise ValueError("Invalid marker size")
        if end - pos < size - 2:
            raise ValueError("Stream too short")
        body = data[pos : pos + size - 2]
        pos += size - 2
        if marker == SIZ:
            _read_siz(cs, body, ihdr)
            state = MH
        else:
            _read_marker(cs, cs.default, marker, body)
        marker = read2()
    if not cs.comps:
        raise ValueError("required SIZ marker not found in main header")
    if not cs.default.cod:
        raise ValueError("required COD marker not found in main header")
    if not cs.default.qcd:
        raise ValueError("required QCD marker not found in main header")
    _merge_ppm(cs)
    ntiles = cs.tw * cs.th
    tcps = {}
    state = TPHSOT
    current = 0

    def pending(first: int) -> list:
        return [t for t in sorted(tcps) if t >= first and tcps[t].data is not None]

    while True:
        can_decode = False
        eoc_from = None
        while not can_decode and marker != EOC:
            sot_length = 0
            last_part = False
            while marker != SOD:
                if end - pos == 0:
                    # the stream ends in a tile-part header: OpenJPEG decodes the next tile with data, if
                    # any, and then fails; with none, the image is what was decoded
                    if pending(current):
                        raise ValueError("Stream ended in a tile-part header")
                    return cs
                size = read2()
                if size < 2:
                    raise ValueError("Inconsistent marker size")
                if state == TPH and sot_length:
                    if sot_length < size + 2:
                        raise ValueError("Sot length is less than marker size + marker ID")
                    sot_length -= size + 2
                if not MARKER_STATES.get(marker, MH | TPH) & state:
                    raise ValueError("Marker is not compliant with its position")
                if end - pos < size - 2:
                    raise ValueError("Marker size inconsistent with stream length")
                if marker not in MARKER_STATES:
                    raise ValueError(f"unknown marker {marker:#x} in a tile-part header")
                body = data[pos : pos + size - 2]
                pos += size - 2
                if marker == SOT:
                    if len(body) != 8:
                        raise ValueError("Error reading SOT marker")
                    current, psot, tpsot, tnsot = _u(body, 0, 2), _u(body, 2, 4), body[6], body[7]
                    if current >= ntiles:
                        raise ValueError(f"Invalid tile number {current}")
                    if current not in tcps:
                        tcps[current] = copy.deepcopy(cs.default)
                        tcps[current].cod = False
                    tcp = tcps[current]
                    if tcp.part + 1 != tpsot:
                        raise ValueError("Invalid tile part index")
                    tcp.part = tpsot
                    if psot and psot < 14 and psot != 12:
                        raise ValueError("Psot value is not correct")
                    last_part = psot == 0
                    if tcp.nb_parts and tpsot >= tcp.nb_parts:
                        raise ValueError("TPsot is not valid regards to the previous number of tile-parts")
                    if tnsot:
                        if tpsot >= tnsot:
                            raise ValueError("TPsot is not valid regards to TNsot")
                        tcp.nb_parts = tnsot
                    if tcp.nb_parts and tcp.nb_parts == tpsot + 1:
                        can_decode = True
                    sot_length = 0 if last_part else psot - 12
                    state = TPH
                else:
                    _read_marker(cs, tcps[current], marker, body)
                marker = read2()
            # opj_j2k_read_sod: the tile-part's data
            if last_part:
                sot_length = end - pos - 2
            else:
                sot_length = sot_length - 2 if sot_length >= 2 else 0
            tcp = tcps[current]
            if sot_length > 0:
                if sot_length > end - pos:
                    raise ValueError("Tile part length size inconsistent with stream length")
                tcp.data = (tcp.data or b"") + data[pos : pos + sot_length]
                pos += sot_length
            state = TPHSOT
            if not can_decode:
                if end - pos < 2:
                    if current + 1 == ntiles:
                        first = [t for t in sorted(tcps) if tcps[t].part == 0 and not tcps[t].nb_parts]
                        if first:
                            eoc_from = first[0]
                            marker = EOC
                            break
                    raise ValueError("Stream too short")
                marker = read2()
        if can_decode:
            tcp = tcps[current]
            if tcp.data is None:
                raise ValueError(f"tile {current} has no data")
            cs.tiles.append((current, tcp, tcp.data, _merged_ppt(tcp)))
            tcp.data = None
            marker = read2()
            if marker == SOT:
                continue
            if marker != EOC:
                raise ValueError("Stream too short, expected SOT")
        # EOC: the tiles read but not yet decoded, in index order
        for t in pending(0 if eoc_from is None else eoc_from):
            cs.tiles.append((t, tcps[t], tcps[t].data, _merged_ppt(tcps[t])))
            tcps[t].data = None
        return cs


def _merged_ppt(tcp: Tcp):
    if not tcp.ppt:
        return None
    return b"".join(tcp.ppt[z] for z in sorted(tcp.ppt))


class Jp2(NamedTuple):
    """What OpenJPEG read of a JP2 file's boxes: where the codestream starts, the colour space, ihdr's size."""

    start: int
    colour: int
    ihdr: tuple


def read_jp2(data: bytes) -> Jp2:
    """opj_jp2_read_header's box walk up to `jp2c`; ValueError where OpenJPEG fails."""
    pos, end = 0, len(data)
    state = 0  # 1 signature, 2 file type, 4 header
    enumcs = 0
    has_colr = False
    ihdr = None
    pclr = cmap = cdef = False
    while True:
        if end - pos < 8:
            break
        length, kind = _u(data, pos, 4), data[pos + 4 : pos + 8]
        hlen = 8
        if length == 0:
            length = end - pos
        elif length == 1:
            if end - pos < 16:
                break
            if _u(data, pos + 8, 4):
                raise ValueError("Cannot handle box sizes higher than 2^32")
            length, hlen = _u(data, pos + 12, 4), 16
        if kind == b"jp2c":
            if not state & 4:
                raise ValueError("bad placed jpeg codestream")
            if ihdr is None:
                raise ValueError("IHDR box missing")
            return Jp2(pos + hlen, ENUMCS.get(enumcs, UNSPECIFIED), ihdr)
        if length < hlen:
            raise ValueError("invalid box size")
        body_len = length - hlen
        known = kind in (b"jP  ", b"ftyp", b"jp2h")
        misplaced = kind in (b"ihdr", b"colr", b"bpcc", b"pclr", b"cmap", b"cdef")
        if known or misplaced:
            if not known and not state & 4:
                if body_len > end - pos - hlen:
                    raise ValueError("Problem with skipping JPEG2000 box, stream error")
                pos += length
                continue
            if body_len > end - pos - hlen:
                raise ValueError("Invalid box size")
            body = data[pos + hlen : pos + length]
            if kind == b"jP  ":
                if state or len(body) != 4 or body != b"\x0d\x0a\x87\x0a":
                    raise ValueError("Error with JP signature box")
                state = 1
            elif kind == b"ftyp":
                if state != 1 or len(body) < 8 or (len(body) - 8) % 4:
                    raise ValueError("Error with FTYP signature box")
                state |= 2
            elif kind == b"jp2h":
                if not state & 2:
                    raise ValueError("The jp2h box must follow ftyp")
                boxes = []
                at = 0
                while at < len(body):
                    if len(body) - at < 8:
                        raise ValueError("Stream error while reading JP2 Header box")
                    blen, bkind = _u(body, at, 4), body[at + 4 : at + 8]
                    bh = 8
                    if blen == 1:
                        if len(body) - at < 16 or _u(body, at + 8, 4):
                            raise ValueError("Stream error while reading JP2 Header box")
                        blen, bh = _u(body, at + 12, 4), 16
                    elif blen == 0:
                        raise ValueError("Stream error while reading JP2 Header box")
                    if blen > len(body) - at or blen < bh:
                        raise ValueError("Stream error while reading JP2 Header box: box length is inconsistent")
                    boxes.append((bkind, body[at + bh : at + blen]))
                    at += blen
                for bkind, bbody in boxes:
                    ihdr, enumcs, has_colr, pclr, cmap, cdef = _img_box(bkind, bbody, ihdr, enumcs, has_colr,
                                                                         pclr, cmap, cdef)
                if not any(k == b"ihdr" for k, _ in boxes):
                    raise ValueError("Stream error while reading JP2 Header box: no 'ihdr' box")
                state |= 4
            else:
                ihdr, enumcs, has_colr, pclr, cmap, cdef = _img_box(kind, body, ihdr, enumcs, has_colr, pclr,
                                                                     cmap, cdef)
            pos += length
        else:
            if not state & 1:
                raise ValueError("first box must be JPEG 2000 signature box")
            if not state & 2:
                raise ValueError("second box must be file type box")
            if body_len > end - pos - hlen:
                raise ValueError("Problem with skipping JPEG2000 box, stream error")
            pos += length
    if not state & 4:
        raise ValueError("JP2H box missing")
    raise ValueError("Expected a SOC marker (no codestream box)")


def _img_box(kind, body, ihdr, enumcs, has_colr, pclr, cmap, cdef):
    """The handlers of the boxes jp2h holds (opj_jp2_read_ihdr / colr / bpcc / pclr / cmap / cdef)."""
    if kind == b"ihdr":
        if ihdr is not None:
            return ihdr, enumcs, has_colr, pclr, cmap, cdef
        if len(body) != 14:
            raise ValueError("Bad image header box (bad size)")
        h, w, nc = _u(body, 0, 4), _u(body, 4, 4), _u(body, 8, 2)
        if h < 1 or w < 1 or nc < 1 or nc - 1 >= 16384:
            raise ValueError("Wrong values in ihdr")
        ihdr = (w, h, nc, body[10])
    elif kind == b"colr":
        if len(body) < 3:
            raise ValueError("Bad COLR header box (bad size)")
        if not has_colr:
            if body[0] == 1:
                if len(body) < 7:
                    raise ValueError("Bad COLR header box (bad size)")
                enumcs = _u(body, 3, 4)
                has_colr = True
            elif body[0] == 2:
                has_colr = True
    elif kind == b"bpcc":
        if ihdr is None or len(body) != ihdr[2]:
            raise ValueError("Bad BPCC header box (bad size)")
    elif kind == b"pclr":
        if pclr or len(body) < 3:
            raise ValueError("Invalid PCLR box")
        ne, npc = _u(body, 0, 2), body[2]
        if ne == 0 or ne > 1024 or npc == 0 or len(body) < 3 + npc:
            raise ValueError("Invalid PCLR box")
        sizes = [min(((b & 0x7F) + 1 + 7) >> 3, 4) for b in body[3 : 3 + npc]]
        if len(body) < 3 + npc + ne * sum(sizes):
            raise ValueError("Invalid PCLR box")
        pclr = npc
    elif kind == b"cmap":
        if not pclr:
            raise ValueError("Need to read a PCLR box before the CMAP box")
        if cmap:
            raise ValueError("Only one CMAP box is allowed")
        if len(body) < 4 * pclr:
            raise ValueError("Insufficient data for CMAP box")
        cmap = True
    elif kind == b"cdef":
        if cdef or len(body) < 2:
            raise ValueError("Insufficient data for CDEF box")
        n = _u(body, 0, 2)
        if n == 0 or len(body) < 2 + 6 * n:
            raise ValueError("Insufficient data for CDEF box")
        cdef = True
    return ihdr, enumcs, has_colr, pclr, cmap, cdef


# --- the plan both decoders follow --------------------------------------------------------------------


class Plan(NamedTuple):
    """Everything a decoder needs: Pillow's header, OpenJPEG's codestream and colour space, the unpacker."""

    header: Header
    cs: Codestream
    colour: int
    unpacker: str


def plan(data: bytes, name: str = "<bytes>") -> Plan:
    """Pillow's _open, then OpenJPEG's header and tile-part reading and Jpeg2KDecode.c's choice of unpacker;
    raises raster.NotThisFormat where Image.open tries its next reader, UnsupportedImageFormat for the
    forms not decoded, ValueError where Pillow fails."""
    from uniir_tpu_torch.data.jpeg import UnsupportedImageFormat

    header = open_header(data, name)
    try:
        if header.codec == "jp2":
            jp2 = read_jp2(data)
            cs = read_codestream(data, jp2.start, jp2.ihdr[:2])
            colour = jp2.colour
        else:
            cs = read_codestream(data, 0)
            colour = UNSPECIFIED
    except Unsupported as e:
        raise UnsupportedImageFormat(f"{name}: {e} image: only Part 1 JPEG 2000 files are decoded") from None
    except ValueError as e:
        raise ValueError(f"{name}: JPEG 2000: {e} (broken data stream)") from None
    n = len(cs.comps)
    if n < 1 or n > 4:
        raise ValueError(f"{name}: JPEG 2000 of {n} components (broken data stream)")
    # Pillow's heuristic: the first subsampled component, if any, names the space left unspecified
    subsampled = next((c for c, (dx, dy, _, _) in enumerate(cs.comps) if dx != 1 or dy != 1), -1)
    if colour == UNSPECIFIED:
        colour = GRAY if n <= 2 else SYCC if subsampled in (1, 2) else SRGB
    subsampled = subsampled >= 0
    found = UNPACKERS.get((header.mode, colour, n))
    if found is None or (subsampled and not found[1]):
        raise ValueError(f"{name}: JPEG 2000 of mode {header.mode}, colour space {colour}, {n} components: "
                         f"no unpacker (broken data stream)")
    for tileno, tcp, _, _ in cs.tiles:
        p, q = tileno % cs.tw, tileno // cs.tw
        x0, y0 = max(cs.tx0 + p * cs.tdx, cs.x0), max(cs.ty0 + q * cs.tdy, cs.y0)
        x1, y1 = min(cs.tx0 + (p + 1) * cs.tdx, cs.x1), min(cs.ty0 + (q + 1) * cs.tdy, cs.y1)
        if x0 >= x1 or y0 >= y1 or x1 - cs.x0 > header.width or y1 - cs.y0 > header.height:
            raise ValueError(f"{name}: JPEG 2000 tile {tileno} outside the image (broken data stream)")
    return Plan(header, cs, colour, found[0])


# --- Pillow's unpackers and convert("RGB") -------------------------------------------------------------


def _csiz(prec: int) -> int:
    c = (prec + 7) >> 3
    return 4 if c == 3 else c


def _component_bytes(samples: np.ndarray, prec: int) -> bytes:
    size = _csiz(prec)
    dt = {1: "<u1", 2: "<u2", 4: "<u4"}[size]
    mask = (1 << (8 * size)) - 1
    return (samples.astype(np.int64) & mask).astype(dt).tobytes()


def unpack_tile(pl: Plan, buffer: bytearray, comps: list, tileno: int, image: np.ndarray) -> bytearray:
    """Pillow's unpacker on one decoded tile: writes `image` (uint8 [H, W, 4], or uint16 [H, W] for I;16);
    `buffer` is Pillow's reused tile buffer, returned grown as Pillow grows it."""
    cs = pl.cs
    p, q = tileno % cs.tw, tileno // cs.tw
    tx0, ty0 = max(cs.tx0 + p * cs.tdx, cs.x0), max(cs.ty0 + q * cs.tdy, cs.y0)
    tx1, ty1 = min(cs.tx0 + (p + 1) * cs.tdx, cs.x1), min(cs.ty0 + (q + 1) * cs.tdy, cs.y1)
    w, h = tx1 - tx0, ty1 - ty0
    x0, y0 = tx0 - cs.x0, ty0 - cs.y0
    raw = b"".join(_component_bytes(c, prec) for c, (_, _, prec, _) in zip(comps, cs.comps))
    total_width = sum(_csiz(prec) for _, _, prec, _ in cs.comps)
    need = max(len(raw), w * h * total_width)
    if len(buffer) < need:
        buffer = bytearray(need)
    buffer[: len(raw)] = raw
    buf = np.frombuffer(bytes(buffer), np.uint8)

    def words(offset: int, csiz: int, index: np.ndarray) -> np.ndarray:
        at = offset + csiz * index
        v = np.zeros(index.shape, np.int64)
        for k in range(csiz):
            v |= buf[at + k].astype(np.int64) << (8 * k)
        return v

    def shifted(word: np.ndarray, prec: int, sgnd: int, bits: int) -> np.ndarray:
        shift = bits - prec
        offset = (1 << (prec - 1)) if sgnd else 0
        if shift < 0:
            offset += 1 << (-shift - 1)
        x = (word + offset) & 0xFFFFFFFF
        x = (x >> -shift) if shift < 0 else (x << shift) & 0xFFFFFFFF
        return x & ((1 << bits) - 1)

    yy, xx = np.mgrid[0:h, 0:w]
    kind = pl.unpacker
    if kind in ("gray_l", "gray_i", "gray_rgb"):
        prec, sgnd = cs.comps[0][2], cs.comps[0][3]
        v = shifted(words(0, _csiz(prec), yy * w + xx), prec, sgnd, 16 if kind == "gray_i" else 8)
        if kind == "gray_i":
            image[y0 : y0 + h, x0 : x0 + w] = v
        elif kind == "gray_l":
            image[y0 : y0 + h, x0 : x0 + w, 0] = v
        else:
            image[y0 : y0 + h, x0 : x0 + w, :3] = v[..., None]
            image[y0 : y0 + h, x0 : x0 + w, 3] = 255
    elif kind == "graya_la":
        (_, _, p0, s0), (_, _, p1, s1) = cs.comps[0], cs.comps[1]
        c0, c1 = _csiz(p0), _csiz(p1)
        v = shifted(words(0, c0, yy * w + xx), p0, s0, 8)
        a = shifted(words(c0 * w * h, c1, yy * w + xx), p1, s1, 8)
        image[y0 : y0 + h, x0 : x0 + w, :3] = v[..., None]
        image[y0 : y0 + h, x0 : x0 + w, 3] = a
    else:
        n = 4 if kind in ("srgba_rgba", "sycca_rgba") else 3
        offset = 0
        for c in range(n):
            dx, dy, prec, sgnd = cs.comps[c]
            cz = _csiz(prec)
            v = shifted(words(offset, cz, (yy // dy) * (w // dx) + xx // dx), prec, sgnd, 8)
            image[y0 : y0 + h, x0 : x0 + w, c] = v
            offset += cz * (w // dx) * (h // dy)
        if n == 3:
            image[y0 : y0 + h, x0 : x0 + w, 3] = 255
        if kind in ("sycc_rgb", "sycca_rgba"):
            image[y0 : y0 + h, x0 : x0 + w, :3] = im.ycbcr_to_rgb(image[y0 : y0 + h, x0 : x0 + w, :3])
    return buffer


def new_image(pl: Plan) -> np.ndarray:
    """Pillow's zero-filled image of the plan's mode (uint16 [H, W] for I;16, else uint8 [H, W, 4])."""
    h, w = pl.header.height, pl.header.width
    return np.zeros((h, w), np.uint16) if pl.header.mode == "I;16" else np.zeros((h, w, 4), np.uint8)


def _palette_rgb(palette: Palette) -> np.ndarray:
    """The 256 RGB entries P -> RGB reads after Pillow's putpalette: the palette's entries, then black."""
    out = np.zeros((256, 3), np.uint8)
    step = 4 if palette.mode == "RGBA" else 3
    n = min(len(palette.raw) // step, 256)
    raw = np.frombuffer(palette.raw[: n * step], np.uint8).reshape(n, step)
    out[:n] = raw[:, :3]
    return out


def to_rgb(pl: Plan, image: np.ndarray) -> np.ndarray:
    """convert("RGB") of the unpacked image."""
    from uniir_tpu_torch.data import jpeg

    mode = pl.header.mode
    if mode == "I;16":
        return np.repeat(np.minimum(image, 255).astype(np.uint8)[..., None], 3, axis=2)
    if mode in ("L", "LA"):
        return np.repeat(image[..., :1], 3, axis=2)
    if mode in ("P", "PA"):
        return _palette_rgb(pl.header.palette)[image[..., 0]]
    if mode == "CMYK":
        return jpeg.cmyk_to_rgb(image)
    return np.ascontiguousarray(image[..., :3])


# --- the twin ----------------------------------------------------------------------------------------


def decode_components(data: bytes, name: str = "<bytes>") -> list:
    """(tile number, [int32 samples per component]) for each tile, in decode order: OpenJPEG's output
    before Pillow's unpacker (what the tests hold to opj_decode)."""
    pl = plan(bytes(data), name)
    return _tiles(pl, name)


def _tiles(pl: Plan, name: str) -> list:
    cs = pl.cs
    ppm = j2k_t2.Headers(cs.ppm) if cs.ppm is not None else None
    out = []
    try:
        for tileno, tcp, tile_data, ppt in cs.tiles:
            headers = ppm if ppm is not None else (j2k_t2.Headers(ppt) if ppt is not None else None)
            comps = j2k_t2.decode_tile(cs, tcp, tileno, tile_data, headers)
            out.append((tileno, comps))
    except ValueError as e:
        raise ValueError(f"{name}: JPEG 2000: {e} (broken data stream)") from None
    return out


def decode_twin(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """uint8 [H, W, 3]: `PIL.Image.open(...).convert("RGB")` of a JPEG 2000 file."""
    pl = plan(bytes(data), name)
    image = new_image(pl)
    buffer = bytearray()
    for tileno, comps in _tiles(pl, name):
        buffer = unpack_tile(pl, buffer, comps, tileno, image)
    return to_rgb(pl, image)


# --- the native decoder --------------------------------------------------------------------------------

_YCC = np.ascontiguousarray(np.concatenate([im.R_CR, im.G_CB, im.G_CR, im.B_CB]).astype(np.int32))


def native_plan(pl: Plan) -> tuple:
    """The int64 plan and the byte blob `uniir_jpeg2000_decode` takes (its comment in csrc/jpeg2000.cu)."""
    cs = pl.cs
    blob = bytearray()

    def put(b: bytes) -> tuple:
        blob.extend(b)
        return len(blob) - len(b), len(b)

    ppm = put(cs.ppm) if cs.ppm is not None else (0, -1)
    out = [len(cs.comps), cs.x0, cs.y0, cs.x1, cs.y1, cs.tx0, cs.ty0, cs.tdx, cs.tdy, cs.tw, cs.th,
           pl.header.width, pl.header.height, UNPACKER_CODES[pl.unpacker], len(cs.tiles), *ppm]
    for comp in cs.comps:
        out += comp
    for tileno, tcp, data, ppt in cs.tiles:
        out += [tileno, *put(data), *(put(ppt) if ppt is not None else (0, -1))]
        out += [tcp.csty, tcp.prg, tcp.numlayers, tcp.mct, len(tcp.pocs)]
        for poc in tcp.pocs:
            out += poc
        for t in tcp.tccps:
            out += [t.numresolutions, t.cblkw, t.cblkh, t.cblksty, t.qmfbid, t.roishift, t.numgbits]
            out += t.prcw[: t.numresolutions] + t.prch[: t.numresolutions]
            steps = t.stepsizes[: 3 * (t.numresolutions - 1) + 1]
            out.append(len(steps))
            for e, m in steps:
                out += [e, m]
    return np.array(out, np.int64), bytes(blob)


def decode_native(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """`decode_twin` through csrc/jpeg2000.cu's host decoder (built on first use) after the same plan."""
    from uniir_tpu_torch import _build

    lib = _build.load("jpeg2000")
    pl = plan(bytes(data), name)
    ints, blob = native_plan(pl)
    image = new_image(pl)
    err = ctypes.create_string_buffer(256)
    if lib.uniir_jpeg2000_decode(ints.ctypes.data, len(ints), blob, len(blob), _YCC.ctypes.data, image.ctypes.data,
                                 err, len(err)) != 0:
        raise ValueError(f"{name}: JPEG 2000: {err.value.decode()} (broken data stream)")
    with _calls_lock:
        decode_native.calls += 1
    return to_rgb(pl, image)


decode_native.calls = 0  # decodes that went through the native library (read by chip_smoke.py)
_calls_lock = threading.Lock()  # the loader's threads decode at once


def decoder_for(device) -> Callable[[bytes, str], np.ndarray]:
    """The decoder a run on `device` uses: the native one on a CUDA run's host, the twin on a CPU run."""
    from uniir_tpu_torch import _build

    return decode_native if _build.is_cuda(device) else decode_twin
