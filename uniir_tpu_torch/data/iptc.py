"""IPTC/NAA image decoding with Pillow's pixels, without Pillow.

The JAX package reads every image with `PIL.Image.open(path).convert("RGB")`.
For an IPTC/NAA file this module gives the same uint8 [H, W, 3] array as
Pillow 12.1 (`IptcImagePlugin`):

  * the fields as its `field` reads them: 0x1C, a record of 1-9 or 240, a
    dataset, a 2-byte big-endian length, or where the length's first byte
    is 129-132 that many less 128 bytes after the 5-byte head (the second
    length byte skipped), 128 for none; data cut short is kept short;
  * `_open`: the fields up to the first (8, 10) one; layers and component
    from (3, 60) (1 and 0: L; 3 / 4 and not 0: RGB / CMYK), the band from
    (3, 65) less 1 (0 without it; -1 is the last), the size from (3, 20) /
    (3, 30) and the compression from (3, 120) (1 raw, 5 a file), each
    number the field's bytes read big-endian;
  * `load`: the (8, 10) fields' data joined, behind a "P5" header of the
    size for raw data (`netpbm`), then read as Image.open reads a file
    (`jpeg.decode_image`'s dispatch).  An L image is that file's image
    converted to RGB from the mode Pillow holds it in: F, LAB, La and the
    16-bit modes of one byte order have no such conversion and fail.  An
    RGB or CMYK image is `Image.merge` of zero bands with that image as
    the band's one: an L image at any band, a single-band image of another
    mode at the first (Pillow reads its first bytes as the band: a "1"
    image's 0 / 255), anything else failing as merge fails; then
    Convert.c's conversion to RGB.

A nested IPTC file of an L image is unwrapped in a loop, not by recursion,
and refused past `MAX_DEPTH` levels, where Pillow's own recursion fails
(Python's recursion limit; its depth depends on the caller's stack).  The
port tells the mode of a merged band's file for JPEG, Netpbm and PNG files
(compression 5 is Pillow's "jpeg"); another format in a band, or a band of
palette indices or of 16-bit samples, raises UnsupportedImageFormat.  A
single-band file of mode I or F at the first band crashes Pillow (its merge
reads 8-bit rows that are not there); the port raises ValueError.

A file Pillow's `_open` does not take (a field of another head, no (3, 60)
field, a field number that is no bytes, no mode, a size of 0) is not an
IPTC file to Image.open (it tries its next reader); a field length past 132,
another compression, no (8, 10) field, a bad band, data Image.open cannot
read and a merge Pillow refuses raise ValueError naming the file.
"""

from __future__ import annotations

import struct

import numpy as np

from uniir_tpu_torch.data import fits, im, mcidas, netpbm, raster, tiff

RECORDS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 240)
MAX_DEPTH = 900
# the modes Pillow's readers give that Convert.c cannot convert to RGB directly
_NO_RGB = ("F", "LAB", "La", "I;16B", "I;16L", "I;16N")


class _Fields:
    def __init__(self, data: bytes, name: str, pos: int = 0):
        self.data, self.name, self.pos = data, name, pos

    def read(self, n: int) -> bytes:
        s = self.data[self.pos : self.pos + n]
        self.pos += len(s)
        return s

    def field(self, error) -> tuple:
        """IptcImageFile.field: (tag, size), (None, 0) at zeros or the end; `error` is raised where Pillow
        raises SyntaxError, IndexError or struct.error."""
        s = self.read(5)
        if not s.strip(b"\x00"):
            return None, 0
        if len(s) < 3:
            raise error(f"{self.name}: IPTC field head cut short")
        if s[0] != 0x1C or s[1] not in RECORDS:
            raise error(f"{self.name}: invalid IPTC/NAA file")
        if len(s) < 4:
            raise error(f"{self.name}: IPTC field head cut short")
        size = s[3]
        if size > 132:
            raise ValueError(f"{self.name}: illegal field length {size} in IPTC/NAA file")
        if size == 128:
            return (s[1], s[2]), 0
        if size > 128:
            return (s[1], s[2]), _number(self.read(size - 128))
        if len(s) < 5:
            raise error(f"{self.name}: IPTC field head cut short")
        return (s[1], s[2]), struct.unpack_from(">H", s, 3)[0]


def _number(c) -> int:
    """IptcImagePlugin._i: the last 4 bytes (zeros before) big-endian; TypeError for no bytes."""
    if not isinstance(c, bytes):
        raise TypeError("IPTC field of no bytes")
    return int.from_bytes((bytes(4) + c)[-4:], "big")


def accepts(data: bytes) -> bool:
    return data[:1] == b"\x1c"


def parse(data: bytes, name: str = "<bytes>") -> dict:
    """IptcImageFile._open: mode, size, compression, band and where its (8, 10) fields start (None: none);
    raises raster.NotThisFormat where Image.open tries its next reader."""
    fields, info = _Fields(data, name), {}
    try:
        while True:
            offset = fields.pos
            tag, size = fields.field(raster.NotThisFormat)
            if not tag or tag == (8, 10):
                break
            value = fields.read(size) if size else None
            old = info.get(tag, ...)
            info[tag] = value if old is ... else old + [value] if isinstance(old, list) else [old, value]
        layers, component = info[(3, 60)][0], info[(3, 60)][1]
        band = None
        if layers == 1 and not component:
            mode = "L"
        else:
            mode = "RGB" if layers == 3 and component else "CMYK" if layers == 4 and component else ""
            band = info[(3, 65)][0] - 1 if (3, 65) in info else 0
        size = _number(info[(3, 20)]), _number(info[(3, 30)])
        if (3, 120) not in info or _number(info[(3, 120)]) not in (1, 5):
            raise ValueError(f"{name}: unknown IPTC image compression")
        compression = _number(info[(3, 120)])
    except (IndexError, TypeError, KeyError) as err:
        raise raster.NotThisFormat(f"{name}: not an IPTC/NAA file ({err})") from None
    if not mode:
        raise raster.NotThisFormat(f"{name}: IPTC layers {layers} and component {component} name no mode")
    raster.check_size(*size, name)
    return {"mode": mode, "size": size, "compression": compression, "band": band,
            "offset": offset if tag == (8, 10) else None}


def _joined(data: bytes, p: dict, name: str) -> bytes:
    """IptcImageFile.load's file: the (8, 10) fields' data, behind a P5 header for raw data."""
    if p["offset"] is None:
        raise ValueError(f"{name}: IPTC file without image data (cannot load this image)")
    out = bytearray(b"P5\n%d %d\n255\n" % p["size"] if p["compression"] == 1 else b"")
    fields = _Fields(data, name, p["offset"])
    while True:
        tag, size = fields.field(ValueError)
        if tag != (8, 10):
            return bytes(out)
        out += fields.read(size)


def _mode(kind: str, data: bytes, name: str):
    """Pillow's mode of a file of `kind` where the port can tell it without decoding, else None."""
    from uniir_tpu_torch.data import jpeg

    if kind == "spider":
        return "F"
    if kind in ("fits", "mcidas", "im"):
        return {"fits": fits, "mcidas": mcidas, "im": im}[kind].parse(data, name)["mode"]
    if kind == "tiff":
        return tiff.parse(data, name).mode
    if kind == "netpbm":
        return netpbm.mode(data, name)
    if kind == "jpeg":
        return {1: "L", 3: "RGB", 4: "CMYK"}[len(jpeg.parse(data, name).components)]
    if kind == "png" and len(data) >= 26:  # IHDR's bit depth and colour type
        grey = "1" if data[24] == 1 else "I;16" if data[24] == 16 else "L"
        return {0: grey, 2: "RGB", 3: "P", 4: "LA", 6: "RGBA"}.get(data[25])
    return None


def decode(data: bytes, name: str = "<bytes>", device="cpu") -> np.ndarray:
    """uint8 [H, W, 3]: `PIL.Image.open(path).convert("RGB")` of an IPTC/NAA file; its image file is decoded
    as a run on `device` decodes it."""
    from uniir_tpu_torch.data import jpeg

    data = bytes(data)
    for _ in range(MAX_DEPTH):
        p = parse(data, name)
        inner = _joined(data, p, name)
        kind = jpeg.image_format(inner)
        if p["band"] is None and kind == "iptc":
            data = inner  # the nested file's image, converted once at the top
            continue
        if p["band"] is None:
            mode = _mode(kind, inner, name)
            if mode in _NO_RGB:
                raise ValueError(f"{name}: IPTC image of mode {mode}: conversion from {mode} to RGB not supported")
            return jpeg.decode_image(inner, name, device)
        return _merged(p, kind, inner, name, device)
    raise ValueError(f"{name}: IPTC files nested past {MAX_DEPTH} levels (maximum recursion depth exceeded)")


def _merged(p: dict, kind: str, inner: bytes, name: str, device) -> np.ndarray:
    """Image.merge of the outer mode's bands, zero but the one the inner file fills, converted to RGB."""
    from uniir_tpu_torch.data import jpeg

    bands = 3 if p["mode"] == "RGB" else 4
    if not -bands <= p["band"] < bands:
        raise ValueError(f"{name}: IPTC band {p['band']} of {bands} (list assignment index out of range)")
    index = p["band"] % bands
    mode = _mode(kind, inner, name) if kind in ("jpeg", "netpbm", "png") else None
    if kind == "unknown":
        raise ValueError(f"{name}: IPTC image data of no format (cannot identify image file)")
    if mode is None:
        raise jpeg.UnsupportedImageFormat(f"{name}: IPTC band of a {kind} file, whose mode the port does not tell")
    if index and mode != "L" or netpbm.BANDS.get(mode, 2) > 1:
        raise ValueError(f"{name}: IPTC band of mode {mode} in band {index} of {p['mode']} (mode mismatch)")
    if mode in ("I", "F"):
        raise ValueError(f"{name}: IPTC band of mode {mode} (Pillow's merge reads 8-bit rows it has not)")
    if mode not in ("1", "L"):  # P's indices, I;16's bytes
        raise jpeg.UnsupportedImageFormat(f"{name}: IPTC band of mode {mode}, whose samples the port does not keep")
    plane = jpeg.decode_image(inner, name, device)[..., 0]
    out = np.zeros(plane.shape + (bands,), np.uint8)
    out[..., index] = plane
    return out if bands == 3 else jpeg.cmyk_to_rgb(out)


def decoder_for(device):
    """The decoder a run on `device` uses: its image file through that run's decoders."""
    return lambda data, name="<bytes>": decode(data, name, device)
