"""ICO / CUR (`uniir_tpu_torch.data.ico`) and Netpbm (`uniir_tpu_torch.data.netpbm`)
decoding bit-equal to Pillow 12.1's `Image.open(...).convert("RGB")`, or
refused where Pillow refuses: icons Pillow writes (PNG and BMP entries at 1,
8, 24 and 32 bits) and icons and cursors built here (4-bit DIBs, several
entries, cut-short masks); every Netpbm form, plain and binary, maxvals
other than 255, 16-bit samples, comments, PFM; and `read_image`'s dispatch,
which decodes them and raises `UnsupportedImageFormat` only for a format
the port does not decode yet, named by the test Pillow's reader for it makes
(TGA too, which has no signature), and calls data that no reader
identifies corrupt."""

import io

import numpy as np
import pytest

import chip_smoke
from uniir_tpu_torch.data import ico, jpeg, netpbm


def pillow(data: bytes):
    """Pillow's pixels, or the name of the exception it raises."""
    from PIL import Image

    try:
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except Exception as e:  # noqa: BLE001 -- any refusal counts as one
        return type(e).__name__


def port(data: bytes):
    try:
        return jpeg.decode_image(data, "f", "cpu")
    except ValueError as e:
        assert not isinstance(e, jpeg.UnsupportedImageFormat), e
        return "refused"


def assert_same(data: bytes) -> None:
    want, got = pillow(data), port(data)
    if isinstance(want, str):
        assert got == "refused", want
    else:
        assert not isinstance(got, str), f"Pillow reads it, the port says {got}"
        np.testing.assert_array_equal(got, want)


def rgba(seed: int, w: int, h: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (h, w, 4), dtype=np.uint8)


@pytest.mark.parametrize("bitmap", ["png", "bmp"])
@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA"])
def test_icons_pillow_writes(mode, bitmap):
    """Two or three sizes an icon; Pillow picks the largest."""
    from PIL import Image

    for k, (w, h) in enumerate([(1, 1), (7, 5), (33, 20), (64, 64)]):
        arr = rgba(k, w, h)
        im = Image.fromarray(arr, "RGBA")
        im = im.convert("L").convert("1") if mode == "1" else im.convert(mode)
        buf = io.BytesIO()
        im.save(buf, "ICO", sizes=[(w, h), (max(1, w // 2), max(1, h // 2))], bitmap_format=bitmap)
        data = buf.getvalue()
        assert jpeg.image_format(data) == "ico"
        assert_same(data)
        assert_same(data[: len(data) - 3])  # the mask (or the PNG's end) cut short


def dib_entry(image: np.ndarray, bits: int, mask: bool = True) -> bytes:
    """A DIB (BMP without its file header) of twice the height, with an AND mask."""
    h, w = image.shape[:2]
    if bits <= 8:
        idx, cube = chip_smoke.colour_cube(image[..., :3])
        idx = (idx.astype(np.int64) % (1 << bits)).astype(np.uint8)
        data = chip_smoke.bmp_bytes(idx, bits, palette=cube[: 3 << bits])
    else:
        data = chip_smoke.bmp_bytes(image[..., : 4 if bits == 32 else 3], bits)
    dib = bytearray(data[14:])
    dib[8:12] = (2 * h).to_bytes(4, "little")
    return bytes(dib) + (bytes(-(-w // 32) * 4 * h) if mask else b"")


def icon(entries: list, kind: int = 1) -> bytes:
    """An ICO (kind 1) or CUR (kind 2) of (data, width byte, height byte, colours, bpp) entries."""
    out = b"\0\0" + kind.to_bytes(2, "little") + len(entries).to_bytes(2, "little")
    offset = 6 + 16 * len(entries)
    for data, w, h, colours, bpp in entries:
        out += bytes([w, h, colours, 0]) + (1).to_bytes(2, "little") + bpp.to_bytes(2, "little")
        out += len(data).to_bytes(4, "little") + offset.to_bytes(4, "little")
        offset += len(data)
    return out + b"".join(e[0] for e in entries)


@pytest.mark.parametrize("bits", [1, 4, 8, 24, 32])
def test_icon_dib_entries(bits):
    for k, (w, h) in enumerate([(1, 1), (5, 3), (31, 17), (40, 40)]):
        img = rgba(10 * bits + k, w, h)
        entry = dib_entry(img, bits)
        assert_same(icon([(entry, w, h, 0, bits)]))
        assert_same(icon([(entry, w, h, 0, 32 if bits != 32 else 24)]))  # the entry's bpp picks the mask
        assert_same(icon([(entry[:-2], w, h, 0, bits)]))  # the mask cut short
        assert_same(icon([(dib_entry(img, bits, mask=False), w, h, 0, bits)]))
        assert_same(icon([(entry, w, h, 0, bits)], kind=2))  # as a cursor


def test_icon_entry_choice():
    """The largest area first; among equal areas the lowest colour depth (bpp, else the colour count),
    then the file's order; a width or height byte of 0 means 256."""
    a, b, c = rgba(1, 16, 16), rgba(2, 16, 16), rgba(3, 8, 8)
    ea, eb, ec = dib_entry(a, 24), dib_entry(b, 8), dib_entry(c, 32)
    for entries in ([(ea, 16, 16, 0, 24), (eb, 16, 16, 0, 8)], [(eb, 16, 16, 0, 8), (ea, 16, 16, 0, 24)],
                    [(ec, 8, 8, 0, 32), (ea, 16, 16, 0, 24)], [(ea, 16, 16, 0, 0), (eb, 16, 16, 16, 0)],
                    [(ea, 16, 16, 0, 24), (ec, 0, 0, 0, 32)], [(ea, 16, 16, 0, 24), (eb, 16, 16, 0, 24)]):
        assert_same(icon(entries))
        assert_same(icon(entries, kind=2))
    png = chip_smoke.png_bytes(a[..., :3], 2)
    assert_same(icon([(ea, 16, 16, 0, 24), (png, 0, 0, 0, 32)]))  # a PNG entry, its own size read
    assert_same(icon([]))
    assert_same(icon([(ea, 16, 16, 0, 24)])[:20])


def netpbm_cases() -> dict:
    rng = np.random.default_rng(0)
    cases = {}
    for w, h in ((1, 1), (5, 3), (9, 7)):
        grey, rgb = rng.integers(0, 256, (h, w), dtype=np.uint8), rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        bits = rng.integers(0, 2, (h, w))
        cases[f"P4 {w}x{h}"] = b"P4\n%d %d\n" % (w, h) + np.packbits(bits, axis=1).tobytes()
        cases[f"P1 {w}x{h}"] = b"P1\n# c\n%d %d\n" % (w, h) + b"".join(b"%d" % v for v in bits.ravel())
        cases[f"P1 spaced {w}x{h}"] = b"P1 %d %d\n" % (w, h) + b" ".join(b"%d" % v for v in bits.ravel())
        for maxval in (1, 7, 100, 255, 256, 1000, 65535):
            g = (grey.astype(np.int64) * maxval // 255).ravel()
            c = (rgb.astype(np.int64) * maxval // 255).ravel()
            wide = ">u2" if maxval > 255 else np.uint8
            cases[f"P5 {maxval} {w}x{h}"] = b"P5 %d %d %d\n" % (w, h, maxval) + g.astype(wide).tobytes()
            cases[f"P6 {maxval} {w}x{h}"] = b"P6\t%d\r%d #x\n%d\n" % (w, h, maxval) + c.astype(wide).tobytes()
            cases[f"P2 {maxval} {w}x{h}"] = b"P2\n%d %d\n%d\n" % (w, h, maxval) + b"\n".join(b"%d" % v for v in g)
            cases[f"P3 {maxval} {w}x{h}"] = b"P3 %d %d %d " % (w, h, maxval) + b"  ".join(b"%d" % v for v in c)
        f = rng.normal(100, 200, (h, w)).astype(np.float32)
        f.flat[0] = np.nan
        cases[f"Pf le {w}x{h}"] = b"Pf\n%d %d\n-1.0\n" % (w, h) + f.astype("<f4").tobytes()
        cases[f"Pf be {w}x{h}"] = b"Pf\n%d %d\n2.5\n" % (w, h) + f.astype(">f4").tobytes()
        cases[f"P0CMYK {w}x{h}"] = b"P0CMYK %d %d 255\n" % (w, h) + rng.integers(0, 256, w * h * 4, dtype=np.uint8).tobytes()
        cases[f"PyRGBA {w}x{h}"] = b"PyRGBA %d %d 255\n" % (w, h) + rng.integers(0, 256, w * h * 4, dtype=np.uint8).tobytes()
        cases[f"PyP {w}x{h}"] = b"PyP %d %d 255\n" % (w, h) + grey.tobytes()
    cases.update({
        "zero width": b"P5\n0 1\n255\n", "maxval 0": b"P5\n1 1\n0\n\0",
        "value over maxval": b"P3\n1 1\n255\n1 2 300", "negative": b"P2 1 1 255 -1",
        "comment inside a number": b"P2\n2 1\n255\n1 2#c\n3", "comment in the maxval": b"P5 1 1 255#x\n\x05",
        "plain too short": b"P2 3 1 255 1 2", "P1 bad digit": b"P1 2 1 0 2", "raw too short": b"P6 2 2 255\n" + bytes(11),
        "16-bit too short": b"P5 2 1 1000\n\x00\x01\x00", "token too long": b"P5 12345678901 1 255\n",
        "header cut": b"P6 4", "scale 0": b"Pf 1 1 0.0\n" + bytes(4), "scale nan": b"Pf 1 1 nan\n" + bytes(4),
        "float cut": b"Pf 2 1 1.0\n" + bytes(5),
    })
    return cases


NETPBM = netpbm_cases()


@pytest.mark.parametrize("name", sorted(NETPBM))
def test_netpbm_forms(name):
    data = NETPBM[name]
    assert jpeg.image_format(data) == "netpbm"
    assert_same(data)


@pytest.mark.parametrize("data", [b"PF\n1 1\n-1.0\n" + bytes(12), b"P7\n1 1\n255\n\0"], ids=["PF", "P7"])
def test_netpbm_forms_no_reader_accepts(data):
    """Colour PFM and PAM: no Pillow plugin accepts them, so the port reads them as of an unknown format,
    which it calls corrupt (a plain ValueError), as the JAX pass deletes what Image.open cannot identify."""
    assert jpeg.image_format(data) == "unknown" and pillow(data) == "UnidentifiedImageError"
    with pytest.raises(ValueError, match="cannot identify image file") as e:
        jpeg.decode_image(data, "f", "cpu")
    assert not isinstance(e.value, jpeg.UnsupportedImageFormat)


def test_pillows_own_netpbm_files():
    from PIL import Image

    rng = np.random.default_rng(1)
    for mode in ("1", "L", "RGB", "I;16"):
        arr = rng.integers(0, 65536 if mode == "I;16" else 256, (13, 11, 3 if mode == "RGB" else 1))
        im = Image.fromarray(arr.astype(np.uint16)[..., 0]) if mode == "I;16" else \
            Image.fromarray(arr.astype(np.uint8).squeeze(-1) if mode != "RGB" else arr.astype(np.uint8)).convert(mode)
        buf = io.BytesIO()
        im.save(buf, "PPM")
        assert_same(buf.getvalue())


def test_read_image_dispatch_and_the_two_kinds_of_failure(tmp_path):
    """ICO, CUR and Netpbm files decode through `read_image`; a format not decoded yet (EPS) raises
    UnsupportedImageFormat (a ValueError); corrupt data raises the decoders' own ValueError."""
    img = rgba(5, 9, 6)
    files = {"a.ico": icon([(dib_entry(img, 24), 9, 6, 0, 24)]), "b.cur": icon([(dib_entry(img, 8), 9, 6, 0, 8)], 2),
             "c.ppm": b"P6 2 1 255\n" + bytes(range(6))}
    for name, data in files.items():
        (tmp_path / name).write_bytes(data)
        np.testing.assert_array_equal(jpeg.read_image(str(tmp_path / name), "cpu"), pillow(data))
    assert [jpeg.image_format(d) for d in files.values()] == ["ico", "cur", "netpbm"]
    (tmp_path / "q.png").write_bytes(b"%!PS-Adobe-3.0 EPSF-3.0\n" + bytes(20))
    with pytest.raises(jpeg.UnsupportedImageFormat, match="EPS image"):
        jpeg.read_image(str(tmp_path / "q.png"), "cpu")
    for corrupt in (files["a.ico"][:30], b"P6 2 1 255\n\x00", b"", b"\xff\xd8\xff\xdb"):
        (tmp_path / "x.jpg").write_bytes(corrupt)
        with pytest.raises(ValueError) as e:
            jpeg.read_image(str(tmp_path / "x.jpg"), "cpu")
        assert not isinstance(e.value, jpeg.UnsupportedImageFormat)
    assert ico.ICO_SIGNATURE == b"\0\0\1\0" and netpbm.accepts(b"Pf")


# (Pillow's save format, mode, the port's name for it): formats Image.open reads that the port does not decode
# (TGA, IM, PCX, SGI, DIB, MSP, XBM and QOI are decoded now: their cases are in tests/test_torch_raster_formats.py;
# ICNS, DDS, JPEG 2000 and SPIDER too, whose cases here decode as Pillow does, more in
# tests/test_torch_container_formats.py, tests/test_torch_jpeg2000*.py and tests/test_torch_rare_formats.py)
PILLOW_WRITTEN_REFUSED = [("SPIDER", "F", "spider"), ("EPS", "RGB", "EPS"), ("ICNS", "RGB", "icns"),
                          ("DDS", "RGB", "dds"), ("JPEG2000", "RGB", "jpeg2000")]


@pytest.mark.parametrize("case", PILLOW_WRITTEN_REFUSED,
                         ids=[f"{c[0]}-{c[1]}{'-rle' if len(c) > 3 else ''}" for c in PILLOW_WRITTEN_REFUSED])
def test_files_pillow_writes_in_formats_not_decoded_are_named(case):
    """A file Pillow writes and reads back, in a format the port does not decode, raises
    UnsupportedImageFormat naming the format: the image pass leaves it in place.  ICNS, DDS, JPEG 2000 and
    SPIDER, decoded now, give Pillow's pixels."""
    from PIL import Image

    fmt, mode, label, *options = case
    img = Image.fromarray(np.random.default_rng(7).integers(0, 256, (9, 13, 3), dtype=np.uint8))
    img = img.convert("L").convert("F") if mode == "F" else img.convert(mode)
    buf = io.BytesIO()
    img.save(buf, fmt, **(options[0] if options else {}))
    data = buf.getvalue()
    assert Image.open(io.BytesIO(data)).format == fmt
    assert jpeg.image_format(data) == label
    if label in ("icns", "dds", "jpeg2000", "spider"):
        np.testing.assert_array_equal(jpeg.decode_image(data, "f", "cpu"), pillow(data))
        return
    with pytest.raises(jpeg.UnsupportedImageFormat, match=rf"^f: {label} image"):
        jpeg.decode_image(data, "f", "cpu")


NO_READER = {
    "zeros": bytes(3000), "html": b"<!DOCTYPE html>\n<html><head><title>404 Not Found</title></head></html>\n",
    "text": b"hello world\nfoo bar\n", "json": b'{"error": "not found"}\n',
    "xml": b'<?xml version="1.0"?>\n<Error><Code>AccessDenied</Code></Error>\n',
    "noise": np.random.default_rng(3).integers(0, 256, 5000, dtype=np.uint8).tobytes(),
    "cursor of no entries": b"\0\0\2\0\0\0" + bytes(40), "icon of no entries": b"\0\0\1\0\0\0" + bytes(40),
    "imt without pixels": b"width 3\nheight 2\n\x0c" + bytes(6),
    "tga of type 0": bytes(12) + b"\x03\x00\x02\x00\x18\x00" + bytes(18),
}


@pytest.mark.parametrize("name", sorted(NO_READER))
def test_data_no_reader_identifies_is_corrupt(name):
    """What a scraped tree holds under an image's name when the server sent something else (an error page, a
    zero-filled file): Image.open identifies no format, so the JAX pass deletes it; the port reads it as
    "unknown" and raises a plain ValueError, so its pass deletes it too."""
    data = NO_READER[name]
    assert pillow(data) == "UnidentifiedImageError"
    assert jpeg.image_format(data) == "unknown"
    with pytest.raises(ValueError) as e:
        jpeg.decode_image(data, "f", "cpu")
    assert not isinstance(e.value, jpeg.UnsupportedImageFormat)


# Pillow 12.1's openers -> the port's name for each: decoded, or named in `jpeg._REFUSED`
PILLOW_OPENERS = {"AVIF": "avif", "BLP": "blp", "BMP": "bmp", "DIB": "dib", "BUFR": "BUFR", "CUR": "cur",
                  "PCX": "pcx", "DCX": "dcx", "DDS": "dds", "EPS": "EPS", "FITS": "fits", "FLI": "fli",
                  "FTEX": "ftex", "GBR": "gbr", "GIF": "gif", "GRIB": "GRIB", "HDF5": "HDF5", "PNG": "png",
                  "JPEG2000": "jpeg2000", "ICNS": "icns", "ICO": "ico", "IM": "im", "IMT": "imt", "IPTC": "iptc",
                  "JPEG": "jpeg", "MCIDAS": "mcidas", "MPEG": "MPEG", "TIFF": "tiff", "MSP": "msp", "PCD": "pcd",
                  "PIXAR": "pixar", "PPM": "netpbm", "PSD": "psd", "QOI": "qoi", "SGI": "sgi", "SPIDER": "spider",
                  "SUN": "sun", "TGA": "tga", "WEBP": "webp", "WMF": "WMF", "XBM": "xbm", "XPM": "xpm",
                  "XVTHUMB": "xvthumb"}


def test_every_format_pillow_identifies_is_decoded_or_named():
    """Every reader Image.open tries has a name in the port, so "unknown" is what Pillow cannot identify; a
    Pillow that adds a reader fails this until the port names it."""
    from PIL import Image

    Image.init()
    assert set(Image.ID) <= set(PILLOW_OPENERS), sorted(set(Image.ID) - set(PILLOW_OPENERS))
    decoded = {"jpeg", "png", "gif", "bmp", "dib", "webp", "tiff", "ico", "cur", "netpbm", "pcx", "dcx", "im", "msp",
               "qoi", "sgi", "sun", "tga", "xbm", "xpm", "dds", "icns", "psd", "jpeg2000", "blp", "ftex", "gbr", "imt",
               "mcidas", "pixar", "spider", "xvthumb", "fits", "fli", "iptc", "pcd", "avif"}
    assert set(PILLOW_OPENERS.values()) == {label for _, label in jpeg._REFUSED} | decoded
