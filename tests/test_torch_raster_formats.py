"""DIB, QOI, TGA, SGI, PCX / DCX, Sun raster, MSP, XBM, XPM and IM in the port
against Pillow 12.1.

The JAX package reads every image with `PIL.Image.open(path).convert("RGB")`;
`data.jpeg.decode_image` must give the same pixels, bit for bit, for a file of
each of these formats, and fail where Pillow fails: on files Pillow writes
(DIB, QOI, TGA with and without `tga_rle`, SGI at 8 and 16 bits, PCX, MSP v1,
XBM, IM), on files built here where Pillow cannot write the form (DCX, Sun
raster of every type, MSP v2, XPM, RLE SGI, colour-mapped TGA with
`colormap_first`, 15 / 16-bit TGA, planar PCX), on every truncation and on
seeded corruptions of them, and where several of Image.open's readers could
take the same bytes.  Pillow is read from a file, as the JAX package reads it.

The byte-serial stages are `data/raster.py`'s Python twins here; their native
halves (csrc/raster.cu, built by nvcc on the card's machine) are held to the
twins by the `-m gpu` tests at the end and by chip_smoke.py's decoder phase.
"""

import atexit
import io
import json
import os
import shutil
import struct
import tempfile

import numpy as np
import pytest
import torch

import chip_smoke
from uniir_tpu_torch.data import jpeg, msp, pcx, qoi, raster, sgi, sun, tga

_DIR = tempfile.mkdtemp(prefix="raster_formats_")  # Pillow reads a file, as the JAX package does
atexit.register(shutil.rmtree, _DIR, True)


def pillow(data: bytes):
    """(format, uint8 [H, W, 3]) of Image.open(path).convert("RGB"), or None where Pillow raises."""
    from PIL import Image

    path = os.path.join(_DIR, "f")
    with open(path, "wb") as f:
        f.write(data)
    try:
        with Image.open(path) as img:
            return img.format, np.asarray(img.convert("RGB"))
    except Exception:
        return None


def port(data: bytes):
    """The port's decode of the same bytes: an array, "unsupported" or "error"."""
    try:
        return jpeg.decode_image(data, "f", "cpu")
    except jpeg.UnsupportedImageFormat:
        return "unsupported"
    except ValueError:
        return "error"


# Pillow's format name -> the port's
KINDS = {"DIB": "dib", "QOI": "qoi", "TGA": "tga", "SGI": "sgi", "PCX": "pcx", "DCX": "dcx", "SUN": "sun",
         "MSP": "msp", "XBM": "xbm", "XPM": "xpm", "IM": "im", "BMP": "bmp", "ICO": "ico", "CUR": "cur",
         "PPM": "netpbm", "TIFF": "tiff", "WEBP": "webp", "GIF": "gif", "PNG": "png", "JPEG": "jpeg",
         "FLI": "fli"}


def assert_same(data: bytes, what: str = "") -> None:
    """The port decodes `data` as Pillow does, or fails where Pillow fails (not as a format it refuses)."""
    want, got = pillow(data), port(data)
    if want is None:
        assert isinstance(got, str) and got == "error", (what, got if isinstance(got, str) else got.shape)
        return
    assert jpeg.image_format(data) == KINDS.get(want[0], want[0]), (what, want[0], jpeg.image_format(data))
    assert not isinstance(got, str), (what, want[0], got)
    np.testing.assert_array_equal(got, want[1], err_msg=what)


def rng_image(seed: int, h: int = 9, w: int = 13, c: int = 3) -> np.ndarray:
    """Seeded samples with runs along the rows and repeated rows, so run-length coders find both kinds."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    img = np.where(rng.random((h, w, 1)) < 0.5, img[:, :1], img)
    return np.where(rng.random((h, 1, 1)) < 0.3, img[:1], img).astype(np.uint8)


# --- files Pillow writes


def pillow_file(fmt: str, mode: str, seed: int = 7, **options) -> bytes:
    from PIL import Image

    img = Image.fromarray(rng_image(seed))
    if mode == "P":
        img = img.quantize(23)
    elif mode == "PA":
        img = img.quantize(23).convert("PA")
    elif mode in ("I", "F"):
        img = img.convert("L").convert(mode)
    elif mode in ("I;16", "I;16B"):
        img = Image.frombytes(mode, img.size, rng_image(seed, c=2).tobytes())
    else:
        img = img.convert(mode)
    buf = io.BytesIO()
    img.save(buf, fmt, **options)
    return buf.getvalue()


# the cases of test_files_pillow_writes_in_formats_not_decoded_are_named (tests/test_torch_ico_netpbm.py)
# whose formats are decoded now, with the same ids, and more of Pillow's writers' modes
PILLOW_WRITTEN = [("TGA", "RGB"), ("TGA", "L"), ("TGA", "P"), ("TGA", "1"), ("TGA", "RGBA"), ("IM", "RGB"),
                  ("IM", "L"), ("PCX", "RGB"), ("SGI", "RGB"), ("DIB", "RGB"), ("MSP", "1"), ("XBM", "1"),
                  ("QOI", "RGB")]
PILLOW_WRITTEN += [("TGA", mode, {"compression": "tga_rle"}) for mode in ("RGB", "L", "P")]
PILLOW_WRITTEN += [("TGA", "LA"), ("TGA", "RGBA", {"compression": "tga_rle"}), ("TGA", "LA", {"compression": "tga_rle"}),
                   ("TGA", "1", {"compression": "tga_rle"}), ("TGA", "RGB", {"orientation": 1}),
                   ("IM", "1"), ("IM", "LA"), ("IM", "P"), ("IM", "PA"), ("IM", "I"), ("IM", "I;16"), ("IM", "I;16B"),
                   ("IM", "F"), ("IM", "RGBA"), ("IM", "RGBX"), ("IM", "CMYK"), ("PCX", "1"), ("PCX", "L"),
                   ("PCX", "P"), ("SGI", "L"), ("SGI", "RGBA"), ("SGI", "RGB", {"bpc": 2}), ("SGI", "L", {"bpc": 2}),
                   ("DIB", "1"), ("DIB", "L"), ("DIB", "P"), ("DIB", "RGBA"), ("QOI", "RGBA"),
                   ("XBM", "1", {"hotspot": (3, 4)})]


def _case_id(case) -> str:
    fmt, mode, *options = case
    if not options:
        return f"{fmt}-{mode}"
    return f"{fmt}-{mode}-" + ("rle" if options[0] == {"compression": "tga_rle"} else
                                "-".join(f"{k}{v}" for k, v in options[0].items()))


@pytest.mark.parametrize("case", PILLOW_WRITTEN, ids=[_case_id(c) for c in PILLOW_WRITTEN])
def test_files_pillow_writes_decode_as_pillow_does(case):
    """A file Pillow writes decodes to Pillow's pixels (a 1-bit RLE TGA, which Pillow writes and cannot read
    back, fails in both)."""
    fmt, mode, *options = case
    data = pillow_file(fmt, mode, **(options[0] if options else {}))
    assert_same(data, _case_id(case))
    if case == ("TGA", "1", {"compression": "tga_rle"}):
        assert pillow(data) is None
    else:
        assert pillow(data)[0] == fmt


# the bytes test_formats_pillow_reads_and_the_port_does_not_are_named (tests/test_torch_png.py) named these
# formats by, followed by 64 zero bytes as there
SIGNATURE_STUBS = {"QOI": b"qoif\x00\x00\x00\x04", "SGI": b"\x01\xda\x00\x01", "PCX": b"\x0a\x05\x01\x08",
                   "Sun raster": b"\x59\xa6\x6a\x95", "XBM": b"#define im_width 8", "XPM": b"/* XPM */\n"}


@pytest.mark.parametrize("name", sorted(SIGNATURE_STUBS))
def test_signature_stubs_once_named_decode_as_pillow_does(tmp_path, name):
    """A signature and zeros: what Pillow makes of it (an image of no pixels is not one, a header cut short
    fails), the port makes of it, through `read_image`."""
    data = SIGNATURE_STUBS[name] + bytes(64)
    assert_same(data, name)
    path = tmp_path / "x.jpg"
    path.write_bytes(data)
    with pytest.raises(ValueError) as e:
        jpeg.read_image(str(path), "cpu")
    assert not isinstance(e.value, jpeg.UnsupportedImageFormat)


# --- files built here


def _tga(id_len, cmap_type, image_type, cmap_first, cmap_len, cmap_depth, w, h, depth, flags, body, ident=b"",
         cmap=b""):
    return struct.pack("<BBBHHBHHHHBB", id_len, cmap_type, image_type, cmap_first, cmap_len, cmap_depth, 0, 0, w, h,
                       depth, flags) + ident + cmap + body


def _im(lines, body, lut=b""):
    return b"".join(line + b"\r\n" for line in lines) + b"\x1a" + lut + body


def _xpm(w, h, keys, colours, pixels, pixel_header=True):
    out = [b"/* XPM */", b"static char *x[] = {", b'"%d %d %d %d",' % (w, h, len(keys), len(keys[0]))]
    out += [b'"' + k + b" c " + c + b'",' for k, c in zip(keys, colours)]
    out += [b"/* pixels */"] if pixel_header else []
    out += [b'"' + b"".join(keys[i] for i in row) + b'",' for row in pixels]
    return b"\n".join(out + [b"};"]) + b"\n"


def hand_built() -> dict:
    """Files of the forms Pillow cannot write, seeded."""
    rng = np.random.default_rng(11)
    img = rng_image(12, 11, 17, 4)
    idx = (img[..., 0] >> 4).astype(np.uint8)
    palette = rng.integers(0, 256, 768, dtype=np.uint8).tobytes()
    px16 = rng.integers(0, 65536, 12, dtype=np.uint16).astype("<u2").tobytes()
    chars = [bytes([c]) for c in b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"]
    two = [a + b for a in chars for b in chars]
    files = {
        "dcx": chip_smoke.dcx_bytes([chip_smoke.pcx_bytes(img[..., :3]), chip_smoke.pcx_bytes(idx, palette=palette)]),
        "dcx_planar_page": chip_smoke.dcx_bytes([chip_smoke.pcx_bytes(idx, palette=palette[:48], planes_of_bits=4)]),
        "msp_v2": chip_smoke.msp_bytes(img[..., 0] > 127),
        "msp_v2_odd_width": chip_smoke.msp_bytes(img[:, :13, 0] > 64),
        "msp_v2_blank_row": chip_smoke.msp_bytes(img[..., 0] > 127)[:32] + struct.pack("<H", 0)
        + chip_smoke.msp_bytes(img[..., 0] > 127)[34:],
        "tga_cmap_first": chip_smoke.tga_bytes(idx, palette=palette[:48], cmap_first=3, rle=False),
        "tga_cmap_first_rle": chip_smoke.tga_bytes(idx, palette=palette[:48], cmap_first=2),
        "tga_cmap16": chip_smoke.tga_bytes(idx, palette=palette[:48], cmap_depth=16),
        "tga_15_16bit": _tga(0, 0, 2, 0, 0, 0, 4, 3, 16, 0x00, px16),
        "tga_16bit_mirrored": _tga(0, 0, 2, 0, 0, 0, 4, 3, 16, 0x30, px16),
        "tga_16bit_rle": _tga(0, 0, 10, 0, 0, 0, 4, 3, 16, 0x20, bytes([0x83]) + px16[:2] + bytes([0x07]) + px16[:16]),
        "tga_id_and_grey_map": _tga(5, 1, 3, 0, 4, 24, 4, 2, 8, 0x20, bytes([0, 1, 2, 3, 3, 2, 1, 0]), ident=b"12345",
                                    cmap=palette[:12]),
        "tga_literal_across_rows": _tga(0, 0, 11, 0, 0, 0, 2, 3, 8, 0x20, bytes([0x02, 1, 2, 3, 0x00, 9, 0x81, 5])),
        "tga_run_across_rows": _tga(0, 0, 11, 0, 0, 0, 2, 3, 8, 0x20, bytes([0x82, 1, 0x00, 9, 0x81, 5])),
        "tga_32bit_map": _tga(0, 1, 1, 0, 3, 32, 3, 2, 8, 0x20, bytes([0, 1, 2, 2, 1, 0]), cmap=bytes(range(12))),
        "tga_map_on_rgb": _tga(0, 1, 2, 0, 2, 24, 2, 1, 24, 0x20, bytes(range(6)), cmap=bytes(6)),
        "sgi_rle": chip_smoke.sgi_bytes(img[..., :3]),
        "sgi_rle_rgba": chip_smoke.sgi_bytes(img),
        "sgi_rle_grey": chip_smoke.sgi_bytes(img[..., :1]),
        "sgi_rle_16bit": chip_smoke.sgi_bytes(img[..., :3].astype(np.uint16) * 257 + 5),
        "pcx_planar_4": chip_smoke.pcx_bytes(idx, palette=palette[:48], planes_of_bits=4),
        "pcx_planar_2": chip_smoke.pcx_bytes(idx & 3, palette=palette[:48], planes_of_bits=2),
        "pcx_planar_odd_width": chip_smoke.pcx_bytes(idx[:, :3], palette=palette[:48], planes_of_bits=4),
        "pcx_grey_ramp_tail": chip_smoke.pcx_bytes(np.tile(img[..., 0], (4, 4)),
                                                   palette=bytes(np.repeat(np.arange(256, dtype=np.uint8), 3))),
        "pcx_palette_tail": chip_smoke.pcx_bytes(np.tile(img[..., 0], (4, 4)), palette=palette),
        "pcx_rgb_width_3": chip_smoke.pcx_bytes(img[:, :3, :3]),
        "im_b2": _im([b"Image type: B2 image", b"Image size (x*y): 5*3"], bytes(rng.integers(0, 256, 6, np.uint8))),
        "im_b4_lut": _im([b"Image type: B4 image", b"Image size (x*y): 5*3", b"Lut: 1"],
                         bytes(rng.integers(0, 256, 9, np.uint8)), lut=palette),
        "im_grey_lut": _im([b"Image type: L image", b"Image size (x*y): 5*3", b"Lut: 1"],
                           bytes(rng.integers(0, 256, 15, np.uint8)), lut=palette),
        "im_rgb3": _im([b"Image type: RGB3 image", b"Image size (x*y): 5*3"], bytes(rng.integers(0, 256, 45, np.uint8))),
        "im_l12_bits": _im([b"Image type: L*12 image", b"Image size (x*y): 5*3"],
                           bytes(rng.integers(0, 256, 30, np.uint8))),
        "im_l8s": _im([b"Image type: L 8S image", b"Image size (x*y): 5*3", b"Name: x"],
                      bytes(rng.integers(0, 256, 15, np.uint8))),
        "im_rlb": _im([b"Image type: RLB image", b"Image size (x*y): 5*3"], bytes(45)),
        "xpm": _xpm(7, 6, chars[:9], [b"#%06x" % int(v) for v in rng.integers(0, 1 << 24, 9)],
                    rng.integers(0, 9, (6, 7))),
        "xpm_transparent": _xpm(7, 6, chars[:9], [b"#ff0000"] * 8 + [b"None"], rng.integers(0, 8, (6, 7)), False),
        "xpm_transparent_used": _xpm(7, 6, chars[:9], [b"#ff0000"] * 8 + [b"None"], rng.integers(0, 9, (6, 7))),
        "xpm_over_256_colours": _xpm(7, 6, two[:300], [b"#%06x" % int(v) for v in rng.integers(0, 1 << 24, 300)],
                                     rng.integers(0, 300, (6, 7))),
        "xpm_short_hex": b'/* XPM */\nstatic char *x[] = {\n"3 2 2 1",\n"a c #ff0000",\n"b s x c #fff",\n"abb",\n"bab"\n};\n',
        "xbm_hex_quirks": b"  #define a_width 10\n#define a_height 2\nstatic char a_bits[] = {0x1, 0xFx, 0x3g,\n 0xx12 0x9A};\n",
        "dib_core_header": chip_smoke.bmp_bytes(idx, 8, palette=palette, header=12)[14:],
        "dib_rle8": chip_smoke.bmp_bytes(idx, 8, palette=palette, compression=chip_smoke.BMP_RLE8)[14:],
        "dib_bitfields": chip_smoke.bmp_bytes(img[..., :3], 16, compression=chip_smoke.BMP_BITFIELDS,
                                              masks=(0xF800, 0x7E0, 0x1F))[14:],
    }
    for depth in (1, 4, 8, 24, 32):
        for kind in (0, 1, 2, 3):
            w, h = 7, 5
            stride, row = (w * depth + 15) // 16 * 2, (w * depth + 7) // 8
            data = bytes(rng.integers(0, 4, row * h, dtype=np.uint8) * 0x40) if kind == 2 else \
                bytes(rng.integers(0, 256, stride * h, dtype=np.uint8))
            if kind == 2:  # the writer's RLE of raw bytes
                data = chip_smoke.sun_bytes(np.frombuffer(data, np.uint8).reshape(h, row), kind=2)[32:]
            head = struct.pack(">8I", 0x59A66A95, w, h, depth, len(data), kind, 0, 0)
            files[f"sun_{depth}bit_type{kind}"] = head + data
    files["sun_8bit_map"] = chip_smoke.sun_bytes(idx, kind=1, palette=palette[:48])
    files["sun_8bit_map_rle"] = chip_smoke.sun_bytes(idx, kind=2, palette=palette[:48])
    files["sun_24bit_rle"] = chip_smoke.sun_bytes(img[..., :3], kind=2)
    files["sun_24bit_rgb"] = chip_smoke.sun_bytes(img[..., :3], kind=3)
    return files


HAND_BUILT = hand_built()


@pytest.mark.parametrize("form", sorted(HAND_BUILT))
def test_hand_built_forms_decode_as_pillow_does(form):
    assert_same(HAND_BUILT[form], form)


# --- truncated and corrupt files


# the files cut and corrupted below; those Pillow writes are made in the test (the card's machine has no Pillow)
CORRUPTION_FORMS = ("dib", "qoi", "tga_rle", "tga_cmap", "sgi_rle", "sgi_rle_16bit", "sgi", "pcx", "pcx_palette",
                    "pcx_planar", "dcx", "sun_rle", "sun_map", "msp_v1", "msp_v2", "xbm", "xpm", "im", "im_bits")


def corruption_seed(form: str) -> bytes:
    pillow_made = {"dib": ("DIB", "P"), "sgi": ("SGI", "RGB"), "pcx_palette": ("PCX", "P"), "msp_v1": ("MSP", "1"),
                   "xbm": ("XBM", "1"), "im": ("IM", "P")}
    if form in pillow_made:
        return pillow_file(*pillow_made[form])
    img = rng_image(21, 8, 11)
    idx = (img[..., 0] >> 4).astype(np.uint8)
    palette = np.random.default_rng(22).integers(0, 256, 768, dtype=np.uint8).tobytes()
    makers = {
        "qoi": lambda: chip_smoke.qoi_bytes(img), "tga_rle": lambda: chip_smoke.tga_bytes(img),
        "tga_cmap": lambda: chip_smoke.tga_bytes(idx, palette=palette[:48], cmap_first=1),
        "sgi_rle": lambda: chip_smoke.sgi_bytes(img), "sgi_rle_16bit": lambda: chip_smoke.sgi_bytes(img.astype(np.uint16) * 3),
        "pcx": lambda: chip_smoke.pcx_bytes(img),
        "pcx_planar": lambda: chip_smoke.pcx_bytes(idx, palette=palette[:48], planes_of_bits=4),
        "dcx": lambda: chip_smoke.dcx_bytes([chip_smoke.pcx_bytes(img)]), "sun_rle": lambda: chip_smoke.sun_bytes(img),
        "sun_map": lambda: chip_smoke.sun_bytes(idx, kind=1, palette=palette[:48]),
        "msp_v2": lambda: chip_smoke.msp_bytes(img[..., 0] > 127), "xpm": lambda: HAND_BUILT["xpm"],
        "im_bits": lambda: HAND_BUILT["im_l12_bits"],
    }
    return makers[form]()


@pytest.mark.parametrize("form", CORRUPTION_FORMS)
def test_truncated_and_corrupt_files_fail_where_pillow_fails(form):
    """Every cut of the file (every 3rd length past its first 64 bytes) and 80 seeded corruptions of one to
    three bytes, most in the header: the port decodes what Pillow decodes, to the same pixels, and raises
    where Pillow raises or finds no reader."""
    data = corruption_seed(form)
    rng = np.random.default_rng(len(data))
    cuts = [*range(0, min(64, len(data))), *range(64, len(data), 3)]
    for n in cuts:
        assert_same(data[:n], f"{form} cut at {n}")
    for k in range(80):
        b = bytearray(data)
        for _ in range(int(rng.integers(1, 4))):
            i = int(rng.integers(0, min(len(b), 40))) if rng.random() < 0.6 else int(rng.integers(0, len(b)))
            b[i] = int(rng.integers(0, 256))
        assert_same(bytes(b), f"{form} corruption {k}")


def test_decompression_bomb_and_empty_sizes_as_pillow():
    """Past twice Pillow's pixel limit Image.open raises; a size of 0 is not the format (the next reader
    gets the file)."""
    huge = b"qoif" + (70000).to_bytes(4, "big") + (70000).to_bytes(4, "big") + b"\x03\x00" + bytes(8)
    assert pillow(huge) is None and port(huge) == "error"
    for data in (b"qoif" + bytes(4) + (5).to_bytes(4, "big") + b"\x03\x00" + bytes(8),
                 _tga(0, 0, 2, 0, 0, 0, 0, 3, 24, 0, bytes(9)), chip_smoke.msp_bytes(np.zeros((0, 8), bool))):
        assert pillow(data) is None and jpeg.image_format(data) == "unknown"


# --- which reader takes a file


def test_readers_are_tried_in_pillows_order():
    """Bytes more than one reader accepts go to the reader Image.open keeps: an icon of no entries and a
    cursor whose directory is cut short fall through to TGA; a QOI of width 1 passes GIMP brush's accept
    test but not its header; an XPM or XBM is no IM header; a TGA of no image type is no format."""
    tga_px = bytes(range(27))
    cases = {
        "icon of no entries": b"\0\0\1\0\0\0" + bytes(40),
        "cursor cut short": _tga(0, 0, 2, 0x0700, 0, 0, 3, 3, 24, 0x20, tga_px),
        "qoi of width 1": chip_smoke.qoi_bytes(rng_image(3, 5, 1)),
        "qoi of width 2": chip_smoke.qoi_bytes(rng_image(3, 5, 2)),
        "xpm": HAND_BUILT["xpm"], "xbm": pillow_file("XBM", "1"),
        "tga of type 0": bytes(12) + b"\x03\x00\x02\x00\x18\x00" + bytes(18),
    }
    for what, data in cases.items():
        assert_same(data, what)
    assert jpeg.image_format(cases["cursor cut short"]) == "tga"
    assert jpeg.image_format(cases["qoi of width 1"]) == "qoi"
    assert jpeg.image_format(cases["tga of type 0"]) == "unknown"


def test_im_ycbcr_decodes_as_pillow():
    """An IM file in YCbCr converts as Pillow's ConvertYCbCr.c converts it (`im.ycbcr_to_rgb`, its fixed-point
    tables): a file of the (Y, Cb, Cr) triples at a stride of 5 along each axis, 52^3 of the 2^24
    (scripts/pillow_colour_tables.py checks every one), a small file cut short, and a file Pillow writes."""
    v = np.arange(0, 256, 5, dtype=np.uint8)
    y, cb, cr = (a.reshape(52, 52 * 52) for a in np.meshgrid(v, v, v, indexing="ij"))
    body = np.stack([y, cb, cr], axis=1).tobytes()  # each row's Y, Cb and Cr planes
    data = _im([b"Image type: YCC image", b"Image size (x*y): 2704*52"], body)
    assert pillow(data)[0] == "IM" and jpeg.image_format(data) == "im"
    assert_same(data, "YCbCr triples")
    small = _im([b"Image type: YCC image", b"Image size (x*y): 5*3"], bytes(range(45)))
    for n in range(len(small) - 50, len(small) + 1):
        assert_same(small[:n], f"YCbCr cut at {n}")
    assert_same(pillow_file("IM", "YCbCr"), "YCbCr as Pillow writes it")


# --- the twins of csrc/raster.cu on the smoke's seeded files


@pytest.mark.parametrize("form", chip_smoke.RASTER_CASE_FORMS)
def test_twins_on_the_smokes_seeded_files(form):
    """chip_smoke.py's decoder phase holds the native stages to these twins on `raster_case` files; here the
    twins are held to Pillow on a few of them, 1-40 px."""
    for k in range(4):
        rng = np.random.default_rng(k)
        data = chip_smoke.raster_case(form, rng, int(rng.integers(1, 41)), int(rng.integers(1, 41)))
        assert_same(data, f"{form} case {k}")


def test_decoders_follow_the_runs_device():
    for module in (qoi, tga, sgi, pcx, sun, msp):
        assert module.decoder_for("cpu") is module.decode_twin
        assert module.decoder_for(torch.device("cuda", 0)) is module.decode_native
    assert all(kind in raster.TWINS and kind in raster.NATIVES for kind in raster.KINDS)


# --- dataset items


DATASET_FILES = {"dib": ("DIB", "RGB"), "qoi": ("QOI", "RGB"), "tga": ("TGA", "RGB", {"compression": "tga_rle"}),
                 "sgi": chip_smoke.sgi_bytes(rng_image(5)), "pcx": ("PCX", "RGB"), "dcx": HAND_BUILT["dcx"],
                 "sun": HAND_BUILT["sun_24bit_rle"], "msp": HAND_BUILT["msp_v2"], "xbm": ("XBM", "1"),
                 "xpm": HAND_BUILT["xpm"], "im": ("IM", "RGB")}  # (format, mode, options): a file Pillow writes


@pytest.mark.parametrize("kind", sorted(DATASET_FILES))
def test_dataset_items_from_raster_files_equal_jax(tmp_path, kind):
    """The port's MBEIRCandidatePoolDataset item for an img_path of each format equals the JAX package's
    (fp32), as for WebP (tests/test_torch_webp.py)."""
    from tests.helpers import identity_image_transform
    from tests.torch_helpers import on_array
    from uniir_tpu.data import dataset as jax_dataset
    from uniir_tpu_torch.data import dataset

    os.makedirs(tmp_path / "images")
    data = DATASET_FILES[kind]
    if isinstance(data, tuple):
        data = pillow_file(*data[:2], **(data[2] if len(data) > 2 else {}))
    (tmp_path / "images" / "a.jpg").write_bytes(data)
    (tmp_path / "cand_pool.jsonl").write_text(json.dumps({"did": "9:1", "modality": "image", "img_path": "images/a.jpg"})
                                              + "\n")
    transform = identity_image_transform(32)
    ours = dataset.MBEIRCandidatePoolDataset(str(tmp_path), "cand_pool.jsonl", on_array(transform), device="cpu")
    theirs = jax_dataset.MBEIRCandidatePoolDataset(str(tmp_path), "cand_pool.jsonl", transform)
    a, b = ours[0], theirs[0]
    assert a.keys() == b.keys()
    assert a["img"].dtype == b["img"].dtype == np.float32
    np.testing.assert_array_equal(a["img"], b["img"])
    assert {k: v for k, v in a.items() if k != "img"} == {k: v for k, v in b.items() if k != "img"}


# --- the native stages (csrc/raster.cu, built by nvcc on the card's machine)


@pytest.fixture
def native():
    if not torch.cuda.is_available():
        pytest.skip("needs the card's machine: csrc/raster.cu is built by nvcc, which is installed there")
    return chip_smoke.RasterNative()


@pytest.mark.gpu
@pytest.mark.parametrize("form", chip_smoke.RASTER_CASE_FORMS)
def test_native_stages_are_bit_equal_to_twins(native, form):
    for k in range(12):
        rng = np.random.default_rng(100 + k)
        data = chip_smoke.raster_case(form, rng, int(rng.integers(1, 200)), int(rng.integers(1, 200)))
        before = native.calls
        out = native(data, f"{form} case {k}")
        assert native.calls == before + 1
        np.testing.assert_array_equal(out, jpeg.decode_image(data, f"{form} case {k}", "cpu"))


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["qoi", "tga_rle", "sgi_rle", "sgi_rle_16bit", "pcx", "pcx_planar", "sun_rle",
                                  "msp_v2"])
def test_native_stages_refuse_what_twins_refuse(native, form):
    """Cuts and corruptions: the native stage raises where the twin raises, with the same message, and
    decodes the rest to the same pixels."""
    data = corruption_seed(form)
    rng = np.random.default_rng(7)
    variants = [data[:n] for n in range(0, len(data), 2)]
    for _ in range(60):
        b = bytearray(data)
        b[int(rng.integers(0, len(b)))] = int(rng.integers(0, 256))
        variants.append(bytes(b))
    for v in variants:
        try:
            want = jpeg.decode_image(v, "f", "cpu")
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                native(v, "f")
            assert str(got.value) == str(e)
            continue
        np.testing.assert_array_equal(native(v, "f"), want)
