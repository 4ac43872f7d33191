"""PSD, DDS and ICNS in the port against Pillow 12.1.

The JAX package reads every image with `PIL.Image.open(path).convert("RGB")`;
`data.jpeg.decode_image` must give the same pixels, bit for bit, for a file of
each of these formats, and fail where Pillow fails: on files Pillow writes (DDS
raw RGB / RGBA / L / LA, DXT1 / DXT3 / DXT5, BC2 / BC3 / BC5; ICNS of PNG
entries), on files built here where Pillow cannot write the form (PSD in every
mode of Pillow's MODES, raw and PackBits, with and without resources and a layer
section; DDS blocks of every BC format from seeded bits, uncompressed masks,
palettes; ICNS RLE entries with their masks), on every truncation and on seeded
corruptions of them.  Pillow is read from a file, as the JAX package reads it.
An ICNS JPEG 2000 entry decodes as Pillow decodes it (data/jpeg2000.py).

The native stages (PSD's PackBits and ICNS's RLE in csrc/raster.cu, DDS's block
and mask decoders in csrc/bcn.cu, built by nvcc on the card's machine) are held
to the twins by the `-m gpu` tests at the end and by chip_smoke.py's decoder
phase.
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
from uniir_tpu_torch.data import dds, icns, jpeg, psd, raster

_DIR = tempfile.mkdtemp(prefix="container_formats_")  # Pillow reads a file, as the JAX package does
atexit.register(shutil.rmtree, _DIR, True)
KINDS = {"PSD": "psd", "DDS": "dds", "ICNS": "icns"}


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


def assert_same(data: bytes, what: str = "") -> None:
    """The port decodes `data` as Pillow does, or fails where Pillow fails (not as a format it refuses)."""
    want, got = pillow(data), port(data)
    if want is None:
        assert isinstance(got, str) and got == "error", (what, got if isinstance(got, str) else got.shape)
        return
    assert jpeg.image_format(data) == KINDS.get(want[0], want[0].lower()), (what, want[0], jpeg.image_format(data))
    assert not isinstance(got, str), (what, want[0], got)
    np.testing.assert_array_equal(got, want[1], err_msg=what)


def rng_image(seed: int, h: int = 9, w: int = 13, c: int = 4) -> np.ndarray:
    """Seeded samples with runs along the rows and repeated rows, so run-length coders find both kinds."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    img = np.where(rng.random((h, w, 1)) < 0.5, img[:, :1], img)
    return np.where(rng.random((h, 1, 1)) < 0.3, img[:1], img).astype(np.uint8)


# --- files Pillow writes


PILLOW_WRITTEN = [("DDS", "RGB"), ("DDS", "RGBA"), ("DDS", "L"), ("DDS", "LA"), ("DDS", "RGB", "DXT1"),
                  ("DDS", "RGBA", "DXT1"), ("DDS", "RGBA", "DXT3"), ("DDS", "RGBA", "DXT5"), ("DDS", "RGBA", "BC2"),
                  ("DDS", "RGBA", "BC3"), ("DDS", "RGB", "BC5"), ("ICNS", "RGBA"), ("ICNS", "RGB")]


@pytest.mark.parametrize("case", PILLOW_WRITTEN, ids=["-".join(c) for c in PILLOW_WRITTEN])
def test_files_pillow_writes_decode_as_pillow_does(case):
    from PIL import Image

    fmt, mode, *pixel_format = case
    size = (16, 16) if fmt == "ICNS" else (13, 9)  # Pillow writes every ICNS size, up to 1024 x 1024
    img = Image.fromarray(rng_image(7, size[1], size[0], len(mode)).squeeze(-1) if len(mode) == 1 else
                          rng_image(7, size[1], size[0], len(mode)), mode)
    buf = io.BytesIO()
    img.save(buf, fmt, **({"pixel_format": pixel_format[0]} if pixel_format else {}))
    assert pillow(buf.getvalue())[0] == fmt
    assert_same(buf.getvalue(), "-".join(case))


# --- PSD


PSD_MODES = ["1", "bitmap8", "L", "P", "RGB", "RGBA", "CMYK", "multichannel", "duotone", "LAB"]


def psd_file(mode: str, compression: int, layers: bool, seed: int = 3, h: int = 9, w: int = 13) -> bytes:
    """A PSD file of seeded planes in `mode` (PSD_MODES; "bitmap8": the bitmap mode at 8 bits, "RGBA": RGB
    of four channels), an image resource, and a layer section when `layers`."""
    img = rng_image(seed, h, w, 5)
    planes = {"1": img[..., :1] & 1, "bitmap8": img[..., :1], "L": img[..., :1], "P": img[..., :1],
              "RGB": img[..., :3], "RGBA": img[..., :4], "CMYK": img[..., :4], "multichannel": img[..., :2],
              "duotone": img[..., :1], "LAB": img[..., :3]}[mode].transpose(2, 0, 1)
    extra = {"resources": chip_smoke.psd_resource(1005, b"ab", b"xyz")}
    if layers:
        extra["layers"] = struct.pack(">I", 12) + struct.pack(">h", 0) + bytes(10)
    if mode == "P":
        extra["palette"] = np.random.default_rng(seed).integers(0, 256, 768, dtype=np.uint8).tobytes()
    if mode == "bitmap8":
        data = chip_smoke.psd_bytes(np.ascontiguousarray(planes), "L", compression=compression, **extra)
        return data[:24] + struct.pack(">H", 0) + data[26:]  # colour mode 0 at 8 bits
    label = "RGB" if mode == "RGBA" else mode
    return chip_smoke.psd_bytes(np.ascontiguousarray(planes), label, compression=compression, **extra)


PSD_CASES = [(mode, c, layers) for mode in PSD_MODES for c in (0, 1) for layers in (False, True)]


@pytest.mark.parametrize("case", PSD_CASES, ids=[f"{m}-{'rle' if c else 'raw'}{'-layers' if l else ''}"
                                                 for m, c, l in PSD_CASES])
def test_psd_in_every_mode_decodes_as_pillow_does(case):
    data = psd_file(*case)
    assert pillow(data)[0] == "PSD"
    assert_same(data, str(case))


def test_psd_forms_pillow_reads_its_own_way():
    """An indexed image without a 768-byte palette shows black; RGB and CMYK of more channels than they need
    read the first ones; PackBits packets past a row's end are cut there and rows are read whatever their
    byte counts say; a compression other than raw or PackBits opens and cannot load; too few channels for
    the mode, 16 bits, a mode outside MODES and another version are refused or not identified."""
    img = rng_image(4, 6, 7, 5)
    planes = np.ascontiguousarray(img.transpose(2, 0, 1))
    cases = {
        "P without a palette": chip_smoke.psd_bytes(planes[:1], "P"),
        "P with a short palette": chip_smoke.psd_bytes(planes[:1], "P", palette=bytes(300)),
        "RGB of 5 channels": chip_smoke.psd_bytes(planes, "RGB"),
        "CMYK of 5 channels raw": chip_smoke.psd_bytes(planes, "CMYK", compression=0),
        "ZIP compression": chip_smoke.psd_bytes(planes[:3], "RGB", compression=2),
        "too few channels": chip_smoke.psd_bytes(planes[:2], "RGB"),
    }
    rows = [chip_smoke.packbits_row(planes[0, y].tobytes()) for y in range(6)]
    body = b"".join(rows)
    overrun = bytes((257 - 12, 9)) + body  # a run of 12 in rows of 7, then the rows
    counts = b"".join(struct.pack(">H", 1) for _ in range(6))  # byte counts that say nothing true
    head = chip_smoke.psd_bytes(planes[:1], "L")[:38]  # the header and three empty sections
    cases["a run past the row"] = head + struct.pack(">H", 1) + counts + overrun
    sixteen = chip_smoke.psd_bytes(planes[:1], "L", compression=0)
    cases["16 bits"] = sixteen[:22] + struct.pack(">H", 16) + sixteen[24:]
    cases["mode 5"] = sixteen[:24] + struct.pack(">H", 5) + sixteen[26:]
    cases["version 2"] = sixteen[:4] + struct.pack(">H", 2) + sixteen[6:]
    for what, data in cases.items():
        assert_same(data, what)
    for what in ("16 bits", "mode 5", "version 2"):
        assert pillow(cases[what]) is None and jpeg.image_format(cases[what]) == "unknown"
    assert pillow(cases["ZIP compression"]) is None and jpeg.image_format(cases["ZIP compression"]) == "psd"


def test_psd_lab_converts_as_pillow_does():
    """Lab through Pillow's LittleCMS transform (`psd.lab_to_rgb`): every (L, a, b) at a stride of 5 along each
    axis, 52^3 of the 2^24 (scripts/pillow_colour_tables.py checks every one)."""
    v = np.arange(0, 256, 5, dtype=np.uint8)
    planes = np.stack([a.reshape(52, 52 * 52) for a in np.meshgrid(v, v, v, indexing="ij")])
    data = chip_smoke.psd_bytes(planes, "LAB", compression=0)
    assert pillow(data)[0] == "PSD"
    assert_same(data, "Lab triples")


# --- DDS


def dds_form(form: str, rng, w: int, h: int) -> bytes:
    """A DDS file of `form`: a block format of chip_smoke.BC_DDS from seeded bits, or one of the forms below."""
    if form in chip_smoke.BC_DDS:
        fourcc, dxgi = chip_smoke.BC_DDS[form]
        return chip_smoke.dds_bytes(chip_smoke.bc_blocks(form, rng, w, h), w, h, fourcc=fourcc, dxgi=dxgi)
    pf = chip_smoke.DDS_PF
    px = rng.bytes(4 * w * h)
    masks = {"masks_565": (16, (0xF800, 0x7E0, 0x1F, 0)), "masks_5551": (16, (0x7C00, 0x3E0, 0x1F, 0x8000)),
             "masks_bgr24": (24, (0xFF0000, 0xFF00, 0xFF, 0)), "masks_odd": (32, (0x5, 0xF0F0, 0x3FF00000, 0)),
             "masks_zero": (32, (0, 0xFF00, 0, 0xFF)), "masks_8bit": (8, (0xE0, 0x1C, 0x3, 0))}
    if form in masks:
        bits, m = masks[form]
        flags = pf["rgb"] | (pf["alpha_pixels"] if m[3] else 0)
        return chip_smoke.dds_bytes(px[: w * h * bits // 8], w, h, flags=flags, bitcount=bits, masks=m)
    if form == "luminance":
        return chip_smoke.dds_bytes(px[: w * h], w, h, flags=pf["luminance"], bitcount=8)
    if form == "luminance_alpha":
        return chip_smoke.dds_bytes(px[: 2 * w * h], w, h, flags=pf["luminance"] | pf["alpha_pixels"], bitcount=16)
    if form == "palette":
        return chip_smoke.dds_bytes(px[: w * h], w, h, flags=pf["pal8"], bitcount=8, palette=rng.bytes(1024))
    if form == "r8g8b8a8_srgb":
        return chip_smoke.dds_bytes(px, w, h, dxgi=29)
    if form == "bc4_dx10":
        return chip_smoke.dds_bytes(chip_smoke.bc_blocks("bc4", rng, w, h), w, h, dxgi=80)
    if form == "bc7_srgb":
        return chip_smoke.dds_bytes(chip_smoke.bc_blocks("bc7", rng, w, h), w, h, dxgi=99)
    if form == "ati1":
        return chip_smoke.dds_bytes(chip_smoke.bc_blocks("bc4", rng, w, h), w, h, fourcc=b"ATI1")
    raise ValueError(form)


DDS_FORMS = [*chip_smoke.BC_DDS, "masks_565", "masks_5551", "masks_bgr24", "masks_odd", "masks_zero", "masks_8bit",
             "luminance", "luminance_alpha", "palette", "r8g8b8a8_srgb", "bc4_dx10", "bc7_srgb", "ati1"]


@pytest.mark.parametrize("form", DDS_FORMS)
def test_dds_forms_decode_as_pillow_does(form):
    """Each form at sizes that are and are not multiples of 4, its blocks or pixels from seeded bits (BC6H's
    and BC7's modes spread over every mode, reserved ones included)."""
    rng = np.random.default_rng(len(form))
    for w, h in ((1, 1), (4, 4), (5, 3), (13, 9), (24, 20)):
        data = dds_form(form, rng, w, h)
        assert pillow(data)[0] == "DDS", (form, w, h)
        assert_same(data, f"{form} at {w} x {h}")


def test_dds_headers_pillow_refuses_or_passes_on():
    """A header size other than 124, a header cut short, luminance of 16 bits without alpha, an unknown
    FourCC (BC4S, which Pillow does not read), an unknown DXGI format (BC1's sRGB), no pixel format flag:
    Image.open raises; fewer than 8 bytes, or a DX10 header cut before its format, is no DDS file."""
    base = chip_smoke.dds_bytes(bytes(64), 4, 4, fourcc=b"DXT1")
    pf = chip_smoke.DDS_PF
    cases = {
        "header size 100": base[:4] + struct.pack("<I", 100) + base[8:],
        "header cut short": base[:100],
        "luminance 16 without alpha": chip_smoke.dds_bytes(bytes(32), 4, 4, flags=pf["luminance"], bitcount=16),
        "BC4S": chip_smoke.dds_bytes(bytes(64), 4, 4, fourcc=b"BC4S"),
        "BC1 sRGB": chip_smoke.dds_bytes(bytes(64), 4, 4, dxgi=72),
        "no flags": chip_smoke.dds_bytes(bytes(64), 4, 4),
        "seven bytes": base[:7],
        "DX10 cut": chip_smoke.dds_bytes(b"", 4, 4, dxgi=98)[:130],
        "width 0": chip_smoke.dds_bytes(bytes(64), 0, 4, fourcc=b"DXT1"),
    }
    for what, data in cases.items():
        assert pillow(data) is None, what
        assert_same(data, what)
    assert [jpeg.image_format(cases[k]) for k in ("BC4S", "seven bytes", "DX10 cut", "width 0")] == \
        ["dds", "unknown", "unknown", "unknown"]


# --- ICNS


def icns_form(form: str, seed: int = 5) -> bytes:
    img = rng_image(seed, 128, 128, 4)
    if form in ("is32", "il32", "ih32", "it32"):
        s = {"is32": 16, "il32": 32, "ih32": 48, "it32": 128}[form]
        return chip_smoke.icns_bytes(chip_smoke.icns_rle_entries(np.ascontiguousarray(img[:s, :s, :3]),
                                                                 np.ascontiguousarray(img[:s, :s, 3])))
    if form == "all_rle":  # every RLE size: the largest is shown
        return chip_smoke.icns_bytes([e for s in (16, 32, 48) for e in chip_smoke.icns_rle_entries(
            np.ascontiguousarray(img[:s, :s, :3]), np.ascontiguousarray(img[:s, :s, 3]))])
    if form == "raw":  # an entry of 3 x its pixels is read raw
        return chip_smoke.icns_bytes([(b"is32", img[:16, :16, :3].tobytes())])
    if form == "mask_first":
        return chip_smoke.icns_bytes(chip_smoke.icns_rle_entries(np.ascontiguousarray(img[:32, :32, :3]),
                                                                 np.ascontiguousarray(img[:32, :32, 3]))[::-1])
    if form in ("png_and_rle", "png_half_size"):
        from PIL import Image

        size = 64 if form == "png_half_size" else 32
        buf = io.BytesIO()
        Image.fromarray(img[:size, :size]).save(buf, "PNG")
        kind = b"ic07" if form == "png_half_size" else b"icp5"
        rle = chip_smoke.icns_rle_entries(np.ascontiguousarray(img[:32, :32, :3]))
        return chip_smoke.icns_bytes(rle + [(kind, buf.getvalue())])
    raise ValueError(form)


ICNS_FORMS = ["is32", "il32", "ih32", "it32", "all_rle", "raw", "mask_first", "png_and_rle", "png_half_size"]


@pytest.mark.parametrize("form", ICNS_FORMS)
def test_icns_forms_decode_as_pillow_does(form):
    data = icns_form(form)
    assert pillow(data)[0] == "ICNS"
    assert_same(data, form)


def test_icns_entries_pillow_refuses():
    """A mask alone, it32 without its 4 zero bytes, an RLE channel that misses its size, a PNG of a size the
    file does not allow, an entry of an unknown signature: Pillow's load raises; an empty resource list, an
    entry of length 0 and a list cut short are no ICNS file."""
    from PIL import Image

    img = rng_image(6, 32, 32, 4)
    buf = io.BytesIO()
    Image.fromarray(img[:20, :20]).save(buf, "PNG")
    rle = chip_smoke.icns_rle_entries(np.ascontiguousarray(img[:16, :16, :3]))[0][1]
    cases = {
        "mask alone": chip_smoke.icns_bytes([(b"s8mk", bytes(256))]),
        "it32 lead": chip_smoke.icns_bytes([(b"it32", b"\1\0\0\0" + bytes(100))]),
        "RLE past its size": chip_smoke.icns_bytes([(b"is32", bytes((0xFF, 7)) * 3 + rle)]),
        "PNG of 20 x 20": chip_smoke.icns_bytes([(b"icp5", buf.getvalue())]),
        "unknown subimage": chip_smoke.icns_bytes([(b"ic08", b"GIF89a" + bytes(40))]),
        "no entries": chip_smoke.icns_bytes([]),
        "entry of length 0": b"icns" + struct.pack(">I", 24) + b"is32" + struct.pack(">I", 0) + bytes(8),
        "list cut short": chip_smoke.icns_bytes([(b"is32", rle)])[:12],
    }
    for what, data in cases.items():
        assert pillow(data) is None, what
        assert_same(data, what)


def test_icns_jpeg2000_entry_is_named():
    """Pillow decodes an ICNS entry in JPEG 2000 (OpenJPEG) and converts it to RGBA; the port decodes it
    through data/jpeg2000.py to the same pixels: a JP2 and a J2K entry, a JP2 whose `colr` says CMYK, a
    grey one, an entry of a size Pillow does not allow, a cut one and one behind the bare JP2 signature
    Pillow's plugin does not open."""
    from PIL import Image

    img = rng_image(8, 32, 32, 4)
    entries = {}
    for key, mode, options in (("jp2", "RGB", {}), ("j2k", "RGB", {"no_jp2": True}), ("grey", "L", {}),
                               ("cmyk", "RGBA", {}), ("small", "RGB", {})):
        buf = io.BytesIO()
        Image.fromarray(img[:20, :20] if key == "small" else img).convert(mode).save(buf, "JPEG2000", **options)
        entries[key] = buf.getvalue()
    cmyk = entries["cmyk"]
    at = cmyk.index(b"colr") + 7
    entries["cmyk"] = cmyk[:at] + (12).to_bytes(4, "big") + cmyk[at + 4 :]
    entries["cut"] = entries["jp2"][: len(entries["jp2"]) // 2]
    entries["bare signature"] = entries["jp2"][8:]
    for key, entry in entries.items():
        data = chip_smoke.icns_bytes([(b"icp5", entry)])
        assert jpeg.image_format(data) == "icns", key
        assert_same(data, key)
        if key in ("jp2", "j2k", "grey", "cmyk"):
            assert pillow(data)[0] == "ICNS", key
            np.testing.assert_array_equal(jpeg.decode_image(data, "f", "cpu"), pillow(data)[1])
        else:
            assert pillow(data) is None, key


# --- cuts and corruptions


def corruption_seed(form: str) -> bytes:
    rng = np.random.default_rng(31)
    makers = {
        "psd_rgb_rle": lambda: psd_file("RGB", 1, True), "psd_cmyk_raw": lambda: psd_file("CMYK", 0, False),
        "psd_p_rle": lambda: psd_file("P", 1, False), "psd_lab_rle": lambda: psd_file("LAB", 1, False),
        "psd_1_rle": lambda: psd_file("1", 1, True), "dds_bc1": lambda: dds_form("bc1", rng, 9, 7),
        "dds_bc6h": lambda: dds_form("bc6hs", rng, 8, 8), "dds_bc7": lambda: dds_form("bc7", rng, 9, 7),
        "dds_masks": lambda: dds_form("masks_565", rng, 6, 5), "dds_palette": lambda: dds_form("palette", rng, 6, 5),
        "icns_rle": lambda: icns_form("is32"), "icns_png": lambda: icns_form("png_and_rle"),
    }
    return makers[form]()


CORRUPTION_FORMS = ("psd_rgb_rle", "psd_cmyk_raw", "psd_p_rle", "psd_lab_rle", "psd_1_rle", "dds_bc1", "dds_bc6h",
                    "dds_bc7", "dds_masks", "dds_palette", "icns_rle", "icns_png")


@pytest.mark.parametrize("form", CORRUPTION_FORMS)
def test_truncated_and_corrupt_files_fail_where_pillow_fails(form):
    """Every cut of the file (every 3rd length past its first 64 bytes) and 80 seeded corruptions of one to
    three bytes, most in the header: the port decodes what Pillow decodes, to the same pixels, and raises
    where Pillow raises or finds no reader."""
    data = corruption_seed(form)
    rng = np.random.default_rng(len(data))
    for n in [*range(0, min(64, len(data))), *range(64, len(data), 3)]:
        assert_same(data[:n], f"{form} cut at {n}")
    for k in range(80):
        b = bytearray(data)
        for _ in range(int(rng.integers(1, 4))):
            i = int(rng.integers(0, min(len(b), 60))) if rng.random() < 0.6 else int(rng.integers(0, len(b)))
            b[i] = int(rng.integers(0, 256))
        if form == "dds_masks" and np.prod(struct.unpack_from("<2I", b, 12), dtype=np.int64) > 1 << 16:
            b[12:20] = data[12:20]  # Pillow decodes this form pixel by pixel in Python: sizes it can finish
        assert_same(bytes(b), f"{form} corruption {k}")


# --- the twins on the smoke's seeded files


@pytest.mark.parametrize("form", chip_smoke.CONTAINER_CASE_FORMS)
def test_twins_on_the_smokes_seeded_files(form):
    """chip_smoke.py's decoder phase holds the native stages to these twins on `container_case` files; here
    the twins are held to Pillow on a few of them, 1-40 px."""
    for k in range(4):
        rng = np.random.default_rng(k)
        data = chip_smoke.container_case(form, rng, int(rng.integers(1, 41)), int(rng.integers(1, 41)))
        assert_same(data, f"{form} case {k}")


def test_the_smokes_query_files_decode_as_pillow_does():
    """Phase 10's DDS (BC7 mode 6 blocks of a photo) and PSD (PackBits) queries."""
    for form in ("dds_bc7", "psd_rle"):
        assert_same(chip_smoke.fixture_file(form, 3), form)


def test_decoders_follow_the_runs_device():
    for module in (dds, icns, psd):
        assert module.decoder_for("cpu") is module.decode_twin
        assert module.decoder_for(torch.device("cuda", 0)) is module.decode_native
    assert all(kind in dds.TWINS and kind in dds.NATIVES for kind in dds.KINDS)
    assert all(kind in raster.TWINS and kind in raster.NATIVES for kind in ("packbits", "icns_rle"))


def test_bc6h_packings_name_every_endpoint_bit_once():
    """Each BC6H mode's layout stores each endpoint bit its precisions need exactly once."""
    for mode, (ns, tr, _, epb, rb, gb, bb) in enumerate(dds.BC6_MODES):
        bits = dds.bc6_packing(mode)
        assert len(bits) == len(set(bits)) == (75 if mode < 2 else 72 if mode < 10 else 60)
        want = {(c, b) for c in range(3) for b in range(epb)}
        for e in range(1, 2 * ns):
            want |= {(3 * e + c, b) for c, p in enumerate((rb, gb, bb)) for b in range(p)}
        assert set(bits) == want, mode


# --- dataset items


DATASET_FILES = {"psd": lambda: psd_file("RGB", 1, True, h=30, w=40), "dds": lambda: chip_smoke.fixture_file("dds_bc7", 4),
                 "icns": lambda: icns_form("it32")}


@pytest.mark.parametrize("kind", sorted(DATASET_FILES))
def test_dataset_items_from_container_files_equal_jax(tmp_path, kind):
    """The port's MBEIRCandidatePoolDataset item for an img_path of each format equals the JAX package's
    (fp32), as for the raster formats (tests/test_torch_raster_formats.py)."""
    from tests.helpers import identity_image_transform
    from tests.torch_helpers import on_array
    from uniir_tpu.data import dataset as jax_dataset
    from uniir_tpu_torch.data import dataset

    os.makedirs(tmp_path / "images")
    (tmp_path / "images" / "a.jpg").write_bytes(DATASET_FILES[kind]())
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


# --- the native stages (csrc/raster.cu and csrc/bcn.cu, built by nvcc on the card's machine)


@pytest.fixture
def native():
    if not torch.cuda.is_available():
        pytest.skip("needs the card's machine: csrc/raster.cu and csrc/bcn.cu are built by nvcc, installed there")
    return chip_smoke.ContainerNative()


@pytest.mark.gpu
@pytest.mark.parametrize("form", chip_smoke.CONTAINER_CASE_FORMS)
def test_native_stages_are_bit_equal_to_twins(native, form):
    for k in range(12):
        rng = np.random.default_rng(100 + k)
        data = chip_smoke.container_case(form, rng, int(rng.integers(1, 200)), int(rng.integers(1, 200)))
        before = native.calls
        out = native(data, f"{form} case {k}")
        assert native.calls == before + chip_smoke.container_native_calls(form)
        np.testing.assert_array_equal(out, jpeg.decode_image(data, f"{form} case {k}", "cpu"))


@pytest.mark.gpu
@pytest.mark.parametrize("form", CORRUPTION_FORMS)
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
