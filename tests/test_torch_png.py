"""The PNG decoders (`uniir_tpu_torch.data.png`): the twin bit-equal to
Pillow's `Image.open(...).convert("RGB")` over every colour type, bit depth,
interlace method and scanline filter (files from chip_smoke.py's writer, and
Pillow's own), Pillow's rules for what it checks and what it ignores, and
(`-m gpu`, on the card's machine, where nvcc builds csrc/png.cu) the native
decoder bit-equal to the twin.

The module imports no JAX and no Pillow at its top, so its `-m gpu` cases
collect with `--noconftest` on a machine that has neither."""

import io
import itertools
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import chip_smoke
from uniir_tpu_torch.data import jpeg, png

FORMS = sorted(png.CHANNELS)  # (bit depth, colour type)
SIZES = [(1, 1), (3, 2), (9, 8), (13, 7), (33, 17)]


def samples(seed: int, w: int, h: int, depth: int, ctype: int) -> tuple:
    """Random samples of the form, and a palette for colour type 3 that may
    be shorter than the indices reach."""
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 1 << depth, (h, w, png.CHANNELS[(depth, ctype)])).astype(np.uint16)
    palette = rng.integers(0, 256, 3 * int(rng.integers(1, (1 << depth) + 1)), dtype=np.uint8).tobytes() \
        if ctype == 3 else b""
    return arr, palette


def pillow_rgb(data: bytes) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("form", FORMS, ids=[f"depth{d}_type{t}" for d, t in FORMS])
def test_twin_is_bit_equal_to_pillow(form, interlace):
    """Every filter type alone and all five mixed, at sizes that leave Adam7
    passes empty and rows that end inside a byte."""
    depth, ctype = form
    for (w, h), filters in itertools.product(SIZES, [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)]):
        arr, palette = samples(w * 100 + h + depth + ctype, w, h, depth, ctype)
        data = chip_smoke.png_bytes(arr, ctype, depth, filters=filters, interlace=interlace, palette=palette)
        got = png.decode_twin(data)
        assert got.dtype == np.uint8 and got.shape == (h, w, 3)
        np.testing.assert_array_equal(got, pillow_rgb(data))


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P", "1", "I;16"])
def test_twin_reads_pillows_own_files(mode):
    """Files Pillow writes (its adaptive filter choice, one IDAT)."""
    from PIL import Image

    rng = np.random.default_rng(len(mode))
    base = Image.fromarray(rng.integers(0, 256, (45, 67, 3), dtype=np.uint8))
    img = base.convert(mode) if mode != "I;16" else Image.fromarray(rng.integers(0, 65536, (45, 67), dtype=np.uint16))
    buf = io.BytesIO()
    img.save(buf, "PNG")
    data = buf.getvalue()
    np.testing.assert_array_equal(png.decode_twin(data), pillow_rgb(data))


def test_pillows_conversion_rules():
    """The rules the module docstring states, on fixed values."""
    grey16 = np.array([[0, 255, 256, 1000, 65535]], np.uint16)[..., None]
    assert png.decode_twin(chip_smoke.png_bytes(grey16, 0, 16))[0, :, 0].tolist() == [0, 255, 255, 255, 255]
    rgb16 = np.array([[[0x1234, 0xFF00, 0x00FF]]], np.uint16)
    assert png.decode_twin(chip_smoke.png_bytes(rgb16, 2, 16))[0, 0].tolist() == [0x12, 0xFF, 0x00]
    for depth, scale in ((1, 255), (2, 85), (4, 17)):
        ramp = np.arange(1 << depth, dtype=np.uint16)[None, :, None]
        assert png.decode_twin(chip_smoke.png_bytes(ramp, 0, depth))[0, :, 0].tolist() == list(range(0, 256, scale))
    rgba = np.array([[[10, 20, 30, 0]]], np.uint16)
    assert png.decode_twin(chip_smoke.png_bytes(rgba, 6))[0, 0].tolist() == [10, 20, 30]  # alpha dropped
    idx = np.array([[0, 1, 2, 255]], np.uint16)[..., None]
    data = chip_smoke.png_bytes(idx, 3, palette=bytes([1, 2, 3, 4, 5, 6]), trns=b"\x00\x80")
    assert png.decode_twin(data)[0].tolist() == [[1, 2, 3], [4, 5, 6], [0, 0, 0], [0, 0, 0]]
    np.testing.assert_array_equal(png.decode_twin(data), pillow_rgb(data))
    assert png.decode_twin(chip_smoke.png_bytes(idx, 3)).max() == 0  # no PLTE: black, as Pillow gives


def _chunks(data: bytes) -> list:
    out, pos = [], 8
    while pos < len(data):
        n = struct.unpack(">I", data[pos : pos + 4])[0]
        out.append((pos, data[pos + 4 : pos + 8], n))
        pos += 12 + n
    return out


def _flip_crc(data: bytes, kind: bytes) -> bytes:
    pos, _, n = next(c for c in _chunks(data) if c[1] == kind)
    at = pos + 8 + n
    return data[:at] + bytes([data[at] ^ 1]) + data[at + 1 :]


def _file(ihdr: bytes, idat: bytes) -> bytes:
    return (png.SIGNATURE + chip_smoke.png_chunk(b"IHDR", ihdr) + chip_smoke.png_chunk(b"IDAT", idat)
            + chip_smoke.png_chunk(b"IEND", b""))


def _refused():
    img = np.random.default_rng(5).integers(0, 256, (20, 24, 3)).astype(np.uint16)
    good = chip_smoke.png_bytes(img, 2, filters=(0,))
    ihdr = struct.pack(">IIBBBBB", 24, 20, 8, 2, 0, 0, 0)
    raw = b"".join(b"\x00" + row.astype(np.uint8).tobytes() for row in img)
    bad_adler = bytearray(zlib.compress(raw))
    bad_adler[-1] ^= 1
    idat = next(c for c in _chunks(good) if c[1] == b"IDAT")
    return {
        "ihdr_crc": (_flip_crc(good, b"IHDR"), r"chunk IHDR: bad CRC"),
        "unknown_chunk_crc": (good[:33] + b"\x00\x00\x00\x01abCd\x00\x00\x00\x00\x00" + good[33:], r"chunk abCd: bad CRC"),
        "truncated_image_data": (good[: idat[0] + 200], r"chunk IDAT: truncated"),
        "interrupted_image_data": (png.SIGNATURE + chip_smoke.png_chunk(b"IHDR", ihdr)
                                   + chip_smoke.png_chunk(b"IDAT", zlib.compress(raw)[:100])
                                   + chip_smoke.png_chunk(b"tEXt", b"a\x00b")
                                   + chip_smoke.png_chunk(b"IDAT", zlib.compress(raw)[100:])
                                   + chip_smoke.png_chunk(b"IEND", b""), r"chunk IDAT: truncated"),
        "bad_checksum": (_file(ihdr, bytes(bad_adler)), r"chunk IDAT: corrupt zlib"),
        "filter_type_5": (_file(ihdr, zlib.compress(b"\x05" + raw[1:])), r"chunk IDAT: unknown filter type 5"),
        "interlace_method_2": (_file(ihdr[:-1] + b"\x02", zlib.compress(raw)), r"chunk IHDR: .*interlace method 2"),
        "depth4_rgb": (_file(ihdr[:8] + b"\x04" + ihdr[9:], zlib.compress(raw)), r"chunk IHDR: bit depth 4"),
        "width_0": (_file(struct.pack(">IIBBBBB", 0, 20, 8, 2, 0, 0, 0), zlib.compress(b"")), r"chunk IHDR: image size"),
        "palette_257": (chip_smoke.png_bytes(img[..., :1] % 4, 3, palette=bytes(771)), r"chunk PLTE: 257 entries"),
        "no_signature": (b"\x89PNX" + good[4:], r"not a PNG file"),
        "data_before_ihdr": (png.SIGNATURE + good[good.index(b"IDAT") - 4 :], r"chunk IDAT: image data before"),
    }


@pytest.mark.parametrize("form", sorted(_refused()))
def test_refused_forms_raise_naming_file_and_chunk(form):
    """What Pillow refuses (it raises SyntaxError / OSError / ValueError for
    each), the twin refuses with a ValueError naming the file and chunk."""
    from PIL import Image

    data, pattern = _refused()[form]
    with pytest.raises(ValueError, match=rf"^f\.png: .*{pattern}"):
        png.decode_twin(data, "f.png")
    with pytest.raises((SyntaxError, OSError, ValueError)):
        Image.open(io.BytesIO(data)).convert("RGB")


def test_what_pillow_ignores_is_ignored():
    """CRCs of IDAT and of the chunks after it, a missing IEND, a zlib stream
    longer than the image, an unknown ancillary chunk (also before IHDR), an
    IHDR compression byte: Pillow decodes all of these, and so does the twin."""
    img = np.random.default_rng(6).integers(0, 256, (9, 11, 3)).astype(np.uint16)
    good = chip_smoke.png_bytes(img, 2, filters=(1, 4))
    ihdr = struct.pack(">IIBBBBB", 11, 9, 8, 2, 0, 0, 0)
    raw = b"".join(b"\x00" + row.astype(np.uint8).tobytes() for row in img)
    cases = [_flip_crc(good, b"IDAT"), _flip_crc(good, b"IEND"), good[: good.index(b"IEND") - 4],
             _file(ihdr, zlib.compress(raw + bytes(300))),
             good[:33] + chip_smoke.png_chunk(b"abCd", b"xyz") + good[33:],
             png.SIGNATURE + chip_smoke.png_chunk(b"tEXt", b"a\x00b") + good[8:],
             _file(ihdr[:10] + b"\x01" + ihdr[11:], zlib.compress(raw))]
    for data in cases:
        np.testing.assert_array_equal(png.decode_twin(data), pillow_rgb(data))
        np.testing.assert_array_equal(png.decode_twin(data), img.astype(np.uint8))


def test_corrupt_files_raise_or_decode_never_crash():
    """Random byte flips: the twin raises ValueError or returns pixels."""
    data = chip_smoke.png_bytes(np.random.default_rng(7).integers(0, 256, (16, 13, 3)).astype(np.uint16), 2,
                                interlace=True)
    rng = np.random.default_rng(8)
    for _ in range(100):
        bad = bytearray(data)
        for at in rng.integers(0, len(bad), size=2):
            bad[at] = int(rng.integers(0, 256))
        try:
            out = png.decode_twin(bytes(bad))
        except ValueError:
            continue
        assert out.dtype == np.uint8 and out.shape == (16, 13, 3)


def test_read_image_decodes_by_signature_not_name(tmp_path):
    """A PNG named .jpg and a JPEG named .png decode; Pillow's GIF, BMP,
    WebP and TIFF files decode to its pixels, WebP under a wrong suffix too;
    unknown bytes and a RIFF / WEBP file whose first chunk Pillow does not
    take raise naming the file and the format found."""
    from PIL import Image

    arr = np.random.default_rng(9).integers(0, 256, (12, 10, 3), dtype=np.uint8)
    (tmp_path / "a.jpg").write_bytes(chip_smoke.png_bytes(arr.astype(np.uint16), 2))
    np.testing.assert_array_equal(jpeg.read_image(str(tmp_path / "a.jpg"), "cpu"), arr)
    (tmp_path / "b.png").write_bytes(chip_smoke.jpeg_bytes(arr))
    np.testing.assert_array_equal(jpeg.read_image(str(tmp_path / "b.png"), "cpu"),
                                  np.asarray(Image.open(tmp_path / "b.png").convert("RGB")))
    for fmt in ("GIF", "BMP", "WEBP"):
        path = tmp_path / f"c.{fmt.lower()}"
        Image.fromarray(arr).save(path, fmt)
        np.testing.assert_array_equal(jpeg.read_image(str(path), "cpu"), np.asarray(Image.open(path).convert("RGB")))
    (tmp_path / "c.jpg").write_bytes((tmp_path / "c.webp").read_bytes())
    np.testing.assert_array_equal(jpeg.read_image(str(tmp_path / "c.jpg"), "cpu"),
                                  np.asarray(Image.open(tmp_path / "c.webp").convert("RGB")))
    path = tmp_path / "c.tiff"
    Image.fromarray(arr).save(path, "TIFF")
    np.testing.assert_array_equal(jpeg.read_image(str(path), "cpu"), np.asarray(Image.open(path).convert("RGB")))
    (tmp_path / "d.jpg").write_bytes(b"hello")
    with pytest.raises(ValueError, match=r"d\.jpg: unknown image"):
        jpeg.read_image(str(tmp_path / "d.jpg"), "cpu")
    webp_data = (tmp_path / "c.webp").read_bytes()
    (tmp_path / "e.webp").write_bytes(webp_data[:12] + b"VP9 " + webp_data[16:])
    with pytest.raises(ValueError, match=r"e\.webp: unknown image"):
        jpeg.read_image(str(tmp_path / "e.webp"), "cpu")
    assert [jpeg.image_format(b) for b in (b"\xff\xd8\xff", png.SIGNATURE, b"MM\x00*", b"GIF89a", b"BM", webp_data)] == [
        "jpeg", "png", "tiff", "gif", "bmp", "webp"]


def test_decoder_follows_the_runs_device():
    assert png.decoder_for("cpu") is png.decode_twin
    assert png.decoder_for(torch.device("cuda", 0)) is png.decode_native


# --- the native decoder (csrc/png.cu, built by nvcc on the card's machine)


@pytest.fixture
def native():
    if not torch.cuda.is_available():
        pytest.skip("needs the card's machine: csrc/png.cu is built by nvcc, which is installed there")
    return png.decode_native


@pytest.mark.gpu
@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("form", FORMS, ids=[f"depth{d}_type{t}" for d, t in FORMS])
def test_native_is_bit_equal_to_twin(native, form, interlace):
    depth, ctype = form
    for (w, h), filters in itertools.product(SIZES, [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)]):
        arr, palette = samples(w * 100 + h + depth + ctype, w, h, depth, ctype)
        data = chip_smoke.png_bytes(arr, ctype, depth, filters=filters, interlace=interlace, palette=palette)
        before = png.decode_native.calls
        out = native(data)
        assert png.decode_native.calls == before + 1
        np.testing.assert_array_equal(out, png.decode_twin(data))


@pytest.mark.gpu
def test_native_in_threads_and_refusals(native):
    """The loader's threads decode at once; the native path refuses what the
    twin refuses, with the same chunk named."""
    rng = np.random.default_rng(10)
    files = [chip_smoke.png_bytes(rng.integers(0, 256, (40 + i, 30 + 2 * i, 3)).astype(np.uint16), 2,
                                  interlace=bool(i % 2)) for i in range(8)]
    with ThreadPoolExecutor(8) as pool:
        outs = list(pool.map(native, files * 4))
    for i, out in enumerate(outs):
        np.testing.assert_array_equal(out, png.decode_twin(files[i % len(files)]))
    for form, (data, pattern) in _refused().items():
        with pytest.raises(ValueError, match=rf"^f\.png: .*{pattern}"):
            native(data, "f.png")


# QOI, SGI, PCX, Sun raster, XBM and XPM are decoded now: their cases are in tests/test_torch_raster_formats.py
REFUSED_FORMATS = {"EPS": b"%!PS-Adobe-3.0", "HDF5": b"\x89HDF\r\n"}
# PSD, DDS, ICNS, JPEG 2000, BLP and AVIF are decoded now (tests/test_torch_container_formats.py,
# tests/test_torch_jpeg2000*.py, tests/test_torch_rare_formats.py, tests/test_torch_avif*.py): these stubs of
# theirs, which Pillow cannot read either, fail as corrupt data
DECODED_STUBS = {"PSD": b"8BPS\x00\x01", "DDS": b"DDS \x7c\x00\x00\x00", "ICNS": b"icns\x00\x00",
                 "JPEG 2000": b"\x00\x00\x00\x0cjP  \r\n\x87\n\x00", "BLP": b"BLP2\x01",
                 "AVIF": b"\x00\x00\x00\x1cftypavif\x00\x00\x00\x00"}


@pytest.mark.parametrize("name", sorted({**REFUSED_FORMATS, **DECODED_STUBS}))
def test_formats_pillow_reads_and_the_port_does_not_are_named(tmp_path, name):
    """A file of a format Pillow's Image.open reads and the port does not decode raises
    UnsupportedImageFormat naming the format (ROADMAP Queue 3), not "unknown"; ICO, CUR and PPM are
    decoded now (tests/test_torch_ico_netpbm.py), DIB, QOI, TGA, SGI, PCX / DCX, Sun raster, MSP, XBM,
    XPM and IM (tests/test_torch_raster_formats.py), and PSD, DDS, ICNS, JPEG 2000, BLP and AVIF, whose stubs
    here raise the decoders' own ValueError where Pillow raises too (tests/test_torch_container_formats.py,
    tests/test_torch_jpeg2000*.py, tests/test_torch_avif*.py)."""
    path = tmp_path / "x.jpg"
    if name in DECODED_STUBS:
        from PIL import Image

        path.write_bytes(DECODED_STUBS[name] + bytes(64))
        with pytest.raises(Exception):
            Image.open(path).convert("RGB")
        with pytest.raises(ValueError) as e:
            jpeg.read_image(str(path), "cpu")
        assert not isinstance(e.value, jpeg.UnsupportedImageFormat)
        return
    data = REFUSED_FORMATS[name] + bytes(64)
    assert jpeg.image_format(data) == name
    path.write_bytes(data)
    with pytest.raises(jpeg.UnsupportedImageFormat, match=rf"^{path}: {name} image \(by its signature\)"):
        jpeg.read_image(str(path), "cpu")
