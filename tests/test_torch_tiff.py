"""The TIFF decoders (`uniir_tpu_torch.data.tiff`): the twin bit-equal to
Pillow's `Image.open(...).convert("RGB")` (TiffImagePlugin, libtiff 4.7) on
Pillow-made files of every mode and compression Pillow writes, on every form
of chip_smoke.py's TIFF writer (strips and tiles, planar configuration 2,
both byte orders, BigTIFF, predictors 2 and 3, FillOrder 2, orientations
1-8, 16-bit ColorMaps, associated alpha, CCITT 1-D), on Group 3 / Group 4
files, on truncated and corrupted files, and the named refusals; and
(`-m gpu`, on the card's machine, where nvcc builds csrc/tiff.cu) the native
decoder bit-equal to the twin and to Pillow's digests.

The module imports no JAX and no Pillow at its top, so its `-m gpu` cases
collect with `--noconftest` on a machine that has neither."""

import base64
import hashlib
import io
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import chip_smoke
from uniir_tpu_torch.data import jpeg, tiff


def pillow_rgb(data: bytes):
    """Pillow's pixels, or the exception it raises."""
    from PIL import Image

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        except Exception as err:  # noqa: BLE001 -- any refusal of Pillow's
            return err


def assert_as_pillow(data: bytes) -> None:
    """The twin gives Pillow's pixels, or raises (naming the file) where Pillow raises."""
    ref = pillow_rgb(data)
    if isinstance(ref, Exception):
        with pytest.raises(ValueError, match=r"^f\.tif: "):
            tiff.decode_twin(data, "f.tif")
        return
    np.testing.assert_array_equal(tiff.decode_twin(data, "f.tif"), ref)


def pillow_tiff(im, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, "TIFF", **kw)
    return buf.getvalue()


# --- 1. Pillow-made files: every mode and compression Pillow writes

MODES = ("RGB", "L", "1", "P", "RGBA", "CMYK", "I;16", "F", "LA", "I", "YCbCr", "LAB")
COMPRESSIONS = ("raw", "tiff_lzw", "tiff_adobe_deflate", "tiff_deflate", "packbits", "lzma", "zstd", "jpeg", "group3",
                "group4", "tiff_ccitt")


def _matrix():
    for mode in MODES:
        for comp in COMPRESSIONS:
            if comp in ("group3", "group4", "tiff_ccitt") and mode != "1":
                continue
            if comp == "jpeg" and mode not in ("RGB", "L", "CMYK", "YCbCr"):
                continue
            yield mode, comp


def pillow_image(mode: str, seed: int = 0):
    from PIL import Image

    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, (13, 21, 3), np.uint8)
    if mode in ("I;16", "F", "I"):
        vals = {"I;16": rng.integers(0, 700, (13, 21)).astype(np.uint16),
                "F": rng.normal(100, 150, (13, 21)).astype(np.float32),
                "I": rng.integers(-300, 700, (13, 21)).astype(np.int32)}[mode]
        return Image.fromarray(vals)
    if mode == "RGBA":
        return Image.fromarray(np.concatenate([a, rng.integers(0, 256, (13, 21, 1), np.uint8)], 2))
    if mode == "P":
        return Image.fromarray(a).convert("P", palette=Image.Palette.ADAPTIVE, colors=37)
    return Image.fromarray(a).convert(mode)


@pytest.mark.parametrize("mode,compression", list(_matrix()))
def test_pillow_files_decode_as_pillow_does(mode, compression):
    data = pillow_tiff(pillow_image(mode), compression=compression)
    if compression == "zstd" or mode == "LAB":  # once refused by the port: Pillow reads them
        assert not isinstance(pillow_rgb(data), Exception)
    assert_as_pillow(data)  # raw YCbCr raises in both (Pillow: raw mode RGBX over three samples)


@pytest.mark.parametrize("orientation", range(1, 9))
@pytest.mark.parametrize("compression", ["raw", "tiff_lzw"])
def test_pillow_files_are_transposed_by_their_orientation(orientation, compression):
    """exif_transpose in TiffImageFile.load_end: 5-8 swap width and height."""
    from PIL import Image

    a = np.random.default_rng(orientation).integers(0, 256, (23, 37, 3), np.uint8)
    data = pillow_tiff(Image.fromarray(a), compression=compression, tiffinfo={274: orientation})
    out = tiff.decode_twin(data, "f.tif")
    assert out.shape == ((37, 23, 3) if orientation >= 5 else (23, 37, 3))
    np.testing.assert_array_equal(out, pillow_rgb(data))


@pytest.mark.parametrize("compression,t4", [("group3", 0), ("group3", 1), ("group3", 5), ("group3", 4), ("group4", 0),
                                            ("tiff_ccitt", 0)])
@pytest.mark.parametrize("w,h", [(1, 1), (8, 3), (37, 23), (300, 41), (1728, 5)])
def test_pillow_ccitt_files_decode_as_pillow_does(compression, t4, w, h):
    """Group 3 1-D and 2-D (T4Options 1 / 5), Group 4 and modified Huffman rows, noise and blocks: libtiff's
    padding of the bit accumulator with zeros at the end of the data included (an 8 x 3 RLE strip whose last
    row libtiff reads shifted)."""
    from PIL import Image

    rng = np.random.default_rng(w * 7 + h)
    opts = {292: t4} if t4 else {}
    for a in (rng.random((h, w)) > 0.6,
              np.kron(rng.random((h // 3 + 1, w // 5 + 1)) > 0.5, np.ones((3, 5), bool))[:h, :w]):
        assert_as_pillow(pillow_tiff(Image.fromarray(a), compression=compression, tiffinfo=opts))


def test_invalid_headers_and_bigtiff_as_pillow():
    """Pillow's two "invalid" headers read uncompressed files and fail compressed ones (libtiff's bad magic);
    Pillow's BigTIFF."""
    from PIL import Image

    a = np.random.default_rng(3).integers(0, 256, (20, 30, 3), np.uint8)
    for comp in ("raw", "tiff_lzw"):
        data = pillow_tiff(Image.fromarray(a), compression=comp)
        assert_as_pillow(data)
        assert_as_pillow(b"II\x00\x2a" + data[4:])
        mm = chip_smoke.tiff_bytes(a, 2, order="MM", compression=1 if comp == "raw" else 5)
        assert_as_pillow(b"MM\x2a\x00" + mm[4:])
        assert_as_pillow(pillow_tiff(Image.fromarray(a), compression=comp, big_tiff=True))
    bad = b"II\x00\x2a" + pillow_tiff(Image.fromarray(a), compression="tiff_lzw")[4:]
    with pytest.raises(ValueError, match=r"^f\.tif: .*bad magic"):
        tiff.decode_twin(bad, "f.tif")


# --- 2. every form of chip_smoke.py's writer


def _samples(rng, h, w):
    return {
        "rgb": rng.integers(0, 256, (h, w, 3), np.uint8),
        "rgba": rng.integers(0, 256, (h, w, 4), np.uint8),
        "rgba16": rng.integers(0, 65536, (h, w, 4)).astype(np.uint16),
        "bilevel": (rng.random((h, w, 1)) > 0.5).astype(np.uint8),
    }


def _writer_forms():
    """tag -> (samples key or callable, tiff_bytes keywords)."""
    forms = {}
    for comp in (1, 5, 8, 32946, 32773, 34925, 7):
        for order in ("II", "MM"):
            for big in (False, True):
                for lay, lay_kw in (("strips", dict(rows_per_strip=5)), ("tiles", dict(tile=(16, 16))),
                                    ("one_strip", {})):
                    for planar in ((1, 2) if comp != 7 else (1,)):
                        forms[f"rgb-c{comp}-{order}-big{int(big)}-{lay}-planar{planar}"] = (
                            "rgb", dict(photometric=2, compression=comp, order=order, bigtiff=big, planar=planar,
                                        **lay_kw))
    for comp in (1, 5, 8, 32773):
        for kind in ("rgb", "grey", "rgb16", "grey16"):
            for order in ("II", "MM"):
                forms[f"predictor2-c{comp}-{kind}-{order}"] = (kind, dict(
                    photometric=2 if kind.startswith("rgb") else 1, compression=comp, predictor=2, order=order,
                    rows_per_strip=7))
    for comp in (5, 8):
        for order in ("II", "MM"):
            forms[f"predictor3-c{comp}-{order}"] = ("float", dict(photometric=1, compression=comp, predictor=3,
                                                                  order=order, rows_per_strip=6))
            forms[f"float-c{comp}-{order}"] = ("float", dict(photometric=1, compression=comp, order=order))
    for o in range(1, 9):
        for comp in (1, 5):
            forms[f"orientation{o}-c{comp}"] = ("rgb", dict(photometric=2, compression=comp, orientation=o,
                                                            rows_per_strip=4))
    for comp in (1, 2, 3, 5, 32773):
        for fill in (1, 2):
            for ph in (0, 1):
                forms[f"bilevel-c{comp}-fillorder{fill}-photometric{ph}"] = ("bilevel", dict(
                    photometric=ph, compression=comp, bits=1, fillorder=fill, rows_per_strip=9,
                    t4options=4 if comp == 3 else 0))
    for b in (2, 4):
        for ph in (0, 1, 3):
            for fill in (1, 2):
                for comp in (1, 5):
                    forms[f"{b}bit-photometric{ph}-fillorder{fill}-c{comp}"] = (f"bits{b}", dict(
                        photometric=ph, bits=b, fillorder=fill, compression=comp, colormap=ph == 3))
    for fill in (1, 2):
        for comp in (1, 5):
            forms[f"grey-fillorder{fill}-c{comp}"] = ("grey", dict(photometric=1, fillorder=fill, compression=comp))
            forms[f"rgb-fillorder{fill}-c{comp}"] = ("rgb", dict(photometric=2, fillorder=fill, compression=comp))
            forms[f"palette-fillorder{fill}-c{comp}"] = ("grey", dict(photometric=3, fillorder=fill,
                                                                       compression=comp, colormap=True))
    for extra in ((1,), (2,), (0,), ()):
        for comp in (1, 5):
            for planar in (1, 2):
                forms[f"rgba-extra{''.join(map(str, extra))}-c{comp}-planar{planar}"] = (
                    "rgba", dict(photometric=2, extra=extra, compression=comp, planar=planar))
    for extra in ((1,), (2,), (0,)):
        for order in ("II", "MM"):
            for comp in (1, 5):
                forms[f"rgba16-extra{extra[0]}-{order}-c{comp}"] = ("rgba16", dict(photometric=2, extra=extra,
                                                                                   order=order, compression=comp))
    for order in ("II", "MM"):
        for comp in (1, 5):
            forms[f"cmyk-{order}-c{comp}"] = ("rgba", dict(photometric=5, order=order, compression=comp))
            forms[f"la-{order}-c{comp}"] = ("la", dict(photometric=1, extra=(2,), order=order, compression=comp))
            for kind in ("int16", "int32", "uint16"):
                forms[f"{kind}-{order}-c{comp}"] = (kind, dict(photometric=1, order=order, compression=comp))
    for samp in ((2, 2), (1, 1), (2, 1)):
        for lay, lay_kw in (("strips", dict(rows_per_strip=16)), ("tiles", dict(tile=(16, 16))), ("one_strip", {})):
            forms[f"jpeg-ycbcr{samp[0]}{samp[1]}-{lay}"] = ("rgb", dict(photometric=6, compression=7,
                                                                        ycbcr_sampling=samp, **lay_kw))
    forms["jpeg-grey"] = ("grey", dict(photometric=1, compression=7, rows_per_strip=8))
    forms["jpeg-cmyk"] = ("rgba", dict(photometric=5, compression=7, rows_per_strip=8))
    for comp in (5, 8, 32773):
        forms[f"ycbcr-c{comp}"] = ("rgb", dict(photometric=6, compression=comp, rows_per_strip=8))
    forms["lzw-compat"] = ("rgb", dict(photometric=2, compression=5, lzw_compat=True))
    forms["lzw-full-table"] = ("levels", dict(photometric=2, compression=5))
    forms["lzw-compat-full-table"] = ("levels", dict(photometric=2, compression=5, lzw_compat=True))
    for form in chip_smoke.ZSTD_FORMS[:-1]:  # (frames_skippable is not one frame a strip)
        forms[f"zstd-{form}"] = ("rgb", dict(photometric=2, compression=50000, zstd_form=form, rows_per_strip=9))
    for kind in ("rgb", "grey16", "rgb16"):
        for order in ("II", "MM"):
            forms[f"zstd-predictor2-{kind}-{order}"] = (kind, dict(photometric=1 if kind == "grey16" else 2, order=order,
                                                                   compression=50000, predictor=2, rows_per_strip=7))
    forms["zstd-predictor3-float"] = ("float", dict(photometric=1, compression=50000, predictor=3, rows_per_strip=6))
    forms["zstd-tiles-planar"] = ("rgba", dict(photometric=2, extra=(2,), compression=50000, planar=2, tile=(16, 32)))
    forms["predictor3-uint16-c5"] = ("uint16", dict(photometric=1, compression=5, predictor=3))  # Pillow refuses
    for comp in (1, 5, 32773, 50000):
        for planar in (1, 2):
            forms[f"lab-c{comp}-planar{planar}"] = ("rgb", dict(photometric=8, compression=comp, planar=planar,
                                                                rows_per_strip=10))
    forms["lab-c50000-tiles-orientation6"] = ("rgb", dict(photometric=8, compression=50000, tile=(16, 16),
                                                          orientation=6))
    for sub in ((2, 2), (2, 1), (1, 2), (4, 4), (4, 2), (4, 1)):
        for n, (lay, lay_kw) in enumerate((("strips8", dict(rows_per_strip=8)), ("strips5", dict(rows_per_strip=5)),
                                           ("tiles", dict(tile=(16, 16))), ("one_strip", {}))):
            comp = (5, 8, 32773, 50000)[n]
            forms[f"ycbcr{sub[0]}{sub[1]}-{lay}-c{comp}"] = ("rgb", dict(photometric=6, compression=comp,
                                                                         subsampling=sub, **lay_kw))
            # horizontal differencing over libtiff's PredictorSetup rows of data units, under LZW and Deflate (where
            # those rows do not divide a chunk or are not whole 3-byte strides, libtiff's predictor fails and
            # TIFFRGBAImage reads the differences as they stand)
            comp = (5, 8, 5, 8)[n]
            forms[f"ycbcr{sub[0]}{sub[1]}-predictor2-{lay}-c{comp}"] = ("rgb", dict(
                photometric=6, compression=comp, subsampling=sub, predictor=2, **lay_kw))
    for o in range(1, 9):
        forms[f"ycbcr22-orientation{o}-c8"] = ("rgb", dict(photometric=6, compression=8, subsampling=(2, 2),
                                                           orientation=o, rows_per_strip=6))
        forms[f"ycbcr44-tiles-orientation{o}-c50000"] = ("rgb", dict(photometric=6, compression=50000,
                                                                     subsampling=(4, 4), orientation=o, tile=(16, 16)))
    for comp in (5, 50000):
        forms[f"ycbcr11-planar-c{comp}"] = ("rgb", dict(photometric=6, compression=comp, planar=2, rows_per_strip=7))
    forms["ycbcr22-refblackwhite-c5"] = ("rgb", dict(photometric=6, compression=5, subsampling=(2, 2), tags={
        532: (5, [(15, 1), (235, 1), (128, 1), (240, 1), (128, 1), (240, 1)]),
        529: (5, [(2990, 10000), (5870, 10000), (1140, 10000)])}))
    forms["ycbcr-raw-strips"] = ("rgb", dict(photometric=6, compression=1, rows_per_strip=4))  # Pillow's raw RGBX
    forms["ycbcr33-c5"] = ("rgb", dict(photometric=6, compression=5, tags={530: (3, [3, 3])}))  # refused by both
    forms["ycbcr22-planar-c5"] = ("rgb", dict(photometric=6, compression=5, planar=2, tags={530: (3, [2, 2])}))
    forms["ycbcr-grey-c5"] = ("grey", dict(photometric=6, compression=5))  # refused by both
    for ph in (1, 2, 5):
        forms[f"jpeg-planar-photometric{ph}"] = ({1: "grey", 2: "rgb", 5: "rgba"}[ph], dict(
            photometric=ph, compression=7, planar=2, rows_per_strip=8))
    forms["jpeg-ycbcr11-planar-orientation3"] = ("rgb", dict(photometric=6, compression=7, planar=2, orientation=3,
                                                             tags={530: (3, [1, 1])}, tile=(16, 16)))
    for comp in (1, 5):
        forms[f"la-planar-c{comp}"] = ("la", dict(photometric=1, extra=(2,), planar=2, compression=comp))
        forms[f"pa-planar-c{comp}"] = ("la", dict(photometric=3, extra=(2,), planar=2, compression=comp,
                                                  colormap=True))
        forms[f"cmyk-planar-c{comp}"] = ("rgba", dict(photometric=5, planar=2, compression=comp))
        forms[f"grey16-planar-c{comp}"] = ("grey16", dict(photometric=1, planar=2, compression=comp))
        forms[f"rgb16-planar-c{comp}"] = ("rgb16", dict(photometric=2, planar=2, compression=comp))
    return forms


WRITER_FORMS = _writer_forms()


def writer_file(tag: str, seed: int = 1, h: int = 23, w: int = 37) -> bytes:
    kind, kw = WRITER_FORMS[tag]
    rng = np.random.default_rng(seed)
    s = _samples(rng, h, w)
    s.update(grey=s["rgb"][..., :1], rgb16=s["rgba16"][..., :3], grey16=s["rgba16"][..., :1], la=s["rgba"][..., :2],
             float=rng.normal(100, 200, (h, w, 1)).astype(np.float32),
             int16=rng.integers(-40000, 70000, (h, w, 1)).astype(np.int16),
             int32=rng.integers(-40000, 70000, (h, w, 1)).astype(np.int32),
             uint16=rng.integers(0, 70000, (h, w, 1)).astype(np.uint16),
             bits2=rng.integers(0, 4, (h, w, 1)).astype(np.uint8), bits4=rng.integers(0, 16, (h, w, 1)).astype(np.uint8),
             levels=rng.integers(0, 4, (200, 300, 3)).astype(np.uint8) * 60)
    samples = s[kind]
    kw = dict(kw)
    if kw.pop("colormap", False):
        kw["colormap"] = list(rng.integers(0, 65536, 3 << kw.get("bits", 8)))
    return chip_smoke.tiff_bytes(samples, **kw)


@pytest.mark.parametrize("tag", sorted(WRITER_FORMS))
def test_writer_forms_decode_as_pillow_does(tag):
    """Each of the writer's forms: the twin gives Pillow's pixels, or raises where Pillow raises (a planar
    RGBX or a 2 / 4-bit palette with FillOrder 2, for which Pillow has no unpacker)."""
    assert_as_pillow(writer_file(tag))


# --- 3. refusals, truncations and corruptions


def _patched_compression(data: bytes, value: int) -> bytes:
    """A little-endian classic TIFF with its Compression tag's value replaced."""
    import struct

    t = tiff.parse(data)
    at = data.index(struct.pack("<HHL", 259, 3, 1) + struct.pack("<H", t.compression))
    return data[:at + 8] + struct.pack("<H", value) + data[at + 10:]


@pytest.mark.parametrize("value,pattern", [(6, "old-style JPEG"), (50001, "WebP"), (32766, "NeXT"),
                                           (32809, "ThunderScan"), (34676, "SGILog"), (34661, "JBIG"),
                                           (34887, "LERC"), (12345, "unknown TIFF compression")])
def test_codecs_pillow_refuses_too_raise_by_name(value, pattern):
    """Compressions neither Pillow nor the port reads: both raise, the port naming the file and the codec."""
    data = _patched_compression(writer_file("rgb-c5-II-big0-strips-planar1"), value)
    assert isinstance(pillow_rgb(data), Exception)
    with pytest.raises(ValueError, match=rf"^f\.tif: .*{pattern}"):
        tiff.decode_twin(data, "f.tif")


def _truncation_files(pillow_made: bool = True):
    """Files of each codec cut and corrupted below; `pillow_made`: Pillow's Group 3 2-D and Group 4 files too
    (the card's machine has no Pillow)."""
    rng = np.random.default_rng(7)
    h, w = 40, 53
    rgb = rng.integers(0, 256, (h, w, 3), np.uint8) // 32 * 32
    bil = np.kron(rng.random((h // 4 + 1, w // 3 + 1)) > 0.5, np.ones((4, 3), np.uint8))[:h, :w, None].astype(np.uint8)
    files = {f"c{c}": chip_smoke.tiff_bytes(rgb, 6 if c == 7 else 2, compression=c, rows_per_strip=16)
             for c in (1, 5, 8, 32773, 34925, 7)}
    files["lzw-compat"] = chip_smoke.tiff_bytes(rgb, 2, compression=5, lzw_compat=True, rows_per_strip=16)
    files["predictor2"] = chip_smoke.tiff_bytes(rgb, 2, compression=5, predictor=2, rows_per_strip=16)
    files["tiles"] = chip_smoke.tiff_bytes(rgb, 2, compression=5, tile=(16, 16))
    files["zstd"] = chip_smoke.tiff_bytes(rgb, 2, compression=50000, rows_per_strip=16)
    files["lab"] = chip_smoke.tiff_bytes(rgb, 8, compression=50000, rows_per_strip=16)
    files["ycbcr22"] = chip_smoke.tiff_bytes(rgb, 6, compression=5, subsampling=(2, 2), rows_per_strip=16)
    files["ycbcr22-predictor2"] = chip_smoke.tiff_bytes(rgb, 6, compression=8, subsampling=(2, 2), predictor=2,
                                                        rows_per_strip=16)
    files["ycbcr44-tiles-zstd"] = chip_smoke.tiff_bytes(rgb, 6, compression=50000, subsampling=(4, 4), tile=(32, 16))
    files["rle"] = chip_smoke.tiff_bytes(bil, 0, compression=2, bits=1, rows_per_strip=16)
    files["g3"] = chip_smoke.tiff_bytes(bil, 0, compression=3, bits=1, rows_per_strip=16)
    if pillow_made:
        from PIL import Image

        files["g3-2d"] = pillow_tiff(Image.fromarray(bil[..., 0].astype(bool)), compression="group3",
                                     tiffinfo={292: 1})
        files["g4"] = pillow_tiff(Image.fromarray(bil[..., 0].astype(bool)), compression="group4")
    return files


# Where the port does not give Pillow's answer it raises UnsupportedImageFormat, which leaves the file in place:
# a Group 4 strip that ends before its last row, whose later rows libtiff leaves as Pillow's strip buffer held
# them -- uninitialised memory for the first strip, so that Pillow's pixels differ from one run to the next and no
# decoder can give them.
DIVERGES = {("g4", "cut"), ("g4", "flip")}


@pytest.mark.parametrize("codec", ["c1", "c5", "c8", "c32773", "c34925", "c7", "lzw-compat", "predictor2", "tiles",
                                   "rle", "g3", "g3-2d", "g4", "zstd", "lab", "ycbcr22", "ycbcr22-predictor2",
                                   "ycbcr44-tiles-zstd"])
def test_truncations_and_corruptions_as_pillow(codec):
    """Each codec cut at four points of its data and with single bytes flipped: the twin raises where Pillow
    raises and gives Pillow's pixels where Pillow gives an image, except the DIVERGES cases, where the port
    raises UnsupportedImageFormat."""
    data = _truncation_files()[codec]
    t = tiff.parse(data)
    offs = t.tags.get(273) or t.tags.get(324)
    counts = t.tags.get(279) or t.tags.get(325)
    start, end = offs[0], offs[-1] + counts[-1]
    cases = [("cut", data[: int(start + (end - start) * f)]) for f in (0.2, 0.5, 0.8, 0.97)]
    for j in range(6):
        pos = int(start + (end - start) * (j + 0.5) / 6)
        cases.append(("flip", data[:pos] + bytes([data[pos] ^ (0x5A + j)]) + data[pos + 1:]))
    for kind, bad in cases:
        ref = pillow_rgb(bad)
        try:
            got = tiff.decode_twin(bad, "f.tif")
        except ValueError as err:
            assert str(err).startswith("f.tif: ")
            assert isinstance(ref, Exception) or (codec, kind) in DIVERGES and isinstance(
                err, jpeg.UnsupportedImageFormat), (kind, err)
            continue
        assert not isinstance(ref, Exception), (kind, ref)
        np.testing.assert_array_equal(got, ref)


def _cut_counts(data: bytes, frac: float) -> bytes:
    """A little-endian classic TIFF whose strips end early: each StripByteCounts value cut to `frac` of itself."""
    return _set_counts(data, [max(1, int(c * frac)) for c in tiff.parse(data).tags[279]])


def _set_counts(data: bytes, counts: list, tag: int = 279) -> bytes:
    """A little-endian classic TIFF with its StripByteCounts (or, `tag` 325, TileByteCounts) values replaced."""
    import struct

    at = struct.unpack("<L", data[4:8])[0]
    out = bytearray(data)
    for k in range(struct.unpack("<H", data[at:at + 2])[0]):
        t, typ, n = struct.unpack("<HHL", data[at + 2 + 12 * k: at + 10 + 12 * k])
        if t == tag:
            fmt = "<H" if typ == 3 else "<L"
            where = at + 10 + 12 * k if n * struct.calcsize(fmt) <= 4 else struct.unpack("<L", data[at + 10 + 12 * k:
                                                                                                    at + 14 + 12 * k])[0]
            for j, v in enumerate(counts):
                struct.pack_into(fmt, out, where + j * struct.calcsize(fmt), v)
    return bytes(out)


YCBCR_DAMAGE = [(c, lay) for c in (5, 8, 32773, 50000) for lay in ("strips", "tiles")]


def damaged_ycbcr_files(codec: int, layout: str, n: int = 12) -> list:
    """Seeded YCbCr files of every subsampling (predicted where the codec runs libtiff's predictor), each with one
    chunk damaged: bytes flipped or zeroed, its byte count cut, or (in a file of several chunks) a byte count of
    0 or past the file's end, which libtiff cannot read."""
    rng = np.random.default_rng(1000 * codec + (layout == "tiles"))
    subs = [(1, 1), (2, 1), (2, 2), (4, 2), (4, 4), (1, 2), (4, 1)]
    files = []
    for case in range(n):
        w, h = int(rng.integers(5, 50)), int(rng.integers(5, 40))
        img = np.clip(chip_smoke.raw_image(int(rng.integers(0, 999)), w, h).astype(int)
                      + rng.integers(-30, 30, (h, w, 3)), 0, 255).astype(np.uint8)
        lay = dict(tile=(16 * int(rng.integers(1, 3)), 16)) if layout == "tiles" else dict(
            rows_per_strip=int(rng.integers(1, 12)))
        data = chip_smoke.tiff_bytes(img, 6, compression=codec, subsampling=subs[case % len(subs)],
                                     predictor=2 if codec != 32773 and case % 3 else 1, **lay)
        t = tiff.parse(data)
        tag = 325 if layout == "tiles" else 279
        offs, counts = list(t.tags[tag - 1]), list(t.tags[tag])
        k = int(rng.integers(0, len(offs)))
        kind = ("flip", "zeros", "cut", "unread")[case % 4 if len(offs) > 1 else case % 3]
        b = bytearray(data)
        if kind == "flip":
            for _ in range(int(rng.integers(1, 4))):
                b[offs[k] + int(rng.integers(0, counts[k]))] ^= int(rng.integers(1, 256))
        elif kind == "zeros":
            at = offs[k] + int(rng.integers(0, counts[k]))
            end = min(at + int(rng.integers(1, 16)), offs[k] + counts[k])
            b[at:end] = bytes(end - at)
        else:
            counts[k] = max(1, int(counts[k] * rng.uniform(0.05, 0.95))) if kind == "cut" else int(
                rng.choice([0, 10 ** 6]))
            b = bytearray(_set_counts(bytes(b), counts, tag))
        files.append(bytes(b))
    return files


@pytest.mark.parametrize("codec,layout", YCBCR_DAMAGE)
def test_damaged_ycbcr_chunks_read_on_as_pillow(codec, layout):
    """TIFFRGBAImage (Pillow passes stop = 0) reads on past a YCbCr strip or tile that fails to decode, with its
    buffer as the failed call left it: LZW's and PackBits' output and zeros after, Deflate's output before the
    symbol zlib rejects and zeros after, zeros for a ZSTD error, the differences where the predictor's rows do not
    divide the chunk; a chunk libtiff cannot read fails the file where it starts one of Pillow's calls (a strip,
    a row of tiles), else reads as zeros.  The twin gives Pillow's pixels, or raises where Pillow raises."""
    decoded = 0
    for data in damaged_ycbcr_files(codec, layout):
        ref = pillow_rgb(data)
        if isinstance(ref, Exception):
            with pytest.raises(ValueError, match=r"^f\.tif: "):
                tiff.decode_twin(data, "f.tif")
            assert not isinstance(_raises(tiff.decode_twin, data), jpeg.UnsupportedImageFormat)
            continue
        np.testing.assert_array_equal(tiff.decode_twin(data, "f.tif"), ref)
        decoded += 1
    assert decoded >= 6


def _lzw_codes(codes: list) -> bytes:
    """MSB-first TIFF LZW of the given codes (9-12 bits, widening as libtiff's decoder expects)."""
    acc = n = 0
    out, nbits, free, first = bytearray(), 9, 258, True
    for c in codes:
        acc, n = (acc << nbits) | c, n + nbits
        while n >= 8:
            n -= 8
            out.append((acc >> n) & 0xFF)
        acc &= (1 << n) - 1
        if c == 256:
            nbits, free, first = 9, 258, True
            continue
        free += 0 if first else 1
        first = False
        if free + 1 >= (1 << nbits) and nbits < 12:
            nbits += 1
    return bytes(out) + (bytes([(acc << (8 - n)) & 0xFF]) if n else b"")


@pytest.mark.parametrize("case", ["no_clear", "clear_then_big", "past_free", "no_eoi", "early_eoi", "packbits_cut"])
def test_codec_failures_leave_what_libtiff_leaves(case):
    """One strip of a 2 x 2 YCbCr file replaced by a stream libtiff 4.7 fails on, TIFFRGBAImage reading on with
    what the failed call left: LZW without a leading clear code (nothing: LZWPreDecode leaves no free entry),
    a code above 255 after a clear, a code past the next free entry, no EOI, an early EOI (the output so far,
    zeros after), a PackBits literal run cut by the data's end (dropped, zeros after); twin and Pillow agree."""
    import struct

    rgb = np.random.default_rng(3).integers(0, 256, (12, 10, 3), np.uint8)
    comp = 32773 if case == "packbits_cut" else 5
    data = chip_smoke.tiff_bytes(rgb, 6, compression=comp, subsampling=(2, 2), rows_per_strip=4)
    stream = {"no_clear": [65, 66, 67, 257], "clear_then_big": [256, 65, 66, 256, 300, 257],
              "past_free": [256, 65, 66, 400, 257], "no_eoi": [256, 65, 66, 67], "early_eoi": [256, 65, 66, 257]}
    strip = _lzw_codes(stream[case]) if comp == 5 else bytes([3, 9, 8, 7, 0xFE, 5, 20, 1, 2, 3])
    t = tiff.parse(data)
    offsets, counts = list(t.tags[273]), list(t.tags[279])
    offsets[1], counts[1] = len(data), len(strip)
    out = bytearray(_set_counts(data + strip, counts))
    at = struct.unpack("<L", out[4:8])[0]
    for k in range(struct.unpack("<H", out[at:at + 2])[0]):
        tag, typ, n = struct.unpack("<HHL", out[at + 2 + 12 * k: at + 10 + 12 * k])
        if tag == 273:
            fmt = "<H" if typ == 3 else "<L"
            where = at + 10 + 12 * k if n * struct.calcsize(fmt) <= 4 else struct.unpack("<L", out[at + 10 + 12 * k:
                                                                                                 at + 14 + 12 * k])[0]
            struct.pack_into(fmt, out, where + struct.calcsize(fmt), offsets[1])
    assert_as_pillow(bytes(out))


def _raises(fn, data):
    try:
        fn(data, "f.tif")
    except ValueError as err:
        return err
    return None


@pytest.mark.parametrize("kind", ["g3", "g3-2d", "g4", "g3-writer", "jpeg"])
def test_strips_that_end_early_as_pillow(kind):
    """Strips whose byte counts end early, or with a byte flipped: Group 3 rows whose EOL is cut off are read
    again from the strip's start without EOLs for the rest of the image (libtiff 4.7), a JPEG strip ends at
    libtiff's fake EOI; the twin gives Pillow's pixels or raises with it.  A Group 4 strip that stops before its
    last row raises UnsupportedImageFormat (Pillow leaves those rows as its buffer held them)."""
    from PIL import Image

    rng = np.random.default_rng(["g3", "g3-2d", "g4", "g3-writer", "jpeg"].index(kind))
    for case in range(12):
        h, w = int(rng.integers(2, 50)), int(rng.integers(1, 80))
        bil = (np.kron(rng.random((h // 3 + 1, w // 4 + 1)) > 0.5, np.ones((3, 4)))[:h, :w]).astype(bool)
        rps = int(rng.integers(1, h + 1))
        if kind == "jpeg":
            yy, xx = np.mgrid[0:h + 8, 0:w + 8]
            a = np.clip(np.stack([(xx * 3 + yy * 2 + 40 * c) % 256 for c in range(3)], 2) + rng.normal(0, 8, (h + 8, w + 8, 3)),
                        0, 255).astype(np.uint8)
            data = chip_smoke.tiff_bytes(a, 6, compression=7, rows_per_strip=rps + 7)
        elif kind == "g3-writer":
            data = chip_smoke.tiff_bytes(bil[..., None].astype(np.uint8), 0, compression=3, bits=1, rows_per_strip=rps)
        else:
            opts = {"g3": ("group3", {}), "g3-2d": ("group3", {292: 1}), "g4": ("group4", {})}[kind]
            data = pillow_tiff(Image.fromarray(bil), compression=opts[0], tiffinfo={**opts[1], 278: rps})
        if case % 2:
            bad = _cut_counts(data, float(rng.uniform(0.1, 0.95)))
        else:
            t = tiff.parse(data)
            s = int(rng.integers(0, len(t.tags[273])))
            pos = t.tags[273][s] + int(rng.integers(0, t.tags[279][s]))
            bad = data[:pos] + bytes([data[pos] ^ int(rng.integers(1, 256))]) + data[pos + 1:]
        ref = pillow_rgb(bad)
        try:
            got = tiff.decode_twin(bad, "f.tif")
        except jpeg.UnsupportedImageFormat as err:
            assert kind == "g4" and "Group 4 strip that ends" in str(err), err
            continue
        except ValueError as err:
            assert isinstance(ref, Exception), (case, err)
            continue
        assert not isinstance(ref, Exception), (case, ref)
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("level", [-5, 1, 3, 9, 19, 22])
def test_libzstd_strips_at_every_level_decode_as_pillow(level):
    """ZSTD strips as libtiff writes them (streamed, no content size) at each level, with and without the
    horizontal predictor, and one-call frames with a checksum and a content size: Pillow's pixels."""
    from tests.test_torch_zstd import compress

    rng = np.random.default_rng(level + 50)
    rgb = (rng.integers(0, 24, (37, 53, 3)) * 10).astype(np.uint8)
    for predictor, streamed in ((1, True), (2, True), (1, False)):
        data = chip_smoke.tiff_bytes(rgb, 2, compression=50000, predictor=predictor, rows_per_strip=11,
                                     zstd=lambda raw: compress(raw, level, streamed, checksum=int(not streamed)))
        assert_as_pillow(data)


def test_embedded_pillow_files_decode_to_pillows_digests():
    """The Pillow-made files chip_smoke.py carries for the card's machine (libtiff's own JPEG, Group 3 / 4 and
    LZMA output): the twin gives Pillow's digests and pixels."""
    for name, (b64, digest, w, h) in chip_smoke.TIFF_PILLOW_FILES.items():
        data = base64.b64decode(b64)
        out = tiff.decode_twin(data, name)
        assert out.shape == (h, w, 3) and hashlib.sha256(out.tobytes()).hexdigest() == digest, name
        np.testing.assert_array_equal(out, pillow_rgb(data))


def test_read_image_decodes_tiff_by_signature(tmp_path):
    data = writer_file("rgb-c5-II-big1-tiles-planar2")
    (tmp_path / "a.jpg").write_bytes(data)
    assert jpeg.image_format(data) == "tiff"
    np.testing.assert_array_equal(jpeg.read_image(str(tmp_path / "a.jpg"), "cpu"), pillow_rgb(data))


def test_dataset_items_from_tiff_files_equal_jax(tmp_path):
    """The port's MBEIRCandidatePoolDataset item for a `.tif` img_path equals the JAX package's (fp32): an LZW
    RGB TIFF with the horizontal predictor, a tiled big-endian Deflate one, a palette TIFF, a Group 4 one, an
    orientation-6 one (Pillow's own transposition), a ZSTD one with the predictor, a CIELAB one and a 4x4
    subsampled YCbCr one in tiles with orientation 8."""
    import json
    import os

    from tests.helpers import identity_image_transform
    from tests.torch_helpers import on_array
    from uniir_tpu.data import dataset as jax_dataset
    from uniir_tpu_torch.data import dataset

    os.makedirs(tmp_path / "images")
    files = {"lzw_predictor": writer_file("predictor2-c5-rgb-II", seed=2),
             "tiles_deflate_mm": writer_file("rgb-c8-MM-big0-tiles-planar1", seed=3),
             "palette": writer_file("palette-fillorder1-c5", seed=4),
             "group4": _truncation_files()["g4"],
             "orientation6": writer_file("orientation6-c5", seed=5),
             "zstd_predictor": writer_file("zstd-predictor2-rgb-II", seed=6),
             "lab": writer_file("lab-c50000-planar1", seed=7),
             "ycbcr44_orientation8": writer_file("ycbcr44-tiles-orientation8-c50000", seed=8)}
    with open(tmp_path / "cand_pool.jsonl", "w") as f:
        for i, (name, data) in enumerate(files.items()):
            (tmp_path / "images" / f"{name}.tif").write_bytes(data)
            f.write(json.dumps({"did": f"9:{i}", "modality": "image", "img_path": f"images/{name}.tif"}) + "\n")
    transform = identity_image_transform(32)
    ours = dataset.MBEIRCandidatePoolDataset(str(tmp_path), "cand_pool.jsonl", on_array(transform), device="cpu")
    theirs = jax_dataset.MBEIRCandidatePoolDataset(str(tmp_path), "cand_pool.jsonl", transform)
    assert len(ours) == len(theirs) == len(files)
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        assert a.keys() == b.keys()
        assert a["img"].dtype == b["img"].dtype == np.float32
        np.testing.assert_array_equal(a["img"], b["img"])
        assert {k: v for k, v in a.items() if k != "img"} == {k: v for k, v in b.items() if k != "img"}


def test_decoder_follows_the_runs_device():
    assert tiff.decoder_for("cpu") is tiff.decode_twin
    assert tiff.decoder_for(torch.device("cuda", 0)) is tiff.decode_native


# --- 4. the native decoder (csrc/tiff.cu, built by nvcc on the card's machine)


@pytest.fixture
def native():
    if not torch.cuda.is_available():
        pytest.skip("needs the card's machine: csrc/tiff.cu is built by nvcc, which is installed there")
    return tiff.decode_native


NATIVE_FORMS = [tag for tag in sorted(WRITER_FORMS) if any(k in tag for k in ("-c5", "-c2", "-c3", "-c32773", "lzw",
                                                                               "jpeg", "zstd", "c50000", "lab",
                                                                               "ycbcr"))]


@pytest.mark.gpu
@pytest.mark.parametrize("tag", NATIVE_FORMS)
def test_native_is_bit_equal_to_twin(native, tag):
    data = writer_file(tag, seed=5)
    try:
        want = tiff.decode_twin(data, "f.tif")
    except ValueError:
        with pytest.raises(ValueError, match=r"^f\.tif: "):
            native(data, "f.tif")
        return
    before = tiff.decode_native.calls
    np.testing.assert_array_equal(native(data, "f.tif"), want)
    assert tiff.decode_native.calls == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("codec,layout", YCBCR_DAMAGE)
def test_native_reads_on_past_damaged_ycbcr_chunks_as_the_twin(native, codec, layout):
    for data in damaged_ycbcr_files(codec, layout):
        want = _raises(tiff.decode_twin, data)
        if want is not None:
            with pytest.raises(type(want), match=r"^f\.tif: "):
                native(data, "f.tif")
            continue
        np.testing.assert_array_equal(native(data, "f.tif"), tiff.decode_twin(data, "f.tif"))


@pytest.mark.gpu
def test_native_on_pillow_files_truncations_and_threads(native):
    """Pillow's digests, the truncations and corruptions (equal to the twin or raising with it), and the
    loader's threads at once."""
    for name, (b64, digest, w, h) in chip_smoke.TIFF_PILLOW_FILES.items():
        assert hashlib.sha256(native(base64.b64decode(b64), name).tobytes()).hexdigest() == digest, name
    for codec, data in _truncation_files(pillow_made=False).items():
        t = tiff.parse(data)
        offs = t.tags.get(273) or t.tags.get(324)
        counts = t.tags.get(279) or t.tags.get(325)
        start, end = offs[0], offs[-1] + counts[-1]
        for f in (0.2, 0.5, 0.97):
            bad = data[: int(start + (end - start) * f)]
            try:
                want = tiff.decode_twin(bad, "f.tif")
            except ValueError:
                with pytest.raises(ValueError, match=r"^f\.tif: "):
                    native(bad, "f.tif")
                continue
            np.testing.assert_array_equal(native(bad, "f.tif"), want)
    files = [writer_file(tag, seed=9) for tag in NATIVE_FORMS[:12]]
    with ThreadPoolExecutor(8) as pool:
        outs = list(pool.map(native, files * 2))
    for i, out in enumerate(outs):
        np.testing.assert_array_equal(out, tiff.decode_twin(files[i % len(files)]))
