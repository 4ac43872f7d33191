"""FITS, FLI / FLC, PCD and IPTC files read as Pillow 12.1 reads them
(`uniir_tpu_torch.data.{fits,fli,pcd,iptc}` through `jpeg.decode_image`): each form's pixels equal
`Image.open(path).convert("RGB")` and `image_format` names the format as Pillow's `format` does; cut and flipped
files raise where Pillow raises and give Pillow's pixels where Pillow gives an image; header edge cases, a header
that fails over to a later reader, PhotoCD's Photo YCC tables over every (Y, Cb, Cr) triple, FliDecode.c over
seeded chunk streams, and IPTC's band merge over its inner files' modes.  Pillow reads the files from a path, as
the JAX package does.  `-m gpu`: the FLI frame through csrc/raster.cu's `uniir_raster_fli`, held to the twin.

The module imports no JAX and no Pillow at its top, so its `-m gpu` case collects with `--noconftest` on a
machine that has neither."""

import functools
import struct

import numpy as np
import pytest
import torch

import chip_smoke
import rare_format_files as files
from uniir_tpu_torch.data import fli, iptc, jpeg, pcd, raster

corpus = functools.cache(files.fits_pcd_fli_iptc)
CORPUS = sorted(corpus(0))
FORMATS = {"fits": "FITS", "fli": "FLI", "flc": "FLI", "pcd": "PCD", "iptc": "IPTC"}


def pillow(tmp_path, data: bytes):
    """(format, RGB pixels) of Image.open(path).convert("RGB"), or (None, "refused") where it raises."""
    from PIL import Image

    path = tmp_path / "f.bin"
    path.write_bytes(data)
    try:
        with Image.open(path) as im:
            return im.format, np.asarray(im.convert("RGB"))
    except Exception:  # noqa: BLE001 -- that Pillow raises is the outcome
        return None, "refused"


def port(data: bytes, device: str = "cpu"):
    """(image_format, pixels) of the port, or (image_format, "refused") where it raises a plain ValueError."""
    try:
        return jpeg.image_format(data), jpeg.decode_image(data, "f", device)
    except jpeg.UnsupportedImageFormat as err:
        pytest.fail(f"UnsupportedImageFormat where Pillow decides: {err}")
    except ValueError:
        return jpeg.image_format(data), "refused"


def assert_as_pillow(tmp_path, data: bytes, what: str = "") -> bool:
    fmt, want = pillow(tmp_path, data)
    kind, got = port(data)
    if isinstance(want, str):
        assert isinstance(got, str), (what, kind, "decoded where Pillow refuses")
        return False
    assert not isinstance(got, str), (what, fmt, "refused where Pillow decodes")
    assert kind == fmt.lower(), (what, kind, fmt)
    np.testing.assert_array_equal(got, want, err_msg=what)
    return True


@pytest.mark.parametrize("name", CORPUS)
def test_files_decode_as_pillow(tmp_path, name):
    data = corpus(0)[name]
    fmt, want = pillow(tmp_path, data)
    assert fmt == FORMATS[name.split("_")[0]]
    assert assert_as_pillow(tmp_path, data, name)
    assert len(np.unique(want)) > 16, "the file's samples should land inside 0-255, not on its clipped ends"
    assert jpeg.image_comment(data) is None


@pytest.mark.parametrize("name", CORPUS)
def test_cut_and_flipped_files_as_pillow(tmp_path, name):
    """Seeded cuts (anywhere) and byte flips (mostly in the header): the port raises a plain ValueError where
    Pillow raises, and gives Pillow's pixels, under Pillow's format, where Pillow gives an image."""
    data = corpus(1)[name]
    rng = np.random.default_rng(CORPUS.index(name))
    decoded = 0
    for case in range(24):
        b = bytearray(data)
        if case % 3 == 0:
            b = b[: int(rng.integers(0, len(b)))]
        else:
            for _ in range(int(rng.integers(1, 4))):
                at = int(rng.integers(0, min(len(b), 600) if case % 3 == 1 else len(b)))
                b[at] ^= int(rng.integers(1, 256))
        decoded += assert_as_pillow(tmp_path, bytes(b), f"{name} case {case}")
    assert decoded >= 4


def _fli_head(w: int, h: int, frames: int = 1, magic: int = 0xAF12, flags: int = 3) -> bytes:
    head = bytearray(128)
    struct.pack_into("<IHHHHHHI", head, 0, 0, magic, frames, w, h, 8, flags, 70)
    return bytes(head)


def _pcd_after(head: bytes) -> bytes:
    """A PhotoCD file whose first bytes are `head`: Image.open reaches it where an earlier reader fails."""
    data = bytearray(chip_smoke.pcd_bytes(files.image(7, 768, 512)))
    data[: len(head)] = head
    return bytes(data)


@functools.cache
def _edge_cases() -> dict:
    card, rng = chip_smoke.fits_card, np.random.default_rng(5)
    grey = files.image(3, 12, 7)[..., 0]
    pixels = grey[::-1].tobytes() + bytes(200)
    base = [card("SIMPLE", "T"), card("BITPIX", 8), card("NAXIS", 2), card("NAXIS1", 12), card("NAXIS2", 7)]

    def fits(cards, data=pixels):
        return chip_smoke.fits_header(cards) + data

    groups = np.zeros((7, 12, 4), np.uint8)
    groups[..., 3] = grey
    gz = chip_smoke.fits_gzip_bytes(groups.tobytes(), 8, 12, 7)
    idx = (grey // 8).astype(np.uint8)
    brun = chip_smoke.fli_chunk(15, chip_smoke.fli_brun(idx))
    frame = chip_smoke.fli_frame([chip_smoke.fli_chunk(15, chip_smoke.fli_brun(idx), pad=False)])
    palette = rng.integers(0, 256, (256, 3), dtype=np.uint8)
    pgm = files.pillow_pgm(grey)
    return {
        "fits_missing_naxis2": fits(base[:4]),
        "fits_missing_bitpix": fits(base[:1] + base[2:]),
        "fits_bitpix_64": fits([base[0], card("BITPIX", 64)] + base[2:]),
        "fits_bad_integer": fits(base[:3] + [card("NAXIS1", "12.0"), base[4]]),
        "fits_comment_and_equals": fits(base[:3] + [b"NAXIS1  =                   12 / width".ljust(80),
                                                    b"NAXIS2  = =7".ljust(80)]),
        "fits_negative_naxis": fits(base[:2] + [card("NAXIS", -1)] + base[3:]),
        "fits_no_image": fits([base[0], card("BITPIX", 8), card("NAXIS", 0)]),
        "fits_header_runs_out": b"".join(base),
        "fits_no_data": fits(base, b""),
        "fits_data_below_a_card": fits(base, grey[::-1].tobytes()[:60]),
        "fits_not_simple": fits([card("SIMPLE", "F")] + base[1:]),
        "fits_simple_later_keyword": fits([card("SIMPLEX", "T")] + base[1:]),
        "fits_second_header_ignored": fits(base) [: 2880] + chip_smoke.fits_header([card("XTENSION", b"'IMAGE'"),
                                                                                    card("NAXIS", 0)]) + pixels,
        "fits_gzip_rice": gz.replace(b"'GZIP_1  '", b"'RICE_1  '"),
        "fits_gzip_no_zcmptype": gz.replace(b"ZCMPTYPE", b"ZCMPTYPX"),
        "fits_gzip_float": gz.replace(b"ZBITPIX =                    8", b"ZBITPIX =                  -32"),
        "fits_gzip_not_gzip": gz.replace(b"\x1f\x8b", b"\x1f\x8c"),
        "fits_gzip_short": gz.replace(b"ZNAXIS2 =                    7", b"ZNAXIS2 =                    9"),
        "fits_fails_over_to_pcd": _pcd_after(card("SIMPLE", "F")),
        "fli_missing_frame": _fli_head(12, 7),
        "fli_frame_size_cut": _fli_head(12, 7) + b"\x10\x00\x00",
        "fli_no_frames": _fli_head(12, 7, frames=0) + chip_smoke.fli_frame([brun]),
        "fli_prefix_chunk": _fli_head(12, 7) + struct.pack("<IH", 16, 0xF100) + bytes(10) + chip_smoke.fli_frame(
            [chip_smoke.fli_chunk(4, chip_smoke.fli_palette(palette, [(0, 10)], 0)), brun]),
        "fli_odd_frame": _fli_head(12, 7) + frame,
        "fli_frame_size_one_over": _fli_head(12, 7) + struct.pack("<I", len(frame) + 1) + frame[4:],
        "fli_frame_size_two_over": _fli_head(12, 7) + struct.pack("<I", len(frame) + 2) + frame[4:],
        "fli_frame_size_small": _fli_head(12, 7) + struct.pack("<I", 20) + frame[4:],
        "fli_frame_size_zero": _fli_head(12, 7) + struct.pack("<I", 0) + frame[4:],
        "fli_frame_size_high_bit": _fli_head(12, 7) + struct.pack("<I", 0xB6000000 | len(frame)) + frame[4:],
        "fli_no_chunks": _fli_head(12, 7) + chip_smoke.fli_frame([]),
        "fli_unknown_chunk": _fli_head(12, 7) + chip_smoke.fli_frame([chip_smoke.fli_chunk(99, b"abcd"), brun]),
        "fli_chunk_of_size_0": _fli_head(12, 7) + chip_smoke.fli_frame([struct.pack("<IH", 0, 18) + bytes(10)]),
        "fli_copy_short": _fli_head(12, 7) + chip_smoke.fli_frame([chip_smoke.fli_chunk(16, idx.tobytes()[:-5])]),
        "fli_copy_short_then_frame": _fli_head(12, 7, frames=2) + chip_smoke.fli_frame(
            [chip_smoke.fli_chunk(16, idx.tobytes()[:-5])]) + chip_smoke.fli_frame([brun]),
        "fli_lc_past_height": _fli_head(12, 7) + chip_smoke.fli_frame(
            [chip_smoke.fli_chunk(12, struct.pack("<HH", 5, 4) + bytes(4))]),
        "fli_lc_starting_past": _fli_head(12, 7) + chip_smoke.fli_frame(
            [chip_smoke.fli_chunk(12, struct.pack("<HH", 9, 0))]),
        "fli_ss2_skip_past": _fli_head(12, 7) + chip_smoke.fli_frame(
            [chip_smoke.fli_chunk(7, struct.pack("<HH", 1, 65536 - 9) + bytes(2))]),
        "fli_ss2_skip_and_odd_pixel": _fli_head(13, 7) + chip_smoke.fli_frame(
            [chip_smoke.fli_chunk(7, struct.pack("<HHHHBB", 1, 65536 - 3, 0x8000 | 77, 1, 2, 1) + b"xy")]),
        "fli_brun_zero_run": _fli_head(4, 1) + chip_smoke.fli_frame([chip_smoke.fli_chunk(15, bytes([1, 0, 5, 4, 9]))]),
        "fli_palette_of_256": _fli_head(12, 7) + chip_smoke.fli_frame(
            [chip_smoke.fli_chunk(4, struct.pack("<HBB", 1, 0, 0) + rng.bytes(768)), brun]),
        "fli_palette_past_256": _fli_head(12, 7) + chip_smoke.fli_frame(
            [chip_smoke.fli_chunk(4, struct.pack("<HBB", 1, 200, 100) + rng.bytes(300)), brun]),
        "fli_color64_past_8_bits": _fli_head(12, 7, magic=0xAF11, flags=0) + chip_smoke.fli_frame(
            [chip_smoke.fli_chunk(11, struct.pack("<HBB", 1, 0, 4) + bytes([255, 64, 63, 200] * 3)), brun]),
        "fli_palette_after_a_chunk_of_size_0": _fli_head(12, 7) + chip_smoke.fli_frame(
            [struct.pack("<IH", 0, 18) + bytes(4), chip_smoke.fli_chunk(4, struct.pack("<HBB", 1, 0, 4) + bytes(12))]),
        "fli_fails_over_to_pcd": _pcd_after(_fli_head(768, 512)[:20] + b"\1" + _fli_head(768, 512)[21:]),
        "pcd_header_cut": chip_smoke.pcd_bytes(files.image(8, 768, 512))[: 2048 + 1538],
        "pcd_header_whole": chip_smoke.pcd_bytes(files.image(8, 768, 512))[: 2048 + 1539],
        "pcd_orientation_2": chip_smoke.pcd_bytes(files.image(8, 768, 512), 6),
        "iptc_illegal_length": chip_smoke.iptc_bytes(grey.tobytes(), 12, 7)[:-len(grey.tobytes()) - 5] + bytes(
            (0x1C, 8, 10, 140, 0)),
        "iptc_no_image_field": chip_smoke.iptc_bytes(b"", 12, 7)[:-5],
        "iptc_compression_3": chip_smoke.iptc_bytes(grey.tobytes(), 12, 7, compression=3),
        "iptc_no_compression": chip_smoke.iptc_bytes(grey.tobytes(), 12, 7).replace(b"\x1c\x03x\x00\x01\x01", b""),
        "iptc_band_past_bands": chip_smoke.iptc_bytes(grey.tobytes(), 12, 7, layers=3, component=1, band=5),
        "iptc_band_0_is_the_last": chip_smoke.iptc_bytes(grey.tobytes(), 12, 7, layers=4, component=1, band=0),
        "iptc_no_band_field": chip_smoke.iptc_bytes(grey.tobytes(), 12, 7, layers=3, component=1),
        "iptc_layers_2": chip_smoke.iptc_bytes(grey.tobytes(), 12, 7, layers=2, component=1),
        "iptc_raw_short": chip_smoke.iptc_bytes(grey.tobytes()[:50], 12, 7),
        "iptc_raw_extended_lengths": chip_smoke.iptc_bytes(grey.tobytes(), 12, 7, pieces=4),
        "iptc_other_record": chip_smoke.iptc_bytes(grey.tobytes(), 12, 7).replace(b"\x1c\x02\x00", b"\x1c\x0a\x00"),
        "iptc_pgm_file": chip_smoke.iptc_bytes(pgm, 12, 7, compression=5),
        "iptc_unknown_file": chip_smoke.iptc_bytes(b"<html>no image</html>", 12, 7, compression=5),
        "iptc_unknown_file_in_a_band": chip_smoke.iptc_bytes(b"<html>no image</html>", 12, 7, layers=3, component=1,
                                                             band=1, compression=5),
        "iptc_fails_over_to_pcd": _pcd_after(b"\x1c\x02\x00\x00\x02\x00\x02"),
    }


@pytest.mark.parametrize("case", sorted(_edge_cases()))
def test_header_edge_cases_as_pillow(tmp_path, case):
    """Headers each plugin's _open takes, refuses (Image.open then tries its next reader, here a PhotoCD file)
    or fails: FITS cards missing or unreadable, a data part shorter than a card (Pillow's offset moves back),
    tiled forms of other compressions or float samples; FLI frames whose size Pillow reads past or short of,
    chunks its decoder refuses, palettes past 256 or over 8 bits; a PCD header cut at its orientation byte;
    IPTC lengths, compressions and bands Pillow refuses, and a file in an IPTC file."""
    assert_as_pillow(tmp_path, _edge_cases()[case], case)


def test_failing_headers_fall_over_to_pcd():
    """A FITS, FLI or IPTC header that its reader's _open refuses leaves the file to the readers after it."""
    cases = _edge_cases()
    assert {jpeg.image_format(cases[f"{kind}_fails_over_to_pcd"]) for kind in ("fits", "fli", "iptc")} == {"pcd"}
    assert jpeg.image_format(cases["fits_missing_naxis2"]) == jpeg.image_format(cases["fli_missing_frame"]) == "unknown"


def test_pcd_layout_and_ycc_tables_are_pillows(tmp_path):
    """Every (Y, Cb, Cr) triple through Pillow's PhotoCD reader gives `pcd.ycc_to_rgb`'s pixel: 43 files, each
    pixel's luma and its 2 x 2 block's chroma set from its place in the file (two luma rows and 384 Cb and 384
    Cr samples a 3 x 768-byte chunk)."""
    from PIL import Image

    total, per = 65536 * 64, 256 * 384
    for f in range(-(-total // per)):
        s = np.arange(f * per, (f + 1) * per) % total
        cb, cr, y0 = (s // 64 // 256).reshape(256, 384), (s // 64 % 256).reshape(256, 384), (4 * (s % 64)).reshape(
            256, 384)
        chunks = np.zeros((256, 3 * 768), np.uint8)
        for j in range(2):
            for e in range(2):
                chunks[:, j * 768 + e : (j + 1) * 768 : 2] = y0 + 2 * j + e
        chunks[:, 1536:1920], chunks[:, 1920:] = cb, cr
        data = bytearray(96 * 2048) + chunks.tobytes()
        data[2048:2052] = b"PCD_"
        path = tmp_path / "f.pcd"
        path.write_bytes(data)
        with Image.open(path) as im:
            want = np.asarray(im.convert("RGB"))
        np.testing.assert_array_equal(pcd.decode(bytes(data)), want, err_msg=f"file {f}")


def _fli_chunk_streams(count: int, seed: int) -> list:
    """Seeded FLC files of 0-3 chunks of seeded bodies (SS2 and LC line counts kept near the height)."""
    rng, out = np.random.default_rng(seed), []
    for _ in range(count):
        w, h = int(rng.integers(1, 20)), int(rng.integers(1, 12))
        chunks = []
        for _ in range(int(rng.integers(0, 4))):
            kind = int(rng.choice([4, 7, 11, 12, 13, 15, 16, 18, 5]))
            body = rng.integers(0, 256, int(rng.integers(4, 3 * w * h + 10)), dtype=np.uint8)
            if kind in (7, 12):
                body[0], body[1] = min(body[0], h), 0
            if kind == 12:
                body[2], body[3] = min(body[2], h), 0
            chunks.append(chip_smoke.fli_chunk(kind, body.tobytes(), pad=bool(rng.random() < 0.5)))
        data = _fli_head(w, h) + chip_smoke.fli_frame(chunks)
        out.append(data[: int(rng.integers(128, len(data) + 1))] if rng.random() < 0.3 else data)
    return out


def test_fli_decoder_over_seeded_chunk_streams(tmp_path):
    """FliDecode.c as Pillow runs it, held on seeded chunk streams: BRUN, COPY, BLACK, LC and SS2 bodies of
    seeded bytes, palettes, postage stamps and an unknown type, some cut short."""
    decoded = sum(assert_as_pillow(tmp_path, data, f"stream {k}") for k, data in enumerate(_fli_chunk_streams(300, 7)))
    assert decoded >= 50


def _iptc_inner(kind: str, grey: np.ndarray) -> bytes:
    h, w = grey.shape
    rgb = np.stack([grey, 255 - grey, grey // 2], axis=2)
    if kind == "jpeg_grey":
        return chip_smoke.jpeg_bytes(grey, 85)
    if kind == "jpeg_rgb":
        return chip_smoke.jpeg_bytes(rgb, 85)
    if kind == "pgm":
        return files.pillow_pgm(grey)
    if kind == "pbm":
        return b"P4 %d %d\n" % (w, h) + np.packbits(grey > 127, axis=1).tobytes()
    if kind == "ppm":
        return b"P6 %d %d 255\n" % (w, h) + rgb.tobytes()
    if kind == "png_grey":
        return chip_smoke.png_bytes(grey[..., None], 0)
    if kind == "png_rgb":
        return chip_smoke.png_bytes(rgb, 2)
    if kind == "pf":
        return b"Pf %d %d -1.0\n" % (w, h) + (grey.astype("<f4") * 0.5).tobytes()
    if kind == "fits_float":
        return chip_smoke.fits_bytes(grey[::-1].astype("<f4").tobytes(), -32, w, h)
    if kind == "mcidas_i16":
        return files.mcidas_bytes(grey.astype(np.uint16))
    if kind == "lab_tiff":
        from PIL import Image

        return _pillow_bytes(Image.fromarray(rgb).convert("LAB"), "TIFF")
    if kind == "iptc":
        return chip_smoke.iptc_bytes(grey.tobytes(), w, h)
    raise KeyError(kind)


def _pillow_bytes(im, fmt: str) -> bytes:
    import io

    buf = io.BytesIO()
    im.save(buf, fmt)
    return buf.getvalue()


# (inner file, layers, band field): every band of an RGB / CMYK merge for grey files, a "1" image at the first
# band and at others, files of several bands; L images of modes Pillow cannot convert to RGB
IPTC_BANDS = [(kind, layers, band) for kind in ("jpeg_grey", "pgm") for layers, band in
              ((1, None), (3, 1), (3, 2), (3, 3), (3, 0), (4, 1), (4, 4), (4, 0))] + [
    ("pbm", 3, 1), ("pbm", 3, 2), ("pbm", 4, 0), ("png_grey", 3, 2), ("png_grey", 4, 1), ("png_rgb", 3, 1),
    ("png_rgb", 3, 2), ("jpeg_rgb", 3, 1), ("jpeg_rgb", 4, 3), ("ppm", 3, 1), ("jpeg_rgb", 1, None),
    ("png_rgb", 1, None), ("pf", 1, None), ("fits_float", 1, None), ("mcidas_i16", 1, None), ("lab_tiff", 1, None),
    ("iptc", 1, None), ("iptc", 3, 2)]


@pytest.mark.parametrize("case", IPTC_BANDS, ids=[f"{k}-{l}-{b}" for k, l, b in IPTC_BANDS])
def test_iptc_band_merge_as_pillow(tmp_path, case):
    """IPTC's image files (compression 5) merged into their band, or converted from their own mode for an L
    image: as Pillow, or UnsupportedImageFormat for a band of a file whose mode the port does not tell."""
    kind, layers, band = case
    grey = files.image(9, 14, 11)[..., 0]
    data = chip_smoke.iptc_bytes(_iptc_inner(kind, grey), 14, 11, layers=layers, component=int(layers > 1),
                                 band=band, compression=5)
    if kind == "iptc" and band is not None:
        with pytest.raises(jpeg.UnsupportedImageFormat):
            jpeg.decode_image(data, "f", "cpu")
        return
    assert_as_pillow(tmp_path, data, str(case))


@pytest.mark.parametrize("levels", [3, 50, iptc.MAX_DEPTH + 200])
def test_nested_iptc_as_pillow(tmp_path, levels):
    """IPTC files nested in IPTC files: unwrapped in a loop, refused past MAX_DEPTH, where Pillow's recursion
    fails too."""
    data = chip_smoke.iptc_bytes(bytes(range(35)), 7, 5)
    for _ in range(levels):
        data = chip_smoke.iptc_bytes(data, 7, 5, compression=5)
    assert assert_as_pillow(tmp_path, data, f"{levels} levels") == (levels < iptc.MAX_DEPTH)


# --- the native FLI stage (the card's machine)


@pytest.fixture
def native():
    if not torch.cuda.is_available():
        pytest.skip("needs the card's machine: csrc/raster.cu is built by nvcc, installed there")
    return "cuda"


def _outcome(fn, data: bytes):
    try:
        return fn(data, "f").tobytes()
    except (ValueError, raster.NotThisFormat) as err:
        return type(err).__name__


@pytest.mark.gpu
def test_native_fli_equals_the_twin(native):
    """`uniir_raster_fli` gives the twin's pixels, or fails where it fails, on every FLI form, its cuts and
    flips, and seeded chunk streams; one native call a decode that reaches the frame."""
    samples = [data for name, data in sorted(corpus(0).items()) if name.endswith(".fli")]
    rng = np.random.default_rng(11)
    for data in list(samples):
        for case in range(20):
            b = bytearray(data)
            if case % 2:
                b = b[: int(rng.integers(128, len(b)))]
            else:
                at = int(rng.integers(128, len(b)))
                b[at] ^= int(rng.integers(1, 256))
            samples.append(bytes(b))
    samples += _fli_chunk_streams(300, 7)
    decoded = 0
    for k, data in enumerate(samples):
        before = raster.native_calls["fli"]
        got = _outcome(fli.decode_native, data)
        assert got == _outcome(fli.decode_twin, data), k
        if not isinstance(got, str):
            decoded += 1
            assert raster.native_calls["fli"] == before + 1
            assert jpeg.decode_image(data, "f", native).tobytes() == got
    assert decoded >= 100
