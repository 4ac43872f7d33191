"""JP2 boxes rewritten, and cut and corrupt JPEG 2000 files, decoded by the port as Pillow 12.1 decodes them.

  * `colr` of each enumerated space (sRGB 16, grey 17, sYCC 18, CMYK 12, e-sYCC 24, CIELab 14, unknown)
    and method 2 (ICC) / 3, two `colr` boxes, none, `pclr` with and without `cmap` (entries Pillow's
    palette merges, 3 and 4 columns, more than 256 entries), `res `, `cdef`, boxes out of place: Pillow's
    pixels, or a failure where Pillow fails;
  * every cut at a marker or packet boundary and seeded cuts: the port fails where Pillow fails;
  * seeded corruptions of code-block bytes and of headers: decoded as Pillow decodes them, or failing as it
    fails.  Where the port cannot follow OpenJPEG on a corrupt file it must raise, never return other
    pixels: such files are listed by name in FOLLOWS_NOT (none so far), and any other disagreement fails.
"""

import struct
from pathlib import Path

import numpy as np
import pytest

import jpeg2000_files as files
from uniir_tpu_torch.data import jpeg

# corrupt files on which the port raises while Pillow decodes (the port cannot follow OpenJPEG there)
FOLLOWS_NOT: set = set()


def outcome(data: bytes, what: str):
    """Pillow's pixels or failure, the port's the same; a file of FOLLOWS_NOT may only fail in the port."""
    want = files.pillow_rgb(data)
    try:
        got = jpeg.decode_image(data, "f", "cpu")
    except ValueError as e:
        assert not isinstance(e, jpeg.UnsupportedImageFormat), (what, e)
        assert isinstance(want, Exception) or what in FOLLOWS_NOT, (what, "Pillow decodes it", e)
        return "error"
    assert not isinstance(want, Exception), (what, "Pillow fails", want)
    np.testing.assert_array_equal(got, want, err_msg=what)
    return "pixels"


MODES = ("L", "LA", "RGB", "RGBA")
BOXES = {
    **{f"colr_{e}": (lambda e: lambda sub: [sub[0], files.colr(e)])(e) for e in (16, 17, 18, 12, 24, 14, 99)},
    "colr_icc": lambda sub: [sub[0], files.colr(method=2, icc=bytes(40))],
    "colr_method_3": lambda sub: [sub[0], files.colr(method=3, icc=bytes(4))],
    "colr_short": lambda sub: [sub[0], (b"colr", b"\x01\x00")],
    "colr_none": lambda sub: [sub[0]], "colr_twice": lambda sub: [sub[0], files.colr(18), files.colr(16)],
    "colr_first": lambda sub: [sub[1], sub[0]],
    "res": lambda sub: sub + [(b"res ", files.box(b"resc", struct.pack(">HHHHBB", 1, 1, 1, 1, 0, 0)))],
    "res_empty": lambda sub: sub + [(b"res ", b"")],
    "cdef": lambda sub: sub + [(b"cdef", struct.pack(">HHHH", 1, 0, 0, 1))],
    "cdef_short": lambda sub: sub + [(b"cdef", b"\x00\x01")],
    "bpcc": lambda sub: sub + [(b"bpcc", b"\x07")], "ihdr_twice": lambda sub: [sub[0]] + sub,
    "ihdr_missing": lambda sub: sub[1:], "unknown_box": lambda sub: sub + [(b"abcd", b"xyz")],
    "ihdr_size": lambda sub: [(b"ihdr", sub[0][1][:4] + struct.pack(">I", 3) + sub[0][1][8:])] + sub[1:],
    "ihdr_components": lambda sub: [(b"ihdr", sub[0][1][:8] + struct.pack(">H", 4) + sub[0][1][10:])] + sub[1:],
    "ihdr_bits": lambda sub: [(b"ihdr", sub[0][1][:10] + b"\x0b" + sub[0][1][11:])] + sub[1:],
}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("form", sorted(BOXES))
def test_jp2_header_boxes(mode, form):
    data = files.pillow_file(mode, 12, 14, seed=len(form))
    outcome(files.rebuild_jp2(data, BOXES[form]), f"{mode} {form}")


@pytest.mark.parametrize("placement", ["xml_before_codestream", "colr_outside_header", "jp2c_first"])
def test_jp2_top_level_boxes(placement):
    data = files.pillow_file("RGB", 12, 14, seed=3)
    if placement == "xml_before_codestream":
        variant = files.rebuild_jp2(data, before_codestream=[(b"xml ", b"<a/>")])
    elif placement == "colr_outside_header":
        variant = files.rebuild_jp2(data, before_codestream=[files.colr(18)])
    else:
        top = files.boxes(data)
        variant = b"".join(files.box(k, b) for k, b in [top[0], top[1], top[3], top[2]])
    outcome(variant, placement)


PALETTES = {"rgb_16": (16, 3, False), "rgb_merged": (8, 3, True), "rgb_256": (256, 3, False),
            "rgba_10": (10, 4, False), "rgb_300": (300, 3, False), "one_column": (12, 1, False)}


@pytest.mark.parametrize("form", sorted(PALETTES))
def test_palette_boxes(form):
    """`pclr` (and `cmap`) make Pillow's mode P / PA with a palette built by getcolor, which merges equal
    entries; OpenJPEG's tile reading leaves the indices as they are, and an index past the palette is black."""
    entries, channels, merged = PALETTES[form]
    rng = np.random.default_rng(entries)
    colours = [tuple(int(v) for v in rng.integers(0, 256, channels)) for _ in range(entries)]
    if merged:
        colours[3] = colours[1]
    for with_cmap in (True, False):
        for enumcs in (16, 17):
            outcome(files.palette_file(colours, channels, seed=entries, with_cmap=with_cmap, enumcs=enumcs),
                    f"{form} cmap {with_cmap} colr {enumcs}")


CUT_SOURCES = {
    "pillow_jp2_layers": lambda: files.pillow_file("RGB", 20, 22, seed=1, quality_layers=[30, 10, 2]),
    "pillow_j2k_tiles": lambda: files.pillow_file("RGBA", 20, 22, seed=2, tile_size=(8, 8), no_jp2=True),
    "opj_sop_eph": lambda: files.opj_file(3, 19, 17, 8, seed=3, csty=6, rates=[20, 4, 0]),
    "opj_bypass_termall": lambda: files.opj_file(1, 19, 17, 8, seed=4, mode=1 | 4),
    "opj_ppm": lambda: files.to_ppm(files.opj_file(3, 19, 17, 8, seed=5, csty=6, rates=[10, 0])),
    "opj_tile_parts": lambda: files.opj_file(3, 24, 20, 8, seed=6, tp_on=1, tp_flag=ord("L"), rates=[10, 0]),
}


@pytest.mark.parametrize("source", sorted(CUT_SOURCES))
def test_every_cut_fails_where_pillow_fails(source):
    """Every cut at a marker or packet boundary (and one and two bytes in), and seeded cuts."""
    data = CUT_SOURCES[source]()
    rng = np.random.default_rng(len(data))
    cuts = set(files.boundaries(data)) | {int(v) for v in rng.integers(1, len(data), 24)} | {len(data) - 1}
    for n in sorted(cuts):
        outcome(data[:n], f"{source} cut at {n}")


@pytest.mark.parametrize("source", sorted(CUT_SOURCES))
def test_corruptions_decode_or_fail_as_pillow(source):
    """Seeded corruptions: one to three bytes replaced in the code-block data, and in the headers (the
    main header, the tile-part headers and the first packet headers)."""
    data = CUT_SOURCES[source]()
    prefix, main, parts, _ = files.split(data)
    header_end = len(prefix) + 2 + sum(4 + len(b) for _, b in main) + 80
    data_start = data.index(b"\xff\x93") + 2
    rng = np.random.default_rng(len(data) + 1)
    for k in range(60):
        bad = bytearray(data)
        lo, hi = (data_start, len(data) - 2) if k % 2 == 0 else (len(prefix), min(header_end, len(data)))
        for at in rng.integers(lo, hi, size=1 + k % 3):
            bad[at] = int(rng.integers(0, 256))
        outcome(bytes(bad), f"{source} corruption {k}")


# --- the native decoder (csrc/jpeg2000.cu, built by nvcc on the card's machine)


@pytest.fixture
def native():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs the card's machine: csrc/jpeg2000.cu is built by nvcc, which is installed there")
    return lambda data: jpeg.decode_image(data, "f", "cuda")


CORPUS = Path(__file__).resolve().parent / "data" / "jpeg2000"
# stored corpus files of the forms above (the card's machine has no Pillow or OpenJPEG to write them)
NATIVE_SOURCES = ("09_layers_rates.jp2", "15_tiles.jp2", "23_style_termall.j2k", "28_sop_eph.j2k",
                  "30_tile_parts_l.j2k", "41_ppm.j2k", "33_subsampled_ycc.j2k", "47_palette.jp2")


@pytest.mark.gpu
@pytest.mark.parametrize("source", NATIVE_SOURCES)
def test_native_refuses_what_the_twin_refuses(native, source):
    """Cuts and corruptions: the native decoder raises where the twin raises, with the same message, and
    decodes the rest to the same pixels."""
    data = (CORPUS / source).read_bytes()
    rng = np.random.default_rng(len(data) + 2)
    variants = [data[:n] for n in files.boundaries(data)]
    for _ in range(40):
        bad = bytearray(data)
        bad[int(rng.integers(0, len(bad)))] = int(rng.integers(0, 256))
        variants.append(bytes(bad))
    for v in variants:
        try:
            want = jpeg.decode_image(v, "f", "cpu")
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                native(v)
            assert str(got.value) == str(e)
            continue
        np.testing.assert_array_equal(native(v), want)
