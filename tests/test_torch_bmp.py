"""The BMP decoder (`uniir_tpu_torch.data.bmp`, numpy only) bit-equal to
Pillow's `Image.open(...).convert("RGB")` over every header, bit depth,
bit-field layout and RLE form (files from chip_smoke.py's writer), Pillow's
own RLE quirks (a four-byte delta, RLE4's absolute runs, word alignment by
file position, encoded runs clipped at the row's end), its widening of 5 and
6-bit fields, its grey-ramp palettes, and a truncated or corrupt file raising
where Pillow raises."""

import io

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import chip_smoke
from chip_smoke import BMP_BITFIELDS, BMP_RLE4, BMP_RLE8
from uniir_tpu_torch.data import bmp, jpeg

HEADERS = [12, 40, 52, 56, 64, 108, 124]
MASKS = {
    "565": (0xF800, 0x7E0, 0x1F), "555": (0x7C00, 0x3E0, 0x1F), "bgra": (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
    "rgba": (0xFF, 0xFF00, 0xFF0000, 0xFF000000), "xbgr": (0xFF000000, 0xFF0000, 0xFF00, 0),
    "bgrx": (0xFF0000, 0xFF00, 0xFF, 0), "bgar": (0xFF000000, 0xFF00, 0xFF, 0xFF0000),
    "abgr": (0xFF000000, 0xFF0000, 0xFF00, 0xFF), "bgxr": (0xFF000000, 0xFF00, 0xFF, 0), "bgr24": (0xFF0000, 0xFF00, 0xFF),
}
# (bits, compression, masks name): every pixel form the decoder reads
FORMS = {
    "p1": (1, 0, None), "p4": (4, 0, None), "p8": (8, 0, None), "rgb16_555": (16, 0, None), "rgb24": (24, 0, None),
    "rgb32": (32, 0, None), "bf16_565": (16, BMP_BITFIELDS, "565"), "bf16_555": (16, BMP_BITFIELDS, "555"),
    "bf24": (24, BMP_BITFIELDS, "bgr24"), "rle8": (8, BMP_RLE8, None), "rle4": (4, BMP_RLE4, None),
    **{f"bf32_{name}": (32, BMP_BITFIELDS, name) for name in ("bgra", "rgba", "xbgr", "bgrx", "bgar", "abgr", "bgxr")},
}


def pillow_rgb(data: bytes):
    """Pillow's pixels, or the exception it raises."""
    from PIL import Image

    try:
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except Exception as e:  # Pillow raises OSError / ValueError / struct.error by case
        return e


def assert_same(data: bytes) -> None:
    """The decoder gives Pillow's pixels, or raises a ValueError naming the file where Pillow raises."""
    ref = pillow_rgb(data)
    if isinstance(ref, Exception):
        with pytest.raises(ValueError, match=r"^f\.bmp: "):
            bmp.decode(data, "f.bmp")
        return
    got = bmp.decode(data, "f.bmp")
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def form_file(form: str, seed: int, w: int, h: int, header: int, top_down: bool) -> bytes:
    bits, compression, masks = FORMS[form]
    rng = np.random.default_rng(seed)
    if bits <= 8:
        colors = int(rng.integers(1, (1 << bits) + 1)) if rng.random() < 0.5 else 0
        palette = rng.integers(0, 256, 3 * (colors or 1 << bits), dtype=np.uint8).tobytes()
        image = rng.integers(0, 1 << bits, (h, w))
        image = np.where(rng.random((h, 1)) < 0.5, image[:, :1], image).astype(np.uint8)  # rows of runs
        return chip_smoke.bmp_bytes(image, bits, palette=palette, colors_used=colors, compression=compression,
                                    header=header, top_down=top_down)
    image = rng.integers(0, 256, (h, w, 4 if bits == 32 else 3), dtype=np.uint8)
    return chip_smoke.bmp_bytes(image, bits, compression=compression, masks=MASKS.get(masks), header=header,
                                top_down=top_down)


@pytest.mark.parametrize("form", sorted(FORMS))
@settings(max_examples=20, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 2**31), w=st.integers(1, 300), h=st.integers(1, 300),
       header=st.sampled_from(HEADERS), top_down=st.booleans())
def test_decoder_is_bit_equal_to_pillow(form, seed, w, h, header, top_down):
    """Every form under every header it fits (the core header has no
    compression field and no negative height); RLE4's odd absolute runs and
    other quirks make Pillow refuse some files, and then the decoder raises."""
    if header == 12 and (FORMS[form][1] or top_down):
        header = 40
    assert_same(form_file(form, seed, w, h, header, top_down))


@pytest.mark.parametrize("header", HEADERS)
@pytest.mark.parametrize("bits", [1, 4, 8, 24])
def test_every_header_reads_palettes_and_rgb(header, bits):
    rng = np.random.default_rng(header + bits)
    if bits <= 8:
        palette = rng.integers(0, 256, 3 << bits, dtype=np.uint8).tobytes()
        idx = rng.integers(0, 1 << bits, (7, 13)).astype(np.uint8)
        data = chip_smoke.bmp_bytes(idx, bits, palette=palette, header=header)
        want = np.frombuffer(palette, np.uint8).reshape(-1, 3)[idx]
    else:
        want = rng.integers(0, 256, (7, 13, 3), dtype=np.uint8)
        data = chip_smoke.bmp_bytes(want, bits, header=header)
    np.testing.assert_array_equal(bmp.decode(data), want)
    assert_same(data)


def test_pillows_conversion_rules():
    """The rules the module docstring states, on fixed values."""
    v5 = (np.arange(32, dtype=np.uint8) << 3)[None, :, None].repeat(3, 2)
    v6 = np.stack([np.zeros(64, np.uint8), np.arange(64, dtype=np.uint8) << 2, np.zeros(64, np.uint8)], -1)[None]
    assert bmp.decode(chip_smoke.bmp_bytes(v5, 16))[0, :, 0].tolist() == [x * 255 // 31 for x in range(32)]
    data = chip_smoke.bmp_bytes(v6, 16, compression=BMP_BITFIELDS, masks=MASKS["565"])
    assert bmp.decode(data)[0, :, 1].tolist() == [x * 255 // 63 for x in range(64)]
    idx = np.array([[0, 1, 2, 200]], np.uint8)
    assert bmp.decode(chip_smoke.bmp_bytes(idx, 8, palette=bytes(range(9)), colors_used=3))[0, 3].tolist() == [0, 0, 0]
    ramp = bytes(v for i in range(16) for v in (i, i, i))  # a grey ramp: Pillow reads L, the index as grey
    assert bmp.decode(chip_smoke.bmp_bytes(idx, 8, palette=ramp, colors_used=16))[0, :, 0].tolist() == [0, 1, 2, 200]
    bw = chip_smoke.bmp_bytes(np.array([[0, 1, 1, 0, 1, 0, 0, 1, 1]] * 2, np.uint8), 8, palette=bytes([0] * 3 + [255] * 3),
                              colors_used=2)  # black and white: Pillow reads the 8-bit rows as bits
    for data in (bw, chip_smoke.bmp_bytes(idx, 8, palette=ramp, colors_used=16)):
        assert_same(data)


# RLE8 data of a 6 x 4 image (rows bottom-up), by what Pillow makes of it
RLE_CASES = {
    "end_of_line_pads": b"\x03\x01\x00\x00" + b"\x06\x02\x00\x00" + b"\x06\x03\x00\x00" + b"\x06\x04\x00\x01",
    "early_end_of_bitmap": b"\x06\x01\x00\x00\x06\x02\x00\x01",
    "delta_reads_four_bytes": b"\x02\x01\x00\x02\x01\x01\x03\x05\x00\x00" + b"\x06\x03\x00\x00" * 3 + b"\x00\x01",
    "delta_padded": b"\x02\x01\x00\x02\x01\x01\x00\x00\x03\x05\x00\x00" + b"\x06\x03\x00\x00" * 3 + b"\x00\x01",
    "delta_right_up": b"\x02\x01\x00\x02\x00\x00\x02\x01\x03\x05\x00\x00" + b"\x06\x03\x00\x00" * 3 + b"\x00\x01",
    "run_past_the_row": b"\x09\x01\x00\x00" + b"\x06\x02\x00\x00" * 3 + b"\x00\x01",
    "no_end_of_line": b"\x06\x01\x06\x02\x06\x03\x06\x04",
    "absolute_odd": b"\x00\x03\x01\x02\x03\x00\x03\x04\x00\x00" + b"\x06\x03\x00\x00" * 3 + b"\x00\x01",
    "truncated": b"\x06\x01\x06",
}
RLE4_CASES = {
    "absolute_odd": b"\x00\x03\x12\x30\x03\x45\x00\x00" + b"\x06\x33\x00\x00" * 3 + b"\x00\x01",
    "absolute_even": b"\x00\x04\x12\x34\x02\x56\x00\x00" + b"\x06\x33\x00\x00" * 3 + b"\x00\x01",
    "absolute_five": b"\x00\x05\x12\x34\x50\x00\x01\x66\x00\x00" + b"\x06\x33\x00\x00" * 3 + b"\x00\x01",
    "pair_runs": b"\x05\x12\x00\x00" + b"\x06\x34\x00\x00" * 3 + b"\x00\x01",
}


@pytest.mark.parametrize("case", [f"rle8_{k}" for k in RLE_CASES] + [f"rle4_{k}" for k in RLE4_CASES])
def test_rle_escapes_as_pillow_reads_them(case):
    """End of line, end of bitmap, delta (what it skips is index 0), runs
    clipped at the row's end, RLE4's absolute runs; Pillow's pixels or its
    refusal, fixed data."""
    four = case.startswith("rle4")
    rle = (RLE4_CASES if four else RLE_CASES)[case[5:]]
    palette = bytes(range(30, 78))
    data = chip_smoke.bmp_bytes(np.zeros((4, 6), np.uint8), 4 if four else 8, palette=palette, colors_used=16,
                                compression=BMP_RLE4 if four else BMP_RLE8, rle=rle)
    assert_same(data)
    if case == "rle8_delta_reads_four_bytes":
        got = bmp.decode(data)
        assert (got[:3] == np.frombuffer(palette[:3], np.uint8)).all() and got[3, :2].tolist() == [list(palette[3:6])] * 2


def _refused() -> dict:
    img = np.random.default_rng(5).integers(0, 256, (10, 12, 3), dtype=np.uint8)
    good = chip_smoke.bmp_bytes(img, 24)
    pal8 = chip_smoke.bmp_bytes(img[..., 0], 8, palette=bytes(range(256)) * 3)
    return {
        "not_a_bmp": (b"BN" + good[2:], r"not a BMP file"),
        "truncated_header": (good[:30], r"truncated BMP header"),
        "header_size_20": (good[:14] + (20).to_bytes(4, "little") + good[18:], r"unsupported BMP header type \(20\)"),
        "bits_7": (good[:28] + (7).to_bytes(2, "little") + good[30:], r"unsupported BMP pixel depth \(7\)"),
        "compression_4": (good[:30] + (4).to_bytes(4, "little") + good[34:], r"unsupported BMP compression \(4\)"),
        "bitfields_layout": (chip_smoke.bmp_bytes(img, 24, compression=BMP_BITFIELDS, masks=(0xFF, 0xFF00, 0xFF0000)),
                             r"unsupported BMP bitfields layout"),
        "palette_300": (chip_smoke.bmp_bytes(img[..., 0], 8, palette=bytes(range(256)) * 4, colors_used=300),
                        r"invalid palette size"),
        "truncated_pixels": (good[:-40], r"truncated BMP image data"),
        "rle_short": (chip_smoke.bmp_bytes(img[..., 0], 8, palette=bytes(range(256)) * 3, compression=BMP_RLE8,
                                           rle=b"\x06\x01\x00\x01"), r"not enough image data"),
        "rle_for_rgb": (chip_smoke.bmp_bytes(img, 24)[:30] + (1).to_bytes(4, "little") + good[34:], r"RLE data"),
        "width_0": (pal8[:18] + (0).to_bytes(4, "little") + pal8[22:], r"BMP image of size 0"),
    }


@pytest.mark.parametrize("form", sorted(_refused()))
def test_refused_forms_raise_naming_the_file(form):
    data, pattern = _refused()[form]
    with pytest.raises(ValueError, match=rf"^f\.bmp: .*{pattern}"):
        bmp.decode(data, "f.bmp")
    assert isinstance(pillow_rgb(data), Exception)


def test_corrupt_files_raise_or_decode_as_pillow_does():
    """Random byte flips and cuts over every form: Pillow's pixels, or a ValueError where it raises."""
    rng = np.random.default_rng(9)
    names = sorted(FORMS)
    for k in range(120):
        data = form_file(names[k % len(names)], k, int(rng.integers(1, 30)), int(rng.integers(1, 20)),
                         40 if FORMS[names[k % len(names)]][1] else int(rng.choice(HEADERS)), False)
        bad = bytearray(data)
        for at in rng.integers(0, len(bad), size=2):
            bad[at] = int(rng.integers(0, 256))
        assert_same(bytes(bad))
        assert_same(data[: int(rng.integers(2, len(data)))])


def test_read_image_decodes_a_bmp_by_its_signature(tmp_path):
    data = form_file("rle8", 3, 17, 11, 40, False)
    (tmp_path / "a.jpg").write_bytes(data)
    np.testing.assert_array_equal(jpeg.read_image(str(tmp_path / "a.jpg"), "cpu"), pillow_rgb(data))
    np.testing.assert_array_equal(jpeg.read_image(str(tmp_path / "a.jpg"), "cuda"), pillow_rgb(data))  # one decoder
    assert jpeg.image_format(data) == "bmp"
