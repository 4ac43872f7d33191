"""The GIF decoders (`uniir_tpu_torch.data.gif`): the twin bit-equal to
Pillow's `Image.open(...).convert("RGB")` over every form of a first frame
(files from chip_smoke.py's writer: interlaced, local and short palettes,
grey-ramp palettes, transparency, frame offsets, deferred clears, every
minimum code size), Pillow's rules for the canvas, the palette's end and a
broken or truncated stream, and (`-m gpu`, on the card's machine, where nvcc
builds csrc/gif.cu) the native decoder bit-equal to the twin.

The module imports no JAX and no Pillow at its top, so its `-m gpu` cases
collect with `--noconftest` on a machine that has neither."""

import io
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import chip_smoke
from uniir_tpu_torch.data import gif, jpeg

FORMS = ["plain", "interlaced", "local_palette", "short_palette", "transparency", "deferred_clear", "frame_offset",
         "grey_palette", "no_palette", "min_code_size"]


def pillow_rgb(data: bytes):
    """Pillow's pixels, or the exception it raises."""
    from PIL import Image

    try:
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except Exception as e:  # Pillow raises OSError / SyntaxError / EOFError / ValueError by case
        return e


def twin_rgb(data: bytes):
    try:
        return gif.decode_twin(data, "f.gif")
    except ValueError as e:
        assert str(e).startswith("f.gif: "), e
        return e


def assert_same(data: bytes) -> None:
    """The twin gives Pillow's pixels, or raises where Pillow raises."""
    ref, got = pillow_rgb(data), twin_rgb(data)
    if isinstance(ref, Exception) or isinstance(got, Exception):
        assert isinstance(ref, Exception) and isinstance(got, Exception), (ref, got)
    else:
        assert got.dtype == np.uint8 and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


def form_file(form: str, seed: int, w: int, h: int) -> bytes:
    """A seeded GIF of the form: indices with runs and noise, and the form's options."""
    rng = np.random.default_rng(seed)
    n_colors = int(rng.integers(1, 257))
    palette = rng.integers(0, 256, 3 * n_colors, dtype=np.uint8).tobytes()
    top = n_colors
    kw = {}
    if form == "interlaced":
        kw["interlace"] = True
    elif form == "local_palette":
        kw["local"] = True
    elif form == "short_palette":  # indices past the table's end, a min code size wider than the table
        n_colors = int(rng.integers(1, 9))
        palette, top = palette[: 3 * n_colors], 256
    elif form == "transparency":
        kw["transparency"] = int(rng.integers(0, top))
        kw["screen"] = (w + int(rng.integers(0, 9)), h + int(rng.integers(0, 9)))
    elif form == "deferred_clear":
        kw["deferred_clear"] = True
    elif form == "frame_offset":
        kw["offset"] = (int(rng.integers(0, 20)), int(rng.integers(0, 20)))
        kw["screen"] = (int(rng.integers(1, w + 30)), int(rng.integers(1, h + 30)))
    elif form == "grey_palette":
        n_colors = int(rng.integers(1, 257))
        palette, top = bytes(v for i in range(n_colors) for v in (i, i, i)), 256
    elif form == "no_palette":
        palette = b""
    idx = rng.integers(0, top, (h, w))
    runs = rng.random((h, 1)) < 0.5
    idx = np.where(runs, idx[:, :1], idx).astype(np.uint8)
    bits = int(idx.max()).bit_length()
    table_bits = max(1, (max(1, len(palette) // 3) - 1).bit_length())
    kw["min_code_size"] = max(2, bits, table_bits if palette else 0)
    if form == "min_code_size":
        low = 1 if bits <= 1 else bits
        kw["min_code_size"] = int(rng.integers(low, 9))
    return chip_smoke.gif_bytes(idx, palette, **kw)


@pytest.mark.parametrize("form", FORMS)
@settings(max_examples=25, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 2**31), w=st.integers(1, 300), h=st.integers(1, 300))
def test_twin_is_bit_equal_to_pillow(form, seed, w, h):
    data = form_file(form, seed, w, h)
    ref = pillow_rgb(data)
    assert not isinstance(ref, Exception), ref
    np.testing.assert_array_equal(gif.decode_twin(data, "f.gif"), ref)


def test_pillows_first_frame_rules():
    """The rules the module docstring states, on fixed values."""
    pal = bytes([10, 20, 30, 200, 100, 50, 1, 2, 3, 4, 5, 6])
    idx = np.array([[0, 1, 2, 3]], np.uint8)
    # the canvas outside the frame: index 0, or the transparency index; the background index is not used
    plain = gif.decode_twin(chip_smoke.gif_bytes(idx, pal, screen=(6, 3), offset=(1, 1), background=3))
    assert plain[0, 0].tolist() == [10, 20, 30] and plain[1, 1:5].tolist() == [[10, 20, 30], [200, 100, 50],
                                                                                  [1, 2, 3], [4, 5, 6]]
    clear = gif.decode_twin(chip_smoke.gif_bytes(idx, pal, screen=(6, 3), offset=(1, 1), transparency=2))
    assert clear[0, 0].tolist() == [1, 2, 3] and clear[1, 3].tolist() == [1, 2, 3]  # its palette colour kept
    # a frame past the screen grows the image
    assert gif.decode_twin(chip_smoke.gif_bytes(idx, pal, screen=(2, 1), offset=(3, 2))).shape == (3, 7, 3)
    # past the table: black; past a grey-ramp table: the index as grey
    wide = np.array([[0, 1, 2, 200]], np.uint8)
    assert gif.decode_twin(chip_smoke.gif_bytes(wide, pal[:6], min_code_size=8))[0, 2:].tolist() == [[0, 0, 0]] * 2
    ramp = bytes(v for i in range(4) for v in (i, i, i))
    assert gif.decode_twin(chip_smoke.gif_bytes(wide, ramp, min_code_size=8))[0, :, 0].tolist() == [0, 1, 2, 200]
    for data in (chip_smoke.gif_bytes(wide, pal[:6], min_code_size=8), chip_smoke.gif_bytes(wide, ramp, min_code_size=8),
                 chip_smoke.gif_bytes(idx, pal, screen=(6, 3), offset=(1, 1), transparency=2)):
        assert_same(data)


def _big_codes():
    rng = np.random.default_rng(11)
    big = rng.integers(0, 256, (600, 600)).astype(np.uint8)
    return big, rng.integers(0, 256, 768, dtype=np.uint8).tobytes(), chip_smoke.lzw_codes(big.tobytes(), 8)


def test_end_of_information_and_trailing_data():
    """An EOI before the frame is full raises as truncated when the decoder
    has the file's last 64 KiB chunk, and is read past when Pillow's reader
    had more to read; data after the trailer, and codes after the last row,
    are not read."""
    idx = np.random.default_rng(3).integers(0, 4, (20, 20)).astype(np.uint8)
    early = chip_smoke.gif_bytes(idx, bytes(12), lzw=chip_smoke.pack_codes(chip_smoke.lzw_codes(idx.tobytes()[:200], 2)))
    with pytest.raises(ValueError, match=r"^f\.gif: truncated GIF image data \(end of information"):
        gif.decode_twin(early, "f.gif")
    assert isinstance(pillow_rgb(early), OSError)
    big, pal, codes = _big_codes()
    eoi = (257, codes[1000][1])
    far = chip_smoke.gif_bytes(big, pal, lzw=chip_smoke.pack_codes(codes[:1000] + [eoi] + codes[1000:]))
    near = chip_smoke.gif_bytes(big, pal, lzw=chip_smoke.pack_codes(codes[:-300] + [eoi] + codes[-300:]))
    np.testing.assert_array_equal(gif.decode_twin(far), np.frombuffer(pal, np.uint8).reshape(256, 3)[big])
    for data in (far, near):
        assert_same(data)
    data = chip_smoke.gif_bytes(idx, bytes(12))
    for extra in (b"\x3b\x00\x01garbage", bytes(range(256))):
        assert_same(data + extra)
        np.testing.assert_array_equal(gif.decode_twin(data + extra), gif.decode_twin(data))


def _refused() -> dict:
    idx = np.random.default_rng(5).integers(0, 16, (30, 40)).astype(np.uint8)
    pal = np.random.default_rng(6).integers(0, 256, 48, dtype=np.uint8).tobytes()
    good = chip_smoke.gif_bytes(idx, pal)
    lzw_at = good.index(b"\x2c") + 10 + 1  # past the descriptor: the code size byte, then the blocks
    codes = chip_smoke.lzw_codes(idx.tobytes(), 4)
    return {
        "not_a_gif": (b"GIF88a" + good[6:], r"not a GIF file"),
        "truncated_header": (good[:11], r"not a GIF file"),
        "truncated_palette": (good[:41], r"truncated GIF colour table"),
        "no_image": (good[: 13 + 48] + b"\x3b", r"without an image"),
        "truncated_descriptor": (good[: lzw_at - 4], r"truncated GIF image descriptor"),
        "truncated_data": (good[: lzw_at + 40], r"truncated GIF image data"),
        "code_size_13": (good[:lzw_at - 1] + b"\x0d" + good[lzw_at:], r"LZW minimum code size 13"),
        "first_code_past_clear": (chip_smoke.gif_bytes(idx, pal, lzw=chip_smoke.pack_codes([(16, 5), (30, 5)] + codes[1:])),
                                  r"broken GIF data stream \(first code"),
        "code_past_next": (chip_smoke.gif_bytes(idx, pal, lzw=chip_smoke.pack_codes(codes[:3] + [(31, 5)] + codes[3:])),
                           r"broken GIF data stream \(code 31"),
        "short_control_extension": (good[:13 + 48] + b"\x21\xf9\x02\x01\x00\x00" + good[13 + 48:],
                                    r"truncated GIF graphic control extension"),
    }


@pytest.mark.parametrize("form", sorted(_refused()))
def test_refused_forms_raise_naming_the_file(form):
    """What Pillow refuses, the twin refuses with a ValueError naming the file."""
    data, pattern = _refused()[form]
    with pytest.raises(ValueError, match=rf"^f\.gif: .*{pattern}"):
        gif.decode_twin(data, "f.gif")
    assert isinstance(pillow_rgb(data), Exception)


def test_corrupt_files_raise_or_decode_as_pillow_does():
    """Random byte flips and cuts: the twin gives Pillow's pixels or raises where it raises."""
    rng = np.random.default_rng(8)
    for k in range(80):
        data = form_file(FORMS[k % len(FORMS)], k, int(rng.integers(1, 40)), int(rng.integers(1, 40)))
        bad = bytearray(data)
        for at in rng.integers(0, len(bad), size=2):
            bad[at] = int(rng.integers(0, 256))
        assert_same(bytes(bad))
        assert_same(data[: int(rng.integers(6, len(data)))])


def test_read_image_decodes_a_gif_by_its_signature(tmp_path):
    data = form_file("interlaced", 4, 21, 13)
    (tmp_path / "a.jpg").write_bytes(data)
    np.testing.assert_array_equal(jpeg.read_image(str(tmp_path / "a.jpg"), "cpu"), pillow_rgb(data))
    assert jpeg.image_format(data) == "gif" and jpeg.image_format(b"GIF87a" + data[6:]) == "gif"


def test_decoder_follows_the_runs_device():
    assert gif.decoder_for("cpu") is gif.decode_twin
    assert gif.decoder_for(torch.device("cuda", 0)) is gif.decode_native


# --- the native decoder (csrc/gif.cu, built by nvcc on the card's machine)


@pytest.fixture
def native():
    if not torch.cuda.is_available():
        pytest.skip("needs the card's machine: csrc/gif.cu is built by nvcc, which is installed there")
    return gif.decode_native


@pytest.mark.gpu
@pytest.mark.parametrize("form", FORMS)
def test_native_is_bit_equal_to_twin(native, form):
    rng = np.random.default_rng(len(form))
    for k in range(12):
        data = form_file(form, 100 * k + len(form), int(rng.integers(1, 300)), int(rng.integers(1, 300)))
        before = gif.decode_native.calls
        out = native(data)
        assert gif.decode_native.calls == before + 1
        np.testing.assert_array_equal(out, gif.decode_twin(data))


@pytest.mark.gpu
def test_native_in_threads_and_refusals(native):
    """The loader's threads decode at once; the native path refuses what the
    twin refuses, and reads the end-of-information cases as the twin does."""
    files = [form_file(FORMS[i % len(FORMS)], i, 37 + i, 21 + 2 * i) for i in range(10)]
    with ThreadPoolExecutor(8) as pool:
        outs = list(pool.map(native, files * 4))
    for i, out in enumerate(outs):
        np.testing.assert_array_equal(out, gif.decode_twin(files[i % len(files)]))
    for form, (data, pattern) in _refused().items():
        with pytest.raises(ValueError, match=rf"^f\.gif: .*{pattern}"):
            native(data, "f.gif")
    big, pal, codes = _big_codes()
    eoi = (257, codes[1000][1])
    far = chip_smoke.gif_bytes(big, pal, lzw=chip_smoke.pack_codes(codes[:1000] + [eoi] + codes[1000:]))
    near = chip_smoke.gif_bytes(big, pal, lzw=chip_smoke.pack_codes(codes[:-300] + [eoi] + codes[-300:]))
    np.testing.assert_array_equal(native(far), gif.decode_twin(far))
    with pytest.raises(ValueError, match="end of information"):
        native(near, "f.gif")
