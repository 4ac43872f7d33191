"""The WebP decoders (`uniir_tpu_torch.data.webp`, with `data.vp8` and
`data.vp8l`): the twin bit-equal to Pillow's `Image.open(...).convert("RGB")`
on files Pillow's encoder writes (lossy at many qualities and methods,
lossless at methods 0 / 4 / 6 with and without `exact`, alpha, animations),
on every form chip_smoke.py's writer emits (which proves the writer's syntax
is libwebp's), and on truncated and corrupted files, where it raises where
Pillow raises; libwebp's rules pinned on fixed files; VP8L and the ALPH
chunk's filters alone; the dataset and `read_image`; and (`-m gpu`, on the
card's machine, where nvcc builds csrc/webp.cu) the native decoder
bit-equal to the twin.

The module imports no JAX and no Pillow at its top, so its `-m gpu` cases
collect with `--noconftest` on a machine that has neither."""

import base64
import hashlib
import io
import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import chip_smoke
from uniir_tpu_torch.data import jpeg, vp8, vp8l, webp


def pillow_rgb(data: bytes):
    """Pillow's pixels, or the exception it raises."""
    from PIL import Image

    try:
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except Exception as e:  # Pillow raises OSError / SyntaxError / ValueError by case
        return e


def twin_rgb(data: bytes):
    try:
        return webp.decode_twin(data, "f.webp")
    except ValueError as e:
        assert str(e).startswith("f.webp: "), e
        return e


def assert_same(data: bytes) -> None:
    """The twin gives Pillow's pixels, or raises where Pillow raises."""
    ref, got = pillow_rgb(data), twin_rgb(data)
    if isinstance(ref, Exception) or isinstance(got, Exception):
        assert isinstance(ref, Exception) and isinstance(got, Exception), (ref, got)
    else:
        assert got.dtype == np.uint8 and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


def smooth(seed: int, w: int, h: int, channels: int = 3) -> np.ndarray:
    """A seeded colour field with noise: what an encoder meets in a photograph."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    field = np.stack([(xx * (3 + c) + yy * (2 + 2 * c) + 40 * c) % 256 for c in range(channels)], axis=2)
    return np.clip(field + rng.normal(0, 12, field.shape), 0, 255).astype(np.uint8)


def pillow_file(arr: np.ndarray, **kw) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr, "RGBA" if arr.shape[2] == 4 else "RGB").save(buf, "WEBP", **kw)
    return buf.getvalue()


# --- 1. files Pillow's encoder writes


@pytest.mark.parametrize("quality,method,w,h", [
    (0, 0, 1, 1), (5, 1, 2, 3), (30, 2, 17, 16), (50, 3, 31, 45), (75, 4, 64, 33), (90, 5, 160, 21),
    (100, 6, 15, 97), (75, 6, 48, 48), (20, 0, 99, 7), (95, 3, 1, 40), (75, 4, 160, 160), (60, 5, 129, 80),
    (10, 6, 33, 150), (85, 0, 90, 61), (100, 2, 2, 2), (45, 1, 70, 3),
])
def test_twin_is_bit_equal_to_pillow_on_lossy_files(quality, method, w, h):
    data = pillow_file(smooth(quality + w, w, h), quality=quality, method=method)
    assert data[12:16] == b"VP8 "
    assert_same(data)


@pytest.mark.parametrize("method,exact,channels,w,h", [
    (0, False, 3, 33, 20), (4, True, 3, 1, 9), (6, False, 4, 40, 31), (0, True, 4, 25, 2), (4, False, 4, 64, 64),
    (6, True, 3, 20, 57),
])
def test_twin_is_bit_equal_to_pillow_on_lossless_files(method, exact, channels, w, h):
    arr = smooth(method + w, w, h, channels)
    arr[h // 3 : h // 2] = arr[h // 3]  # runs for the LZ77 copies and the cache
    assert_same(pillow_file(arr, lossless=True, method=method, exact=exact))


@pytest.mark.parametrize("quality,alpha_quality,w,h", [(80, 100, 30, 22), (40, 20, 17, 33), (90, 0, 64, 8)])
def test_twin_is_bit_equal_to_pillow_on_lossy_files_with_alpha(quality, alpha_quality, w, h):
    """VP8X + ALPH + VP8: the alpha plane decoded (VP8L-coded, filtered), RGB as without it."""
    arr = smooth(w * h, w, h, 4)
    data = pillow_file(arr, quality=quality, alpha_quality=alpha_quality, exact=True)
    assert data[12:16] == b"VP8X" and b"ALPH" in data
    assert_same(data)


@pytest.mark.parametrize("lossless", [False, True])
def test_twin_is_bit_equal_to_pillow_on_animations(lossless):
    """A two-frame animation opens as its first frame."""
    from PIL import Image

    first, second = smooth(1, 30, 20), smooth(2, 30, 20)
    second[5:9, 3:20] = 7
    buf = io.BytesIO()
    Image.fromarray(second).save(buf, "WEBP", save_all=True, append_images=[Image.fromarray(first)],
                                 lossless=lossless, background=(200, 10, 10, 255), duration=50)
    assert_same(buf.getvalue())
    assert Image.open(io.BytesIO(buf.getvalue())).n_frames == 2


def test_embedded_pillow_files_decode_to_pillows_digests():
    """The Pillow-made files chip_smoke.py carries for the card's machine: the twin gives the digests
    written beside them, which are Pillow's."""
    for name, (b64, digest, w, h) in chip_smoke.WEBP_PILLOW_FILES.items():
        data = base64.b64decode(b64)
        out = webp.decode_twin(data, name)
        assert out.shape == (h, w, 3) and hashlib.sha256(out.tobytes()).hexdigest() == digest, name
        np.testing.assert_array_equal(out, pillow_rgb(data))


# --- 2. every form of chip_smoke.py's writer


@pytest.mark.parametrize("form", chip_smoke.WEBP_CASE_FORMS)
def test_writer_forms_decode_as_pillow_does(form):
    """Each form at a few seeded sizes, odd and even, 1 px to several macroblocks."""
    rng = np.random.default_rng(len(form))
    for k, (w, h) in enumerate([(1, 1), (int(rng.integers(2, 40)), int(rng.integers(2, 40))),
                                (int(rng.integers(17, 70)), int(rng.integers(17, 70))),
                                (int(rng.integers(100, 161)), int(rng.integers(60, 161)))]):
        data = chip_smoke.webp_bytes(form, 500 + 10 * k + len(form), w, h)
        ref = pillow_rgb(data)
        assert not isinstance(ref, Exception), (form, w, h, ref)
        np.testing.assert_array_equal(webp.decode_twin(data), ref)


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(form=st.sampled_from(chip_smoke.WEBP_CASE_FORMS), seed=st.integers(0, 2**31), w=st.integers(1, 48),
       h=st.integers(1, 48))
def test_writer_parameters_decode_as_pillow_does(form, seed, w, h):
    data = chip_smoke.webp_bytes(form, seed, w, h)
    ref = pillow_rgb(data)
    assert not isinstance(ref, Exception), ref
    np.testing.assert_array_equal(webp.decode_twin(data), ref)


def test_writer_codes_given_pixels():
    """With an image the writer's lossless forms code its pixels exactly (the phase-12 oracle) and the lossy
    ones close to them; Pillow reads them the same."""
    img = smooth(3, 37, 29, 4)
    lossless = chip_smoke.webp_bytes("lossless", 1, 0, 0, image=img)
    np.testing.assert_array_equal(webp.decode_twin(lossless), img[..., :3])
    assert_same(lossless)
    photo = np.concatenate([chip_smoke.fixture_image(3)[:29, :37], img[..., 3:]], axis=2)
    for form in ("lossy", "alpha_lossless"):
        data = chip_smoke.webp_bytes(form, 2, 0, 0, image=photo)
        out = webp.decode_twin(data)
        assert np.abs(out.astype(int) - photo[..., :3]).mean() < 6, form
        assert_same(data)


# --- 3. truncations, corruptions and what libwebp refuses


def _files() -> list:
    return [pillow_file(smooth(4, 40, 30), quality=70), pillow_file(smooth(5, 33, 21, 4), quality=60, exact=True),
            pillow_file(smooth(6, 27, 25), lossless=True), pillow_file(smooth(7, 30, 19, 4), lossless=True, exact=True),
            chip_smoke.webp_bytes("animation", 8, 24, 20), chip_smoke.webp_bytes("lossy_segments", 9, 35, 18)]


def test_truncations_raise_as_pillow_does():
    """A file cut short: the RIFF size then passes the file's end, which libwebp's demuxer refuses."""
    rng = np.random.default_rng(10)
    for data in _files():
        for cut in sorted(set(rng.integers(16, len(data), 12).tolist())):
            assert_same(data[:cut])
            with pytest.raises(ValueError, match=r"^f\.webp: "):
                webp.decode_twin(data[:cut], "f.webp")


def test_corruptions_decode_or_raise_as_pillow_does():
    """One or two bytes changed anywhere: the twin gives Pillow's pixels or raises where it raises."""
    rng = np.random.default_rng(11)
    for k, data in enumerate(_files() * 40):
        bad = bytearray(data)
        for at in rng.integers(0, len(bad), size=1 + k % 2):
            bad[at] = int(rng.integers(0, 256))
        if webp.accepts(bytes(bad)):
            assert_same(bytes(bad))


def _riff(*chunks: bytes) -> bytes:
    return chip_smoke.riff_webp(b"".join(chunks))


def _chunk(fourcc: bytes, payload: bytes) -> bytes:
    return chip_smoke.riff_chunk(fourcc, payload)


def _refused() -> dict:
    rng = np.random.default_rng(12)
    lossy = chip_smoke.vp8_bitstream(rng, 20, 12, q=40)
    lossless = chip_smoke.vp8l_bitstream(chip_smoke.webp_argb(rng, 20, 12), rng)
    alpha = chip_smoke.alph_chunk(rng.integers(0, 256, (12, 20), dtype=np.uint8), rng, 0, 1)
    good = _riff(_chunk(b"VP8 ", lossy))
    not_key = bytes([lossy[0] | 1]) + lossy[1:]
    no_show = bytes([lossy[0] & ~0x10]) + lossy[1:]
    version_1 = lossless[:4] + bytes([lossless[4] | 0x20]) + lossless[5:]
    last = (lossy[0] | lossy[1] << 8 | lossy[2] << 16) >> 5  # partition 0's length
    four = chip_smoke.vp8_bitstream(rng, 20, 12, q=40, partitions=2)
    sizes_at = 10 + ((four[0] | four[1] << 8 | four[2] << 16) >> 5)  # three partition sizes follow partition 0
    return {
        "riff_size_past_the_end": (good[:4] + (len(good) + 2).to_bytes(4, "little") + good[8:], r"truncated"),
        "riff_size_below_a_chunk": (good[:4] + (4).to_bytes(4, "little") + good[8:], r"RIFF size"),
        "chunk_past_the_riff": (_riff(_chunk(b"VP8 ", lossy))[:-4] + b"", r"truncated"),
        "trailing_bytes_in_the_riff": (_riff(_chunk(b"VP8 ", lossy), b"ab\0\0"), r"truncated chunk header"),
        "vp8x_canvas_is_not_the_image": (_riff(chip_smoke.vp8x_chunk(0, 21, 12), _chunk(b"VP8 ", lossy)),
                                         r"image 20 x 12 on a canvas of 21 x 12"),
        "vp8x_canvas_is_not_the_vp8l_image": (_riff(chip_smoke.vp8x_chunk(0, 20, 13), _chunk(b"VP8L", lossless)),
                                              r"image 20 x 12 on a canvas of 20 x 13"),
        "vp8x_reserved_flag": (_riff(chip_smoke.vp8x_chunk(0x01, 20, 12), _chunk(b"VP8 ", lossy)), r"VP8X flags"),
        "alph_before_vp8l": (_riff(chip_smoke.vp8x_chunk(0x10, 20, 12), alpha, _chunk(b"VP8L", lossless)),
                             r"ALPH before VP8L"),
        "alph_reserved_bits": (_riff(chip_smoke.vp8x_chunk(0x10, 20, 12),
                                     _chunk(b"ALPH", bytes([0xC0]) + bytes(240)), _chunk(b"VP8 ", lossy)),
                               r"ALPH header"),
        "alph_method_2": (_riff(chip_smoke.vp8x_chunk(0x10, 20, 12), _chunk(b"ALPH", bytes([2]) + bytes(240)),
                                _chunk(b"VP8 ", lossy)), r"ALPH header"),
        "alph_raw_too_short": (_riff(chip_smoke.vp8x_chunk(0x10, 20, 12), _chunk(b"ALPH", bytes(200)),
                                     _chunk(b"VP8 ", lossy)), r"shorter than the plane"),
        "vp8_not_a_key_frame": (_riff(_chunk(b"VP8 ", not_key)), r"header"),
        "vp8_not_shown": (_riff(_chunk(b"VP8 ", no_show)), r"header"),
        "vp8_start_code": (_riff(_chunk(b"VP8 ", lossy[:3] + b"\x9d\x01\x2b" + lossy[6:])), r"header"),
        "vp8_partition_0_past_the_data": (_riff(_chunk(b"VP8 ", lossy[: 10 + last - 3])), r"partition"),
        "vp8_partition_sizes_past_the_chunk": (_riff(_chunk(b"VP8 ", four[: sizes_at + 9])), r"partition"),
        "vp8l_version": (_riff(_chunk(b"VP8L", version_1)), r"header"),
        "anmf_before_anim": (_riff(chip_smoke.vp8x_chunk(0x02, 20, 12), _chunk(b"ANMF", bytes(16) + _chunk(b"VP8 ", lossy))),
                             r"ANMF before ANIM"),
        "frame_past_the_canvas": (_riff(chip_smoke.vp8x_chunk(0x02, 20, 12), _chunk(b"ANIM", bytes(6)),
                                        _chunk(b"ANMF", bytes([1]) + bytes(15) + _chunk(b"VP8 ", lossy))),
                                  r"past the canvas"),
        "no_image_in_vp8x": (_riff(chip_smoke.vp8x_chunk(0, 20, 12), _chunk(b"EXIF", b"abcd")), r"no frame"),
    }


@pytest.mark.parametrize("form", sorted(_refused()))
def test_refused_forms_raise_naming_the_file(form):
    """What libwebp refuses, the twin refuses with a ValueError naming the file and the reason."""
    data, pattern = _refused()[form]
    assert isinstance(pillow_rgb(data), Exception)
    with pytest.raises(ValueError, match=rf"^f\.webp: .*({pattern})"):
        webp.decode_twin(data, "f.webp")


def test_libwebp_rules():
    """What Pillow's reading shows, beyond the format's letter: the first frame on a zero canvas (black
    outside it; ANIM's background and the frame's blend / dispose bits unseen); alpha never in RGB; a broken
    ALPH chunk refused all the same; bytes past the RIFF end ignored; a file whose first chunk Pillow does
    not accept is `unknown` to `image_format`; Pillow's RGBA / RGBX modes alike; B_PRED's above-right
    pixels."""
    from PIL import Image

    rng = np.random.default_rng(13)
    frame = chip_smoke.vp8_bitstream(rng, 14, 10, q=30)

    def anim(background: int, bits: int) -> bytes:
        head = (3).to_bytes(3, "little") + (2).to_bytes(3, "little") + (13).to_bytes(3, "little")
        head += (9).to_bytes(3, "little") + (40).to_bytes(3, "little") + bytes([bits])
        return _riff(chip_smoke.vp8x_chunk(0x02, 30, 20), _chunk(b"ANIM", background.to_bytes(4, "little") + b"\0\0"),
                     _chunk(b"ANMF", head + _chunk(b"VP8 ", frame)))

    base = webp.decode_twin(anim(0, 0))
    assert not base[:4].any() and not base[:, :6].any() and base[4:14, 6:20].any()
    for background, bits in ((0xFF0A0AC8, 0), (0x12345678, 3), (0, 1), (0xFFFFFFFF, 2)):
        np.testing.assert_array_equal(webp.decode_twin(anim(background, bits)), base)
        assert_same(anim(background, bits))
    plain = _riff(_chunk(b"VP8 ", frame))
    for level in (255, 60, 0):
        plane = np.full((10, 14), level, np.uint8)
        for method in (0, 1):
            data = _riff(chip_smoke.vp8x_chunk(0x10, 14, 10), chip_smoke.alph_chunk(plane, rng, method, 2),
                         _chunk(b"VP8 ", frame))
            np.testing.assert_array_equal(webp.decode_twin(data), webp.decode_twin(plain))
            assert_same(data)
    broken = _riff(chip_smoke.vp8x_chunk(0x10, 14, 10), _chunk(b"ALPH", b"\x01\xff\xff\xff"), _chunk(b"VP8 ", frame))
    assert isinstance(pillow_rgb(broken), Exception) and isinstance(twin_rgb(broken), Exception)
    unflagged = _riff(chip_smoke.vp8x_chunk(0, 14, 10), _chunk(b"ALPH", b"\x01\xff\xff\xff"), _chunk(b"VP8 ", frame))
    assert_same(unflagged)  # without the alpha flag a still image's ALPH chunk is not read
    np.testing.assert_array_equal(webp.decode_twin(plain + b"trailing bytes"), webp.decode_twin(plain))
    assert_same(plain + b"trailing bytes")
    other = plain[:12] + b"VP9 " + plain[16:]
    assert not webp.accepts(other) and jpeg.image_format(other) == "unknown"
    assert jpeg.image_format(plain) == "webp"
    # a VP8L image whose header says alpha, all of it 255: Pillow opens RGBA (else RGBX); RGB is the same
    argb = chip_smoke.webp_argb(rng, 17, 9) | np.uint32(0xFF000000)
    for hint in (True, False):
        data = _riff(_chunk(b"VP8L", chip_smoke.vp8l_bitstream(argb, rng, alpha_hint=hint)))
        assert Image.open(io.BytesIO(data)).mode == ("RGBA" if hint else "RGB")
        assert_same(data)
    # B_PRED everywhere: above-right pixels from the macroblock above and to the right (the last column's
    # from the one above, the first row's 127), the same four for the right-hand sub-blocks of rows 1-3
    for seed in range(4):
        assert_same(_riff(_chunk(b"VP8 ", chip_smoke.vp8_bitstream(np.random.default_rng(seed), 40, 40, b_pred=1.0,
                                                                      density=0.3, level=0))))


def test_vp8l_streams_alone():
    """VP8L on its own: each transform (and colour indexing at 1-256 colours, packing 8 / 4 / 2 / 1 indices a
    byte), caches of 1-11 bits, meta-Huffman groups and copies give back the writer's ARGB exactly."""
    rng = np.random.default_rng(14)
    cases = [((), {}), (("predictor",), {"predictor_bits": 2}), (("cross",), {"cross_bits": 3}),
             (("subtract_green",), {}), (("subtract_green", "predictor", "cross"), {"predictor_bits": 4}),
             ((), {"cache_bits": 1}), ((), {"cache_bits": 11, "meta_bits": 2, "groups": 4}),
             (("predictor",), {"cache_bits": 5, "meta_bits": 3, "groups": 2, "copies": 0.8})]
    for colours in (1, 2, 3, 4, 9, 16, 17, 256):
        cases.append((("palette",), {"colours": colours}))
    for transforms, kw in cases:
        w, h = int(rng.integers(1, 40)), int(rng.integers(1, 30))
        colours = kw.pop("colours", 0)
        argb = chip_smoke.webp_argb(rng, w, h, colours)
        if colours:
            kw["palette"] = np.unique(argb)
        stream = chip_smoke.vp8l_bitstream(argb, rng, transforms=transforms, **kw)
        assert vp8l.header(stream)[:2] == (w, h)
        rgba = vp8l.decode(stream)
        want = np.stack([(argb >> 16) & 255, (argb >> 8) & 255, argb & 255, argb >> 24], axis=2)
        np.testing.assert_array_equal(rgba, want.astype(np.uint8), err_msg=str((transforms, kw)))
    with pytest.raises(ValueError, match="VP8L"):
        vp8l.decode(stream[:6])


@pytest.mark.parametrize("filt", [0, 1, 2, 3])
def test_alpha_planes_alone(filt):
    """The ALPH chunk's filters undone (the first row horizontal from 0, a later row's first pixel from
    above), raw and VP8L-coded (through colour indexing alone, libwebp's 8-bit path, or not), and the plane
    Pillow hands back as the A channel."""
    from PIL import Image

    rng = np.random.default_rng(15 + filt)
    plane = chip_smoke.webp_argb(rng, 23, 17).astype(np.uint8)
    for method, transforms in ((0, ()), (1, ("palette",)), (1, ("predictor", "subtract_green"))):
        chunk = chip_smoke.alph_chunk(plane, rng, method, filt, transforms=transforms) if method else \
            chip_smoke.alph_chunk(plane, rng, 0, filt)
        payload = chunk[8 : 8 + int.from_bytes(chunk[4:8], "little")]
        np.testing.assert_array_equal(webp.decode_alpha(payload, 23, 17), plane)
        data = _riff(chip_smoke.vp8x_chunk(0x10, 23, 17), chunk,
                     _chunk(b"VP8 ", chip_smoke.vp8_bitstream(rng, 23, 17, q=50)))
        assert_same(data)
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data)).getchannel("A")), plane)
    filtered = np.random.default_rng(filt).integers(0, 256, (5, 7), dtype=np.uint8)
    out = webp.unfilter_alpha(filtered, filt)
    if filt == 0:
        np.testing.assert_array_equal(out, filtered)
    else:
        np.testing.assert_array_equal(out[0], np.cumsum(filtered[0], dtype=np.uint8))


def test_vp8_header_quirks():
    """`vp8.info` as VP8GetInfo reads the frame tag and size (scale bits ignored); a first partition
    longer than the data and an empty last partition are refused."""
    rng = np.random.default_rng(16)
    frame = chip_smoke.vp8_bitstream(rng, 33, 18, partitions=2)
    assert vp8.info(frame, len(frame)) == (33, 18)
    scaled = frame[:7] + bytes([frame[7] | 0xC0]) + frame[8:9] + bytes([frame[9] | 0x40]) + frame[10:]
    assert vp8.info(scaled, len(scaled)) == (33, 18)
    y, u, v = vp8.decode(frame)
    assert y.shape == (18, 33) and u.shape == v.shape == (9, 17)
    assert vp8.info(frame, (frame[0] | frame[1] << 8 | frame[2] << 16) >> 5) is None
    with pytest.raises(ValueError, match="VP8"):
        vp8.decode(frame[:12])


# --- the data path


def test_read_image_decodes_webp_by_signature(tmp_path):
    data = chip_smoke.webp_bytes("alpha_lossless", 17, 21, 13)
    (tmp_path / "a.png").write_bytes(data)
    np.testing.assert_array_equal(jpeg.read_image(str(tmp_path / "a.png"), "cpu"), pillow_rgb(data))


def test_dataset_items_from_webp_files_equal_jax(tmp_path):
    """The port's MBEIRCandidatePoolDataset item for a `.webp` img_path equals the JAX package's (fp32)."""
    from tests.helpers import identity_image_transform
    from tests.torch_helpers import on_array
    from uniir_tpu.data import dataset as jax_dataset
    from uniir_tpu_torch.data import dataset

    os.makedirs(tmp_path / "images")
    files = {"lossy": pillow_file(smooth(18, 40, 24), quality=80),
             "lossless_alpha": chip_smoke.webp_bytes("lossless", 19, 0, 0, image=smooth(19, 33, 30, 4)),
             "animation": chip_smoke.webp_bytes("animation", 20, 29, 22)}
    with open(tmp_path / "cand_pool.jsonl", "w") as f:
        for i, (name, data) in enumerate(files.items()):
            (tmp_path / "images" / f"{name}.webp").write_bytes(data)
            f.write(json.dumps({"did": f"9:{i}", "modality": "image", "img_path": f"images/{name}.webp"}) + "\n")
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
    assert webp.decoder_for("cpu") is webp.decode_twin
    assert webp.decoder_for(torch.device("cuda", 0)) is webp.decode_native


# --- the native decoder (csrc/webp.cu, built by nvcc on the card's machine)


@pytest.fixture
def native():
    if not torch.cuda.is_available():
        pytest.skip("needs the card's machine: csrc/webp.cu is built by nvcc, which is installed there")
    return webp.decode_native


@pytest.mark.gpu
@pytest.mark.parametrize("form", chip_smoke.WEBP_CASE_FORMS)
def test_native_is_bit_equal_to_twin(native, form):
    rng = np.random.default_rng(len(form) + 1)
    for k in range(6):
        data = chip_smoke.webp_bytes(form, 700 + k, int(rng.integers(1, 200)), int(rng.integers(1, 200)))
        before = webp.decode_native.calls
        out = native(data)
        assert webp.decode_native.calls == before + 1
        np.testing.assert_array_equal(out, webp.decode_twin(data))


@pytest.mark.gpu
def test_native_on_pillow_files_in_threads_and_refusals(native):
    """Pillow's digests, the loader's threads at once, and the twin's refusals and corruptions."""
    for name, (b64, digest, w, h) in chip_smoke.WEBP_PILLOW_FILES.items():
        assert hashlib.sha256(native(base64.b64decode(b64)).tobytes()).hexdigest() == digest, name
    files = [chip_smoke.webp_bytes(chip_smoke.WEBP_CASE_FORMS[i % 11], 800 + i, 30 + i, 20 + 2 * i) for i in range(11)]
    with ThreadPoolExecutor(8) as pool:
        outs = list(pool.map(native, files * 3))
    for i, out in enumerate(outs):
        np.testing.assert_array_equal(out, webp.decode_twin(files[i % len(files)]))
    for form, (data, pattern) in _refused().items():
        with pytest.raises(ValueError, match=rf"^f\.webp: .*({pattern})"):
            native(data, "f.webp")
    rng = np.random.default_rng(21)
    for k, data in enumerate(files * 4):
        bad = bytearray(data)
        for at in rng.integers(0, len(bad), size=1 + k % 2):
            bad[at] = int(rng.integers(0, 256))
        if not webp.accepts(bytes(bad)):
            continue
        try:
            want = webp.decode_twin(bytes(bad), "f.webp")
        except ValueError:
            with pytest.raises(ValueError, match=r"^f\.webp: "):
                native(bytes(bad), "f.webp")
            continue
        np.testing.assert_array_equal(native(bytes(bad), "f.webp"), want)
