"""The JPEG encoders (`uniir_tpu_torch.data.jpeg_encode`): the twin's bytes
equal to Pillow 12.1's `Image.fromarray(rgb).save(buf, "JPEG")` at its
defaults, with and without a comment, over sizes 1-600 px and every residue
of the width and height mod 16 (the MCU's edges: the right and bottom
padding, the dummy luma blocks), flat, noisy and smooth images; the file
read back by the port's decoder as Pillow reads it; and (`-m gpu`, on the
card's machine, where nvcc builds csrc/jpeg_encode.cu) the native encoder
bit-equal to the twin.

The module imports no JAX and no Pillow at its top, so its `-m gpu` cases
collect with `--noconftest` on a machine that has neither."""

import io
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from uniir_tpu_torch.data import jpeg, jpeg_encode

KINDS = ("flat", "noise", "smooth", "binary")


def image(kind: str, seed: int, w: int, h: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "flat":
        return np.broadcast_to(rng.integers(0, 256, 3, dtype=np.uint8), (h, w, 3)).copy()
    if kind == "noise":
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if kind == "binary":  # the extremes: the largest coefficients, 0xFF bytes to stuff
        return (rng.integers(0, 2, (h, w, 3)) * 255).astype(np.uint8)
    walk = np.cumsum(rng.integers(-6, 7, (h, w, 3)), axis=1) + np.cumsum(rng.integers(-6, 7, (h, 1, 3)), axis=0)
    return np.clip(walk + 128, 0, 255).astype(np.uint8)


def pillow_bytes(rgb: np.ndarray, comment=None) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "JPEG", **({} if comment is None else {"comment": comment}))
    return buf.getvalue()


def pillow_rgb(data: bytes) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


@settings(max_examples=40, deadline=None)
@given(blocks=st.tuples(st.integers(0, 37), st.integers(0, 37)), residue=st.tuples(st.integers(0, 15), st.integers(0, 15)),
       kind=st.sampled_from(KINDS), seed=st.integers(0, 2**16),
       comment=st.sampled_from([None, b"", b"a comment", "caf\xe9 ☃", b"\xff\xd9\x00"]))
def test_twin_is_pillows_bytes(blocks, residue, kind, seed, comment):
    w = max(1, min(600, 16 * blocks[0] + residue[0]))
    h = max(1, min(600, 16 * blocks[1] + residue[1]))
    rgb = image(kind, seed, w, h)
    assert jpeg_encode.encode_twin(rgb, comment) == pillow_bytes(rgb, comment)


@pytest.mark.parametrize("rw", range(16))
def test_every_residue_mod_16(rw):
    """Width 16 + rw against every height residue 16 + rh, and at one and two MCUs less a pixel."""
    for rh in range(16):
        for kind in ("noise", "smooth"):
            rgb = image(kind, 16 * rw + rh, 16 + rw, 16 + rh)
            assert jpeg_encode.encode_twin(rgb) == pillow_bytes(rgb), (rw, rh, kind)
    for w, h in ((rw + 1, 15), (31, rw + 1), (rw + 1, 1)):
        rgb = image("noise", rw, w, h)
        assert jpeg_encode.encode_twin(rgb) == pillow_bytes(rgb), (w, h)


@pytest.mark.parametrize("kind", KINDS)
def test_round_trip_through_the_ports_decoder(kind):
    """The file decodes in the port as in Pillow; a flat image and a ramp come back close to the source."""
    rgb = image(kind, 7, 203, 117)
    data = jpeg_encode.encode_twin(rgb, b"x")
    back = jpeg.decode_twin(data)
    np.testing.assert_array_equal(back, pillow_rgb(data))
    assert jpeg.open_header(data)[:3] == (203, 117, b"x")
    if kind == "flat":
        assert np.abs(back.astype(np.int64) - rgb).max() <= 3
    ramp = np.stack([*np.meshgrid(np.arange(203), np.arange(117)), np.full((117, 203), 90)], axis=2)
    ramp = ramp.astype(np.uint8)
    err = np.abs(jpeg.decode_twin(jpeg_encode.encode_twin(ramp)).astype(np.int64) - ramp).mean()
    assert err < 2.0, err


def test_the_layout_pillow_writes():
    """SOI, APP0 JFIF 1.01 1:1, COM, DQT x 2, SOF0 4:2:0, DHT DC0 AC0 DC1 AC1, SOS, data, EOI."""
    data = jpeg_encode.encode_twin(image("noise", 1, 40, 24), b"hello")
    markers, pos = [], 2
    while True:
        marker, length = data[pos + 1], int.from_bytes(data[pos + 2 : pos + 4], "big")
        markers.append((marker, data[pos + 4 : pos + 2 + length]))
        if marker == 0xDA:
            break
        pos += 2 + length
    assert [m for m, _ in markers] == [0xE0, 0xFE, 0xDB, 0xDB, 0xC0, 0xC4, 0xC4, 0xC4, 0xC4, 0xDA]
    assert markers[0][1] == b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00" and markers[1][1] == b"hello"
    assert markers[4][1] == bytes([8, 0, 24, 0, 40, 3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])
    assert [p[0] for m, p in markers if m == 0xC4] == [0x00, 0x10, 0x01, 0x11]
    assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"


def test_refusals():
    for bad in (np.zeros((4, 4), np.uint8), np.zeros((4, 4, 3), np.int32), np.zeros((0, 4, 3), np.uint8),
                np.zeros((4, 4, 4), np.uint8)):
        with pytest.raises(ValueError):
            jpeg_encode.encode_twin(bad)


@pytest.mark.parametrize("width", [2, 16384, 16385, 16390])
def test_the_longest_comment_pillow_writes(width):
    """SOI, APP0 and the COM segment must leave a byte of Pillow's max(65536, 4 W) buffer: one byte more and
    its save fails, as the twin's does."""
    from PIL import Image

    rgb = np.zeros((1, width, 3), np.uint8)
    longest = min(65533, max(65536, 4 * width) - 25)
    assert jpeg_encode.encode_twin(rgb, b"x" * longest) == pillow_bytes(rgb, b"x" * longest)
    if longest < 65533:
        with pytest.raises(ValueError, match="buffer"):
            jpeg_encode.encode_twin(rgb, b"x" * (longest + 1))
        with pytest.raises(OSError):
            Image.fromarray(rgb).save(io.BytesIO(), "JPEG", comment=b"x" * (longest + 1))


def test_encoder_for_picks_by_device():
    assert jpeg_encode.encoder_for("cpu") is jpeg_encode.encode_twin
    assert jpeg_encode.encoder_for(torch.device("cuda", 0)) is jpeg_encode.encode_native
    assert jpeg_encode.encoder_for("cuda:1") is jpeg_encode.encode_native


@pytest.fixture(scope="module")
def native():
    if not torch.cuda.is_available():
        pytest.skip("needs the card's machine: csrc/jpeg_encode.cu is built by nvcc, which is installed there")
    return jpeg_encode.encode_native


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
def test_native_is_bit_equal_to_twin(native, kind):
    rng = np.random.default_rng(len(kind))
    for k in range(24):
        w, h = int(rng.integers(1, 600)), int(rng.integers(1, 600))
        rgb = image(kind, k, w, h)
        comment = (None, b"c", "\xe9")[k % 3]
        before = jpeg_encode.encode_native.calls
        assert native(rgb, comment) == jpeg_encode.encode_twin(rgb, comment), (w, h)
        assert jpeg_encode.encode_native.calls == before + 1


@pytest.mark.gpu
def test_native_in_threads(native):
    images = [image(KINDS[k % 4], k, 37 + 29 * k, 301 - 13 * k) for k in range(12)]
    with ThreadPoolExecutor(8) as pool:
        outs = list(pool.map(native, images * 3))
    for k, out in enumerate(outs):
        assert out == jpeg_encode.encode_twin(images[k % len(images)])
