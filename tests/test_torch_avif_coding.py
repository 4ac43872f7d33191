"""The AV1 coding tools Pillow 12.1's AVIF save brings in, each file held to Pillow's pixels bit for bit.

Which tools a save uses is read from its headers (av1_obu): aom's all-intra mode writes 64 x 64 superblocks,
the deblocking filter, transform-size selection, filter intra and every intra predictor at speeds 1-10,
128 x 128 superblocks at speed 0, and uniform tiles on request; lossless frames code the Walsh-Hadamard
transform.  Loop restoration (speeds 0-4) and a sequence's CDEF are in tests/test_torch_avif_restoration.py.
Each case asserts the tool is in its file's headers, so a change in the encoder's choices fails here rather
than leaving a tool untested.
"""

import pytest

import avif_files as files
from tests.test_torch_avif import assert_pillow
from uniir_tpu_torch.data import av1_obu, avif


def headers(data: bytes):
    info = avif.parse(data)
    seq, hdr, _ = av1_obu.parse(info.payload, "f")
    return seq, hdr


@pytest.mark.parametrize("speed", range(11))
@pytest.mark.parametrize("quality", (10, 50, 80))
def test_speeds_and_qualities(speed, quality):
    data = files.pillow_file("RGB", 72, 88, seed=speed * 7 + quality, speed=speed, quality=quality)
    seq, hdr = headers(data)
    assert seq.sb128 == (speed == 0)
    assert_pillow(data, f"speed {speed} quality {quality}")


@pytest.mark.parametrize("rows,cols", [(1, 0), (0, 1), (1, 1), (2, 2)])
def test_tiles(rows, cols):
    data = files.pillow_file("RGB", 260, 270, seed=rows * 3 + cols, tile_rows=rows, tile_cols=cols, speed=8)
    _, hdr = headers(data)
    assert (hdr.tile_rows > 1, hdr.tile_cols > 1) == (rows > 0, cols > 0)
    assert_pillow(data, f"tiles {rows} {cols}")


def test_autotiling():
    data = files.pillow_file("RGB", 130, 200, seed=3, autotiling=True, speed=9)
    assert_pillow(data, "autotiling")


@pytest.mark.parametrize("size", [(8, 8), (31, 45), (64, 64), (70, 130)])
@pytest.mark.parametrize("subsampling", ("4:2:0", "4:4:4"))
def test_lossless(size, subsampling):
    data = files.pillow_file("RGB", *size, seed=size[0], quality=100, subsampling=subsampling)
    _, hdr = headers(data)
    assert hdr.coded_lossless
    assert_pillow(data, f"lossless {size} {subsampling}")
