"""Loop restoration and CDEF in Pillow 12.1's AVIF files, each file held to Pillow's pixels bit for bit.

aom's all-intra mode restores at speeds 0-4 (Wiener, self-guided and switchable frames, units of 64-256 on each
plane's grid, read per superblock, filtered per 64-row stripe with the stripe's edge rows); a sequence (save_all)
is coded in aom's good-quality mode, whose key frame adds CDEF, so restoration reads the deblocked rows across
stripe edges and CDEF's output inside them.  Each case asserts its tool is in the file's headers.
"""

import pytest

import avif_files as files
from tests.test_torch_avif import assert_pillow
from tests.test_torch_avif_coding import headers
from uniir_tpu_torch.data import av1_obu


@pytest.mark.parametrize("subsampling", ("4:2:0", "4:2:2", "4:4:4", "4:0:0"))
@pytest.mark.parametrize("speed", (0, 4))
@pytest.mark.parametrize("quality", (45, 75))
def test_loop_restoration(subsampling, speed, quality):
    """Speeds 0-4 restore: Wiener and self-guided units on each plane's grid, across stripe edges."""
    data = files.pillow_file("RGB", 100, 140, seed=speed, speed=speed, quality=quality, subsampling=subsampling)
    seq, hdr = headers(data)
    assert_pillow(data, f"{subsampling} speed {speed} lr {hdr.lr_type}")


# (height, width, seed, speed, quality, subsampling) -> the frame's restoration types on its planes
LR_FILES = {(200, 300, 0, 0, 75, "4:2:0"): [av1_obu.RESTORE_SWITCHABLE, av1_obu.RESTORE_WIENER, av1_obu.RESTORE_WIENER],
            (120, 160, 2, 0, 75, "4:2:0"): [av1_obu.RESTORE_SGRPROJ, av1_obu.RESTORE_WIENER, av1_obu.RESTORE_WIENER],
            (120, 160, 7, 0, 75, "4:4:4"): [av1_obu.RESTORE_NONE, av1_obu.RESTORE_SGRPROJ, av1_obu.RESTORE_WIENER]}


@pytest.mark.parametrize("case", sorted(LR_FILES))
def test_loop_restoration_kinds(case):
    """Switchable, self-guided and Wiener frames, each file's types asserted from its header."""
    h, w, seed, speed, quality, subsampling = case
    data = files.pillow_file("RGB", h, w, seed=seed, speed=speed, quality=quality, subsampling=subsampling)
    _, hdr = headers(data)
    assert hdr.lr_type == LR_FILES[case]
    assert_pillow(data, f"{case}")


@pytest.mark.parametrize("speed", (0, 3, 6, 9))
@pytest.mark.parametrize("mode", ("RGB", "RGBA"))
def test_sequences_first_frame_with_cdef(speed, mode):
    """save_all writes an `avis` file: libavif's AUTO source reads the colour track's first sample, a key
    frame of aom's good-quality mode, with CDEF."""
    data = files.pillow_file(mode, 56, 72, seed=speed, frames=2, speed=speed, quality=40)
    assert data[8:12] == b"avis"
    seq, hdr = headers(data)
    assert hdr.enable_cdef and not seq.reduced
    assert_pillow(data, f"sequence {mode} speed {speed}")
