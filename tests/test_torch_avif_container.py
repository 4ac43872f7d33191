"""The AVIF container as libavif 1.3.0 reads it inside Pillow 12.1, the forms the port refuses by name, and
damaged files: each case has Pillow's outcome (its pixels, or a failure) and the port's.

  * container forms Pillow's save does not write, made by box surgery on its files (tests/avif_files.py):
    items in `idat`, the nclx matrices (those libyuv converts decode; those libavif converts in floating
    point are refused by name; those it cannot convert fail), a missing `pixi` or `colr`, transformative
    properties (`clap`, `irot`, `imir`) essential or not, an unknown essential property, pixi depths;
  * the forms no Pillow-written natural image uses, refused with UnsupportedImageFormat naming them
    (ROADMAP Queue 3): 10-bit samples, superres, film grain, screen content tools, quantizer matrices,
    non-key first frames, grid items, an item whose size differs from its AV1 frame;
  * cuts and byte flips: the same outcome as Pillow.  A flip that drives a transform past the conformance
    ranges (a non-conformant stream) is held to Pillow's outcome only: there dav1d clamps at its own stages.
"""

import struct

import numpy as np
import pytest

import avif_files as files
from tests.test_torch_avif import assert_pillow
from uniir_tpu_torch.data import av1_obu, av1_recon, avif, jpeg


def outcome(data: bytes) -> str:
    """Pillow's and the port's outcome on `data`, as one word: "equal", "both fail", "refused" (Pillow
    decodes, the port names the form), or what differs."""
    want = files.pillow_rgb(data)
    clamped = av1_recon.inverse_transform.clamped
    try:
        got = jpeg.decode_image(data, "f", "cpu")
    except ValueError as e:
        got = e
    if isinstance(want, Exception):
        return "both fail" if isinstance(got, Exception) and not isinstance(got, jpeg.UnsupportedImageFormat) \
            else f"port {'refuses' if isinstance(got, Exception) else 'decodes'} what Pillow fails on"
    if isinstance(got, jpeg.UnsupportedImageFormat):
        return "refused"
    if isinstance(got, Exception):
        return f"port fails ({got}) where Pillow decodes"
    if got.shape == want.shape and (got == want).all():
        return "equal"
    return "non-conformant" if av1_recon.inverse_transform.clamped > clamped else "pixels differ"


def test_items_in_idat():
    for mode, options in (("RGB", {}), ("RGBA", {"alpha_premultiplied": True})):
        data = files.to_idat(files.pillow_file(mode, 30, 41, seed=1, **options))
        assert b"idat" in data and b"mdat" not in data
        assert_pillow(data, mode)


@pytest.mark.parametrize("full", (True, False))
@pytest.mark.parametrize("matrix", range(17))
def test_nclx_matrices(matrix, full):
    """libyuv's matrices (BT.709, unspecified, BT.470BG, BT.601, BT.2020 NCL) decode in both ranges; the
    ones libavif converts in floating point (FCC, SMPTE 240M, YCgCo, chroma-derived NCL, YCgCo-Re) are refused
    by name; the rest fail as libavif fails.  Identity needs 4:4:4 (and full range, refused otherwise)."""
    data = files.set_colr(files.pillow_file("RGB", 30, 41, seed=1), matrix=matrix, full=full)
    expect = {1: "equal", 2: "equal", 5: "equal", 6: "equal", 9: "equal", 4: "refused", 7: "refused",
              12: "refused", 15: "refused", 8: "refused" if full else "both fail"}.get(matrix, "both fail")
    assert outcome(data) == expect
    if matrix == 0:
        identity = files.set_colr(files.pillow_file("RGB", 30, 41, seed=1, subsampling="4:4:4"), matrix=0, full=full)
        assert outcome(identity) == ("equal" if full else "refused")


def test_optional_and_mandatory_properties():
    data = files.pillow_file("RGB", 30, 41, seed=1)
    assert outcome(files.drop_property(data, b"pixi")) == "equal"
    assert outcome(files.drop_property(data, b"colr")) == "equal"  # the sequence header's colour then
    for kind in (b"ispe", b"av1C"):
        assert outcome(files.drop_property(data, kind)) == "both fail"


@pytest.mark.parametrize("kind", (b"clap", b"irot", b"imir"))
def test_transformative_properties_move_no_pixel_and_must_be_essential(kind):
    data = files.pillow_file("RGB", 30, 41, seed=1)
    body = struct.pack(">8I", 20, 1, 16, 1, 0, 1, 0, 1) if kind == b"clap" else b"\x01"
    assert outcome(files.add_property(data, kind, body, essential=True)) == "equal"
    assert outcome(files.add_property(data, kind, body, essential=False)) == "both fail"


def test_unknown_properties():
    data = files.pillow_file("RGB", 30, 41, seed=1)
    assert outcome(files.add_property(data, b"zzzz", b"\x01\x02", essential=False)) == "equal"
    assert outcome(files.add_property(data, b"zzzz", b"\x01\x02", essential=True)) == "both fail"


@pytest.mark.parametrize("depths,expect", [(b"\x01\x08", "equal"), (b"\x02\x08\x08", "equal"),
                                           (b"\x03\x08\x08\x0a", "both fail"), (b"\x00", "both fail")])
def test_pixi_depths(depths, expect):
    data = files.pillow_file("RGB", 30, 41, seed=1)
    old = b"pixi\x00\x00\x00\x00\x03\x08\x08\x08"
    assert outcome(data.replace(old, b"pixi\x00\x00\x00\x00" + depths.ljust(4, b"\x08"))) == expect


def test_item_size_other_than_its_frame_is_refused():
    data = bytearray(files.pillow_file("RGB", 30, 41, seed=1))
    at = bytes(data).find(b"ispe") + 8
    data[at : at + 4] = struct.pack(">I", 40)
    assert outcome(bytes(data)) == "refused"
    with pytest.raises(jpeg.UnsupportedImageFormat, match="item of 40 x 30 holding a 41 x 30 AV1 frame"):
        jpeg.decode_image(bytes(data), "f", "cpu")


def test_grid_item_is_refused_by_name():
    data = files.pillow_file("RGB", 30, 41, seed=1).replace(b"av01Color", b"gridColor")
    with pytest.raises(jpeg.UnsupportedImageFormat, match="AVIF grid image"):
        jpeg.decode_image(data, "f", "cpu")


# ---- AV1 forms refused by name, in synthetic headers -----------------------------------------------------------

class BitWriter:
    def __init__(self):
        self.bits = []

    def f(self, n: int, v: int):
        self.bits += [(v >> (n - 1 - i)) & 1 for i in range(n)]
        return self

    def trailing(self):
        self.bits.append(1)
        while len(self.bits) % 8:
            self.bits.append(0)
        return self

    def bytes(self) -> bytes:
        return bytes(int("".join(map(str, self.bits[i : i + 8])), 2) for i in range(0, len(self.bits), 8))


def obu(kind: int, payload: bytes) -> bytes:
    return bytes([kind << 3 | 2, len(payload)]) + payload


def still_sequence(high_bitdepth=0, superres=0, film_grain=0) -> bytes:
    """A reduced still-picture sequence header of a 16 x 16 4:2:0 frame."""
    w = BitWriter().f(3, 0).f(1, 1).f(1, 1).f(5, 0).f(4, 5).f(4, 5).f(6, 15).f(6, 15)
    w.f(1, 0).f(1, 0).f(1, 0).f(1, superres).f(1, 0).f(1, 0)  # sb128, filter intra, edge filter, superres, cdef, lr
    w.f(1, high_bitdepth).f(1, 0).f(1, 0).f(1, 1).f(2, 0).f(1, 0).f(1, film_grain)
    return obu(av1_obu.OBU_SEQUENCE_HEADER, w.trailing().bytes())


def still_frame(superres=0, screen_content=0, qmatrix=0, film_grain=0) -> bytes:
    """A key frame's uncompressed header for still_sequence, then a tile of zero bytes."""
    w = BitWriter().f(1, 0).f(1, screen_content)
    if screen_content:
        w.f(1, 0)  # force_integer_mv
    if superres is not None:
        w.f(1, superres)
        if superres:
            w.f(3, 0)
    w.f(1, 0)  # render_and_frame_size_different
    if screen_content:
        w.f(1, 0)  # allow_intrabc
    w.f(1, 1).f(8, 100).f(1, 0).f(1, 0).f(1, 0).f(1, qmatrix)  # uniform tiles, base_q_idx, delta q's, qm
    if qmatrix:
        w.f(4, 0).f(4, 0)
    w.f(1, 0).f(1, 0).f(6, 0).f(6, 0).f(3, 0).f(1, 0).f(1, 0).f(1, 0)  # seg, delta q, lf, tx mode, reduced set
    if film_grain:
        w.f(1, 1)
    while len(w.bits) % 8:
        w.bits.append(0)
    return obu(av1_obu.OBU_FRAME, w.bytes() + bytes(8))


@pytest.mark.parametrize("form,sequence,frame", [
    ("10-bit samples", {"high_bitdepth": 1}, {"superres": None}),
    ("superres frame", {"superres": 1}, {"superres": 1}),
    ("film grain frame", {"film_grain": 1}, {"superres": None, "film_grain": 1}),
    ("screen content tools \\(palette\\) frame", {}, {"superres": None, "screen_content": 1}),
    ("quantizer matrix frame", {}, {"superres": None, "qmatrix": 1}),
])
def test_av1_forms_refused_by_name(form, sequence, frame):
    payload = still_sequence(**sequence) + still_frame(**frame)
    with pytest.raises(jpeg.UnsupportedImageFormat, match=f"AVIF {form} is not decoded"):
        avif.decode_yuv(payload, "f")
    assert isinstance(av1_obu.parse(still_sequence() + still_frame(superres=None), "f")[0].bit_depth, int)


def test_non_key_first_frames_refused_by_name():
    """A full sequence header (not reduced) whose first frame is an inter frame, or shows an existing one."""
    w = BitWriter().f(3, 0).f(1, 0).f(1, 0).f(1, 0).f(1, 0).f(5, 0).f(12, 0).f(5, 0)  # one operating point
    w.f(4, 5).f(4, 5).f(6, 15).f(6, 15).f(1, 0).f(1, 0).f(1, 0).f(1, 0)  # sizes, frame ids, sb128, fi, edge
    w.f(4, 0).f(1, 0).f(1, 1).f(1, 1)  # inter tools, order hint, screen content and integer mv chosen per frame
    w.f(1, 0).f(1, 0).f(1, 0)  # superres, CDEF, restoration
    w.f(1, 0).f(1, 0).f(1, 0).f(1, 1).f(2, 0).f(1, 0).f(1, 0)  # 8-bit 4:2:0 full range, no film grain
    sequence = obu(av1_obu.OBU_SEQUENCE_HEADER, w.trailing().bytes())
    for frame, form in ((BitWriter().f(1, 0).f(2, av1_obu.INTER_FRAME).f(1, 1), "inter first frame"),
                        (BitWriter().f(1, 1).f(3, 0), "show_existing_frame first frame")):
        payload = sequence + obu(av1_obu.OBU_FRAME_HEADER, frame.trailing().bytes())
        with pytest.raises(jpeg.UnsupportedImageFormat, match=form):
            av1_obu.parse(payload, "f")


# ---- damage --------------------------------------------------------------------------------------------------

@pytest.mark.parametrize("mode,options", [("RGB", {}), ("RGBA", {"alpha_premultiplied": True}),
                                          ("RGB", {"frames": 1}), ("RGB", {"quality": 100})])
def test_cuts_fail_as_pillow_fails(mode, options):
    data = files.pillow_file(mode, 24, 40, seed=5, **options)
    for at in np.linspace(8, len(data) - 1, 13).astype(int):
        assert outcome(data[:at]) == "both fail", at


def test_byte_flips_have_pillows_outcome():
    """Every third byte of a default file flipped three ways: Pillow's outcome each time (a flip in the AV1
    data may make a form the port refuses by name, or a non-conformant stream)."""
    data = files.pillow_file("RGB", 40, 56, seed=3)
    seen = set()
    for at in range(0, len(data), 3):
        for x in (0x01, 0x80, 0xFF):
            flipped = bytearray(data)
            flipped[at] ^= x
            got = outcome(bytes(flipped))
            seen.add(got)
            assert got in ("equal", "both fail", "refused", "non-conformant"), (at, x, got)
    assert {"equal", "both fail"} <= seen
