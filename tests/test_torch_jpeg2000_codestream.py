"""JPEG 2000 codestream forms Pillow's save does not write, decoded by the port as Pillow 12.1 decodes them.

The files come from the libopenjp2 Pillow ships, called through ctypes (tests/openjpeg_ctypes.py, whose
opj_cparameters_t layout is checked against the defaults opj_set_default_encoder_parameters writes): each
code-block style bit and all of them, SOP / EPH, tile-parts, POC, RGN, subsampled components at even and
odd origins, precisions 1 to 16, signed samples; and rewrites of such files: packet headers moved into PPT
or PPM, TLM / PLM / CRG / COM inserted.  The twin's int32 components are held to `opj_decode`'s on the same
files, stage by stage: one resolution (tier 1 and dequantisation), several (each DWT level), with the
component transform, and then Pillow's pixels through its unpacker.
"""

import numpy as np
import pytest

import jpeg2000_files as files
import openjpeg_ctypes as opj
from uniir_tpu_torch.data import jpeg, jpeg2000

STYLES = {"none": 0, "bypass": opj.BYPASS, "reset": opj.RESET, "termall": opj.TERMALL, "vsc": opj.VSC,
          "pterm": opj.PTERM, "segsym": opj.SEGSYM, "bypass_termall": opj.BYPASS | opj.TERMALL,
          "bypass_reset_vsc": opj.BYPASS | opj.RESET | opj.VSC, "all": 63}


def assert_pillow(data: bytes, what: str = "") -> None:
    want = files.pillow_rgb(data)
    if isinstance(want, Exception):
        with pytest.raises(ValueError):
            jpeg2000.decode_twin(data, what)
        return
    np.testing.assert_array_equal(jpeg2000.decode_twin(data, what), want, err_msg=what)


def assert_components(data: bytes, what: str = "") -> None:
    """The twin's samples per component equal opj_decode's (a single-tile codestream)."""
    ref = opj.decode_components(data)
    assert ref is not None, what
    (tile, comps), = jpeg2000.decode_components(data, what)
    assert len(comps) == len(ref[1]), what
    for c, (mine, theirs) in enumerate(zip(comps, ref[1])):
        np.testing.assert_array_equal(mine, theirs["data"], err_msg=f"{what} component {c}")


def test_encoder_parameter_layout():
    opj.check_layout()


@pytest.mark.parametrize("style", sorted(STYLES))
@pytest.mark.parametrize("irreversible", [0, 1])
def test_code_block_styles(style, irreversible):
    for n, prec in ((1, 8), (3, 8), (1, 12)):
        data = files.opj_file(n, 21, 19, prec, seed=n + prec, mode=STYLES[style], irreversible=irreversible,
                              tcp_mct=int(n == 3 and irreversible), rates=[12, 3, 0] if irreversible else [10, 0])
        assert_pillow(data, f"{style} {n}x{prec}")
        assert_components(data, f"{style} {n}x{prec}")


@pytest.mark.parametrize("prec", [1, 2, 4, 6, 8, 10, 12, 14, 16])
def test_precisions(prec):
    """Each precision, grey (16 bits opens as I;16, clipped to 255) and three components, unsigned and
    signed, in both wavelets: Pillow's shifts to 8 bits with their rounding offset and wrap."""
    for n in (1, 3):
        for signed in (False, True):
            for irreversible in (0, 1):
                data = files.opj_file(n, 17, 15, prec, seed=prec * 7 + n, signed=signed, irreversible=irreversible)
                assert_pillow(data, f"{n} x {prec} signed {signed} irreversible {irreversible}")
                assert_components(data, f"{n} x {prec} signed {signed}")


@pytest.mark.parametrize("levels", [1, 2, 3, 5])
def test_components_stage_by_stage(levels):
    """One resolution holds tier 1 and dequantisation alone; more add DWT levels; three components add
    the RCT / ICT."""
    for n, irreversible in ((1, 0), (1, 1), (3, 0), (3, 1)):
        data = files.opj_file(n, 37, 33, 8, seed=levels * 10 + n, numresolution=levels, irreversible=irreversible,
                              tcp_mct=int(n == 3))
        assert_components(data, f"{levels} levels, {n} components, irreversible {irreversible}")


FORMS = {
    "sop": dict(csty=2, rates=[10, 0]), "eph": dict(csty=4, rates=[10, 0]), "sop_eph": dict(csty=6, rates=[12, 4, 0]),
    "tile_parts_r": dict(tp_on=1, tp_flag=ord("R"), rates=[8, 0]),
    "tile_parts_l": dict(tp_on=1, tp_flag=ord("L"), rates=[8, 3, 0]),
    "tile_parts_c": dict(tp_on=1, tp_flag=ord("C")),
    "tiles": dict(tile_size_on=1, cp_tdx=16, cp_tdy=16, numresolution=3, rates=[8, 0]),
    "tiles_offset": dict(tile_size_on=1, cp_tdx=16, cp_tdy=12, cp_tx0=1, cp_ty0=2, numresolution=3),
    "rgn": dict(roi_compno=0, roi_shift=5), "rgn_irreversible": dict(roi_compno=1, roi_shift=3, irreversible=1),
    "rgn_layers": dict(roi_compno=2, roi_shift=7, rates=[20, 5, 0]),
    "poc": dict(numresolution=5, rates=[30, 10, 0],
                pocs=[dict(tile=1, resno0=0, compno0=0, layno1=2, resno1=3, compno1=3, prg1=0),
                      dict(tile=1, resno0=0, compno0=0, layno1=3, resno1=6, compno1=3, prg1=2)]),
    "poc_cprl": dict(numresolution=4, rates=[10, 0],
                     pocs=[dict(tile=1, resno0=0, compno0=0, layno1=2, resno1=2, compno1=2, prg1=4),
                           dict(tile=1, resno0=0, compno0=0, layno1=2, resno1=4, compno1=3, prg1=1)]),
    "precincts": dict(precincts=[(16, 16), (8, 8)], prog_order=2, cblockw_init=8, cblockh_init=8, numresolution=3),
    "precincts_pcrl": dict(precincts=[(32, 16)], prog_order=3, cblockw_init=16, cblockh_init=4, numresolution=4),
    "codeblock_4x256": dict(cblockw_init=4, cblockh_init=256, numresolution=2),
}


@pytest.mark.parametrize("form", sorted(FORMS))
def test_encoder_forms(form):
    options = dict(FORMS[form])
    data = files.opj_file(3, 40, 36, 8, seed=len(form), **options)
    assert_pillow(data, form)
    if not form.startswith("tile"):
        assert_components(data, form)


SUBSAMPLING = {"chroma_420": [(1, 1), (2, 2), (2, 2)], "chroma_422": [(1, 1), (2, 1), (2, 1)],
               "chroma_mixed": [(1, 1), (2, 1), (1, 2)], "all_halved": [(2, 2), (2, 2), (2, 2)],
               "thirds": [(1, 1), (3, 3), (3, 3)], "first_subsampled": [(2, 1), (1, 1), (1, 1)],
               "four_components": [(1, 1), (2, 2), (2, 2), (1, 1)]}


@pytest.mark.parametrize("form", sorted(SUBSAMPLING))
def test_subsampled_components(form):
    """Pillow reads subsampled components with its own strides (w / dx) from the buffer OpenJPEG fills, and
    calls an unspecified space sYCC when the first subsampled component is the second or third."""
    sub = SUBSAMPLING[form]
    for h, w in ((20, 18), (21, 19), (7, 5)):
        for x0, y0 in ((0, 0), (1, 3), (2, 1)):
            data = files.opj_file(len(sub), h, w, 8, seed=h + x0, sub=sub, x0=x0, y0=y0)
            assert_pillow(data, f"{form} {h}x{w} at {x0},{y0}")


def _sop_eph(seed: int, **options) -> bytes:
    return files.opj_file(3, 40, 36, 8, seed=seed, csty=6, rates=[10, 0], **options)


REWRITES = {
    "ppt": lambda: files.to_ppt(_sop_eph(1)), "ppt_without_sop": lambda: files.to_ppt(_sop_eph(2), keep_sop=False),
    "ppt_tile_parts": lambda: files.to_ppt(_sop_eph(3, tp_on=1, tp_flag=ord("L"))),
    "ppt_tiles": lambda: files.to_ppt(_sop_eph(4, tile_size_on=1, cp_tdx=16, cp_tdy=16, numresolution=3)),
    "ppm": lambda: files.to_ppm(_sop_eph(5)), "ppm_small_markers": lambda: files.to_ppm(_sop_eph(6), 7),
    "ppm_tile_parts": lambda: files.to_ppm(_sop_eph(7, tp_on=1, tp_flag=ord("R")), 5000),
    "ppm_tiles": lambda: files.to_ppm(_sop_eph(8, tile_size_on=1, cp_tdx=16, cp_tdy=16, numresolution=3), 5000),
    "tlm": lambda: files.tlm(_sop_eph(9)), "plm": lambda: files.insert_main(_sop_eph(10), 0xFF57, b"\x00\x05\x81\x02"),
    "crg": lambda: files.insert_main(_sop_eph(11), 0xFF63, bytes(12)),
    "com_first": lambda: files.insert_main(_sop_eph(12), 0xFF64, b"\x00\x01first", at=1),
    "com_binary": lambda: files.insert_main(_sop_eph(13), 0xFF64, b"\x00\x00\xff\x00"),
    "unknown_marker": lambda: files.insert_main(_sop_eph(14), 0xFF30, b"\x12\x34"),
}


@pytest.mark.parametrize("form", sorted(REWRITES))
def test_marker_rewrites(form):
    data = REWRITES[form]()
    want = files.pillow_rgb(data)
    assert not isinstance(want, Exception), form
    np.testing.assert_array_equal(jpeg.decode_image(data, "f", "cpu"), want)
