"""The M-BEIR image pass on every form that the port once refused or still refuses by name (the rarer plugins'
files too: McIdas, PIXAR, SPIDER, XVThumb, GBR, IMT, FTEX, BLP, FITS, FLI / FLC, PCD, IPTC, and AVIF)
(`uniir_tpu_torch.data.preprocessing.io_utils.resize_and_convert_image_to_jpg` beside the JAX package's): where
the JAX pass writes a JPEG, the port writes the same bytes or leaves the file in place (UnsupportedImageFormat);
where the JAX pass deletes a file as corrupt, the port deletes it too.  The port's pass used to delete any file
its decoders refused with a plain ValueError -- ZSTD and CIELAB TIFFs among them, which Pillow reads."""

import io
import os

import numpy as np
import pytest

import chip_smoke


def _pillow_tiff(im, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, "TIFF", **kw)
    return buf.getvalue()


def _cut_counts(data: bytes, frac: float) -> bytes:
    from tests.test_torch_tiff import _cut_counts

    return _cut_counts(data, frac)


def _lossless_cut_by_a_marker() -> bytes:
    """A lossless JPEG whose scan a stray RST0 cuts in the middle (libjpeg reads zeros to the end of the scan, with
    a warning, and decodes on)."""
    img = chip_smoke.raw_image(3, 48, 40)
    data = chip_smoke.jpeg_bytes(img[..., 0], coding="lossless", predictor=1)
    sos = data.index(b"\xff\xda")
    at = (sos + len(data)) // 2
    while data[at - 1] == 0xFF or data[at] == 0xFF:
        at += 1
    return data[:at] + b"\xff\xd0" + data[at:]


def _jpeg_strip_unknown_marker() -> bytes:
    """A one-strip JPEG TIFF whose strip ends in the unknown marker FF B8 instead of EOI: libjpeg raises at it
    after the scan, in jpeg_finish_decompress, which libtiff ignores."""
    yy, xx = np.mgrid[0:24, 0:32]
    img = np.stack([(xx * 5 + yy * 3 + 50 * c) % 256 for c in range(3)], axis=2).astype(np.uint8)
    data = chip_smoke.tiff_bytes(img, 6, compression=7)
    at = data.rindex(b"\xff\xd9", 0, data.index(b"\xff\xd8\xff\xdb", 9) if b"\xff\xd8\xff\xdb" in data[9:] else None)
    return data[:at] + b"\xff\xb8" + data[at + 2:]


def _forms() -> dict:
    """name -> file bytes: one file of every form the port's refusals were audited for."""
    from PIL import Image

    rng = np.random.default_rng(25)
    rgb = chip_smoke.raw_image(4, 40, 30)
    bil = np.kron(rng.random((14, 11)) > 0.5, np.ones((3, 4), bool))[:40, :41]
    ycc = chip_smoke.tiff_bytes(rgb, 6, compression=5, subsampling=(2, 2), rows_per_strip=8)
    t_off = [int(v) for v in __import__("uniir_tpu_torch.data.tiff", fromlist=["parse"]).parse(ycc).tags[273]]
    g4 = _pillow_tiff(Image.fromarray(bil), compression="group4", tiffinfo={278: 40})
    forms = {
        "zstd.tif": _pillow_tiff(Image.fromarray(rgb), compression="zstd"),
        "lab.tif": _pillow_tiff(Image.fromarray(rgb).convert("LAB"), compression="tiff_lzw"),
        "ycbcr22_orientation6.tif": chip_smoke.tiff_bytes(rgb, 6, compression=8, subsampling=(2, 2), orientation=6,
                                                          rows_per_strip=8),
        "ycbcr44_tiles.tif": chip_smoke.tiff_bytes(rgb, 6, compression=50000, subsampling=(4, 4), tile=(16, 16)),
        "ycbcr_planar.tif": chip_smoke.tiff_bytes(rgb, 6, compression=5, planar=2),
        "ycbcr_raw.tif": chip_smoke.tiff_bytes(rgb, 6, compression=1, rows_per_strip=4),
        "ycbcr_damaged.tif": ycc[:t_off[2] + 3] + bytes([ycc[t_off[2] + 3] ^ 0x5A]) + ycc[t_off[2] + 4:],
        "g3_cut.tif": _cut_counts(_pillow_tiff(Image.fromarray(bil), compression="group3", tiffinfo={278: 5}), 0.6),
        "g4_cut.tif": _cut_counts(g4, 0.5),
        "jpeg_strip_marker.tif": _jpeg_strip_unknown_marker(),
        "jpeg_planes.tif": chip_smoke.tiff_bytes(rgb, 2, compression=7, planar=2, rows_per_strip=16),
        "lossless_cut.jpg": _lossless_cut_by_a_marker(),
        "predictor3_integer.tif": chip_smoke.tiff_bytes(rgb[..., :1].astype(np.uint16) * 200, 1, compression=5,
                                                        predictor=3),
        "ycbcr33.tif": chip_smoke.tiff_bytes(rgb, 6, compression=5, tags={530: (3, [3, 3])}),
        "jpeg_cut_in_scan.jpg": chip_smoke.jpeg_bytes(rgb)[:-300],
    }
    # the rarer plugins, one file of each form (a GIMP brush's comment is carried into the JPEG)
    import rare_format_files

    rare = rare_format_files.corpus(25)
    for name in ("mcidas_i16.area", "pixar.pxr", "spider.spi", "xvthumb.p7", "gbr_v2_rgba.gbr", "imt.imt",
                 "ftex_bc1.ftc", "ftex_rgb.ftu", "blp1_pillow.blp", "blp1_jpeg.blp", "blp2_palette.blp",
                 "blp2_dxt1.blp", "blp2_dxt3.blp", "blp2_dxt5.blp"):
        forms[name] = rare[name]
    forms["blp2_dxt1_cut.blp"] = rare["blp2_dxt1.blp"][:-40]  # deleted by both passes
    # FITS, FLI / FLC, PCD and IPTC: one file of each, and one cut short of each
    more = rare_format_files.fits_pcd_fli_iptc(25)
    for name in ("fits_16.fits", "fits_gzip_8.fits", "flc_brun_ss2.fli", "pcd_1.pcd", "iptc_jpeg.iim",
                 "iptc_raw_rgb_band2.iim"):
        forms[name] = more[name]
        stem, ext = os.path.splitext(name)
        forms[f"{stem}_cut{ext}"] = more[name][: len(more[name]) * 3 // 4]
    # AVIF: Pillow's default save, premultiplied alpha, a sequence, grey; a matrix libavif converts in its own
    # float path (refused by name); one cut short (deleted by both passes)
    import avif_files

    forms["avif_default.avif"] = avif_files.pillow_file("RGB", 40, 30, seed=25)
    forms["avif_rgba_premultiplied.avif"] = avif_files.pillow_file("RGBA", 33, 21, seed=26, alpha_premultiplied=True)
    forms["avif_sequence.avif"] = avif_files.pillow_file("RGB", 24, 40, seed=27, frames=1)
    forms["avif_grey_limited.avif"] = avif_files.pillow_file("L", 30, 30, seed=28, subsampling="4:0:0", range="limited")
    forms["avif_matrix_ycgco.avif"] = avif_files.set_colr(forms["avif_default.avif"], matrix=8)
    forms["avif_cut.avif"] = forms["avif_default.avif"][: len(forms["avif_default.avif"]) * 2 // 3]
    return forms


# the forms the port leaves in place where the JAX pass writes a JPEG (their pixels are not modelled; an AVIF
# matrix libavif converts in floating point is refused by name, ROADMAP Queue 3)
KEPT = {"g4_cut.tif", "avif_matrix_ycgco.avif"}


@pytest.mark.parametrize("name", sorted(_forms()))
def test_image_pass_writes_what_jax_writes_or_keeps_the_file(tmp_path, name):
    from uniir_tpu.data.preprocessing import io_utils as jax_io
    from uniir_tpu_torch.data.preprocessing import io_utils as port_io

    data = _forms()[name]
    stem = os.path.splitext(name)[0]
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
        (tmp_path / side / name).write_bytes(data)
    jax_done = jax_io.resize_and_convert_image_to_jpg(str(tmp_path / "jax" / name))
    port_done = port_io.resize_and_convert_image_to_jpg(str(tmp_path / "port" / name), device="cpu")
    if not jax_done:  # deleted as corrupt by the JAX pass: by the port's too
        assert port_done is False and not os.listdir(tmp_path / "jax") and not os.listdir(tmp_path / "port")
        return
    if port_done is None:  # left in place, named
        assert name in KEPT
        assert (tmp_path / "port" / name).read_bytes() == data
        return
    assert port_done is True and name not in KEPT
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) == [f"{stem}.jpg"]
    assert (tmp_path / "port" / f"{stem}.jpg").read_bytes() == (tmp_path / "jax" / f"{stem}.jpg").read_bytes()
