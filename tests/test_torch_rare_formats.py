"""McIdas, PIXAR, SPIDER, XVThumb, GBR, IMT, FTEX and BLP files read as Pillow 12.1 reads them
(`uniir_tpu_torch.data.{mcidas,pixar,spider,xvthumb,gbr,imt,ftex,blp}` through `jpeg.decode_image`): each
form's pixels equal `Image.open(path).convert("RGB")` and `image_format` names the format as Pillow's `format`
does; cut and flipped files raise where Pillow raises and give Pillow's pixels where Pillow gives an image; the
header tests keep Image.open's order of readers; BLP's DXT arithmetic is its plugin's own, not the `bcn`
decoder's.  Pillow reads the files from a path, as the JAX package does (a path's L / P / I;16B pixels are
memory-mapped).  `-m gpu`: FTEX's BC1 blocks through csrc/bcn.cu and BLP1's JPEG through csrc/jpeg.cu, held
to the twins.

The module imports no JAX and no Pillow at its top, so its `-m gpu` cases collect with `--noconftest` on a
machine that has neither."""

import struct

import numpy as np
import pytest
import torch

import chip_smoke
import rare_format_files as files
from uniir_tpu_torch.data import blp, dds, ftex, jpeg

CORPUS = sorted(files.corpus(0))
FORMATS = {"mcidas": "MCIDAS", "pixar": "PIXAR", "spider": "SPIDER", "xvthumb": "XVThumb", "gbr": "GBR",
           "imt": "IMT", "ftex": "FTEX", "blp1": "BLP", "blp2": "BLP"}


def pillow(tmp_path, data: bytes):
    """(format, RGB pixels) of Image.open(path).convert("RGB"), or (None, "refused") where it raises."""
    from PIL import Image

    path = tmp_path / "f.bin"
    path.write_bytes(data)
    try:
        with Image.open(path) as im:
            return im.format, np.asarray(im.convert("RGB"))
    except Exception:  # noqa: BLE001 -- that Pillow raises is the outcome
        return None, "refused"


def port(data: bytes, device: str = "cpu"):
    """(image_format, pixels) of the port, or (image_format, "refused") where it raises a plain ValueError."""
    try:
        return jpeg.image_format(data), jpeg.decode_image(data, "f", device)
    except jpeg.UnsupportedImageFormat as err:
        pytest.fail(f"UnsupportedImageFormat where Pillow decides: {err}")
    except ValueError:
        return jpeg.image_format(data), "refused"


def assert_as_pillow(tmp_path, data: bytes, what: str = "") -> bool:
    fmt, want = pillow(tmp_path, data)
    kind, got = port(data)
    if isinstance(want, str):
        assert isinstance(got, str), (what, kind, "decoded where Pillow refuses")
        return False
    assert not isinstance(got, str), (what, fmt, "refused where Pillow decodes")
    assert kind == fmt.lower(), (what, kind, fmt)
    np.testing.assert_array_equal(got, want, err_msg=what)
    return True


@pytest.mark.parametrize("name", CORPUS)
def test_files_decode_as_pillow(tmp_path, name):
    data = files.corpus(0)[name]
    fmt, _ = pillow(tmp_path, data)
    assert fmt == FORMATS[name.split("_")[0].split(".")[0]]
    assert assert_as_pillow(tmp_path, data, name)


@pytest.mark.parametrize("name", CORPUS)
def test_cut_and_flipped_files_as_pillow(tmp_path, name):
    """Seeded cuts (anywhere) and byte flips (mostly in the header): the port raises a plain ValueError where
    Pillow raises, and gives Pillow's pixels, under Pillow's format, where Pillow gives an image."""
    data = files.corpus(1)[name]
    rng = np.random.default_rng(CORPUS.index(name))
    decoded = 0
    for case in range(24):
        b = bytearray(data)
        if case % 3 == 0:
            b = b[: int(rng.integers(0, len(b)))]
        else:
            for _ in range(int(rng.integers(1, 4))):
                at = int(rng.integers(0, min(len(b), 400) if case % 3 == 1 else len(b)))
                b[at] ^= int(rng.integers(1, 256))
        decoded += assert_as_pillow(tmp_path, bytes(b), f"{name} case {case}")
    assert decoded >= 4


def _edge_cases() -> dict:
    rgb = files.image(3, 13, 9)
    grey = rgb[..., 0]
    mc = bytearray(files.mcidas_bytes(grey, prefix=4))
    struct.pack_into(">i", mc, 4 * 14, -20)  # a row stride below a row's bytes: mapped rows overlap
    spider = bytearray(files.pillow_spider(grey))
    struct.pack_into(">f", spider, 4 * 23, 2.0)  # a stack of images
    gbr = bytearray(files.gbr_bytes(grey, 2, b""))
    gbr[:4] = (24).to_bytes(4, "big")  # a version-2 header of 24 bytes: its comment runs to the file's end
    return {
        "mcidas_overlapping_rows": bytes(mc),
        "mcidas_no_stride": files.mcidas_bytes(grey)[:4 * 14] + bytes(4) + files.mcidas_bytes(grey)[4 * 15:],
        "spider_stack": bytes(spider) + bytes(len(spider)),
        "imt_without_pixel_mode": b"width 3\nheight 2\n\x0c" + bytes(6),
        "imt_without_form_feed": b"width 3\nheight 2\npixel n8\n",
        "imt_bad_width": b"width x3\nheight 2\npixel n8\n\x0c" + bytes(6),
        "imt_comments": files.imt_bytes(grey, (b"* one\n", b"* two\n", b"*\n")),
        "xvthumb_no_size_line": b"P7 332\n#END_OF_COMMENTS\n",
        "xvthumb_one_number": b"P7 332\n#c\n5\n" + bytes(25),
        "gbr_v2_short_header": bytes(gbr),
        "gbr_bad_depth": files.gbr_bytes(grey)[:16] + b"\0\0\0\3" + files.gbr_bytes(grey)[20:],
        "pixar_other_depth": files.pixar_bytes(rgb, 14, 3),
        "ftex_two_formats": chip_smoke.ftex_bytes(13, 9, 1, rgb.tobytes(), formats=2),
        "ftex_format_2": chip_smoke.ftex_bytes(13, 9, 2, rgb.tobytes()),
        "ftex_negative_length": chip_smoke.ftex_bytes(13, 9, 1, rgb.tobytes(), length=-1),
        "ftex_mipmap_past_end": chip_smoke.ftex_bytes(13, 9, 1, b"", where=4000),
        "blp2_raw_bgra": b"BLP2" + struct.pack("<ibbbbII", 1, 3, 0, 0, 0, 13, 9) + bytes(128 + 1024 + 13 * 9 * 4),
        "blp2_jpeg": b"BLP2" + struct.pack("<ibbbbII", 0, 1, 0, 0, 0, 13, 9) + bytes(128 + 1024 + 13 * 9),
        "blp_header_cut": b"BLP2" + bytes(10),
    }


@pytest.mark.parametrize("case", sorted(_edge_cases()))
def test_header_edge_cases_as_pillow(tmp_path, case):
    """Header forms each plugin's _open takes or refuses: rows of a mapped McIdas file that overlap, a SPIDER
    stack's first image, IMT headers without a pixel mode, form feed or numeric width (Image.open identifies
    nothing, or raises), XV thumbnails without a size line, GBR headers Pillow refuses or reads its comment
    to the end of, a PIXAR file of another depth, FTEX files Pillow's assert or format check refuses, BLP2
    encodings Pillow's decoder refuses."""
    assert_as_pillow(tmp_path, _edge_cases()[case], case)


@pytest.mark.parametrize("form", ["cmyk", "ycck", "grey", "rgb_adobe", "ycbcr_420"])
def test_blp1_jpeg_forms_as_pillow(tmp_path, form):
    """BLP1's JPEG mipmaps in each colour form: red and blue swapped ("BGR"), and a CMYK frame re-tagged so
    that libjpeg takes a YCCK frame's components as they are stored."""
    img = files.image(11, 30, 21)
    arr = {"cmyk": np.concatenate([img, img[..., :1]], 2), "ycck": np.concatenate([img, img[..., 1:2]], 2),
           "grey": img[..., 0], "rgb_adobe": img, "ycbcr_420": img}[form]
    jpg = chip_smoke.jpeg_bytes(arr, 85, form={"ycbcr_420": "ycbcr", "grey": "ycbcr", "rgb_adobe": "rgb"}.get(form, form))
    sos = jpg.index(b"\xff\xda")
    for alpha in (0, 1):
        extra = struct.pack("<I", sos) + jpg[:sos]
        head = b"BLP1" + struct.pack("<iIIIii", 0, alpha, 30, 21, 0, 0)
        data = head + struct.pack("<16I", 28 + 128 + len(extra), *[0] * 15) + struct.pack(
            "<16I", len(jpg) - sos, *[0] * 15) + extra + jpg[sos:]
        assert assert_as_pillow(tmp_path, data, f"{form} alpha {alpha}")


@pytest.mark.parametrize("kind", ["dxt1", "dxt1_alpha", "dxt3", "dxt5"])
def test_dxt_blocks_are_the_plugins_arithmetic(kind):
    """`blp.dxt_pixels` equals BlpImagePlugin's decode_dxt1 / decode_dxt3 / decode_dxt5 on seeded block rows
    (random bits: both DXT1 forms, both DXT5 alpha forms); Pillow's `bcn` decoder (the DDS and FTEX one)
    differs on them, so BLP does not reuse it."""
    from PIL import BlpImagePlugin

    rng = np.random.default_rng(["dxt1", "dxt1_alpha", "dxt3", "dxt5"].index(kind))
    size = 8 if kind.startswith("dxt1") else 16
    blocks = rng.integers(0, 256, (6, 9, size), dtype=np.uint8)
    fn = {"dxt1": lambda d: BlpImagePlugin.decode_dxt1(d, False), "dxt1_alpha": lambda d: BlpImagePlugin.decode_dxt1(
        d, True), "dxt3": BlpImagePlugin.decode_dxt3, "dxt5": BlpImagePlugin.decode_dxt5}[kind]
    want = b"".join(bytes(r) for row in blocks for r in fn(row.tobytes()))
    assert blp.dxt_pixels(blocks, kind[:4], kind != "dxt1") == want
    if kind == "dxt1_alpha":
        bcn = dds.TWINS["bc1"](blocks.tobytes(), 0, 36, 24, 0, "f")
        ours = np.frombuffer(want, np.uint8).reshape(24, 36, 4)[..., :3]
        assert not np.array_equal(bcn, ours)


def test_gbr_comment_is_carried_by_the_image_pass():
    """GIMP brushes keep their comment (less its last byte) in info["comment"], which Pillow's JPEG writer
    carries over: `image_comment` gives it, and nothing for a comment of one byte."""
    grey = files.image(2, 7, 5)[..., 0]
    assert jpeg.image_comment(files.gbr_bytes(grey, 2, b"my brush\0")) == b"my brush"
    assert jpeg.image_comment(files.gbr_bytes(grey, 1, b"v1 brush\0")) == b"v1 brush"
    assert jpeg.image_comment(files.gbr_bytes(grey, 2, b"\0")) is None


# --- the native stages (the card's machine)


@pytest.fixture
def native():
    if not torch.cuda.is_available():
        pytest.skip("needs the card's machine: csrc/bcn.cu and csrc/jpeg.cu are built by nvcc, installed there")
    return "cuda"


@pytest.mark.gpu
def test_native_stages_equal_the_twins(native):
    """FTEX's BC1 blocks through csrc/bcn.cu and BLP1's JPEG through csrc/jpeg.cu give the twins' pixels,
    each a native call."""
    corpus = files.corpus(0)
    for seed in range(4):
        rgb = files.image(20 + seed, 17 + 11 * seed, 13 + 7 * seed)
        data = chip_smoke.ftex_bytes(rgb.shape[1], rgb.shape[0], 0, chip_smoke.dxt1_encode(rgb))
        before = dds.native_calls["bc1"]
        np.testing.assert_array_equal(jpeg.decode_image(data, "f", native), ftex.decode_twin(data, "f"))
        assert dds.native_calls["bc1"] == before + 1
    for name in ("blp1_jpeg.blp", "blp2_dxt1.blp", "ftex_rgb.ftu", "ftex_bc1.ftc"):
        before = jpeg.decode_native.calls
        np.testing.assert_array_equal(jpeg.decode_image(corpus[name], name, native),
                                      jpeg.decode_image(corpus[name], name, "cpu"))
        assert jpeg.decode_native.calls == before + (name == "blp1_jpeg.blp")
