"""AVIF in the port (data/avif.py and the AV1 decoder av1_*.py) against Pillow 12.1.

The JAX package reads every image with `PIL.Image.open(path).convert("RGB")`, which opens an AVIF file through
libavif 1.3.0 with dav1d 1.5.1 and libavif's libyuv YUV -> RGB step; `data.jpeg.decode_image` must give the
same pixels, bit for bit.  This file holds the files Pillow's own save writes in every mode it takes and under
each named option at small sizes, sizes from 1 x 1 across the 64 x 64 superblock edges, the dispatch (format
name, error kinds, the decompression-bomb limit), the dataset item and the image pass against the JAX
package's, and the stored corpus chip_smoke.py decodes on the card.  The coding tools at the speeds and sizes
that bring them in are in tests/test_torch_avif_coding.py, the container forms, refusals and damage in
tests/test_torch_avif_container.py, the tables and transforms in tests/test_torch_avif_tables.py, the
interactive retriever's AVIF query in tests/test_torch_avif_query.py.
"""

import hashlib
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import avif_files as files
from uniir_tpu_torch.data import avif, jpeg

CORPUS = Path(__file__).resolve().parent / "data" / "avif"
TOP = 160  # the corpus files the decoder is held to here: up to this size a side (the 640 x 480 ones are rates)

MODES = ("L", "LA", "P", "PA", "RGB", "RGBA", "RGBX", "RGBa", "CMYK", "YCbCr", "LAB", "HSV", "I;16", "I", "F")
SAVE_OPTIONS = {
    "default": {}, "q0": {"quality": 0}, "q30": {"quality": 30}, "q90": {"quality": 90},
    "lossless": {"quality": 100}, "lossless_444": {"quality": 100, "subsampling": "4:4:4"},
    "speed0": {"speed": 0}, "speed10": {"speed": 10}, "sub422": {"subsampling": "4:2:2"},
    "sub444": {"subsampling": "4:4:4"}, "sub400": {"subsampling": "4:0:0"}, "limited": {"range": "limited"},
    "premultiplied": {"alpha_premultiplied": True}, "sequence": {"frames": 1}, "xmp": {"xmp": b"<x/>"},
    "icc": {"icc_profile": b"\0" * 128},
}


def assert_pillow(data: bytes, what: str = "") -> np.ndarray:
    """The port decodes `data` to Pillow's pixels, or fails where Pillow fails."""
    want = files.pillow_rgb(data)
    if isinstance(want, Exception):
        with pytest.raises(ValueError) as e:
            jpeg.decode_image(data, what, "cpu")
        assert not isinstance(e.value, jpeg.UnsupportedImageFormat), what
        return want
    got = jpeg.decode_image(data, what, "cpu")
    assert got.dtype == np.uint8 and got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)
    return got


@pytest.mark.parametrize("mode", MODES)
def test_every_mode_pillow_saves(mode):
    data = files.pillow_file(mode, 21, 26, seed=len(mode))
    assert jpeg.image_format(data) == "avif"
    assert not isinstance(assert_pillow(data, mode), Exception)


@pytest.mark.parametrize("option", sorted(SAVE_OPTIONS))
@pytest.mark.parametrize("mode", ("RGB", "RGBA", "LA"))
def test_pillow_save_options(mode, option):
    data = files.pillow_file(mode, 27, 22, seed=len(option), **SAVE_OPTIONS[option])
    assert not isinstance(assert_pillow(data, f"{mode} {option}"), Exception), "Pillow reads back what it writes"


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_moves_no_pixel(orientation):
    """Pillow's save writes orientations 2-8 as irot / imir (essential) and EXIF without the tag; Image.open
    gives the frame as coded, its size unrotated."""
    from PIL import Image

    exif = Image.Exif()
    exif[0x0112] = orientation
    data = files.pillow_file("RGB", 20, 36, seed=orientation, exif=exif.tobytes())
    out = assert_pillow(data, f"orientation {orientation}")
    assert out.shape == (20, 36, 3)
    assert (b"irot" in data or b"imir" in data) == (orientation > 1)


@pytest.mark.parametrize("size", [(1, 1), (1, 9), (9, 1), (2, 3), (7, 5), (16, 17), (33, 17), (63, 64), (64, 65),
                                  (65, 63), (100, 31), (129, 3)])
def test_sizes_from_one_pixel_across_superblock_edges(size):
    """The default save (quality 75, speed 6, 4:2:0): odd sizes, frames of one 4 x 4 unit, partitions forced
    at the bottom and right frame edges, and chroma's last odd column."""
    h, w = size
    assert_pillow(files.pillow_file("RGB", h, w, seed=h * w), f"{size}")


def test_format_and_error_kinds():
    """image_format names an AVIF file "avif"; a file cut short (libavif: truncated data, so Pillow's plugin
    raises SyntaxError and Image.open tries its next reader) is one no reader identifies, and raises a plain
    ValueError; a HEIF `mif1` file with no AV1 item fails as Pillow fails; one decoder serves both hosts."""
    data = files.pillow_file("RGB", 30, 20)
    assert jpeg.image_format(data) == "avif"
    assert avif.accepts(data) and not avif.accepts(data[:4] + b"ftyp" + b"heic")
    cut = data[: len(data) // 2]
    assert isinstance(files.pillow_rgb(cut), Exception)
    assert jpeg.image_format(cut) == "unknown"
    heic = data[:8] + b"mif1" + data[12:].replace(b"av01", b"hvc1").replace(b"avif", b"heic")
    assert isinstance(files.pillow_rgb(heic), Exception)
    for bad in (cut, heic):
        with pytest.raises(ValueError) as e:
            jpeg.decode_image(bad, "f", "cpu")
        assert not isinstance(e.value, jpeg.UnsupportedImageFormat)
    assert avif.decoder_for("cpu") is avif.decode
    assert avif.decoder_for(torch.device("cuda", 0)) is avif.decode
    assert "AVIF" in jpeg.DECODED


def test_decompression_bomb_refused_at_open():
    """Pillow's decompression-bomb check on the size `ispe` gives, before any decoding."""
    import struct

    data = bytearray(files.pillow_file("RGB", 30, 20))
    at = bytes(data).find(b"ispe") + 8
    data[at : at + 8] = struct.pack(">II", 16000, 16000)
    assert "DecompressionBomb" in type(files.pillow_rgb(bytes(data))).__name__
    with pytest.raises(ValueError, match="decompression bomb"):
        jpeg.decode_image(bytes(data), "f", "cpu")


def test_dataset_items_from_avif_files_equal_jax(tmp_path):
    """The port's MBEIRCandidatePoolDataset item for AVIF img_paths (default, premultiplied alpha, a
    sequence) equals the JAX package's."""
    from tests.helpers import identity_image_transform
    from tests.torch_helpers import on_array
    from uniir_tpu.data import dataset as jax_dataset
    from uniir_tpu_torch.data import dataset

    os.makedirs(tmp_path / "images")
    lines = []
    for k, (mode, options) in enumerate((("RGB", {}), ("RGBA", {"alpha_premultiplied": True}),
                                         ("RGB", {"frames": 1, "speed": 4}))):
        (tmp_path / "images" / f"{k}.jpg").write_bytes(files.pillow_file(mode, 40, 30, seed=k, **options))
        lines.append(json.dumps({"did": f"9:{k}", "modality": "image", "img_path": f"images/{k}.jpg"}))
    (tmp_path / "cand_pool.jsonl").write_text("\n".join(lines) + "\n")
    transform = identity_image_transform(32)
    ours = dataset.MBEIRCandidatePoolDataset(str(tmp_path), "cand_pool.jsonl", on_array(transform), device="cpu")
    theirs = jax_dataset.MBEIRCandidatePoolDataset(str(tmp_path), "cand_pool.jsonl", transform)
    for k in range(3):
        a, b = ours[k], theirs[k]
        assert a.keys() == b.keys()
        np.testing.assert_array_equal(a["img"], b["img"])
        assert {key: v for key, v in a.items() if key != "img"} == {key: v for key, v in b.items() if key != "img"}


def test_read_image_and_image_pass_convert_as_the_jax_pass(tmp_path):
    """read_image gives Pillow's pixels; the M-BEIR image pass converts an AVIF file to the JPEG the JAX pass
    writes, byte for byte."""
    from uniir_tpu.data.preprocessing.io_utils import resize_and_convert_image_to_jpg as jax_pass
    from uniir_tpu_torch.data.preprocessing.io_utils import resize_and_convert_image_to_jpg as port_pass

    data = files.pillow_file("RGB", 61, 47, seed=5)
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
        (tmp_path / side / "a.avif").write_bytes(data)
    np.testing.assert_array_equal(jpeg.read_image(str(tmp_path / "port" / "a.avif"), "cpu"), files.pillow_rgb(data))
    assert jax_pass(str(tmp_path / "jax" / "a.avif"))
    assert port_pass(str(tmp_path / "port" / "a.avif"), device="cpu")
    assert (tmp_path / "port" / "a.jpg").read_bytes() == (tmp_path / "jax" / "a.jpg").read_bytes()


def _corpus():
    return json.loads((CORPUS / "digests.json").read_text())


SMALL = [name for name, entry in _corpus().items() if max(entry["shape"][:2]) <= TOP]


def test_corpus_digests_are_pillows():
    """scripts/make_avif_files.py's stored files still decode in Pillow to the stored digests (chip_smoke.py
    holds the decoder to these digests on the card)."""
    corpus = _corpus()
    assert 25 <= len(corpus) <= 40
    assert sum((CORPUS / name).stat().st_size for name in corpus) < 1024 * 1024
    for name, entry in corpus.items():
        want = files.pillow_rgb((CORPUS / name).read_bytes())
        assert list(want.shape) == entry["shape"], name
        assert hashlib.sha256(want.tobytes()).hexdigest() == entry["sha256"], name


@pytest.mark.parametrize("name", SMALL)
def test_corpus_file_decodes_to_pillows_digest(name):
    entry = _corpus()[name]
    out = avif.decode((CORPUS / name).read_bytes(), name)
    assert list(out.shape) == entry["shape"]
    assert hashlib.sha256(out.tobytes()).hexdigest() == entry["sha256"]


def test_corpus_directory_holds_only_the_listed_files():
    listed = set(_corpus()) | {"digests.json"}
    assert {p.name for p in CORPUS.iterdir()} == listed
