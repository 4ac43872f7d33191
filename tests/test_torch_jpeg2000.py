"""JPEG 2000 in the port (data/jpeg2000.py and its tier-1, tier-2 and DWT modules) against Pillow 12.1.

The JAX package reads every image with `PIL.Image.open(path).convert("RGB")`, which opens a JPEG 2000 file
through OpenJPEG 2.5.4; `data.jpeg.decode_image` must give the same pixels, bit for bit.  This file holds
the files Pillow's own save writes (every mode it saves, reversible and irreversible, component transform
on and off, 1 to 6 resolutions, the five progressions, tiles with their offsets, image offsets, code-block
and precinct sizes, quality layers by rate and by dB, PLT, comments, signed samples, J2K and JP2), the
dispatch (image_format, the error kinds, HT refused by name), the dataset item and the image pass against
the JAX package's, and the stored corpus chip_smoke.py decodes on the card.  The forms only OpenJPEG's
encoder writes are in tests/test_torch_jpeg2000_codestream.py, damaged files in
tests/test_torch_jpeg2000_damage.py.  The native decoder (csrc/jpeg2000.cu, built by nvcc on the card's
machine) is held to the twin by the `-m gpu` tests at the end and by chip_smoke.py's decoder phase.
"""

import hashlib
import json
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

import jpeg2000_files as files
from uniir_tpu_torch.data import jpeg, jpeg2000

CORPUS = Path(__file__).resolve().parent / "data" / "jpeg2000"
# the corpus files the twin decodes in the `-m gpu` cases (it is pure Python: up to 160 pixels a side)
SMALL_CORPUS = [name for name, entry in json.loads((CORPUS / "digests.json").read_text()).items()
                if max(entry["shape"][:2]) <= 160]

MODES = ("L", "LA", "RGB", "RGBA", "I;16")
SAVE_OPTIONS = {
    "default": {}, "irreversible": {"irreversible": True}, "one_resolution": {"num_resolutions": 1},
    "one_resolution_irreversible": {"num_resolutions": 1, "irreversible": True},
    "six_resolutions": {"num_resolutions": 6, "irreversible": True}, "mct": {"mct": 1},
    "mct_irreversible": {"mct": 1, "irreversible": True},
    "layers_rates": {"quality_layers": [40, 10, 2]},
    "layers_db": {"quality_mode": "dB", "quality_layers": [30, 40, 50]},
    "layers_irreversible": {"irreversible": True, "quality_layers": [20, 5]},
    "rlcp": {"num_resolutions": 4, "progression": "RLCP"},
    "rpcl": {"progression": "RPCL", "precinct_size": (16, 16), "codeblock_size": (8, 8), "num_resolutions": 3},
    "pcrl": {"progression": "PCRL", "precinct_size": (32, 16), "codeblock_size": (4, 16), "num_resolutions": 4},
    "cprl": {"progression": "CPRL", "precinct_size": (64, 32), "codeblock_size": (16, 4), "irreversible": True},
    "tiles": {"tile_size": (16, 16)}, "tiles_offsets": {"tile_size": (16, 12), "tile_offset": (3, 5), "offset": (7, 9)},
    "plt": {"plt": True}, "comment": {"comment": "a comment"}, "j2k": {"no_jp2": True}, "signed": {"signed": True},
}


def assert_pillow(data: bytes, what: str = "") -> np.ndarray:
    """The twin decodes `data` to Pillow's pixels, or fails where Pillow fails."""
    want = files.pillow_rgb(data)
    if isinstance(want, Exception):
        with pytest.raises(ValueError):
            jpeg2000.decode_twin(data, what)
        return want
    got = jpeg2000.decode_twin(data, what)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)
    return got


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("option", sorted(SAVE_OPTIONS))
def test_pillow_save_matrix(mode, option):
    data = files.pillow_file(mode, 40, 37, seed=len(option), **SAVE_OPTIONS[option])
    assert jpeg.image_format(data) == "jpeg2000"
    out = assert_pillow(data, f"{mode} {option}")
    assert not isinstance(out, Exception), "Pillow reads back what it writes"
    np.testing.assert_array_equal(jpeg.decode_image(data, "f", "cpu"), out)


def test_written_files_pillow_cannot_read_fail_alike():
    """Pillow writes precincts of 16 over six resolutions, which halve to a precinct exponent of 0 above
    the lowest resolution; OpenJPEG refuses to read that back, and so does the port."""
    data = files.pillow_file("RGB", 40, 37, progression="RPCL", precinct_size=(16, 16), codeblock_size=(8, 8))
    assert isinstance(files.pillow_rgb(data), OSError)
    with pytest.raises(ValueError, match="Invalid precinct size"):
        jpeg.decode_image(data, "f", "cpu")


@pytest.mark.parametrize("size", [(1, 1), (1, 7), (7, 1), (2, 3), (33, 17), (128, 96)])
def test_sizes_from_one_pixel_up(size):
    """Lengths 1 and 2 on either axis, at even and odd origins (a lone sample at each parity, the lifting's
    parity swapped), in both wavelets, one resolution and as many as the size holds."""
    h, w = size
    for x0, y0 in ((0, 0), (1, 1), (3, 0)):
        for irreversible in (0, 1):
            for levels in {1, max(1, min(6, min(h, w).bit_length()))}:
                data = files.opj_file(3, h, w, 8, seed=h * w + x0, x0=x0, y0=y0, irreversible=irreversible,
                                      tcp_mct=irreversible, numresolution=levels)
                assert_pillow(data, f"{size} at {x0}, {y0} {irreversible} {levels}")


def test_format_and_error_kinds():
    """image_format names a file Pillow's plugin opens; HT code-blocks and Part 2 transforms raise
    UnsupportedImageFormat naming them; a header Pillow's _open rejects makes Image.open try its next reader
    (so "unknown"), a broken stream fails as corrupt."""
    data = files.pillow_file("RGB", no_jp2=True)
    assert jpeg.image_format(data) == "jpeg2000"
    prefix, main, parts, suffix = files.split(data)
    cod = next(i for i, (m, _) in enumerate(main) if m == 0xFF52)
    body = main[cod][1]
    ht = list(main)
    ht[cod] = (0xFF52, body[:8] + bytes([body[8] | 0x40]) + body[9:])
    for form, what in ((files.join(prefix, ht, parts, suffix), "HT"),
                       (files.insert_main(data, 0xFF50, b"\x00\x02\x00\x00\x00\x00"), "HT"),
                       (files.insert_main(data, 0xFF74, b"\x00\x00\x00\x00"), "Part 2")):
        with pytest.raises(jpeg.UnsupportedImageFormat, match=f"JPEG 2000 {what}"):
            jpeg.decode_image(form, "f", "cpu")
    assert jpeg.image_format(data[:5]) == "unknown"
    with pytest.raises(ValueError) as e:
        jpeg.decode_image(data[: len(data) // 2], "f", "cpu")
    assert not isinstance(e.value, jpeg.UnsupportedImageFormat)
    assert isinstance(files.pillow_rgb(data[: len(data) // 2]), OSError)
    assert jpeg2000.decoder_for("cpu") is jpeg2000.decode_twin
    assert jpeg2000.decoder_for(torch.device("cuda", 0)) is jpeg2000.decode_native


def test_decompression_bomb_refused_at_open():
    """Pillow's decompression-bomb check on the size the header gives, before any decoding."""
    data = files.pillow_file("L", no_jp2=True)
    big = data[:8] + (40000).to_bytes(4, "big") + (40000).to_bytes(4, "big") + data[16:]
    assert "DecompressionBomb" in type(files.pillow_rgb(big)).__name__
    with pytest.raises(ValueError, match="decompression bomb"):
        jpeg.decode_image(big, "f", "cpu")


def test_dataset_items_from_jpeg2000_files_equal_jax(tmp_path):
    """The port's MBEIRCandidatePoolDataset item for a JP2 and a J2K img_path equals the JAX package's."""
    from tests.helpers import identity_image_transform
    from tests.torch_helpers import on_array
    from uniir_tpu.data import dataset as jax_dataset
    from uniir_tpu_torch.data import dataset

    os.makedirs(tmp_path / "images")
    lines = []
    for k, options in enumerate(({}, {"no_jp2": True, "irreversible": True})):
        (tmp_path / "images" / f"{k}.jpg").write_bytes(files.pillow_file("RGB", 40, 30, seed=k, **options))
        lines.append(json.dumps({"did": f"9:{k}", "modality": "image", "img_path": f"images/{k}.jpg"}))
    (tmp_path / "cand_pool.jsonl").write_text("\n".join(lines) + "\n")
    transform = identity_image_transform(32)
    ours = dataset.MBEIRCandidatePoolDataset(str(tmp_path), "cand_pool.jsonl", on_array(transform), device="cpu")
    theirs = jax_dataset.MBEIRCandidatePoolDataset(str(tmp_path), "cand_pool.jsonl", transform)
    for k in range(2):
        a, b = ours[k], theirs[k]
        assert a.keys() == b.keys()
        np.testing.assert_array_equal(a["img"], b["img"])
        assert {key: v for key, v in a.items() if key != "img"} == {key: v for key, v in b.items() if key != "img"}


def test_image_pass_converts_as_the_jax_pass(tmp_path):
    """The M-BEIR image pass converts a JP2 file to the JPEG the JAX pass writes, byte for byte."""
    from uniir_tpu.data.preprocessing.io_utils import resize_and_convert_image_to_jpg as jax_pass
    from uniir_tpu_torch.data.preprocessing.io_utils import resize_and_convert_image_to_jpg as port_pass

    data = files.pillow_file("RGB", 61, 47, seed=5, irreversible=True)
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
        (tmp_path / side / "a.jp2").write_bytes(data)
    assert jax_pass(str(tmp_path / "jax" / "a.jp2"))
    assert port_pass(str(tmp_path / "port" / "a.jp2"), device="cpu")
    assert (tmp_path / "port" / "a.jpg").read_bytes() == (tmp_path / "jax" / "a.jpg").read_bytes()


def _corpus():
    return json.loads((CORPUS / "digests.json").read_text())


def test_corpus_digests_are_pillows():
    """scripts/make_jpeg2000_files.py's stored files still decode in Pillow to the stored digests, and the
    twin gives the same pixels on the ones up to 160 pixels (chip_smoke.py holds the native decoder to
    these digests on the card)."""
    corpus = _corpus()
    assert 40 <= len(corpus) <= 80
    assert sum((CORPUS / name).stat().st_size for name in corpus) < 2 * 1024 * 1024
    for name, entry in corpus.items():
        data = (CORPUS / name).read_bytes()
        want = files.pillow_rgb(data)
        assert list(want.shape) == entry["shape"], name
        assert hashlib.sha256(want.tobytes()).hexdigest() == entry["sha256"], name
        if max(entry["shape"][:2]) <= 160:
            assert hashlib.sha256(jpeg2000.decode_twin(data).tobytes()).hexdigest() == entry["sha256"], name


# --- the native decoder (csrc/jpeg2000.cu, built by nvcc on the card's machine)


@pytest.fixture
def native():
    if not torch.cuda.is_available():
        pytest.skip("needs the card's machine: csrc/jpeg2000.cu is built by nvcc, which is installed there")
    return jpeg2000.decode_native


@pytest.mark.gpu
@pytest.mark.parametrize("name", SMALL_CORPUS)
def test_native_is_bit_equal_to_twin(native, name):
    """The card's machine has no Pillow to write files: the stored corpus's files up to 160 pixels."""
    data = (CORPUS / name).read_bytes()
    before = jpeg2000.decode_native.calls
    out = native(data)
    assert jpeg2000.decode_native.calls == before + 1
    np.testing.assert_array_equal(out, jpeg2000.decode_twin(data))


@pytest.mark.gpu
def test_native_on_the_corpus_in_threads(native):
    """Pillow's digests on every corpus file, eight of the loader's threads at once."""
    corpus = _corpus()
    blobs = {name: (CORPUS / name).read_bytes() for name in corpus}
    with ThreadPoolExecutor(8) as pool:
        outs = dict(zip(blobs, pool.map(native, blobs.values())))
    for name, out in outs.items():
        assert hashlib.sha256(out.tobytes()).hexdigest() == corpus[name]["sha256"], name


def test_corpus_directory_holds_only_the_listed_files():
    listed = set(_corpus()) | {"digests.json"}
    assert {p.name for p in CORPUS.iterdir()} == listed
