"""Damaged JPEG data read as Pillow 12.1's libjpeg-turbo reads it: decoded with its warnings' recoveries, or
refused where Pillow raises (`uniir_tpu_torch.data.jpeg`, the twin; `-m gpu`, the native decoder
csrc/jpeg.cu on the card's machine).

The corpus tests/data/jpeg_damage/ (scripts/make_damaged_jpegs.py; Pillow's outcome of each file in
`digests.json`), seeded derivatives of its clean files by `chip_smoke.jpeg_damage` (a flipped byte, zeroed
bytes, a scan cut with EOI appended, a tail zeroed, junk before a marker, a restart marker dropped, repeated,
renumbered or replaced), files of chosen out-of-range coefficients (libjpeg-turbo's x86-64 SIMD IDCT, whose
16-bit lanes wrap and saturate), `open_header` / `is_jpeg` against `Image.open`, and the three places the
JAX package reads an image (its dataset, and the M-BEIR image pass) held to the port on damaged files.

The module imports no JAX and no Pillow at its top, so its `-m gpu` cases collect with `--noconftest` on a
machine that has neither."""

import hashlib
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from uniir_tpu_torch.data import jpeg

CORPUS = Path(chip_smoke.JPEG_DAMAGE_CORPUS)
DIGESTS = json.loads((CORPUS / "digests.json").read_text())
SOURCES = chip_smoke.jpeg_damage_sources()
SEEDS_PER_KIND = 4  # derivatives of each clean file by each damage kind: 11 x 10 x 4 = 440


def outcome(decode, data: bytes, name: str = "f.jpg"):
    """`decode`'s pixels, or "refused" where it raises ValueError (anything else fails the test)."""
    try:
        return decode(data, name)
    except ValueError:
        return "refused"


def pillow(data: bytes):
    import jpeg_damage_files

    got = jpeg_damage_files.pillow_outcome(data)
    return "refused" if isinstance(got, str) else got


def same(a, b) -> bool:
    if isinstance(a, str) or isinstance(b, str):
        return isinstance(a, str) and isinstance(b, str) and a == b
    return a.shape == b.shape and bool(np.array_equal(a, b))


def derivative(source: str, kind: str, seed: int) -> bytes:
    rng = np.random.default_rng(10_000 * SOURCES.index(source) + 100 * chip_smoke.JPEG_DAMAGE_KINDS.index(kind) + seed)
    return chip_smoke.jpeg_damage((CORPUS / source).read_bytes(), kind, rng)


def digest_outcome(got) -> dict:
    if isinstance(got, str):
        return {"refused": True}
    return {"shape": list(got.shape), "sha256": hashlib.sha256(got.tobytes()).hexdigest()}


def wanted(name: str) -> dict:
    entry = DIGESTS[name]
    return {"refused": True} if "error" in entry else entry


# --- the corpus


def test_corpus_is_what_the_script_writes_and_pillow_still_reads_so():
    """Every file is the script's bytes and Pillow's outcome is still the recorded one; the corpus holds
    every form, both large sizes and files Pillow refuses, within 1.5 MB."""
    import jpeg_damage_files

    files = jpeg_damage_files.corpus()
    assert sorted(files) == sorted(DIGESTS)
    for name, data in files.items():
        assert (CORPUS / name).read_bytes() == data, name
        got = jpeg_damage_files.pillow_outcome(data)
        want = DIGESTS[name]
        assert ({"error": got} if isinstance(got, str) else
                {"shape": list(got.shape), "sha256": hashlib.sha256(got.tobytes()).hexdigest()}) == want, name
    assert sum((CORPUS / n).stat().st_size for n in DIGESTS) < 1.5e6
    assert sum("error" in e for e in DIGESTS.values()) >= 5 and len(SOURCES) == 11
    assert {tuple(e["shape"][:2]) for e in DIGESTS.values() if "shape" in e} >= {(480, 640), (1080, 1920)}


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_twin_on_the_corpus_gives_pillows_outcome(name):
    got = outcome(jpeg.decode_twin, (CORPUS / name).read_bytes(), name)
    assert digest_outcome(got) == wanted(name)


# --- seeded derivatives


@pytest.mark.parametrize("kind", chip_smoke.JPEG_DAMAGE_KINDS)
@pytest.mark.parametrize("source", SOURCES)
def test_derivatives_decode_as_pillow(source, kind):
    """SEEDS_PER_KIND derivatives of a clean file by one damage kind: the twin's outcome is Pillow's, pixels
    or refusal alike."""
    for seed in range(SEEDS_PER_KIND):
        data = derivative(source, kind, seed)
        want, got = pillow(data), outcome(jpeg.decode_twin, data)
        assert same(got, want), (source, kind, seed, "refused" if isinstance(got, str) else "decoded",
                                 "refused" if isinstance(want, str) else "decoded")


def test_restart_resync_cases():
    """libjpeg's resynchronisation at a restart, case by case on a file of 24 restart intervals (RST0-7
    three times): each RSTn put where another is expected (the next two left unread, the interval between
    read as zeros, then decoding resumes; a prior one skipped; a far one discarded), a marker dropped or
    repeated, EOI or TEM in its place."""
    import jpeg_damage_files as files

    data = files.pillow_jpeg(files.photo(12, 64, 96), quality=85, restart_marker_blocks=1)
    lo, hi = chip_smoke.jpeg_scan_span(data)
    rst = [i for i in range(lo, hi - 1) if data[i] == 0xFF and 0xD0 <= data[i + 1] <= 0xD7]
    assert len(rst) == 23
    cases = []
    for k in (1, 5, 9):
        at = rst[k]
        for code in range(0xD0, 0xD8):
            cases.append(data[: at + 1] + bytes([code]) + data[at + 2 :])
        cases.append(data[:at] + data[at + 2 :])  # dropped
        cases.append(data[:at] + data[at : at + 2] * 2 + data[at + 2 :])  # repeated
        cases.append(data[: at + 1] + b"\xd9" + data[at + 2 :])  # EOI early
        cases.append(data[: at + 1] + b"\x01" + data[at + 2 :])  # TEM
    for bad in cases:
        assert same(outcome(jpeg.decode_twin, bad), pillow(bad))


def test_bad_dc_approximation_is_refused():
    """A progressive DC scan whose Ah / Al break jdphuff.c's rule (Al = Ah - 1, Al <= 13) is refused, as
    Pillow refuses it."""
    data = (CORPUS / "clean_prog.jpg").read_bytes()
    sos = data.index(b"\xff\xda")
    at = sos + 2 + int.from_bytes(data[sos + 2 : sos + 4], "big") - 1  # the first scan's Ah / Al byte
    for ahal in (0xB4, 0x0E, 0x31):
        bad = data[:at] + bytes([ahal]) + data[at + 1 :]
        assert isinstance(pillow(bad), str)
        with pytest.raises(ValueError, match="0xFFDA: bad progression"):
            jpeg.decode_twin(bad, "f.jpg")


def test_ycbcr_reading_of_other_component_counts_is_refused():
    """libtiff asks libjpeg for YCbCr where a TIFF says so: a frame of 1 or 4 components read so is refused
    (jdcolor.c's JERR_BAD_J_COLORSPACE), not read past its planes."""
    for name in ("clean_grey.jpg", "clean_cmyk.jpg"):
        with pytest.raises(ValueError, match="components read as YCbCr"):
            jpeg.decode_samples((CORPUS / name).read_bytes(), name, "ycbcr")
    assert jpeg.decode_samples((CORPUS / "clean_b420.jpg").read_bytes(), "f", "ycbcr").shape == (72, 96, 3)


# --- the IDCT on out-of-range coefficients


@pytest.mark.parametrize("seed", range(6))
def test_crafted_coefficients_decode_as_pillow(seed):
    """Blocks of chosen quantised coefficients whose products leave 16 bits (DC categories 12-15, AC values
    up to 15 bits, 8- and 16-bit quantisers, blocks of a first row only): Pillow's pixels, which are
    libjpeg-turbo's SIMD IDCT's (the 16-bit product wrapping, pass 1 packed with saturation but its
    first-row shortcut wrapping, the output saturated around 128)."""
    import jpeg_damage_files as files

    rng = np.random.default_rng(seed)
    top = 256 if seed % 2 else 65536
    data = files.coefficient_jpeg(files.extreme_blocks(100 + seed, 5, 7), rng.integers(1, top, 64))
    np.testing.assert_array_equal(jpeg.decode_twin(data, "f.jpg"), pillow(data))


def _jidctint(coef: np.ndarray, q: np.ndarray) -> np.ndarray:
    """jidctint.c's jpeg_idct_islow in full precision, its 10-bit range-limit table at the end."""

    def one_pass(x, shift):
        z1 = (x[2] + x[6]) * 4433
        tmp2, tmp3 = z1 - x[6] * 15137, z1 + x[2] * 6270
        tmp0, tmp1 = (x[0] + x[4]) << 13, (x[0] - x[4]) << 13
        tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
        t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
        z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
        z5 = (z3 + z4) * 9633
        t0, t1, t2, t3 = t0 * 2446, t1 * 16819, t2 * 25172, t3 * 12299
        z1, z2, z3, z4 = z1 * -7373, z2 * -20995, z3 * -16069 + z5, z4 * -3196 + z5
        t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
        return [(v + (1 << (shift - 1))) >> shift for v in (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                                                            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]

    d = (coef * q).reshape(-1, 8, 8)
    ws = np.stack(one_pass([d[:, k, :] for k in range(8)], 11), axis=1)
    x = np.stack(one_pass([ws[:, :, k] for k in range(8)], 18), axis=2)
    return np.clip(((x + 512) & 1023) - 512 + 128, 0, 255).astype(np.uint8)


def test_in_range_blocks_keep_jidctint_arithmetic():
    """Where no sum leaves 16 bits and no sample leaves 0-255 by much, the SIMD arithmetic is jidctint.c's:
    random blocks of a photograph's magnitudes, bit for bit (clean files stay as they were)."""
    rng = np.random.default_rng(0)
    coef = (rng.integers(-24, 25, (20000, 64)) * (rng.random((20000, 64)) < 0.25)).astype(np.int64)
    coef[:, 0] = rng.integers(-60, 61, 20000)
    coef[::3, 8:] = 0  # the first-row shortcut
    q = rng.integers(1, 8, 64)
    np.testing.assert_array_equal(jpeg.idct_islow(coef, q), _jidctint(coef, q))


# --- Pillow's Image.open on junk before markers


def _junk_cases() -> dict:
    data = (CORPUS / "clean_b420.jpg").read_bytes()
    dqt = data.index(b"\xff\xdb")
    sos = data.index(b"\xff\xda")
    return {"clean": data, "junk_before_dqt": data[:dqt] + b"\x12\x34\x00" + data[dqt:],
            "ff00_before_dqt": data[:dqt] + b"\xff\x00" + data[dqt:], "fill_before_sos": data[:sos] + b"\xff\xff" + data[sos:],
            "junk_after_soi": data[:2] + b"\x00\x11" + data[2:], "ff01_before_dqt": data[:dqt] + b"\xff\x01" + data[dqt:],
            "ff12_before_sos": data[:sos] + b"\xff\x12" + data[sos:], "junk_then_ff_at_end": data[:dqt] + b"\x00\xff",
            "eoi_before_frame": data[:dqt] + b"\xff\xd9" + data[dqt:], "junk_before_eoi": data[:-2] + b"\x01\x02\xff\xd9"}


@pytest.mark.parametrize("case", sorted(_junk_cases()))
def test_open_header_and_is_jpeg_agree_with_image_open(case):
    """`is_jpeg` is `Image.open(...).format == "JPEG"` on junk before markers, and the decoders refuse
    what Image.open refuses (its marker walk up to the first scan) and decode the rest to Pillow's pixels."""
    import io

    from PIL import Image

    data = _junk_cases()[case]
    try:
        fmt = Image.open(io.BytesIO(data)).format
    except Exception:  # noqa: BLE001 -- Image.open identifies no image
        fmt = None
    assert jpeg.is_jpeg(data) == (fmt == "JPEG")
    assert same(outcome(jpeg.decode_twin, data), pillow(data))


# --- the three places the JAX package reads an image


def test_dataset_item_from_a_damaged_jpeg_equals_jax(tmp_path):
    """The port's MBEIRCandidatePoolDataset item for a damaged JPEG (flipped bytes, a restart marker dropped)
    equals the JAX package's (fp32), where the port raised before."""
    from tests.helpers import identity_image_transform
    from tests.torch_helpers import on_array
    from uniir_tpu.data import dataset as jax_dataset
    from uniir_tpu_torch.data import dataset

    os.makedirs(tmp_path / "images")
    rows = []
    for k, name in enumerate(("b420_flip.jpg", "rst_rst_missing.jpg", "prog_zeros.jpg", "arith_flip.jpg")):
        (tmp_path / "images" / name).write_bytes((CORPUS / name).read_bytes())
        rows.append(json.dumps({"did": f"9:{k}", "modality": "image", "img_path": f"images/{name}"}))
    (tmp_path / "cand_pool.jsonl").write_text("\n".join(rows) + "\n")
    transform = identity_image_transform(32)
    ours = dataset.MBEIRCandidatePoolDataset(str(tmp_path), "cand_pool.jsonl", on_array(transform), device="cpu")
    theirs = jax_dataset.MBEIRCandidatePoolDataset(str(tmp_path), "cand_pool.jsonl", transform)
    for k in range(len(rows)):
        a, b = ours[k], theirs[k]
        assert a.keys() == b.keys()
        assert a["img"].dtype == b["img"].dtype == np.float32
        np.testing.assert_array_equal(a["img"], b["img"])
        assert {k: v for k, v in a.items() if k != "img"} == {k: v for k, v in b.items() if k != "img"}


def test_image_pass_converts_damaged_jpegs_as_jax_does(tmp_path):
    """Damaged JPEGs Pillow decodes through both image passes: each converted to the JAX pass's JPEG byte for
    byte (the port deleted them as corrupt before), a file Pillow refuses deleted on both sides."""
    from uniir_tpu.data.preprocessing import io_utils as jax_io
    from uniir_tpu_torch.data.preprocessing import io_utils as port_io

    names = ("b444_flip.jpg", "b420_zeros.jpg", "rst_rst_wrong.jpg", "prog_cut.jpg", "grey_flip.jpg",
             "b444_junk_segment.jpg", "refused_unknown_marker.jpg")
    for side, io_utils in (("jax", jax_io), ("port", port_io)):
        (tmp_path / side / "images").mkdir(parents=True)
        for k, name in enumerate(names):  # under .png names: the pass writes each as a .jpg beside it
            (tmp_path / side / "images" / f"{k}.png").write_bytes((CORPUS / name).read_bytes())
        kw = {"device": "cpu"} if side == "port" else {}
        io_utils.parallel_process_image_directory(str(tmp_path / side / "images"), 2, **kw)

    def tree(root: Path) -> dict:
        return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}

    assert tree(tmp_path / "port") == tree(tmp_path / "jax")
    kept = {k for k, name in enumerate(names) if "error" not in DIGESTS[name]}
    assert sorted(os.listdir(tmp_path / "port" / "images")) == sorted(f"{k}.jpg" for k in kept)
    assert len(kept) >= 4


# --- the native decoder (csrc/jpeg.cu, built by nvcc on the card's machine)


@pytest.fixture
def native():
    if not torch.cuda.is_available():
        pytest.skip("needs the card's machine: csrc/jpeg.cu is built by nvcc, which is installed there")
    return jpeg.decode_native


@pytest.mark.gpu
def test_native_on_the_corpus_gives_pillows_outcome(native):
    for name in sorted(DIGESTS):
        got = outcome(native, (CORPUS / name).read_bytes(), name)
        assert digest_outcome(got) == wanted(name), name


@pytest.mark.gpu
def test_native_refuses_a_ycbcr_reading_of_other_component_counts(native):
    for name in ("clean_grey.jpg", "clean_cmyk.jpg"):
        with pytest.raises(ValueError, match="components read as YCbCr"):
            jpeg.decode_samples_native((CORPUS / name).read_bytes(), name, "ycbcr")
    data = (CORPUS / "clean_b420.jpg").read_bytes()
    np.testing.assert_array_equal(jpeg.decode_samples_native(data, "f", "ycbcr"), jpeg.decode_samples(data, "f", "ycbcr"))


@pytest.mark.gpu
@pytest.mark.parametrize("source", SOURCES)
def test_native_equals_twin_on_derivatives(native, source):
    """Every derivative of the CPU tests, native against twin (error messages included)."""
    from concurrent.futures import ThreadPoolExecutor

    files = [derivative(source, kind, seed) for kind in chip_smoke.JPEG_DAMAGE_KINDS for seed in range(SEEDS_PER_KIND)]

    def either(fn, data):
        try:
            return fn(data, "f.jpg")
        except ValueError as err:
            return str(err)

    with ThreadPoolExecutor(8) as pool:
        outs = list(pool.map(lambda d: either(native, d), files))
    for data, got in zip(files, outs):
        want = either(jpeg.decode_twin, data)
        assert same(got, want), (want if isinstance(want, str) else "decoded", got if isinstance(got, str) else "decoded")
