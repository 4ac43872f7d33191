"""The offline M-BEIR construction (`uniir_tpu_torch.data.preprocessing`)
against the JAX package's (`uniir_tpu.data.preprocessing`): the ten
converters' CLIs on two copies of one seeded raw tree (chip_smoke.py's
`write_raw_trees` at a small size: every image form the image pass reads,
a missing image, a truncated JPEG, an HTML page under a .jpg name), every file written compared byte for
byte -- JSON lines, candidate pools, the JPEG files of the image pass --,
the files deleted and the printed statistics; then the union generator with
one seeded `random.Random` on each side.  Also: a file of a format the port
does not decode yet is left in place and counted, a failed native build
raises and deletes nothing, `is_valid_image` is Pillow's `format == "JPEG"`.

Each converter runs as `python -m` would run it, in a process of its own
(its image pass's spawn pool at 2 workers, the OVEN pool at 2 chunks)."""

import json
import os
import random
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

import chip_smoke

REPO = Path(__file__).resolve().parent.parent
COUNTS = {"mscoco": 15, "cirr": 8, "fashioniq": 9, "fashion200k": 8, "edis": 6, "nights": 4, "visualnews": 12,
          "webqa": 6, "oven": 6}
SIDE = 0.06  # 640 x 480 -> 38 x 29
RUNNER = (  # a converter's main with its pools held to 2 processes
    "import runpy, sys\n"
    "pkg, name = sys.argv[1], sys.argv[2]\n"
    "io_utils = __import__(pkg + '.data.preprocessing.io_utils', fromlist=['x'])\n"
    "io_utils.cpu_count = lambda: 2\n"
    "oven = __import__(pkg + '.data.preprocessing.oven', fromlist=['x'])\n"
    "oven.cpu_count = lambda: 8\n"
    "sys.argv = [name] + sys.argv[3:]\n"
    "runpy.run_module(pkg + '.data.preprocessing.' + name, run_name='__main__', alter_sys=True)\n"
)


def run_converter(pkg: str, name: str, tree: Path, extra=()) -> subprocess.CompletedProcess:
    args = [sys.executable, "-c", RUNNER, pkg, name, "--mbeir_data_dir", str(tree),
            *map(str, chip_smoke.converter_args(name)), *extra]
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    return subprocess.run(args, cwd=REPO, env=env, capture_output=True, text=True, timeout=300)


def normalised(stdout: str, tree: Path) -> list:
    """Lines with the tree's root replaced and the decoders' own words cut from "Error processing" lines
    (Pillow's messages are not the port's); the pool's lines, printed by its workers in any order, sorted."""
    lines = stdout.replace(str(tree), "<tree>").splitlines()
    errors = sorted(line.split(" Message: ")[0] for line in lines if line.startswith("Error processing"))
    return [line for line in lines if not line.startswith("Error processing")] + errors


def tree_files(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The raw tree, and the JAX package's and the port's runs of every converter over copies of it."""
    root = tmp_path_factory.mktemp("construction")
    raw = chip_smoke.write_raw_trees(root / "raw", COUNTS, SIDE, refused=False)
    trees = {"jax": root / "jax", "port": root / "port"}
    for tree in trees.values():
        shutil.copytree(root / "raw", tree)
    runs = {}

    def convert(side: str) -> None:
        pkg = "uniir_tpu" if side == "jax" else "uniir_tpu_torch"
        for name in chip_smoke.P13_CONVERTERS:  # in order: InfoSeek reads OVEN's images
            extra = ["--device", "cpu"] if side == "port" and name != "infoseek" else []
            runs[side, name] = run_converter(pkg, name, trees[side], extra)
            assert runs[side, name].returncode == 0, runs[side, name].stderr[-3000:]

    with ThreadPoolExecutor(2) as pool:
        list(pool.map(convert, trees))
    return {"raw": raw, "root": root, "trees": trees, "runs": runs,
            "files": {side: tree_files(tree) for side, tree in trees.items()}}


@pytest.mark.parametrize("name", chip_smoke.P13_CONVERTERS)
def test_converter_outputs_and_statistics_match_jax(built, name):
    """Every file under the converter's src_data/ directory and its image directory, byte for byte, and its
    printed lines (statistics, warnings, the pass's counts)."""
    images = "oven" if name == "infoseek" else name
    prefixes = (f"src_data/{name}/", f"mbeir_images/{images}_images/")
    jax_files, port_files = ({k: v for k, v in built["files"][side].items() if k.startswith(prefixes)}
                             for side in ("jax", "port"))
    assert sorted(port_files) == sorted(jax_files)
    assert any(k.endswith(".jsonl") and k.startswith(f"src_data/{name}/mbeir_") for k in jax_files)
    differ = [k for k in jax_files if jax_files[k] != port_files[k]]
    assert not differ, differ[:5]
    jax_out, port_out = (normalised(built["runs"][side, name].stdout, built["trees"][side]) for side in ("jax", "port"))
    assert port_out == jax_out


def test_image_pass_deletes_what_jax_deletes_and_writes_every_form(built):
    """The same files are gone on both sides -- the truncated JPEG, the HTML page no reader identifies, each
    source a .jpg replaced -- and every form of P13_FORMS and MSCOCO's JP2 file went through the pass (its
    .jpg written, equal above)."""
    raw = built["raw"]["images"]
    gone = {side: sorted(p for p in raw if not (built["trees"][side] / Path(p).relative_to(built["root"] / "raw")).exists())
            for side in ("jax", "port")}
    assert gone["port"] == gone["jax"]
    assert built["raw"]["truncated"] in gone["jax"] and built["raw"]["garbage"] in gone["jax"]
    written = {Path(p).relative_to(built["root"] / "raw").with_suffix(".jpg").as_posix(): form for p, form in raw.items()}
    forms = {form for rel, form in written.items() if rel in built["files"]["port"] and form not in ("truncated", "garbage")}
    assert forms == set(chip_smoke.P13_FORMS) | {"jp2"}
    counts = [line for line in built["runs"]["port", "mscoco"].stdout.splitlines() if line.startswith("Number of c")]
    assert counts == ["Number of corrupted files: 2"]


def test_generator_matches_jax(built, tmp_path):
    """Union pools, the union train split (shuffled, and up-sampled to small targets) from one seeded
    random.Random on each side, task ids, qrels and the held-out splits, byte for byte."""
    from uniir_tpu.data.preprocessing import generator as jax_gen
    from uniir_tpu_torch.data.preprocessing import generator as port_gen

    small = {k: {**v, "target": 7} for k, v in jax_gen.DEFAULT_DATASETS_INFO.items()}
    out = {}
    for side, gen in (("jax", jax_gen), ("port", port_gen)):
        tree = tmp_path / side
        shutil.copytree(built["trees"][side] / "src_data", tree / "src_data")
        chip_smoke.arrange_for_generator(tree)
        d = str(tree)
        gen.generate_union_train_cand_pool(d)
        gen.generate_union_all_cand_pool(d)
        gen.unify_train_data(d, upsample=False, rng=random.Random(3))
        gen.unify_train_data(d, upsample=True, datasets_info=small, rng=random.Random(4))
        gen.assign_task_ids(d)
        gen.generate_qrels(d)
        gen.generate_held_n_dataset_out_data(d)
        gen.generate_held_n_task_out_data(d)
        gen.generate_held_1_domain_out_data(d)
        out[side] = tree_files(tree)
    assert sorted(out["port"]) == sorted(out["jax"])
    assert [k for k in out["jax"] if out["jax"][k] != out["port"][k]] == []
    union = out["port"]["train/union_train/mbeir_union_up_train.jsonl"].decode().splitlines()
    sizes = {name: len(out["port"][f"train/mbeir_{name.lower()}_train.jsonl"].decode().splitlines())
             for name in small}
    assert len(union) == sum(max(n, 7) if small[name]["up_sampling"] else n for name, n in sizes.items())
    assert all("task_id" in json.loads(line) for line in union)


def small_tree(root: Path) -> dict:
    """An image directory of three files: a baseline JPEG, a truncated one and an EPS file named .png."""
    files = {"ok.jpg": chip_smoke.raw_file("jpeg", 1, 40, 30), "cut.jpg": chip_smoke.raw_file("truncated", 2, 40, 30),
             "odd.png": chip_smoke.raw_file("eps", 3, 40, 30)}
    for name, data in files.items():
        (root / "images").mkdir(parents=True, exist_ok=True)
        (root / "images" / name).write_bytes(data)
    return files


def test_a_format_not_decoded_yet_is_left_in_place_and_counted(tmp_path, capfd):
    """The JAX pass deletes an EPS file Pillow cannot load (no Ghostscript); the port, which does not decode
    EPS, leaves it and names it."""
    from uniir_tpu.data.preprocessing import io_utils as jax_io
    from uniir_tpu_torch.data.preprocessing import io_utils as port_io

    for side, io_utils in (("jax", jax_io), ("port", port_io)):
        small_tree(tmp_path / side)
        kw = {"device": "cpu"} if side == "port" else {}
        assert io_utils.parallel_process_image_directory(str(tmp_path / side / "images"), 2, **kw) == \
            (2 if side == "jax" else 1)
    assert sorted(os.listdir(tmp_path / "jax" / "images")) == ["ok.jpg"]
    assert sorted(os.listdir(tmp_path / "port" / "images")) == ["odd.png", "ok.jpg"]
    assert (tmp_path / "port/images/ok.jpg").read_bytes() == (tmp_path / "jax/images/ok.jpg").read_bytes()
    out = capfd.readouterr().out
    assert f"Unsupported image format, left in place: {tmp_path / 'port/images/odd.png'}" in out
    assert "Number of files left in place (format not decoded yet): 1" in out


def raster_tree(root: Path) -> dict:
    """An image directory of one file of each raster format the raw trees do not hold (DIB, QOI, TGA, SGI, PCX,
    DCX, Sun raster, MSP, XBM, XPM, IM), each under a name the pass picks up, and a TGA cut short."""
    img = chip_smoke.raw_image(5, 40, 30)
    grey = img.mean(axis=2).astype(np.uint8)
    bits = np.packbits(grey > 127, axis=1, bitorder="little")
    xbm = (b"#define im_width 40\n#define im_height 30\nstatic char im_bits[] = {\n"
           + b",".join(b"0x%02x" % v for v in bits.ravel()) + b"\n};\n")
    keys = [bytes([c]) for c in b"abcdefgh"]
    level = (grey >> 5).astype(np.int64)
    xpm = b"\n".join([b"/* XPM */", b"static char *x[] = {", b'"40 30 8 1",']
                     + [b'"%s c #%02x%02x%02x",' % (k, 32 * i, 255 - 32 * i, 17 * i) for i, k in enumerate(keys)]
                     + [b'"' + b"".join(keys[v] for v in row) + b'",' for row in level] + [b"};"]) + b"\n"
    im = b"Image type: RGB image\r\nImage size (x*y): 40*30\r\n\x1a" \
        + np.ascontiguousarray(img[::-1].transpose(0, 2, 1)).tobytes()
    files = {"dib.png": chip_smoke.bmp_bytes(img, 24)[14:], "qoi.png": chip_smoke.qoi_bytes(img),
             "tga.jpg": chip_smoke.tga_bytes(img), "sgi.png": chip_smoke.sgi_bytes(img),
             "pcx.png": chip_smoke.pcx_bytes(img), "dcx.png": chip_smoke.dcx_bytes([chip_smoke.pcx_bytes(img)]),
             "sun.png": chip_smoke.sun_bytes(img), "msp.png": chip_smoke.msp_bytes(grey > 127),
             "xbm.png": xbm, "xpm.png": xpm, "im.png": im, "cut.png": chip_smoke.tga_bytes(img)[:900]}
    for name, data in files.items():
        (root / "images").mkdir(parents=True, exist_ok=True)
        (root / "images" / name).write_bytes(data)
    return files


def test_image_pass_on_the_raster_formats_writes_what_jax_writes(tmp_path):
    """One file of each of the raster formats through both image passes: every JPEG the JAX pass writes, byte
    for byte, the sources deleted on both sides, and the TGA cut short deleted and counted on both."""
    from uniir_tpu.data.preprocessing import io_utils as jax_io
    from uniir_tpu_torch.data.preprocessing import io_utils as port_io

    for side, io_utils in (("jax", jax_io), ("port", port_io)):
        raster_tree(tmp_path / side)
        kw = {"device": "cpu"} if side == "port" else {}
        assert io_utils.parallel_process_image_directory(str(tmp_path / side / "images"), 2, **kw) == 1
    names = sorted(os.listdir(tmp_path / "jax" / "images"))
    assert names == sorted(f"{name.split('.')[0]}.jpg" for name in raster_tree(tmp_path / "names") if name != "cut.png")
    assert tree_files(tmp_path / "port") == tree_files(tmp_path / "jax")


def container_tree(root: Path) -> dict:
    """An image directory of PSD (PackBits RGB, raw CMYK), DDS (BC7, BC1, 16-bit masks) and ICNS (RLE) files
    under names the pass picks up, a DDS cut short and a PSD no reader identifies."""
    img = chip_smoke.raw_image(6, 40, 30)
    planes = np.ascontiguousarray(img.transpose(2, 0, 1))
    cmyk = np.concatenate([planes, planes[:1] // 2])
    rng = np.random.default_rng(6)
    icon = np.ascontiguousarray(np.resize(img, (32, 32, 3)))
    files = {"psd.png": chip_smoke.psd_bytes(planes, "RGB"), "cmyk.jpg": chip_smoke.psd_bytes(cmyk, "CMYK", compression=0),
             "bc7.png": chip_smoke.dds_bytes(chip_smoke.bc7_mode6(img), 40, 30, dxgi=98),
             "bc1.jpg": chip_smoke.dds_bytes(chip_smoke.bc_blocks("bc1", rng, 40, 30), 40, 30, fourcc=b"DXT1"),
             "masks.png": chip_smoke.dds_bytes(rng.bytes(2 * 40 * 30), 40, 30, flags=chip_smoke.DDS_PF["rgb"],
                                               bitcount=16, masks=(0xF800, 0x7E0, 0x1F, 0)),
             "icns.png": chip_smoke.icns_bytes(chip_smoke.icns_rle_entries(icon, icon[..., 0])),
             "cut.png": chip_smoke.dds_bytes(chip_smoke.bc7_mode6(img), 40, 30, dxgi=98)[:400],
             "odd.png": chip_smoke.raw_file("psd", 7, 40, 30)}
    for name, data in files.items():
        (root / "images").mkdir(parents=True, exist_ok=True)
        (root / "images" / name).write_bytes(data)
    return files


def test_image_pass_on_the_container_formats_writes_what_jax_writes(tmp_path):
    """One file of each PSD / DDS / ICNS form through both image passes: every JPEG the JAX pass writes, byte
    for byte, the sources deleted on both sides, the DDS cut short and the PSD no reader identifies deleted
    and counted on both."""
    from uniir_tpu.data.preprocessing import io_utils as jax_io
    from uniir_tpu_torch.data.preprocessing import io_utils as port_io

    for side, io_utils in (("jax", jax_io), ("port", port_io)):
        container_tree(tmp_path / side)
        kw = {"device": "cpu"} if side == "port" else {}
        assert io_utils.parallel_process_image_directory(str(tmp_path / side / "images"), 2, **kw) == 2
    names = sorted(os.listdir(tmp_path / "jax" / "images"))
    assert names == sorted(f"{name.split('.')[0]}.jpg" for name in container_tree(tmp_path / "names")
                           if name not in ("cut.png", "odd.png"))
    assert tree_files(tmp_path / "port") == tree_files(tmp_path / "jax")


def test_a_failed_native_build_raises_and_deletes_nothing(tmp_path, monkeypatch):
    """On a CUDA run the libraries are built before the first file and outside the pass's try: a failed
    nvcc is not corrupt data."""
    from uniir_tpu_torch import _build
    from uniir_tpu_torch.data.preprocessing import io_utils

    files = small_tree(tmp_path)

    def broken(names):
        raise RuntimeError("nvcc failed for jpeg.cu")

    monkeypatch.setattr(_build, "build_all", broken)
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc failed"):
        io_utils.parallel_process_image_directory(str(tmp_path / "images"), 2, device="cuda")
    for name in files:
        with pytest.raises(RuntimeError, match="nvcc failed"):
            io_utils.resize_and_convert_image_to_jpg(str(tmp_path / "images" / name), device="cuda")
    assert {p.name: p.read_bytes() for p in (tmp_path / "images").iterdir()} == files


def test_the_cli_runs_on_the_card_by_default(tmp_path):
    """--device is the card unless named: without one the image pass raises before touching a file."""
    files = small_tree(tmp_path)
    args = [sys.executable, "-c", "import torch; torch.cuda.is_available = lambda: False\n" + RUNNER,
            "uniir_tpu_torch", "nights", "--mbeir_data_dir", str(tmp_path), "--nights_images_dir", "images",
            "--enable_image_processing"]
    proc = subprocess.run(args, cwd=REPO, env={**os.environ, "PYTHONPATH": str(REPO)}, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0 and "no CUDA device found" in proc.stderr
    assert {p.name: p.read_bytes() for p in (tmp_path / "images").iterdir()} == files


def test_is_valid_image_is_pillows_jpeg_format(tmp_path):
    """A header parse: a JPEG cut in its scan is valid; other formats, a JPEG without a frame, an
    MPO file (an MPF index naming two images), an empty or missing file are not."""
    from uniir_tpu.data.preprocessing.io_utils import is_valid_image as jax_valid
    from uniir_tpu_torch.data.preprocessing.io_utils import is_valid_image as port_valid

    jpeg = chip_smoke.raw_file("jpeg", 4, 33, 17)
    ifd = (2).to_bytes(2, "big") + bytes.fromhex("b001 0004 00000001 00000002") + bytes.fromhex("b002 0007 00000020")
    ifd += (8 + len(ifd) + 8).to_bytes(4, "big") + bytes(4)
    mpf = b"MPF\0MM\x00\x2a" + (8).to_bytes(4, "big") + ifd + bytes.fromhex("00030000" + "00" * 12) + bytes(16)
    cases = {"jpeg": jpeg, "cut": jpeg[: jpeg.index(b"\xff\xda") + 20], "cut_header": jpeg[:300], "comment": chip_smoke.raw_file("jpeg_comment", 5, 9, 9),
             "cmyk": chip_smoke.raw_file("jpeg_cmyk", 6, 20, 20), "png": chip_smoke.raw_file("png_rgb", 7, 8, 8),
             "no_frame": jpeg[:2] + jpeg[jpeg.index(b"\xff\xda"):], "header_only": jpeg[:jpeg.index(b"\xff\xda") + 2],
             "bad_marker": jpeg[:2] + b"\xff\x01" + jpeg[2:], "mpo": jpeg[:2] + chip_smoke._jpeg_segment(0xE2, mpf) + jpeg[2:],
             "empty": b"", "12bit": jpeg.replace(b"\xff\xc0\x00\x11\x08", b"\xff\xc0\x00\x11\x0c", 1)}
    for name, data in cases.items():
        (tmp_path / f"{name}.jpg").write_bytes(data)
    got = {name: port_valid(str(tmp_path / f"{name}.jpg")) for name in [*cases, "missing"]}
    assert got == {name: jax_valid(str(tmp_path / f"{name}.jpg")) for name in [*cases, "missing"]}
    assert got["cut"] and not got["png"] and not got["mpo"] and got["jpeg"], got


def test_webqa_images_written_as_pillow_writes_them(tmp_path):
    """WebQA's base64 images through `decode_webqa_images` (convert("RGB"), save at Pillow's defaults, the
    comment carried): equal to the JAX package's files; a format not decoded yet is written as it is."""
    import base64

    from uniir_tpu.data.preprocessing.webqa import decode_webqa_images as jax_decode
    from uniir_tpu_torch.data.preprocessing.webqa import decode_webqa_images as port_decode

    blobs = [chip_smoke.raw_file(form, 10 + k, 37, 23) for k, form in enumerate(chip_smoke.P13_FORMS)]
    tsv, offsets = b"", []
    for k, data in enumerate(blobs):
        offsets.append(len(tsv))
        tsv += f"{k}\t".encode() + base64.b64encode(data) + b"\n"
    (tmp_path / "imgs.tsv").write_bytes(tsv)
    (tmp_path / "imgs.lineidx").write_text("".join(f"{o}\n" for o in offsets))
    assert jax_decode(str(tmp_path / "imgs.tsv"), str(tmp_path / "imgs.lineidx"), str(tmp_path / "jax")) == len(blobs)
    assert port_decode(str(tmp_path / "imgs.tsv"), str(tmp_path / "imgs.lineidx"), str(tmp_path / "port"),
                       "cpu") == len(blobs)
    assert tree_files(tmp_path / "port") == tree_files(tmp_path / "jax")
    eps = chip_smoke.raw_file("eps", 1, 8, 8)
    (tmp_path / "imgs.tsv").write_bytes(b"7\t" + base64.b64encode(eps) + b"\n")
    (tmp_path / "imgs.lineidx").write_text("0\n")
    port_decode(str(tmp_path / "imgs.tsv"), str(tmp_path / "imgs.lineidx"), str(tmp_path / "refused"), "cpu")
    assert (tmp_path / "refused/7.jpg").read_bytes() == eps


def test_resize_sizes_and_comment_carried(tmp_path):
    """The short side to 256 with the reference's round() for the long one, the comment of each source kind
    in the JPEG's COM segment (a PNG's latin-1 text as UTF-8), bit-equal to the JAX pass."""
    from PIL import Image

    from uniir_tpu.data.preprocessing.io_utils import resize_and_convert_image_to_jpg as jax_pass
    from uniir_tpu_torch.data.preprocessing.io_utils import resize_and_convert_image_to_jpg as port_pass

    cases = {"wide": ("jpeg", 301, 97), "tall": ("jpeg_comment", 13, 200), "square": ("png_comment", 50, 50),
             "gif": ("gif_comment", 77, 31), "one": ("jpeg", 1, 9)}
    for name, (form, w, h) in cases.items():
        for side in ("jax", "port"):
            (tmp_path / side).mkdir(exist_ok=True)
            (tmp_path / side / f"{name}.png").write_bytes(chip_smoke.raw_file(form, len(name), w, h))
        assert jax_pass(str(tmp_path / "jax" / f"{name}.png"))
        assert port_pass(str(tmp_path / "port" / f"{name}.png"), device="cpu")
        got = (tmp_path / "port" / f"{name}.jpg").read_bytes()
        assert got == (tmp_path / "jax" / f"{name}.jpg").read_bytes()
        assert min(Image.open(tmp_path / "port" / f"{name}.jpg").size) == 256
    assert b"\xff\xfe\x00\x09caf\xc3\xa9 6" in (tmp_path / "port/square.jpg").read_bytes()
    assert np.asarray(Image.open(tmp_path / "port/one.jpg")).shape == (round(9 * 256 / 1), 256, 3)


def test_the_pass_times_its_own_stages(tmp_path):
    """`timings` gathers the seconds of each stage of the files written; a dropped file adds only the stages
    it reached; the files are the same as without it."""
    from uniir_tpu_torch.data.preprocessing.io_utils import resize_and_convert_image_to_jpg

    for side in ("timed", "plain"):
        small_tree(tmp_path / side)
    timings = {}
    for name in ("ok.jpg", "cut.jpg"):
        got = resize_and_convert_image_to_jpg(str(tmp_path / "timed/images" / name), device="cpu", timings=timings)
        assert got is (name == "ok.jpg")
        resize_and_convert_image_to_jpg(str(tmp_path / "plain/images" / name), device="cpu")
    assert sorted(timings) == ["comment", "decode", "encode", "read", "resize", "write"]
    assert all(v >= 0 for v in timings.values())
    assert tree_files(tmp_path / "timed") == tree_files(tmp_path / "plain")
