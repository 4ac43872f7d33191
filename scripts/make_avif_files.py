"""Write the AVIF corpus chip_smoke.py decodes on the card, with Pillow's digest of each file.

The card's machine has no Pillow and the port has no AVIF encoder, so the files are made here by Pillow 12.1's
AVIF save (libavif 1.3.0 with aom 3.12.1) and stored under tests/data/avif/ beside `digests.json`: for each
file the shape and the SHA-256 of `Image.open(path).convert("RGB")`'s pixels.  The forms follow the test
matrix (tests/test_torch_avif*.py): the default save at sizes across the 64 x 64 superblock edges, lossless,
each subsampling, limited range, speeds 0 (128 x 128 superblocks, loop restoration) to 10, tiles, the modes
with alpha (premultiplied too), a sequence (its first frame, CDEF), EXIF orientations (irot / imir), and the
colour matrices libyuv converts, written into a default file's nclx box; and, for rates, a 640 x 480 default
and lossless file.  Seeded, so a rerun writes the same bytes; `tests/test_torch_avif.py` checks the digests
still hold.

    python scripts/make_avif_files.py [--out tests/data/avif]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tests"))

import avif_files as files  # noqa: E402

# name -> (mode, height, width, seed, save options)
CORPUS = {
    "01_default_1x1.avif": ("RGB", 1, 1, 1, {}),
    "02_default_5x7.avif": ("RGB", 5, 7, 2, {}),
    "03_default_64x64.avif": ("RGB", 64, 64, 3, {}),
    "04_default_33x65.avif": ("RGB", 33, 65, 4, {}),
    "05_default_70x130.avif": ("RGB", 70, 130, 5, {}),
    "06_default_150x40.avif": ("RGB", 150, 40, 6, {}),
    "07_lossless_444.avif": ("RGB", 40, 48, 7, {"quality": 100, "subsampling": "4:4:4"}),
    "08_q0.avif": ("RGB", 48, 40, 8, {"quality": 0}),
    "09_q95.avif": ("RGB", 40, 40, 9, {"quality": 95}),
    "10_422.avif": ("RGB", 40, 60, 10, {"subsampling": "4:2:2"}),
    "11_444.avif": ("RGB", 45, 37, 11, {"subsampling": "4:4:4", "quality": 60}),
    "12_400_limited.avif": ("L", 45, 33, 12, {"subsampling": "4:0:0", "range": "limited"}),
    "13_limited.avif": ("RGB", 40, 41, 13, {"range": "limited"}),
    "14_speed0_sb128_lr.avif": ("RGB", 80, 96, 14, {"speed": 0, "quality": 60}),
    "15_speed2_lr.avif": ("RGB", 70, 90, 15, {"speed": 2, "quality": 50}),
    "16_speed10.avif": ("RGB", 50, 70, 16, {"speed": 10}),
    "17_tiles.avif": ("RGB", 136, 136, 17, {"tile_rows": 1, "tile_cols": 1}),
    "18_rgba.avif": ("RGBA", 40, 33, 18, {}),
    "19_rgba_premultiplied.avif": ("RGBA", 33, 40, 19, {"alpha_premultiplied": True}),
    "20_la.avif": ("LA", 30, 30, 20, {}),
    "21_sequence_cdef.avif": ("RGB", 48, 64, 21, {"frames": 1}),
    "22_exif_orientation6.avif": ("RGB", 40, 64, 22, {"exif": 6}),
    "23_exif_orientation2.avif": ("RGB", 40, 64, 23, {"exif": 2}),
}
# the colour matrices libyuv converts, in a default file's nclx box: (source, matrix, full range)
MATRICES = {"24_matrix_bt709.avif": ("04_default_33x65.avif", 1, True),
            "25_matrix_bt709_limited.avif": ("04_default_33x65.avif", 1, False),
            "26_matrix_bt2020.avif": ("04_default_33x65.avif", 9, True),
            "27_matrix_bt470bg_limited.avif": ("04_default_33x65.avif", 5, False),
            "28_matrix_unspecified.avif": ("04_default_33x65.avif", 2, True),
            "29_matrix_identity_444.avif": ("11_444.avif", 0, True)}
RATE_FILES = {"30_vga_default.avif": ("RGB", 480, 640, 30, {}),
              "31_vga_lossless.avif": ("RGB", 480, 640, 31, {"quality": 100, "subsampling": "4:4:4"})}


def make(mode, h, w, seed, options) -> bytes:
    options = dict(options)
    if "exif" in options:
        from PIL import Image

        exif = Image.Exif()
        exif[0x0112] = options.pop("exif")
        options["exif"] = exif.tobytes()
    return files.pillow_file(mode, h, w, seed, **options)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(REPO / "tests" / "data" / "avif"))
    args = ap.parse_args()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    blobs = {name: make(*spec) for name, spec in {**CORPUS, **RATE_FILES}.items()}
    for name, (source, matrix, full) in MATRICES.items():
        blobs[name] = files.set_colr(blobs[source], matrix=matrix, full=full)
    digests = {}
    for name in sorted(blobs):
        rgb = files.pillow_rgb(blobs[name])
        if isinstance(rgb, Exception):
            sys.exit(f"{name}: Pillow cannot read it back: {rgb}")
        (out / name).write_bytes(blobs[name])
        digests[name] = {"shape": list(rgb.shape), "sha256": hashlib.sha256(rgb.tobytes()).hexdigest()}
    (out / "digests.json").write_text(json.dumps(digests, indent=1, sort_keys=True) + "\n")
    total = sum(len(b) for b in blobs.values())
    print(f"wrote {len(blobs)} files ({total} bytes) and digests.json to {out}")


if __name__ == "__main__":
    main()
