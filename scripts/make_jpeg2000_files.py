"""Write the JPEG 2000 corpus chip_smoke.py decodes on the card, with Pillow's digest of each file.

The card's machine has no Pillow and no OpenJPEG, and the port has no JPEG 2000 encoder, so the files are
made here, by Pillow 12.1's JPEG 2000 save and by the libopenjp2 Pillow ships (through
tests/openjpeg_ctypes.py), and stored under tests/data/jpeg2000/ beside `digests.json`: for each file the
shape and the SHA-256 of `Image.open(path).convert("RGB")`'s pixels.  The forms follow the test matrix
(tests/test_torch_jpeg2000*.py): Pillow's modes and options, every code-block style, SOP / EPH, tile-parts,
POC, RGN, subsampled components, precisions, packet headers in PPM / PPT, JP2 colour spaces and a
palette; and, for rates, a 640 x 480 file reversible and irreversible and a 1920 x 1080 irreversible one.
Seeded, so a rerun writes the same bytes; `tests/test_torch_jpeg2000.py` checks the digests still hold.

    python scripts/make_jpeg2000_files.py [--out tests/data/jpeg2000]
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tests"))

import jpeg2000_files as files  # noqa: E402
import openjpeg_ctypes as opj  # noqa: E402


def photo(seed: int, h: int, w: int) -> np.ndarray:
    """A smooth RGB picture with mild noise: gradients, a disc and stripes (compresses as a photograph)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    r = (xx * 255 // max(w - 1, 1)).astype(np.int64)
    g = (yy * 255 // max(h - 1, 1)).astype(np.int64)
    disc = ((xx - w * 0.6) ** 2 + (yy - h * 0.4) ** 2 < (min(h, w) * 0.3) ** 2) * 90
    b = (128 + 60 * np.sin(xx / 9.0) * np.cos(yy / 13.0)).astype(np.int64) + disc
    a = np.stack([r, g, b], -1) + rng.integers(-3, 4, (h, w, 3))
    return np.clip(a, 0, 255).astype(np.uint8)


def pillow_save(array: np.ndarray, mode: str, **options) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(array).convert(mode).save(buf, "JPEG2000", **options)
    return buf.getvalue()


def corpus() -> dict:
    """name -> bytes, in a fixed order."""
    out = {}
    k = 0

    def add(name: str, data: bytes, ext: str | None = None) -> None:
        nonlocal k
        ext = ext or ("j2k" if data[:4] == b"\xff\x4f\xff\x51" else "jp2")
        out[f"{k:02d}_{name}.{ext}"] = data
        k += 1

    small = photo(1, 48, 40)
    for mode in ("L", "LA", "RGB", "RGBA"):
        add(f"pillow_{mode.lower()}", pillow_save(small, mode))
        add(f"pillow_{mode.lower()}_irreversible", pillow_save(small, mode, irreversible=True, quality_layers=[12]))
    add("pillow_i16", files.pillow_file("I;16", 48, 40, seed=2))
    mid = photo(3, 120, 160)
    for name, options in {
        "layers_rates": {"quality_layers": [60, 20, 5]},
        "layers_db": {"quality_mode": "dB", "quality_layers": [28, 36, 44]},
        "rlcp": {"progression": "RLCP", "num_resolutions": 4},
        "rpcl": {"progression": "RPCL", "precinct_size": (32, 32)},
        "pcrl": {"progression": "PCRL", "precinct_size": (64, 32), "codeblock_size": (16, 16)},
        "cprl": {"progression": "CPRL", "precinct_size": (32, 64), "irreversible": True},
        "tiles": {"tile_size": (64, 48), "irreversible": True, "quality_layers": [10]},
        "tile_offsets": {"tile_size": (50, 40), "tile_offset": (5, 3), "offset": (9, 7)},
        "mct_off": {"mct": 0, "no_jp2": True}, "one_resolution": {"num_resolutions": 1},
        "signed": {"signed": True}, "plt_comment": {"plt": True, "comment": "corpus"},
    }.items():
        add(name, pillow_save(mid, "RGB", **options))
    for style, bits in {"bypass": opj.BYPASS, "reset": opj.RESET, "termall": opj.TERMALL, "vsc": opj.VSC,
                        "pterm": opj.PTERM, "segsym": opj.SEGSYM, "all_styles": 63}.items():
        add(f"style_{style}", files.opj_file(3, 57, 61, 8, seed=len(style), mode=bits, rates=[8, 0]))
    add("sop_eph", files.opj_file(3, 57, 61, 8, seed=4, csty=6, rates=[10, 3, 0]))
    add("tile_parts_r", files.opj_file(3, 64, 64, 8, seed=5, tp_on=1, tp_flag=ord("R"), rates=[6, 0]))
    add("tile_parts_l", files.opj_file(3, 64, 64, 8, seed=6, tp_on=1, tp_flag=ord("L"), rates=[6, 2, 0]))
    add("poc", files.opj_file(3, 64, 64, 8, seed=7, numresolution=5, rates=[20, 5, 0],
                              pocs=[dict(tile=1, resno0=0, compno0=0, layno1=2, resno1=3, compno1=3, prg1=0),
                                    dict(tile=1, resno0=0, compno0=0, layno1=3, resno1=6, compno1=3, prg1=2)]))
    add("rgn", files.opj_file(3, 57, 61, 8, seed=8, roi_compno=0, roi_shift=5, irreversible=1, rates=[10]))
    add("subsampled_ycc", files.opj_file(3, 61, 57, 8, seed=9, sub=[(1, 1), (2, 2), (2, 2)], x0=1, y0=3))
    add("subsampled_all", files.opj_file(3, 60, 58, 8, seed=10, sub=[(2, 2), (2, 2), (2, 2)]))
    for prec in (1, 4, 12, 16):
        add(f"precision_{prec}", files.opj_file(3, 33, 35, prec, seed=prec, irreversible=int(prec == 12)))
    add("grey_16_signed", files.opj_file(1, 40, 44, 16, seed=11, signed=True))
    sop = files.opj_file(3, 64, 60, 8, seed=12, csty=6, rates=[10, 0])
    add("ppt", files.to_ppt(sop))
    add("ppm", files.to_ppm(sop, 700))
    add("tlm", files.tlm(sop))
    jp2 = pillow_save(photo(13, 64, 72), "RGB")
    add("colr_sycc", files.rebuild_jp2(jp2, lambda sub: [sub[0], files.colr(18)]))
    add("colr_icc", files.rebuild_jp2(jp2, lambda sub: [sub[0], files.colr(method=2, icc=bytes(64))]))
    add("colr_unknown", files.rebuild_jp2(jp2, lambda sub: [sub[0], files.colr(99)]))
    cmyk = pillow_save(np.dstack([photo(14, 64, 72), photo(15, 64, 72)[..., :1]]), "RGBA")
    add("colr_cmyk", files.rebuild_jp2(cmyk, lambda sub: [sub[0], files.colr(12)]))
    rng = np.random.default_rng(16)
    add("palette", files.palette_file([tuple(int(v) for v in rng.integers(0, 256, 3)) for _ in range(40)], 3))
    add("palette_rgba", files.palette_file([tuple(int(v) for v in rng.integers(0, 256, 4)) for _ in range(20)], 4))
    add("l_tiles_five_levels", pillow_save(mid, "L", tile_size=(64, 64), num_resolutions=5))
    add("rgba_layers", pillow_save(np.dstack([mid, mid[..., :1]]), "RGBA", quality_layers=[30, 8]))
    add("i16_irreversible", files.pillow_file("I;16", 50, 46, seed=19, irreversible=True))
    add("codeblock_64x64", pillow_save(mid, "RGB", codeblock_size=(64, 64), irreversible=True))
    add("style_bypass_irreversible", files.opj_file(3, 57, 61, 8, seed=20, mode=opj.BYPASS, irreversible=1,
                                                    tcp_mct=1, rates=[12, 4]))
    add("two_components_6bit", files.opj_file(2, 41, 39, 6, seed=21, rates=[5, 0]))
    add("res_box", files.rebuild_jp2(jp2, lambda sub: sub + [(b"res ", files.box(b"resc", bytes([0, 1, 0, 1, 0, 1,
                                                                                               0, 1, 0, 0])))]))
    add("odd_origin", files.opj_file(3, 63, 59, 8, seed=22, x0=3, y0=5, numresolution=5, irreversible=1,
                                     tcp_mct=1))
    vga = photo(17, 480, 640)
    add("vga_lossless", pillow_save(vga, "RGB"))
    add("vga_irreversible", pillow_save(vga, "RGB", irreversible=True, quality_layers=[16]))
    add("vga_irreversible", pillow_save(vga, "RGB", irreversible=True, quality_layers=[16], no_jp2=True))
    add("hd_irreversible", pillow_save(photo(18, 1080, 1920), "RGB", irreversible=True, quality_layers=[40]))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(REPO / "tests" / "data" / "jpeg2000"))
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for old in out.iterdir():
        old.unlink()
    digests = {}
    for name, data in corpus().items():
        (out / name).write_bytes(data)
        rgb = files.pillow_rgb(data)
        if isinstance(rgb, Exception):
            raise RuntimeError(f"Pillow cannot read {name}: {rgb}")
        digests[name] = {"shape": list(rgb.shape), "sha256": hashlib.sha256(rgb.tobytes()).hexdigest()}
    (out / "digests.json").write_text(json.dumps(digests, indent=1) + "\n")
    total = sum((out / n).stat().st_size for n in digests)
    print(f"{len(digests)} files, {total} bytes, in {out}")


if __name__ == "__main__":
    main()
