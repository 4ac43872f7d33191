"""Decode rates of the image forms read since the damaged-lossless-JPEG / rare-plugin slice, at 640 x 480 on one
thread: damaged lossless (SOF3) JPEG, predicted and damaged subsampled YCbCr TIFF, McIdas, PIXAR, SPIDER,
XVThumb, GBR, IMT, FTEX and BLP files of the seeded writers (chip_smoke.py, tests/rare_format_files.py), then
FITS (BITPIX 8, 16, -32, GZIP_1 tiles), FLI 320 x 200 (BRUN), FLC (BRUN + SS2), PCD (768 x 512) and IPTC (raw,
JPEG) files (`chip_smoke.plugin_rate_files`), then AVIF files of the stored corpus (tests/data/avif, written by
scripts/make_avif_files.py: Pillow's default save and its lossless 4:4:4 save at 640 x 480).  Each
file is decoded as a run on `--device` decodes it (`jpeg.decode_image`: the native libraries on a CUDA run's
host, the twins on a CPU run), after one warm-up call, median of `--repeats` calls.  Prints one line a file and
the card's name and power limit (nvidia-smi) where there is one.

    python scripts/rare_format_rates.py [--device cuda] [--repeats 5] [--only fits,fli,flc,pcd,iptc,avif]
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402
import rare_format_files as rare  # noqa: E402


def files() -> dict:
    w, h = 640, 480
    rgb = chip_smoke.raw_image(1, w, h)
    grey = rgb[..., 1]
    rng = np.random.default_rng(2)
    lossless = chip_smoke.jpeg_bytes(rgb, form="rgb", coding="lossless", predictor=4, restart=4)
    lo, hi = chip_smoke.jpeg_scan_span(lossless)
    flipped = bytearray(lossless)
    for at in rng.integers(lo, hi, 3):
        flipped[int(at)] ^= 0x5A
    ycc = chip_smoke.tiff_bytes(rgb, 6, compression=5, subsampling=(2, 2), predictor=2, rows_per_strip=16)
    from uniir_tpu_torch.data import tiff

    t = tiff.parse(ycc)
    at = int(t.tags[273][3]) + 5
    return {
        "jpeg_lossless_rgb_restart": lossless,
        "jpeg_lossless_rgb_flipped": bytes(flipped),
        "jpeg_lossless_rgb_cut": lossless[: (lo + hi) // 2] + b"\xff\xd9",
        "tiff_ycbcr22_predictor2_lzw": ycc,
        "tiff_ycbcr22_predictor2_deflate": chip_smoke.tiff_bytes(rgb, 6, compression=8, subsampling=(2, 2),
                                                                 predictor=2, rows_per_strip=16),
        "tiff_ycbcr22_lzw_damaged": ycc[:at] + bytes([ycc[at] ^ 0x5A]) + ycc[at + 1:],
        "mcidas_l": rare.mcidas_bytes(grey, prefix=8),
        "mcidas_i16": rare.mcidas_bytes(grey.astype(np.uint16) * 3),
        "pixar": rare.pixar_bytes(rgb),
        "spider": rare.spider_bytes(grey.astype(np.float32) * 1.5 - 20),
        "xvthumb": rare.xvthumb_bytes(rng.integers(0, 256, (h, w))),
        "gbr_rgba": rare.gbr_bytes(np.concatenate([rgb, grey[..., None]], axis=2)),
        "imt": rare.imt_bytes(grey),
        "ftex_bc1": chip_smoke.ftex_bytes(w, h, 0, chip_smoke.dxt1_encode(rgb)),
        "ftex_rgb": chip_smoke.ftex_bytes(w, h, 1, rgb.tobytes()),
        **{form: chip_smoke.blp_bytes(form, rgb, np.random.default_rng(k)) for k, form in enumerate(chip_smoke.BLP_FORMS)},
        **chip_smoke.plugin_rate_files(),
        "avif_vga_default": (chip_smoke.AVIF_CORPUS / "30_vga_default.avif").read_bytes(),
        "avif_vga_lossless": (chip_smoke.AVIF_CORPUS / "31_vga_lossless.avif").read_bytes(),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--only", default="", help="comma-separated name prefixes of the files to time (all by default)")
    args = ap.parse_args(argv)
    from uniir_tpu_torch.data import jpeg

    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip()
    except FileNotFoundError:
        smi = "no nvidia-smi"
    for name, data in files().items():
        if args.only and not name.startswith(tuple(args.only.split(","))):
            continue
        out = jpeg.decode_image(data, name, args.device)  # warm-up: builds and loads the native libraries
        times = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            jpeg.decode_image(data, name, args.device)
            times.append(time.perf_counter() - t0)
        ms = statistics.median(times) * 1e3
        h, w = out.shape[:2]
        print(f"{name}: {w} x {h}, {len(data)} bytes, {jpeg.image_format(data)}: {ms:.3f} ms a decode, "
              f"{1e3 / ms:.1f} images/s, {w * h / ms / 1e3:.2f} Mpixel/s on one thread ({args.device}; card {smi})")


if __name__ == "__main__":
    main()
