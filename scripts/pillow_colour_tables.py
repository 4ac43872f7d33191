"""Derive and check the colour tables the port's image decoders hold for
Pillow's own colour conversions, against Pillow on this host.

  * YCbCr -> RGB (an IM file in YCbCr; `data/im.py::ycbcr_to_rgb`): the four
    fixed-point tables of Pillow's ConvertYCbCr.c, computed in code.  The
    check converts all 2^24 (Y, Cb, Cr) triples with Pillow and with the port.
  * LAB -> RGB (a PSD file in Lab mode; `data/psd.py::lab_to_rgb`): Pillow's
    convert runs a LittleCMS transform from its Lab profile to sRGB, which
    LittleCMS evaluates for 8-bit input as tetrahedral interpolation in a
    33^3 grid of 16-bit nodes.  `--write-lab` samples the unoptimized
    transform at the grid's nodes through the LittleCMS library Pillow
    ships (ctypes) and writes them, second-differenced and xz-compressed,
    to `uniir_tpu_torch/data/lab_srgb_nodes.xz`; the check converts all 2^24
    (L, a, b) triples with Pillow and with the port.

Usage: python scripts/pillow_colour_tables.py [--write-lab]
Prints one line a table and exits non-zero where the port differs.
"""

from __future__ import annotations

import argparse
import ctypes
import lzma
import os
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

NODES = Path(__file__).resolve().parent.parent / "uniir_tpu_torch" / "data" / "lab_srgb_nodes.xz"
GRID = 33


def all_triples() -> np.ndarray:
    v = np.arange(1 << 24, dtype=np.uint32)
    return np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], axis=1).astype(np.uint8)


def pillow_convert(mode: str, px: np.ndarray) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.fromarray(px.reshape(4096, 4096, 3), mode).convert("RGB")).reshape(-1, 3)


def lab_nodes_from_lcms() -> np.ndarray:
    """uint16 [33, 33, 33, 3]: Pillow's Lab -> sRGB transform, unoptimized, at the grid's 16-bit nodes."""
    import PIL

    libs = Path(PIL.__file__).resolve().parent.parent / "pillow.libs"
    lib = ctypes.CDLL(str(next(libs.glob("liblcms2*"))))
    lib.cmsCreateLab4Profile.restype = ctypes.c_void_p
    lib.cmsCreateLab4Profile.argtypes = [ctypes.c_void_p]
    lib.cmsCreate_sRGBProfile.restype = ctypes.c_void_p
    lib.cmsCreateTransform.restype = ctypes.c_void_p
    lib.cmsCreateTransform.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p, ctypes.c_uint32,
                                       ctypes.c_uint32, ctypes.c_uint32]
    lib.cmsDoTransform.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32]
    lab16 = 10 << 16 | 3 << 3 | 2  # TYPE_Lab_16: PT_Lab, 3 channels, 2 bytes
    rgb16 = 4 << 16 | 3 << 3 | 2  # TYPE_RGB_16
    no_optimize = 0x0100
    xform = lib.cmsCreateTransform(lib.cmsCreateLab4Profile(None), lab16, lib.cmsCreate_sRGBProfile(), rgb16, 0,
                                   no_optimize)
    q = np.floor(np.arange(GRID) * 65535.0 / (GRID - 1) + 0.5).astype(np.uint16)  # _cmsQuantizeVal
    inp = np.ascontiguousarray(np.stack(np.meshgrid(q, q, q, indexing="ij"), axis=-1).reshape(-1, 3))
    out = np.zeros_like(inp)
    lib.cmsDoTransform(xform, inp.ctypes.data, out.ctypes.data, len(inp))
    return out.reshape(GRID, GRID, GRID, 3)


def write_lab_nodes() -> None:
    nodes = lab_nodes_from_lcms()
    d2 = np.diff(np.diff(nodes, axis=2, prepend=np.uint16(0)), axis=2, prepend=np.uint16(0))  # wraps mod 2^16
    NODES.write_bytes(lzma.compress(d2.astype("<u2").tobytes(), preset=9 | lzma.PRESET_EXTREME))
    print(f"wrote {NODES} ({NODES.stat().st_size} bytes)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--write-lab", action="store_true", help="derive the Lab grid's nodes and write them first")
    args = ap.parse_args(argv)
    if args.write_lab:
        write_lab_nodes()
    from uniir_tpu_torch.data import im, psd

    px = all_triples()
    failed = 0
    for mode, port in (("YCbCr", im.ycbcr_to_rgb), ("LAB", psd.lab_to_rgb)):
        differ = int((pillow_convert(mode, px) != port(px)).any(axis=1).sum())
        print(f"{mode} -> RGB: {differ} of {len(px)} triples differ from Pillow")
        failed += differ
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
