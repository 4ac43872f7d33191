"""Time the native JPEG decoder (csrc/jpeg.cu) of one or more checkouts on the same files, in turns.

    python scripts/jpeg_decode_rate.py --tree . --tree build/parent [--threads 8] [--rounds 2]

Each tree's `uniir_tpu_torch/csrc/jpeg.cu` is built with nvcc and the flags of uniir_tpu_torch/_build.py (one
nvcc per tree, all started together) into a temporary directory and loaded through ctypes with the decoder's
C interface (`uniir_jpeg_info`, `uniir_jpeg_decode`), so two versions run in one process on one host.  The
files are tests/data/jpeg_damage/'s 640 x 480 baseline 4:2:0 file, clean and damaged, and its damaged
1920 x 1080 one.  On one thread the trees decode each file in turns, one decode each, 200 turns (A B A B ...:
the host's drift falls on all alike): each tree's median ms, and the median of the ratios of each turn's
times to the first tree's.  Then every round visits the trees in the order given and reversed (A B B A) for
the images/s of 64 decodes on `--threads` threads (ctypes releases the GIL).  Also the ms of `data.jpeg.open_header`, which the port's `decode_native` runs in Python before the
library (Pillow's marker walk up to the first scan).  Prints the card's name and power limit."""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from uniir_tpu_torch import _build  # noqa: E402
from uniir_tpu_torch.data import jpeg  # noqa: E402

FILES = ("clean_vga_420.jpg", "vga_420_flips.jpg", "vga_restart_rst_missing.jpg", "hd_420_flips_zeros.jpg")


def build(tree: Path, out: Path) -> subprocess.Popen:
    return subprocess.Popen([_build._nvcc(), *_build._flags("jpeg"), "-o", str(out),
                             str(tree / "uniir_tpu_torch" / "csrc" / "jpeg.cu")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def loaded(path: Path):
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in _build.SIGNATURES["jpeg"].items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int

    def decode(data: bytes) -> np.ndarray:
        err, size = ctypes.create_string_buffer(256), (ctypes.c_int * 2)()
        if lib.uniir_jpeg_info(data, len(data), size, err, len(err)):
            raise ValueError(err.value.decode())
        out = np.empty((size[1], size[0], 3), np.uint8)
        if lib.uniir_jpeg_decode(data, len(data), out.ctypes.data, size[0], size[1], err, len(err)):
            raise ValueError(err.value.decode())
        return out

    return decode


def interleaved(decoders: list, data: bytes, turns: int = 200) -> list:
    """Per decoder, the seconds of each of `turns` decodes, the decoders taking turns."""
    times = [[] for _ in decoders]
    for _ in range(turns):
        for k, decode in enumerate(decoders):
            t0 = time.perf_counter()
            decode(data)
            times[k].append(time.perf_counter() - t0)
    return times


def threaded(decode, data: bytes, threads: int) -> float:
    with ThreadPoolExecutor(threads) as pool:
        t0 = time.perf_counter()
        list(pool.map(decode, [data] * 64))
        return 64 / (time.perf_counter() - t0)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", required=True, help="a checkout's root (repeatable)")
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}")
    trees = [Path(t).resolve() for t in args.tree]
    files = {name: (REPO / "tests" / "data" / "jpeg_damage" / name).read_bytes() for name in FILES}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = [build(tree, Path(tmp) / f"jpeg{k}.so") for k, tree in enumerate(trees)]
        for tree, proc in zip(trees, procs):
            log = proc.communicate()[0]
            if proc.returncode:
                raise SystemExit(f"nvcc failed for {tree}:\n{log[-3000:]}")
        print(f"built {len(trees)} trees in {time.perf_counter() - t0:.1f} s")
        decoders = [loaded(Path(tmp) / f"jpeg{k}.so") for k in range(len(trees))]

        def outcome(decode, data):
            try:
                return decode(data)
            except ValueError as err:
                return str(err)

        outs = [{name: outcome(d, data) for name, data in files.items()} for d in decoders]
        for name in files:  # a tree that refuses a damaged file is not timed on it
            kinds = ["refuses" if isinstance(o[name], str) else "decodes" for o in outs]
            same = all(not isinstance(o[name], str) and np.array_equal(o[name], outs[0][name]) for o in outs)
            print(f"{name}: the trees {kinds}; pixels {'equal' if same else 'not all equal'}")
        for name, data in files.items():
            ks = [k for k in range(len(trees)) if not isinstance(outs[k][name], str)]
            times = interleaved([decoders[k] for k in ks], data)
            h, w = outs[ks[0]][name].shape[:2]
            for k, t in zip(ks, times):
                ms = statistics.median(t) * 1e3
                ratio = statistics.median(a / b for a, b in zip(t, times[0]))
                print(f"one thread, tree {trees[k]} {name}: {ms:.3f} ms a decode ({w * h / ms / 1e3:.2f} Mpixel/s), "
                      f"{ratio:.4f} x the time of {trees[ks[0]]} turn by turn")
        order = list(range(len(trees)))
        for r in range(args.rounds):
            for k in order + order[::-1]:
                for name, data in files.items():
                    if not isinstance(outs[k][name], str):
                        print(f"round {r} tree {trees[k]} {name}: {threaded(decoders[k], data, args.threads):.1f} "
                              f"images/s on {args.threads} threads")
    for name, data in files.items():
        times = []
        for _ in range(200):
            t0 = time.perf_counter()
            jpeg.open_header(data, name)
            times.append(time.perf_counter() - t0)
        print(f"open_header {name}: {statistics.median(times) * 1e3:.4f} ms")


if __name__ == "__main__":
    main()
