"""Write uniir_tpu_torch/data/av1_tables.py: the AV1 specification's constant tables, read out of the
libavif Pillow bundles (dav1d 1.5.1 and aom 3.12.1 carry the same tables).

The port never opens that library; this script runs once, where Pillow is installed, and writes the
tables as Python literals.  Each table is found by its first row as the AV1 Bitstream & Decoding Process
Specification gives it (the default CDFs as libaom stores them, `32768 - x` per entry, then a zero entry
and a zero count per CDF, in its declared slot size; the few small CDF tables the compiler folds into
libaom's code from dav1d's copy, `32768 - x` and a count per CDF), then read with the table's dimensions.
A table found at no place, or at more than one, stops the script.

    python scripts/extract_av1_tables.py [--lib path/to/libavif.so] [--out uniir_tpu_torch/data/av1_tables.py]
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent


def _library() -> str:
    import PIL

    libs = glob.glob(os.path.join(os.path.dirname(PIL.__file__), "..", "pillow.libs", "libavif-*.so*"))
    if len(libs) != 1:
        sys.exit(f"expected one bundled libavif next to PIL, found {libs}")
    return libs[0]


class Binary:
    def __init__(self, path: str):
        self.data = open(path, "rb").read()

    def find(self, values, dtype) -> int:
        """The byte offset of `values`, which must occur once in the library."""
        v = np.asarray(values)
        s = np.frombuffer(self.data[: len(self.data) // np.dtype(dtype).itemsize * np.dtype(dtype).itemsize],
                          dtype=dtype).astype(np.int64)
        m = np.ones(len(s) - len(v) + 1, bool)
        for k, x in enumerate(v):
            m &= s[k : len(s) - len(v) + 1 + k] == x
        hits = np.nonzero(m)[0]
        if len(hits) != 1:
            sys.exit(f"anchor {list(v)[:6]}... found {len(hits)} times")
        return int(hits[0]) * np.dtype(dtype).itemsize

    def read(self, offset: int, count: int, dtype) -> np.ndarray:
        return np.frombuffer(self.data, dtype=dtype, count=count, offset=offset).astype(np.int64)


def stored(*cdf) -> list:
    return [32768 - x for x in cdf]


def cdfs(binary: Binary, offset: int, dims: tuple, n: int, stride: int, padded: bool) -> np.ndarray:
    """[*dims, n + 1] CDFs in the specification's form (n - 1 rising values, 32768, a zero count) from
    `stride`-entry slots of stored `32768 - x` values; `padded` slots (libaom's) hold a zero for 32768."""
    count = int(np.prod(dims))
    raw = binary.read(offset, count * stride, "<u2").reshape(count, stride)
    vals = 32768 - raw[:, : n - 1]
    if not (np.diff(vals, axis=1) > 0).all() or not ((vals > 0) & (vals < 32768)).all():
        sys.exit(f"table at {offset:#x} is not {count} CDFs of {n} symbols")
    if padded and not (raw[:, n - 1 : n + 1] == 0).all():
        sys.exit(f"table at {offset:#x}: slots do not end in 0, 0")
    out = np.concatenate([vals, np.full((count, 1), 32768), np.zeros((count, 1), np.int64)], axis=1)
    return out.reshape(*dims, n + 1)


AOM_REGION = (0x4426E0, 0x44D778)  # libaom's CDF tables in the libavif Pillow 12.1 bundles


def aom(binary, first_row, dims, n, stride, then=None):
    """A libaom table anchored on its first row (with its slot's zero tail, and the next row's first value),
    the one place it occurs among libaom's tables (dav1d's copy may hold the same bytes)."""
    anchor = stored(*first_row) + [0] * (stride - n + 1) + ([] if then is None else stored(then))
    return cdfs(binary, aom_find(binary, anchor), dims, n, stride, True)


def aom_find(binary, anchor, first: bool = False) -> int:
    """The byte offset of `anchor` among libaom's tables: its one place, or (`first`, for rows that repeat
    across the quantiser contexts) its first."""
    v = np.asarray(anchor)
    lo, hi = AOM_REGION
    s = binary.read(lo, (hi - lo) // 2, "<u2")
    hits = [lo + 2 * i for i in range(len(s) - len(v)) if (s[i : i + len(v)] == v).all()]
    if len(hits) != 1 and not (first and hits):
        sys.exit(f"anchor {anchor[:6]}... found {len(hits)} times among libaom's tables")
    return hits[0]


def dav1d(binary, first_row, dims, n, stride):
    """A table of dav1d's copy (the few small ones libaom's compiled code holds as immediates)."""
    anchor = stored(*first_row) + [0]
    return cdfs(binary, binary.find(anchor, "<u2"), dims, n, stride, False)


def extract(binary: Binary) -> dict:
    t = {}
    kf = aom_find(binary, stored(15588, 17027, 19338, 20218, 20682, 21110, 21825, 23244, 24189, 28165, 29093, 30466)
                  + [0, 0] + stored(12016))
    t["KF_Y_MODE_CDF"] = cdfs(binary, kf, (5, 5), 13, 14, True)
    # libaom's angle-delta CDFs lie just before, in slots of 8: the same bytes as dav1d's copy
    t["ANGLE_DELTA_CDF"] = cdfs(binary, kf - 8 * 16, (8,), 7, 8, True)
    if list(t["ANGLE_DELTA_CDF"][0, :6]) != [2180, 5032, 7567, 22776, 26989, 30217]:
        sys.exit("angle-delta CDFs not before the key-frame y-mode CDFs")
    t["UV_MODE_CFL_NOT_ALLOWED_CDF"] = aom(binary, [22631, 24152, 25378, 25661, 25986, 26520, 27055, 27923, 28244,
                                                    30059, 30941, 31961], (13,), 13, 15, then=9513)
    t["UV_MODE_CFL_ALLOWED_CDF"] = aom(binary, [10407, 11208, 12900, 13181, 13823, 14175, 14899, 15656, 15986,
                                                20086, 20995, 22455, 24212], (13,), 14, 15, then=4532)
    w8 = aom_find(binary, stored(19132, 25510, 30392) + [0] * 8 + stored(13928))
    t["PARTITION_W8_CDF"] = cdfs(binary, w8, (4,), 4, 11, True)
    t["PARTITION_W16_CDF"] = cdfs(binary, w8 + 4 * 22, (4,), 10, 11, True)
    t["PARTITION_W32_CDF"] = cdfs(binary, w8 + 8 * 22, (4,), 10, 11, True)
    t["PARTITION_W64_CDF"] = cdfs(binary, w8 + 12 * 22, (4,), 10, 11, True)
    t["PARTITION_W128_CDF"] = cdfs(binary, w8 + 16 * 22, (4,), 8, 11, True)
    set1 = aom_find(binary, stored(1535, 8035, 9461, 12751, 23467, 27825) + [0] * 11 + stored(564))
    t["INTRA_TX_SET1_CDF"] = cdfs(binary, set1, (2, 13), 7, 17, True)  # libaom [set][4 sizes][13 modes][17]
    t["INTRA_TX_SET2_CDF"] = cdfs(binary, set1 + 4 * 13 * 34, (3, 13), 5, 17, True)
    t["CFL_ALPHA_CDF"] = aom(binary, [7637, 20719, 31401, 32481, 32657, 32688, 32692, 32696, 32700, 32704, 32708,
                                      32712, 32716, 32720, 32724], (6,), 16, 17, then=14365)
    tx8 = aom_find(binary, stored(19968) + [0, 0, 0] + stored(19968) + [0, 0, 0] + stored(24320))
    t["TX_8X8_CDF"] = cdfs(binary, tx8, (3,), 2, 4, True)
    t["TX_16X16_CDF"] = cdfs(binary, tx8 + 3 * 8, (3,), 3, 4, True)
    t["TX_32X32_CDF"] = cdfs(binary, tx8 + 6 * 8, (3,), 3, 4, True)
    t["TX_64X64_CDF"] = cdfs(binary, tx8 + 9 * 8, (3,), 3, 4, True)
    fi = aom_find(binary, stored(4621) + [0, 0] + stored(6743) + [0, 0] + stored(5893))
    t["FILTER_INTRA_CDF"] = cdfs(binary, fi, (22,), 2, 3, True)
    t["DELTA_LF_CDF"] = cdfs(binary, aom_find(binary, stored(28160, 32120, 32677) + [0, 0], first=True), (), 4, 5, True)
    skip = binary.find(stored(31671) + [0] + stored(16515) + [0] + stored(4576), "<u2")
    t["SKIP_CDF"] = cdfs(binary, skip, (3,), 2, 2, False)
    t["SEGMENT_ID_CDF"] = dav1d(binary, [5622, 7893, 16093, 18233, 27809, 28373, 32533], (3,), 8, 8)
    t["CFL_SIGN_CDF"] = dav1d(binary, [1418, 2123, 13340, 18405, 26972, 28343, 32294], (), 8, 8)
    t["FILTER_INTRA_MODE_CDF"] = dav1d(binary, [8949, 12776, 17211, 29558], (), 5, 8)
    lr = binary.find(stored(9413, 22581) + [0, 0] + stored(11570) + [0] + stored(16855) + [0], "<u2")
    t["RESTORATION_TYPE_CDF"] = cdfs(binary, lr, (), 3, 4, False)
    t["USE_WIENER_CDF"] = cdfs(binary, lr + 8, (), 2, 2, False)
    t["USE_SGRPROJ_CDF"] = cdfs(binary, lr + 12, (), 2, 2, False)
    # coefficients: [TOKEN_CDF_Q_CTXS][...]
    for name, rows, dims in (("TXB_SKIP_CDF", (31849, 5892, 12112), (4, 5, 13)),
                             ("EOB_EXTRA_CDF", (16961, 17223, 7621), (4, 5, 2, 9)),
                             ("DC_SIGN_CDF", (16000, 13056, 18816), (4, 2, 3))):
        # rows repeat across the quantiser contexts: the table starts at the first place
        at = aom_find(binary, stored(rows[0]) + [0, 0] + stored(rows[1]) + [0, 0] + stored(rows[2]), first=True)
        t[name] = cdfs(binary, at, dims, 2, 3, True)
    for size, row, then in ((16, [840, 1039, 1980, 4895], 370), (32, [400, 520, 977, 2102, 6542], 210),
                            (64, [329, 498, 1101, 1784, 3265, 7758], 335),
                            (128, [219, 482, 1140, 2091, 3680, 6028, 12586], 371),
                            (256, [310, 584, 1887, 3589, 6168, 8611, 11352, 15652], 998),
                            (512, [641, 983, 3707, 5430, 10234, 14958, 18788, 23412, 26061], 3277),
                            (1024, [393, 421, 751, 1623, 3160, 6352, 13345, 18047, 22571, 25830], 2979)):
        t[f"EOB_PT_{size}_CDF"] = aom(binary, row, (4, 2, 2), len(row) + 1, len(row) + 2, then)
    base_eob = aom_find(binary, stored(17837, 29055) + [0, 0], first=True)
    t["COEFF_BASE_EOB_CDF"] = cdfs(binary, base_eob, (4, 5, 2, 4), 3, 4, True)
    base = aom_find(binary, stored(4034, 8930, 12727) + [0, 0], first=True)
    t["COEFF_BASE_CDF"] = cdfs(binary, base, (4, 5, 2, 42), 4, 5, True)
    t["COEFF_BR_CDF"] = cdfs(binary, base + 4 * 5 * 2 * 42 * 10, (4, 5, 2, 21), 4, 5, True)
    # the other tables
    t["DC_QLOOKUP"] = binary.read(binary.find([4, 8, 8, 9, 10, 11, 12, 12, 13, 14, 15, 16], "<u2"), 256, "<u2")
    t["AC_QLOOKUP"] = binary.read(binary.find([4, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18], "<u2"), 256, "<u2")
    t["SM_WEIGHTS"] = binary.read(binary.find([0, 0, 255, 128, 255, 149, 85, 64], "u1"), 128, "u1")
    t["DR_INTRA_DERIVATIVE"] = binary.read(binary.find([0, 0, 0, 1023, 0, 0, 547], "<u2"), 90, "<u2")
    taps = binary.read(binary.find([-6, 10, 0, 0, 0, 12, 0, 0, -5, 2, 10], "i1"), 5 * 8 * 8, "i1")
    t["FILTER_INTRA_TAPS"] = taps.reshape(5, 8, 8)[:, :, :7]
    sgr = binary.read(binary.find([2, 1, 140, 3236, 2, 1, 112, 2158], "<i4"), 16 * 4, "<i4").reshape(16, 4)
    t["SGR_PARAMS"] = sgr[:, [0, 2, 1, 3]]  # libaom's {r0, r1, s0, s1} as the spec's {r0, e0, r1, e1}
    return t


def literal(a: np.ndarray) -> str:
    flat = ", ".join(str(int(x)) for x in a.ravel())
    lines, line = [], "    "
    for tok in flat.split(" "):
        if len(line) + len(tok) + 1 > 116:
            lines.append(line.rstrip())
            line = "    "
        line += tok + " "
    lines.append(line.rstrip())
    return "_t([\n" + "\n".join(lines) + f"\n], {tuple(a.shape)})"


HEADER = '''"""The AV1 specification's constant tables that av1_*.py read (AV1 Bitstream & Decoding Process
Specification, version 1.0.0 with errata: the default CDFs of section 9.4 / 9.5's tables, Dc_Qlookup /
Ac_Qlookup's 8-bit rows, the smooth predictor's weights, Dr_Intra_Derivative, Filter_Intra_Taps and
Sgr_Params), as dav1d 1.5.1 and aom 3.12.1 carry them.  Written by scripts/extract_av1_tables.py; do not
edit by hand.

Each CDF is the specification's form: N - 1 rising values, 32768, and a zero adaptation count, the last
axis of its array.  The coefficient CDFs' first axis is the quantiser context (base_q_idx <= 20, <= 60,
<= 120, above).
"""

import numpy as np


def _t(values, shape):
    return np.array(values, dtype=np.int32).reshape(shape)

'''


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lib", default=None)
    ap.add_argument("--out", default=str(REPO / "uniir_tpu_torch" / "data" / "av1_tables.py"))
    args = ap.parse_args()
    tables = extract(Binary(args.lib or _library()))
    body = "".join(f"\n{name} = {literal(a)}\n" for name, a in tables.items())
    Path(args.out).write_text(HEADER + body)
    print(f"wrote {len(tables)} tables to {args.out}")


if __name__ == "__main__":
    main()
