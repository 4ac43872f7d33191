"""data/av1_tables.py (written by scripts/extract_av1_tables.py from the libavif Pillow bundles) held to the
shapes and the form the AV1 specification gives its tables, the transforms of data/av1_recon.py held to the
real DCT / ADST they approximate, and the port held to never opening the bundled library itself."""

import math
from pathlib import Path

import numpy as np
import pytest

from uniir_tpu_torch.data import av1_recon, av1_tables

REPO = Path(__file__).resolve().parent.parent

# name -> (shape, symbols per CDF) of the default CDFs; the coefficient ones lead with 4 quantiser contexts
CDFS = {
    "KF_Y_MODE_CDF": ((5, 5), 13), "ANGLE_DELTA_CDF": ((8,), 7), "UV_MODE_CFL_NOT_ALLOWED_CDF": ((13,), 13),
    "UV_MODE_CFL_ALLOWED_CDF": ((13,), 14), "PARTITION_W8_CDF": ((4,), 4), "PARTITION_W16_CDF": ((4,), 10),
    "PARTITION_W32_CDF": ((4,), 10), "PARTITION_W64_CDF": ((4,), 10), "PARTITION_W128_CDF": ((4,), 8),
    "INTRA_TX_SET1_CDF": ((2, 13), 7), "INTRA_TX_SET2_CDF": ((3, 13), 5), "CFL_ALPHA_CDF": ((6,), 16),
    "CFL_SIGN_CDF": ((), 8), "TX_8X8_CDF": ((3,), 2), "TX_16X16_CDF": ((3,), 3), "TX_32X32_CDF": ((3,), 3),
    "TX_64X64_CDF": ((3,), 3), "FILTER_INTRA_CDF": ((22,), 2), "FILTER_INTRA_MODE_CDF": ((), 5),
    "DELTA_LF_CDF": ((), 4), "SKIP_CDF": ((3,), 2), "SEGMENT_ID_CDF": ((3,), 8), "RESTORATION_TYPE_CDF": ((), 3),
    "USE_WIENER_CDF": ((), 2), "USE_SGRPROJ_CDF": ((), 2), "TXB_SKIP_CDF": ((4, 5, 13), 2),
    "EOB_EXTRA_CDF": ((4, 5, 2, 9), 2), "DC_SIGN_CDF": ((4, 2, 3), 2), "EOB_PT_16_CDF": ((4, 2, 2), 5),
    "EOB_PT_32_CDF": ((4, 2, 2), 6), "EOB_PT_64_CDF": ((4, 2, 2), 7), "EOB_PT_128_CDF": ((4, 2, 2), 8),
    "EOB_PT_256_CDF": ((4, 2, 2), 9), "EOB_PT_512_CDF": ((4, 2, 2), 10), "EOB_PT_1024_CDF": ((4, 2, 2), 11),
    "COEFF_BASE_EOB_CDF": ((4, 5, 2, 4), 3), "COEFF_BASE_CDF": ((4, 5, 2, 42), 4),
    "COEFF_BR_CDF": ((4, 5, 2, 21), 4),
}
OTHERS = {"DC_QLOOKUP": (256,), "AC_QLOOKUP": (256,), "SM_WEIGHTS": (128,), "DR_INTRA_DERIVATIVE": (90,),
          "FILTER_INTRA_TAPS": (5, 8, 7), "SGR_PARAMS": (16, 4)}


def test_every_table_is_listed():
    names = {n for n in dir(av1_tables) if n.isupper()}
    assert names == set(CDFS) | set(OTHERS)


@pytest.mark.parametrize("name", sorted(CDFS))
def test_cdf_shape_and_form(name):
    """N - 1 rising values inside (0, 32768), then 32768 and a zero adaptation count, on the last axis."""
    shape, n = CDFS[name]
    table = getattr(av1_tables, name)
    assert table.shape == shape + (n + 1,)
    flat = table.reshape(-1, n + 1)
    assert (flat[:, n - 1] == 32768).all() and (flat[:, n] == 0).all()
    values = flat[:, : n - 1]
    assert ((values > 0) & (values < 32768)).all()
    assert (np.diff(flat[:, :n], axis=1) > 0).all()


@pytest.mark.parametrize("name", sorted(OTHERS))
def test_other_table_shapes(name):
    assert getattr(av1_tables, name).shape == OTHERS[name]


def test_other_tables_by_their_definitions():
    dc, ac = av1_tables.DC_QLOOKUP, av1_tables.AC_QLOOKUP
    assert dc[0] == ac[0] == 4 and dc[-1] == 1336 and ac[-1] == 1828
    assert (np.diff(dc) >= 0).all() and (np.diff(ac) > 0).all()
    # the smooth weights: block size n's weights at [n, 2n), from 255 down
    sm = av1_tables.SM_WEIGHTS
    for n in (4, 8, 16, 32, 64):
        assert sm[n] == 255 and (np.diff(sm[n : 2 * n]) <= 0).all()
    # Dr_Intra_Derivative is defined where the directional modes' angles (3 degrees apart) index it: p below
    # 90, 180 - p and p - 90 between 90 and 180, 270 - p above
    dr = av1_tables.DR_INTRA_DERIVATIVE
    used = set()
    for p in {m + 3 * d for m in (45, 67, 90, 113, 135, 157, 180, 203) for d in range(-3, 4)} - {90, 180}:
        used |= {p} if p < 90 else {180 - p, p - 90} if p < 180 else {270 - p}
    assert [a for a in range(90) if dr[a]] == sorted(used) and dr[3] == 1023 and dr[87] == 3
    # each filter-intra row is a predictor of gain 16 (its taps sum to 16)
    assert (av1_tables.FILTER_INTRA_TAPS.sum(axis=2) == 16).all()
    sgr = av1_tables.SGR_PARAMS
    assert sgr[0].tolist() == [2, 140, 1, 3236] and ((sgr[:, 0] == 0) | (sgr[:, 0] == 2)).all()
    assert ((sgr[:, 2] == 0) | (sgr[:, 2] == 1)).all()


def test_no_port_file_opens_the_bundled_library():
    """The tables are literals: no port module reads libavif (the card's machine has no Pillow)."""
    for path in (REPO / "uniir_tpu_torch").rglob("*.py"):
        text = path.read_text()
        assert "pillow.libs" not in text and "libavif-" not in text, path


@pytest.mark.parametrize("n", (4, 8, 16, 32, 64))
def test_inverse_dct_approximates_the_real_one(n):
    x = np.random.default_rng(n).integers(-500, 500, n)
    out = np.array(av1_recon._idct([np.array(v, np.int64) for v in x], av1_recon._Clamp(24)))
    ref = [x[0] / math.sqrt(2) + sum(x[j] * math.cos(math.pi * (2 * i + 1) * j / (2 * n)) for j in range(1, n))
           for i in range(n)]
    assert np.abs(out - np.array(ref)).max() < 0.2 * n + 1  # 12-bit butterflies, each rounded


@pytest.mark.parametrize("n", (4, 8, 16))
def test_inverse_adst_approximates_the_real_one(n):
    x = np.random.default_rng(n).integers(-500, 500, n)
    out = np.array(av1_recon._1d(av1_recon.ADST, [np.array(v, np.int64) for v in x], av1_recon._Clamp(24)))
    if n == 4:
        ref = [sum(x[j] * math.sin(math.pi * (i + 1) * (2 * j + 1) / 9) for j in range(4)) * 2 * math.sqrt(2) / 3
               for i in range(4)]
    else:
        ref = [sum(x[j] * math.sin(math.pi * (2 * i + 1) * (2 * j + 1) / (4 * n)) for j in range(n)) for i in range(n)]
    assert np.abs(out - np.array(ref)).max() < 0.3 * n


def test_lossless_walsh_hadamard_round_trip():
    """The inverse WHT undoes the forward one (libaom's av1_fwht4x4 on a residual block)."""
    rng = np.random.default_rng(3)
    block = rng.integers(-255, 256, (4, 4))

    def fwht(ip):
        a, b, c, d = ip
        a += b
        d -= c
        e = (a - d) >> 1
        b = e - b
        c = e - c
        a -= c
        d += b
        return [a, c, d, b]

    cols = np.array([fwht(list(block[:, j])) for j in range(4)]).T
    coef = np.array([fwht(list(cols[i, :])) for i in range(4)]) * 4
    out = av1_recon.inverse_transform(coef, 4, 4, 0, True)
    np.testing.assert_array_equal(out, block)
