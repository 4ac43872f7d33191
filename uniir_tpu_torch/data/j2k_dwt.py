"""JPEG 2000 inverse wavelet transforms and component transforms, as OpenJPEG 2.5 computes them.

  * the reversible 5/3 transform in int32 (`opj_dwt_decode_tile`): per level, every row then every column
    of the resolution, the low-pass samples at the even coordinates of the tile-component (so an odd
    origin swaps the lifting's parity), whole-sample symmetric extension, a lone sample at an odd
    coordinate halved toward zero;
  * the irreversible 9/7 transform in float32 (`opj_dwt_decode_tile_97`): the low band scaled by K and the
    high band by 2 / K's historic value 1.625732422 (OpenJPEG's step sizes make up the difference), then
    the four lifting steps, each `x + (left + right) * c` rounded to float32 after every operation (no
    fused multiply-add: the library is built for SSE2), and a lone sample left as it is;
  * the inverse RCT (integer) and ICT (float32) on the first three components, then the DC level shift,
    float samples rounded half to even (`lrintf`), and the clamp to the component's precision.
"""

from __future__ import annotations

import numpy as np

ALPHA, BETA, GAMMA, DELTA = (np.float32(v) for v in (-1.586134342, -0.052980118, 0.882911075, 0.443506852))
K, TWO_INV_K = np.float32(1.230174105), np.float32(1.625732422)


def _neighbours(pos: np.ndarray, n: int):
    """Left and right neighbours of positions `pos` in 0..n-1 under whole-sample symmetric extension."""
    left = np.where(pos >= 1, pos - 1, pos + 1)
    right = np.where(pos + 1 < n, pos + 1, pos - 1)
    return left, right


def _interleave(x: np.ndarray, sn: int, cas: int) -> np.ndarray:
    """The last axis of `x` (low band's sn samples, then the high band's) in signal order."""
    out = np.empty_like(x)
    out[..., cas::2] = x[..., :sn]
    out[..., 1 - cas :: 2] = x[..., sn:]
    return out


def idwt53_1d(x: np.ndarray, sn: int, cas: int) -> np.ndarray:
    """The 5/3 synthesis of int32 rows x[..., n] (opj_idwt53_h / _v)."""
    n = x.shape[-1]
    if n == 1:
        if cas:
            a = x.astype(np.int64)
            return (np.sign(a) * (np.abs(a) >> 1)).astype(np.int32)
        return x
    y = _interleave(x, sn, cas)
    s = np.arange(cas, n, 2)
    d = np.arange(1 - cas, n, 2)
    with np.errstate(over="ignore"):
        left, right = _neighbours(s, n)
        same = left == right
        upd = np.where(same, (y[..., left] + 1) >> 1, (y[..., left] + y[..., right] + 2) >> 2)
        y[..., s] = y[..., s] - upd
        left, right = _neighbours(d, n)
        same = left == right
        upd = np.where(same, y[..., left], (y[..., left] + y[..., right]) >> 1)
        y[..., d] = y[..., d] + upd
    return y


def idwt97_1d(x: np.ndarray, sn: int, cas: int) -> np.ndarray:
    """The 9/7 synthesis of float32 rows x[..., n] (opj_v8dwt_decode)."""
    n = x.shape[-1]
    dn = n - sn
    if (cas == 0 and not (dn > 0 or sn > 1)) or (cas == 1 and not (sn > 0 or dn > 1)):
        return x
    y = _interleave(x, sn, cas)
    s = np.arange(cas, n, 2)
    d = np.arange(1 - cas, n, 2)
    y[..., s] *= K
    y[..., d] *= TWO_INV_K
    for pos, c in ((s, -DELTA), (d, -GAMMA), (s, -BETA), (d, -ALPHA)):
        left, right = _neighbours(pos, n)
        y[..., pos] = y[..., pos] + (y[..., left] + y[..., right]) * c
    return y


def idwt(data: np.ndarray, resolutions: list, reversible: bool) -> np.ndarray:
    """Inverse DWT of a tile-component's coefficients data[h, w] (int32 or float32), laid out as OpenJPEG
    lays them (each level's low band top-left), over `resolutions` [(x0, y0, x1, y1)] from the lowest."""
    one = idwt53_1d if reversible else idwt97_1d
    rx0, ry0, rx1, ry1 = resolutions[0]
    rw, rh = rx1 - rx0, ry1 - ry0
    for x0, y0, x1, y1 in resolutions[1:]:
        sw, sh = rw, rh
        rw, rh = x1 - x0, y1 - y0
        if rw and rh:
            data[:rh, :rw] = one(data[:rh, :rw], sw, x0 % 2)
            data[:rh, :rw] = one(data[:rh, :rw].T, sh, y0 % 2).T
    return data


def rct(c0: np.ndarray, c1: np.ndarray, c2: np.ndarray):
    """opj_mct_decode: the inverse reversible colour transform in int32."""
    with np.errstate(over="ignore"):
        g = c0 - ((c1 + c2) >> 2)
        return c2 + g, g, c1 + g


def ict(c0: np.ndarray, c1: np.ndarray, c2: np.ndarray):
    """opj_mct_decode_real: the inverse irreversible colour transform in float32."""
    r = c0 + c2 * np.float32(1.402)
    g = (c0 - c1 * np.float32(0.34413)) - c2 * np.float32(0.71414)
    b = c0 + c1 * np.float32(1.772)
    return r, g, b


def level_shift(data: np.ndarray, prec: int, sgnd: bool, reversible: bool) -> np.ndarray:
    """opj_tcd_dc_level_shift_decode: int32 samples of the component's range."""
    lo, hi = (-(1 << (prec - 1)), (1 << (prec - 1)) - 1) if sgnd else (0, (1 << prec) - 1)
    shift = 0 if sgnd else 1 << (prec - 1)
    if reversible:
        with np.errstate(over="ignore"):
            return np.clip(data + np.int32(shift), lo, hi).astype(np.int32)
    f = data.astype(np.float32)
    with np.errstate(invalid="ignore"):
        big, small = f > np.float32(2 ** 31), f < np.float32(-(2 ** 31))
        v = np.rint(np.where(big | small | np.isnan(f), 0, f)).astype(np.int64) + shift
    v = np.clip(v, lo, hi)
    v[big] = hi
    v[small | np.isnan(f)] = lo
    return v.astype(np.int32)
