"""Host-side image preprocessing on uint8 HWC arrays: the port's copy of
uniir_tpu/data/preprocess.py, held equal to it by tests/test_torch_data.py
and tests/test_torch_preprocess.py.

The eval transforms take the decoded array (`data.jpeg`) and need no
Pillow: `resize_uint8` is Pillow's `Image.resize` on an RGB image, bit for
bit (`ImagingResample`'s 8-bit path: the filter's support widened by the
downscale factor, bicubic a = -0.5, coefficients normalised and made
fixed-point with PRECISION_BITS = 22, rounded half away from zero, the
accumulator started at 1 << 21, the horizontal pass over only the rows the
vertical one reads, then the vertical, each clipped to 0..255), and
`center_crop` is Pillow's `crop` box.

Produces HWC float32 numpy arrays (NHWC batches) with CLIP normalization
statistics.  Mirrors:
  * CLIP eval preprocess -- resize-shortest-side + center-crop + normalize
    (external `clip.load` transform, used at reference clip_sf.py:25,32-33)
  * BLIP train/eval transforms -- RandomResizedCrop(min_scale, bicubic) +
    HFlip + RandAugment(2 ops, magnitude 5) + normalize
    (reference src/models/uniir_blip/backbone/transform/blip_transform.py:8-49)
  * RandAugment 10-op palette (reference .../transform/randaugment.py)

The train transforms work on the array too, each bit-equal to Pillow's op
on the same image and drawing `random` in the JAX package's order, so a
seeded `random` gives both packages the same augmentation:
`random_resized_crop` passes its box to `resize_uint8`, the flip is
`arr[:, ::-1]`, and RandAugment's ops are Pillow's C code in numpy --
`ImageOps.autocontrast` / `equalize` as per-channel LUTs from histograms
(Python floats / integers, as `ImageOps` computes them), `ImageEnhance`'s
`Image.blend` in float32 (truncated, clipped first where the factor lies
outside [0, 1]), `ImageFilter.SMOOTH` in float32 with the border copied,
and the affine ops (shears, translations, `rotate` with its rounded matrix)
as `ImagingGenericTransform` with bilinear sampling: output centres through
the matrix in double precision, black outside the image, neighbours
clamped at its edge, the value truncated.

These host transforms can emit either the fully normalized float image or
a raw uint8 resize for a device-side preprocessing path.
"""

from __future__ import annotations

import math
import random
from typing import Callable, Optional

import numpy as np

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)

BICUBIC, BILINEAR = 3, 2  # PIL.Image.Resampling values
PRECISION_BITS = 22  # Pillow's Resample.c: 32 - 8 - 2


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _bilinear(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


_FILTERS = {BICUBIC: (_bicubic, 2.0), BILINEAR: (_bilinear, 1.0)}


def _coefficients(in_size: int, in0, in1, out_size: int, resample: int):
    """Pillow's precompute_coeffs + normalize_coeffs_8bpc: (first source
    index [out], tap count [out], fixed-point weights [out, ksize])."""
    fn, support = _FILTERS[resample]
    in0, in1 = np.float32(in0), np.float32(in1)
    filterscale = scale = float(in1 - in0) / out_size  # float subtraction, then double, as in C
    filterscale = max(filterscale, 1.0)
    support = support * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = float(in0) + (np.arange(out_size) + 0.5) * scale
    ss = 1.0 / filterscale
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    weights = np.zeros((out_size, ksize))
    ww = np.zeros(out_size)
    for x in range(ksize):  # summed in C's order, tap by tap
        w = np.where(x < xmax, fn(((x + xmin) - center + 0.5) * ss), 0.0)
        weights[:, x] = w
        ww = ww + w
    weights = np.where(ww[:, None] != 0.0, weights / np.where(ww == 0.0, 1.0, ww)[:, None], weights)
    scaled = weights * (1 << PRECISION_BITS)
    fixed = np.where(weights < 0, np.trunc(-0.5 + scaled), np.trunc(0.5 + scaled)).astype(np.int64)
    return xmin, xmax, fixed


def _resample_rows(src: np.ndarray, xmin, xmax, fixed) -> np.ndarray:
    """One 8-bit pass along axis 0 of uint8 `src` (rows gathered whole, so
    each tap is a few contiguous copies): int32 sums, as Pillow's."""
    n = src.shape[0]
    src = src.astype(np.int32)
    acc = np.full((len(xmin),) + src.shape[1:], 1 << (PRECISION_BITS - 1), np.int32)
    tap = np.empty_like(acc)
    shape = (-1,) + (1,) * (src.ndim - 1)
    for x in range(fixed.shape[1]):
        live = x < xmax  # taps past an output's window carry weight 0
        if not live.any():
            break
        np.take(src, np.minimum(xmin + x, n - 1), axis=0, out=tap)
        tap *= np.where(live, fixed[:, x], 0).astype(np.int32).reshape(shape)
        acc += tap
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_uint8(arr: np.ndarray, size, resample: int = BICUBIC, box=None) -> np.ndarray:
    """`Image.fromarray(arr).resize(size, resample, box)` for uint8 [H, W, 3]
    (`size` is (width, height), `box` (left, upper, right, lower))."""
    h, w = arr.shape[:2]
    out_w, out_h = int(size[0]), int(size[1])
    box = (0, 0, w, h) if box is None else tuple(box)
    if out_w < 1 or out_h < 1:
        raise ValueError(f"resize to {out_w} x {out_h}: sizes must be positive")
    if box[0] < 0 or box[1] < 0 or box[2] > w or box[3] > h or box[2] - box[0] < 0 or box[3] - box[1] < 0:
        raise ValueError(f"box {box} does not fit a {w} x {h} image")
    if (out_w, out_h) == (w, h) and box == (0, 0, w, h):
        return arr.copy()
    if resample not in _FILTERS:
        raise ValueError(f"resample {resample}: only BICUBIC ({BICUBIC}) and BILINEAR ({BILINEAR}) are ported")
    need_h = out_w != w or box[0] or box[2] != out_w
    need_v = out_h != h or box[1] or box[3] != out_h
    x0, xn, xk = _coefficients(w, box[0], box[2], out_w, resample)
    y0, yn, yk = _coefficients(h, box[1], box[3], out_h, resample)
    out = arr
    if need_h:
        first, last = int(y0[0]), int(y0[-1] + yn[-1])  # the rows the vertical pass reads
        out = _resample_rows(np.ascontiguousarray(arr[first:last].swapaxes(0, 1)), x0, xn, xk).swapaxes(0, 1)
        y0 = y0 - first
    if need_v:
        out = _resample_rows(out, y0, yn, yk)
    return np.ascontiguousarray(out)


def to_normalized_array(arr: np.ndarray) -> np.ndarray:
    """uint8 HWC -> float32 HWC in CLIP-normalized space."""
    arr = np.asarray(arr, dtype=np.float32) / 255.0
    return (arr - CLIP_MEAN) / CLIP_STD


def resize_shortest_side(arr: np.ndarray, size: int) -> np.ndarray:
    h, w = arr.shape[:2]
    if w <= h:
        new_w, new_h = size, max(1, round(h * size / w))
    else:
        new_w, new_h = max(1, round(w * size / h)), size
    return resize_uint8(arr, (new_w, new_h), BICUBIC)


def center_crop(arr: np.ndarray, size: int) -> np.ndarray:
    """Pillow's `crop((left, top, left + size, top + size))` of the centred
    box; what lies outside the image is 0."""
    h, w = arr.shape[:2]
    left, top = (w - size) // 2, (h - size) // 2
    out = np.zeros((size, size) + arr.shape[2:], arr.dtype)
    ys, xs = max(top, 0), max(left, 0)
    ye, xe = min(top + size, h), min(left + size, w)
    if ye > ys and xe > xs:
        out[ys - top : ye - top, xs - left : xe - left] = arr[ys:ye, xs:xe]
    return out


def clip_transform(image_size: int = 224) -> Callable:
    """The CLIP eval transform: shortest-side resize, center crop, normalize."""

    def fn(arr: np.ndarray) -> np.ndarray:
        arr = resize_shortest_side(arr, image_size)
        arr = center_crop(arr, image_size)
        return to_normalized_array(arr)

    return fn


# ---------------------------------------------------------------------------
# Pillow's point, blend, filter and transform ops on uint8 [H, W, 3] arrays
# ---------------------------------------------------------------------------


def _apply_luts(arr: np.ndarray, luts) -> np.ndarray:
    """`Image.point` with one 256-entry LUT a channel (values clipped to 0..255)."""
    out = np.empty_like(arr)
    for c, lut in enumerate(luts):
        out[..., c] = np.clip(np.asarray(lut, np.int64), 0, 255).astype(np.uint8)[arr[..., c]]
    return out


def autocontrast(arr: np.ndarray) -> np.ndarray:
    """`ImageOps.autocontrast(img)`: each channel stretched from its lowest
    to its highest value, `int(ix * scale + offset)` in doubles."""
    luts = []
    for c in range(arr.shape[2]):
        present = np.flatnonzero(np.bincount(arr[..., c].ravel(), minlength=256))
        lo, hi = int(present[0]), int(present[-1])
        if hi <= lo:
            luts.append(np.arange(256))
            continue
        scale = 255.0 / (hi - lo)
        luts.append(np.trunc(np.arange(256, dtype=np.float64) * scale + (-lo * scale)))
    return _apply_luts(arr, luts)


def equalize(arr: np.ndarray) -> np.ndarray:
    """`ImageOps.equalize(img)`: each channel through its histogram's
    cumulative LUT, in integers."""
    luts = []
    for c in range(arr.shape[2]):
        h = np.bincount(arr[..., c].ravel(), minlength=256).astype(np.int64)
        histo = h[h != 0]
        step = (int(histo.sum()) - int(histo[-1])) // 255 if len(histo) > 1 else 0
        if not step:
            luts.append(np.arange(256))
            continue
        luts.append((step // 2 + np.concatenate([[0], np.cumsum(h)[:-1]])) // step)
    return _apply_luts(arr, luts)


def blend(im1: np.ndarray, im2: np.ndarray, alpha: float) -> np.ndarray:
    """`Image.blend(im1, im2, alpha)` (Blend.c): im1 + alpha * (im2 - im1)
    in float32, truncated; clipped to 0..255 first where alpha lies outside
    [0, 1]."""
    a = np.float32(alpha)
    v = im1.astype(np.float32) + a * (im2.astype(np.int32) - im1.astype(np.int32)).astype(np.float32)
    if not 0.0 <= a <= 1.0:
        v = np.clip(v, 0.0, 255.0)
    return np.trunc(v).astype(np.uint8)


def smooth(arr: np.ndarray) -> np.ndarray:
    """`img.filter(ImageFilter.SMOOTH)` (Filter.c's 3x3 path): kernel 1 1 1 /
    1 5 1 / 1 1 1 over 13 as float32 weights, each output 0.5 + the row
    below, then the row, then the row above (each a left-to-right float32
    sum), clipped and truncated; the border rows and columns copied, and an
    image under 3 x 3 returned as it is."""
    h, w = arr.shape[:2]
    if h < 3 or w < 3:
        return arr.copy()
    k1, k5 = np.float32(1.0) / np.float32(13.0), np.float32(5.0) / np.float32(13.0)
    f = arr.astype(np.float32)
    ss = np.full((h - 2, w - 2, arr.shape[2]), 0.5, np.float32)
    for rows, mid in ((f[2:], k1), (f[1:-1], k5), (f[:-2], k1)):
        ss += (rows[:, :-2] * k1 + rows[:, 1:-1] * mid) + rows[:, 2:] * k1
    out = arr.copy()
    out[1:-1, 1:-1] = np.trunc(np.clip(ss, 0.0, 255.0)).astype(np.uint8)
    return out


def affine_bilinear(arr: np.ndarray, matrix) -> np.ndarray:
    """`img.transform(img.size, AFFINE, matrix, resample=BILINEAR)`
    (Geometry.c: `affine_transform` + `bilinear_filter32RGB`), vectorised
    over the image with one gather of the four neighbours."""
    a0, a1, a2, a3, a4, a5 = (float(m) for m in matrix[:6])
    h, w = arr.shape[:2]
    yc = np.arange(h, dtype=np.float64)[:, None] + 0.5
    xc = np.arange(w, dtype=np.float64)[None, :] + 0.5
    xin = a0 * xc + a1 * yc + a2
    yin = a3 * xc + a4 * yc + a5
    inside = (xin >= 0.0) & (xin < w) & (yin >= 0.0) & (yin < h)
    xin, yin = xin - 0.5, yin - 0.5
    x, y = np.floor(xin), np.floor(yin)
    dx, dy = (xin - x)[..., None], (yin - y)[..., None]
    x, y = x.astype(np.int64), y.astype(np.int64)
    x0, x1 = np.clip(x, 0, w - 1), np.clip(x + 1, 0, w - 1)
    # y + 1 past the last row: C takes v2 = v1; the clamped row gives the same value
    row0, row1 = np.clip(y, 0, h - 1) * w, np.clip(y + 1, 0, h - 1) * w
    flat = arr.reshape(h * w, -1)
    # the four neighbours in one gather: [4, H, W, C]
    tl, tr, bl, br = np.take(flat, np.stack([row0 + x0, row0 + x1, row1 + x0, row1 + x1]), axis=0).astype(np.float64)
    tr -= tl
    tr *= dx
    tl += tr  # v1 = a + (b - a) * dx, as BILINEAR() groups it
    br -= bl
    br *= dx
    bl += br  # v2
    bl -= tl
    bl *= dy
    tl += bl  # v1 + (v2 - v1) * dy
    np.trunc(tl, out=tl)
    tl *= inside[..., None]  # black outside the source image
    return tl.astype(np.uint8)


def rotate(arr: np.ndarray, angle: float) -> np.ndarray:
    """`img.rotate(angle, resample=BILINEAR)` (no expand, about the centre):
    Pillow's fast paths at 0 / 180 (and 90 / 270 of a square), else its
    matrix, rounded to 15 places, through `affine_bilinear`."""
    angle = angle % 360.0
    h, w = arr.shape[:2]
    if angle == 0:
        return arr.copy()
    if angle == 180:
        return np.ascontiguousarray(arr[::-1, ::-1])
    if angle in (90, 270) and w == h:
        return np.ascontiguousarray(np.rot90(arr, 1 if angle == 90 else -1))
    cx, cy = w / 2, h / 2
    rad = -math.radians(angle)
    a, b, d, e = round(math.cos(rad), 15), round(math.sin(rad), 15), round(-math.sin(rad), 15), round(math.cos(rad), 15)
    c, f = a * -cx + b * -cy + 0.0, d * -cx + e * -cy + 0.0
    return affine_bilinear(arr, (a, b, c + cx, d, e, f + cy))


# ---------------------------------------------------------------------------
# RandAugment (magnitude scale 0..10 like the reference palette)
# ---------------------------------------------------------------------------


def _identity(img, _):
    return img


def _autocontrast(img, _):
    return autocontrast(img)


def _equalize(img, _):
    return equalize(img)


def _brightness(img, level):
    # level in [0,10] -> enhancement factor around 1.0; ImageEnhance.Brightness blends with black
    return blend(np.zeros_like(img), img, 1.0 + (level / 10.0) * 0.9 * random.choice([-1, 1]))


def _sharpness(img, level):
    return blend(smooth(img), img, 1.0 + (level / 10.0) * 0.9 * random.choice([-1, 1]))


def _shear_x(img, level):
    v = (level / 10.0) * 0.3 * random.choice([-1, 1])
    return affine_bilinear(img, (1, v, 0, 0, 1, 0))


def _shear_y(img, level):
    v = (level / 10.0) * 0.3 * random.choice([-1, 1])
    return affine_bilinear(img, (1, 0, 0, v, 1, 0))


def _translate_x(img, level):
    v = (level / 10.0) * 0.45 * img.shape[1] * random.choice([-1, 1])
    return affine_bilinear(img, (1, 0, v, 0, 1, 0))


def _translate_y(img, level):
    v = (level / 10.0) * 0.45 * img.shape[0] * random.choice([-1, 1])
    return affine_bilinear(img, (1, 0, 0, 0, 1, v))


def _rotate(img, level):
    v = (level / 10.0) * 30 * random.choice([-1, 1])
    return rotate(img, v)


RANDAUG_OPS = {
    "Identity": _identity,
    "AutoContrast": _autocontrast,
    "Equalize": _equalize,
    "Brightness": _brightness,
    "Sharpness": _sharpness,
    "ShearX": _shear_x,
    "ShearY": _shear_y,
    "TranslateX": _translate_x,
    "TranslateY": _translate_y,
    "Rotate": _rotate,
}


class RandomAugment:
    """N random ops at magnitude M from the BLIP palette (reference randaugment.py)."""

    def __init__(self, n: int = 2, m: int = 5, augs: Optional[list] = None):
        self.n = n
        self.m = m
        self.augs = augs or list(RANDAUG_OPS.keys())

    def __call__(self, img):
        ops = random.choices(self.augs, k=self.n)
        for name in ops:
            img = RANDAUG_OPS[name](img, self.m)
        return img


def random_resized_crop(arr: np.ndarray, size: int, min_scale: float = 0.5, max_scale: float = 1.0,
                        ratio=(3 / 4, 4 / 3)) -> np.ndarray:
    """torchvision RandomResizedCrop semantics with bicubic resize, on uint8 [H, W, 3]."""
    h, w = arr.shape[:2]
    area = w * h
    for _ in range(10):
        target_area = area * random.uniform(min_scale, max_scale)
        log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
        aspect = float(np.exp(random.uniform(*log_ratio)))
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            left = random.randint(0, w - cw)
            top = random.randint(0, h - ch)
            return resize_uint8(arr, (size, size), BICUBIC, box=(left, top, left + cw, top + ch))
    # Fallback: center crop
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        cw, ch = int(round(h * ratio[1])), h
    else:
        cw, ch = w, h
    left, top = (w - cw) // 2, (h - ch) // 2
    return resize_uint8(arr, (size, size), BICUBIC, box=(left, top, left + cw, top + ch))


def blip_transform(image_size: int = 224, min_scale: float = 0.5, is_train: bool = True) -> Callable:
    """BLIP train/eval transform (reference blip_transform.py:8-49)."""
    randaug = RandomAugment(2, 5)

    def train_fn(arr: np.ndarray) -> np.ndarray:
        img = random_resized_crop(arr, image_size, min_scale=min_scale)
        if random.random() < 0.5:
            img = np.ascontiguousarray(img[:, ::-1])  # Image.FLIP_LEFT_RIGHT
        img = randaug(img)
        return to_normalized_array(img)

    def eval_fn(arr: np.ndarray) -> np.ndarray:
        return to_normalized_array(resize_uint8(arr, (image_size, image_size), BICUBIC))

    return train_fn if is_train else eval_fn


def raw_resize_uint8(image_size: int = 256) -> Callable:
    """Shortest-side resize to uint8 HWC, for a device-side preprocess path."""

    def fn(arr: np.ndarray) -> np.ndarray:
        return center_crop(resize_shortest_side(arr, image_size), image_size)

    return fn
