"""Host-side image preprocessing (PIL/numpy): the port's copy of
uniir_tpu/data/preprocess.py, held equal to it by tests/test_torch_data.py.

Pillow is imported inside the functions that touch an image, never when the
module is imported: a serving host without Pillow still imports the port.

Produces HWC float32 numpy arrays (NHWC batches) with CLIP normalization
statistics.  Mirrors:
  * CLIP eval preprocess -- resize-shortest-side + center-crop + normalize
    (external `clip.load` transform, used at reference clip_sf.py:25,32-33)
  * BLIP train/eval transforms -- RandomResizedCrop(min_scale, bicubic) +
    HFlip + RandAugment(2 ops, magnitude 5) + normalize
    (reference src/models/uniir_blip/backbone/transform/blip_transform.py:8-49)
  * RandAugment 10-op palette (reference .../transform/randaugment.py)

These host transforms can emit either the fully normalized float image or
a raw uint8 resize for a device-side preprocessing path.
"""

from __future__ import annotations

import random
from typing import Callable, Optional

import numpy as np

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)

BICUBIC, BILINEAR = 3, 2  # PIL.Image.Resampling values
AFFINE, FLIP_LEFT_RIGHT = 0, 0  # PIL.Image.Transform.AFFINE, PIL.Image.Transpose.FLIP_LEFT_RIGHT


def to_normalized_array(img) -> np.ndarray:
    """PIL -> float32 HWC in CLIP-normalized space."""
    arr = np.asarray(img, dtype=np.float32) / 255.0
    return (arr - CLIP_MEAN) / CLIP_STD


def resize_shortest_side(img, size: int) :
    w, h = img.size
    if w <= h:
        new_w, new_h = size, max(1, round(h * size / w))
    else:
        new_w, new_h = max(1, round(w * size / h)), size
    return img.resize((new_w, new_h), BICUBIC)


def center_crop(img, size: int) :
    w, h = img.size
    left = (w - size) // 2
    top = (h - size) // 2
    return img.crop((left, top, left + size, top + size))


def clip_transform(image_size: int = 224) -> Callable:
    """The CLIP eval transform: shortest-side resize, center crop, normalize."""

    def fn(img) -> np.ndarray:
        img = resize_shortest_side(img, image_size)
        img = center_crop(img, image_size)
        return to_normalized_array(img)

    return fn


# ---------------------------------------------------------------------------
# RandAugment (PIL ops, magnitude scale 0..10 like the reference palette)
# ---------------------------------------------------------------------------


def _identity(img, _):
    return img


def _autocontrast(img, _):
    from PIL import ImageOps

    return ImageOps.autocontrast(img)


def _equalize(img, _):
    from PIL import ImageOps

    return ImageOps.equalize(img)


def _brightness(img, level):
    # level in [0,10] -> enhancement factor around 1.0
    from PIL import ImageEnhance

    return ImageEnhance.Brightness(img).enhance(1.0 + (level / 10.0) * 0.9 * random.choice([-1, 1]))


def _sharpness(img, level):
    from PIL import ImageEnhance

    return ImageEnhance.Sharpness(img).enhance(1.0 + (level / 10.0) * 0.9 * random.choice([-1, 1]))


def _shear_x(img, level):
    v = (level / 10.0) * 0.3 * random.choice([-1, 1])
    return img.transform(img.size, AFFINE, (1, v, 0, 0, 1, 0), resample=BILINEAR)


def _shear_y(img, level):
    v = (level / 10.0) * 0.3 * random.choice([-1, 1])
    return img.transform(img.size, AFFINE, (1, 0, 0, v, 1, 0), resample=BILINEAR)


def _translate_x(img, level):
    v = (level / 10.0) * 0.45 * img.size[0] * random.choice([-1, 1])
    return img.transform(img.size, AFFINE, (1, 0, v, 0, 1, 0), resample=BILINEAR)


def _translate_y(img, level):
    v = (level / 10.0) * 0.45 * img.size[1] * random.choice([-1, 1])
    return img.transform(img.size, AFFINE, (1, 0, 0, 0, 1, v), resample=BILINEAR)


def _rotate(img, level):
    v = (level / 10.0) * 30 * random.choice([-1, 1])
    return img.rotate(v, resample=BILINEAR)


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

    def __call__(self, img) :
        ops = random.choices(self.augs, k=self.n)
        for name in ops:
            img = RANDAUG_OPS[name](img, self.m)
        return img


def random_resized_crop(img, size: int, min_scale: float = 0.5, max_scale: float = 1.0, ratio=(3 / 4, 4 / 3)) :
    """torchvision RandomResizedCrop semantics with bicubic resize."""
    w, h = img.size
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
            return img.resize((size, size), BICUBIC, box=(left, top, left + cw, top + ch))
    # Fallback: center crop
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        cw, ch = int(round(h * ratio[1])), h
    else:
        cw, ch = w, h
    left, top = (w - cw) // 2, (h - ch) // 2
    return img.resize((size, size), BICUBIC, box=(left, top, left + cw, top + ch))


def blip_transform(image_size: int = 224, min_scale: float = 0.5, is_train: bool = True) -> Callable:
    """BLIP train/eval transform (reference blip_transform.py:8-49)."""
    randaug = RandomAugment(2, 5)

    def train_fn(img) -> np.ndarray:
        img = random_resized_crop(img, image_size, min_scale=min_scale)
        if random.random() < 0.5:
            img = img.transpose(FLIP_LEFT_RIGHT)
        img = randaug(img)
        return to_normalized_array(img)

    def eval_fn(img) -> np.ndarray:
        img = img.resize((image_size, image_size), BICUBIC)
        return to_normalized_array(img)

    return train_fn if is_train else eval_fn


def raw_resize_uint8(image_size: int = 256) -> Callable:
    """Shortest-side resize to uint8 HWC, for a device-side preprocess path."""

    def fn(img) -> np.ndarray:
        img = resize_shortest_side(img, image_size)
        img = center_crop(img, image_size)
        return np.asarray(img, dtype=np.uint8)

    return fn
