"""BLIP's train-time transforms in the port (`random_resized_crop`, the flip
and RandAugment's ten ops on uint8 arrays, no Pillow) against the JAX
package's, which run on Pillow: the same array and the same `random.seed`
give bit-equal outputs, op by op, for the crop and for the whole
`blip_transform(is_train=True)`.  The ops' building blocks (`blend`,
`smooth`, `affine_bilinear`, `rotate`, the LUT ops) are also held to Pillow
directly at factors and angles the palette does not draw."""

import random

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image, ImageEnhance, ImageFilter, ImageOps

from uniir_tpu.data import preprocess as jax_preprocess
from uniir_tpu_torch.data import preprocess

OPS = list(preprocess.RANDAUG_OPS)


def random_image(seed: int, w: int, h: int, levels: int = 0) -> np.ndarray:
    """Gradients with noise; `levels` > 0 posterises to that many grey levels
    a channel (flat histograms for AutoContrast and Equalize's edge cases)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(xx * 7 + yy * 3) % 256, (yy * 5) % 256, (xx * 2 + 40) % 256], axis=2)
    arr = np.clip(base + rng.normal(0, 30, base.shape), 0, 255).astype(np.uint8)
    if levels:
        arr = (arr.astype(np.int64) * levels // 256 * (255 // max(1, levels - 1))).astype(np.uint8)
    return arr


def seed_drawing(sign: int) -> int:
    """A `random` seed whose first `random.choice([-1, 1])` is `sign`."""
    for s in range(100):
        random.seed(s)
        if random.choice([-1, 1]) == sign:
            return s
    raise AssertionError("no seed draws that sign")


@pytest.mark.parametrize("sign", [1, -1])
@pytest.mark.parametrize("op", OPS)
@settings(max_examples=12, deadline=None)
@given(w=st.integers(1, 300), h=st.integers(1, 300), seed=st.integers(0, 2**16), levels=st.sampled_from([0, 0, 1, 5]))
def test_randaugment_op_is_bit_equal_to_pillow(op, sign, w, h, seed, levels):
    """Each op at magnitude 5 (BLIP's), both signs of its draw, on the array
    and on the Pillow image of the same pixels; the same draws follow."""
    arr = random_image(seed, w, h, levels)
    s = seed_drawing(sign)
    random.seed(s)
    ours = preprocess.RANDAUG_OPS[op](arr, 5)
    after = random.random()
    random.seed(s)
    theirs = np.asarray(jax_preprocess.RANDAUG_OPS[op](Image.fromarray(arr), 5))
    assert random.random() == after  # the op drew as many numbers in both packages
    assert ours.dtype == np.uint8 and ours.shape == arr.shape
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("factor", [0.0, 0.1, 0.55, 1.0, 1.45, 1.9, 2.5])
def test_blend_and_smooth_equal_image_enhance(factor):
    """`ImageEnhance.Brightness` (a blend with black) and `Sharpness` (a
    blend with `ImageFilter.SMOOTH`), inside and outside [0, 1]."""
    for w, h in [(1, 1), (2, 7), (3, 3), (40, 31), (257, 64)]:
        arr = random_image(w * h, w, h)
        img = Image.fromarray(arr)
        np.testing.assert_array_equal(preprocess.smooth(arr), np.asarray(img.filter(ImageFilter.SMOOTH)))
        np.testing.assert_array_equal(preprocess.blend(np.zeros_like(arr), arr, factor),
                                      np.asarray(ImageEnhance.Brightness(img).enhance(factor)))
        np.testing.assert_array_equal(preprocess.blend(preprocess.smooth(arr), arr, factor),
                                      np.asarray(ImageEnhance.Sharpness(img).enhance(factor)))


@pytest.mark.parametrize("levels", [0, 1, 2, 3, 200])
def test_lut_ops_equal_image_ops(levels):
    """AutoContrast and Equalize on ordinary, flat and few-level histograms."""
    for w, h in [(1, 1), (5, 2), (64, 48), (300, 7)]:
        arr = random_image(levels + w, w, h, levels)
        img = Image.fromarray(arr)
        np.testing.assert_array_equal(preprocess.autocontrast(arr), np.asarray(ImageOps.autocontrast(img)))
        np.testing.assert_array_equal(preprocess.equalize(arr), np.asarray(ImageOps.equalize(img)))


@pytest.mark.parametrize("angle", [0.0, 7.5, 15.0, -15.0, 30.0, 90.0, 180.0, 270.0, -90.0, 359.0])
def test_rotate_equals_pillow(angle):
    """Pillow's fast paths (0, 180, and 90 / 270 of a square) and its matrix."""
    for w, h in [(1, 1), (2, 3), (16, 16), (37, 21), (120, 200)]:
        arr = random_image(w + h, w, h)
        np.testing.assert_array_equal(preprocess.rotate(arr, angle),
                                      np.asarray(Image.fromarray(arr).rotate(angle, resample=Image.BILINEAR)))


@settings(max_examples=40, deadline=None)
@given(w=st.integers(1, 120), h=st.integers(1, 120), m=st.tuples(*[st.floats(-3, 3, width=32)] * 6),
       seed=st.integers(0, 2**16))
def test_affine_bilinear_equals_pillow_transform(w, h, m, seed):
    """Any affine matrix, black outside the source, the edge clamped."""
    arr = random_image(seed, w, h)
    matrix = (m[0], m[1], m[2] * w, m[3], m[4], m[5] * h)
    ref = Image.fromarray(arr).transform((w, h), Image.AFFINE, matrix, resample=Image.BILINEAR)
    np.testing.assert_array_equal(preprocess.affine_bilinear(arr, matrix), np.asarray(ref))


@settings(max_examples=40, deadline=None)
@given(w=st.integers(1, 300), h=st.integers(1, 300), size=st.sampled_from([1, 16, 32, 224]),
       min_scale=st.sampled_from([0.05, 0.5, 1.0]), seed=st.integers(0, 2**16))
def test_random_resized_crop_equals_jax(w, h, size, min_scale, seed):
    """The crop box drawn alike (also the centre-crop fallback of a strip)
    and resized as `Image.resize(box=...)` does."""
    arr = random_image(seed, w, h)
    random.seed(seed)
    ours = preprocess.random_resized_crop(arr, size, min_scale=min_scale)
    random.seed(seed)
    theirs = np.asarray(jax_preprocess.random_resized_crop(Image.fromarray(arr), size, min_scale=min_scale))
    np.testing.assert_array_equal(ours, theirs)


@settings(max_examples=30, deadline=None)
@given(w=st.integers(1, 300), h=st.integers(1, 300), size=st.sampled_from([16, 48, 224]),
       seed=st.integers(0, 2**16), calls=st.integers(1, 4))
def test_blip_train_transform_is_bit_equal_to_jax(w, h, size, seed, calls):
    """crop, flip and RandAugment(2, 5), then normalisation: successive
    calls under one seed walk the same draws in both packages."""
    arr = random_image(seed, w, h)
    random.seed(seed)
    fn = preprocess.blip_transform(size, is_train=True)
    ours = [fn(arr) for _ in range(calls)]
    random.seed(seed)
    jfn = jax_preprocess.blip_transform(size, is_train=True)
    img = Image.fromarray(arr)
    theirs = [jfn(img) for _ in range(calls)]
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape == (size, size, 3)
        np.testing.assert_array_equal(a, b)


def test_flip_is_pillows_left_right_transpose():
    for w, h in [(1, 1), (5, 4), (224, 3)]:
        arr = random_image(w, w, h)
        np.testing.assert_array_equal(np.ascontiguousarray(arr[:, ::-1]),
                                      np.asarray(Image.fromarray(arr).transpose(Image.FLIP_LEFT_RIGHT)))
