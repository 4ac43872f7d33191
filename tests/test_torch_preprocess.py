"""The port's image transforms on uint8 arrays (no Pillow) against Pillow
and the JAX package's transforms on the same pixels: bit-equal."""

import sys

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from uniir_tpu.data import preprocess as jax_preprocess
from uniir_tpu_torch.data import preprocess
from uniir_tpu_torch.data.preprocess import BICUBIC, BILINEAR, center_crop, resize_uint8


def random_image(rng, w: int, h: int) -> np.ndarray:
    """Smooth gradients with noise: both the filters' edges and their flat parts matter."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(xx * 7 + yy * 3) % 256, (yy * 5) % 256, (xx * 2 + 40) % 256], axis=2)
    return np.clip(base + rng.normal(0, 30, base.shape), 0, 255).astype(np.uint8)


@settings(max_examples=80, deadline=None)
@given(w=st.integers(1, 600), h=st.integers(1, 600), ow=st.integers(1, 600), oh=st.integers(1, 600),
       resample=st.sampled_from([BICUBIC, BILINEAR]), seed=st.integers(0, 2**16))
def test_resize_equals_pillow(w, h, ow, oh, resample, seed):
    arr = random_image(np.random.default_rng(seed), w, h)
    ref = np.asarray(Image.fromarray(arr).resize((ow, oh), resample))
    np.testing.assert_array_equal(resize_uint8(arr, (ow, oh), resample), ref)


@settings(max_examples=60, deadline=None)
@given(w=st.integers(2, 300), h=st.integers(2, 300), out=st.integers(1, 300), frac=st.tuples(*[st.floats(0, 1)] * 4),
       resample=st.sampled_from([BICUBIC, BILINEAR]), integral=st.booleans(), seed=st.integers(0, 2**16))
def test_resize_with_box_equals_pillow(w, h, out, frac, resample, integral, seed):
    """RandomResizedCrop's call: a crop box (integral or not) resized to a square."""
    x0, x1 = sorted((frac[0] * w, frac[1] * w))
    y0, y1 = sorted((frac[2] * h, frac[3] * h))
    if integral:
        x0, x1, y0, y1 = int(x0), int(x1), int(y0), int(y1)
    if x1 - x0 < 0.5 or y1 - y0 < 0.5:
        return
    arr = random_image(np.random.default_rng(seed), w, h)
    ref = np.asarray(Image.fromarray(arr).resize((out, out), resample, box=(x0, y0, x1, y1)))
    np.testing.assert_array_equal(resize_uint8(arr, (out, out), resample, box=(x0, y0, x1, y1)), ref)


@pytest.mark.parametrize("size", [(1, 1), (5, 3), (64, 48), (30, 90), (224, 224), (257, 256), (500, 20), (333, 517)])
def test_eval_transforms_equal_jax_on_pillow_image(size):
    """clip_transform, BLIP's eval transform and raw_resize_uint8 on the array
    equal the JAX package's on the Pillow image of the same pixels."""
    arr = random_image(np.random.default_rng(size[0] * 1000 + size[1]), *size)
    img = Image.fromarray(arr)
    for ours, theirs in [(preprocess.clip_transform(224), jax_preprocess.clip_transform(224)),
                         (preprocess.clip_transform(32), jax_preprocess.clip_transform(32)),
                         (preprocess.blip_transform(384, is_train=False), jax_preprocess.blip_transform(384, is_train=False)),
                         (preprocess.raw_resize_uint8(256), jax_preprocess.raw_resize_uint8(256))]:
        a, b = ours(arr), theirs(img)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("w,h,size", [(10, 10, 4), (9, 7, 4), (3, 3, 8), (4, 9, 6), (1, 1, 3)])
def test_center_crop_equals_pillow_crop_box(w, h, size):
    """Pillow's crop box, zeros where it leaves the image."""
    arr = random_image(np.random.default_rng(w * h), w, h)
    left, top = (w - size) // 2, (h - size) // 2
    ref = np.asarray(Image.fromarray(arr).crop((left, top, left + size, top + size)))
    np.testing.assert_array_equal(center_crop(arr, size), ref)


def test_same_size_resize_is_a_copy():
    arr = random_image(np.random.default_rng(0), 7, 5)
    out = resize_uint8(arr, (7, 5))
    assert out is not arr
    np.testing.assert_array_equal(out, arr)


def test_train_only_transforms_name_what_needs_pillow(monkeypatch):
    """None of them needs Pillow now: with Pillow blocked, the eval
    transforms, the train transform and every RandAugment op run and give
    what they give with Pillow importable."""
    import random

    arr = random_image(np.random.default_rng(1), 40, 30)
    random.seed(3)
    train = [preprocess.blip_transform(32, is_train=True)(arr) for _ in range(4)]
    random.seed(4)
    ops = [fn(arr, 5) for fn in preprocess.RANDAUG_OPS.values()]
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert preprocess.clip_transform(32)(arr).shape == (32, 32, 3)
    assert preprocess.blip_transform(32, is_train=False)(arr).shape == (32, 32, 3)
    random.seed(3)
    for want in train:
        np.testing.assert_array_equal(preprocess.blip_transform(32, is_train=True)(arr), want)
    random.seed(4)
    for fn, want in zip(preprocess.RANDAUG_OPS.values(), ops):
        np.testing.assert_array_equal(fn(arr, 5), want)
