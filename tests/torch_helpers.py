"""Helpers shared by the port's tests (tests/test_torch_*.py)."""

from __future__ import annotations

from PIL import Image


def on_array(fn):
    """A transform of PIL images (the JAX package's, or tests.helpers') as
    the port's datasets call theirs: on the decoded uint8 HWC array, which
    is Pillow's pixels bit for bit (tests/test_torch_jpeg.py)."""

    def wrapped(arr):
        return fn(Image.fromarray(arr))

    return wrapped
