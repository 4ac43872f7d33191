"""Kernel K7 (fused image preprocessing): the port's resize matrices, their
band form, plain path and twin against the JAX package's `image_ops`, the
route table, and on a card both CUDA kernels (band and dense) against the
twin and against each other.

Inputs come from numpy with a seed.  The JAX side runs
`pallas_fused_preprocess` in interpret mode, as the JAX package's own tests
do on the CPU.  JAX is imported inside the parity tests only, so the GPU
cases also run on a host without it:
`python -m pytest tests/test_torch_image_ops.py -m gpu --noconftest`.
"""

import numpy as np
import pytest
import torch

from uniir_tpu_torch.ops import image_ops as T

# tests/test_image_ops.py's tolerance: fp32 sums of at most a few hundred
# terms in another order, on values of a few units.
ATOL = 1e-4
SIZES = [(48, 32), (256, 224), (32, 48)]  # downscale, the serving shape, upscale
# upscales where an output centre lands on a source pixel (odd : odd ratios): in bicubic that row's first
# tap is an exact zero, and the next row's first non-zero tap lies one source row earlier
ON_PIXEL = [(96, 224), (16, 48), (160, 224), (32, 224)]


def _images(n, size, seed=0, width=None):
    return np.random.default_rng(seed).integers(0, 256, (n, size, width or size, 3), dtype=np.uint8)


@pytest.mark.parametrize("src,dst", SIZES)
@pytest.mark.parametrize("method", ["bilinear", "bicubic"])
def test_resize_matrix_equals_jax(src, dst, method):
    from uniir_tpu.ops import image_ops as J

    ours, theirs = T.resize_matrix(src, dst, method), J.resize_matrix(src, dst, method)
    assert ours.dtype == np.float32 and ours.shape == (dst, src)
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(T.resize_matrix(src, dst, method, antialias=False),
                                  J.resize_matrix(src, dst, method, antialias=False))
    np.testing.assert_allclose(ours.sum(axis=1), 1.0, atol=1e-6)


@pytest.mark.parametrize("src,dst", SIZES)
@pytest.mark.parametrize("method", ["bilinear", "bicubic"])
def test_plain_path_and_twin_match_jax(src, dst, method):
    import jax.numpy as jnp

    from uniir_tpu.ops import image_ops as J

    img = _images(2, src, seed=src)
    t_img = torch.from_numpy(img)
    plain = T.preprocess_images(t_img, dst, method).numpy()
    twin = T.fused_preprocess(t_img, dst, method).numpy()  # a CPU tensor runs the twin
    assert plain.shape == twin.shape == (2, dst, dst, 3) and twin.dtype == np.float32
    np.testing.assert_allclose(plain, np.asarray(J.preprocess_images(jnp.asarray(img), dst, method)), atol=ATOL)
    kernel = np.asarray(J.pallas_fused_preprocess(jnp.asarray(img), dst, method, interpret=True))
    np.testing.assert_allclose(twin, kernel, atol=ATOL)
    np.testing.assert_allclose(twin, J.preprocess_reference_numpy(img, dst, method), atol=ATOL)
    np.testing.assert_array_equal(T.preprocess_reference_numpy(img, dst, method),
                                  J.preprocess_reference_numpy(img, dst, method))
    np.testing.assert_allclose(twin, plain, atol=ATOL)  # multiply by 1/255, 1/std against the divisions


@pytest.mark.parametrize("src,dst", SIZES + ON_PIXEL)
@pytest.mark.parametrize("method", ["bilinear", "bicubic"])
def test_resize_band_expands_to_the_matrix_bit_for_bit(src, dst, method):
    """The band kernel's form of each matrix: every window inside [0, src),
    the windows never stepping back, every non-zero entry inside its row's
    window, the weights copied."""
    first, weights = T.resize_band(src, dst, method)
    A = T.resize_matrix(src, dst, method)
    taps = weights.shape[1]
    assert first.dtype == np.int32 and weights.dtype == np.float32 and weights.shape == (dst, taps)
    assert (first >= 0).all() and (first + taps <= src).all()
    assert (np.diff(first) >= 0).all()
    expanded = np.zeros_like(A)
    np.put_along_axis(expanded, first[:, None] + np.arange(taps)[None, :], weights, axis=1)
    np.testing.assert_array_equal(expanded.view(np.uint32), A.view(np.uint32))
    # the band is as narrow as the widest row's span of non-zero taps
    spans = [np.flatnonzero(row)[-1] - np.flatnonzero(row)[0] + 1 for row in A]
    assert taps == max(spans)


@pytest.mark.parametrize("src,dst", SIZES + ON_PIXEL)
@pytest.mark.parametrize("method", ["bilinear", "bicubic"])
def test_band_strips_read_every_window_they_need(src, dst, method):
    """What the band kernel reads for a strip of BAND_ROWS output rows:
    `band_rows_in` rows from its first row's `first`.  Every row of the strip
    finds its whole window there, and `band_rows_in` is the largest such
    range."""
    first, weights = T.resize_band(src, dst, method)
    taps, rows_in, widest = weights.shape[1], T.band_rows_in(src, dst, method), 0
    for r0 in range(0, dst, T.BAND_ROWS):
        rows = np.arange(r0, min(r0 + T.BAND_ROWS, dst))
        lo, n_in = first[r0], first[rows[-1]] + taps - first[r0]
        assert (first[rows] >= lo).all() and (first[rows] + taps <= lo + n_in).all()
        assert lo + n_in <= src
        widest = max(widest, n_in)
    assert rows_in == widest


def _band_preprocess(img: np.ndarray, dst: int, method: str) -> np.ndarray:
    """The band kernel's function in numpy, from `resize_band` alone: each
    output row and column a weighted sum of its window's taps, then the
    normalisation."""
    _, H, W, _ = img.shape
    inv255, mean, inv_std = T._norm_constants()
    x = img.astype(np.float32) * np.float32(inv255)
    (fh, wh), (fw, ww) = T.resize_band(H, dst, method), T.resize_band(W, dst, method)
    rows = x[:, fh[:, None] + np.arange(wh.shape[1])[None, :]]  # [B, O, taps_h, W, 3]
    x = np.einsum("oj,bojwc->bowc", wh, rows)
    cols = x[:, :, fw[:, None] + np.arange(ww.shape[1])[None, :]]  # [B, O, O, taps_w, 3]
    x = np.einsum("pj,bopjc->bopc", ww, cols)
    return (x - np.float32(mean)) * np.float32(inv_std)


@pytest.mark.parametrize("src,dst", SIZES + [(16, 48)])
@pytest.mark.parametrize("method", ["bilinear", "bicubic"])
def test_banded_computation_matches_pallas_kernel(src, dst, method):
    import jax.numpy as jnp

    from uniir_tpu.ops import image_ops as J

    img = _images(2, src, seed=src + 1)
    kernel = np.asarray(J.pallas_fused_preprocess(jnp.asarray(img), dst, method, interpret=True))
    np.testing.assert_allclose(_band_preprocess(img, dst, method), kernel, atol=ATOL)


@pytest.mark.parametrize("H,W,O,method,want", [
    (256, 256, 224, "bicubic", "band"),  # the BLIP paths' call: 22.5 KB a block
    (256, 256, 224, "bilinear", "band"),
    (48, 48, 32, "bicubic", "band"), (32, 48, 48, "bilinear", "band"), (256, 192, 224, "bicubic", "band"),
    (1024, 1024, 224, "bicubic", "band"),  # 33 source rows of 3 KB beside the [4, 3072] fp32 intermediate: 147 KB
    (256, 256, 16, "bicubic", "band"),  # 16x down: 112 source rows a strip, 96 KB
    (280, 280, 4, "bicubic", "dense"),  # 70x down: all 280 rows of 840 bytes a strip, 243 KB; the plane fits
    (256, 320, 4, "bicubic", "dense"),
    (4096, 4096, 224, "bilinear", None),  # neither: 92 rows of 12 KB; a 16 MB plane
])
def test_preprocess_route_table(H, W, O, method, want):
    """The band kernel where its strip (its source rows as bytes, the fp32
    intermediate) fits in a block's shared memory, the dense kernel where
    only its uint8 plane and strips do, none past both."""
    assert T.preprocess_route(H, W, O, method) == want
    assert (T.band_smem_bytes(H, W, O, method) <= T.MAX_SMEM_BYTES) == (want == "band")


def test_cpu_tensor_runs_the_twin_through_both_kernels_and_counts_no_launch():
    img = torch.from_numpy(_images(2, 20, seed=4, width=24))
    before = (T.fused_preprocess.launches, T.fused_preprocess_dense.launches)
    want = T.fused_preprocess_reference(img, 8, "bicubic", torch.bfloat16)
    for fn in (T.fused_preprocess, T.fused_preprocess_dense):
        torch.testing.assert_close(fn(img, 8, "bicubic", torch.bfloat16), want, rtol=0, atol=0)
    assert (T.fused_preprocess.launches, T.fused_preprocess_dense.launches) == before


def test_twin_bf16_output_matches_jax():
    import jax.numpy as jnp

    from uniir_tpu.ops import image_ops as J

    img = _images(2, 48, seed=3)
    ref = np.asarray(J.pallas_fused_preprocess(jnp.asarray(img), 32, "bicubic", jnp.bfloat16, interpret=True), np.float32)
    out = T.fused_preprocess(torch.from_numpy(img), 32, "bicubic", torch.bfloat16)
    assert out.dtype == torch.bfloat16
    # one rounding of values below 4 to bf16 (2^-7 relative) on top of ATOL
    np.testing.assert_allclose(out.float().numpy(), ref, atol=2.0**-6)


def test_constant_image_maps_to_the_normalised_constant():
    from uniir_tpu_torch.data.preprocess import CLIP_MEAN, CLIP_STD

    img = np.full((1, 40, 40, 3), 128, np.uint8)
    out = T.fused_preprocess(torch.from_numpy(img), 24, "bicubic").numpy()
    np.testing.assert_allclose(out, np.broadcast_to((128 / 255.0 - CLIP_MEAN) / CLIP_STD, out.shape), atol=ATOL)


def test_cpu_tensor_runs_the_twin_and_counts_no_launch():
    img = torch.from_numpy(_images(1, 16))
    before = T.fused_preprocess.launches
    out = T.fused_preprocess(img, 8)
    assert T.fused_preprocess.launches == before
    torch.testing.assert_close(out, T.fused_preprocess_reference(img, 8), rtol=0, atol=0)


def test_wrapper_rejects_bad_arguments():
    img = torch.from_numpy(_images(1, 16))
    with pytest.raises(ValueError):
        T.fused_preprocess(img.float(), 8)
    with pytest.raises(ValueError):
        T.fused_preprocess(img[..., :2], 8)
    with pytest.raises(ValueError):
        T.fused_preprocess(img, 8, out_dtype=torch.float16)
    with pytest.raises(ValueError):
        T.fused_preprocess_dense(img.float(), 8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


# Kernel vs twin on the card: the same fp32 FMAs in the same order, against
# a library product that may sum in another order.
@pytest.mark.gpu
@pytest.mark.parametrize("B,src,dst", [(8, 256, 224), (3, 48, 32), (2, 32, 48), (2, 50, 30)])
@pytest.mark.parametrize("method,out_dtype", [("bilinear", torch.float32), ("bicubic", torch.bfloat16)])
def test_cuda_kernel_matches_twin(cuda, B, src, dst, method, out_dtype):
    img = torch.from_numpy(_images(B, src, seed=1)).to(cuda)
    before = T.fused_preprocess.launches
    out = T.fused_preprocess(img, dst, method, out_dtype)
    torch.cuda.synchronize()
    assert T.fused_preprocess.launches == before + 1
    assert out.shape == (B, dst, dst, 3) and out.dtype == out_dtype
    ref = T.fused_preprocess_reference(img, dst, method, out_dtype)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=ATOL if out_dtype == torch.float32 else 2.0**-6)
    numpy_ref = torch.from_numpy(T.preprocess_reference_numpy(img.cpu().numpy(), dst, method)).to(cuda)
    torch.testing.assert_close(out.float(), numpy_ref.float(), rtol=0, atol=ATOL if out_dtype == torch.float32 else 2.0**-6)


# The band kernel against the dense one: the same rounding points, the skipped taps zero, so bit-equal;
# both against the twin.  Square and rectangular images, B = 1 and B = 300, an O that is not a multiple of
# the band kernel's 4-row strip (30, 45), rows of W * 3 bytes that are not a multiple of 16 (50, 75), an
# 8x downscale (56 source rows a strip in bicubic), and upscales whose output centres land on source pixels
# (96 -> 224, 16 -> 48: in bicubic a row starts one source row before the row above it).
@pytest.mark.gpu
@pytest.mark.parametrize("B,H,W,dst", [(8, 256, 256, 224), (3, 48, 48, 32), (2, 32, 32, 48), (2, 50, 50, 30),
                                       (2, 256, 192, 224), (2, 64, 75, 45), (1, 256, 256, 224), (300, 64, 64, 56),
                                       (3, 256, 256, 32), (2, 96, 96, 224), (2, 16, 16, 48), (2, 96, 160, 224)])
@pytest.mark.parametrize("method,out_dtype", [("bilinear", torch.float32), ("bicubic", torch.bfloat16)])
def test_cuda_band_kernel_is_bit_equal_to_the_dense_kernel(cuda, B, H, W, dst, method, out_dtype):
    img = torch.from_numpy(_images(B, H, seed=H + W, width=W)).to(cuda)
    assert T.preprocess_route(H, W, dst, method) == "band"
    before = (T.fused_preprocess.launches, T.fused_preprocess_dense.launches)
    band = T.fused_preprocess(img, dst, method, out_dtype)
    dense = T.fused_preprocess_dense(img, dst, method, out_dtype)
    torch.cuda.synchronize()
    assert (T.fused_preprocess.launches, T.fused_preprocess_dense.launches) == (before[0] + 1, before[1] + 1)
    assert band.shape == (B, dst, dst, 3) and band.dtype == out_dtype
    assert torch.equal(band.view(torch.int16 if out_dtype == torch.bfloat16 else torch.int32),
                       dense.view(torch.int16 if out_dtype == torch.bfloat16 else torch.int32))
    ref = T.fused_preprocess_reference(img, dst, method, out_dtype)
    torch.testing.assert_close(band.float(), ref.float(), rtol=0, atol=ATOL if out_dtype == torch.float32 else 2.0**-6)


@pytest.mark.gpu
def test_cuda_dense_route_where_the_band_does_not_fit(cuda):
    """A 64x / 80x downscale: `fused_preprocess` launches the dense kernel,
    on its counter."""
    img = torch.from_numpy(_images(2, 256, seed=9, width=320)).to(cuda)
    assert T.preprocess_route(256, 320, 4, "bicubic") == "dense"
    before = (T.fused_preprocess.launches, T.fused_preprocess_dense.launches)
    out = T.fused_preprocess(img, 4, "bicubic", torch.float32)
    torch.cuda.synchronize()
    assert (T.fused_preprocess.launches, T.fused_preprocess_dense.launches) == (before[0], before[1] + 1)
    torch.testing.assert_close(out, T.fused_preprocess_reference(img, 4, "bicubic"), rtol=0, atol=ATOL)
