"""Kernel K7 (fused image preprocessing): the port's resize matrices, plain
path and twin against the JAX package's `image_ops`, and on a card the CUDA
kernel against the twin.

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


def _images(n, size, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)


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
