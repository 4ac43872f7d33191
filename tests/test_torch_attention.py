"""Kernel K1 (attention forward): the plain twin against the JAX Pallas kernel,
and on a card the CUDA kernel against the twin.

Inputs come from numpy with a seed and go through both frameworks as the
same bf16 values.  The JAX side runs `mha_paired_stack` in interpret mode,
as the JAX package's own tests do on the CPU.  JAX is imported inside the
parity tests only, so the GPU cases also run on a host without it:
`python -m pytest tests/test_torch_attention.py -m gpu --noconftest`.
"""

import numpy as np
import pytest
import torch

from uniir_tpu_torch.ops.attention import attention, attention_reference

# The twin rounds at the kernel's points (bf16 q*scale, fp32 softmax, bf16
# probabilities, fp32 PV, bf16 output), so it may differ from the Pallas
# kernel only by the order of fp32 sums: allow 2 bf16 ulps of the output.
PALLAS_RTOL, PALLAS_ATOL = 1e-2, 1e-2
# Against the all-fp32 einsum the bf16 probabilities and output add up to
# ~2^-8 relative error per element.
EINSUM_ATOL = 2e-2


def _qkv(B, L, W, seed=0):
    rng = np.random.default_rng(seed)
    # round through bf16 so both frameworks see identical values
    return [torch.from_numpy(rng.standard_normal((B, L, W)).astype(np.float32)).bfloat16() for _ in range(3)]


def _jax(t):
    import jax.numpy as jnp

    return jnp.asarray(t.float().numpy(), jnp.bfloat16)


@pytest.mark.parametrize(
    "B,L,H,D,causal,l_valid",
    [
        (2, 17, 2, 64, False, None),  # L not a multiple of 8
        (2, 17, 2, 64, True, 13),  # causal with l_valid < L
        (2, 20, 4, 16, True, None),
        (1, 33, 2, 64, False, 30),  # l_valid < L, non-causal
    ],
)
def test_twin_matches_pallas_kernel(B, L, H, D, causal, l_valid):
    from uniir_tpu.ops.attention_pallas import mha_paired_stack

    q, k, v = _qkv(B, L, H * D)
    ref = mha_paired_stack(_jax(q), _jax(k), _jax(v), H, D**-0.5, interpret=True, causal=causal, l_valid=l_valid)
    out = attention_reference(q, k, v, H, D**-0.5, causal, l_valid)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), rtol=PALLAS_RTOL, atol=PALLAS_ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_twin_matches_fp32_einsum(causal):
    import jax.numpy as jnp

    from uniir_tpu.ops.attention_pallas import _einsum_flat

    B, L, H, D = 2, 19, 3, 32
    q, k, v = _qkv(B, L, H * D, seed=1)
    ref = _einsum_flat(*(jnp.asarray(t.float().numpy()) for t in (q, k, v)), H, D**-0.5, causal)
    out = attention_reference(q, k, v, H, D**-0.5, causal)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref), atol=EINSUM_ATOL)


def test_masked_keys_cannot_leak_nan():
    """Keys and values past l_valid are masked by select: NaN there must not reach valid rows."""
    B, L, H, D, lv = 1, 24, 2, 64, 20
    q, k, v = _qkv(B, L, H * D, seed=2)
    k[:, lv:], v[:, lv:] = float("nan"), float("nan")
    out = attention_reference(q, k, v, H, causal=False, l_valid=lv)
    assert torch.isfinite(out[:, :lv].float()).all()


def test_cpu_tensor_runs_the_twin_and_counts_no_launch():
    q, k, v = _qkv(2, 9, 128)
    before = attention.launches
    out = attention(q, k, v, 2, causal=True)
    assert attention.launches == before
    torch.testing.assert_close(out, attention_reference(q, k, v, 2, causal=True), rtol=0, atol=0)


def test_wrapper_rejects_bad_arguments():
    q, k, v = _qkv(1, 8, 128)
    with pytest.raises(ValueError):
        attention(q, k[:, :4], v, 2)
    with pytest.raises(ValueError):
        attention(q, k, v, 3)
    with pytest.raises(ValueError):
        attention(q, k, v, 2, l_valid=9)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


# Kernel vs twin on the card: same rounding points, fp32 sums in another
# order -> at most a couple of bf16 ulps of the output.
@pytest.mark.gpu
@pytest.mark.parametrize("B,L,H,causal", [(8, 257, 16, False), (8, 77, 12, True), (3, 100, 3, False)])
def test_cuda_kernel_matches_twin(cuda, B, L, H, causal):
    q, k, v = (t.to(cuda) for t in _qkv(B, L, H * 64, seed=3))
    before = attention.launches
    out = attention(q, k, v, H, causal=causal)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    ref = attention_reference(q, k, v, H, causal=causal)
    torch.testing.assert_close(out.float(), ref.float(), rtol=PALLAS_RTOL, atol=PALLAS_ATOL)
