"""Kernel K3 (attention backward) and the differentiable `attention`: the plain
twin against the JAX Pallas kernel, and on a card the CUDA kernel against
the twin.

Inputs come from numpy with a seed and go through both frameworks as the
same bf16 values.  The JAX side runs `mha_paired_stack_bwd` in interpret
mode, as the JAX package's own tests do on the CPU.  JAX is imported inside
the parity tests only, so the GPU cases also run on a host without it:
`python -m pytest tests/test_torch_attention_bwd.py -m gpu --noconftest`.
"""

import numpy as np
import pytest
import torch

from uniir_tpu_torch.ops.attention import (
    attention,
    attention_bwd,
    attention_bwd_reference,
    attention_reference,
    attention_twin,
)

# The twin rounds at the Pallas kernel's points (bf16 q*scale and g, fp32 p,
# bf16 p for dv, bf16 ds, fp32 dq*scale, bf16 outputs), so the two differ
# only by the order of fp32 sums, which can flip the bf16 rounding of a ds
# or an output element: allow 2 bf16 ulps of gradients of magnitude < 4.
PALLAS_RTOL, PALLAS_ATOL = 1e-2, 1e-2
# Against the all-fp32 einsum VJP, the bf16 p and ds and the bf16 outputs
# add ~2^-8 relative error per term (the JAX package quotes ~6e-2 abs at
# CLIP-L shapes); these small shapes stay well inside that.
EINSUM_ATOL = 6e-2


def _inputs(B, L, W, seed=0):
    rng = np.random.default_rng(seed)
    # round through bf16 so both frameworks see identical values
    return [torch.from_numpy(rng.standard_normal((B, L, W)).astype(np.float32)).bfloat16() for _ in range(4)]


def _jax(t):
    import jax.numpy as jnp

    return jnp.asarray(t.float().numpy(), jnp.bfloat16)


@pytest.mark.parametrize(
    "B,L,H,D,causal",
    [
        (2, 17, 2, 64, False),  # L not a multiple of 8
        (2, 17, 2, 64, True),
        (2, 20, 4, 16, True),  # D=16
        (1, 33, 2, 16, False),
    ],
)
def test_twin_matches_pallas_kernel(B, L, H, D, causal):
    from uniir_tpu.ops.attention_pallas import mha_paired_stack_bwd

    q, k, v, g = _inputs(B, L, H * D)
    ref = mha_paired_stack_bwd(_jax(q), _jax(k), _jax(v), _jax(g), H, D**-0.5, interpret=True, causal=causal)
    out = attention_bwd_reference(q, k, v, g, H, D**-0.5, causal)
    for name, o, r in zip(("dq", "dk", "dv"), out, ref):
        assert o.dtype == torch.bfloat16 and o.shape == q.shape, name
        np.testing.assert_allclose(
            o.float().numpy(), np.asarray(r, np.float32), rtol=PALLAS_RTOL, atol=PALLAS_ATOL, err_msg=name
        )


@pytest.mark.parametrize("causal", [False, True])
def test_twin_matches_fp32_einsum_vjp(causal):
    import jax.numpy as jnp

    from uniir_tpu.ops.attention_pallas import _einsum_bwd

    B, L, H, D = 2, 19, 3, 32
    q, k, v, g = _inputs(B, L, H * D, seed=1)
    ref = _einsum_bwd(*(jnp.asarray(t.float().numpy()) for t in (q, k, v, g)), H, D**-0.5, causal)
    out = attention_bwd_reference(q, k, v, g, H, D**-0.5, causal)
    for name, o, r in zip(("dq", "dk", "dv"), out, ref):
        np.testing.assert_allclose(o.float().numpy(), np.asarray(r), atol=EINSUM_ATOL, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_nan_in_padding_cannot_leak(causal):
    """Rows past l_valid are zeroed by select: NaN there must not reach any
    gradient, rows past l_valid get zero gradients, and the valid rows equal
    the gradients of the truncated sequence."""
    B, L, H, D, lv = 1, 24, 2, 64, 19
    q, k, v, g = _inputs(B, L, H * D, seed=2)
    for t in (q, k, v, g):
        t[:, lv:] = float("nan")
    out = attention_bwd_reference(q, k, v, g, H, causal=causal, l_valid=lv)
    short = attention_bwd_reference(*(t[:, :lv] for t in (q, k, v, g)), H, causal=causal)
    for name, o, s in zip(("dq", "dk", "dv"), out, short):
        assert torch.isfinite(o.float()).all(), name
        assert (o[:, lv:] == 0).all(), name
        torch.testing.assert_close(o[:, :lv], s, rtol=PALLAS_RTOL, atol=PALLAS_ATOL, msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_autograd_through_attention_is_the_twin_on_cpu(causal):
    q, k, v, g = _inputs(2, 13, 128, seed=3)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (attention.launches, attention_bwd.launches)
    out = attention(*leaves, 2, causal=causal)
    grads = torch.autograd.grad(out, leaves, g)
    assert (attention.launches, attention_bwd.launches) == before  # CPU tensors launch no kernel
    torch.testing.assert_close(out, attention_reference(q, k, v, 2, causal=causal), rtol=0, atol=0)
    for got, want in zip(grads, attention_bwd_reference(q, k, v, g, 2, causal=causal)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    twin_grads = torch.autograd.grad(attention_twin(*leaves, 2, causal=causal), leaves, g)
    for got, want in zip(twin_grads, grads):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_bwd_wrapper_rejects_bad_arguments():
    q, k, v, g = _inputs(1, 8, 128)
    with pytest.raises(ValueError):
        attention_bwd(q, k, v, g[:, :4], 2)
    with pytest.raises(ValueError):
        attention_bwd(q, k, v, g, 3)
    with pytest.raises(ValueError):
        attention_bwd(q, k, v, g, 2, l_valid=0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


# Kernel vs twin on the card: same rounding points, fp32 sums in another
# order (and the row statistics of a separate pass) -> a couple of bf16 ulps.
@pytest.mark.gpu
@pytest.mark.parametrize(
    "B,L,H,causal,l_valid",
    [(8, 257, 16, False, None), (8, 77, 12, True, None), (3, 100, 3, False, None), (2, 40, 2, True, 33)],
)
def test_cuda_kernel_matches_twin(cuda, B, L, H, causal, l_valid):
    q, k, v, g = (t.to(cuda) for t in _inputs(B, L, H * 64, seed=4))
    before = attention_bwd.launches
    out = attention_bwd(q, k, v, g, H, causal=causal, l_valid=l_valid)
    torch.cuda.synchronize()
    assert attention_bwd.launches == before + 1
    ref = attention_bwd_reference(q, k, v, g, H, causal=causal, l_valid=l_valid)
    for name, o, r in zip(("dq", "dk", "dv"), out, ref):
        assert torch.isfinite(o.float()).all(), name
        torch.testing.assert_close(o.float(), r.float(), rtol=PALLAS_RTOL, atol=PALLAS_ATOL, msg=name)


@pytest.mark.gpu
def test_cuda_autograd_launches_k1_then_k3(cuda):
    q, k, v, g = (t.to(cuda) for t in _inputs(4, 77, 12 * 64, seed=5))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (attention.launches, attention_bwd.launches)
    grads = torch.autograd.grad(attention(*leaves, 12, causal=True), leaves, g)
    torch.cuda.synchronize()
    assert (attention.launches, attention_bwd.launches) == (before[0] + 1, before[1] + 1)
    for got, want in zip(grads, attention_bwd_reference(q, k, v, g, 12, causal=True)):
        torch.testing.assert_close(got.float(), want.float(), rtol=PALLAS_RTOL, atol=PALLAS_ATOL)
