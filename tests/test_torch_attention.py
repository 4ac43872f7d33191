"""Kernels K1, K8, K9 and K10 (attention forward): each plain twin against its
JAX Pallas kernel, the static routes to each function's two kernels, and on
a card the CUDA kernels against the twins.

Inputs come from numpy with a seed and go through both frameworks as the
same bf16 values.  The JAX side runs `mha_paired_stack` (K1; K10 under
`UNIIR_ATTN_SPLITK=1`), `mha_nocausal` (K8) and `mha_paired` (K9) in
interpret mode, as the JAX package's own tests do on the CPU.  JAX is imported inside the
parity tests only, so the GPU cases also run on a host without it:
`python -m pytest tests/test_torch_attention.py -m gpu --noconftest`.
"""

import numpy as np
import pytest
import torch

from uniir_tpu_torch.ops.attention import (
    attention,
    attention_bwd,
    attention_bwd_general,
    attention_fwd_general,
    attention_reference,
    attention_splitk,
    attention_splitk_general,
    attention_splitk_reference,
    attention_twin,
    attention_twopass_reference,
    backward_route,
    forward_route,
    kernel_supported,
    mha_nocausal,
    mha_paired,
    norm_first_general,
    norm_first_route,
    splitk_applies,
    splitk_route,
)

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


# K8 / K9: the twin keeps `_attn_kernel`'s / `_paired_kernel`'s rounding
# points (fp32 scores scaled after the product, p = bf16(e / rowsum) before
# the PV product).  Measured bit-equal to both Pallas kernels in interpret
# mode on every case below; the tolerance stated is 0.
TWOPASS_ATOL = 0.0


def _qkv4(B, L, H, D, seed=0):
    return [t.view(B, L, H, D) for t in _qkv(B, L, H * D, seed)]


@pytest.mark.parametrize("L", [13, 21, 29, 32])
@pytest.mark.parametrize("D", [16, 64])
def test_mha_nocausal_twin_matches_pallas_kernel(L, D):
    from uniir_tpu.ops.attention_pallas import mha_nocausal as jax_mha_nocausal

    B, H = 2, 2
    q, k, v = _qkv4(B, L, H, D, seed=L)
    ref = jax_mha_nocausal(_jax(q), _jax(k), _jax(v), interpret=True)
    before = mha_nocausal.launches
    out = mha_nocausal(q, k, v)
    assert mha_nocausal.launches == before  # a CPU tensor runs the twin
    assert out.dtype == torch.bfloat16 and out.shape == (B, L, H, D)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), rtol=0, atol=TWOPASS_ATOL)


@pytest.mark.parametrize("L", [13, 21, 29, 32])
@pytest.mark.parametrize("D", [16, 64])
@pytest.mark.parametrize("causal", [False, True])
def test_mha_paired_twin_matches_pallas_kernel(L, D, causal):
    from uniir_tpu.ops.attention_pallas import mha_paired as jax_mha_paired

    B, H = 2, 2
    q, k, v = _qkv(B, L, H * D, seed=L + 1)
    ref = jax_mha_paired(_jax(q), _jax(k), _jax(v), H, interpret=True, causal=causal)
    before = mha_paired.launches
    out = mha_paired(q, k, v, H, causal=causal)
    assert mha_paired.launches == before
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), rtol=0, atol=TWOPASS_ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_twopass_twin_matches_mha_reference(causal):
    """Within 2e-2 of `mha_reference` on the same bf16 inputs, as
    tests/test_topk_pallas.py holds the Pallas kernels."""
    from uniir_tpu.ops.attention_pallas import mha_reference

    B, L, H, D = 2, 29, 2, 64
    q, k, v = _qkv(B, L, H * D, seed=4)
    ref = mha_reference(*(_jax(t.view(B, L, H, D)) for t in (q, k, v)), causal=causal)
    out = attention_twopass_reference(q, k, v, H, causal=causal)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32).reshape(B, L, H * D), atol=EINSUM_ATOL)
    if not causal:
        four = mha_nocausal(*(t.view(B, L, H, D) for t in (q, k, v)))
        torch.testing.assert_close(four.view(B, L, H * D), out, rtol=0, atol=0)


def test_standalone_wrappers_reject_bad_arguments():
    q, k, v = _qkv(1, 8, 128)
    with pytest.raises(ValueError):
        mha_nocausal(q, k, v)  # [B, L, H, D] wanted
    with pytest.raises(ValueError):
        mha_paired(q, k[:, :4], v, 2)
    with pytest.raises(ValueError):
        mha_paired(q, k, v, 3)


# ------------------------------------------------------------------- K10
# The split-K twin rounds at `_paired_stack_splitk_kernel`'s points (the last
# key's products rounded to bf16 one by one, its term added to the row sum
# after the main block's), so it may differ from the Pallas kernel only by
# the order of fp32 sums: the same 2 bf16 ulps of the output as K1.


@pytest.mark.parametrize("B,L,H,l_valid", [(2, 129, 2, None), (1, 257, 4, None), (2, 136, 2, 129)])
def test_splitk_twin_matches_pallas_splitk_kernel(monkeypatch, B, L, H, l_valid):
    from uniir_tpu.ops.attention_pallas import mha_paired_stack

    monkeypatch.setenv("UNIIR_ATTN_SPLITK", "1")
    D = 64
    q, k, v = _qkv(B, L, H * D, seed=L)
    ref = mha_paired_stack(_jax(q), _jax(k), _jax(v), H, D**-0.5, interpret=True, l_valid=l_valid)
    lv = l_valid or L
    before = attention_splitk.launches
    out = attention(q, k, v, H, D**-0.5, l_valid=l_valid, splitk=True)
    assert attention_splitk.launches == before  # a CPU tensor runs the twin
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    torch.testing.assert_close(out, attention_splitk_reference(q, k, v, H, D**-0.5, lv), rtol=0, atol=0)
    np.testing.assert_allclose(out.float().numpy()[:, :lv], np.asarray(ref, np.float32)[:, :lv],
                               rtol=PALLAS_RTOL, atol=PALLAS_ATOL)


def test_splitk_twin_is_not_k1_behind_a_view():
    """Same function, other rounding points: close to K1's twin (a few bf16
    steps) and not equal to it."""
    q, k, v = _qkv(2, 257, 128, seed=9)
    a = attention_splitk_reference(q, k, v, 2)
    b = attention_reference(q, k, v, 2)
    assert not torch.equal(a, b)
    torch.testing.assert_close(a.float(), b.float(), rtol=PALLAS_RTOL, atol=PALLAS_ATOL)


@pytest.mark.parametrize("L,causal,l_valid", [(130, False, None), (129, True, None), (77, True, None), (197, False, None),
                                              (257, False, 200), (128, False, None), (1, False, None),
                                              (257, True, None)])
def test_splitk_flag_runs_k1_where_the_condition_fails(monkeypatch, L, causal, l_valid):
    """`attention(..., splitk=True)` outside `l_valid % 128 == 1 and l_valid >
    128`, or causal: K1's twin, bit for bit, as `mha_paired_stack` keeps its
    base kernel there with the flag set."""
    from uniir_tpu.ops.attention_pallas import mha_paired_stack

    assert not splitk_applies(l_valid or L, causal)
    q, k, v = _qkv(1, L, 128, seed=L + 3)
    out = attention(q, k, v, 2, causal=causal, l_valid=l_valid, splitk=True)
    torch.testing.assert_close(out, attention_reference(q, k, v, 2, None, causal, l_valid), rtol=0, atol=0)
    if L in (130, 129):
        monkeypatch.setenv("UNIIR_ATTN_SPLITK", "1")
        flagged = mha_paired_stack(_jax(q), _jax(k), _jax(v), 2, interpret=True, causal=causal)
        monkeypatch.setenv("UNIIR_ATTN_SPLITK", "0")
        base = mha_paired_stack(_jax(q), _jax(k), _jax(v), 2, interpret=True, causal=causal)
        np.testing.assert_array_equal(np.asarray(flagged, np.float32), np.asarray(base, np.float32))


def test_splitk_condition_and_wrapper_arguments():
    assert splitk_applies(257, False) and splitk_applies(129, False) and splitk_applies(385, False)
    assert not splitk_applies(257, True) and not splitk_applies(1, False) and not splitk_applies(256, False)
    q, k, v = _qkv(1, 130, 128)
    with pytest.raises(ValueError, match="l_valid % 128 == 1"):
        attention_splitk(q, k, v, 2)
    out = attention_splitk(q, k, v, 2, l_valid=129)  # the valid length decides, not the array's
    torch.testing.assert_close(out, attention_splitk_reference(q, k, v, 2, None, 129), rtol=0, atol=0)


def test_splitk_forward_keeps_the_k3_backward():
    """The gradient of `attention(splitk=True)` is K3's twin on the same
    q, k, v, as `_paired_bwd` serves both forwards."""
    from uniir_tpu_torch.ops.attention import attention_bwd_reference

    q, k, v = (t.requires_grad_() for t in _qkv(1, 129, 128, seed=11))
    g = _qkv(1, 129, 128, seed=12)[0]
    out = attention(q, k, v, 2, splitk=True)
    out.backward(g)
    dq, dk, dv = attention_bwd_reference(q.detach(), k.detach(), v.detach(), g, 2)
    for got, want in ((q.grad, dq), (k.grad, dk), (v.grad, dv)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    twin = attention_twin(q.detach(), k.detach(), v.detach(), 2, splitk=True)
    torch.testing.assert_close(out.detach(), twin, rtol=0, atol=0)


# ------------------------------------------------------- the static route
# Which kernel a CUDA bf16 call launches is a rule over the shape alone
# (head width, length, whether a gradient will be asked), settled before any
# launch: the one-block-a-head kernels to L = 272, the general-length K1 to
# L = 848 and K3 to L = 544 (what their shared memory holds), no kernel for
# another head width or a longer sequence -- the layer then takes its einsum.
ROUTES = {  # L -> (forward, backward) at head width 64
    1: ("fused", "fused"), 77: ("fused", "fused"), 197: ("fused", "fused"), 257: ("fused", "fused"),
    334: ("general", "general"), 577: ("general", None), 900: (None, None),
}


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("L", sorted(ROUTES))
@pytest.mark.parametrize("D", [16, 64, 80])
def test_route_table(D, L, training):
    fwd, bwd = ROUTES[L] if D == 64 else (None, None)
    assert forward_route(D, L) == fwd and backward_route(D, L) == bwd
    want = fwd is not None and (not training or bwd is not None)
    assert kernel_supported(16, 16 * D, L, training) is want
    assert kernel_supported(12, 12 * D, L, training) is want  # the head count does not enter


@pytest.mark.parametrize("L,fwd,bwd", [(272, "fused", "fused"), (273, "general", "general"), (544, "general", "general"),
                                       (545, "general", None), (848, "general", None), (849, None, None)])
def test_route_edges(L, fwd, bwd):
    assert (forward_route(64, L), backward_route(64, L)) == (fwd, bwd)
    assert not kernel_supported(3, 100, L, False)  # a width the heads do not divide


def test_layer_on_the_cpu_runs_the_twin_at_any_head_width():
    """The rule guards CUDA launches only: a CPU bf16 tensor runs K1's twin
    through `attention` at `test-tiny`'s head width 16, as before."""
    from uniir_tpu_torch.models import layers

    torch.manual_seed(0)
    mha = layers.MultiHeadAttention(64, 4).bfloat16()
    x = torch.randn(2, 9, 64).bfloat16()
    q, k, v = layers.qkv_project(x, mha.in_proj_weight, mha.in_proj_bias, None)
    want = mha.out_proj(attention_reference(q, k, v, 4, 16**-0.5))
    assert not kernel_supported(4, 64, 9, False)
    torch.testing.assert_close(mha(x), want, rtol=0, atol=0)


# K8 / K9 and K10 have a static route of their own, as K1 has: the
# one-block-a-head kernel to L = 272 (K10: at l_valid = 129 or 257), the
# general-length kernel while its shared memory holds the keys (K8 / K9 to L =
# 848; K10 to l_valid = 769), no kernel past that or at another head width.
NORM_FIRST_ROUTES = {1: "fused", 50: "fused", 77: "fused", 197: "fused", 257: "fused", 272: "fused",
                     273: "general", 577: "general", 848: "general", 849: None, 900: None}


@pytest.mark.parametrize("L", sorted(NORM_FIRST_ROUTES))
@pytest.mark.parametrize("D", [16, 64, 80])
def test_norm_first_route_table(D, L):
    want = NORM_FIRST_ROUTES[L] if D == 64 else None
    assert norm_first_route(D, L) == want
    assert norm_first_route(D, L) == forward_route(D, L)  # the same shared-memory bounds as K1's two kernels


@pytest.mark.parametrize("L,l_valid,want", [
    (129, 129, "fused"), (136, 129, "fused"), (257, 257, "fused"), (264, 257, "fused"), (272, 257, "fused"),
    (273, 257, "general"), (300, 129, "general"), (385, 385, "general"), (400, 385, "general"),
    (769, 769, "general"), (897, 897, None), (130, 130, None), (256, 256, None), (257, 200, None), (1, 1, None),
])
def test_splitk_route_table(L, l_valid, want):
    assert splitk_route(64, L, l_valid) == want
    assert splitk_route(80, L, l_valid) is None  # no kernel at another head width
    # the route exists exactly where the split-K condition holds and a kernel fits
    assert (want is not None) <= splitk_applies(l_valid, causal=False)


def _all_counters():
    return (attention, attention_fwd_general, attention_splitk, attention_splitk_general, mha_nocausal, mha_paired,
            norm_first_general, attention_bwd, attention_bwd_general)


@pytest.mark.parametrize("L,causal", [(50, False), (77, True), (197, False), (300, True), (577, False)])
def test_cpu_norm_first_runs_the_twin_and_counts_no_launch(L, causal):
    """On CPU tensors `mha_paired` and `mha_nocausal` run the twin at every
    length, both routes' lengths included, and no counter moves."""
    B, H, D = 1, 2, 64
    q, k, v = _qkv(B, L, H * D, seed=L)
    before = [f.launches for f in _all_counters()]
    want = attention_twopass_reference(q, k, v, H, causal=causal)
    torch.testing.assert_close(mha_paired(q, k, v, H, causal=causal), want, rtol=0, atol=0)
    if not causal:
        four = mha_nocausal(*(t.view(B, L, H, D) for t in (q, k, v)))
        torch.testing.assert_close(four.view(B, L, H * D), want, rtol=0, atol=0)
    assert [f.launches for f in _all_counters()] == before


@pytest.mark.parametrize("L,l_valid", [(129, None), (136, 129), (257, None), (272, 257), (385, None), (400, 385)])
def test_cpu_splitk_runs_the_twin_and_counts_no_launch(L, l_valid):
    """`attention(splitk=True)` and `attention_splitk` on CPU tensors run
    K10's twin on both routes' lengths, and no counter moves."""
    q, k, v = _qkv(1, L, 128, seed=L + 7)
    lv = l_valid or L
    before = [f.launches for f in _all_counters()]
    want = attention_splitk_reference(q, k, v, 2, None, lv)
    torch.testing.assert_close(attention(q, k, v, 2, l_valid=l_valid, splitk=True), want, rtol=0, atol=0)
    torch.testing.assert_close(attention_splitk(q, k, v, 2, l_valid=l_valid), want, rtol=0, atol=0)
    assert [f.launches for f in _all_counters()] == before


def test_general_length_wrappers_take_cuda_tensors_only():
    """The general-length kernels have no CPU mode: their wrappers raise on a
    CPU tensor, as `attention_fwd_general` does."""
    q, k, v = _qkv(1, 385, 128)
    for call in (lambda: norm_first_general(q, k, v, 2), lambda: attention_splitk_general(q, k, v, 2),
                 lambda: attention_fwd_general(q, k, v, 2)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    with pytest.raises(ValueError, match="l_valid % 128 == 1"):
        attention_splitk_general(q, k, v, 2, l_valid=384)


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


# K8 / K9 on the card: the twin's rounding points; the fp32 row sum in
# another order can move a probability by one bf16 step: a couple of bf16
# ulps of outputs of magnitude < 4.
@pytest.mark.gpu
@pytest.mark.parametrize("B,L,H,causal", [(8, 197, 16, False), (8, 257, 16, False), (8, 77, 12, True), (3, 100, 3, True)])
def test_cuda_norm_first_kernel_matches_twin(cuda, B, L, H, causal):
    q, k, v = (t.to(cuda) for t in _qkv(B, L, H * 64, seed=5))
    before = mha_paired.launches
    out = mha_paired(q, k, v, H, causal=causal)
    torch.cuda.synchronize()
    assert mha_paired.launches == before + 1
    ref = attention_twopass_reference(q, k, v, H, causal=causal)
    torch.testing.assert_close(out.float(), ref.float(), rtol=PALLAS_RTOL, atol=PALLAS_ATOL)
    if not causal:
        before = mha_nocausal.launches
        four = mha_nocausal(*(t.view(B, L, H, 64) for t in (q, k, v)))
        torch.cuda.synchronize()
        assert mha_nocausal.launches == before + 1
        assert torch.equal(four.view(B, L, H * 64), out)  # the same kernel over the same memory
    with pytest.raises(ValueError):
        mha_paired(q[..., : H * 32].contiguous(), k[..., : H * 32].contiguous(), v[..., : H * 32].contiguous(), H)


@pytest.mark.gpu
def test_cuda_k1_at_blip_length(cuda):
    """K1 at BLIP's L = 197: rows 197..207 of the padded key tile are masked."""
    q, k, v = (t.to(cuda) for t in _qkv(8, 197, 1024, seed=6))
    out = attention(q, k, v, 16)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), attention_reference(q, k, v, 16).float(), rtol=PALLAS_RTOL, atol=PALLAS_ATOL)


# K10 on the card: the twin's rounding points, fp32 sums in another order.
@pytest.mark.gpu
@pytest.mark.parametrize("B,L,H,l_valid", [(8, 257, 16, None), (3, 129, 2, None), (2, 264, 4, 257)])
def test_cuda_splitk_kernel_matches_twin(cuda, B, L, H, l_valid):
    q, k, v = (t.to(cuda) for t in _qkv(B, L, H * 64, seed=7))
    lv = l_valid or L
    before = (attention.launches, attention_splitk.launches)
    out = attention(q, k, v, H, l_valid=l_valid, splitk=True)
    torch.cuda.synchronize()
    assert (attention.launches, attention_splitk.launches) == (before[0], before[1] + 1)
    ref = attention_splitk_reference(q, k, v, H, None, lv)
    torch.testing.assert_close(out.float()[:, :lv], ref.float()[:, :lv], rtol=PALLAS_RTOL, atol=PALLAS_ATOL)
    k1 = attention(q, k, v, H, l_valid=l_valid)
    torch.testing.assert_close(out.float()[:, :lv], k1.float()[:, :lv], rtol=PALLAS_RTOL, atol=PALLAS_ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("L,H,causal", [(197, 16, False), (77, 12, True)])
def test_cuda_splitk_flag_launches_k1_elsewhere(cuda, L, H, causal):
    q, k, v = (t.to(cuda) for t in _qkv(4, L, H * 64, seed=8))
    before = (attention.launches, attention_splitk.launches)
    out = attention(q, k, v, H, causal=causal, splitk=True)
    torch.cuda.synchronize()
    assert (attention.launches, attention_splitk.launches) == (before[0] + 1, before[1])
    assert torch.equal(out, attention(q, k, v, H, causal=causal))


# The one-block-a-head K1 at every tile count, with padding, small batches
# and both head counts; the same limits as above.
@pytest.mark.gpu
@pytest.mark.parametrize("H", [12, 16])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("L,causal,l_valid", [(1, False, None), (16, False, None), (64, False, None), (77, True, None),
                                              (197, False, None), (257, False, None), (272, False, None),
                                              (272, False, 257), (200, True, 130), (80, False, 3)])
def test_cuda_fused_k1_matches_twin(cuda, B, L, H, causal, l_valid):
    q, k, v = (t.to(cuda) for t in _qkv(B, L, H * 64, seed=L + H))
    lv = l_valid or L
    if l_valid:  # padding must not leak: NaN past l_valid in k and v
        k[:, lv:], v[:, lv:] = float("nan"), float("nan")
    before = (attention.launches, attention_fwd_general.launches)
    out = attention(q, k, v, H, causal=causal, l_valid=l_valid)
    torch.cuda.synchronize()
    assert (attention.launches, attention_fwd_general.launches) == (before[0] + 1, before[1])
    ref = attention_reference(q, k, v, H, causal=causal, l_valid=l_valid)
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), rtol=PALLAS_RTOL, atol=PALLAS_ATOL)
    old = attention_fwd_general(q, k, v, H, causal=causal, l_valid=l_valid)  # the general kernel takes short lengths too
    torch.testing.assert_close(old.float()[:, :lv], ref.float()[:, :lv], rtol=PALLAS_RTOL, atol=PALLAS_ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("L,causal", [(577, False), (273, True), (848, False)])
def test_cuda_general_k1_takes_the_long_lengths(cuda, L, causal):
    """L > 272 launches the general-length kernel (its own counter), e.g. a 384-pixel BLIP's 577 tokens."""
    q, k, v = (t.to(cuda) for t in _qkv(2, L, 16 * 64, seed=L))
    before = (attention.launches, attention_fwd_general.launches)
    out = attention(q, k, v, 16, causal=causal)
    torch.cuda.synchronize()
    assert (attention.launches, attention_fwd_general.launches) == (before[0], before[1] + 1)
    ref = attention_reference(q, k, v, 16, causal=causal)
    torch.testing.assert_close(out.float(), ref.float(), rtol=PALLAS_RTOL, atol=PALLAS_ATOL)
    with pytest.raises(ValueError, match="shared memory"):
        attention(*(t.to(cuda) for t in _qkv(1, 849, 64)), 1)


@pytest.mark.gpu
def test_cuda_layer_takes_the_einsum_where_no_kernel_fits(cuda):
    """Head width 16 in bf16 on the card: no launch and no error, the layer's
    einsum path; `test-tiny` serves and agrees with its fp32 self."""
    from uniir_tpu_torch.models.clip import CLIP_CONFIGS
    from uniir_tpu_torch.models.registry import seeded_clip_sf

    cfg = CLIP_CONFIGS["test-tiny"]
    rng = np.random.default_rng(0)
    txt = np.zeros((6, cfg.context_length), np.int64)
    for i in range(6):
        n = 3 + i
        txt[i, :n] = rng.integers(1, cfg.vocab_size - 1, n)
        txt[i, n] = cfg.vocab_size - 1
    img = rng.random((6, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    inputs = [torch.from_numpy(a).to(cuda) for a in (txt, img, np.array([1, 1, 0, 1, 0, 1]), np.array([1, 0, 1, 1, 1, 0]))]
    before = (attention.launches, attention_fwd_general.launches)
    with torch.inference_mode():
        low = seeded_clip_sf(cfg, cuda, seed=0, dtype=torch.bfloat16)(*inputs).float()
        full = seeded_clip_sf(cfg, cuda, seed=0, dtype=torch.float32)(*inputs).float()
    assert (attention.launches, attention_fwd_general.launches) == before
    assert torch.isfinite(low).all()
    assert torch.nn.functional.cosine_similarity(low, full, dim=1).min().item() >= 0.999


# The normalise-first variant of the one-block-a-head kernel (K8 / K9 to L =
# 272) at every tile count, small batches and both head counts; the limits of
# `test_cuda_norm_first_kernel_matches_twin`.  The general-length kernel on the
# same inputs, which it takes too.
@pytest.mark.gpu
@pytest.mark.parametrize("H", [12, 16])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("L,causal", [(1, False), (16, False), (64, False), (77, True), (197, False), (257, False),
                                      (272, False), (50, False), (130, True)])
def test_cuda_fused_norm_first_matches_twin(cuda, B, L, H, causal):
    q, k, v = (t.to(cuda) for t in _qkv(B, L, H * 64, seed=L + H + 1))
    before = (mha_paired.launches, mha_nocausal.launches, norm_first_general.launches)
    out = mha_paired(q, k, v, H, causal=causal)
    four = None if causal else mha_nocausal(*(t.view(B, L, H, 64) for t in (q, k, v)))
    torch.cuda.synchronize()
    assert (mha_paired.launches, mha_nocausal.launches, norm_first_general.launches) == (
        before[0] + 1, before[1] + (not causal), before[2])
    ref = attention_twopass_reference(q, k, v, H, causal=causal)
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), rtol=PALLAS_RTOL, atol=PALLAS_ATOL)
    if four is not None:
        assert torch.equal(four.view(B, L, H * 64), out)  # the same kernel over the same memory
    old = norm_first_general(q, k, v, H, causal=causal)
    torch.testing.assert_close(old.float(), ref.float(), rtol=PALLAS_RTOL, atol=PALLAS_ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("L,causal", [(577, False), (273, True), (848, False)])
def test_cuda_general_norm_first_takes_the_long_lengths(cuda, L, causal):
    """272 < L <= 848 launches K8 / K9's general-length kernel (its own counter); longer raises."""
    q, k, v = (t.to(cuda) for t in _qkv(2, L, 16 * 64, seed=L + 1))
    before = (mha_paired.launches, mha_nocausal.launches, norm_first_general.launches)
    out = mha_paired(q, k, v, 16, causal=causal)
    four = None if causal else mha_nocausal(*(t.view(2, L, 16, 64) for t in (q, k, v)))
    torch.cuda.synchronize()
    assert (mha_paired.launches, mha_nocausal.launches, norm_first_general.launches) == (
        before[0], before[1], before[2] + 1 + (not causal))
    ref = attention_twopass_reference(q, k, v, 16, causal=causal)
    torch.testing.assert_close(out.float(), ref.float(), rtol=PALLAS_RTOL, atol=PALLAS_ATOL)
    if four is not None:
        assert torch.equal(four.view(2, L, 16 * 64), out)
    with pytest.raises(ValueError, match="shared memory"):
        mha_paired(*(t.to(cuda) for t in _qkv(1, 849, 64)), 1)


# The one-block-a-head K10 at both main-block sizes, with L = l_valid and L >
# l_valid (query rows past l_valid compute like any other and are discarded;
# keys past l_valid are never staged: NaN there must not reach a valid row),
# against its twin and K1; the general-length kernel on the same inputs.
@pytest.mark.gpu
@pytest.mark.parametrize("H", [12, 16])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("L,l_valid", [(129, None), (136, 129), (257, None), (264, 257), (272, 257)])
def test_cuda_fused_splitk_matches_twin(cuda, B, L, H, l_valid):
    q, k, v = (t.to(cuda) for t in _qkv(B, L, H * 64, seed=L + H + 2))
    lv = l_valid or L
    k[:, lv:], v[:, lv:] = float("nan"), float("nan")
    counters = (attention, attention_splitk, attention_splitk_general)
    before = [f.launches for f in counters]
    out = attention(q, k, v, H, l_valid=l_valid, splitk=True)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == [0, 1, 0]
    assert torch.isfinite(out.float()[:, :lv]).all()
    ref = attention_splitk_reference(q, k, v, H, None, lv)
    torch.testing.assert_close(out.float()[:, :lv], ref.float()[:, :lv], rtol=PALLAS_RTOL, atol=PALLAS_ATOL)
    k1 = attention(q, k, v, H, l_valid=l_valid)
    torch.testing.assert_close(out.float()[:, :lv], k1.float()[:, :lv], rtol=PALLAS_RTOL, atol=PALLAS_ATOL)
    old = attention_splitk_general(q, k, v, H, l_valid=l_valid)
    torch.testing.assert_close(old.float()[:, :lv], ref.float()[:, :lv], rtol=PALLAS_RTOL, atol=PALLAS_ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("L,l_valid", [(385, None), (400, 385), (300, 257), (769, None)])
def test_cuda_general_splitk_takes_the_long_lengths(cuda, L, l_valid):
    """Where `splitk_route` says "general" the general-length K10 runs (its own counter)."""
    q, k, v = (t.to(cuda) for t in _qkv(2, L, 16 * 64, seed=L + 3))
    lv = l_valid or L
    counters = (attention, attention_fwd_general, attention_splitk, attention_splitk_general)
    before = [f.launches for f in counters]
    out = attention(q, k, v, 16, l_valid=l_valid, splitk=True)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == [0, 0, 0, 1]
    ref = attention_splitk_reference(q, k, v, 16, None, lv)
    torch.testing.assert_close(out.float()[:, :lv], ref.float()[:, :lv], rtol=PALLAS_RTOL, atol=PALLAS_ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,H,l_valid", [(3, 257, 16, None), (2, 136, 4, 129), (2, 385, 4, None)])
def test_cuda_gradients_through_splitk_match_the_twin(cuda, B, L, H, l_valid):
    """`attention(splitk=True)` (K10 forward, K3 backward) against
    `attention_twin(splitk=True)` on the same leaves."""
    q, k, v = (t.to(cuda) for t in _qkv(B, L, H * 64, seed=L + 4))
    g = _qkv(B, L, H * 64, seed=L + 5)[0].to(cuda)
    lv = l_valid or L
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = attention(*leaves, H, l_valid=l_valid, splitk=True)
    grads = torch.autograd.grad(out, leaves, g)
    twin = attention_twin(*leaves, H, l_valid=l_valid, splitk=True)
    twin_grads = torch.autograd.grad(twin, leaves, g)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float()[:, :lv], twin.float()[:, :lv], rtol=PALLAS_RTOL, atol=PALLAS_ATOL)
    for got, want in zip(grads, twin_grads):
        torch.testing.assert_close(got.float(), want.float(), rtol=PALLAS_RTOL, atol=PALLAS_ATOL)


# The `base` configs' shapes (ViT-B/32: vision L = 50, W = 768, H = 12; text
# L = 77, W = 512, H = 8, causal), which take the NT = 10 instantiations: K1,
# K3 and K8 / K9 against their twins.
@pytest.mark.gpu
@pytest.mark.parametrize("L,H,causal", [(50, 12, False), (77, 8, True)])
def test_cuda_base_shapes(cuda, L, H, causal):
    from uniir_tpu_torch.ops.attention import attention_bwd_reference

    q, k, v, g = (t.to(cuda) for t in _qkv(4, L, H * 64, seed=L + 6) + _qkv(4, L, H * 64, seed=L + 7)[:1])
    out = attention(q, k, v, H, causal=causal)
    torch.testing.assert_close(out.float(), attention_reference(q, k, v, H, causal=causal).float(),
                               rtol=PALLAS_RTOL, atol=PALLAS_ATOL)
    for got, want in zip(attention_bwd(q, k, v, g, H, causal=causal),
                         attention_bwd_reference(q, k, v, g, H, causal=causal)):
        torch.testing.assert_close(got.float(), want.float(), rtol=PALLAS_RTOL, atol=PALLAS_ATOL)
    torch.testing.assert_close(mha_paired(q, k, v, H, causal=causal).float(),
                               attention_twopass_reference(q, k, v, H, causal=causal).float(),
                               rtol=PALLAS_RTOL, atol=PALLAS_ATOL)
