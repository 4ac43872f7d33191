"""Kernel K6's plain twin (`uniir_tpu_torch/ops/mlp.py`) against the JAX
package's fused int8 MLP (`uniir_tpu/ops/mlp_pallas.py`, interpret mode, as
tests/test_mlp_pallas.py runs it) and its jnp oracle, on the same seeded
inputs.  GPU cases hold the CUDA kernel against the twin on a card:
`python -m pytest tests/test_torch_mlp_int8.py -m gpu --noconftest`.

Tolerances.  Integer sums are exact on both sides and every fp32 step is
rounded alike, so twin and Pallas kernel can differ only where the
activation's transcendental (exp, erf, tanh) differs by an ulp between
XLA and PyTorch AND the second quantisation rounds that to another integer.
One hidden integer off by one moves an output by a2 * w2_scale * 127 at
most (~1e-3 here), far below a bf16 step of the outputs (|y| ~ 1-4: 2^-7
to 2^-6).  The last fp32 steps (acc * scale + bias + res) may be contracted
into fused multiply-adds by XLA's CPU compiler, which moves an output that
sits on a bf16 rounding boundary by one step.  So: the share of hidden
integers that differ is at most HIDDEN_FLIP_SHARE (measured here: none),
none differs by more than one step, and outputs agree to OUT_ULPS bf16
steps (measured: 0 or 1).
"""

import numpy as np
import pytest
import torch

from uniir_tpu_torch.ops import mlp as M_
from uniir_tpu_torch.ops.quant import quantize_weight

HIDDEN_FLIP_SHARE = 1e-3
OUT_ULPS = 1
ACTS = ["quick_gelu", "gelu", "gelu_tanh"]


def _case(M, W=256, H=512, seed=0, lead=None):
    rng = np.random.default_rng(seed)
    shape = (M, W) if lead is None else (*lead, W)
    h = (rng.normal(size=shape) * 0.5).astype(np.float32)
    res = rng.normal(size=shape).astype(np.float32)
    w1 = (rng.normal(size=(W, H)) * 0.05).astype(np.float32)
    w2 = (rng.normal(size=(H, W)) * 0.05).astype(np.float32)
    b1 = (rng.normal(size=(H,)) * 0.1).astype(np.float32)
    b2 = (rng.normal(size=(W,)) * 0.1).astype(np.float32)
    a1 = np.float32(np.abs(h).max() / 127.0)
    a2 = np.float32(0.5 * np.abs(h.reshape(-1, W) @ w1 + b1).max() / 127.0)  # the top of the hidden clips
    return h, res, w1, b1, w2, b2, a1, a2


def _jax_args(h, res, w1, b1, w2, b2, a1, a2):
    import jax.numpy as jnp

    from uniir_tpu.ops.quant import quantize_weight as jax_quantize_weight

    w1q, s1 = jax_quantize_weight(w1)
    w2q, s2 = jax_quantize_weight(w2)
    return (jnp.asarray(h, jnp.bfloat16), jnp.asarray(res, jnp.bfloat16), jnp.asarray(w1q), jnp.asarray(s1),
            jnp.asarray(b1), jnp.asarray(w2q), jnp.asarray(s2), jnp.asarray(b2), jnp.float32(a1), jnp.float32(a2))


def _port_args(h, res, w1, b1, w2, b2, a1, a2):
    w1q, s1 = quantize_weight(torch.from_numpy(w1.T.copy()))
    w2q, s2 = quantize_weight(torch.from_numpy(w2.T.copy()))
    return (torch.from_numpy(h).bfloat16(), torch.from_numpy(res).bfloat16(), w1q, s1, torch.from_numpy(b1), w2q, s2,
            torch.from_numpy(b2), float(a1), float(a2))


def _bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    ia, ib = a.bfloat16().view(torch.int16).int(), b.bfloat16().view(torch.int16).int()
    ia, ib = torch.where(ia < 0, -(ia & 0x7FFF), ia), torch.where(ib < 0, -(ib & 0x7FFF), ib)
    return int((ia - ib).abs().max())


def _jax_hidden(args, act):
    """The Pallas kernel's quantised hidden, recomputed with its own jnp steps."""
    import jax
    import jax.numpy as jnp

    from uniir_tpu.ops.mlp_pallas import _act

    h, _, w1q, s1, b1, _, _, _, a1, a2 = args
    xq = jnp.clip(jnp.round(h.astype(jnp.float32) * (1.0 / a1)), -127.0, 127.0).astype(jnp.int8)
    acc = jax.lax.dot_general(xq, w1q, (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32)
    hf = _act(act, acc.astype(jnp.float32) * (a1 * s1)[None, :] + b1[None, :])
    return np.asarray(jnp.clip(jnp.round(hf * (1.0 / a2)), -127.0, 127.0).astype(jnp.int8))


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("M", [128, 200])  # 200 leaves a ragged last row block
def test_twin_matches_pallas_kernel_interpreted(M, act):
    from uniir_tpu.ops.mlp_pallas import fused_int8_mlp

    case = _case(M)
    jargs, pargs = _jax_args(*case), _port_args(*case)
    ref = torch.from_numpy(np.asarray(fused_int8_mlp(*jargs, act=act, tm=128, interpret=True), np.float32))
    out = M_.int8_mlp(*pargs, act=act)
    assert out.dtype == torch.bfloat16 and out.shape == (M, 256)
    hidden = M_.int8_mlp_hidden(pargs[0], *pargs[2:5], *pargs[8:], act=act).numpy().astype(np.int32)
    diff = np.abs(hidden - _jax_hidden(jargs, act).astype(np.int32))
    share = float((diff != 0).mean())
    print(f"act={act} M={M}: hidden integers that differ: {share:.2e}, largest step {diff.max()}, "
          f"output bf16 steps {_bf16_ulps(out.float(), ref)}")
    assert diff.max() <= 1 and share <= HIDDEN_FLIP_SHARE
    assert (np.abs(hidden) == 127).mean() > 0  # the clip is exercised
    assert _bf16_ulps(out.float(), ref) <= OUT_ULPS


@pytest.mark.parametrize("act", ACTS)
def test_twin_matches_jnp_oracle_and_port_reference(act):
    """`reference_int8_mlp` divides by a1, a2 where the kernel multiplies by
    their fp32 reciprocals: a rare input on a rounding boundary lands one
    integer off.  Same bounds as against the kernel."""
    from uniir_tpu.ops.mlp_pallas import reference_int8_mlp

    case = _case(160, seed=1)
    jargs, pargs = _jax_args(*case), _port_args(*case)
    oracle = torch.from_numpy(np.asarray(reference_int8_mlp(*jargs[:8], case[6], case[7], act=act), np.float32))
    out = M_.int8_mlp(*pargs, act=act)
    assert _bf16_ulps(out.float(), oracle) <= OUT_ULPS
    assert _bf16_ulps(M_.reference_int8_mlp(*pargs, act=act).float(), oracle) <= OUT_ULPS
    # and the int8 math tracks the float MLP (static-scale sanity)
    h, res, w1, b1, w2, b2 = (torch.from_numpy(x) for x in case[:6])
    y_f = M_._act(act, h.bfloat16().float() @ w1 + b1) @ w2 + b2 + res
    assert torch.nn.functional.cosine_similarity(out.float().flatten(), y_f.flatten(), dim=0) > 0.995


def test_3d_leading_dims_and_fp32_inputs():
    from uniir_tpu.ops.mlp_pallas import fused_int8_mlp

    case = _case(0, lead=(4, 32), seed=2)
    jargs, pargs = _jax_args(*case), _port_args(*case)
    ref = torch.from_numpy(np.asarray(fused_int8_mlp(*jargs, interpret=True), np.float32))
    out = M_.int8_mlp(*pargs)
    assert out.shape == (4, 32, 256) and out.dtype == torch.bfloat16
    assert _bf16_ulps(out.float(), ref) <= OUT_ULPS
    # fp32 h / res are cast to bf16 first, as the TPU kernel casts them
    out32 = M_.int8_mlp(torch.from_numpy(case[0]), torch.from_numpy(case[1]), *pargs[2:])
    assert torch.equal(out32, out)


def test_support_gate_and_argument_checks():
    assert M_.int8_mlp_supported(1024, 4096, "quick_gelu") and M_.int8_mlp_supported(768, 3072, "gelu")
    assert M_.int8_mlp_supported(32, 128, "gelu_tanh")  # narrow test widths run the kernel too
    assert not M_.int8_mlp_supported(1000, 4000, "quick_gelu")  # not cut into 32-value steps
    # the hidden no longer lives in a block's shared memory: no width limit
    assert M_.int8_mlp_supported(1440, 5760, "quick_gelu") and M_.int8_mlp_supported(2048, 8192, "quick_gelu")
    assert not M_.int8_mlp_supported(1024, 4096, "relu")
    pargs = _port_args(*_case(8))
    with pytest.raises(ValueError, match="activation"):
        M_.int8_mlp(*pargs, act="relu")
    with pytest.raises(ValueError, match="do not form an MLP"):
        M_.int8_mlp(pargs[0], pargs[1][:4], *pargs[2:])
    with pytest.raises(RuntimeError, match="inference only"):
        M_.int8_mlp(pargs[0].float().requires_grad_(), *pargs[1:])


@pytest.mark.parametrize("act", ACTS)
def test_twin_at_a_width_the_old_gate_refused(act):
    """W = 1440, H = 5760: the smallest CLIP-shaped MLP whose 32-row hidden
    did not fit the old kernel's shared memory, which the gate now takes.
    The twin against the JAX package's jnp oracle, as at the small widths
    (the Pallas kernel refuses widths that are not multiples of 128)."""
    from uniir_tpu.ops.mlp_pallas import reference_int8_mlp

    case = _case(6, W=1440, H=5760, seed=3)
    jargs, pargs = _jax_args(*case), _port_args(*case)
    oracle = torch.from_numpy(np.asarray(reference_int8_mlp(*jargs[:8], case[6], case[7], act=act), np.float32))
    out = M_.int8_mlp(*pargs, act=act)
    assert out.shape == (6, 1440) and _bf16_ulps(out.float(), oracle) <= OUT_ULPS


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("M,W", [(257 * 4, 1024), (77 * 3, 768), (50, 96)])
def test_kernel_matches_twin_on_card(cuda, M, W, act):
    """K6 against its twin: exact integer sums, the same fp32 steps; only the
    transcendental's last ulp can move a hidden integer by one."""
    H = 4 * W
    g = torch.Generator(device="cuda").manual_seed(0)
    h = (torch.randn(M, W, generator=g, device=cuda) * 0.5).bfloat16()
    res = torch.randn(M, W, generator=g, device=cuda).bfloat16()
    w1q, s1 = quantize_weight(torch.randn(H, W, generator=g, device=cuda) * W**-0.5)
    w2q, s2 = quantize_weight(torch.randn(W, H, generator=g, device=cuda) * H**-0.5)
    b1, b2 = torch.randn(H, generator=g, device=cuda) * 0.1, torch.randn(W, generator=g, device=cuda) * 0.1
    a1, a2 = float(h.abs().max()) / 127.0, 2.0 / 127.0
    before = M_.int8_mlp.launches
    out = M_.int8_mlp(h, res, w1q, s1, b1, w2q, s2, b2, a1, a2, act=act)
    torch.cuda.synchronize()
    assert M_.int8_mlp.launches - before == 1
    ref = M_.int8_mlp_twin(h, res, w1q, s1, b1, w2q, s2, b2, a1, a2, act=act)
    assert _bf16_ulps(out.float().cpu(), ref.float().cpu()) <= OUT_ULPS


@pytest.mark.gpu
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("W", [96, 768, 1024])
@pytest.mark.parametrize("M", [1, 50, 1028, 16448])
def test_kernel_matches_twin_at_tile_edges(cuda, M, W, act):
    """K6 at the edges of the main loop's 128-row tiles (M = 1, 50, 1028) and
    at the vision batch's 16448 rows, at three widths: within one bf16 step
    of the twin on at most 1e-3 of the outputs, and one count a call for its
    three launches."""
    H = 4 * W
    g = torch.Generator(device="cuda").manual_seed(M + W)
    h = (torch.randn(M, W, generator=g, device=cuda) * 0.5).bfloat16()
    res = torch.randn(M, W, generator=g, device=cuda).bfloat16()
    w1q, s1 = quantize_weight(torch.randn(H, W, generator=g, device=cuda) * W**-0.5)
    w2q, s2 = quantize_weight(torch.randn(W, H, generator=g, device=cuda) * H**-0.5)
    b1, b2 = torch.randn(H, generator=g, device=cuda) * 0.1, torch.randn(W, generator=g, device=cuda) * 0.1
    a1, a2 = float(h.abs().max()) / 127.0, 2.0 / 127.0
    before = M_.int8_mlp.launches
    out = M_.int8_mlp(h, res, w1q, s1, b1, w2q, s2, b2, a1, a2, act=act)
    torch.cuda.synchronize()
    assert M_.int8_mlp.launches - before == 1
    ref = M_.int8_mlp_twin(h, res, w1q, s1, b1, w2q, s2, b2, a1, a2, act=act)
    assert _bf16_ulps(out.float().cpu(), ref.float().cpu()) <= OUT_ULPS
    assert (out != ref).float().mean().item() <= HIDDEN_FLIP_SHARE
