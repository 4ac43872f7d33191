"""int8 quantisation and kernel K5's plain twin (`uniir_tpu_torch/ops/quant.py`)
against the JAX package (`uniir_tpu/ops/quant.py`, `quant_pallas.py`) on the
same seeded inputs.  The Pallas kernel runs in interpret mode, as
tests/test_quant.py runs it.  The GPU cases hold the CUDA kernel against its
twin on a card: `python -m pytest tests/test_torch_quant.py -m gpu --noconftest`.
"""

import numpy as np
import pytest
import torch

from uniir_tpu_torch.ops import quant as Q


def _bf16_ulps(a, b) -> int:
    """Largest distance, in bf16 steps, between two arrays of bf16 values."""
    ia = torch.as_tensor(np.asarray(a, np.float32)).bfloat16().view(torch.int16).int()
    ib = torch.as_tensor(np.asarray(b, np.float32)).bfloat16().view(torch.int16).int()
    # sign-magnitude -> a monotone integer line
    ia, ib = torch.where(ia < 0, -(ia & 0x7FFF), ia), torch.where(ib < 0, -(ib & 0x7FFF), ib)
    return int((ia - ib).abs().max())


def _layer(rng, K, N, scale=0.05):
    """A quantised Dense layer in both layouts: JAX [K, N], port [N, K]."""
    from uniir_tpu.ops.quant import quantize_weight

    w = (rng.normal(size=(K, N)) * scale).astype(np.float32)
    b = rng.normal(size=(N,)).astype(np.float32)
    q, s = quantize_weight(w)
    return w, b, q, s, torch.from_numpy(q.T.copy()), torch.from_numpy(s), torch.from_numpy(b)


def test_quantize_weight_bit_equal():
    from uniir_tpu.ops.quant import quantize_weight

    rng = np.random.default_rng(0)
    w = rng.normal(size=(64, 48)).astype(np.float32)
    w[:, 5] = 0.0  # an all-zero output channel keeps scale 1
    w[3, 7] = 1e-30
    q_ref, s_ref = quantize_weight(w)
    q, s = Q.quantize_weight(torch.from_numpy(w.T.copy()))
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and q.shape == (48, 64)
    np.testing.assert_array_equal(q.numpy().T, q_ref)
    np.testing.assert_array_equal(s.numpy(), s_ref)
    assert s[5] == 1.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_activation_bit_equal(dtype):
    """All-bf16 math on both sides: values and scales agree bit for bit."""
    import jax.numpy as jnp

    from uniir_tpu.ops.quant import quantize_activation

    rng = np.random.default_rng(1)
    x = (rng.normal(size=(7, 33, 96)) * rng.uniform(0.01, 30.0, size=(7, 33, 1))).astype(np.float32)
    x[0, 0] = 0.0  # an all-zero row takes the bf16(1e-4) floor
    x[1, 2, :5] = [0.5, -0.5, 1.5, 2.5, -3.5]
    xq_ref, a_ref = quantize_activation(jnp.asarray(x, getattr(jnp, dtype)))
    xq, a = Q.quantize_activation(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert xq.dtype == torch.int8 and a.dtype == torch.bfloat16 and a.shape == (7, 33, 1)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(xq_ref))
    np.testing.assert_array_equal(a.float().numpy(), np.asarray(a_ref, np.float32))


@pytest.mark.parametrize("M,K,N", [(640, 256, 128), (300, 1280, 256)])
@pytest.mark.parametrize("with_bias", [True, False])
def test_twin_dynamic_equals_pallas_kernel_interpreted(M, K, N, with_bias):
    """K5's twin follows the Pallas kernel's epilogue order (acc * a) * w + b:
    bit-equal bf16 outputs; against the XLA formulation acc * (a * w) + b one
    bf16 step at most.  K = 1280 takes the twin through two exact pieces."""
    import jax.numpy as jnp

    from uniir_tpu.ops.quant import int8_matmul
    from uniir_tpu.ops.quant_pallas import fused_int8_matmul

    rng = np.random.default_rng(3)
    _, b, q, s, wq, ws, bias = _layer(rng, K, N)
    x = rng.normal(size=(M, K)).astype(np.float32)
    jb = jnp.asarray(b) if with_bias else None
    ref = np.asarray(fused_int8_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s), jb, interpret=True), np.float32)
    xq, a = Q.quantize_input(torch.from_numpy(x), "dynamic")
    out = Q.int8_matmul(xq, a, wq, ws, bias if with_bias else None)
    assert out.dtype == torch.bfloat16 and out.shape == (M, N)
    np.testing.assert_array_equal(out.float().numpy(), ref)
    xla = np.asarray(int8_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s), jb).astype(jnp.bfloat16), np.float32)
    assert _bf16_ulps(out.float().numpy(), xla) <= 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_linear_static_equals_jax(dtype):
    """Static mode against int8_matmul(a_static=...): the same fp32 steps."""
    import jax.numpy as jnp

    from uniir_tpu.ops.quant import int8_matmul

    rng = np.random.default_rng(4)
    _, b, q, s, wq, ws, bias = _layer(rng, 64, 40)
    x = rng.normal(size=(3, 9, 64)).astype(np.float32)
    a = np.float32(np.abs(x).max() * 0.8 / 127.0)  # some values clip, by design
    ref = int8_matmul(jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(q), jnp.asarray(s), jnp.asarray(b), a_static=a)
    out = Q.quant_linear(torch.from_numpy(x).to(getattr(torch, dtype)), wq, ws, bias, mode="static", a_static=float(a))
    assert out.shape == (3, 9, 40) and out.dtype == getattr(torch, dtype)
    ref = np.asarray(ref.astype(getattr(jnp, dtype)), np.float32)
    np.testing.assert_array_equal(out.float().numpy(), ref)
    # without a calibrated scale the static mode quantises dynamically
    dyn = Q.quant_linear(torch.from_numpy(x), wq, ws, bias, mode="static", a_static=None)
    torch.testing.assert_close(dyn, Q.quant_linear(torch.from_numpy(x), wq, ws, bias, mode="dynamic"), rtol=0, atol=0)


def test_quant_linear_dynamic_fp32_close_to_jax_xla():
    """An fp32 model keeps fp32 outputs; only the epilogue order differs
    from the XLA path: (acc * a) * w against acc * (a * w), one fp32 ulp."""
    import jax.numpy as jnp

    from uniir_tpu.ops.quant import int8_matmul

    rng = np.random.default_rng(5)
    _, b, q, s, wq, ws, bias = _layer(rng, 64, 32)
    x = rng.normal(size=(8, 64)).astype(np.float32)
    ref = np.asarray(int8_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s), jnp.asarray(b)))
    out = Q.quant_linear(torch.from_numpy(x), wq, ws, bias, mode="dynamic")
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_weight_only_matches_jax(monkeypatch):
    """`wonly`: bf16 operands, fp32 sums and epilogue on both sides; only the
    order of the fp32 sums differs."""
    import jax.numpy as jnp

    from uniir_tpu.ops.quant import int8_matmul

    monkeypatch.setenv("UNIIR_INT8_BACKEND", "wonly")
    rng = np.random.default_rng(6)
    w, b, q, s, wq, ws, bias = _layer(rng, 64, 32, scale=0.1)
    x = rng.normal(size=(3, 8, 64)).astype(np.float32)
    ref = np.asarray(int8_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s), jnp.asarray(b)))
    out = Q.quant_linear(torch.from_numpy(x), wq, ws, bias, mode="wonly").numpy()
    assert out.shape == (3, 8, 32)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    rel = np.abs(out - (x @ w + b)).max() / np.abs(x @ w + b).max()
    assert rel < 0.03, rel


@pytest.mark.parametrize("mode", Q.INT8_MODES)
def test_columns_equal_slicing_the_full_output(mode):
    """QuantLinear(columns=(lo, hi)) == the full projection sliced [lo:hi):
    the fused qkv projection's self and cross paths rely on it."""
    rng = np.random.default_rng(7)
    W = 32
    layer = Q.QuantLinear(W, 3 * W, mode=mode)
    layer.load_state_dict({
        "weight_q": torch.from_numpy(rng.integers(-127, 128, size=(3 * W, W)).astype(np.int8)),
        "scale": torch.from_numpy(rng.uniform(0.01, 0.1, size=(3 * W,)).astype(np.float32)),
        "bias": torch.from_numpy(rng.normal(size=(3 * W,)).astype(np.float32)),
    })
    x = torch.from_numpy(rng.normal(size=(4, 5, W)).astype(np.float32))
    a = 0.03 if mode == "static" else None
    full = layer(x, a_static=a)
    shared = None if mode == "wonly" else Q.quantize_input(x, mode, a)
    for lo, hi in [(0, W), (W, 2 * W), (2 * W, 3 * W), (W, 3 * W)]:
        torch.testing.assert_close(layer(x, columns=(lo, hi), a_static=a), full[..., lo:hi], rtol=0, atol=0)
        torch.testing.assert_close(layer(x, columns=(lo, hi), a_static=a, quantized=shared), full[..., lo:hi],
                                   rtol=0, atol=0)


@pytest.mark.parametrize("M", [1, 63, 65, 129])
@pytest.mark.parametrize("K,N", [(32, 8), (96, 40), (96, 264)])
def test_twin_at_tile_edges_equals_jax(M, K, N):
    """The shapes at the edges of K5's 128-row, 128 / 256-column tiles and
    its 128-byte k steps: the twin against the JAX package's int8_matmul,
    bit-equal in the static mode, one bf16 step at most in the dynamic mode
    (the Pallas epilogue order against XLA's)."""
    import jax.numpy as jnp

    from uniir_tpu.ops.quant import int8_matmul

    rng = np.random.default_rng(8)
    _, b, q, s, wq, ws, bias = _layer(rng, K, N)
    x = rng.normal(size=(M, K)).astype(np.float32)
    a = np.float32(np.abs(x).max() * 0.8 / 127.0)
    ref = int8_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s), jnp.asarray(b), a_static=a)
    out = Q.int8_matmul(*Q.quantize_input(torch.from_numpy(x), "static", float(a)), wq, ws, bias)
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref.astype(jnp.bfloat16), np.float32))
    xla = np.asarray(int8_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s), jnp.asarray(b)).astype(jnp.bfloat16),
                     np.float32)
    out = Q.int8_matmul(*Q.quantize_input(torch.from_numpy(x), "dynamic"), wq, ws, bias)
    assert out.shape == (M, N) and _bf16_ulps(out.float().numpy(), xla) <= 1


def test_exact_int_matmul_is_exact_past_fp32_range():
    """K = 4096 of +-127 overflows fp32's exact integers; the pieces do not."""
    xq = torch.full((2, 4096), 127, dtype=torch.int8)
    wq = torch.full((3, 4096), -127, dtype=torch.int8)
    wq[1, ::2] = 126
    ref = xq.to(torch.int64) @ wq.to(torch.int64).T
    assert torch.equal(Q.exact_int_matmul(xq, wq).to(torch.int64), ref)
    assert abs(int(ref[0, 0])) > 2**24


def test_quantize_state_dict_layout_and_stale_calibration():
    from uniir_tpu_torch.models.clip import CLIP_CONFIGS
    from uniir_tpu_torch.models.clip_sf import CLIPScoreFusion

    model = CLIPScoreFusion(CLIP_CONFIGS["test-tiny"])
    sd = model.state_dict()
    scales = {"visual.transformer.resblocks.0.mlp": np.array([0.1, 0.2], np.float32),
              "transformer.resblocks.1.attn": np.array([0.3, 0.4], np.float32)}
    out = Q.quantize_state_dict(model, scales)
    p = "visual.transformer.resblocks.0"
    assert out[f"{p}.attn.qkv_proj.weight_q"].shape == (96, 32) and out[f"{p}.attn.qkv_proj.weight_q"].dtype == torch.int8
    assert out[f"{p}.mlp.c_proj.scale"].shape == (32,) and out[f"{p}.attn.qkv_proj.bias"].shape == (96,)
    assert f"{p}.attn.in_proj_weight" not in out and f"{p}.mlp.c_fc.weight" not in out
    np.testing.assert_array_equal(out[f"{p}.mlp.act_scales"].numpy(), scales[f"{p}.mlp"])
    assert torch.equal(out["visual.proj"], sd["visual.proj"]) and torch.equal(out["visual.conv1.weight"], sd["visual.conv1.weight"])
    twin = CLIPScoreFusion(CLIP_CONFIGS["test-tiny"], quant=True)
    Q.load_quantized_state_dict(twin, out)
    assert set(twin.state_dict()) == set(out)
    with pytest.raises(AssertionError, match="not found"):
        Q.quantize_state_dict(model, {"nope.mlp": np.ones(2, np.float32)})


def test_modes_from_env_and_inference_only(monkeypatch):
    for value, mode in [("xla", "dynamic"), ("pallas", "dynamic"), ("wonly", "wonly"), ("static", "static")]:
        monkeypatch.setenv("UNIIR_INT8_BACKEND", value)
        assert Q.int8_mode_from_env() == mode
    monkeypatch.delenv("UNIIR_INT8_BACKEND")
    assert Q.int8_mode_from_env() == "dynamic"
    monkeypatch.setenv("UNIIR_INT8_BACKEND", "fp4")
    with pytest.raises(ValueError, match="UNIIR_INT8_BACKEND"):
        Q.int8_mode_from_env()
    monkeypatch.delenv("UNIIR_INT8_MLP", raising=False)
    assert Q.int8_mlp_route_from_env() == "fused"  # the port's default under static
    monkeypatch.setenv("UNIIR_INT8_MLP", "xla")
    assert Q.int8_mlp_route_from_env() == "xla"
    layer = Q.QuantLinear(32, 8)
    with pytest.raises(RuntimeError, match="inference only"):
        layer(torch.zeros(2, 32, requires_grad=True))
    with pytest.raises(ValueError, match="int8"):
        Q.int8_matmul(torch.zeros(2, 32), torch.ones(2), torch.zeros(8, 32, dtype=torch.int8), torch.ones(8))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", [(257 * 8, 1024, 1024), (300, 96, 40), (64, 4096, 1024), (77 * 4, 768, 3072)])
@pytest.mark.parametrize("static", [False, True])
def test_kernel_equals_twin_on_card(cuda, M, K, N, static):
    """K5 against its twin: exact integer sums and the same separately
    rounded fp32 epilogue, so bf16 outputs are bit-equal; ragged M, N and a
    half k step included."""
    g = torch.Generator(device="cuda").manual_seed(0)
    xq = torch.randint(-127, 128, (M, K), generator=g, device=cuda, dtype=torch.int8)
    wq = torch.randint(-127, 128, (N, K), generator=g, device=cuda, dtype=torch.int8)
    ws = torch.rand(N, generator=g, device=cuda) * 1e-3
    bias = torch.randn(N, generator=g, device=cuda)
    a = 0.0123 if static else torch.rand(M, generator=g, device=cuda) * 0.05
    before = Q.int8_matmul.launches
    for b, cols in [(bias, None), (None, None), (bias, (8, N - 8))]:
        out = Q.int8_matmul(xq, a, wq, ws, b, cols)
        torch.cuda.synchronize()
        assert torch.equal(out, Q.int8_matmul_twin(xq, a, wq, ws, b, cols))
    assert Q.int8_matmul.launches - before == 3


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 63, 64, 65, 129, 16448])
@pytest.mark.parametrize("N", [8, 40, 248, 256, 264, 4096])
def test_kernel_equals_twin_at_tile_edges(cuda, M, N):
    """K5 at the edges of its 128-row tiles, 128 / 256-column tiles and
    128-byte k steps (K = 32 and 96 are a ragged first step), bit-equal to
    the twin: per-row and static scales, with and without bias, the whole
    weight and a column range starting 136 rows in (a multiple of 8, not of
    128); each tile of the main loop, and the rule's choice through
    `int8_matmul`."""
    g = torch.Generator(device="cuda").manual_seed(M * 7 + N)
    lo = 136
    before = Q.int8_matmul.launches
    for K in (32, 96, 1024, 4096):
        xq = torch.randint(-127, 128, (M, K), generator=g, device=cuda, dtype=torch.int8)
        wq = torch.randint(-127, 128, (lo + N, K), generator=g, device=cuda, dtype=torch.int8)
        ws = torch.rand(lo + N, generator=g, device=cuda) * 1e-3
        bias = torch.randn(lo + N, generator=g, device=cuda)
        for a in (torch.rand(M, generator=g, device=cuda) * 0.05, 0.0123):
            for b, cols in [(bias, (lo, lo + N)), (None, (lo, lo + N)), (bias, None)]:
                ref = Q.int8_matmul_twin(xq, a, wq, ws, b, cols)
                assert torch.equal(Q.int8_matmul(xq, a, wq, ws, b, cols), ref), (K, cols)
            for tile in Q.INT8_TILES.values():
                out = Q._launch_int8_matmul(xq, a, wq, ws, bias, lo, N, tile)
                assert torch.equal(out, Q.int8_matmul_twin(xq, a, wq, ws, bias, (lo, lo + N))), (K, tile)
    torch.cuda.synchronize()
    assert Q.int8_matmul.launches - before == 4 * 2 * 3  # the launches of a named tile are not counted


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take(cuda):
    xq = torch.zeros((4, 48), dtype=torch.int8, device=cuda)
    wq = torch.zeros((8, 48), dtype=torch.int8, device=cuda)
    ws = torch.ones(8, device=cuda)
    with pytest.raises(ValueError, match="K % 32"):
        Q.int8_matmul(xq, 0.1, wq, ws)
    with pytest.raises(ValueError, match="bf16"):
        Q.int8_matmul(xq[:, :32].contiguous(), 0.1, wq[:, :32].contiguous(), ws, out_dtype=torch.float32)
