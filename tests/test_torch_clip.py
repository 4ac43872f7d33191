"""CLIP-SF in the port against the JAX package at `test-tiny`, on the same
seeded inputs and weights (moved over with `state_dict_from_jax`).

In bf16 the JAX towers reach `paired_attention` (Pallas, interpret mode on
the CPU) and the port's reach the twin of kernel K1.  JAX is imported inside
the parity tests only, so the GPU case also runs on a host without it:
`python -m pytest tests/test_torch_clip.py -m gpu --noconftest`.
"""

import numpy as np
import pytest
import torch

from uniir_tpu_torch.models.clip import CLIP_CONFIGS, CLIPTextTower, CLIPVisionTower
from uniir_tpu_torch.models.clip_sf import CLIPScoreFusion
from uniir_tpu_torch.models.convert import state_dict_from_jax
from uniir_tpu_torch.models.layers import LN_EPS, MultiHeadAttention, Transformer
from uniir_tpu_torch.models.registry import seeded_clip_sf

CFG = CLIP_CONFIGS["test-tiny"]
# fp32 on both sides: only summation order and LayerNorm's variance formula
# differ (flax uses E[x^2] - E[x]^2).
FP32_ATOL = 1e-4
# bf16: roundings at different points in the two frameworks; the embedding
# direction must survive.
BF16_MIN_COSINE = 0.999


def _inputs(n=4, seed=0):
    rng = np.random.default_rng(seed)
    txt = np.zeros((n, CFG.context_length), np.int32)
    for i in range(n):
        length = 3 + i % (CFG.context_length - 4)
        txt[i, :length] = rng.integers(1, CFG.vocab_size - 1, length)
        txt[i, length] = CFG.vocab_size - 1  # EOT: the highest id
    img = rng.random((n, CFG.image_size, CFG.image_size, 3)).astype(np.float32)
    txt_mask = np.array([1, 1, 0, 1][:n], np.int32)
    img_mask = np.array([1, 0, 1, 1][:n], np.int32)
    return txt, img, txt_mask, img_mask


@pytest.fixture(scope="module")
def jax_params():
    import jax

    from uniir_tpu.models.clip_sf import CLIPScoreFusion as JaxCLIPSF

    txt, img, tm, im = _inputs()
    return jax.tree_util.tree_map(np.asarray, JaxCLIPSF(_jax_cfg()).init(jax.random.PRNGKey(0), txt, img, tm, im)["params"])


def _jax_cfg():
    from uniir_tpu.models.clip import CLIP_CONFIGS as JAX_CONFIGS

    return JAX_CONFIGS["test-tiny"]


def _port_model(params, dtype=torch.float32):
    model = CLIPScoreFusion(CFG)
    model.load_state_dict(state_dict_from_jax(params))
    return model.to_compute_dtype(dtype).eval()


def _cosine(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def test_state_dict_from_jax_inverts_convert_clip_sf_params():
    from tests.test_convert import fake_clip_sd
    from uniir_tpu.models import convert as jax_convert

    sd = jax_convert.to_numpy_state_dict(fake_clip_sd(_jax_cfg()))
    params = jax_convert.convert_clip_sf_params(sd, CFG.vision_layers, CFG.text_layers)
    back = state_dict_from_jax(params)
    assert set(back) == set(sd)
    for key, value in sd.items():
        np.testing.assert_array_equal(back[key].numpy(), value, err_msg=key)


def test_port_modules_take_openai_clip_names():
    from tests.test_convert import fake_clip_sd

    sd = fake_clip_sd(_jax_cfg())
    model = CLIPScoreFusion(CFG)
    assert set(model.state_dict()) == set(sd)
    model.load_state_dict(sd)  # strict


def test_layernorm_epsilon_is_flax_default():
    assert LN_EPS == 1e-6
    assert all(m.eps == 1e-6 for m in CLIPScoreFusion(CFG).modules() if isinstance(m, torch.nn.LayerNorm))


def test_clip_sf_fp32_matches_jax(jax_params):
    from uniir_tpu.models.clip_sf import CLIPScoreFusion as JaxCLIPSF

    txt, img, tm, im = _inputs()
    ref = JaxCLIPSF(_jax_cfg()).apply({"params": jax_params}, txt, img, tm, im)
    model = _port_model(jax_params)
    with torch.inference_mode():
        out = model(*(torch.from_numpy(a) for a in (txt, img, tm, im)))
    assert out.dtype == torch.float32 and out.shape == (4, CFG.embed_dim)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FP32_ATOL)


@pytest.mark.parametrize("tower", ["vision", "text"])
def test_towers_fp32_match_jax(jax_params, tower):
    from uniir_tpu.models.clip import CLIPTextTower as JaxText
    from uniir_tpu.models.clip import CLIPVisionTower as JaxVision

    txt, img, _, _ = _inputs()
    model = _port_model(jax_params)
    with torch.inference_mode():
        if tower == "vision":
            ref = JaxVision(_jax_cfg()).apply({"params": jax_params["visual"]}, img)
            out = model.encode_image(torch.from_numpy(img))
        else:
            ref = JaxText(_jax_cfg()).apply({"params": jax_params["text"]}, txt)
            out = model.encode_text(torch.from_numpy(txt))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FP32_ATOL)


def test_clip_sf_bf16_matches_jax(jax_params):
    import jax.numpy as jnp

    from uniir_tpu.models.clip_sf import CLIPScoreFusion as JaxCLIPSF

    txt, img, tm, im = _inputs()
    ref = JaxCLIPSF(_jax_cfg(), dtype=jnp.bfloat16).apply({"params": jax_params}, txt, img, tm, im)
    model = _port_model(jax_params, torch.bfloat16)
    assert model.visual.proj.dtype == torch.bfloat16
    assert model.visual.ln_pre.weight.dtype == torch.float32 and model.logit_scale.dtype == torch.float32
    with torch.inference_mode():
        out = model(*(torch.from_numpy(a) for a in (txt, img, tm, im)))
    assert out.dtype == torch.float32
    assert _cosine(out.numpy(), np.asarray(ref)).min() >= BF16_MIN_COSINE


@pytest.mark.parametrize("causal", [False, True])
def test_pooled_last_block_is_exact(causal):
    """The trimmed last block returns exactly the pooled row of the full stack."""
    torch.manual_seed(0)
    stack = Transformer(32, 2, 2, causal=causal).eval()
    x = torch.randn(3, 11, 32)
    pool_idx = torch.tensor([0, 7, 10]) if causal else torch.zeros(3, dtype=torch.long)
    with torch.inference_mode():
        full = stack(x)[torch.arange(3), pool_idx]
        trimmed = stack(x, pool_idx=pool_idx)
    assert trimmed.shape == (3, 1, 32)
    torch.testing.assert_close(trimmed[:, 0], full, rtol=1e-5, atol=1e-5)


def test_seeded_model_is_deterministic_and_cast():
    a = seeded_clip_sf(CFG, "cpu", seed=3)
    b = seeded_clip_sf(CFG, "cpu", seed=3)
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
        if name.endswith(("ln_1.weight", "ln_pre.bias", "ln_final.weight")) or name == "logit_scale":
            assert p.dtype == torch.float32, name
        elif "ln_" not in name:
            assert p.dtype == torch.bfloat16, name
    assert abs(a.logit_scale.item() - np.log(1 / 0.07)) < 1e-6
    txt, img, tm, im = _inputs()
    with torch.inference_mode():
        out = a(*(torch.from_numpy(x) for x in (txt, img, tm, im)))
    assert torch.isfinite(out).all()


def test_torch_checkpoint_loads_with_ddp_and_uniir_prefixes(tmp_path):
    from tests.test_convert import fake_clip_sd
    from uniir_tpu_torch.models.registry import load_torch_checkpoint

    sd = fake_clip_sd(_jax_cfg())
    path = tmp_path / "clip_sf.pth"
    torch.save({"model": {f"module.clip_model.{k}": v for k, v in sd.items()}}, path)
    model = CLIPScoreFusion(CFG).to_compute_dtype(torch.bfloat16)
    load_torch_checkpoint(model, str(path))
    assert torch.equal(model.visual.proj, sd["visual.proj"].bfloat16())
    assert torch.equal(model.ln_final.weight, sd["ln_final.weight"])  # LayerNorms stay fp32


def test_unported_options_raise():
    from uniir_tpu_torch.core.config import Config
    from uniir_tpu_torch.models.registry import build_model_from_config
    from uniir_tpu_torch.train.steps import make_clip_train_step

    with pytest.raises(NotImplementedError, match="ROADMAP"):  # int8 of the feature-fusion models
        build_model_from_config(Config.from_dict(
            {"model": {"name": "CLIPFeatureFusion", "clip_vision_model_name": "test-tiny-ff", "int8": True}}))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model_from_config(Config.from_dict({"model": {"name": "BLIPFeatureFusion", "int8": True}}))
    assert MultiHeadAttention(32, 2, quant=True).qkv_proj.weight_q.dtype == torch.int8  # int8 is ported
    with pytest.raises(ValueError, match="inference only"):
        Transformer(32, 2, 2, quant=True, remat=True)
    with pytest.raises(ValueError, match="no stochastic layer"):
        make_clip_train_step(CLIPScoreFusion(CFG), with_dropout=True)  # only CLIP-FF's T5 stack has dropout
    # the token-output towers are ported
    assert CLIPVisionTower(CFG, pool="none").pool == "none" and CLIPTextTower(CFG, pool="none").pool == "none"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.gpu
def test_vit_l14_bf16_on_card_runs_the_kernel(cuda):
    """Seeded ViT-L/14 at full width (batch 2): finite embeddings through K1."""
    from uniir_tpu_torch.ops.attention import attention

    cfg = CLIP_CONFIGS["ViT-L/14"]
    model = seeded_clip_sf(cfg, cuda, seed=0)
    rng = np.random.default_rng(0)
    txt = torch.from_numpy(rng.integers(1, cfg.vocab_size - 1, (2, cfg.context_length))).to(cuda)
    txt[:, 20] = cfg.vocab_size - 1
    img = torch.rand(2, cfg.image_size, cfg.image_size, 3, device=cuda)
    ones = torch.ones(2, dtype=torch.int32, device=cuda)
    before = attention.launches
    with torch.inference_mode():
        out = model(txt, img, ones, ones)
    assert out.shape == (2, cfg.embed_dim) and torch.isfinite(out).all()
    assert attention.launches - before == (cfg.vision_layers - 1) + (cfg.text_layers - 1)
