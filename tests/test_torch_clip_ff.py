"""CLIP-FF in the port against the JAX package at `test-tiny-ff`: the T5
bucket table, the fusion stack, the token-output towers and the whole
retriever, on the same seeded inputs and weights (moved over with
`state_dict_from_jax`), then the registry and the fusion dropout.

In bf16 the JAX towers reach `paired_attention` (Pallas, interpret mode on
the CPU) and the port's reach the twin of kernel K1; the fusion stack's
attention is a plain einsum on both sides.  JAX is imported inside the
parity tests only, so the GPU case also runs on a host without it:
`python -m pytest tests/test_torch_clip_ff.py -m gpu --noconftest`.
"""

import numpy as np
import pytest
import torch

from uniir_tpu_torch.core.config import Config
from uniir_tpu_torch.models.clip import CLIP_CONFIGS, CLIPTextTower, CLIPVisionTower
from uniir_tpu_torch.models.clip_ff import CLIPFeatureFusion, t5_config_for_clip
from uniir_tpu_torch.models.convert import state_dict_from_jax
from uniir_tpu_torch.models.registry import (
    build_model_from_config,
    load_clip_ff_checkpoint,
    seeded_clip_ff,
    seeded_clip_ff_train,
)
from uniir_tpu_torch.models.t5_fusion import T5Dropout, T5FusionConfig, T5FusionStack, relative_position_bucket

CFG = CLIP_CONFIGS["test-tiny-ff"]
T5_TINY = T5FusionConfig(d_model=32, d_kv=8, num_heads=4, d_ff=64, num_layers=2, dropout_rate=0.0)
# fp32 fusion stack on both sides: only the order of the sums differs.
T5_ATOL = 1e-5
# fp32 towers and retriever: summation order and flax's E[x^2] - E[x]^2
# LayerNorm variance.
FP32_ATOL = 1e-4
# bf16: roundings at different points in the two frameworks; the embedding
# direction must survive.
BF16_MIN_COSINE = 0.999


def _jax_cfg():
    from uniir_tpu.models.clip import CLIP_CONFIGS as JAX_CONFIGS

    return JAX_CONFIGS["test-tiny-ff"]


def _inputs(n=4, seed=0):
    rng = np.random.default_rng(seed)
    txt = np.zeros((n, CFG.context_length), np.int32)
    for i in range(n):
        length = 3 + i % (CFG.context_length - 4)
        txt[i, :length] = rng.integers(1, CFG.vocab_size - 1, length)
        txt[i, length] = CFG.vocab_size - 1
    img = rng.random((n, CFG.image_size, CFG.image_size, 3)).astype(np.float32)
    return txt, img, np.array([1, 1, 0, 1][:n], np.int32), np.array([1, 0, 1, 1][:n], np.int32)


def _cosine(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


@pytest.fixture(scope="module")
def jax_params():
    import jax

    from uniir_tpu.models.clip_ff import CLIPFeatureFusion as JaxCLIPFF

    init = jax.jit(JaxCLIPFF(_jax_cfg()).init)(jax.random.PRNGKey(0), *_inputs())
    return jax.tree_util.tree_map(np.asarray, init["params"])


def _port_model(params, dtype=torch.float32):
    model = CLIPFeatureFusion(CFG)
    model.load_state_dict(state_dict_from_jax(params))
    return model.to_compute_dtype(dtype).eval()


# ------------------------------------------------------------ fusion stack


@pytest.mark.parametrize("num_buckets,max_distance", [(32, 128), (16, 64)])
def test_bucket_table_equals_jax_for_every_distance(num_buckets, max_distance):
    """The host table against the JAX function (an fp32 logarithm truncated
    to an int) for every distance of L = 77 + 257 and beyond."""
    import jax.numpy as jnp

    from uniir_tpu.models.t5_fusion import relative_position_bucket as jax_bucket

    rel = np.arange(-400, 401, dtype=np.int32)
    want = np.asarray(jax_bucket(jnp.asarray(rel), num_buckets, max_distance))
    np.testing.assert_array_equal(relative_position_bucket(rel, num_buckets, max_distance), want)


def test_position_bias_is_a_buffer_rebuilt_per_length():
    stack = T5FusionStack(T5_TINY)
    attn = stack.block[0].layer[0].SelfAttention
    assert "buckets" not in stack.state_dict() and not any("buckets" in n for n, _ in stack.named_parameters())
    bias = attn.position_bias(9)
    assert bias.shape == (1, 4, 9, 9) and bias.dtype == torch.float32
    assert attn.buckets.shape == (9, 9) and attn.position_bias(5).shape == (1, 4, 5, 5)
    assert not hasattr(stack.block[1].layer[0].SelfAttention, "relative_attention_bias")


def _t5_input(seed=0):
    return (np.random.default_rng(seed).standard_normal((2, 9, 32)) * 0.5).astype(np.float32)


def test_t5_stack_fp32_matches_jax():
    import jax

    from uniir_tpu.models.t5_fusion import T5FusionConfig as JaxT5Config
    from uniir_tpu.models.t5_fusion import T5FusionStack as JaxT5Stack

    x = _t5_input()
    jax_stack = JaxT5Stack(JaxT5Config(**{f.name: getattr(T5_TINY, f.name) for f in T5_TINY.__dataclass_fields__.values()}))
    params = jax.tree_util.tree_map(np.asarray, jax_stack.init(jax.random.PRNGKey(1), x)["params"])
    ref = jax_stack.apply({"params": params}, x)
    stack = T5FusionStack(T5_TINY).eval()
    stack.load_state_dict(state_dict_from_jax(params))
    with torch.inference_mode():
        out = stack(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=T5_ATOL)


def test_t5_stack_fp32_matches_transformers_t5stack():
    """HF's T5Stack built from a config only: its state dict loads into the
    port's stack as it is, and the outputs agree."""
    from transformers.models.t5 import T5Config
    from transformers.models.t5.modeling_t5 import T5Stack

    conf = T5Config()
    conf.num_layers = conf.num_decoder_layers = 2
    conf.num_heads, conf.d_model, conf.d_kv, conf.d_ff = 4, 32, 8, 64
    conf.dropout_rate = 0.0
    conf.is_decoder = conf.use_cache = False
    torch.manual_seed(0)
    hf = T5Stack(conf).eval()
    x = torch.from_numpy(_t5_input(1))
    with torch.no_grad():
        ref = hf(inputs_embeds=x, use_cache=False, return_dict=True).last_hidden_state
    stack = T5FusionStack(T5_TINY).eval()
    stack.load_state_dict(hf.state_dict())  # strict: HF's names are the port's
    with torch.inference_mode():
        out = stack(x)
    torch.testing.assert_close(out, ref, rtol=0, atol=T5_ATOL)


def test_t5_quant_raises_with_roadmap_pointer():
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        T5FusionStack(T5_TINY, quant=True)
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        CLIPFeatureFusion(CFG, quant=True)


# ----------------------------------------------------------------- dropout


def test_dropout_is_seeded_identity_in_eval_and_keeps_its_rate():
    drop = T5Dropout(0.1)
    x = torch.ones(200, 500)
    drop.eval()
    assert drop(x) is x
    drop.train()
    drop.generator = torch.Generator().manual_seed(7)
    a = drop(x)
    drop.generator = torch.Generator().manual_seed(7)
    b = drop(x)
    assert torch.equal(a, b)
    kept = (a != 0).float().mean().item()
    # 1e5 draws at keep 0.9: the standard error is 0.001, the band 5 of them
    assert abs(kept - 0.9) < 0.005
    torch.testing.assert_close(a[a != 0], torch.full_like(a[a != 0], 1 / 0.9))


def test_stack_dropout_draws_from_the_given_generator():
    cfg = T5FusionConfig(d_model=32, d_kv=8, num_heads=4, d_ff=64, num_layers=2)
    stack = T5FusionStack(cfg).train()
    x = torch.from_numpy(_t5_input())
    outs = []
    for seed in (3, 3, 4):
        stack.set_dropout_generator(torch.Generator().manual_seed(seed))
        outs.append(stack(x))
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    stack.eval()
    assert torch.equal(stack(x), stack(x))


# ------------------------------------------------------------------ towers


@pytest.mark.parametrize("tower", ["vision", "text"])
def test_token_output_towers_fp32_match_jax(jax_params, tower):
    from uniir_tpu.models.clip import CLIPTextTower as JaxText
    from uniir_tpu.models.clip import CLIPVisionTower as JaxVision

    txt, img, _, _ = _inputs()
    model = _port_model(jax_params)
    with torch.inference_mode():
        if tower == "vision":
            ref = JaxVision(_jax_cfg(), pool="none").apply({"params": jax_params["visual"]}, img)
            out = model.clip_model.visual(torch.from_numpy(img))
            assert out.shape == (4, (CFG.image_size // CFG.patch_size) ** 2 + 1, CFG.embed_dim)
        else:
            ref = JaxText(_jax_cfg(), pool="none").apply({"params": jax_params["text"]}, txt)
            out = model.clip_model(torch.from_numpy(txt))
            assert out.shape == (4, CFG.context_length, CFG.text_width)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FP32_ATOL)


def test_token_output_text_tower_owns_no_projection():
    assert not hasattr(CLIPTextTower(CFG, pool="none"), "text_projection")
    assert hasattr(CLIPTextTower(CFG, pool="eot"), "text_projection")
    assert CLIPVisionTower(CFG, pool="none").proj.shape == (CFG.vision_width, CFG.embed_dim)
    assert not any("text_projection" in k for k in CLIPFeatureFusion(CFG).state_dict())


# --------------------------------------------------------------- retriever


def test_state_dict_from_jax_inverts_convert_clip_ff_params(jax_params):
    from uniir_tpu.models import convert as jax_convert

    sd = state_dict_from_jax(jax_params)
    assert set(sd) == set(CLIPFeatureFusion(CFG).state_dict())
    back = jax_convert.convert_clip_ff_params({k: v.numpy() for k, v in sd.items()}, CFG.vision_layers, CFG.text_layers)
    import jax

    flat_want = jax.tree_util.tree_leaves_with_path(jax_params)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_want) == len(flat_back)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(np.asarray(flat_back[path]), leaf, err_msg=str(path))


def test_clip_ff_fp32_matches_jax(jax_params):
    from uniir_tpu.models.clip_ff import CLIPFeatureFusion as JaxCLIPFF

    txt, img, tm, im = _inputs()
    ref = JaxCLIPFF(_jax_cfg()).apply({"params": jax_params}, txt, img, tm, im)
    model = _port_model(jax_params)
    with torch.inference_mode():
        out = model(*(torch.from_numpy(a) for a in (txt, img, tm, im)))
    assert out.dtype == torch.float32 and out.shape == (4, CFG.embed_dim)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FP32_ATOL)
    np.testing.assert_allclose(model.get_logit_scale().item(), 1 / 0.07, rtol=1e-6)


def test_clip_ff_bf16_matches_jax(jax_params):
    import jax.numpy as jnp

    from uniir_tpu.models.clip_ff import CLIPFeatureFusion as JaxCLIPFF

    txt, img, tm, im = _inputs()
    ref = JaxCLIPFF(_jax_cfg(), dtype=jnp.bfloat16).apply({"params": jax_params}, txt, img, tm, im)
    model = _port_model(jax_params, torch.bfloat16)
    sd = model.state_dict()
    assert sd["clip_model.visual.proj"].dtype == torch.bfloat16
    assert sd["t5_layers.block.0.layer.0.SelfAttention.q.weight"].dtype == torch.bfloat16
    for key in ("clip_model.ln_final.weight", "clip_model.logit_scale", "t5_layers.final_layer_norm.weight",
                "t5_layers.block.0.layer.0.SelfAttention.relative_attention_bias.weight"):
        assert sd[key].dtype == torch.float32, key
    with torch.inference_mode():
        out = model(*(torch.from_numpy(a) for a in (txt, img, tm, im)))
    assert out.dtype == torch.float32
    assert _cosine(out.numpy(), np.asarray(ref)).min() >= BF16_MIN_COSINE


def test_mean_pool_runs_in_the_compute_dtype(jax_params):
    """One bf16 rounding of the token mean, then fp32: every output value is
    a bf16 value, as `jnp.mean(fused, axis=1).astype(float32)` gives."""
    model = _port_model(jax_params, torch.bfloat16)
    with torch.inference_mode():
        out = model(*(torch.from_numpy(a) for a in _inputs()))
    assert torch.equal(out, out.bfloat16().float())


def test_masks_are_accepted_and_unused(jax_params):
    txt, img, tm, im = (torch.from_numpy(a) for a in _inputs())
    model = _port_model(jax_params)
    with torch.inference_mode():
        assert torch.equal(model(txt, img, tm, im), model(txt, img))
        assert not torch.equal(model(txt, img), model(txt, img + 0.5))  # the image reaches the fusion


def test_text_width_must_equal_embed_dim():
    with pytest.raises(ValueError, match="text_width == embed_dim"):
        CLIPFeatureFusion(CLIP_CONFIGS["test-tiny"])
    assert t5_config_for_clip(CLIP_CONFIGS["ViT-L/14"]) == T5FusionConfig(d_model=768, num_heads=12, d_kv=64, num_layers=2)


# ---------------------------------------------------------------- registry


@pytest.fixture(scope="module")
def merges_path(tmp_path_factory):
    from tests.helpers import tiny_clip_merges

    path = tmp_path_factory.mktemp("bpe") / "merges.txt"
    path.write_text("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in tiny_clip_merges()))
    return str(path)


@pytest.fixture
def make_config(merges_path):
    def make(**model):
        return Config.from_dict({"seed": 5, "model": {"name": "CLIPFeatureFusion", "clip_vision_model_name": "test-tiny-ff",
                                                     "clip_bpe_path": merges_path, **model}})

    return make


def test_registry_builds_clip_ff_on_the_cpu_when_asked(make_config):
    bundle = build_model_from_config(make_config(), device="cpu")
    assert bundle.name == "CLIPFeatureFusion" and isinstance(bundle.model, CLIPFeatureFusion)
    assert bundle.embed_dim == CFG.embed_dim and bundle.image_size == (CFG.image_size,) * 2
    assert not bundle.model.training and bundle.model.dtype == torch.bfloat16
    same = seeded_clip_ff(CFG, "cpu", seed=5)
    for (name, p), q in zip(bundle.model.named_parameters(), same.parameters()):
        assert torch.equal(p, q), name
    with torch.inference_mode():
        out = bundle.model(*(torch.from_numpy(a) for a in _inputs()))
    assert out.shape == (4, CFG.embed_dim) and torch.isfinite(out).all()


def test_registry_raises_without_a_card_unless_cpu_is_named(make_config):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="cpu"):
        build_model_from_config(make_config())


def test_registry_train_build_keeps_fp32_masters_and_remat(make_config):
    bundle = build_model_from_config(make_config(remat=True), device="cpu", train=True)
    model = bundle.model
    assert model.training and model.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert model.clip_model.transformer.remat and model.clip_model.visual.transformer.remat
    same = seeded_clip_ff_train(CFG, "cpu", seed=5, remat=True)
    assert all(torch.equal(p, q) for p, q in zip(model.parameters(), same.parameters()))


def test_registry_int8_raises_with_roadmap_pointer(make_config):
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        build_model_from_config(make_config(int8=True), device="cpu")


@pytest.mark.parametrize("flag,want", [("1", True), ("0", False), (None, False)])
def test_attn_splitk_is_read_once_where_the_model_is_built(monkeypatch, make_config, flag, want):
    if flag is None:
        monkeypatch.delenv("UNIIR_ATTN_SPLITK", raising=False)
    else:
        monkeypatch.setenv("UNIIR_ATTN_SPLITK", flag)
    model = build_model_from_config(make_config(), device="cpu").model
    monkeypatch.setenv("UNIIR_ATTN_SPLITK", "0" if want else "1")  # a later change is not seen
    vision = [m.attn_splitk for m in model.clip_model.visual.transformer.modules() if hasattr(m, "attn_splitk")]
    text = [m.attn_splitk for m in model.clip_model.transformer.modules() if hasattr(m, "attn_splitk")]
    assert vision and all(v == want for v in vision) and text and not any(text)


def test_attn_splitk_rejects_other_values(monkeypatch, make_config):
    monkeypatch.setenv("UNIIR_ATTN_SPLITK", "yes")
    with pytest.raises(ValueError, match="UNIIR_ATTN_SPLITK"):
        build_model_from_config(make_config(), device="cpu")


@pytest.mark.parametrize("layout", ["uniir_clip_ff", "openai_clip"])
def test_checkpoint_loads_and_drops_text_projection(tmp_path, make_config, layout):
    from tests.test_convert import fake_clip_sd

    clip_sd = fake_clip_sd(_jax_cfg())  # has a text_projection, which CLIP-FF must drop
    donor = seeded_clip_ff(CFG, "cpu", seed=9, dtype=torch.float32)
    if layout == "uniir_clip_ff":
        sd = {f"module.clip_model.{k}": v for k, v in clip_sd.items()}
        sd.update({f"module.t5_layers.{k}": v for k, v in donor.t5_layers.state_dict().items()})
    else:
        sd = dict(clip_sd)
    path = tmp_path / "ckpt.pth"
    torch.save({"model": sd}, path)
    model = seeded_clip_ff(CFG, "cpu", seed=1, dtype=torch.float32)
    before = {k: v.clone() for k, v in model.t5_layers.state_dict().items()}
    load_clip_ff_checkpoint(model, str(path))
    assert torch.equal(model.clip_model.visual.proj, clip_sd["visual.proj"])
    assert torch.equal(model.clip_model.ln_final.weight, clip_sd["ln_final.weight"])
    want_t5 = donor.t5_layers.state_dict() if layout == "uniir_clip_ff" else before
    for key, value in model.t5_layers.state_dict().items():
        assert torch.equal(value, want_t5[key]), key
    # through the registry, by the config's pretrained_torch_ckpt
    served = build_model_from_config(make_config(pretrained_torch_ckpt=str(path), bf16=False), device="cpu").model
    assert torch.equal(served.clip_model.visual.proj, clip_sd["visual.proj"])


def test_checkpoint_missing_a_parameter_is_an_error(tmp_path):
    sd = {f"clip_model.{k}": v for k, v in seeded_clip_ff(CFG, "cpu", dtype=torch.float32).clip_model.state_dict().items()}
    path = tmp_path / "towers_only.pth"
    torch.save(sd, path)  # the CLIP-FF layout without its t5_layers
    with pytest.raises(RuntimeError, match="t5_layers"):
        load_clip_ff_checkpoint(seeded_clip_ff(CFG, "cpu", dtype=torch.float32), str(path))


# --------------------------------------------------------------------- GPU


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("splitk", [False, True])
def test_vit_l14_clip_ff_on_card_runs_the_kernels(cuda, splitk):
    """Seeded CLIP-FF at ViT-L/14's full width (batch 2): finite embeddings,
    24 + 12 attention launches, the vision tower's through K10 with split-K."""
    from uniir_tpu_torch.ops.attention import attention, attention_splitk

    cfg = CLIP_CONFIGS["ViT-L/14"]
    model = seeded_clip_ff(cfg, cuda, seed=0, attn_splitk=splitk)
    rng = np.random.default_rng(0)
    txt = torch.from_numpy(rng.integers(1, cfg.vocab_size - 1, (2, cfg.context_length))).to(cuda)
    img = torch.rand(2, cfg.image_size, cfg.image_size, 3, device=cuda)
    before = (attention.launches, attention_splitk.launches)
    with torch.inference_mode():
        out = model(txt, img)
    torch.cuda.synchronize()
    assert out.shape == (2, cfg.embed_dim) and torch.isfinite(out).all()
    k1, k10 = attention.launches - before[0], attention_splitk.launches - before[1]
    assert (k1, k10) == ((cfg.text_layers, cfg.vision_layers) if splitk else (cfg.vision_layers + cfg.text_layers, 0))
