"""BLIP-SF in the port against the JAX package at `test-tiny`, on the same
seeded inputs and weights (moved over with `state_dict_from_jax`): the ViT,
MED in both modes, the position-embedding resize, the whole model, and a
fake BLIP `.pth` through both registries.

JAX is imported inside the parity tests only, so the GPU case also runs on
a host without it:
`python -m pytest tests/test_torch_blip.py -m gpu --noconftest`.
"""

import os

import numpy as np
import pytest
import torch

from uniir_tpu_torch.core.config import Config, load_config
from uniir_tpu_torch.models.blip_sf import BLIPScoreFusion
from uniir_tpu_torch.models.blip_vit import BLIP_VIT_CONFIGS, BLIPVisionTransformer
from uniir_tpu_torch.models.convert import state_dict_from_jax
from uniir_tpu_torch.models.layers import DropPath, interpolate_pos_embed
from uniir_tpu_torch.models.med import MED_CONFIGS, MedBertModel
from uniir_tpu_torch.models.registry import build_model_from_config, load_blip_checkpoint, seeded_blip_sf

VIT, MED = BLIP_VIT_CONFIGS["test-tiny"], MED_CONFIGS["test-tiny"]
EMBED_DIM = 16
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# fp32 on both sides: only summation order, the erf / tanh implementations
# and LayerNorm's variance formula differ (flax uses E[x^2] - E[x]^2).
FP32_ATOL = 1e-4
# bf16: roundings at different points in the two frameworks (flax's erf GELU
# rounds every step to bf16, PyTorch's rounds once); the direction survives.
BF16_MIN_COSINE = 0.999
# interpolate_pos_embed against jax.image.resize: the same fp32 weights,
# summed in another order.  Measured 2.2e-6 on values up to 3.5.
POS_EMBED_ATOL = 1e-5


def _cosine(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def _inputs(n=4, seq=12, seed=0):
    """Mixed-modality batch: token ids with padding masks of mixed lengths."""
    rng = np.random.default_rng(seed)
    ids = np.zeros((n, seq), np.int32)
    mask = np.zeros((n, seq), np.int32)
    for i in range(n):
        length = 3 + (2 * i) % (seq - 3)
        ids[i, :length] = rng.integers(4, MED.vocab_size, length)
        mask[i, :length] = 1
    img = rng.standard_normal((n, VIT.image_size, VIT.image_size, 3)).astype(np.float32)
    txt_mask = np.array([1, 1, 0, 1][:n], np.int32)
    img_mask = np.array([1, 0, 1, 1][:n], np.int32)
    return {"input_ids": ids, "attention_mask": mask}, img, txt_mask, img_mask


def _randomise(tree, seed=1):
    """Replace zero-initialised leaves (cls_token, pos_embed, biases) by noise
    so that every parameter takes part in the comparison."""
    import jax

    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) if np.any(np.asarray(x)) else (0.02 * rng.standard_normal(np.shape(x))).astype(np.float32),
        tree,
    )


@pytest.fixture(scope="module")
def jax_sf_params():
    import jax

    from uniir_tpu.models.blip_sf import BLIPScoreFusion as JaxBLIPSF

    model = JaxBLIPSF(vit_cfg=_jax_vit(), med_cfg=_jax_med(), embed_dim=EMBED_DIM)
    return _randomise(model.init(jax.random.PRNGKey(0), *_inputs())["params"])


def _jax_vit():
    from uniir_tpu.models.blip_vit import BLIP_VIT_CONFIGS as J

    return J["test-tiny"]


def _jax_med():
    from uniir_tpu.models.med import MED_CONFIGS as J

    return J["test-tiny"]


def _torch_txt(txt):
    return {k: torch.from_numpy(v) for k, v in txt.items()}


def _port_sf(params, dtype=torch.float32):
    model = BLIPScoreFusion(VIT, MED, EMBED_DIM)
    model.load_state_dict(state_dict_from_jax(params))
    return model.to_compute_dtype(dtype).eval()


# ------------------------------------------------------------ weights across


def _fake_sd(with_pooler=False):
    from tests.test_convert import fake_blip_sd

    return fake_blip_sd(_jax_vit(), _jax_med(), with_pooler=with_pooler)


def test_state_dict_from_jax_inverts_convert_blip_sf_params():
    from uniir_tpu.models import convert as jax_convert

    sd = jax_convert.to_numpy_state_dict(_fake_sd())
    params = jax_convert.convert_blip_sf_params(sd, VIT.layers, MED.num_hidden_layers)
    back = state_dict_from_jax(params)
    kept = {k: v for k, v in sd.items() if "crossattention" not in k}  # the JAX converter drops them for SF
    assert set(back) == set(kept)
    for key, value in kept.items():
        np.testing.assert_array_equal(back[key].numpy(), value, err_msg=key)
    assert back["temp"].dim() == 0


def test_port_modules_take_blip_names():
    sd = {k: v for k, v in _fake_sd().items() if "crossattention" not in k}
    model = BLIPScoreFusion(VIT, MED, EMBED_DIM)
    assert set(model.state_dict()) == set(sd)
    model.load_state_dict(sd)  # strict
    # the text encoder of score fusion has no cross-attention modules
    assert not any("crossattention" in name for name, _ in model.named_modules())


@pytest.mark.parametrize("with_pooler", [False, True])
def test_bare_med_tree_with_cross_attention_converts(with_pooler):
    from uniir_tpu.models import convert as jax_convert

    sd = jax_convert.to_numpy_state_dict(_fake_sd(with_pooler=True))
    tree = jax_convert.convert_med_bert(sd, "text_encoder", MED.num_hidden_layers, with_pooler=with_pooler)
    back = state_dict_from_jax(tree)
    model = MedBertModel(MED, add_pooling_layer=with_pooler)
    assert set(back) == set(model.state_dict())
    for key, value in back.items():
        np.testing.assert_array_equal(value.numpy(), sd[f"text_encoder.{key}"], err_msg=key)


def test_bare_vit_tree_converts():
    from uniir_tpu.models import convert as jax_convert

    sd = jax_convert.to_numpy_state_dict(_fake_sd())
    back = state_dict_from_jax(jax_convert.convert_blip_vit(sd, "visual_encoder", VIT.layers))
    assert set(back) == set(BLIPVisionTransformer(VIT).state_dict())
    for key, value in back.items():
        np.testing.assert_array_equal(value.numpy(), sd[f"visual_encoder.{key}"], err_msg=key)


# ------------------------------------------------------------------- the ViT


@pytest.mark.parametrize("pool_cls", [False, True])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_blip_vit_matches_jax(jax_sf_params, pool_cls, dtype):
    import jax.numpy as jnp

    from uniir_tpu.models.blip_vit import BLIPVisionTransformer as JaxViT

    _, img, _, _ = _inputs()
    params = jax_sf_params["visual_encoder"]
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    ref = np.asarray(JaxViT(_jax_vit(), dtype=jdt).apply({"params": params}, img, pool_cls=pool_cls), np.float32)
    model = BLIPVisionTransformer(VIT, dtype=tdt).eval()
    model.load_state_dict(state_dict_from_jax(params))
    with torch.inference_mode():
        out = model(torch.from_numpy(img), pool_cls=pool_cls).float().numpy()
    n_tokens = (VIT.image_size // VIT.patch_size) ** 2 + 1
    assert out.shape == ref.shape == (4, 1 if pool_cls else n_tokens, VIT.width)
    if dtype == "fp32":
        np.testing.assert_allclose(out, ref, atol=FP32_ATOL)
    else:
        assert _cosine(out, ref).min() >= BF16_MIN_COSINE


def test_trimmed_last_block_is_exact():
    torch.manual_seed(0)
    model = BLIPVisionTransformer(VIT).eval()
    torch.nn.init.normal_(model.pos_embed, std=0.02)
    img = torch.randn(3, VIT.image_size, VIT.image_size, 3)
    with torch.inference_mode():
        torch.testing.assert_close(model(img, pool_cls=True), model(img)[:, :1], rtol=1e-5, atol=1e-5)


def test_remat_from_layer_keeps_gradients():
    torch.manual_seed(0)
    plain, remat = BLIPVisionTransformer(VIT), BLIPVisionTransformer(VIT, remat_from_layer=1)
    remat.load_state_dict(plain.state_dict())
    img = torch.randn(2, VIT.image_size, VIT.image_size, 3)
    grads = []
    for model in (plain, remat):
        model(img, pool_cls=True).square().sum().backward()
        grads.append([p.grad.clone() for p in model.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_drop_path_is_identity_in_eval_and_rescales_in_training():
    x = torch.ones(64, 3, 5)
    layer = DropPath(0.25)
    assert layer.eval()(x) is x
    torch.manual_seed(0)
    out = layer.train()(x)
    kept = out[:, 0, 0] != 0
    assert 0 < kept.sum() < 64  # whole samples dropped
    torch.testing.assert_close(out[kept], x[kept] / 0.75)
    assert (out[~kept] == 0).all()
    assert DropPath(0.0).train()(x) is x


# ----------------------------------------------------------------------- MED


@pytest.fixture(scope="module")
def jax_med_params():
    """A MED tree with cross-attention and pooler (initialised in multimodal mode)."""
    import jax

    from uniir_tpu.models.med import MedBertModel as JaxMed

    txt, _, _, _ = _inputs()
    enc = np.zeros((4, 17, MED.encoder_width), np.float32)
    params = JaxMed(_jax_med()).init(
        jax.random.PRNGKey(1), txt["input_ids"], txt["attention_mask"], enc, None, "multimodal")["params"]
    return _randomise(params, seed=2)


@pytest.mark.parametrize("mode", ["text", "multimodal"])
@pytest.mark.parametrize("trim_last", [False, True])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_med_matches_jax(jax_med_params, mode, trim_last, dtype):
    import jax.numpy as jnp

    from uniir_tpu.models.med import MedBertModel as JaxMed

    txt, _, _, _ = _inputs()
    rng = np.random.default_rng(3)
    enc = rng.standard_normal((4, 17, MED.encoder_width)).astype(np.float32)
    enc_mask = np.ones((4, 17), np.int32)
    enc_mask[1, 9:] = 0
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    kwargs = dict(mode=mode, trim_last=trim_last)
    ref_h, ref_p = JaxMed(_jax_med(), dtype=jdt).apply(
        {"params": jax_med_params}, txt["input_ids"], txt["attention_mask"],
        jnp.asarray(enc, jdt) if mode == "multimodal" else None, enc_mask if mode == "multimodal" else None, **kwargs)
    model = MedBertModel(MED, dtype=tdt).eval()
    model.load_state_dict(state_dict_from_jax(jax_med_params))
    with torch.inference_mode():
        out_h, out_p = model(
            torch.from_numpy(txt["input_ids"]), torch.from_numpy(txt["attention_mask"]),
            torch.from_numpy(enc).to(tdt) if mode == "multimodal" else None,
            torch.from_numpy(enc_mask) if mode == "multimodal" else None, **kwargs)
    assert out_h.shape == (4, 1 if trim_last else 12, MED.hidden_size) and out_p.shape == (4, MED.hidden_size)
    for out, ref in ((out_h, ref_h), (out_p, ref_p)):
        out, ref = out.float().numpy(), np.asarray(ref, np.float32)
        if dtype == "fp32":
            np.testing.assert_allclose(out, ref, atol=FP32_ATOL)
        else:
            assert _cosine(out, ref).min() >= BF16_MIN_COSINE


def test_med_trimmed_last_layer_is_exact_and_padding_does_not_leak():
    torch.manual_seed(0)
    model = MedBertModel(MED, cross_attention=False).eval()
    txt, _, _, _ = _inputs()
    ids, mask = torch.from_numpy(txt["input_ids"]), torch.from_numpy(txt["attention_mask"])
    with torch.inference_mode():
        full, pooled = model(ids, mask, mode="text")
        trimmed, pooled_t = model(ids, mask, mode="text", trim_last=True)
        torch.testing.assert_close(trimmed, full[:, :1], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(pooled_t, pooled, rtol=1e-5, atol=1e-5)
        # other ids under the padding mask change nothing a valid row reads
        other = torch.where(mask.bool(), ids, torch.randint(4, MED.vocab_size, ids.shape).int())
        assert not torch.equal(other, ids)
        again, _ = model(other, mask, mode="text", trim_last=True)
        torch.testing.assert_close(again, trimmed, rtol=0, atol=0)


def test_med_without_cross_attention_refuses_multimodal_mode():
    model = MedBertModel(MED, cross_attention=False).eval()
    txt, _, _, _ = _inputs()
    with pytest.raises(ValueError, match="cross"):
        model(torch.from_numpy(txt["input_ids"]), encoder_hidden_states=torch.zeros(4, 5, MED.encoder_width))
    with pytest.raises(ValueError, match="encoder_hidden_states"):
        MedBertModel(MED).eval()(torch.from_numpy(txt["input_ids"]))


def test_med_layernorm_epsilon_is_berts():
    eps = {m.eps for m in MedBertModel(MED).modules() if isinstance(m, torch.nn.LayerNorm)}
    assert eps == {1e-12}
    assert {m.eps for m in BLIPVisionTransformer(VIT).modules() if isinstance(m, torch.nn.LayerNorm)} == {1e-6}


# ------------------------------------------------- position-embedding resize


@pytest.mark.parametrize("old,new", [(14, 24), (24, 14), (4, 8)])
def test_interpolate_pos_embed_matches_jax(old, new):
    import jax.numpy as jnp

    from uniir_tpu.models.layers import interpolate_pos_embed as jax_interpolate

    pos = np.random.default_rng(old).standard_normal((1, old * old + 1, 8)).astype(np.float32)
    ref = np.asarray(jax_interpolate(jnp.asarray(pos), new * new))
    out = interpolate_pos_embed(torch.from_numpy(pos), new * new).numpy()
    assert out.shape == ref.shape == (1, new * new + 1, 8)
    np.testing.assert_allclose(out, ref, atol=POS_EMBED_ATOL)
    np.testing.assert_array_equal(out[:, 0], pos[:, 0])  # the prefix token is kept
    same = interpolate_pos_embed(torch.from_numpy(pos[0]), old * old)
    np.testing.assert_array_equal(same.numpy(), pos[0])  # 2-D input, same grid


# ----------------------------------------------------------- the whole model


def test_blip_sf_fp32_matches_jax(jax_sf_params):
    from uniir_tpu.models.blip_sf import BLIPScoreFusion as JaxBLIPSF

    txt, img, tm, im = _inputs()
    ref = JaxBLIPSF(vit_cfg=_jax_vit(), med_cfg=_jax_med(), embed_dim=EMBED_DIM).apply(
        {"params": jax_sf_params}, txt, img, tm, im)
    model = _port_sf(jax_sf_params)
    with torch.inference_mode():
        out = model(_torch_txt(txt), *(torch.from_numpy(a) for a in (img, tm, im)))
        txt_only = model.encode_texts(_torch_txt(txt))
        img_only = model.encode_images(torch.from_numpy(img))
    assert out.dtype == torch.float32 and out.shape == (4, EMBED_DIM)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FP32_ATOL)
    # masked fusion: row 1 is text only, row 2 image only
    torch.testing.assert_close(out[1], txt_only[1])
    torch.testing.assert_close(out[2], img_only[2])
    torch.testing.assert_close(out[0], model.fuse_embeddings(txt_only, img_only)[0])


def test_blip_sf_bf16_matches_jax(jax_sf_params):
    import jax.numpy as jnp

    from uniir_tpu.models.blip_sf import BLIPScoreFusion as JaxBLIPSF

    txt, img, tm, im = _inputs()
    ref = JaxBLIPSF(vit_cfg=_jax_vit(), med_cfg=_jax_med(), embed_dim=EMBED_DIM, dtype=jnp.bfloat16).apply(
        {"params": jax_sf_params}, txt, img, tm, im)
    model = _port_sf(jax_sf_params, torch.bfloat16)
    assert model.vision_proj.weight.dtype == torch.bfloat16
    assert model.visual_encoder.norm.weight.dtype == torch.float32 and model.temp.dtype == torch.float32
    assert model.text_encoder.embeddings.LayerNorm.weight.dtype == torch.float32
    with torch.inference_mode():
        out = model(_torch_txt(txt), *(torch.from_numpy(a) for a in (img, tm, im)))
    assert out.dtype == torch.float32
    assert _cosine(out.numpy(), np.asarray(ref, np.float32)).min() >= BF16_MIN_COSINE


def test_padding_does_not_leak_into_the_embedding(jax_sf_params):
    model = _port_sf(jax_sf_params)
    txt, img, tm, im = _inputs()
    other = dict(txt, input_ids=np.where(txt["attention_mask"] == 1, txt["input_ids"], 7).astype(np.int32))
    with torch.inference_mode():
        a = model(_torch_txt(txt), *(torch.from_numpy(x) for x in (img, tm, im)))
        b = model(_torch_txt(other), *(torch.from_numpy(x) for x in (img, tm, im)))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_seeded_model_is_deterministic_and_cast():
    a, b = (seeded_blip_sf(VIT, MED, "cpu", seed=3, embed_dim=EMBED_DIM) for _ in range(2))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
        is_ln = any(tag in name for tag in ("norm", "LayerNorm"))
        assert p.dtype == (torch.float32 if is_ln or name == "temp" else torch.bfloat16), name
    assert not a.visual_encoder.cls_token.any() and not a.visual_encoder.pos_embed.any()  # zero-init, as in flax
    assert abs(a.temp.item() - 0.07) < 1e-6
    c = seeded_blip_sf(VIT, MED, "cpu", seed=4, embed_dim=EMBED_DIM)
    assert not torch.equal(a.vision_proj.weight, c.vision_proj.weight)
    txt, img, tm, im = _inputs()
    with torch.inference_mode():
        out = a(_torch_txt(txt), *(torch.from_numpy(x) for x in (img, tm, im)))
    assert out.shape == (4, EMBED_DIM) and torch.isfinite(out).all()


# -------------------------------------------------------------- the registry


def _published_like_checkpoint(tmp_path, scale=0.1):
    """A fake BLIP-SF .pth as a DDP-saved UniIR checkpoint has it: `module.`
    prefixes, cross-attention, momentum twins, queues, HF buffers and a
    token-type table."""
    sd = {k: v * scale if v.dim() > 0 else v for k, v in _fake_sd().items()}
    g = torch.Generator().manual_seed(5)
    sd["text_encoder.embeddings.token_type_embeddings.weight"] = torch.randn(2, MED.hidden_size, generator=g) * scale
    sd["text_encoder.embeddings.position_ids"] = torch.arange(MED.max_position_embeddings)[None]
    sd["visual_encoder_m.cls_token"] = torch.randn(1, 1, VIT.width)
    sd["vision_proj_m.weight"] = torch.randn(EMBED_DIM, VIT.width)
    sd["query_queue"] = torch.randn(EMBED_DIM, 8)
    sd["idx_queue"] = torch.zeros(1, 8)
    sd["queue_ptr"] = torch.zeros(1)
    path = tmp_path / "blip_sf_tiny.pth"
    torch.save({"model": {f"module.{k}": v for k, v in sd.items()}}, str(path))
    return sd, str(path)


def _registry_config(tmp_path, **model):
    from tests.helpers import tiny_bert_vocab

    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(tiny_bert_vocab()) + "\n")
    return Config.from_dict({
        "uniir_dir": str(tmp_path), "seed": 0,
        "model": {"name": "BLIPScoreFusion", "vit": "test-tiny", "embed_dim": EMBED_DIM, "bf16": False,
                  "tokenizer_max_length": 12, "bert_vocab_path": str(vocab), **model},
    })


@pytest.mark.parametrize("image_size", [32, 64])
def test_blip_pth_loads_through_the_registry_like_the_jax_converter(tmp_path, image_size):
    """Token-type fold, dropped cross-attention / momentum keys, and (at 64)
    the position-embedding resize: embeddings equal the JAX
    `convert_checkpoint` path's."""
    import dataclasses

    from uniir_tpu.models.blip_sf import BLIPScoreFusion as JaxBLIPSF
    from uniir_tpu.models.convert import convert_checkpoint

    sd, path = _published_like_checkpoint(tmp_path)
    config = _registry_config(tmp_path, image_size=image_size, strict_convert=True,
                              ckpt_config={"ckpt_dir": ".", "ckpt_name": "blip_sf_tiny.pth"})
    bundle = build_model_from_config(config, device="cpu")
    assert bundle.name == "BLIPScoreFusion" and bundle.image_size == (image_size, image_size) and bundle.embed_dim == EMBED_DIM
    model = bundle.model
    assert not model.training and model.dtype == torch.float32
    folded = sd["text_encoder.embeddings.position_embeddings.weight"] + sd["text_encoder.embeddings.token_type_embeddings.weight"][0]
    torch.testing.assert_close(model.text_encoder.embeddings.position_embeddings.weight, folded, rtol=0, atol=0)
    n_tokens = (image_size // VIT.patch_size) ** 2 + 1
    assert model.visual_encoder.pos_embed.shape == (1, n_tokens, VIT.width)

    params = convert_checkpoint(path, "BLIPScoreFusion", "test-tiny", image_size=image_size, strict=True)
    rng = np.random.default_rng(7)
    txt = bundle.tokenizer(["a dog on the street", "", "two cats", "the cat sat"])
    img = rng.standard_normal((4, image_size, image_size, 3)).astype(np.float32)
    tm, im = np.array([1, 0, 1, 1], np.int32), np.array([1, 1, 0, 1], np.int32)
    jax_cfg = dataclasses.replace(_jax_vit(), image_size=image_size)
    ref = JaxBLIPSF(vit_cfg=jax_cfg, med_cfg=_jax_med(), embed_dim=EMBED_DIM).apply({"params": params}, txt, img, tm, im)
    with torch.inference_mode():
        out = model(_torch_txt(txt), *(torch.from_numpy(a) for a in (img, tm, im)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FP32_ATOL)


def test_blip_checkpoint_loader_reports_unknown_and_missing_keys(tmp_path):
    sd, path = _published_like_checkpoint(tmp_path)
    sd["visual_encoder.mystery.weight"] = torch.randn(2, 2)
    torch.save(sd, str(tmp_path / "odd.pth"))
    model = BLIPScoreFusion(VIT, MED, EMBED_DIM)
    with pytest.raises(ValueError, match="mystery"):
        load_blip_checkpoint(model, str(tmp_path / "odd.pth"), strict=True)
    load_blip_checkpoint(model, str(tmp_path / "odd.pth"))  # non-strict: warns and loads
    del sd["visual_encoder.mystery.weight"], sd["vision_proj.bias"]
    torch.save(sd, str(tmp_path / "short.pth"))
    with pytest.raises(RuntimeError, match="vision_proj.bias"):
        load_blip_checkpoint(model, str(tmp_path / "short.pth"))


def test_published_config_parses_and_raises_only_for_the_missing_vocabulary():
    config = load_config(os.path.join(REPO, "configs", "blip_sf", "large", "eval", "inbatch", "embed.yaml"))
    assert config.model.name == "BLIPScoreFusion" and config.model.vit == "large"
    assert config.model.tokenizer_max_length == 50 and config.model.bert_vocab_path is None
    with pytest.raises(FileNotFoundError, match="bert_vocab_path"):
        build_model_from_config(config, device="cpu")


def test_unported_blip_options_raise(tmp_path):
    # both retrievers train (fp32 masters, train mode) and serve in int8; an int8 model does not train
    from uniir_tpu_torch.ops.quant import QuantLinear

    trained = build_model_from_config(_registry_config(tmp_path), device="cpu", train=True).model
    assert trained.training and all(p.dtype == torch.float32 for p in trained.parameters())
    for name in ("BLIPScoreFusion", "BLIPFeatureFusion"):
        served = build_model_from_config(_registry_config(tmp_path, name=name, int8=True), device="cpu").model
        assert not served.training and any(isinstance(m, QuantLinear) for m in served.text_encoder.modules())
        with pytest.raises(ValueError, match="serving"):
            build_model_from_config(_registry_config(tmp_path, name=name, int8=True), device="cpu", train=True)
    with pytest.raises(ValueError, match="Unknown model name"):
        build_model_from_config(Config.from_dict({"model": {"name": "BLIPFusion"}}), device="cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.gpu
def test_blip_large_bf16_on_card_runs_the_kernel(cuda):
    """Seeded BLIP-SF at the full width of `large` (batch 2): finite
    embeddings, 23 K1 launches (the trimmed last ViT block and MED take the
    einsum path)."""
    from uniir_tpu_torch.ops.attention import attention

    vit, med = BLIP_VIT_CONFIGS["large"], MED_CONFIGS["large"]
    model = seeded_blip_sf(vit, med, cuda, seed=0)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(4, med.vocab_size, (2, 50))).to(cuda)
    mask = torch.ones(2, 50, dtype=torch.int32, device=cuda)
    mask[1, 20:] = 0
    img = torch.randn(2, vit.image_size, vit.image_size, 3, device=cuda)
    ones = torch.ones(2, dtype=torch.int32, device=cuda)
    before = attention.launches
    with torch.inference_mode():
        out = model({"input_ids": ids, "attention_mask": mask}, img, ones, ones)
    assert out.shape == (2, 768) and torch.isfinite(out).all()
    assert attention.launches - before == vit.layers - 1
