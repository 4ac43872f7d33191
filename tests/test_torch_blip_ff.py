"""BLIP-FF in the port against the JAX package at `test-tiny`, on the same
seeded inputs and weights (moved over with `state_dict_from_jax`): the whole
retriever (ViT tokens -> MED in multimodal mode -> pooler), and a fake BLIP
`.pth` through both registries.  MED's cross-attention, the pooler and the
ViT's token output are held against JAX one by one in `test_torch_blip.py`.

JAX is imported inside the parity tests only, so the GPU case also runs on
a host without it:
`python -m pytest tests/test_torch_blip_ff.py -m gpu --noconftest`.
"""

import os

import numpy as np
import pytest
import torch

from uniir_tpu_torch.core.config import Config, load_config
from uniir_tpu_torch.models.blip_ff import BLIPFeatureFusion
from uniir_tpu_torch.models.blip_vit import BLIP_VIT_CONFIGS
from uniir_tpu_torch.models.convert import state_dict_from_jax
from uniir_tpu_torch.models.med import MED_CONFIGS
from uniir_tpu_torch.models.registry import build_model_from_config, load_blip_checkpoint, seeded_blip_ff

VIT, MED = BLIP_VIT_CONFIGS["test-tiny"], MED_CONFIGS["test-tiny"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# fp32 on both sides: only summation order, the erf / tanh implementations
# and LayerNorm's variance formula differ (flax uses E[x^2] - E[x]^2).
FP32_ATOL = 1e-4
# bf16: roundings at different points in the two frameworks; the direction
# of the pooled embedding survives.
BF16_MIN_COSINE = 0.999


def _cosine(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def _inputs(n=4, seq=12, seed=0):
    """Token ids with padding masks of mixed lengths, and images."""
    rng = np.random.default_rng(seed)
    ids = np.zeros((n, seq), np.int32)
    mask = np.zeros((n, seq), np.int32)
    for i in range(n):
        length = 3 + (2 * i) % (seq - 3)
        ids[i, :length] = rng.integers(4, MED.vocab_size, length)
        mask[i, :length] = 1
    img = rng.standard_normal((n, VIT.image_size, VIT.image_size, 3)).astype(np.float32)
    return {"input_ids": ids, "attention_mask": mask}, img, np.array([1, 1, 0, 1][:n], np.int32), np.array([1, 0, 1, 1][:n], np.int32)


def _jax_cfgs():
    from uniir_tpu.models.blip_vit import BLIP_VIT_CONFIGS as JV
    from uniir_tpu.models.med import MED_CONFIGS as JM

    return JV["test-tiny"], JM["test-tiny"]


def _jax_model(**kwargs):
    from uniir_tpu.models.blip_ff import BLIPFeatureFusion as JaxBLIPFF

    vit, med = _jax_cfgs()
    return JaxBLIPFF(vit_cfg=vit, med_cfg=med, **kwargs)


@pytest.fixture(scope="module")
def jax_params():
    """Initialised JAX BLIP-FF parameters, zero-initialised leaves (cls_token,
    pos_embed, biases) replaced by noise so that every one takes part."""
    import jax

    rng = np.random.default_rng(1)
    params = _jax_model().init(jax.random.PRNGKey(0), *_inputs())["params"]
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) if np.any(np.asarray(x)) else (0.02 * rng.standard_normal(np.shape(x))).astype(np.float32),
        params,
    )


def _torch_txt(txt):
    return {k: torch.from_numpy(v) for k, v in txt.items()}


def _port_model(params, dtype=torch.float32):
    model = BLIPFeatureFusion(VIT, MED)
    model.load_state_dict(state_dict_from_jax(params))
    return model.to_compute_dtype(dtype).eval()


def _run(model, txt, img, tm=None, im=None):
    with torch.inference_mode():
        masks = [] if tm is None else [torch.from_numpy(tm), torch.from_numpy(im)]
        return model(_torch_txt(txt), torch.from_numpy(img), *masks)


# ------------------------------------------------------------ weights across


def _fake_sd():
    from tests.test_convert import fake_blip_sd

    return fake_blip_sd(*_jax_cfgs(), with_pooler=True)


def test_state_dict_from_jax_inverts_convert_blip_ff_params():
    from uniir_tpu.models import convert as jax_convert

    sd = jax_convert.to_numpy_state_dict(_fake_sd())
    params = jax_convert.convert_blip_ff_params(sd, VIT.layers, MED.num_hidden_layers)
    back = state_dict_from_jax(params)
    assert set(back) == set(sd)  # cross-attention and pooler kept, no projection heads
    for key, value in sd.items():
        np.testing.assert_array_equal(back[key].numpy(), value, err_msg=key)


def test_port_module_takes_blip_names():
    sd = _fake_sd()
    model = BLIPFeatureFusion(VIT, MED)
    assert set(model.state_dict()) == set(sd)
    assert any("crossattention" in k for k in sd) and "text_encoder.pooler.dense.weight" in sd
    assert not any(k.startswith(("vision_proj", "text_proj")) for k in sd)
    model.load_state_dict({k: v.reshape(model.state_dict()[k].shape) for k, v in sd.items()})  # strict


# ------------------------------------------------------------- the retriever


def test_blip_ff_fp32_matches_jax(jax_params):
    txt, img, tm, im = _inputs()
    ref = _jax_model().apply({"params": jax_params}, txt, img, tm, im)
    out = _run(_port_model(jax_params), txt, img, tm, im)
    assert out.dtype == torch.float32 and out.shape == (4, MED.hidden_size)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FP32_ATOL)


def test_blip_ff_bf16_matches_jax(jax_params):
    import jax.numpy as jnp

    txt, img, tm, im = _inputs()
    ref = _jax_model(dtype=jnp.bfloat16).apply({"params": jax_params}, txt, img, tm, im)
    model = _port_model(jax_params, torch.bfloat16)
    assert model.text_encoder.pooler.dense.weight.dtype == torch.bfloat16
    assert model.visual_encoder.norm.weight.dtype == torch.float32 and model.temp.dtype == torch.float32
    out = _run(model, txt, img, tm, im)
    assert out.dtype == torch.float32
    assert _cosine(out.numpy(), np.asarray(ref, np.float32)).min() >= BF16_MIN_COSINE


def test_modality_masks_are_accepted_and_unused(jax_params):
    txt, img, tm, im = _inputs()
    model = _port_model(jax_params)
    assert torch.equal(_run(model, txt, img, tm, im), _run(model, txt, img))
    assert not torch.equal(_run(model, txt, img), _run(model, txt, img + 0.5))  # the image reaches the text encoder


def test_padding_does_not_leak_into_the_embedding(jax_params):
    model = _port_model(jax_params)
    txt, img, _, _ = _inputs()
    other = dict(txt, input_ids=np.where(txt["attention_mask"] == 1, txt["input_ids"], 7).astype(np.int32))
    torch.testing.assert_close(_run(model, txt, img), _run(model, other, img), rtol=0, atol=0)


def test_trimmed_last_layer_equals_the_full_pooler_output(jax_params):
    """`trim_last` computes only the CLS row of the last MED layer: the
    pooled output equals the untrimmed encoder's."""
    model = _port_model(jax_params)
    txt, img, _, _ = _inputs()
    with torch.inference_mode():
        tokens = model.visual_encoder(torch.from_numpy(img))
        t = _torch_txt(txt)
        _, full = model.text_encoder(t["input_ids"], attention_mask=t["attention_mask"], encoder_hidden_states=tokens,
                                     mode="multimodal", trim_last=False)
    torch.testing.assert_close(_run(model, txt, img), full.float(), rtol=1e-5, atol=1e-5)


def test_seeded_model_is_deterministic_and_cast():
    a, b = (seeded_blip_ff(VIT, MED, "cpu", seed=3) for _ in range(2))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
        is_ln = any(tag in name for tag in ("norm", "LayerNorm"))
        assert p.dtype == (torch.float32 if is_ln or name == "temp" else torch.bfloat16), name
    assert abs(a.temp.item() - 0.07) < 1e-6 and not a.training
    c = seeded_blip_ff(VIT, MED, "cpu", seed=4)
    assert not torch.equal(a.text_encoder.pooler.dense.weight, c.text_encoder.pooler.dense.weight)
    txt, img, _, _ = _inputs()
    out = _run(a, txt, img)
    assert out.shape == (4, MED.hidden_size) and torch.isfinite(out).all()


# -------------------------------------------------------------- the registry


def _published_like_checkpoint(tmp_path, scale=0.1):
    """A fake BLIP-FF .pth as a DDP-saved UniIR checkpoint has it: `module.`
    prefixes, momentum twins, queues, HF buffers and a token-type table."""
    sd = {k: v * scale if v.dim() > 0 else v for k, v in _fake_sd().items()}
    g = torch.Generator().manual_seed(5)
    sd["text_encoder.embeddings.token_type_embeddings.weight"] = torch.randn(2, MED.hidden_size, generator=g) * scale
    sd["text_encoder.embeddings.position_ids"] = torch.arange(MED.max_position_embeddings)[None]
    sd["visual_encoder_m.cls_token"] = torch.randn(1, 1, VIT.width)
    sd["text_encoder_m.pooler.dense.weight"] = torch.randn(MED.hidden_size, MED.hidden_size)
    sd["query_queue"] = torch.randn(MED.hidden_size, 8)
    sd["queue_ptr"] = torch.zeros(1)
    path = tmp_path / "blip_ff_tiny.pth"
    torch.save({"model": {f"module.{k}": v for k, v in sd.items()}}, str(path))
    return sd, str(path)


def _registry_config(tmp_path, **model):
    from tests.helpers import tiny_bert_vocab

    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(tiny_bert_vocab()) + "\n")
    return Config.from_dict({
        "uniir_dir": str(tmp_path), "seed": 0,
        "model": {"name": "BLIPFeatureFusion", "vit": "test-tiny", "bf16": False,
                  "tokenizer_max_length": 12, "bert_vocab_path": str(vocab), **model},
    })


@pytest.mark.parametrize("image_size", [32, 64])
def test_blip_ff_pth_loads_through_the_registry_like_the_jax_converter(tmp_path, image_size):
    """Token-type fold, kept cross-attention and pooler, dropped momentum
    keys, and (at 64) the position-embedding resize: embeddings equal the
    JAX `convert_checkpoint` path's."""
    import dataclasses

    from uniir_tpu.models.convert import convert_checkpoint

    sd, path = _published_like_checkpoint(tmp_path)
    config = _registry_config(tmp_path, image_size=image_size, strict_convert=True,
                              ckpt_config={"ckpt_dir": ".", "ckpt_name": "blip_ff_tiny.pth"})
    bundle = build_model_from_config(config, device="cpu")
    assert bundle.name == "BLIPFeatureFusion" and bundle.image_size == (image_size, image_size)
    model = bundle.model
    assert isinstance(model, BLIPFeatureFusion) and not model.training and model.dtype == torch.float32
    key = "text_encoder.encoder.layer.1.crossattention.self.key.weight"
    torch.testing.assert_close(model.state_dict()[key], sd[key], rtol=0, atol=0)

    params = convert_checkpoint(path, "BLIPFeatureFusion", "test-tiny", image_size=image_size, strict=True)
    rng = np.random.default_rng(7)
    txt = bundle.tokenizer(["a dog on the street", "", "two cats", "the cat sat"])
    img = rng.standard_normal((4, image_size, image_size, 3)).astype(np.float32)
    vit, med = _jax_cfgs()
    ref = _jax_model().clone(vit_cfg=dataclasses.replace(vit, image_size=image_size)).apply({"params": params}, txt, img)
    np.testing.assert_allclose(_run(model, txt, img).numpy(), np.asarray(ref), atol=FP32_ATOL)


def test_blip_ff_loader_requires_the_cross_attention_keys(tmp_path):
    sd, _ = _published_like_checkpoint(tmp_path)
    short = {k: v for k, v in sd.items() if "crossattention" not in k}
    torch.save(short, str(tmp_path / "sf_like.pth"))
    with pytest.raises(RuntimeError, match="crossattention"):
        load_blip_checkpoint(BLIPFeatureFusion(VIT, MED), str(tmp_path / "sf_like.pth"))
    sd["text_encoder.mystery"] = torch.zeros(1)
    torch.save(sd, str(tmp_path / "odd.pth"))
    with pytest.raises(ValueError, match="mystery"):
        load_blip_checkpoint(BLIPFeatureFusion(VIT, MED), str(tmp_path / "odd.pth"), strict=True)


def test_registry_raises_without_a_card_unless_cpu_is_named(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="cpu"):
        build_model_from_config(_registry_config(tmp_path))


def test_published_config_parses_and_raises_only_for_the_missing_vocabulary():
    config = load_config(os.path.join(REPO, "configs", "blip_ff", "large", "eval", "inbatch", "embed.yaml"))
    assert config.model.name == "BLIPFeatureFusion" and config.model.vit == "large"
    with pytest.raises(FileNotFoundError, match="bert_vocab_path"):
        build_model_from_config(config, device="cpu")


@pytest.mark.parametrize("kwargs,train", [({"int8": True}, False), ({}, True)])
def test_int8_and_training_raise_with_roadmap_pointer(tmp_path, kwargs, train):
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        build_model_from_config(_registry_config(tmp_path, **kwargs), device="cpu", train=train)


# --------------------------------------------------------------------- GPU


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.gpu
def test_blip_ff_large_bf16_on_card_runs_the_kernel(cuda):
    """Seeded BLIP-FF at the full width of `large` (batch 2): finite
    embeddings, 24 K1 launches (every ViT block; MED takes the einsum path)."""
    from uniir_tpu_torch.ops.attention import attention

    vit, med = BLIP_VIT_CONFIGS["large"], MED_CONFIGS["large"]
    model = seeded_blip_ff(vit, med, cuda, seed=0)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(4, med.vocab_size, (2, 50))).to(cuda)
    mask = torch.ones(2, 50, dtype=torch.int32, device=cuda)
    mask[1, 20:] = 0
    img = torch.randn(2, vit.image_size, vit.image_size, 3, device=cuda)
    before = attention.launches
    with torch.inference_mode():
        out = model({"input_ids": ids, "attention_mask": mask}, img)
    torch.cuda.synchronize()
    assert out.shape == (2, med.hidden_size) and torch.isfinite(out).all()
    assert attention.launches - before == vit.layers
