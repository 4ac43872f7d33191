"""int8 BLIP-SF and BLIP-FF serving as a whole: the port against the JAX
package's `BLIPScoreFusion(quant=True)` / `BLIPFeatureFusion(quant=True)` on
the same quantised weights (made by the JAX `quantize_tree`, carried over by
`state_dict_from_jax`), in every activation mode -- the ViT's blocks (K6
with the exact GELU under the static mode), MED's self- and cross-attention
with their three scales, its FFNs and pooler, BLIP-SF's heads; calibration,
the artifact with MED's triples, the quantised state dict under timm's
names, the registry and the calibration CLI.

Tolerances, as tests/test_torch_int8_clip.py's: fp32 within FP32_ATOL
absolute (WONLY_FP32_ATOL in `wonly`, see there) and cosine >=
FP32_MIN_COSINE per row (the JAX side with UNIIR_INT8_FLAT=0, its 3-D
tower; once with its padded-flat default, whose math is the same, at the
bf16 bound); bf16 cosine >= BF16_MIN_COSINE; int8 against the port's own
float model cosine >= 0.98, the JAX package's bound in
tests/test_quant_variants.py.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from uniir_tpu_torch.models import registry as port_registry
from uniir_tpu_torch.models.blip_ff import BLIPFeatureFusion
from uniir_tpu_torch.models.blip_sf import BLIPScoreFusion
from uniir_tpu_torch.models.blip_vit import BLIP_VIT_CONFIGS
from uniir_tpu_torch.models.convert import state_dict_from_jax
from uniir_tpu_torch.models.med import MED_CONFIGS
from uniir_tpu_torch.ops import calibrate as C
from uniir_tpu_torch.ops import quant as Q

FP32_MIN_COSINE = 0.9999
FP32_ATOL = 1e-3
BF16_MIN_COSINE = 0.999
INT8_VS_FLOAT_MIN_COSINE = 0.98
# `wonly` rounds every Dense input to bf16: a last-bit fp32 difference upstream can move an input
# by one bf16 step (tests/test_torch_int8_clip_ff.py measures what one step does)
WONLY_FP32_ATOL = 1e-2

NAMES = ("BLIPScoreFusion", "BLIPFeatureFusion")
PORT = {"BLIPScoreFusion": BLIPScoreFusion, "BLIPFeatureFusion": BLIPFeatureFusion}
TINY_VIT = BLIP_VIT_CONFIGS["test-tiny"]
# wide enough (W % 128 == 0) for the JAX package's fused int8 MLP kernel in the ViT
WIDE_VIT = dataclasses.replace(TINY_VIT, width=128)
MODES = {"xla": ("dynamic", "fused"), "wonly": ("wonly", "fused"), "static": ("static", "xla"),
         "static-fused": ("static", "fused")}


def _cfgs(width: str):
    from uniir_tpu.models.blip_vit import BLIP_VIT_CONFIGS as JAX_VIT
    from uniir_tpu.models.med import MED_CONFIGS as JAX_MED

    vit = TINY_VIT if width == "tiny" else WIDE_VIT
    jvit = dataclasses.replace(JAX_VIT["test-tiny"], width=vit.width)
    med = dataclasses.replace(MED_CONFIGS["test-tiny"], encoder_width=vit.width)
    jmed = dataclasses.replace(JAX_MED["test-tiny"], encoder_width=vit.width)
    return (jvit, jmed), (vit, med)


def _embed_dim(name, med):
    return 16 if name == "BLIPScoreFusion" else med.hidden_size


def _inputs(n=4, seed=0, seq=12):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, MED_CONFIGS["test-tiny"].vocab_size - 1, (n, seq)).astype(np.int32)
    attn = np.ones((n, seq), np.int32)
    for i in range(n):
        attn[i, 3 + (3 * i) % (seq - 3):] = 0  # padding of mixed lengths
    img = rng.normal(size=(n, TINY_VIT.image_size, TINY_VIT.image_size, 3)).astype(np.float32)
    txt_mask = np.array([1, 1, 0, 1][:n], np.int32)
    img_mask = np.array([1, 0, 1, 1][:n], np.int32)
    return {"input_ids": ids, "attention_mask": attn}, img, txt_mask, img_mask


def _torch_batch(batch):
    txt, *rest = batch
    return ({k: torch.from_numpy(v) for k, v in txt.items()}, *(torch.from_numpy(a) for a in rest))


def _cosine(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def _jax_model(name, jcfgs, **kwargs):
    from uniir_tpu.models.blip_ff import BLIPFeatureFusion as JaxBLIPFF
    from uniir_tpu.models.blip_sf import BLIPScoreFusion as JaxBLIPSF

    jvit, jmed = jcfgs
    cls = JaxBLIPSF if name == "BLIPScoreFusion" else JaxBLIPFF
    return cls(vit_cfg=jvit, med_cfg=jmed, embed_dim=_embed_dim(name, jmed), **kwargs)


@pytest.fixture(scope="module")
def jax_models():
    """Per (model, width): float JAX params (cls_token / pos_embed given
    values: flax zero-initialises them), the JAX calibration of the fp32
    model and the quantised tree."""
    import jax

    from uniir_tpu.ops.calibrate import calibrate_act_scales
    from uniir_tpu.ops.quant import quantize_tree

    out = {}
    for name in NAMES:
        for width in ("tiny", "wide"):
            jcfgs, _ = _cfgs(width)
            model = _jax_model(name, jcfgs)
            batch = _inputs()
            params = jax.tree_util.tree_map(np.asarray, model.init(jax.random.PRNGKey(2), *batch)["params"])
            rng = np.random.default_rng(1)
            for leaf in ("cls_token", "pos_embed"):
                shape = params["visual_encoder"][leaf].shape
                params["visual_encoder"][leaf] = (0.02 * rng.standard_normal(shape)).astype(np.float32)
            scales = calibrate_act_scales(model, params, [batch, _inputs(seed=1)], act="gelu")
            out[name, width] = {"params": params, "scales": scales, "qparams": quantize_tree(params, act_scales=scales)}
    return out


def _port_float(name, params, cfgs, dtype=torch.float32):
    vit, med = cfgs
    model = PORT[name](vit, med, _embed_dim(name, med))
    model.load_state_dict(state_dict_from_jax(params))
    return model.to_compute_dtype(dtype).eval()


def _port_quant(name, qparams, cfgs, mode, route, dtype=torch.float32):
    vit, med = cfgs
    model = PORT[name](vit, med, _embed_dim(name, med), quant=True, int8_mode=mode, mlp_route=route)
    Q.load_quantized_state_dict(model, state_dict_from_jax(qparams))
    return model.to_compute_dtype(dtype).eval()


def _jax_quant_embed(monkeypatch, name, jcfgs, qparams, backend, batch, dtype, flat="0"):
    import jax.numpy as jnp

    monkeypatch.setenv("UNIIR_INT8_BACKEND", backend.split("-")[0])
    monkeypatch.setenv("UNIIR_INT8_MLP", "fused" if backend.endswith("fused") else "xla")
    if flat is None:
        monkeypatch.delenv("UNIIR_INT8_FLAT", raising=False)
    else:
        monkeypatch.setenv("UNIIR_INT8_FLAT", flat)
    model = _jax_model(name, jcfgs, dtype=getattr(jnp, dtype), quant=True)
    return np.asarray(model.apply({"params": qparams}, *batch), np.float32)


@pytest.mark.parametrize("name", NAMES)
def test_quantised_tree_converts_onto_the_int8_modules(jax_models, name):
    """`state_dict_from_jax` of a quantised BLIP tree (the ViT under timm's
    names, act_scales leaves included) loads into the port's int8 twin, and
    the port's own quantisation of the float model loads the same values."""
    m = jax_models[name, "tiny"]
    _, cfgs = _cfgs("tiny")
    sd = state_dict_from_jax(m["qparams"])
    assert "visual_encoder.blocks.0.attn.qkv.weight_q" in sd and sd["visual_encoder.blocks.0.mlp.act_scales"].shape == (2,)
    assert sd["text_encoder.encoder.layer.1.attention.act_scales"].shape == (3,)
    assert sd["text_encoder.encoder.layer.1.act_scales"].shape == (2,)
    twin = _port_quant(name, m["qparams"], cfgs, "static", "fused")
    floats = _port_float(name, m["params"], cfgs)
    own = PORT[name](*cfgs, _embed_dim(name, cfgs[1]), quant=True, int8_mode="static")
    Q.load_quantized_state_dict(own, Q.quantize_state_dict(floats, C.act_scales_by_module(m["scales"], floats)))
    mine, theirs = own.state_dict(), twin.state_dict()
    assert set(mine) == set(theirs) == set(sd)
    for key in sd:
        assert torch.equal(mine[key], theirs[key]), key
    if name == "BLIPFeatureFusion":
        assert theirs["text_encoder.encoder.layer.0.crossattention.act_scales"].shape == (3,)
        assert theirs["text_encoder.pooler.dense.weight_q"].dtype == torch.int8


@pytest.mark.parametrize("name", NAMES)
def test_quantised_state_dict_round_trips_under_timm_names(jax_models, name):
    m = jax_models[name, "tiny"]
    _, cfgs = _cfgs("tiny")
    twin = _port_quant(name, m["qparams"], cfgs, "static", "fused")
    sd = twin.state_dict()
    block = "visual_encoder.blocks.1"
    assert {f"{block}.attn.qkv.weight_q", f"{block}.attn.proj.scale", f"{block}.mlp.fc1.bias", f"{block}.mlp.fc2.weight_q",
            f"{block}.attn.act_scales"} <= set(sd)
    assert not any("qkv_proj" in k or "c_fc" in k or "in_proj" in k for k in sd)
    again = PORT[name](*cfgs, _embed_dim(name, cfgs[1]), quant=True, int8_mode="static")
    Q.load_quantized_state_dict(again, sd)
    assert all(torch.equal(again.state_dict()[k], v) for k, v in sd.items())
    batch = _torch_batch(_inputs())
    with torch.inference_mode():
        assert torch.equal(again.eval()(*batch), twin(*batch))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend", ["xla", "wonly", "static", "static-fused"])
@pytest.mark.parametrize("name", NAMES)
def test_int8_blip_matches_jax(jax_models, monkeypatch, name, backend, dtype):
    # the JAX fused MLP kernel needs W % 128 == 0; below that its static mode
    # takes two static products, which is the port's "xla" route
    width = "wide" if backend == "static-fused" else "tiny"
    jcfgs, cfgs = _cfgs(width)
    batch = _inputs()
    qparams = jax_models[name, width]["qparams"]
    ref = _jax_quant_embed(monkeypatch, name, jcfgs, qparams, backend, batch, dtype)
    mode, route = MODES[backend]
    model = _port_quant(name, qparams, cfgs, mode, route, getattr(torch, dtype))
    with torch.inference_mode():
        out = model(*_torch_batch(batch))
    assert out.dtype == torch.float32 and out.shape == ref.shape and torch.isfinite(out).all()
    cos = _cosine(out.numpy(), ref)
    print(f"{name} {backend} {dtype}: min cosine {cos.min():.7f}, max abs diff {np.abs(out.numpy() - ref).max():.3e}")
    assert cos.min() >= (BF16_MIN_COSINE if dtype == "bfloat16" else FP32_MIN_COSINE), cos
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), ref, atol=WONLY_FP32_ATOL if backend == "wonly" else FP32_ATOL, rtol=0)


@pytest.mark.parametrize("name", NAMES)
def test_int8_blip_matches_jax_flat_tower(jax_models, monkeypatch, name):
    """The JAX ViT's padded-flat default (not carried over) computes the same function."""
    jcfgs, cfgs = _cfgs("tiny")
    batch = _inputs()
    qparams = jax_models[name, "tiny"]["qparams"]
    ref = _jax_quant_embed(monkeypatch, name, jcfgs, qparams, "static", batch, "float32", flat=None)
    with torch.inference_mode():
        out = _port_quant(name, qparams, cfgs, "static", "xla")(*_torch_batch(batch))
    assert _cosine(out.numpy(), ref).min() >= BF16_MIN_COSINE


@pytest.mark.parametrize("mode,route", sorted(set(MODES.values())))
@pytest.mark.parametrize("name", NAMES)
def test_int8_tracks_the_ports_float_embeddings(jax_models, name, mode, route):
    m = jax_models[name, "tiny"]
    _, cfgs = _cfgs("tiny")
    batch = _torch_batch(_inputs())
    with torch.inference_mode():
        e_f = _port_float(name, m["params"], cfgs)(*batch)
        e_q = _port_quant(name, m["qparams"], cfgs, mode, route)(*batch)
    assert _cosine(e_q.numpy(), e_f.numpy()).min() >= INT8_VS_FLOAT_MIN_COSINE


@pytest.mark.parametrize("name", NAMES)
def test_calibration_matches_jax(jax_models, name):
    """Same keys -- the ViT's pairs, MED's attention triples (and BLIP-FF's
    cross-attention ones) and FFN pairs -- and values to 1e-4 relative."""
    m = jax_models[name, "tiny"]
    cfgs = _cfgs("tiny")[1]
    scales = C.calibrate_act_scales(_port_float(name, m["params"], cfgs), [_inputs(), _inputs(seed=1)])
    assert set(scales) == set(m["scales"])
    vit, med = cfgs
    attn_kinds = ("attention",) if name == "BLIPScoreFusion" else ("attention", "crossattention")
    triples = {("text_encoder", f"layer_{i}", kind) for i in range(med.num_hidden_layers) for kind in attn_kinds}
    assert {k for k, v in scales.items() if v.shape == (3,)} == triples
    assert len(scales) == 2 * vit.layers + med.num_hidden_layers + len(triples)
    for key, value in m["scales"].items():
        assert scales[key].dtype == np.float32
        np.testing.assert_allclose(scales[key], value, rtol=1e-4, err_msg=str(key))


def test_module_paths_of_blip_map_both_ways():
    _, (vit, med) = _cfgs("tiny")
    model = BLIPFeatureFusion(vit, med, med.hidden_size)
    owners = [n for n, m in model.named_modules() if isinstance(m, Q.ActScales)]
    assert len(owners) == 2 * vit.layers + 3 * med.num_hidden_layers
    for name in owners:
        assert C.module_name(C.module_path(name)) == name
    assert C.module_path("text_encoder.encoder.layer.1.crossattention") == ("text_encoder", "layer_1", "crossattention")
    assert C.module_path("visual_encoder.blocks.0.mlp") == ("visual_encoder", "blocks_0", "mlp")


def test_jax_written_blip_artifact_loads_in_the_port(jax_models, tmp_path):
    """The JAX CLI writes MED's triples, which the JAX loader refuses (a
    known difference: `uniir_tpu/ops/calibrate.py` is not edited); the
    port's loader reads them, in both packages' files."""
    from uniir_tpu.ops import calibrate as jax_calibrate

    scales = jax_models["BLIPFeatureFusion", "tiny"]["scales"]
    by_jax, by_port = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jax_calibrate.save_act_scales(by_jax, scales)
    C.save_act_scales(by_port, scales)
    for path in (by_jax, by_port):
        loaded = C.load_act_scales(path)
        assert set(loaded) == set(scales)
        for key in scales:
            np.testing.assert_array_equal(loaded[key], scales[key])
    with pytest.raises(AssertionError, match="expected"):
        jax_calibrate.load_act_scales(by_jax)
    np.savez(str(tmp_path / "bad.npz"), **{"a/b": np.ones(4, np.float32)})
    with pytest.raises(AssertionError, match="expected"):
        C.load_act_scales(str(tmp_path / "bad.npz"))


def _registry_config(tmp_path, name, calib_path=None):
    from tests.helpers import tiny_bert_vocab
    from uniir_tpu_torch.core.config import Config

    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(tiny_bert_vocab()) + "\n")
    model = {"name": name, "vit": "test-tiny", "embed_dim": _embed_dim(name, MED_CONFIGS["test-tiny"]), "bf16": False,
             "tokenizer_max_length": 12, "bert_vocab_path": str(vocab), "int8": True}
    if calib_path:
        model["int8_calibration"] = calib_path
    return Config.from_dict({"uniir_dir": str(tmp_path), "seed": 3, "model": model})


@pytest.mark.parametrize("backend", ["xla", "pallas", "wonly", "static"])
@pytest.mark.parametrize("name", NAMES)
def test_registry_builds_int8_blip_in_every_mode(tmp_path, monkeypatch, name, backend):
    """`model.int8` -> the quantised twin of the seeded float model, in the
    mode the environment names; the artifact's scales (the port's
    calibration of that float model) become act_scales buffers."""
    monkeypatch.setenv("UNIIR_INT8_BACKEND", backend)
    monkeypatch.delenv("UNIIR_INT8_MLP", raising=False)
    med = MED_CONFIGS["test-tiny"]
    seeded = port_registry.seeded_blip_sf if name == "BLIPScoreFusion" else port_registry.seeded_blip_ff
    floats = seeded(TINY_VIT, med, "cpu", seed=3, dtype=torch.float32, embed_dim=_embed_dim(name, med))
    batch = _torch_batch(_inputs())
    scales = C.calibrate_act_scales(floats, [batch])
    path = str(tmp_path / "calib.npz")
    C.save_act_scales(path, scales)
    model = port_registry.build_model_from_config(_registry_config(tmp_path, name, path), device="cpu").model
    mode = {"xla": "dynamic", "pallas": "dynamic"}.get(backend, backend)
    layers = [m for m in model.modules() if isinstance(m, Q.QuantLinear)]
    dense = 4 * TINY_VIT.layers + (6 * med.num_hidden_layers + 2 if name == "BLIPScoreFusion" else 10 * med.num_hidden_layers + 1)
    assert len(layers) == dense and all(m.mode == mode for m in layers)
    assert sum(k.endswith("act_scales") for k in model.state_dict()) == len(scales)
    assert model.visual_encoder.blocks[0].mlp.mlp_route == "fused" and model.visual_encoder.blocks[0].mlp.act == "gelu"
    with torch.inference_mode():
        cos = _cosine(model(*batch).numpy(), floats(*batch).numpy())
    assert cos.min() >= INT8_VS_FLOAT_MIN_COSINE, cos


@pytest.mark.parametrize("name", NAMES)
def test_registry_refuses_to_train_int8_blip(tmp_path, name):
    with pytest.raises(ValueError, match="serving"):
        port_registry.build_model_from_config(_registry_config(tmp_path, name), device="cpu", train=True)


def test_cli_probe_flow_for_blip_sf_on_fixture_tree(pipeline_root, jax_models, tmp_path):
    """The calibration CLI over fixture batches of BLIP-SF (the token dict
    through the port's data path) -> npz with MED's triples -> registry-style
    quantisation -> static serving tracks the float model; its scales equal
    the JAX tool's on the same tree and weights."""
    from tests.helpers import identity_image_transform, make_eval_config, simple_bert_tokenizer
    from uniir_tpu.models.registry import ModelBundle as JaxModelBundle
    from uniir_tpu.ops.calibrate import calibrate_act_scales as jax_calibrate_act_scales
    from uniir_tpu.tools.calibrate_int8 import first_probe_loader as jax_first_probe_loader
    from uniir_tpu.train.steps import _model_inputs
    from uniir_tpu_torch.core.config import Config, save_config
    from uniir_tpu_torch.tools import calibrate_int8 as cli

    name = "BLIPScoreFusion"
    jcfgs, cfgs = _cfgs("tiny")
    params = jax_models[name, "tiny"]["params"]
    tok, img_fn = simple_bert_tokenizer(max_len=16, vocab_size=97), identity_image_transform(TINY_VIT.image_size)
    size = (TINY_VIT.image_size, TINY_VIT.image_size)
    port_bundle = port_registry.ModelBundle(name, _port_float(name, params, cfgs), tok, img_fn, img_fn, size, 16)
    jax_bundle = JaxModelBundle(name, _jax_model(name, jcfgs), params, tok, img_fn, img_fn, size, 16)
    config = make_eval_config(pipeline_root)
    config.data_config.enable_query_instruct = False  # the prompt is drawn at random: both runs embed the same text
    out = str(tmp_path / "calib_blip.npz")
    scales = cli.calibrate(port_bundle, config, out, num_batches=2, batch_size=4, margin=1.0)
    assert set(C.load_act_scales(out)) == set(scales) and any(v.shape == (3,) for v in scales.values())

    jax_batches = [_model_inputs(b) for b in list(jax_first_probe_loader(jax_bundle, config, batch_size=4))[:2]]
    ref = jax_calibrate_act_scales(jax_bundle.model, params, jax_batches, act="gelu")
    assert set(ref) == set(scales)
    for key in ref:
        np.testing.assert_allclose(scales[key], ref[key], rtol=1e-4, err_msg=str(key))

    served = port_registry.quantize_blip(port_bundle.model, "static", "fused", C.load_act_scales(out))
    txt, *rest = jax_batches[0]
    batch = ({k: torch.from_numpy(np.asarray(v)) for k, v in txt.items()}, *(torch.from_numpy(np.asarray(a)) for a in rest))
    with torch.inference_mode():
        cos = _cosine(served(*batch).numpy(), port_bundle.model(*batch).numpy())
    assert cos.min() > 0.98, cos

    # the command line itself, with a prebuilt bundle as the trainer's tests pass one
    cfg_path = str(tmp_path / "embed.yaml")
    as_dict = config.to_dict()
    as_dict["model"] = {"name": name, "vit": "test-tiny", "int8": True}
    save_config(Config.from_dict(as_dict), cfg_path)
    out2 = str(tmp_path / "calib_cli.npz")
    cli.main(["--config_path", cfg_path, "--uniir_dir", pipeline_root, "--mbeir_data_dir",
              os.path.join(pipeline_root, "mbeir_data"), "--out", out2, "--num_batches", "2", "--batch_size", "4",
              "--margin", "1.0", "--device", "cpu"], bundle=port_bundle)
    again = C.load_act_scales(out2)
    for key in scales:
        np.testing.assert_array_equal(again[key], scales[key])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["dynamic", "static"])
@pytest.mark.parametrize("name", NAMES)
def test_blip_large_int8_on_card_runs_the_kernels(cuda, name, mode):
    """Seeded BLIP `large` at full width (batch 2), quantised: K5 / K6 (exact
    GELU) as often as the depth implies, close to the bf16 model, and equal
    in direction to the same int8 model through the kernels' twins."""
    from uniir_tpu_torch.ops import mlp as M_

    vit, med = BLIP_VIT_CONFIGS["large"], dataclasses.replace(MED_CONFIGS["large"], encoder_width=1024)
    seeded = port_registry.seeded_blip_sf if name == "BLIPScoreFusion" else port_registry.seeded_blip_ff
    floats = seeded(vit, med, cuda, seed=0, dtype=torch.float32)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(1000, med.vocab_size, (2, 50))).to(cuda)
    attn = torch.ones(2, 50, dtype=torch.int32, device=cuda)
    attn[1, 20:] = 0
    batch = ({"input_ids": ids, "attention_mask": attn}, torch.rand(2, 224, 224, 3, device=cuda),
             torch.ones(2, dtype=torch.int32, device=cuda), torch.ones(2, dtype=torch.int32, device=cuda))
    scales = C.calibrate_act_scales(floats, [batch], margin=1.1) if mode == "static" else None
    model = port_registry.quantize_blip(floats, mode, "fused", scales).to_compute_dtype(torch.bfloat16)
    floats = floats.to_compute_dtype(torch.bfloat16).eval()
    k5, k6 = Q.int8_matmul.launches, M_.int8_mlp.launches
    with torch.inference_mode():
        out, ref = model(*batch), floats(*batch)
    per_block = 4 if mode == "static" else 6
    if name == "BLIPScoreFusion":  # 23 full ViT blocks and the trimmed one; MED text mode; two heads
        want5 = 23 * per_block + 3 + (per_block - 4) + 12 * 6 + 2
    else:  # 24 full ViT blocks; MED self- and cross-attention, FFN; the pooler
        want5 = 24 * per_block + 12 * 10 + 1
    assert (Q.int8_matmul.launches - k5, M_.int8_mlp.launches - k6) == (want5, 24 if mode == "static" else 0)
    assert torch.isfinite(out).all()
    assert torch.nn.functional.cosine_similarity(out, ref, dim=1).min() >= 0.95
    kernels = (Q.int8_matmul, M_.int8_mlp)
    Q.int8_matmul, M_.int8_mlp = Q.int8_matmul_twin, M_.int8_mlp_plain
    try:
        with torch.inference_mode():
            plain = model(*batch)
    finally:
        Q.int8_matmul, M_.int8_mlp = kernels
    assert torch.nn.functional.cosine_similarity(out, plain, dim=1).min() >= 0.999
