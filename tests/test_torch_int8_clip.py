"""int8 CLIP-SF serving as a whole: the port against the JAX package's
`CLIPScoreFusion(quant=True)` on the same quantised weights (made by the JAX
`quantize_tree`, carried over by `state_dict_from_jax`), in every activation
mode; calibration, its artifact, the registry and the calibration CLI.

Tolerances.  fp32 compute: both packages take the same integer products, so
embeddings (|e| ~ 1-4 per row) agree to FP32_ATOL absolute (measured: 1e-6)
unless an fp32 epilogue in another order ((acc*a)*w against acc*(a*w)) or a
LayerNorm sum moves a value across a quantisation boundary of a later layer,
which is one int8 step of one activation; cosine >= FP32_MIN_COSINE per row
as well.  bf16 compute: roundings fall at other places in the two
frameworks: cosine >= BF16_MIN_COSINE, as for the float model.
"""

import os

import numpy as np
import pytest
import torch

from uniir_tpu_torch.models import registry as port_registry
from uniir_tpu_torch.models.clip import CLIP_CONFIGS, CLIPConfig
from uniir_tpu_torch.models.clip_sf import CLIPScoreFusion
from uniir_tpu_torch.models.convert import state_dict_from_jax
from uniir_tpu_torch.ops import calibrate as C
from uniir_tpu_torch.ops import quant as Q

FP32_MIN_COSINE = 0.9999
FP32_ATOL = 1e-3
BF16_MIN_COSINE = 0.999
INT8_VS_FLOAT_MIN_COSINE = 0.99  # tests/test_quant.py's bound for the JAX package

TINY = "test-tiny"
# wide enough (W % 128 == 0) for the JAX package's fused int8 MLP kernel
WIDE = dict(image_size=32, patch_size=8, vision_width=128, vision_layers=2, vision_heads=2, vocab_size=128,
            context_length=16, text_width=128, text_layers=2, text_heads=2, embed_dim=16)
# JAX env value -> the port's (mode, MLP route)
MODES = {"xla": ("dynamic", "fused"), "wonly": ("wonly", "fused"), "static": ("static", "xla"),
         "static-fused": ("static", "fused")}


def _cfgs(name):
    from uniir_tpu.models.clip import CLIP_CONFIGS as JAX_CONFIGS
    from uniir_tpu.models.clip import CLIPConfig as JaxCLIPConfig

    if name == TINY:
        return JAX_CONFIGS[TINY], CLIP_CONFIGS[TINY]
    return JaxCLIPConfig(**WIDE), CLIPConfig(**WIDE)


def _inputs(cfg, n=6, seed=0):
    rng = np.random.default_rng(seed)
    txt = np.zeros((n, cfg.context_length), np.int32)
    for i in range(n):
        length = 3 + (5 * i) % (cfg.context_length - 4)  # EOT (the pooled row) at many positions
        txt[i, :length] = rng.integers(1, cfg.vocab_size - 1, length)
        txt[i, length] = cfg.vocab_size - 1
    img = rng.normal(size=(n, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    txt_mask = np.array([1, 1, 0, 1, 1, 1][:n], np.int32)
    img_mask = np.array([1, 0, 1, 1, 1, 1][:n], np.int32)
    return txt, img, txt_mask, img_mask


def _cosine(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


@pytest.fixture(scope="module")
def jax_models():
    """Per config: float JAX params, the JAX calibration of the fp32 model and the quantised tree."""
    import jax

    from uniir_tpu.models.clip_sf import CLIPScoreFusion as JaxCLIPSF
    from uniir_tpu.ops.calibrate import calibrate_act_scales
    from uniir_tpu.ops.quant import quantize_tree

    out = {}
    for name in (TINY, "wide"):
        jcfg, cfg = _cfgs(name)
        batch = _inputs(cfg)
        model = JaxCLIPSF(jcfg)
        params = jax.tree_util.tree_map(np.asarray, model.init(jax.random.PRNGKey(0), *batch)["params"])
        scales = calibrate_act_scales(model, params, [batch, _inputs(cfg, seed=1)], act="quick_gelu")
        out[name] = {"params": params, "scales": scales, "qparams": quantize_tree(params, act_scales=scales)}
    return out


def _port_float(params, cfg, dtype=torch.float32):
    model = CLIPScoreFusion(cfg)
    model.load_state_dict(state_dict_from_jax(params))
    return model.to_compute_dtype(dtype).eval()


def _port_quant(qparams, cfg, mode, route, dtype=torch.float32):
    model = CLIPScoreFusion(cfg, quant=True, int8_mode=mode, mlp_route=route)
    Q.load_quantized_state_dict(model, state_dict_from_jax(qparams))
    return model.to_compute_dtype(dtype).eval()


def _jax_quant_embed(monkeypatch, jcfg, qparams, backend, batch, dtype):
    import jax.numpy as jnp

    from uniir_tpu.models.clip_sf import CLIPScoreFusion as JaxCLIPSF

    monkeypatch.setenv("UNIIR_INT8_BACKEND", backend.split("-")[0])
    monkeypatch.setenv("UNIIR_INT8_MLP", "fused" if backend.endswith("fused") else "xla")
    model = JaxCLIPSF(jcfg, dtype=getattr(jnp, dtype), quant=True)
    return np.asarray(model.apply({"params": qparams}, *batch), np.float32)


def test_quantised_tree_converts_onto_the_int8_modules(jax_models):
    """`state_dict_from_jax` of a quantised tree is the state dict of the
    port's int8 twin, and the port's own quantisation of the float weights
    gives the same integers, scales and act_scales."""
    m = jax_models[TINY]
    cfg = CLIP_CONFIGS[TINY]
    sd = state_dict_from_jax(m["qparams"])
    twin = CLIPScoreFusion(cfg, quant=True)
    Q.load_quantized_state_dict(twin, sd)
    assert set(twin.state_dict()) == set(sd)
    p = "transformer.resblocks.1"
    assert sd[f"{p}.attn.qkv_proj.weight_q"].dtype == torch.int8 and sd[f"{p}.attn.qkv_proj.weight_q"].shape == (96, 32)
    own = Q.quantize_state_dict(_port_float(m["params"], cfg), C.act_scales_by_module(m["scales"]))
    assert set(own) == set(sd)
    for key in sd:
        assert torch.equal(own[key], sd[key]), key


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend", ["xla", "wonly", "static", "static-fused"])
def test_int8_clip_sf_matches_jax(jax_models, monkeypatch, backend, dtype):
    # the JAX fused MLP kernel needs W % 128 == 0; below that its static mode
    # takes two static products, which is the port's "xla" route
    name = "wide" if backend == "static-fused" else TINY
    jcfg, cfg = _cfgs(name)
    batch = _inputs(cfg)
    ref = _jax_quant_embed(monkeypatch, jcfg, jax_models[name]["qparams"], backend, batch, dtype)
    mode, route = MODES[backend]
    model = _port_quant(jax_models[name]["qparams"], cfg, mode, route, getattr(torch, dtype))
    with torch.inference_mode():
        out = model(*(torch.from_numpy(a) for a in batch))
    assert out.dtype == torch.float32 and out.shape == ref.shape and torch.isfinite(out).all()
    cos = _cosine(out.numpy(), ref)
    print(f"{backend} {dtype}: min cosine {cos.min():.7f}, max abs diff {np.abs(out.numpy() - ref).max():.3e}")
    assert cos.min() >= (BF16_MIN_COSINE if dtype == "bfloat16" else FP32_MIN_COSINE), cos
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), ref, atol=FP32_ATOL, rtol=0)


@pytest.mark.parametrize("mode,route", sorted(set(MODES.values())))
def test_int8_tracks_the_ports_float_embeddings(jax_models, mode, route):
    m = jax_models[TINY]
    cfg = CLIP_CONFIGS[TINY]
    batch = tuple(torch.from_numpy(a) for a in _inputs(cfg))
    with torch.inference_mode():
        e_f = _port_float(m["params"], cfg)(*batch)
        e_q = _port_quant(m["qparams"], cfg, mode, route)(*batch)
    assert _cosine(e_q.numpy(), e_f.numpy()).min() >= INT8_VS_FLOAT_MIN_COSINE


def test_static_mode_without_scales_is_dynamic(jax_models):
    """A block with no calibrated scales quantises dynamically under `static`."""
    from uniir_tpu.ops.quant import quantize_tree

    m = jax_models[TINY]
    cfg = CLIP_CONFIGS[TINY]
    uncalibrated = quantize_tree(m["params"])
    batch = tuple(torch.from_numpy(a) for a in _inputs(cfg))
    with torch.inference_mode():
        a = _port_quant(uncalibrated, cfg, "static", "fused")(*batch)
        b = _port_quant(uncalibrated, cfg, "dynamic", "fused")(*batch)
    assert torch.equal(a, b)


def test_int8_is_inference_only():
    cfg = CLIP_CONFIGS[TINY]
    with pytest.raises(ValueError, match="inference only"):
        CLIPScoreFusion(cfg, quant=True, remat=True)
    model = CLIPScoreFusion(cfg, quant=True)
    batch = _inputs(cfg, n=2)
    model.positional_embedding.requires_grad_(True)
    with pytest.raises(RuntimeError, match="inference only"):
        model(*(torch.from_numpy(a) for a in batch))


def test_calibration_matches_jax(jax_models):
    """Same keys; values to 1e-4 relative (fp32 towers differ in summation order)."""
    m = jax_models[TINY]
    cfg = CLIP_CONFIGS[TINY]
    scales = C.calibrate_act_scales(_port_float(m["params"], cfg), [_inputs(cfg), _inputs(cfg, seed=1)])
    assert set(scales) == set(m["scales"])
    assert ("text", "transformer", "resblocks_0", "attn") in scales and ("visual", "transformer", "resblocks_1", "mlp") in scales
    for key, value in m["scales"].items():
        assert scales[key].dtype == np.float32 and scales[key].shape == (2,)
        np.testing.assert_allclose(scales[key], value, rtol=1e-4, err_msg=str(key))
    wider = C.calibrate_act_scales(_port_float(m["params"], cfg), [_inputs(cfg)], margin=1.5)
    one = C.calibrate_act_scales(_port_float(m["params"], cfg), [_inputs(cfg)])
    np.testing.assert_allclose(wider[key], 1.5 * one[key], rtol=1e-6)


def test_module_names_map_both_ways():
    for path, name in [(("visual", "transformer", "resblocks_3", "mlp"), "visual.transformer.resblocks.3.mlp"),
                       (("text", "transformer", "resblocks_11", "attn"), "transformer.resblocks.11.attn")]:
        assert C.module_name(path) == name and C.module_path(name) == path


def test_artifact_written_by_either_package_loads_in_the_other(jax_models, tmp_path):
    from uniir_tpu.ops import calibrate as jax_calibrate

    scales = jax_models[TINY]["scales"]
    by_port, by_jax = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    C.save_act_scales(by_port, scales)
    jax_calibrate.save_act_scales(by_jax, scales)
    for loaded in (jax_calibrate.load_act_scales(by_port), C.load_act_scales(by_jax), C.load_act_scales(by_port)):
        assert set(loaded) == set(scales)
        for key in scales:
            np.testing.assert_array_equal(loaded[key], scales[key])
    with pytest.raises(AssertionError, match="empty"):
        C.save_act_scales(str(tmp_path / "x.npz"), {})


def _registry_config(tmp_path, calib_path=None, bf16=False):
    from tests.helpers import tiny_clip_merges
    from uniir_tpu_torch.core.config import Config

    merges = str(tmp_path / "merges.txt")
    with open(merges, "w") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in tiny_clip_merges()))
    model = {"name": "CLIPScoreFusion", "clip_vision_model_name": TINY, "int8": True, "bf16": bf16,
             "clip_bpe_path": merges}
    if calib_path:
        model["int8_calibration"] = calib_path
    return Config.from_dict({"uniir_dir": "/nonexistent", "seed": 3, "model": model})


def test_registry_static_requires_calibration(tmp_path, monkeypatch):
    monkeypatch.setenv("UNIIR_INT8_BACKEND", "static")
    with pytest.raises(ValueError, match="calibrate_int8"):
        port_registry.build_model_from_config(_registry_config(tmp_path), device="cpu")


@pytest.mark.parametrize("backend", ["xla", "pallas", "wonly", "static"])
def test_registry_builds_int8_model_in_every_mode(jax_models, tmp_path, monkeypatch, backend):
    """`model.int8` -> the quantised twin of the seeded float model, in the
    mode the environment names; the artifact's scales become act_scales buffers."""
    monkeypatch.setenv("UNIIR_INT8_BACKEND", backend)
    monkeypatch.delenv("UNIIR_INT8_MLP", raising=False)
    path = str(tmp_path / "calib.npz")
    C.save_act_scales(path, jax_models[TINY]["scales"])
    bundle = port_registry.build_model_from_config(_registry_config(tmp_path, path), device="cpu")
    model = bundle.model
    mode = {"xla": "dynamic", "pallas": "dynamic"}.get(backend, backend)
    layers = [m for m in model.modules() if isinstance(m, Q.QuantLinear)]
    assert len(layers) == 4 * (2 + 2) and all(m.mode == mode for m in layers)
    assert sum(k.endswith("act_scales") for k in model.state_dict()) == len(jax_models[TINY]["scales"]) == 8
    assert model.visual.transformer.resblocks[0].mlp.mlp_route == "fused"
    floats = port_registry.seeded_clip_sf(CLIP_CONFIGS[TINY], "cpu", seed=3, dtype=torch.float32)
    batch = tuple(torch.from_numpy(a) for a in _inputs(CLIP_CONFIGS[TINY]))
    with torch.inference_mode():
        cos = _cosine(model(*batch).numpy(), floats(*batch).numpy())
    assert cos.min() >= 0.98, cos  # foreign calibration (other weights): a sanity bound only
    assert bundle.tokenizer(["red dress"]).shape == (1, CLIP_CONFIGS[TINY].context_length)


def test_registry_refuses_to_train_int8(tmp_path):
    with pytest.raises(ValueError, match="serving"):
        port_registry.build_model_from_config(_registry_config(tmp_path), device="cpu", train=True)


def test_cli_probe_flow_on_fixture_tree(pipeline_root, bundle, tmp_path):
    """The calibration CLI over real fixture batches (port data path) ->
    npz -> registry-style quantisation -> static serving tracks the float
    model; its scales equal the JAX tool's on the same tree and weights."""
    import jax

    from tests.helpers import make_eval_config
    from uniir_tpu.ops.calibrate import calibrate_act_scales as jax_calibrate_act_scales
    from uniir_tpu.tools.calibrate_int8 import first_probe_loader as jax_first_probe_loader
    from uniir_tpu.train.steps import _model_inputs
    from uniir_tpu_torch.tools import calibrate_int8 as cli

    cfg = CLIP_CONFIGS[TINY]
    params = jax.tree_util.tree_map(np.asarray, bundle.params)
    port_bundle = port_registry.ModelBundle(
        "CLIPScoreFusion", _port_float(params, cfg), bundle.tokenizer, bundle.img_preprocess_fn,
        bundle.img_preprocess_fn_eval, bundle.image_size, bundle.embed_dim)
    config = make_eval_config(pipeline_root)
    config.data_config.enable_query_instruct = False  # the prompt is drawn at random: both runs embed the same text
    out = str(tmp_path / "calib_tiny.npz")
    scales = cli.calibrate(port_bundle, config, out, num_batches=2, batch_size=4, margin=1.0)
    assert os.path.isfile(out) and set(C.load_act_scales(out)) == set(scales)

    jax_batches = []
    for batch in list(jax_first_probe_loader(bundle, config, batch_size=4))[:2]:
        jax_batches.append(_model_inputs(batch))
    ref = jax_calibrate_act_scales(bundle.model, bundle.params, jax_batches, act="quick_gelu")
    assert set(ref) == set(scales)
    for key in ref:
        np.testing.assert_allclose(scales[key], ref[key], rtol=1e-4, err_msg=str(key))

    served = port_registry.quantize_clip_sf(port_bundle.model, "static", "fused", C.load_act_scales(out))
    batch = tuple(torch.from_numpy(np.asarray(a)) for a in jax_batches[0])
    with torch.inference_mode():
        cos = _cosine(served(*batch).numpy(), port_bundle.model(*batch).numpy())
    assert cos.min() > 0.98, cos

    # the command line itself, with a prebuilt bundle as the trainer's tests pass one
    from uniir_tpu_torch.core.config import Config, save_config

    cfg_path = str(tmp_path / "embed.yaml")
    as_dict = config.to_dict()
    as_dict["model"] = {"name": "CLIPScoreFusion", "clip_vision_model_name": TINY, "int8": True}
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
@pytest.mark.parametrize("mode,route", [("dynamic", "fused"), ("static", "fused"), ("static", "xla"), ("wonly", "fused")])
def test_vit_l14_int8_on_card_runs_the_kernels(cuda, mode, route):
    """Seeded ViT-L/14 at full width (batch 2), quantised: finite embeddings
    close to the bf16 model's, through K5 / K6 as often as the depth implies."""
    from uniir_tpu_torch.ops.mlp import int8_mlp
    from uniir_tpu_torch.ops.quant import int8_matmul

    cfg = CLIP_CONFIGS["ViT-L/14"]
    floats = port_registry._seeded(cfg, cuda, 0)
    rng = np.random.default_rng(0)
    txt = torch.from_numpy(rng.integers(1, cfg.vocab_size - 1, (2, cfg.context_length))).to(cuda)
    txt[:, 20] = cfg.vocab_size - 1
    img = torch.rand(2, cfg.image_size, cfg.image_size, 3, device=cuda)
    ones = torch.ones(2, dtype=torch.int32, device=cuda)
    scales = None
    if mode == "static":
        scales = C.calibrate_act_scales(floats, [(txt, img, ones, ones)], margin=1.1)
    model = port_registry.quantize_clip_sf(floats, mode, route, scales).to_compute_dtype(torch.bfloat16)
    floats = floats.to_compute_dtype(torch.bfloat16).eval()
    k5, k6 = int8_matmul.launches, int8_mlp.launches
    with torch.inference_mode():
        out, ref = model(txt, img, ones, ones), floats(txt, img, ones, ones)
    blocks = cfg.vision_layers + cfg.text_layers
    fused = mode == "static" and route == "fused"
    want_k5 = 0 if mode == "wonly" else (blocks - 2) * (4 if fused else 6) + 2 * (3 if fused else 5)
    assert int8_matmul.launches - k5 == want_k5 and int8_mlp.launches - k6 == (blocks if fused else 0)
    assert out.shape == (2, cfg.embed_dim) and torch.isfinite(out).all()
    assert torch.nn.functional.cosine_similarity(out, ref, dim=1).min() >= 0.95
