"""int8 CLIP-FF serving as a whole: the port against the JAX package's
`CLIPFeatureFusion(quant=True)` on the same quantised weights (made by the
JAX `quantize_tree`, carried over by `state_dict_from_jax`), in every
activation mode -- the towers' blocks and the T5 fusion stack's bias-free
q / k / v / o / wi / wo; calibration with its T5 entries, the artifact, the
registry.

Tolerances, as tests/test_torch_int8_clip.py's: fp32 within FP32_ATOL
absolute (WONLY_FP32_ATOL in `wonly`, see there) and cosine >=
FP32_MIN_COSINE per row (the JAX side with
UNIIR_INT8_FLAT=0, its 3-D tower; once with its padded-flat default, whose
math is the same, at the bf16 bound); bf16 cosine >= BF16_MIN_COSINE; int8
against the port's own float model cosine >= 0.98, the JAX package's bound
in tests/test_quant_variants.py.
"""

import numpy as np
import pytest
import torch

from uniir_tpu_torch.models import registry as port_registry
from uniir_tpu_torch.models.clip import CLIP_CONFIGS, CLIPConfig
from uniir_tpu_torch.models.clip_ff import CLIPFeatureFusion
from uniir_tpu_torch.models.convert import state_dict_from_jax
from uniir_tpu_torch.ops import calibrate as C
from uniir_tpu_torch.ops import quant as Q

FP32_MIN_COSINE = 0.9999
FP32_ATOL = 1e-3
BF16_MIN_COSINE = 0.999
INT8_VS_FLOAT_MIN_COSINE = 0.98
# `wonly` rounds every Dense input to bf16, so a last-bit fp32 difference upstream can move an
# input by one bf16 step: measured, a one-ulp change of the port's own image input moves its
# test-tiny-ff vision tokens by 2.9e-3 (the float towers agree with JAX to 2.3e-6)
WONLY_FP32_ATOL = 1e-2

TINY = "test-tiny-ff"
# wide enough (W % 128 == 0) for the JAX package's fused int8 MLP kernel in the towers
WIDE = dict(image_size=32, patch_size=8, vision_width=128, vision_layers=2, vision_heads=2, vocab_size=128,
            context_length=16, text_width=128, text_layers=2, text_heads=2, embed_dim=128)
# JAX env value -> the port's (mode, MLP route)
MODES = {"xla": ("dynamic", "fused"), "wonly": ("wonly", "fused"), "static": ("static", "xla"),
         "static-fused": ("static", "fused")}


def _cfgs(name):
    from uniir_tpu.models.clip import CLIP_CONFIGS as JAX_CONFIGS
    from uniir_tpu.models.clip import CLIPConfig as JaxCLIPConfig

    if name == TINY:
        return JAX_CONFIGS[TINY], CLIP_CONFIGS[TINY]
    return JaxCLIPConfig(**WIDE), CLIPConfig(**WIDE)


def _inputs(cfg, n=4, seed=0):
    rng = np.random.default_rng(seed)
    txt = rng.integers(1, cfg.vocab_size - 1, (n, cfg.context_length)).astype(np.int32)
    img = rng.normal(size=(n, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    mask = np.ones((n,), np.int32)
    return txt, img, mask, mask


def _cosine(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


@pytest.fixture(scope="module")
def jax_models():
    """Per config: float JAX params, the JAX calibration of the fp32 model and the quantised tree."""
    import jax

    from uniir_tpu.models.clip_ff import CLIPFeatureFusion as JaxCLIPFF
    from uniir_tpu.ops.calibrate import calibrate_act_scales
    from uniir_tpu.ops.quant import quantize_tree

    out = {}
    for name in (TINY, "wide"):
        jcfg, cfg = _cfgs(name)
        batch = _inputs(cfg)
        model = JaxCLIPFF(jcfg)
        params = jax.tree_util.tree_map(np.asarray, model.init(jax.random.PRNGKey(1), *batch)["params"])
        scales = calibrate_act_scales(model, params, [batch, _inputs(cfg, seed=1)], act="quick_gelu")
        out[name] = {"params": params, "scales": scales, "qparams": quantize_tree(params, act_scales=scales)}
    return out


def _port_float(params, cfg, dtype=torch.float32):
    model = CLIPFeatureFusion(cfg)
    model.load_state_dict(state_dict_from_jax(params))
    return model.to_compute_dtype(dtype).eval()


def _port_quant(qparams, cfg, mode, route, dtype=torch.float32):
    model = CLIPFeatureFusion(cfg, quant=True, int8_mode=mode, mlp_route=route)
    Q.load_quantized_state_dict(model, state_dict_from_jax(qparams))
    return model.to_compute_dtype(dtype).eval()


def _jax_quant_embed(monkeypatch, jcfg, qparams, backend, batch, dtype, flat="0"):
    import jax.numpy as jnp

    from uniir_tpu.models.clip_ff import CLIPFeatureFusion as JaxCLIPFF

    monkeypatch.setenv("UNIIR_INT8_BACKEND", backend.split("-")[0])
    monkeypatch.setenv("UNIIR_INT8_MLP", "fused" if backend.endswith("fused") else "xla")
    if flat is None:
        monkeypatch.delenv("UNIIR_INT8_FLAT", raising=False)
    else:
        monkeypatch.setenv("UNIIR_INT8_FLAT", flat)
    model = JaxCLIPFF(jcfg, dtype=getattr(jnp, dtype), quant=True)
    return np.asarray(model.apply({"params": qparams}, *batch), np.float32)


def test_quantised_tree_converts_onto_the_int8_modules(jax_models):
    """`state_dict_from_jax` of a quantised CLIP-FF tree is the state dict of
    the port's int8 twin, T5's bias-free layers and both kinds of T5 entry
    included, and the port's own quantisation of the float model gives the
    same integers, scales and act_scales."""
    m = jax_models[TINY]
    cfg = CLIP_CONFIGS[TINY]
    sd = state_dict_from_jax(m["qparams"])
    twin = CLIPFeatureFusion(cfg, quant=True)
    Q.load_quantized_state_dict(twin, sd)
    assert set(twin.state_dict()) == set(sd)
    t5 = "t5_layers.block.1.layer"
    assert sd[f"{t5}.0.SelfAttention.q.weight_q"].dtype == torch.int8 and f"{t5}.0.SelfAttention.q.bias" not in sd
    assert sd[f"{t5}.0.SelfAttention.act_scales"].shape == (2,) and sd[f"{t5}.1.DenseReluDense.act_scales"].shape == (2,)
    assert sd["clip_model.visual.transformer.resblocks.0.attn.qkv_proj.weight_q"].shape == (96, 32)
    floats = _port_float(m["params"], cfg)
    own = Q.quantize_state_dict(floats, C.act_scales_by_module(m["scales"], floats))
    assert set(own) == set(sd)
    for key in sd:
        assert torch.equal(own[key], sd[key]), key


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend", ["xla", "wonly", "static", "static-fused"])
def test_int8_clip_ff_matches_jax(jax_models, monkeypatch, backend, dtype):
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
        np.testing.assert_allclose(out.numpy(), ref, atol=WONLY_FP32_ATOL if backend == "wonly" else FP32_ATOL, rtol=0)


def test_int8_clip_ff_matches_jax_flat_tower(jax_models, monkeypatch):
    """The JAX towers' padded-flat default (not carried over) computes the same function."""
    jcfg, cfg = _cfgs(TINY)
    batch = _inputs(cfg)
    ref = _jax_quant_embed(monkeypatch, jcfg, jax_models[TINY]["qparams"], "static", batch, "float32", flat=None)
    model = _port_quant(jax_models[TINY]["qparams"], cfg, "static", "xla")
    with torch.inference_mode():
        out = model(*(torch.from_numpy(a) for a in batch))
    assert _cosine(out.numpy(), ref).min() >= BF16_MIN_COSINE


@pytest.mark.parametrize("mode,route", sorted(set(MODES.values())))
def test_int8_tracks_the_ports_float_embeddings(jax_models, mode, route):
    m = jax_models[TINY]
    cfg = CLIP_CONFIGS[TINY]
    batch = tuple(torch.from_numpy(a) for a in _inputs(cfg))
    with torch.inference_mode():
        e_f = _port_float(m["params"], cfg)(*batch)
        e_q = _port_quant(m["qparams"], cfg, mode, route)(*batch)
    assert _cosine(e_q.numpy(), e_f.numpy()).min() >= INT8_VS_FLOAT_MIN_COSINE


def test_calibration_matches_jax(jax_models):
    """Same keys -- the towers' pairs and T5's attention and FFN pairs -- and
    values to 1e-4 relative."""
    m = jax_models[TINY]
    cfg = CLIP_CONFIGS[TINY]
    scales = C.calibrate_act_scales(_port_float(m["params"], cfg), [_inputs(cfg), _inputs(cfg, seed=1)])
    assert set(scales) == set(m["scales"])
    t5 = {k for k in scales if k[0] == "t5_layers"}
    assert t5 == {("t5_layers", f"block_{i}", *tail) for i in range(2) for tail in ((), ("attn",))}
    assert len(scales) == 2 * (cfg.vision_layers + cfg.text_layers) + len(t5)
    for key, value in m["scales"].items():
        assert scales[key].dtype == np.float32 and scales[key].shape == (2,)
        np.testing.assert_allclose(scales[key], value, rtol=1e-4, err_msg=str(key))


def test_module_paths_of_clip_ff_map_both_ways():
    model = CLIPFeatureFusion(CLIP_CONFIGS[TINY])
    owners = [n for n, m in model.named_modules() if isinstance(m, Q.ActScales)]
    assert len(owners) == 2 * 4 + 2 * 2
    by_path = {C.module_path(name): np.ones(2, np.float32) for name in owners}
    assert set(C.act_scales_by_module(by_path, model)) == set(owners)
    assert C.module_path("clip_model.transformer.resblocks.1.mlp") == ("text", "transformer", "resblocks_1", "mlp")
    assert C.module_path("t5_layers.block.1.layer.1.DenseReluDense") == ("t5_layers", "block_1")


def test_artifact_written_by_either_package_loads_in_the_other(jax_models, tmp_path):
    from uniir_tpu.ops import calibrate as jax_calibrate

    scales = jax_models[TINY]["scales"]
    by_port, by_jax = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    C.save_act_scales(by_port, scales)
    jax_calibrate.save_act_scales(by_jax, scales)
    for loaded in (jax_calibrate.load_act_scales(by_port), C.load_act_scales(by_jax)):
        assert set(loaded) == set(scales)
        for key in scales:
            np.testing.assert_array_equal(loaded[key], scales[key])


def _registry_config(tmp_path, calib_path=None):
    from tests.helpers import tiny_clip_merges
    from uniir_tpu_torch.core.config import Config

    merges = str(tmp_path / "merges.txt")
    with open(merges, "w") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in tiny_clip_merges()))
    model = {"name": "CLIPFeatureFusion", "clip_vision_model_name": TINY, "int8": True, "bf16": False,
             "clip_bpe_path": merges}
    if calib_path:
        model["int8_calibration"] = calib_path
    return Config.from_dict({"uniir_dir": "/nonexistent", "seed": 3, "model": model})


@pytest.mark.parametrize("backend", ["xla", "pallas", "wonly", "static"])
def test_registry_builds_int8_clip_ff_in_every_mode(jax_models, tmp_path, monkeypatch, backend):
    """`model.int8` -> the quantised twin of the seeded float CLIP-FF, in the
    mode the environment names; the artifact's scales (towers and T5) become
    act_scales buffers."""
    monkeypatch.setenv("UNIIR_INT8_BACKEND", backend)
    monkeypatch.delenv("UNIIR_INT8_MLP", raising=False)
    path = str(tmp_path / "calib.npz")
    C.save_act_scales(path, jax_models[TINY]["scales"])
    model = port_registry.build_model_from_config(_registry_config(tmp_path, path), device="cpu").model
    mode = {"xla": "dynamic", "pallas": "dynamic"}.get(backend, backend)
    layers = [m for m in model.modules() if isinstance(m, Q.QuantLinear)]
    assert len(layers) == 4 * (2 + 2) + 6 * 2 and all(m.mode == mode for m in layers)
    assert sum(k.endswith("act_scales") for k in model.state_dict()) == len(jax_models[TINY]["scales"]) == 12
    floats = port_registry.seeded_clip_ff(CLIP_CONFIGS[TINY], "cpu", seed=3, dtype=torch.float32)
    batch = tuple(torch.from_numpy(a) for a in _inputs(CLIP_CONFIGS[TINY]))
    with torch.inference_mode():
        cos = _cosine(model(*batch).numpy(), floats(*batch).numpy())
    assert cos.min() >= 0.98, cos  # foreign calibration (other weights): a sanity bound only


def test_registry_refuses_to_train_int8_clip_ff(tmp_path):
    with pytest.raises(ValueError, match="serving"):
        port_registry.build_model_from_config(_registry_config(tmp_path), device="cpu", train=True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_clip_ff_l14_int8_on_card_runs_the_kernels(cuda, mode):
    """Seeded CLIP-FF ViT-L/14 at full width (batch 2), quantised: K5 / K6 as
    often as the depth implies (36 tower blocks, none trimmed, and 2 T5
    blocks of six K5), close to the bf16 model, and equal in direction to
    the same int8 model through the kernels' twins."""
    from uniir_tpu_torch.ops import mlp as M_

    cfg = CLIP_CONFIGS["ViT-L/14"]
    floats = port_registry.seeded_clip_ff(cfg, cuda, seed=0, dtype=torch.float32)
    rng = np.random.default_rng(0)
    txt = torch.from_numpy(rng.integers(1, cfg.vocab_size - 1, (2, cfg.context_length))).to(cuda)
    img = torch.rand(2, cfg.image_size, cfg.image_size, 3, device=cuda)
    ones = torch.ones(2, dtype=torch.int32, device=cuda)
    scales = C.calibrate_act_scales(floats, [(txt, img, ones, ones)], margin=1.1) if mode == "static" else None
    model = port_registry.quantize_clip_ff(floats, mode, "fused", scales).to_compute_dtype(torch.bfloat16)
    floats = floats.to_compute_dtype(torch.bfloat16).eval()
    k5, k6 = Q.int8_matmul.launches, M_.int8_mlp.launches
    with torch.inference_mode():
        out, ref = model(txt, img, ones, ones), floats(txt, img, ones, ones)
    blocks = cfg.vision_layers + cfg.text_layers
    want = (blocks * 4 + 12, blocks) if mode == "static" else (blocks * 6 + 12, 0)
    assert (Q.int8_matmul.launches - k5, M_.int8_mlp.launches - k6) == want
    assert out.shape == (2, cfg.embed_dim) and torch.isfinite(out).all()
    assert torch.nn.functional.cosine_similarity(out, ref, dim=1).min() >= 0.95
    kernels = (Q.int8_matmul, M_.int8_mlp)
    Q.int8_matmul, M_.int8_mlp = Q.int8_matmul_twin, M_.int8_mlp_plain
    try:
        with torch.inference_mode():
            plain = model(txt, img, ones, ones)
    finally:
        Q.int8_matmul, M_.int8_mlp = kernels
    assert torch.nn.functional.cosine_similarity(out, plain, dim=1).min() >= 0.999
