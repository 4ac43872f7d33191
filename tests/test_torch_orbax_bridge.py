"""The JAX checkpoint bridge (`scripts/orbax_to_torch.py`, with
`models.convert.load_optimizer_state_from_jax` and `core.checkpoint.
write_jax_train_state`): for each retriever at test-tiny, fp32 and dropout
off, the JAX package takes a step and saves with `save_train_checkpoint`,
the script writes the port's `checkpoint.pth`, the port's registry serves it
with JAX's embeddings, and the port resumes it through
`load_train_checkpoint` and takes the next step to JAX's next parameters.
Also: the legacy `state.msgpack`, a `save_params` file through
`--params-only`, CLIP-FF's fusion group at its own learning rate,
accumulation carried after a whole update and refused in the middle of one,
and the key map's check that moments are only moved, never summed."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from uniir_tpu_torch.core.checkpoint import CHECKPOINT_FILE, load_train_checkpoint
from uniir_tpu_torch.core.config import Config, save_config
from uniir_tpu_torch.models import convert
from uniir_tpu_torch.models.registry import build_model_from_config
from uniir_tpu_torch.train.steps import make_blip_train_step, make_clip_train_step, make_embed_step
from uniir_tpu_torch.train.trainer import make_train_state

LR, FUSION_LR, TOTAL_STEPS, ALPHA, QUEUE = 1e-3, 4e-3, 10, 0.4, 16
EMBED_ATOL = 1e-4  # fp32 serving of the same weights
# fp32 train steps, as tests/test_torch_train.py (CLIP) and tests/test_torch_blip_train.py (BLIP) hold them
STEP_RTOL = {"clip": 1e-4, "blip": 1e-5}
STEP_ATOL = 1e-5
SHORT = {"CLIPScoreFusion": "clip_sf", "CLIPFeatureFusion": "clip_ff", "BLIPScoreFusion": "blip_sf",
         "BLIPFeatureFusion": "blip_ff"}


def _config(root: str, name: str, accum: int = 1, fusion_lr=None) -> dict:
    from tests.helpers import tiny_bert_vocab, tiny_clip_merges

    model = {"name": name, "short_name": SHORT[name].upper(), "bf16": False,
             "ckpt_config": {"ckpt_dir": "checkpoint", "ckpt_name": "", "resume_training": False}}
    if name.startswith("CLIP"):
        merges = os.path.join(root, "merges.txt")
        with open(merges, "w") as f:
            f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in tiny_clip_merges()))
        model.update(clip_vision_model_name="test-tiny" if name == "CLIPScoreFusion" else "test-tiny-ff",
                     clip_bpe_path=merges)
    else:
        vocab = os.path.join(root, "vocab.txt")
        with open(vocab, "w") as f:
            f.write("\n".join(tiny_bert_vocab()) + "\n")
        model.update(vit="test-tiny", embed_dim=16 if name == "BLIPScoreFusion" else 32, tokenizer_max_length=12, bert_vocab_path=vocab, queue_size=QUEUE,
                     momentum=0.995, alpha=ALPHA)
    trainer = {"learning_rate": LR, "weight_decay": 0.2 if name.startswith("CLIP") else 0.05,
               "gradient_accumulation_steps": accum, "num_train_epochs": 1, "warmup_steps": 0}
    if fusion_lr is not None:
        trainer["t5_learning_rate"] = fusion_lr
    return {"uniir_dir": root, "seed": 0, "model": model, "trainer_config": trainer}


def _batch(name: str, seed: int) -> dict:
    if name.startswith("CLIP"):
        from tests.test_torch_train import _batch as clip_batch

        return clip_batch(seed=seed)
    from tests.test_torch_blip_train import _batch as blip_batch

    return blip_batch(seed=seed)


_JAX_BUILDS: dict = {}  # (model, accumulation, fusion rate) -> (model, first state, jitted step, jitted embed)


def _jax_build(cfg: dict):
    """The JAX model, its fresh train state and its jitted step and embed
    functions for a config, built once a session for each (model,
    accumulation, fusion rate): the tests that share one reuse its compiled
    programs (a state is an immutable pytree)."""
    import jax
    import jax.numpy as jnp

    from uniir_tpu.core.config import Config as JaxConfig
    from uniir_tpu.models.registry import build_model_from_config as jax_build
    from uniir_tpu.train.optimizer import make_blip_optimizer, make_clip_optimizer
    from uniir_tpu.train.state import MomentumTrainState, TrainState
    from uniir_tpu.train.steps import make_blip_train_step as jax_blip_step
    from uniir_tpu.train.steps import make_clip_train_step as jax_clip_step
    from uniir_tpu.train.steps import make_embed_step as jax_embed_step

    name, trainer = cfg["model"]["name"], cfg["trainer_config"]
    key = (name, trainer["gradient_accumulation_steps"], trainer.get("t5_learning_rate"))
    if key not in _JAX_BUILDS:
        built = {}

        def params():  # the registry's init, jitted: one program rather than one a primitive
            built["bundle"] = jax_build(JaxConfig.from_dict(cfg))
            return built["bundle"].params

        initialised = jax.jit(params)()
        bundle = built["bundle"]
        if name.startswith("BLIP"):
            tx = make_blip_optimizer(initialised, LR, TOTAL_STEPS, weight_decay=trainer["weight_decay"],
                                     accumulation_steps=key[1],
                                     freeze_path_sub="crossattention" if name == "BLIPScoreFusion" else None)
            state = MomentumTrainState.create(initialised, tx, queue_size=QUEUE, embed_dim=bundle.embed_dim,
                                              rng=jax.random.PRNGKey(1))
            step = jax_blip_step(bundle.model, with_dropout=False)
        else:
            tx = make_clip_optimizer(initialised, LR, TOTAL_STEPS, weight_decay=trainer["weight_decay"],
                                     accumulation_steps=key[1], fusion_learning_rate=key[2])
            state = TrainState.create(params=initialised, tx=tx)
            step = jax_clip_step(bundle.model, with_dropout=False)
        # the first state on the host: the steps donate their state's device buffers
        _JAX_BUILDS[key] = (bundle.model, jax.device_get(state), step, jax_embed_step(bundle.model, out_dtype=jnp.float32))
    return _JAX_BUILDS[key]


class JaxRun:
    """The JAX package's train state of a config, its steps, its checkpoint and its embeddings."""

    def __init__(self, cfg: dict):
        from uniir_tpu.core.config import Config as JaxConfig

        self.config = JaxConfig.from_dict(cfg)
        self.name = cfg["model"]["name"]
        self.blip = self.name.startswith("BLIP")
        self.model, self.state, self.step_fn, self.embed_fn = _jax_build(cfg)

    def step(self, batch):
        args = (np.float32(ALPHA),) if self.blip else ()
        self.state, _ = self.step_fn(self.state, batch, *args)

    def save(self, ckpt_dir: str, epoch: int = 0) -> str:
        from uniir_tpu.core.checkpoint import save_train_checkpoint

        return save_train_checkpoint(ckpt_dir, SHORT[self.name], self.state, epoch, self.config)

    def embeddings(self, batch) -> np.ndarray:
        return np.asarray(self.embed_fn(self.state.params, batch))

    def numpy_params(self, tree: str = "params"):
        import jax

        return jax.tree_util.tree_map(np.asarray, getattr(self.state, tree))


def _convert(root: str, cfg: dict, ckpt: str, *extra) -> str:
    import importlib.util

    yaml_path = os.path.join(root, "train.yaml")
    save_config(Config.from_dict(cfg), yaml_path)
    spec = importlib.util.spec_from_file_location(
        "orbax_to_torch", os.path.join(os.path.dirname(__file__), "..", "scripts", "orbax_to_torch.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    return script.main(["--config", yaml_path, "--ckpt", ckpt, "--out", os.path.join(root, "port"), *extra])


def _key_bias(key: str, t: torch.Tensor):
    """A key bias's elements (true gradient 0: both sides hold rounding noise there), or None."""
    if key.endswith(("attn.in_proj_bias", "attn.qkv.bias")):
        w = t.numel() // 3
        return t[w : 2 * w]
    return t if key.endswith("self.key.bias") else None


def _assert_close(got: torch.Tensor, want: torch.Tensor, key: str, family: str, steps: int = 2):
    """The step tests' comparison: STEP_RTOL / STEP_ATOL of the tensor's
    largest element, the key biases within the steps' Adam bound, and 5 % of
    a step's lr on top for elements whose gradient is noise about 0."""
    noise = _key_bias(key, got)
    if noise is not None:
        assert (noise - _key_bias(key, want)).abs().max() <= 2 * 2 * steps * max(LR, FUSION_LR), key
        if key.endswith("self.key.bias"):
            return
        keep = torch.ones(got.numel(), dtype=torch.bool)
        keep[got.numel() // 3 : 2 * got.numel() // 3] = False
        got, want = got[keep], want[keep]
    atol = STEP_ATOL * max(1.0, want.abs().max().item()) + 0.05 * (FUSION_LR if ".t5_layers." in f".{key}" else LR)
    torch.testing.assert_close(got, want, rtol=STEP_RTOL[family], atol=atol, msg=lambda m: f"{key}: {m}")


def _serve_and_resume(root: str, cfg: dict, path: str, jax_run: JaxRun, next_batches: list) -> None:
    """The converted checkpoint served (embeddings against JAX's) and resumed
    (the next update against JAX's)."""
    assert sorted(os.listdir(path)) == [CHECKPOINT_FILE, "meta.json"]
    serve = Config.from_dict(cfg)
    serve.model.ckpt_config.ckpt_dir = os.path.relpath(os.path.dirname(path), root)
    serve.model.ckpt_config.ckpt_name = os.path.basename(path)
    bundle = build_model_from_config(serve, "cpu")
    batch = _batch(jax_run.name, seed=7)
    emb = make_embed_step(bundle.model, torch.float32)(batch).numpy()
    np.testing.assert_allclose(emb, jax_run.embeddings(batch), atol=EMBED_ATOL)

    config = Config.from_dict(cfg)
    train_bundle = build_model_from_config(config, "cpu", train=True)
    state, epoch = load_train_checkpoint(path, make_train_state(config, train_bundle, TOTAL_STEPS))
    assert epoch == 0 and state.step == int(np.asarray(jax_run.state.step))
    blip = jax_run.blip
    step = (make_blip_train_step(state.model, with_dropout=False) if blip
            else make_clip_train_step(state.model, with_dropout=False))
    for b in next_batches:
        state, _ = step(state, b, ALPHA) if blip else step(state, b)
        jax_run.step(b)
    assert state.step == int(np.asarray(jax_run.state.step))
    family = "blip" if blip else "clip"
    for tree, module in (("params", state.model),) + ((("params_m", state.model_m),) if blip else ()):
        want = convert.state_dict_from_jax(jax_run.numpy_params(tree))
        for key, p in module.state_dict(keep_vars=True).items():
            _assert_close(p.detach(), want[key], f"{tree} {key}" if tree != "params" else key, family)
    if blip:
        assert state.queue_ptr == int(np.asarray(jax_run.state.queue_ptr))
        torch.testing.assert_close(state.queue_query, torch.from_numpy(np.array(jax_run.state.queue_query)),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["CLIPScoreFusion", "CLIPFeatureFusion", "BLIPScoreFusion", "BLIPFeatureFusion"])
def test_train_checkpoint_serves_and_resumes_like_jax(tmp_path, name):
    """One JAX step, its orbax checkpoint converted: served with JAX's
    embeddings, resumed to JAX's second step (CLIP-FF with its fusion group
    at its own rate, BLIP-SF through multi_transform's frozen label)."""
    root = str(tmp_path)
    cfg = _config(root, name, fusion_lr=FUSION_LR if name == "CLIPFeatureFusion" else None)
    run = JaxRun(cfg)
    run.step(_batch(name, seed=0))
    path = _convert(root, cfg, run.save(os.path.join(root, "jax")))
    assert os.path.basename(path) == f"{SHORT[name]}_epoch_0"
    with open(os.path.join(path, "meta.json")) as f:
        assert json.load(f)["step"] == 1
    _serve_and_resume(root, cfg, path, run, [_batch(name, seed=1)])


def test_clip_ff_fusion_group_keeps_its_own_rate(tmp_path):
    """The converted optimizer holds CLIP-FF's four groups, the fusion pair
    on its own rate's schedule, one update in, and each parameter's moments
    are those of the JAX label that trains it, element for element."""
    import jax

    from uniir_tpu_torch.train.optimizer import cosine_schedule

    root = str(tmp_path)
    cfg = _config(root, "CLIPFeatureFusion", fusion_lr=FUSION_LR)
    run = JaxRun(cfg)
    run.step(_batch("CLIPFeatureFusion", seed=0))
    path = _convert(root, cfg, run.save(os.path.join(root, "jax")))
    config = Config.from_dict(cfg)
    state, _ = load_train_checkpoint(path, make_train_state(config, build_model_from_config(config, "cpu", train=True),
                                                            TOTAL_STEPS))
    rates = [g["lr"] for g in state.optimizer.param_groups]
    assert rates == pytest.approx([cosine_schedule(r, TOTAL_STEPS)(1) for r in (LR, LR, FUSION_LR, FUSION_LR)])
    assert state.scheduler.last_epoch == 1
    params = run.numpy_params()
    for label, fusion in (("backbone", False), ("fusion", True)):
        adam = run.state.opt_state.inner_states[label].inner_state[0]
        for field, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            moments = convert.state_dict_from_jax(jax.tree_util.tree_map(
                lambda m, p: np.zeros(np.shape(p), np.float32) if isinstance(m, tuple) else np.asarray(m),
                getattr(adam, field), params, is_leaf=lambda x: isinstance(x, tuple) and not x))
            for name, p in state.model.named_parameters():
                if ("t5" in name) == fusion:
                    got = state.optimizer.state[p]
                    assert float(got["step"]) == 1.0
                    torch.testing.assert_close(got[key], moments[name], rtol=0, atol=0, msg=lambda m: f"{name}: {m}")


def test_legacy_state_msgpack_converts(tmp_path):
    """A checkpoint directory holding only the legacy single-file
    state.msgpack (and meta.json) converts and resumes as the orbax one."""
    import jax
    from flax import serialization

    from uniir_tpu.core.checkpoint import _state_to_pytree

    root = str(tmp_path)
    cfg = _config(root, "CLIPScoreFusion")
    run = JaxRun(cfg)
    run.step(_batch("CLIPScoreFusion", seed=0))
    ckpt = run.save(os.path.join(root, "jax"))
    for item in os.listdir(ckpt):
        if item != "meta.json":
            shutil.rmtree(os.path.join(ckpt, item))
    with open(os.path.join(ckpt, "state.msgpack"), "wb") as f:
        f.write(serialization.to_bytes(jax.device_get(_state_to_pytree(run.state))))
    path = _convert(root, cfg, os.path.join(ckpt, "state.msgpack"))
    _serve_and_resume(root, cfg, path, run, [_batch("CLIPScoreFusion", seed=1)])


def test_params_file_converts_to_a_state_dict_the_registry_reads(tmp_path):
    from uniir_tpu.core.checkpoint import save_params

    root = str(tmp_path)
    cfg = _config(root, "BLIPFeatureFusion")
    run = JaxRun(cfg)
    run.step(_batch("BLIPFeatureFusion", seed=0))
    save_params(os.path.join(root, "params.msgpack"), run.state.params)
    out = os.path.join(root, "weights.pth")
    assert _convert(root, cfg, os.path.join(root, "params.msgpack"), "--params-only", "--out", out) == out
    serve = Config.from_dict(cfg)
    serve.model.pretrained_torch_ckpt = out
    bundle = build_model_from_config(serve, "cpu")
    batch = _batch("BLIPFeatureFusion", seed=3)
    np.testing.assert_allclose(make_embed_step(bundle.model, torch.float32)(batch).numpy(), run.embeddings(batch),
                               atol=EMBED_ATOL)


def test_accumulation_is_carried_after_a_whole_update(tmp_path):
    """accumulation_steps 2, saved after 2 micro-steps (one update): the
    port resumes and its next update matches JAX's."""
    root = str(tmp_path)
    cfg = _config(root, "CLIPScoreFusion", accum=2)
    run = JaxRun(cfg)
    for seed in (0, 1):
        run.step(_batch("CLIPScoreFusion", seed=seed))
    path = _convert(root, cfg, run.save(os.path.join(root, "jax")))
    with open(os.path.join(path, "meta.json")) as f:
        assert json.load(f)["step"] == 2
    _serve_and_resume(root, cfg, path, run, [_batch("CLIPScoreFusion", seed=s) for s in (2, 3)])


def test_mid_accumulation_checkpoint_is_refused(tmp_path):
    root = str(tmp_path)
    cfg = _config(root, "CLIPScoreFusion", accum=2)
    run = JaxRun(cfg)
    run.step(_batch("CLIPScoreFusion", seed=0))
    with pytest.raises(ValueError, match=r"mini_step 1"):
        _convert(root, cfg, run.save(os.path.join(root, "jax")))
    assert not os.path.exists(os.path.join(root, "port"))


@pytest.mark.parametrize("fault", ["sum", "copy", "drop"])
def test_element_map_refuses_a_key_map_that_combines(tmp_path, monkeypatch, fault):
    """Moments may only be moved: the real CLIP-SF key map is a permutation
    of the tree's elements (each port key traced to its JAX leaf), and a map
    that sums two leaves, copies one or drops one is refused by name."""
    import jax

    params = jax.tree_util.tree_map(np.asarray, _jax_build(_config(str(tmp_path), "CLIPScoreFusion"))[1].params)
    key_of = convert.element_map(params)
    assert key_of["visual.proj"] == ("visual", "proj") and key_of["logit_scale"] == ("logit_scale",)
    assert key_of["transformer.resblocks.0.attn.in_proj_weight"] == ("text", "transformer", "resblocks_0", "attn",
                                                                      "qkv_proj", "kernel")
    assert set(key_of) == set(convert.state_dict_from_jax(params))
    real = convert._renamed

    def faulty(params_np):
        out = dict(real(params_np))
        if fault == "sum":
            out["logit_scale"] = out["logit_scale"] + out["visual.class_embedding"][0]
        elif fault == "copy":
            out["visual.ln_post.bias"] = out["visual.ln_post.weight"].copy()
        else:
            del out["ln_final.bias"]
        return out

    monkeypatch.setattr(convert, "_renamed", faulty)
    with pytest.raises(ValueError, match=r"does not only move elements"):
        convert.element_map(params)


def test_a_jax_checkpoint_given_to_the_port_names_the_bridge(tmp_path):
    root = str(tmp_path)
    cfg = _config(root, "CLIPScoreFusion")
    os.makedirs(os.path.join(root, "checkpoint", "clip_sf_epoch_0", "params"))
    serve = Config.from_dict(cfg)
    serve.model.ckpt_config.ckpt_name = "clip_sf_epoch_0"
    with pytest.raises(NotImplementedError, match=r"scripts/orbax_to_torch\.py"):
        build_model_from_config(serve, "cpu")
