"""The CLIP-SF and CLIP-FF training paths of the port against the JAX package at
`test-tiny` / `test-tiny-ff`: the in-batch loss, the optimizer groups and
schedules, one train step (fp32 and bf16), remat, the fusion dropout, the
checkpoint and the trainer end to end.

Inputs come from numpy with a seed; weights move from JAX with
`state_dict_from_jax`, which also maps a JAX gradient tree onto the port's
parameter names.  In bf16 the JAX towers reach `paired_attention` (Pallas
forward and backward in interpret mode on the CPU) and the port's reach the
twins of kernels K1 and K3.  JAX is imported inside the parity tests only,
so the GPU case also runs on a host without it:
`python -m pytest tests/test_torch_train.py -m gpu --noconftest`.
"""

import os

import numpy as np
import pytest
import torch

from uniir_tpu_torch.core.checkpoint import CHECKPOINT_FILE, load_train_checkpoint, save_train_checkpoint
from uniir_tpu_torch.core.config import Config
from uniir_tpu_torch.models.clip import CLIP_CONFIGS
from uniir_tpu_torch.models.clip_sf import CLIPScoreFusion
from uniir_tpu_torch.models.convert import state_dict_from_jax
from uniir_tpu_torch.models.registry import ModelBundle, seeded_clip_sf_train
from uniir_tpu_torch.train.losses import inbatch_contrastive_loss
from uniir_tpu_torch.train.optimizer import clip_decay_mask, cosine_schedule, make_clip_optimizer
from uniir_tpu_torch.train.state import TrainState
from uniir_tpu_torch.train.steps import clip_loss, make_clip_train_step, make_embed_step, step_seed

CFG = CLIP_CONFIGS["test-tiny"]
# fp32 on both sides: the loss and optimizer differ only by summation order
# (and AdamW's algebraically equal update), a few fp32 ulps.  The loss is a
# log-sum-exp minus a logit of ~1/0.07, so its ulps are absolute, ~1e-6.
LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-6
ADAM_ATOL = 1e-6
# fp32 train step: summation order and flax's E[x^2] - E[x]^2 LayerNorm
# variance; gradients and parameters agree to ~1e-5 of the largest element
# of their tensor (the embedding gradients sum many rows of magnitude ~40).
STEP_RTOL, STEP_ATOL = 1e-4, 1e-5
# bf16 train step: the frameworks round at other points; each gradient's
# direction must survive, and the loss (~4) within one bf16 ulp (2^-5).
BF16_MIN_COSINE = 0.99
BF16_LOSS_ATOL = 2**-5
LR, TOTAL_STEPS = 1e-3, 10


def _jax_cfg():
    from uniir_tpu.models.clip import CLIP_CONFIGS as JAX_CONFIGS

    return JAX_CONFIGS["test-tiny"]


def _batch(bs=4, seed=0):
    """A collated train batch of bs pairs, flat layout: rows [0, bs) queries,
    [bs, 2bs) positives, mixed modality."""
    rng = np.random.default_rng(seed)
    n = 2 * bs
    txt = np.zeros((n, CFG.context_length), np.int32)
    for i in range(n):
        length = 3 + i % (CFG.context_length - 4)
        txt[i, :length] = rng.integers(1, CFG.vocab_size - 1, length)
        txt[i, length] = CFG.vocab_size - 1  # EOT: the highest id
    return {
        "txt_batched": txt,
        "image_batched": rng.random((n, CFG.image_size, CFG.image_size, 3)).astype(np.float32),
        "txt_mask_batched": np.array([1, 1, 0] * n, np.int32)[:n],
        "image_mask_batched": np.array([1, 0, 1] * n, np.int32)[::-1][:n].copy(),
    }


@pytest.fixture(scope="module")
def jax_params():
    import jax

    from uniir_tpu.models.clip_sf import CLIPScoreFusion as JaxCLIPSF

    b = _batch()
    init = jax.jit(JaxCLIPSF(_jax_cfg()).init)(jax.random.PRNGKey(0), *(b[k][:2] for k in b))
    return jax.tree_util.tree_map(np.asarray, init["params"])


def _port_model(params, dtype=torch.float32, remat=False):
    model = CLIPScoreFusion(CFG, dtype=dtype, remat=remat)
    model.load_state_dict(state_dict_from_jax(params))
    return model


def _assert_step_close(got, want, name):
    atol = STEP_ATOL * max(1.0, want.abs().max().item())
    torch.testing.assert_close(got, want, rtol=STEP_RTOL, atol=atol, msg=lambda m: f"{name}: {m}")


def _cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return torch.nn.functional.cosine_similarity(a, b, dim=0).item()


# ------------------------------------------------------------------ loss


@pytest.mark.parametrize(
    "hard_neg_num,in_batch_neg_num,n_hosts",
    [(0, 0, 1), (2, 0, 1), (2, 2, 1), (2, 9, 1), (0, 0, 2), (1, 2, 2)],
)
def test_inbatch_loss_matches_jax(hard_neg_num, in_batch_neg_num, n_hosts):
    import jax.numpy as jnp

    from uniir_tpu.train.losses import inbatch_contrastive_loss as jax_loss

    bs, D = 6, 16
    rng = np.random.default_rng(hard_neg_num * 10 + in_batch_neg_num + n_hosts)
    q = rng.standard_normal((bs, D)).astype(np.float32)
    rows = [q, q + 0.8 * rng.standard_normal((bs, D)), rng.standard_normal((bs * hard_neg_num, D))]
    emb = np.concatenate(rows).astype(np.float32)
    if n_hosts > 1:  # host-major: each host's [q|p|n] block after the other
        per = bs // n_hosts
        blocks = [np.concatenate([r.reshape(n_hosts, -1, D)[h] for r in rows]) for h in range(n_hosts)]
        emb, q = np.concatenate(blocks).astype(np.float32), q
        assert blocks[0].shape[0] == (2 + hard_neg_num) * per
    scale = np.float32(1 / 0.07)
    ref = jax_loss(jnp.asarray(emb), bs, jnp.asarray(scale), hard_neg_num, in_batch_neg_num, n_hosts)
    out = inbatch_contrastive_loss(torch.from_numpy(emb), bs, torch.tensor(scale), hard_neg_num, in_batch_neg_num,
                                   n_hosts)
    np.testing.assert_allclose(out["loss"].item(), float(ref["loss"]), rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert out["accuracy"].item() == float(ref["accuracy"])


# ------------------------------------------------------------- optimizer


def test_decay_mask_matches_jax(jax_params):
    import jax

    from uniir_tpu.train.optimizer import clip_decay_mask as jax_mask

    full = jax.tree_util.tree_map(lambda m, p: np.full(np.shape(p), m), jax_mask(jax_params), jax_params)
    want = {name: bool(t.flatten()[0]) for name, t in state_dict_from_jax(full).items()}
    assert clip_decay_mask(CLIPScoreFusion(CFG)) == want
    assert not want["logit_scale"] and not want["visual.ln_pre.weight"] and want["visual.proj"]


@pytest.mark.parametrize("warmup", [0, 3])
def test_cosine_schedule_matches_optax(warmup):
    from uniir_tpu.train.optimizer import cosine_schedule as jax_schedule

    ref = jax_schedule(LR, TOTAL_STEPS, warmup)
    ours = cosine_schedule(LR, TOTAL_STEPS, warmup)
    for count in (0, 1, 2, 3, 4, 7, 10, 13):
        np.testing.assert_allclose(ours(count), float(ref(count)), rtol=1e-6, atol=1e-12, err_msg=str(count))


def _grad_trees(params, n, seed=0):
    import jax

    rng = np.random.default_rng(seed)
    return [jax.tree_util.tree_map(lambda p: rng.standard_normal(np.shape(p)).astype(np.float32), params)
            for _ in range(n)]


@pytest.mark.parametrize("accum,warmup", [(1, 0), (1, 2), (2, 0)])
def test_adamw_steps_match_optax(jax_params, accum, warmup):
    """AdamW in the CLIP groups with the schedule (and MultiSteps-style
    accumulation) against make_clip_optimizer's optax chain on the same grads."""
    import jax
    import optax

    from uniir_tpu.train.optimizer import make_clip_optimizer as jax_optimizer

    grads = _grad_trees(jax_params, 3 * accum)
    tx = jax_optimizer(jax_params, LR, TOTAL_STEPS, warmup_steps=warmup, accumulation_steps=accum)
    params, opt_state = jax_params, tx.init(jax_params)
    update = jax.jit(tx.update)
    for g in grads:
        updates, opt_state = update(g, opt_state, params)
        params = optax.apply_updates(params, updates)

    model = _port_model(jax_params)
    state = TrainState(model, *make_clip_optimizer(model, LR, TOTAL_STEPS, warmup_steps=warmup), accumulation_steps=accum)
    for g in grads:
        sd = state_dict_from_jax(g)
        for name, p in model.named_parameters():
            p.grad = sd[name].clone() if p.grad is None else p.grad + sd[name]
        state.apply_gradients()
    assert state.step == 3 * accum
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params))
    for name, p in model.named_parameters():
        torch.testing.assert_close(
            p.detach(), want[name], rtol=0, atol=ADAM_ATOL, msg=lambda m, name=name: f"{name}: {m}"
        )


# ------------------------------------------------------------ train step


def _jax_loss_and_grads(params, batch, dtype):
    import jax
    import jax.numpy as jnp

    from uniir_tpu.models.clip_sf import CLIPScoreFusion as JaxCLIPSF
    from uniir_tpu.train.losses import inbatch_contrastive_loss as jax_loss

    model = JaxCLIPSF(_jax_cfg(), dtype=dtype)

    def loss_fn(p):
        emb = model.apply({"params": p}, *(batch[k] for k in batch))
        out = jax_loss(emb, batch["image_batched"].shape[0] // 2, jnp.exp(p["logit_scale"]))
        return out["loss"], out

    (loss, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return float(loss), float(out["accuracy"]), state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads))


def test_train_step_fp32_matches_jax(jax_params):
    import jax

    from uniir_tpu.models.clip_sf import CLIPScoreFusion as JaxCLIPSF
    from uniir_tpu.train.optimizer import make_clip_optimizer as jax_optimizer
    from uniir_tpu.train.state import TrainState as JaxTrainState
    from uniir_tpu.train.steps import make_clip_train_step as jax_train_step

    batch = _batch()
    loss, acc, grads = _jax_loss_and_grads(jax_params, batch, np.float32)
    model = _port_model(jax_params)
    out = clip_loss(model, batch)
    out["loss"].backward()
    np.testing.assert_allclose(out["loss"].item(), loss, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert out["accuracy"].item() == acc
    for name, p in model.named_parameters():
        _assert_step_close(p.grad, grads[name], name)

    # two steps: parameters after the updates
    jax_state = JaxTrainState.create(jax_params, jax_optimizer(jax_params, LR, TOTAL_STEPS))
    jax_step = jax_train_step(JaxCLIPSF(_jax_cfg()))
    model = _port_model(jax_params)
    state = TrainState(model, *make_clip_optimizer(model, LR, TOTAL_STEPS))
    step = make_clip_train_step(model)
    for seed in (0, 1):
        b = _batch(seed=seed)
        jax_state, jax_metrics = jax_step(jax_state, b)
        state, metrics = step(state, b)
        np.testing.assert_allclose(metrics["loss"].item(), float(jax_metrics["loss"]), rtol=STEP_RTOL)
        assert metrics["inbatch_accuracy"].item() == float(jax_metrics["inbatch_accuracy"])
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jax_state.params))
    for name, p in model.named_parameters():
        got = p.detach()
        if name.endswith("attn.in_proj_bias"):
            # The key bias shifts every score of a row by the same q.b_k, so
            # its true gradient is 0 and both sides hold only rounding noise,
            # which Adam scales to steps of about +-lr: it only must stay
            # within the 2 steps' bound.
            W = got.numel() // 3
            assert (got[W : 2 * W] - want[name][W : 2 * W]).abs().max() <= 2 * 2 * 2 * LR, name
            keep = torch.ones(3 * W, dtype=torch.bool)
            keep[W : 2 * W] = False
            got, want[name] = got[keep], want[name][keep]
        # Adam divides each gradient element by its own magnitude, so an
        # element whose gradient is within rounding noise of 0 moves by an
        # amount that noise sets: allow 5% of one step's lr on top.
        torch.testing.assert_close(
            got, want[name], rtol=STEP_RTOL, atol=STEP_ATOL + 0.05 * LR, msg=lambda m, name=name: f"{name}: {m}"
        )


def test_train_step_bf16_matches_jax(jax_params):
    """bf16 compute over fp32 parameters: JAX through Pallas K1/K3 (interpret),
    the port through their twins."""
    import jax.numpy as jnp

    batch = _batch()
    loss, _, grads = _jax_loss_and_grads(jax_params, batch, jnp.bfloat16)
    model = _port_model(jax_params, torch.bfloat16)
    out = clip_loss(model, batch)
    out["loss"].backward()
    assert abs(out["loss"].item() - loss) <= BF16_LOSS_ATOL
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, name
        assert _cosine(p.grad, grads[name]) >= BF16_MIN_COSINE, name


def test_remat_gives_the_same_loss_and_gradients(jax_params):
    batch = _batch(seed=2)
    results = []
    for remat in (False, True):
        model = _port_model(jax_params, torch.bfloat16, remat=remat)
        out = clip_loss(model, batch)
        out["loss"].backward()
        results.append((out["loss"].detach(), {n: p.grad for n, p in model.named_parameters()}))
    (loss, grads), (loss_r, grads_r) = results
    torch.testing.assert_close(loss_r, loss, rtol=0, atol=0)
    for name, g in grads.items():
        torch.testing.assert_close(grads_r[name], g, rtol=0, atol=0, msg=lambda m, name=name: f"{name}: {m}")


# ------------------------------------------------- checkpoint and trainer


def test_checkpoint_round_trip_is_bit_equal(tmp_path, jax_params):
    model = _port_model(jax_params, torch.bfloat16)
    state = TrainState(model, *make_clip_optimizer(model, LR, TOTAL_STEPS))
    step = make_clip_train_step(model)
    state, _ = step(state, _batch())
    path = save_train_checkpoint(str(tmp_path), "clip_sf", state, 3, Config.from_dict({"seed": 1}))
    assert sorted(os.listdir(path)) == [CHECKPOINT_FILE, "meta.json"]

    fresh = CLIPScoreFusion(CFG, dtype=torch.bfloat16)
    restored, epoch = load_train_checkpoint(path, TrainState(fresh, *make_clip_optimizer(fresh, LR, TOTAL_STEPS)))
    assert epoch == 3 and restored.step == 1
    for (name, p), q in zip(model.named_parameters(), fresh.parameters()):
        assert torch.equal(p, q), name
    a, b = state.optimizer.state_dict(), restored.optimizer.state_dict()
    assert a["param_groups"] == b["param_groups"]
    for i, s in a["state"].items():
        for key, value in s.items():
            assert torch.equal(value, b["state"][i][key]), (i, key)
    assert restored.scheduler.state_dict() == state.scheduler.state_dict()


def _train_config(root, epochs, resume_from=""):
    return Config.from_dict({
        "uniir_dir": root,
        "mbeir_data_dir": os.path.join(root, "mbeir_data"),
        "seed": 2023,
        "data_config": {
            "image_size": "32, 32", "hard_neg_num": 0, "in_batch_neg_num": 0, "shuffle_cand": True,
            "returns": None, "enable_query_instruct": True, "query_instruct_path": "instructions.tsv",
            "train_query_data_path": "queries.jsonl", "train_cand_pool_path": "cand_pool.jsonl",
            "val_query_data_path": "queries.jsonl", "val_cand_pool_path": "cand_pool.jsonl",
        },
        "dataloader_config": {"num_workers": 2, "train_batch_size": 8, "valid_batch_size": 8},
        "trainer_config": {"gradient_accumulation_steps": 1, "num_train_epochs": epochs, "learning_rate": 3e-3,
                           "warmup_steps": 0, "print_freq": 1},
        "evaluator": {"enable_eval": True, "eval_freq": 1, "print_freq": 10},
        "model": {
            "name": "CLIPScoreFusion", "short_name": "TEST_SF", "size": "Tiny", "bf16": False,
            "clip_vision_model_name": "test-tiny", "clip_bpe_path": os.path.join(root, "merges.txt"),
            "ckpt_config": {"ckpt_dir": "checkpoint/test/", "resume_training": bool(resume_from),
                            "ckpt_name": resume_from},
        },
    })


def _bundle():
    from tests.helpers import identity_image_transform, simple_tokenizer
    from tests.torch_helpers import on_array

    tok = simple_tokenizer(max_len=CFG.context_length, vocab_size=CFG.vocab_size)
    img_fn = on_array(identity_image_transform(CFG.image_size))
    model = seeded_clip_sf_train(CFG, "cpu", seed=0, dtype=torch.float32)
    return ModelBundle("CLIPScoreFusion", model, tok, img_fn, img_fn, (CFG.image_size,) * 2, CFG.embed_dim)


def test_trainer_trains_resumes_and_serves(tmp_path):
    from tests.helpers import build_mbeir_fixture, tiny_clip_merges
    from uniir_tpu_torch.models.registry import build_clip_sf
    from uniir_tpu_torch.train import trainer
    from uniir_tpu_torch.train.steps import make_embed_step

    root = str(tmp_path)
    build_mbeir_fixture(os.path.join(root, "mbeir_data"), n_queries=16, n_cands=24)
    with open(os.path.join(root, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in tiny_clip_merges()))

    first = trainer.main(_train_config(root, epochs=1), bundle=_bundle())
    ckpt_dir = os.path.join(root, "checkpoint/test")
    assert os.path.isfile(os.path.join(ckpt_dir, "test_sf_epoch_0", CHECKPOINT_FILE))
    assert first["state"].step == 2  # 16 queries / batch 8
    assert "val_loss" in first["stats"]

    # resume from epoch 0: continues with epoch 1, where the loss is lower
    second = trainer.main(_train_config(root, epochs=2, resume_from="test_sf_epoch_0"), bundle=_bundle())
    assert second["stats"]["epoch"] == 1 and second["state"].step == 4
    assert float(second["stats"]["train_loss"]) < float(first["stats"]["train_loss"])

    # the trained checkpoint serves
    config = _train_config(root, epochs=2)
    config.model.ckpt_config.ckpt_name = "test_sf_epoch_1"
    served = build_clip_sf(config, device="cpu")
    for (name, p), q in zip(second["state"].model.named_parameters(), served.model.parameters()):
        assert torch.equal(p, q), name
    batch = _batch()
    emb = make_embed_step(served.model)(batch)
    assert emb.shape == (8, CFG.embed_dim) and torch.isfinite(emb.float()).all()


# ------------------------------------------------------------------ CLIP-FF

FF_CFG = CLIP_CONFIGS["test-tiny-ff"]
FUSION_LR = 4e-3


def _jax_ff():
    from uniir_tpu.models.clip import CLIP_CONFIGS as JAX_CONFIGS
    from uniir_tpu.models.clip_ff import CLIPFeatureFusion as JaxCLIPFF

    return JaxCLIPFF(JAX_CONFIGS["test-tiny-ff"])


@pytest.fixture(scope="module")
def jax_ff_params():
    import jax

    b = _batch()
    init = jax.jit(_jax_ff().init)(jax.random.PRNGKey(0), *(b[k][:2] for k in b))
    return jax.tree_util.tree_map(np.asarray, init["params"])


def _port_ff(params, dtype=torch.float32, remat=False):
    from uniir_tpu_torch.models.clip_ff import CLIPFeatureFusion

    model = CLIPFeatureFusion(FF_CFG, dtype=dtype, remat=remat)
    model.load_state_dict(state_dict_from_jax(params))
    return model


def test_fusion_groups_match_the_jax_labels(jax_ff_params):
    """The four groups: {backbone, fusion} x {decay, no decay}, by the JAX
    package's label tree and decay mask."""
    import jax

    from uniir_tpu.train.optimizer import clip_decay_mask as jax_mask

    model = _port_ff(jax_ff_params)
    optimizer, _ = make_clip_optimizer(model, LR, TOTAL_STEPS, fusion_learning_rate=FUSION_LR)
    group_of = {id(p): i for i, g in enumerate(optimizer.param_groups) for p in g["params"]}
    decay = jax.tree_util.tree_map(lambda m, p: np.full(np.shape(p), m), jax_mask(jax_ff_params), jax_ff_params)
    decay = {name: bool(t.flatten()[0]) for name, t in state_dict_from_jax(decay).items()}
    assert clip_decay_mask(model) == decay
    for name, p in model.named_parameters():
        fusion = name.startswith("t5_layers.")
        assert group_of[id(p)] == 2 * fusion + (not decay[name]), name
    assert [g["lr"] for g in optimizer.param_groups] == [LR, LR, FUSION_LR, FUSION_LR]
    assert [g["weight_decay"] for g in optimizer.param_groups] == [0.2, 0.0, 0.2, 0.0]
    assert not decay["t5_layers.block.0.layer.0.SelfAttention.relative_attention_bias.weight"]
    assert decay["t5_layers.block.0.layer.0.SelfAttention.q.weight"] and not decay["t5_layers.final_layer_norm.weight"]


@pytest.mark.parametrize("warmup", [0, 2])
def test_both_schedules_are_read_back_from_the_optimizer(jax_ff_params, warmup):
    from uniir_tpu.train.optimizer import cosine_schedule as jax_schedule

    model = _port_ff(jax_ff_params)
    optimizer, scheduler = make_clip_optimizer(model, LR, TOTAL_STEPS, warmup_steps=warmup, fusion_learning_rate=FUSION_LR)
    ref, ref_fusion = jax_schedule(LR, TOTAL_STEPS, warmup), jax_schedule(FUSION_LR, TOTAL_STEPS, warmup)
    for count in range(TOTAL_STEPS + 1):
        lrs = [g["lr"] for g in optimizer.param_groups]
        # optax evaluates 1 + cos in fp32: near the end of the decay its relative rounding reaches 1e-6
        np.testing.assert_allclose(lrs[:2], float(ref(count)), rtol=1e-5, atol=1e-12)
        np.testing.assert_allclose(lrs[2:], float(ref_fusion(count)), rtol=1e-5, atol=1e-12)
        optimizer.step()
        scheduler.step()


@pytest.mark.parametrize("accum,warmup", [(1, 0), (2, 2)])
def test_adamw_with_fusion_group_matches_optax_multi_transform(jax_ff_params, accum, warmup):
    import jax
    import optax

    from uniir_tpu.train.optimizer import make_clip_optimizer as jax_optimizer

    grads = _grad_trees(jax_ff_params, 3 * accum, seed=1)
    tx = jax_optimizer(jax_ff_params, LR, TOTAL_STEPS, warmup_steps=warmup, accumulation_steps=accum,
                       fusion_learning_rate=FUSION_LR)
    params, opt_state = jax_ff_params, tx.init(jax_ff_params)
    update = jax.jit(tx.update)
    for g in grads:
        updates, opt_state = update(g, opt_state, params)
        params = optax.apply_updates(params, updates)

    model = _port_ff(jax_ff_params)
    state = TrainState(
        model, *make_clip_optimizer(model, LR, TOTAL_STEPS, warmup_steps=warmup, fusion_learning_rate=FUSION_LR),
        accumulation_steps=accum,
    )
    for g in grads:
        sd = state_dict_from_jax(g)
        for name, p in model.named_parameters():
            p.grad = sd[name].clone() if p.grad is None else p.grad + sd[name]
        state.apply_gradients()
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params))
    for name, p in model.named_parameters():
        # the fusion group steps by up to FUSION_LR: its rounding scales with it
        atol = ADAM_ATOL * (FUSION_LR / LR if name.startswith("t5_layers.") else 1.0)
        torch.testing.assert_close(p.detach(), want[name], rtol=0, atol=atol, msg=lambda m, name=name: f"{name}: {m}")


def _jax_ff_loss_and_grads(params, batch, dtype):
    import jax
    import jax.numpy as jnp

    from uniir_tpu.train.losses import inbatch_contrastive_loss as jax_loss

    model = _jax_ff().clone(dtype=dtype)

    def loss_fn(p):
        emb = model.apply({"params": p}, *(batch[k] for k in batch))
        out = jax_loss(emb, batch["image_batched"].shape[0] // 2, jnp.exp(p["logit_scale"]))
        return out["loss"], out

    (loss, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return float(loss), float(out["accuracy"]), state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads))


def test_clip_ff_train_step_fp32_matches_jax_without_dropout(jax_ff_params):
    """Dropout cannot match across frameworks: both sides run the step with
    it off.  Loss and gradients of one batch, then the parameters after two
    updates with the T5 group at its own rate."""
    import jax

    from uniir_tpu.train.optimizer import make_clip_optimizer as jax_optimizer
    from uniir_tpu.train.state import TrainState as JaxTrainState
    from uniir_tpu.train.steps import make_clip_train_step as jax_train_step

    batch = _batch()
    loss, acc, grads = _jax_ff_loss_and_grads(jax_ff_params, batch, np.float32)
    model = _port_ff(jax_ff_params)
    model.t5_layers.eval()
    out = clip_loss(model, batch)
    out["loss"].backward()
    np.testing.assert_allclose(out["loss"].item(), loss, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert out["accuracy"].item() == acc
    for name, p in model.named_parameters():
        _assert_step_close(p.grad, grads[name], name)

    jax_state = JaxTrainState.create(jax_ff_params, jax_optimizer(jax_ff_params, LR, TOTAL_STEPS, fusion_learning_rate=FUSION_LR))
    jax_step = jax_train_step(_jax_ff(), with_dropout=False)
    model = _port_ff(jax_ff_params)
    state = TrainState(model, *make_clip_optimizer(model, LR, TOTAL_STEPS, fusion_learning_rate=FUSION_LR))
    step = make_clip_train_step(model, with_dropout=False)
    for seed in (0, 1):
        b = _batch(seed=seed)
        jax_state, jax_metrics = jax_step(jax_state, b)
        state, metrics = step(state, b)
        np.testing.assert_allclose(metrics["loss"].item(), float(jax_metrics["loss"]), rtol=STEP_RTOL)
        assert metrics["inbatch_accuracy"].item() == float(jax_metrics["inbatch_accuracy"])
    assert not model.t5_layers.training  # with_dropout=False keeps the fusion stack in eval mode
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jax_state.params))
    for name, p in model.named_parameters():
        got = p.detach()
        lr = FUSION_LR if name.startswith("t5_layers.") else LR
        if name.endswith("attn.in_proj_bias"):
            # the key bias's true gradient is 0 (see the CLIP-SF test): bounded, not compared
            W = got.numel() // 3
            assert (got[W : 2 * W] - want[name][W : 2 * W]).abs().max() <= 2 * 2 * 2 * lr, name
            keep = torch.ones(3 * W, dtype=torch.bool)
            keep[W : 2 * W] = False
            got, want[name] = got[keep], want[name][keep]
        # Adam divides each gradient element by its own magnitude: an element
        # within rounding noise of 0 moves by what the noise sets, 5% of a step.
        close = torch.isclose(got, want[name], rtol=STEP_RTOL, atol=STEP_ATOL + 0.05 * lr)
        if name.startswith("t5_layers."):
            # The fusion stack adds two discrete effects: a ReLU input within
            # rounding of 0 is on in one framework and off in the other, and
            # the unscaled logits' q / k gradients are the smallest of the
            # model.  Measured: at most 2 elements of a tensor off, by 20% of
            # a step.  Allowed: 1 element in 10^4, each within the two steps'
            # bound.
            assert (~close).sum().item() <= max(1, got.numel() // 10_000), name
            assert (got - want[name]).abs().max() <= 2 * 2 * lr, name
        else:
            assert close.all(), f"{name}: {(got - want[name]).abs().max()}"


def test_clip_ff_train_step_bf16_matches_jax(jax_ff_params):
    """bf16 compute over fp32 parameters: JAX through Pallas K1 / K3
    (interpret), the port through their twins; the fusion stack is an einsum
    on both sides."""
    import jax.numpy as jnp

    batch = _batch()
    loss, _, grads = _jax_ff_loss_and_grads(jax_ff_params, batch, jnp.bfloat16)
    model = _port_ff(jax_ff_params, torch.bfloat16)
    model.t5_layers.eval()
    out = clip_loss(model, batch)
    out["loss"].backward()
    assert abs(out["loss"].item() - loss) <= BF16_LOSS_ATOL
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, name
        assert _cosine(p.grad, grads[name]) >= BF16_MIN_COSINE, name


def test_clip_ff_dropout_step_is_seeded_and_the_eval_step_deterministic(jax_ff_params):
    from uniir_tpu_torch.train.steps import make_clip_eval_step

    batch = _batch()
    losses = []
    for seed in (11, 11, 12):
        model = _port_ff(jax_ff_params)
        state = TrainState(model, *make_clip_optimizer(model, LR, TOTAL_STEPS, fusion_learning_rate=FUSION_LR))
        step = make_clip_train_step(model, with_dropout=True, seed=seed)
        state, first = step(state, dict(batch))
        assert model.t5_layers.training
        state, second = step(state, dict(batch))
        losses.append((first["loss"].item(), second["loss"].item()))
    assert losses[0] == losses[1] and losses[0] != losses[2]
    plain = clip_loss(_port_ff(jax_ff_params).eval(), batch)["loss"].item()
    assert losses[0][0] != plain  # dropout really acted
    eval_step = make_clip_eval_step(model)
    a, b = eval_step(dict(batch)), eval_step(dict(batch))
    assert a["loss"].item() == b["loss"].item() and not model.t5_layers.training


def test_clip_ff_remat_gives_the_same_loss_and_gradients(jax_ff_params):
    batch = _batch(seed=2)
    results = []
    for remat in (False, True):
        model = _port_ff(jax_ff_params, torch.bfloat16, remat=remat)
        model.t5_layers.eval()
        out = clip_loss(model, batch)
        out["loss"].backward()
        results.append((out["loss"].detach(), {n: p.grad for n, p in model.named_parameters()}))
    (loss, grads), (loss_r, grads_r) = results
    torch.testing.assert_close(loss_r, loss, rtol=0, atol=0)
    for name, g in grads.items():
        torch.testing.assert_close(grads_r[name], g, rtol=0, atol=0, msg=lambda m, name=name: f"{name}: {m}")


def _seeded_ff_state(seed=0):
    from uniir_tpu_torch.models.registry import seeded_clip_ff_train

    model = seeded_clip_ff_train(FF_CFG, "cpu", seed=seed, dtype=torch.float32)
    return TrainState(model, *make_clip_optimizer(model, LR, TOTAL_STEPS, fusion_learning_rate=FUSION_LR))


def test_embed_step_after_a_dropout_train_step_is_deterministic():
    """The embed step applies the model deterministically whatever mode the
    last train step left the fusion stack in: two calls on the same object
    agree with each other and with the `.eval()` model's output."""
    state = _seeded_ff_state()
    step = make_clip_train_step(state.model, with_dropout=True, seed=5)
    state, _ = step(state, _batch())
    assert state.model.t5_layers.training  # the train step left the dropout on
    batch = _batch(seed=3)
    a = make_embed_step(state.model)(dict(batch))
    state, _ = step(state, _batch(seed=1))  # dropout on again before the second embed step is made
    assert state.model.t5_layers.training
    frozen = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    b, c = make_embed_step(state.model)(dict(batch)), make_embed_step(state.model)(dict(batch))
    assert torch.equal(b, c)
    assert not state.model.t5_layers.training
    from uniir_tpu_torch.train.steps import model_inputs

    with torch.inference_mode():
        want = state.model.eval()(*model_inputs(batch, torch.device("cpu"))).to(torch.float16)
    assert torch.equal(b, want)
    assert a.shape == b.shape and not torch.equal(a, b)  # the parameters moved between the two
    for n, p in state.model.named_parameters():
        assert torch.equal(p, frozen[n]), n


def test_step_seed_is_a_function_of_seed_and_step():
    seeds = {step_seed(s, t) for s in (0, 1, 2023) for t in range(50)}
    assert len(seeds) == 150 and all(0 <= x < 2**63 for x in seeds)
    assert step_seed(2023, 7) == step_seed(2023, 7)


def test_resumed_clip_ff_run_draws_the_uninterrupted_runs_masks(tmp_path):
    """4 steps straight against 2 steps + checkpoint round trip + 2 steps,
    dropout on: every parameter bit-equal.  The dropout generator is seeded
    from (seed, state.step) each step, so nothing of it needs saving."""
    batches = [_batch(seed=10 + i) for i in range(4)]

    straight = _seeded_ff_state()
    step = make_clip_train_step(straight.model, with_dropout=True, seed=7)
    losses = []
    for b in batches:
        straight, metrics = step(straight, dict(b))
        losses.append(metrics["loss"].item())

    first = _seeded_ff_state()
    step = make_clip_train_step(first.model, with_dropout=True, seed=7)
    for b in batches[:2]:
        first, _ = step(first, dict(b))
    path = save_train_checkpoint(str(tmp_path), "clip_ff", first, 0, Config.from_dict({"seed": 7}))
    resumed, _ = load_train_checkpoint(path, _seeded_ff_state(seed=1))  # other weights until the checkpoint loads
    assert resumed.step == 2
    step = make_clip_train_step(resumed.model, with_dropout=True, seed=7)  # a new step function, as a new process makes
    resumed_losses = []
    for b in batches[2:]:
        resumed, metrics = step(resumed, dict(b))
        resumed_losses.append(metrics["loss"].item())

    assert resumed_losses == losses[2:]
    assert losses[2] != losses[0]
    for (name, p), r in zip(straight.model.named_parameters(), resumed.model.parameters()):
        assert torch.equal(p, r), name


def test_trainer_logs_to_wandb_when_it_is_there_and_goes_on_when_not(monkeypatch, capsys):
    """`wandb_config.enabled`: a run when the package imports, None and a
    printed reason when it does not (the reference's gate); off: None."""
    import sys
    import types

    from uniir_tpu_torch.train import trainer

    config = Config.from_dict({"seed": 1, "wandb_config": {"enabled": True, "experiment_name": "exp"}})
    monkeypatch.setitem(sys.modules, "wandb", None)  # import wandb -> ImportError
    assert trainer.init_wandb(config) is None
    assert "wandb disabled" in capsys.readouterr().out
    calls = {}
    fake = types.ModuleType("wandb")
    fake.init = lambda **kw: calls.setdefault("init", kw) and "run"
    monkeypatch.setitem(sys.modules, "wandb", fake)
    assert trainer.init_wandb(config) == "run" and calls["init"]["name"] == "exp"
    assert trainer.init_wandb(Config.from_dict({"seed": 1, "wandb_config": {"enabled": False}})) is None
    assert trainer.init_wandb(Config.from_dict({"seed": 1})) is None


def _ff_train_config(root, epochs, resume_from=""):
    config = _train_config(root, epochs, resume_from)
    config.model.name, config.model.short_name = "CLIPFeatureFusion", "TEST_FF"
    config.model.clip_vision_model_name = "test-tiny-ff"
    config.trainer_config.t5_learning_rate = 6e-3
    return config


def _ff_bundle():
    from tests.helpers import identity_image_transform, simple_tokenizer
    from tests.torch_helpers import on_array
    from uniir_tpu_torch.models.registry import seeded_clip_ff_train

    tok = simple_tokenizer(max_len=FF_CFG.context_length, vocab_size=FF_CFG.vocab_size)
    img_fn = on_array(identity_image_transform(FF_CFG.image_size))
    model = seeded_clip_ff_train(FF_CFG, "cpu", seed=0, dtype=torch.float32)
    return ModelBundle("CLIPFeatureFusion", model, tok, img_fn, img_fn, (FF_CFG.image_size,) * 2, FF_CFG.embed_dim)


def test_trainer_trains_clip_ff_with_the_t5_group_and_serves(tmp_path):
    from tests.helpers import build_mbeir_fixture, tiny_clip_merges
    from uniir_tpu_torch.models.clip_ff import CLIPFeatureFusion
    from uniir_tpu_torch.models.registry import build_model_from_config
    from uniir_tpu_torch.train import trainer
    from uniir_tpu_torch.train.steps import make_embed_step

    root = str(tmp_path)
    build_mbeir_fixture(os.path.join(root, "mbeir_data"), n_queries=16, n_cands=24)
    with open(os.path.join(root, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in tiny_clip_merges()))

    setup = trainer.build_train_setup(_ff_train_config(root, epochs=1), device="cpu")  # the model from the registry
    model = setup["bundle"].model
    assert isinstance(model, CLIPFeatureFusion) and all(p.dtype == torch.float32 for p in model.parameters())
    assert model.training and model.dtype == torch.float32
    assert [g["lr"] for g in setup["state"].optimizer.param_groups] == [3e-3, 3e-3, 6e-3, 6e-3]
    fusion = {id(p) for p in model.t5_layers.parameters()}
    assert {id(p) for g in setup["state"].optimizer.param_groups[2:] for p in g["params"]} == fusion

    first = trainer.main(_ff_train_config(root, epochs=1), bundle=_ff_bundle())
    ckpt_dir = os.path.join(root, "checkpoint/test")
    assert os.path.isfile(os.path.join(ckpt_dir, "test_ff_epoch_0", CHECKPOINT_FILE))
    assert first["state"].step == 2
    # the dropout's generator: seeded from (config.seed, the step count) at the top of the last step
    assert first["state"].model.t5_layers.dropout.generator.initial_seed() == step_seed(2023, 1)
    assert "val_loss" in first["stats"]
    second = trainer.main(_ff_train_config(root, epochs=2, resume_from="test_ff_epoch_0"), bundle=_ff_bundle())
    assert second["stats"]["epoch"] == 1 and second["state"].step == 4
    assert [g["lr"] for g in second["state"].optimizer.param_groups][::2] == pytest.approx([0.0, 0.0])  # both cosines end

    config = _ff_train_config(root, epochs=2)
    config.model.ckpt_config.ckpt_name = "test_ff_epoch_1"
    served = build_model_from_config(config, device="cpu")
    for (name, p), q in zip(second["state"].model.named_parameters(), served.model.parameters()):
        assert torch.equal(p, q), name
    emb = make_embed_step(served.model)(_batch())
    assert emb.shape == (8, FF_CFG.embed_dim) and torch.isfinite(emb.float()).all()


def test_unported_training_options_raise(tmp_path):
    from tests.helpers import tiny_bert_vocab
    from uniir_tpu_torch.models.registry import build_model_from_config

    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(tiny_bert_vocab()) + "\n")
    # the BLIP retrievers train (tests/test_torch_blip_train.py); their int8 serving twins do not
    for name in ("BLIPScoreFusion", "BLIPFeatureFusion"):
        config = Config.from_dict({"model": {"name": name, "vit": "test-tiny", "bert_vocab_path": str(vocab), "int8": True}})
        with pytest.raises(ValueError, match="int8 layers do not train"):
            build_model_from_config(config, device="cpu", train=True)
    config = Config.from_dict({"model": {"name": "CLIPScoreFusion", "clip_vision_model_name": "test-tiny", "int8": True}})
    with pytest.raises(ValueError, match="int8 layers do not train"):
        build_model_from_config(config, device="cpu", train=True)
    # the T5 group is ported: a model without fusion parameters leaves it empty
    optimizer, _ = make_clip_optimizer(CLIPScoreFusion(CFG), LR, TOTAL_STEPS, fusion_learning_rate=1e-4)
    assert [len(g["params"]) > 0 for g in optimizer.param_groups] == [True, True, False, False]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (kernels K1 and K3 have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_vit_l14_train_step_kernels_match_twins(cuda):
    """One seeded ViT-L/14 loss and gradient through K1/K3 and through their
    twins: same loss within 1e-2, per-tensor gradient cosine >= 0.99."""
    from chip_smoke import make_train_batch
    from uniir_tpu_torch.models import layers
    from uniir_tpu_torch.ops import attention as attn_mod

    cfg = CLIP_CONFIGS["ViT-L/14"]
    model = seeded_clip_sf_train(cfg, cuda, seed=0)
    batch = make_train_batch(np.random.default_rng(0), 8, cfg)
    params = list(model.parameters())
    before = (attn_mod.attention.launches, attn_mod.attention_bwd.launches)
    out = clip_loss(model, batch)
    grads = torch.autograd.grad(out["loss"], params)
    blocks = (cfg.vision_layers - 1) + (cfg.text_layers - 1)
    assert (attn_mod.attention.launches, attn_mod.attention_bwd.launches) == (before[0] + blocks, before[1] + blocks)
    layers.attention = attn_mod.attention_twin
    try:
        ref = clip_loss(model, batch)
        ref_grads = torch.autograd.grad(ref["loss"], params)
    finally:
        layers.attention = attn_mod.attention
    assert abs(out["loss"].item() - ref["loss"].item()) <= 1e-2
    for (name, _), g, r in zip(model.named_parameters(), grads, ref_grads):
        assert torch.isfinite(g).all() and _cosine(g, r) >= BF16_MIN_COSINE, name
