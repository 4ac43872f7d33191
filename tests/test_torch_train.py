"""The CLIP-SF training path of the port against the JAX package at `test-tiny`:
the in-batch loss, the optimizer and schedule, one train step (fp32 and
bf16), remat, the checkpoint and the trainer end to end.

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
from uniir_tpu_torch.train.steps import clip_loss, make_clip_train_step

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

    tok = simple_tokenizer(max_len=CFG.context_length, vocab_size=CFG.vocab_size)
    img_fn = identity_image_transform(CFG.image_size)
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


def test_unported_training_options_raise():
    model = CLIPScoreFusion(CFG)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_clip_optimizer(model, LR, TOTAL_STEPS, fusion_learning_rate=1e-4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        from uniir_tpu_torch.train.trainer import build_train_setup

        build_train_setup(Config.from_dict({"model": {"name": "BLIPScoreFusion"}}))


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
