"""BLIP-SF and BLIP-FF momentum-distillation training of the port against
the JAX package at `test-tiny`: the momentum train state (EMA, ring-buffer
queues), the momentum-distilled loss, the BLIP optimizer and its freeze
mapping, the train and eval steps, the alpha warm-up, dropout drawn from
explicit generators (also under remat), the enqueue coin, and the trainer
end to end.

Inputs come from numpy with a seed; weights and whole train states move
from JAX with `state_dict_from_jax` / `load_momentum_state_from_jax`.  JAX
is imported inside the parity tests only, so the GPU cases also run on a
host without it:
`python -m pytest tests/test_torch_blip_train.py -m gpu --noconftest`.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from uniir_tpu_torch.core.checkpoint import CHECKPOINT_FILE, load_train_checkpoint, save_train_checkpoint
from uniir_tpu_torch.core.config import Config
from uniir_tpu_torch.models.blip_ff import BLIPFeatureFusion
from uniir_tpu_torch.models.blip_sf import BLIPScoreFusion
from uniir_tpu_torch.models.blip_vit import BLIP_VIT_CONFIGS, BLIPVisionTransformer
from uniir_tpu_torch.models.convert import load_momentum_state_from_jax, state_dict_from_jax
from uniir_tpu_torch.models.layers import Dropout, DropPath
from uniir_tpu_torch.models.med import MED_CONFIGS
from uniir_tpu_torch.train import steps as steps_mod
from uniir_tpu_torch.train.engine import eval_engine, train_one_epoch
from uniir_tpu_torch.train.losses import momentum_distill_contrastive_loss
from uniir_tpu_torch.train.optimizer import make_blip_optimizer
from uniir_tpu_torch.train.state import MomentumTrainState
from uniir_tpu_torch.train.steps import blip_loss, enqueue_coin, make_blip_eval_step, make_blip_train_step

VIT, MED = BLIP_VIT_CONFIGS["test-tiny"], MED_CONFIGS["test-tiny"]
SF_DIM = 16  # BLIP-SF's projection width; BLIP-FF's embedding is MED's hidden width
LR, TOTAL_STEPS, QUEUE, BS, SEQ = 1e-3, 10, 16, 4, 12
ALPHA = 0.4
# EMA and enqueue: one multiply-add per element, or a copy
STATE_ATOL = 1e-7
# the loss of identical fp32 inputs: summation order of the [bs, bs + Q]
# products and log-softmax, a few fp32 ulps of the loss (~2 to 15) and of
# the unit-norm rows
LOSS_RTOL = LOSS_ATOL = 1e-6
# AdamW against optax.adamw on the same gradients (as the CLIP tests)
ADAM_ATOL = 1e-6
# fp32 train steps, as the CLIP-SF step test: summation order and flax's
# E[x^2] - E[x]^2 LayerNorm variance, 1e-5 of the largest element of a
# tensor; Adam divides each gradient element by its own magnitude, so an
# element whose gradient is rounding noise about 0 (the key biases, whose
# true gradient is 0) moves by what the noise sets: allowed 5% of a step's lr
STEP_RTOL, STEP_ATOL = 1e-5, 1e-5
# bf16 compute: each gradient's direction survives the other rounding points
BF16_MIN_COSINE = 0.99


def _named(module):
    """(state-dict name, parameter) pairs: the ViT blocks' timm names, as
    `state_dict_from_jax` writes them."""
    return module.state_dict(keep_vars=True).items()


def _cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return torch.nn.functional.cosine_similarity(a, b, dim=0).item()


def _jax_cfgs():
    from uniir_tpu.models.blip_vit import BLIP_VIT_CONFIGS as JV
    from uniir_tpu.models.med import MED_CONFIGS as JM

    return JV["test-tiny"], JM["test-tiny"]


def _jax_model(name, dtype=np.float32, remat=False):
    import jax.numpy as jnp

    from uniir_tpu.models.blip_ff import BLIPFeatureFusion as JaxFF
    from uniir_tpu.models.blip_sf import BLIPScoreFusion as JaxSF

    vit, med = _jax_cfgs()
    dtype = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    if name == "sf":
        return JaxSF(vit_cfg=vit, med_cfg=med, embed_dim=SF_DIM, dtype=dtype, remat=remat)
    return JaxFF(vit_cfg=vit, med_cfg=med, dtype=dtype, remat=remat)


def _dim(name):
    return SF_DIM if name == "sf" else MED.hidden_size


def _batch(bs=BS, seed=0, hard_neg_num=0, dids=None):
    """A collated BLIP train batch, flat layout [q | p | n]: token ids with
    padding masks of mixed lengths, images, modality masks and dids."""
    rng = np.random.default_rng(seed)
    n = (2 + hard_neg_num) * bs
    ids = np.zeros((n, SEQ), np.int32)
    mask = np.zeros((n, SEQ), np.int32)
    for i in range(n):
        length = 3 + (2 * i + seed) % (SEQ - 3)
        ids[i, :length] = rng.integers(4, MED.vocab_size, length)
        mask[i, :length] = 1
    batch = {
        "txt_batched": {"input_ids": ids, "attention_mask": mask},
        "image_batched": rng.standard_normal((n, VIT.image_size, VIT.image_size, 3)).astype(np.float32),
        "txt_mask_batched": np.array([1, 1, 0] * n, np.int32)[:n],
        "image_mask_batched": np.array([1, 0, 1] * n, np.int32)[::-1][:n].copy(),
        "p_did_list": (1000 + 10 * seed + np.arange(bs) if dids is None else np.asarray(dids)).astype(np.int64),
    }
    if hard_neg_num:
        batch["nc_dids_list"] = (5000 + 10 * seed + np.arange(bs * hard_neg_num)).reshape(bs, hard_neg_num).astype(np.int64)
    return batch


def _randomise(tree, seed=1):
    """Replace zero-initialised leaves (cls_token, pos_embed, biases) by noise
    so that every parameter takes part in the comparison."""
    import jax

    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) if np.any(np.asarray(x)) else (0.02 * rng.standard_normal(np.shape(x))).astype(np.float32),
        tree,
    )


def _init_jax(name):
    import jax

    b = _batch()
    txt = {k: v[:2] for k, v in b["txt_batched"].items()}
    args = (txt, b["image_batched"][:2], b["txt_mask_batched"][:2], b["image_mask_batched"][:2])
    return _randomise(jax.jit(_jax_model(name).init)(jax.random.PRNGKey(0), *args)["params"])


@pytest.fixture(scope="module")
def jax_params():
    return {name: _init_jax(name) for name in ("sf", "ff")}


def _port_model(name, dtype=torch.float32, remat=False, vit=VIT, med=MED):
    cls = BLIPScoreFusion if name == "sf" else BLIPFeatureFusion
    return cls(vit, med, SF_DIM, dtype=dtype, remat=remat).train()


def _jax_state(name, params, queue_size=QUEUE, lr=LR, seed=0, warmup=0):
    """A JAX MomentumTrainState whose twin and queues differ from a fresh one's:
    params_m a perturbed copy, the id queue holding real dids."""
    import jax
    import jax.numpy as jnp

    from uniir_tpu.train.optimizer import make_blip_optimizer as jax_optimizer
    from uniir_tpu.train.state import MomentumTrainState as JaxState

    state = JaxState.create(params, jax_optimizer(params, lr, TOTAL_STEPS, warmup_steps=warmup), queue_size=queue_size,
                            embed_dim=_dim(name), rng=jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 3)
    params_m = jax.tree_util.tree_map(lambda p: p + 0.01 * rng.standard_normal(np.shape(p)).astype(np.float32), params)
    idx = np.full(queue_size, -100, np.int64)
    idx[: queue_size // 2] = 1000 + rng.integers(0, 40, queue_size // 2)  # some match the batches' dids
    return state.replace(params_m=params_m, queue_idx=jnp.asarray(idx, state.queue_idx.dtype))


def _to_numpy(state):
    import jax

    return {k: jax.tree_util.tree_map(np.asarray, getattr(state, k))
            for k in ("params", "params_m", "queue_query", "queue_cand", "queue_idx", "queue_ptr")}


def _port_state(name, jax_state, dtype=torch.float32, remat=False, lr=LR, warmup=0, accum=1, vit=VIT):
    model = _port_model(name, dtype, remat, vit)
    state = MomentumTrainState.create(model, *make_blip_optimizer(model, lr, TOTAL_STEPS, warmup_steps=warmup),
                                      queue_size=QUEUE, embed_dim=_dim(name), accumulation_steps=accum)
    if jax_state is not None:
        load_momentum_state_from_jax(state, **_to_numpy(jax_state))
    return state


def _assert_state_equal(a, b):
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), name
    for (name, p), q in zip(a.model_m.named_parameters(), b.model_m.parameters()):
        assert torch.equal(p, q), name
    for key in ("queue_query", "queue_cand", "queue_idx"):
        assert torch.equal(getattr(a, key), getattr(b, key)), key
    assert (a.queue_ptr, a.step) == (b.queue_ptr, b.step)


# ------------------------------------------------------------- train state


def test_created_state_has_a_frozen_twin_and_normalised_queues():
    model = _port_model("ff")
    state = MomentumTrainState.create(model, *make_blip_optimizer(model, LR, TOTAL_STEPS), queue_size=QUEUE,
                                      embed_dim=MED.hidden_size)
    assert state.model_m is not model and not state.model_m.training
    for (name, p), pm in zip(model.named_parameters(), state.model_m.parameters()):
        assert torch.equal(p, pm) and not pm.requires_grad and p.requires_grad, name
    for q in (state.queue_query, state.queue_cand):
        assert q.shape == (QUEUE, MED.hidden_size) and q.dtype == torch.float32
        torch.testing.assert_close(q.norm(dim=1), torch.ones(QUEUE), rtol=0, atol=1e-6)
    assert not torch.equal(state.queue_query, state.queue_cand)
    assert state.queue_idx.dtype == torch.int64 and (state.queue_idx == -100).all()
    assert (state.queue_ptr, state.step, state.momentum) == (0, 0, 0.995)
    again = MomentumTrainState.create(model, *make_blip_optimizer(model, LR, TOTAL_STEPS), queue_size=QUEUE,
                                      embed_dim=MED.hidden_size)
    assert torch.equal(again.queue_query, state.queue_query)  # seed 0 by default, as the JAX state's PRNGKey(0)


@pytest.mark.parametrize("name", ["sf", "ff"])
def test_momentum_update_matches_jax(jax_params, name):
    js = _jax_state(name, jax_params[name])
    state = _port_state(name, js)
    js = js.momentum_update()
    state.momentum_update()
    want = state_dict_from_jax(_to_numpy(js)["params_m"])
    for key, p in _named(state.model_m):
        torch.testing.assert_close(p, want[key], rtol=0, atol=STATE_ATOL, msg=lambda m, key=key: f"{key}: {m}")


def test_enqueue_matches_jax_wraps_and_checks_divisibility():
    import jax.numpy as jnp

    from uniir_tpu.train.state import MomentumTrainState as JaxState

    rng = np.random.default_rng(4)
    model = _port_model("sf")
    state = MomentumTrainState.create(model, *make_blip_optimizer(model, LR, TOTAL_STEPS), queue_size=12, embed_dim=8)
    js = JaxState(step=jnp.zeros((), jnp.int32), params={}, params_m={}, opt_state=None,
                  queue_query=jnp.asarray(state.queue_query.numpy()), queue_cand=jnp.asarray(state.queue_cand.numpy()),
                  queue_idx=jnp.full((12,), -100, jnp.int32), queue_ptr=jnp.zeros((), jnp.int32), tx=None)
    for i in range(4):  # 4 x 4 rows into 12: the fourth wraps to the start
        q, c = (rng.standard_normal((4, 8)).astype(np.float32) for _ in range(2))
        idx = np.arange(4, dtype=np.int64) + 10 * i
        js = js.enqueue(jnp.asarray(q), jnp.asarray(c), jnp.asarray(idx))
        state.enqueue(torch.from_numpy(q), torch.from_numpy(c), torch.from_numpy(idx))
        assert state.queue_ptr == int(js.queue_ptr) == (4 * (i + 1)) % 12
        torch.testing.assert_close(state.queue_query, torch.from_numpy(np.array(js.queue_query)), rtol=0, atol=STATE_ATOL)
        torch.testing.assert_close(state.queue_cand, torch.from_numpy(np.array(js.queue_cand)), rtol=0, atol=STATE_ATOL)
        assert state.queue_idx.tolist() == np.asarray(js.queue_idx).tolist()
    assert state.queue_idx[:4].tolist() == [30, 31, 32, 33]
    five = torch.zeros(5, 8)
    with pytest.raises(ValueError, match="divisible"):
        state.enqueue(five, five, torch.zeros(5, dtype=torch.int64))
    with pytest.raises(AssertionError, match="divisible"):
        js.enqueue(jnp.zeros((5, 8)), jnp.zeros((5, 8)), jnp.zeros(5, jnp.int32))


# ------------------------------------------------------------------- loss


@pytest.mark.parametrize("hard_neg_num", [0, 1])
@pytest.mark.parametrize("n_hosts", [1, 2])
def test_momentum_distill_loss_matches_jax(hard_neg_num, n_hosts):
    """A did repeated inside the batch and also present in the queue: the
    soft targets spread over all its copies on both sides."""
    import jax.numpy as jnp

    from uniir_tpu.train.losses import momentum_distill_contrastive_loss as jax_loss

    bs, D, Q = 6, 16, 12
    rng = np.random.default_rng(10 * hard_neg_num + n_hosts)
    n = (2 + hard_neg_num) * bs
    emb = rng.standard_normal((n, D)).astype(np.float32)
    emb_m = (emb + 0.1 * rng.standard_normal((n, D))).astype(np.float32)
    p_dids = np.array([7, 8, 7, 9, 10, 11], np.int64)  # 7 twice in the batch
    n_dids = (100 + np.arange(bs * hard_neg_num)).reshape(bs, hard_neg_num).astype(np.int64) if hard_neg_num else None
    qq, qc = (rng.standard_normal((Q, D)).astype(np.float32) for _ in range(2))
    qi = np.array([-100] * 4 + [7, 9, 3, 7, 12, 13, 14, 15], np.int64)  # 7 twice and 9 once in the queue
    temp, alpha = np.float32(0.07), np.float32(ALPHA)
    ref = jax_loss(jnp.asarray(emb), jnp.asarray(emb_m), bs, jnp.asarray(p_dids), jnp.asarray(qq), jnp.asarray(qc),
                   jnp.asarray(qi), jnp.asarray(temp), jnp.asarray(alpha), hard_neg_num,
                   None if n_dids is None else jnp.asarray(n_dids), n_hosts)
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    out = momentum_distill_contrastive_loss(t(emb), t(emb_m), bs, t(p_dids), t(qq), t(qc), t(qi), torch.tensor(temp),
                                            ALPHA, hard_neg_num, None if n_dids is None else t(n_dids), n_hosts)
    np.testing.assert_allclose(out["loss"].item(), float(ref["loss"]), rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert out["accuracy"].item() == pytest.approx(float(ref["accuracy"]), abs=1e-7)
    keys = ["enqueue_query", "enqueue_pos_cand"] + (["enqueue_neg_cand"] if hard_neg_num else [])
    for key in keys:
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), rtol=0, atol=LOSS_ATOL, err_msg=key)
    if not hard_neg_num:
        assert out["enqueue_neg_cand"] is None


def test_loss_gradient_reaches_the_online_rows_and_temp_only():
    rng = np.random.default_rng(3)
    emb = torch.from_numpy(rng.standard_normal((8, 8)).astype(np.float32)).requires_grad_()
    emb_m = torch.from_numpy(rng.standard_normal((8, 8)).astype(np.float32)).requires_grad_()
    temp = torch.tensor(0.07, requires_grad=True)
    queue = torch.nn.functional.normalize(torch.randn(8, 8), dim=1)
    out = momentum_distill_contrastive_loss(emb, emb_m, 4, torch.arange(4), queue, queue, torch.full((8,), -100),
                                            temp, ALPHA)
    out["loss"].backward()
    assert emb.grad.abs().sum() > 0 and temp.grad.abs() > 0 and emb_m.grad is None
    assert not out["enqueue_query"].requires_grad


# -------------------------------------------------------------- optimizer


def _grad_trees(params, n, seed=0):
    import jax

    rng = np.random.default_rng(seed)
    return [jax.tree_util.tree_map(lambda p: rng.standard_normal(np.shape(p)).astype(np.float32), params)
            for _ in range(n)]


def _run_optax(tx, params, grads):
    import jax
    import optax

    opt_state, update = tx.init(params), jax.jit(tx.update)
    for g in grads:
        updates, opt_state = update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
    return jax.tree_util.tree_map(np.asarray, params)


def _run_port(model, state, grads):
    for g in grads:
        sd = state_dict_from_jax(g)
        for key, p in _named(model):
            p.grad = sd[key].clone() if p.grad is None else p.grad + sd[key]
        state.apply_gradients()


@pytest.mark.parametrize("accum,warmup", [(1, 0), (1, 2), (2, 0)])
def test_blip_optimizer_matches_optax(jax_params, accum, warmup):
    """One AdamW group, decay 0.05 on every parameter (temp, LayerNorm and
    biases too), over 3 updates with the schedule and accumulation."""
    from uniir_tpu.train.optimizer import make_blip_optimizer as jax_optimizer

    params = jax_params["ff"]  # BLIP-FF: its cross-attention trains
    grads = _grad_trees(params, 3 * accum)
    want = state_dict_from_jax(_run_optax(jax_optimizer(params, LR, TOTAL_STEPS, warmup_steps=warmup,
                                                        accumulation_steps=accum), params, grads))
    model = _port_model("ff")
    model.load_state_dict(state_dict_from_jax(params))
    optimizer, scheduler = make_blip_optimizer(model, LR, TOTAL_STEPS, warmup_steps=warmup)
    assert len(optimizer.param_groups) == 1
    group = optimizer.param_groups[0]
    assert group["weight_decay"] == 0.05 and group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8
    assert len(group["params"]) == len(list(model.parameters()))
    state = MomentumTrainState.create(model, optimizer, scheduler, queue_size=QUEUE, embed_dim=MED.hidden_size,
                                      accumulation_steps=accum)
    _run_port(model, state, grads)
    for key, p in _named(model):
        torch.testing.assert_close(p.detach(), want[key], rtol=0, atol=ADAM_ATOL, msg=lambda m, key=key: f"{key}: {m}")


def test_blip_sf_freeze_mapping_matches_jax(jax_params):
    """The JAX optimizer's `crossattention` leaves -- given a tree that has
    them, as a BLIP checkpoint does -- are exactly the keys the port's
    BLIP-SF lacks, optax leaves them as they were, and every other leaf
    moves as the port's single group moves it."""
    import jax

    from uniir_tpu.train.optimizer import make_blip_optimizer as jax_optimizer

    params = jax.tree_util.tree_map(np.copy, jax_params["sf"])
    for layer in params["text_encoder"].values():
        if isinstance(layer, dict) and "attention" in layer:
            layer["crossattention"] = jax.tree_util.tree_map(lambda x: x + 0.5, layer["attention"])
    grads = _grad_trees(params, 3, seed=2)
    got = _run_optax(jax_optimizer(params, LR, TOTAL_STEPS, freeze_path_sub="crossattention"), params, grads)
    before, after = state_dict_from_jax(params), state_dict_from_jax(got)

    model = _port_model("sf")
    frozen = set(before) - set(model.state_dict())
    assert frozen and all(".crossattention." in key for key in frozen)
    assert frozen == {key for key in before if "crossattention" in key}
    for key in frozen:
        assert torch.equal(after[key], before[key]), key  # no step, no decay

    model.load_state_dict({k: v for k, v in before.items() if k not in frozen})
    optimizer, scheduler = make_blip_optimizer(model, LR, TOTAL_STEPS)
    state = MomentumTrainState.create(model, optimizer, scheduler, queue_size=QUEUE, embed_dim=SF_DIM)
    sf_grads = [jax.tree_util.tree_map(np.asarray, g) for g in grads]
    for g in sf_grads:
        sd = state_dict_from_jax(g)
        for key, p in _named(model):
            p.grad = sd[key].clone()
        state.apply_gradients()
    for key, p in _named(model):
        torch.testing.assert_close(p.detach(), after[key], rtol=0, atol=ADAM_ATOL, msg=lambda m, key=key: f"{key}: {m}")
    # a parameter with requires_grad=False is left out of the port's group
    model.temp.requires_grad_(False)
    group = make_blip_optimizer(model, LR, TOTAL_STEPS)[0].param_groups[0]
    assert all(p is not model.temp for p in group["params"])


# ------------------------------------------------------------- train steps


def _key_bias(key: str, t: torch.Tensor):
    """The elements of a key bias in `t`, or None: a key bias shifts every
    logit of a row by the same q.b_k, so its true gradient is 0 and both
    frameworks hold only rounding noise there (the ViT's fused qkv bias
    keeps it in its middle third, MED's attention in `key.bias`)."""
    if key.endswith("attn.qkv.bias"):
        W = t.numel() // 3
        return t[W : 2 * W]
    return t if key.endswith("self.key.bias") else None


def _assert_params_close(got: torch.Tensor, want: torch.Tensor, key: str, lr: float = LR):
    noise = _key_bias(key, got)
    if noise is not None:
        # Adam scales the noise to steps of about +-lr: within the 2 steps' bound, not compared
        assert (noise - _key_bias(key, want)).abs().max() <= 2 * 2 * 2 * lr, key
        if key.endswith("self.key.bias"):
            return
        keep = torch.ones(got.numel(), dtype=torch.bool)
        keep[got.numel() // 3 : 2 * got.numel() // 3] = False
        got, want = got[keep], want[keep]
    atol = STEP_ATOL * max(1.0, want.abs().max().item()) + 0.05 * lr
    torch.testing.assert_close(got, want, rtol=STEP_RTOL, atol=atol, msg=lambda m: f"{key}: {m}")


@pytest.mark.parametrize("name", ["sf", "ff"])
def test_two_fp32_train_steps_match_jax_without_dropout(jax_params, name):
    """Loss, accuracy, params, params_m, queues and queue_ptr after each of
    two steps against the JAX `make_blip_train_step(with_dropout=False)`,
    from the same state; the second batch repeats a did of the first, which
    is then in the queue."""
    from uniir_tpu.train.steps import make_blip_train_step as jax_train_step

    js = _jax_state(name, jax_params[name])
    state = _port_state(name, js)
    jax_step = jax_train_step(_jax_model(name), with_dropout=False)
    step = make_blip_train_step(state.model, with_dropout=False)
    batches = [_batch(seed=0), _batch(seed=1, dids=[1001, 2001, 2002, 2003])]
    for b in batches:
        js, jax_metrics = jax_step(js, b, np.float32(ALPHA))
        state, metrics = step(state, b, ALPHA)
        np.testing.assert_allclose(metrics["loss"].item(), float(jax_metrics["loss"]), rtol=STEP_RTOL, atol=STEP_ATOL)
        assert metrics["inbatch_accuracy"].item() == float(jax_metrics["inbatch_accuracy"])
        assert not state.model.training and not state.model_m.training
    want = _to_numpy(js)
    assert state.queue_ptr == int(want["queue_ptr"]) == 2 * BS and state.step == 2
    for key in ("queue_query", "queue_cand"):
        torch.testing.assert_close(getattr(state, key), torch.from_numpy(np.array(want[key])), rtol=STEP_RTOL, atol=STEP_ATOL)
    assert state.queue_idx.tolist() == want["queue_idx"].tolist()
    for tree, module in (("params", state.model), ("params_m", state.model_m)):
        ref = state_dict_from_jax(want[tree])
        for key, p in _named(module):
            _assert_params_close(p.detach(), ref[key], f"{tree} {key}")


def _jax_grads(name, params, js, batch, dtype):
    """(loss, gradients) of the JAX BLIP step's loss function at one batch,
    dropout off, against the state's twin and queues."""
    import jax
    import jax.numpy as jnp

    from uniir_tpu.train.losses import momentum_distill_contrastive_loss as jax_loss

    model = _jax_model(name, dtype)
    inputs = (batch["txt_batched"], batch["image_batched"], batch["txt_mask_batched"], batch["image_mask_batched"])
    emb_m = model.apply({"params": js.params_m}, *inputs)

    def loss_fn(p):
        emb = model.apply({"params": p}, *inputs)
        out = jax_loss(emb, emb_m, BS, batch["p_did_list"], js.queue_query, js.queue_cand, js.queue_idx,
                       p["temp"], jnp.float32(ALPHA))
        return out["loss"]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads))


@pytest.mark.parametrize("name", ["sf", "ff"])
def test_bf16_step_gradients_match_jax(jax_params, name):
    """bf16 compute over fp32 masters: the port's ViT attention through K1 /
    K3's twins, JAX's through its own path; gradient cosine >= 0.99."""
    js = _jax_state(name, jax_params[name])
    batch = _batch(seed=2)
    loss, grads = _jax_grads(name, jax_params[name], js, batch, "bf16")
    state = _port_state(name, js, torch.bfloat16)
    state.model.eval()
    out = blip_loss(state, batch, ALPHA)
    out["loss"].backward()
    assert abs(out["loss"].item() - loss) <= 2**-5 * max(1.0, abs(loss))  # one bf16 ulp of the loss
    largest = max(g.abs().max().item() for g in grads.values())
    for key, p in _named(state.model):
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, key
        if key.endswith("self.key.bias"):  # true gradient 0 (`_key_bias`): bf16 noise on both sides
            assert max(p.grad.abs().max().item(), grads[key].abs().max().item()) <= 1e-2 * largest, key
        else:
            assert _cosine(p.grad, grads[key]) >= BF16_MIN_COSINE, key


@pytest.mark.parametrize("name", ["sf", "ff"])
def test_eval_step_matches_jax_and_leaves_the_state_bit_equal(jax_params, name):
    import copy

    from uniir_tpu.train.steps import make_blip_eval_step as jax_eval_step
    from uniir_tpu.train.steps import make_blip_train_step as jax_train_step

    js = _jax_state(name, jax_params[name])
    state = _port_state(name, js)
    # one train step first, for an optimizer state to keep
    js, _ = jax_train_step(_jax_model(name), with_dropout=False)(js, _batch(seed=5), np.float32(ALPHA))
    state, _ = make_blip_train_step(state.model, with_dropout=False)(state, _batch(seed=5), ALPHA)
    # temp out of its range: the eval step clamps a copy
    js = js.replace(params={**js.params, "temp": np.float32(0.9)})
    state.model.temp.data.fill_(0.9)
    before = copy.deepcopy(state)
    batch = _batch(seed=6)
    ref = jax_eval_step(_jax_model(name))(js, batch, np.float32(ALPHA))
    out = make_blip_eval_step()(state, batch, ALPHA)
    np.testing.assert_allclose(out["loss"].item(), float(ref["loss"]), rtol=STEP_RTOL, atol=STEP_ATOL)
    assert out["inbatch_accuracy"].item() == float(ref["inbatch_accuracy"])
    _assert_state_equal(state, before)
    a, b = state.optimizer.state_dict(), before.optimizer.state_dict()
    for i, s in a["state"].items():
        for key, value in s.items():
            assert torch.equal(value, b["state"][i][key]), (i, key)


# ----------------------------------------------------------------- engine


def test_alpha_warms_up_over_epoch_zero_as_the_jax_engine():
    from uniir_tpu.train.engine import train_one_epoch as jax_train_one_epoch

    config = Config.from_dict({"trainer_config": {"print_freq": 0}, "evaluator": {"print_freq": 10}})
    batches = [{"x": np.zeros(1)} for _ in range(4)]
    for epoch in (0, 1):
        seen, jax_seen = [], []

        def step(state, batch, alpha, seen=seen):
            seen.append(alpha)
            return state, {"loss": torch.tensor(1.0)}

        def jax_step(state, batch, alpha, seen=jax_seen):
            seen.append(float(alpha))
            return state, {"loss": 1.0}

        train_one_epoch(step, None, [dict(b) for b in batches], epoch, config, is_blip=True, alpha=ALPHA)
        jax_train_one_epoch(jax_step, None, [dict(b) for b in batches], epoch, config, is_blip=True, alpha=ALPHA)
        want = [ALPHA * i / 4 for i in range(4)] if epoch == 0 else [ALPHA] * 4
        assert seen == pytest.approx(want, abs=0) and np.allclose(jax_seen, want, rtol=1e-7)

    calls = []
    stats = eval_engine(lambda state, batch, alpha: calls.append((state, alpha)) or {"loss": torch.tensor(2.0)},
                        batches, config, state="the state", alpha=ALPHA)
    assert calls == [("the state", ALPHA)] * 4 and float(stats["loss"]) == 2.0


# ---------------------------------------------------------------- dropout


DP_VIT = dataclasses.replace(VIT, drop_path_rate=0.1)  # drop-path on in the last block too


def _dropout_state(name, remat=False, seed=0, vit=DP_VIT, med=MED, dtype=torch.float32, device="cpu"):
    torch.manual_seed(seed)
    model = _port_model(name, dtype, remat, vit, med).to(device)
    return MomentumTrainState.create(model, *make_blip_optimizer(model, LR, TOTAL_STEPS), queue_size=QUEUE,
                                     embed_dim=_dim(name))


def _loss_and_grads(state, batch, seed, step=0):
    state.model.train()
    generator = torch.Generator(device=state.model.temp.device)
    state.model.set_dropout_generator(generator.manual_seed(steps_mod.step_seed(seed, step)))
    out = blip_loss(state, batch, ALPHA)
    out["loss"].backward()
    grads = {k: p.grad.clone() for k, p in _named(state.model) if p.grad is not None}
    state.model.zero_grad(set_to_none=True)
    return out["loss"].detach(), grads


@pytest.mark.parametrize("name", ["sf", "ff"])
def test_dropout_is_a_function_of_seed_and_step(name):
    state = _dropout_state(name)
    batch = _batch(seed=7)
    a, grads_a = _loss_and_grads(state, batch, seed=11)
    b, grads_b = _loss_and_grads(state, batch, seed=11)
    c, _ = _loss_and_grads(state, batch, seed=12)
    d, _ = _loss_and_grads(state, batch, seed=11, step=1)
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, d)
    assert grads_a.keys() == grads_b.keys() and all(torch.equal(grads_a[k], grads_b[k]) for k in grads_a)
    state.model.eval()
    plain = blip_loss(state, batch, ALPHA)["loss"].detach()
    assert not torch.equal(a, plain)  # dropout really acted
    # eval mode is the identity, generator or not
    emb = state.model(*steps_mod.model_inputs(batch, torch.device("cpu")))
    state.model.set_dropout_generator(None)
    assert torch.equal(emb, state.model(*steps_mod.model_inputs(batch, torch.device("cpu"))))
    x = torch.randn(5, 3)
    assert Dropout(0.1).eval()(x) is x and DropPath(0.1).eval()(x) is x


def test_every_dropout_draws_from_the_generator_it_was_given():
    model = _port_model("ff", vit=DP_VIT)
    g = torch.Generator()
    model.set_dropout_generator(g)
    drops = [m for m in model.modules() if isinstance(m, Dropout)]
    # embeddings + per layer: self-attention probabilities and output, cross-attention's two, FFN output
    assert len(drops) == 2 * DP_VIT.layers + 1 + 5 * MED.num_hidden_layers
    assert all(m.generator is g for m in drops) and not any(isinstance(m, torch.nn.Dropout) for m in model.modules())
    assert model.visual_encoder.dropout_generator is g and model.text_encoder.dropout_generator is g


def test_med_keep_rate_and_the_last_blocks_drop_path_rate():
    g = torch.Generator().manual_seed(0)
    drop = Dropout(MED.hidden_dropout_prob).train()
    drop.generator = g
    out = drop(torch.ones(400_000))
    kept = out != 0
    assert abs(kept.float().mean().item() - 0.9) <= 0.005
    torch.testing.assert_close(out[kept], torch.full((int(kept.sum()),), 1 / 0.9))

    with torch.device("meta"):
        vit = BLIPVisionTransformer(BLIP_VIT_CONFIGS["large"])
    rates = [blk.drop_path1.rate for blk in vit.blocks]
    assert rates[0] == 0.0 and rates[-1] == pytest.approx(0.1) and rates == sorted(rates)
    last = vit.blocks[-1].drop_path2
    path = DropPath(last.rate).train()
    path.generator = g
    out = path(torch.ones(40_000, 3, 4))
    dropped = (out[:, 0, 0] == 0).float()
    assert abs(dropped.mean().item() - 0.1) <= 0.005
    assert ((out == 0).all(dim=(1, 2)) | (out != 0).all(dim=(1, 2))).all()  # whole samples


def _assert_remat_is_bit_equal(**model):
    """BLIP-FF with remat against without, dropout on, the same seeds: loss
    and every gradient bit-equal, and after two train steps every parameter
    and the queues too."""
    batch = _batch(seed=8)
    results = []
    for remat in (False, True):
        state = _dropout_state("ff", remat=remat, **model)
        assert state.model.visual_encoder.remat_from_layer == (DP_VIT.layers if remat else 0)
        assert state.model.text_encoder.remat == remat
        results.append(_loss_and_grads(state, batch, seed=3))
    (loss, grads), (loss_r, grads_r) = results
    assert torch.equal(loss, loss_r)
    assert grads.keys() == grads_r.keys()
    for key, g in grads.items():
        assert torch.equal(g, grads_r[key]), key

    finals = []
    for remat in (False, True):
        state = _dropout_state("ff", remat=remat, **model)
        step = make_blip_train_step(state.model, seed=5)
        for seed in (9, 10):
            state, _ = step(state, _batch(seed=seed), ALPHA)
        finals.append(state)
    _assert_state_equal(*finals)


def test_blip_ff_with_remat_is_bit_equal_to_without_dropout_on():
    """The checkpointed ViT blocks and MED layers recompute with the masks
    their forward drew (a CPU generator)."""
    _assert_remat_is_bit_equal()


# ----------------------------------------------------------- enqueue coin


def _jax_coin(seed, step):
    import jax

    return bool(jax.random.bernoulli(jax.random.fold_in(jax.random.PRNGKey(seed + 1), step)))


def test_enqueue_coin_is_a_fair_coin_of_seed_and_step():
    draws = [enqueue_coin(2023, step) for step in range(400)]
    assert 160 <= sum(draws) <= 240
    assert draws == [enqueue_coin(2023, step) for step in range(400)]
    assert draws != [enqueue_coin(2024, step) for step in range(400)]


@pytest.mark.parametrize("coin", [True, False])
def test_enqueue_coin_forced_each_way_matches_jax(jax_params, monkeypatch, coin):
    """With a hard negative, heads enqueues the positives and tails the first
    negatives: the JAX step at a seed whose coin lands that way, the port's
    with its coin forced the same way."""
    from uniir_tpu.train.steps import make_blip_train_step as jax_train_step

    seed = next(s for s in range(64) if _jax_coin(s, 0) == coin)
    js = _jax_state("sf", jax_params["sf"])
    state = _port_state("sf", js)
    batch = _batch(seed=3, hard_neg_num=1)
    js, _ = jax_train_step(_jax_model("sf"), hard_neg_num=1, with_dropout=False, seed=seed)(js, batch, np.float32(ALPHA))
    monkeypatch.setattr(steps_mod, "enqueue_coin", lambda s, step: s == seed and step == 0 and coin)
    state, _ = make_blip_train_step(state.model, hard_neg_num=1, with_dropout=False, seed=seed)(state, batch, ALPHA)
    want = _to_numpy(js)
    idx = batch["p_did_list"] if coin else batch["nc_dids_list"][:, 0]
    assert state.queue_idx[:BS].tolist() == want["queue_idx"][:BS].tolist() == idx.tolist()
    for key in ("queue_query", "queue_cand"):
        torch.testing.assert_close(getattr(state, key), torch.from_numpy(np.array(want[key])), rtol=STEP_RTOL, atol=STEP_ATOL)


# ---------------------------------------------------------------- trainer


def _train_config(root, name, epochs, resume_from=""):
    from tests.helpers import tiny_bert_vocab

    vocab = os.path.join(root, "vocab.txt")
    with open(vocab, "w") as f:
        f.write("\n".join(tiny_bert_vocab()) + "\n")
    short = "TEST_BLIP_SF" if name == "BLIPScoreFusion" else "TEST_BLIP_FF"
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
                           "warmup_steps": 0, "print_freq": 1, "weight_decay": 0.05},
        "evaluator": {"enable_eval": True, "eval_freq": 1, "print_freq": 10},
        "model": {
            "name": name, "short_name": short, "size": "Tiny", "bf16": False, "vit": "test-tiny",
            "embed_dim": SF_DIM if name == "BLIPScoreFusion" else MED.hidden_size, "queue_size": QUEUE,
            "momentum": 0.995, "alpha": ALPHA, "tokenizer_max_length": SEQ, "bert_vocab_path": vocab,
            "vit_grad_ckpt": name == "BLIPFeatureFusion",
            "ckpt_config": {"ckpt_dir": "checkpoint/test/", "resume_training": bool(resume_from),
                            "ckpt_name": resume_from},
        },
    })


def _bundle(config):
    """The registry's BLIP model for training, with the tests' cheap tokenizer and image transform."""
    from tests.helpers import identity_image_transform, simple_bert_tokenizer
    from tests.torch_helpers import on_array
    from uniir_tpu_torch.models.registry import ModelBundle, build_model_from_config

    bundle = build_model_from_config(config, device="cpu", train=True)
    img_fn = on_array(identity_image_transform(VIT.image_size))
    return ModelBundle(bundle.name, bundle.model, simple_bert_tokenizer(max_len=SEQ, vocab_size=MED.vocab_size),
                       img_fn, img_fn, bundle.image_size, bundle.embed_dim, bundle.extra)


@pytest.mark.parametrize("name", ["BLIPScoreFusion", "BLIPFeatureFusion"])
def test_trainer_trains_resumes_bit_equal_and_serves(tmp_path, name):
    """Two epochs straight against one epoch, a checkpoint and a resumed
    second epoch: parameters, twin, queues and pointer bit-equal; then the
    trained checkpoint serves through the registry."""
    from tests.helpers import build_mbeir_fixture
    from uniir_tpu_torch.models.registry import build_model_from_config
    from uniir_tpu_torch.train import trainer
    from uniir_tpu_torch.train.steps import make_embed_step

    root = str(tmp_path)
    build_mbeir_fixture(os.path.join(root, "mbeir_data"), n_queries=16, n_cands=24)
    setup = trainer.build_train_setup(_train_config(root, name, 1), device="cpu")  # the registry's model
    state = setup["state"]
    assert setup["is_blip"] and isinstance(state, MomentumTrainState) and state.queue_query.shape[0] == QUEUE
    assert state.model.training and all(p.dtype == torch.float32 for p in state.model.parameters())
    assert state.model.visual_encoder.remat_from_layer == (VIT.layers if name == "BLIPFeatureFusion" else 0)
    assert [g["weight_decay"] for g in state.optimizer.param_groups] == [0.05]

    straight = trainer.main(_train_config(root, name, 2), bundle=_bundle(_train_config(root, name, 2)))
    assert straight["state"].step == 4 and straight["state"].queue_ptr == 0  # 4 steps x 8 = twice the queue
    assert (straight["state"].queue_idx >= 0).all() and "val_loss" in straight["stats"]
    # dropout on: the generator was seeded from (config.seed, the step count) at the top of the last step
    assert straight["state"].model.visual_encoder.dropout_generator.initial_seed() == steps_mod.step_seed(2023, 3)
    # the straight run's epoch-0 checkpoint, resumed: the second epoch again
    config = _train_config(root, name, 2, resume_from=f"{config_short(name)}_epoch_0")
    second = trainer.main(config, bundle=_bundle(config))
    assert second["stats"]["epoch"] == 1 and second["state"].step == 4
    _assert_state_equal(straight["state"], second["state"])

    serve = _train_config(root, name, 2)
    serve.model.ckpt_config.ckpt_name = f"{config_short(name)}_epoch_1"
    served = build_model_from_config(serve, device="cpu")
    assert not served.model.training
    for (key, p), q in zip(second["state"].model.named_parameters(), served.model.parameters()):
        assert torch.equal(p, q), key
    emb = make_embed_step(served.model)(_batch())
    assert emb.shape == (2 * BS, _dim("sf" if name == "BLIPScoreFusion" else "ff")) and torch.isfinite(emb.float()).all()


def config_short(name):
    return "test_blip_sf" if name == "BLIPScoreFusion" else "test_blip_ff"


def test_checkpoint_keeps_the_twin_and_the_queues(tmp_path):
    state = _dropout_state("sf")
    state, _ = make_blip_train_step(state.model, seed=1)(state, _batch(), ALPHA)
    path = save_train_checkpoint(str(tmp_path), "blip_sf", state, 0)
    assert sorted(os.listdir(path)) == [CHECKPOINT_FILE, "meta.json"]
    fresh, epoch = load_train_checkpoint(path, _dropout_state("sf", seed=1))
    assert epoch == 0
    _assert_state_equal(state, fresh)
    blob = torch.load(os.path.join(path, CHECKPOINT_FILE), weights_only=True)
    assert set(blob) >= {"model", "model_m", "queue_query", "queue_cand", "queue_idx", "queue_ptr"}
    assert not any(k.endswith("_m") for k in blob["model"])  # the serving loaders read `model` alone


# -------------------------------------------------------------------- GPU


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (kernels K1 and K3 have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,H", [(64, 197, 16), (4, 17, 2)])
def test_k3_matches_its_twin_at_blip_shapes(cuda, B, L, H):
    """K3 at the BLIP ViT-L's [64, 197, 1024] H16 (three whole 64-row tiles
    and one of 5 rows) and at a tiny BLIP length, L = 17, at head width 64:
    within 1e-2 of the largest element and cosine >= 0.9999 (the limits of
    `chip_smoke.py`'s K3 check)."""
    from uniir_tpu_torch.ops import attention as A

    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v, do = (torch.randn(B, L, H * 64, generator=g, device=cuda).bfloat16() for _ in range(4))
    before = A.attention_bwd.launches
    out = A.attention_bwd(q, k, v, do, H)
    assert A.attention_bwd.launches == before + 1
    ref = A.attention_bwd_reference(q, k, v, do, H)
    for o, r in zip(out, ref):
        assert (o.float() - r.float()).abs().max().item() <= 1e-2 * max(1.0, r.abs().max().item())
        assert _cosine(o, r) >= 0.9999


@pytest.mark.gpu
def test_blip_large_train_step_kernels_match_twins(cuda):
    """One seeded BLIP-SF `large` loss and gradient (4 pairs, dropout off)
    through K1 / K3 and through their twins: gradient cosine >= 0.99 (MED's
    key biases, whose true gradient is 0, held to rounding noise)."""
    from uniir_tpu_torch.models import layers
    from uniir_tpu_torch.models.registry import seeded_blip_sf_train
    from uniir_tpu_torch.ops import attention as attn_mod

    vit, med = BLIP_VIT_CONFIGS["large"], MED_CONFIGS["large"]
    model = seeded_blip_sf_train(vit, med, cuda, seed=0)
    state = MomentumTrainState.create(model, *make_blip_optimizer(model, 1e-5, 10), queue_size=64, embed_dim=768)
    model.eval()
    rng = np.random.default_rng(0)
    n = 8
    batch = {
        "txt_batched": {"input_ids": rng.integers(4, med.vocab_size, (n, 50)).astype(np.int32),
                        "attention_mask": np.ones((n, 50), np.int32)},
        "image_batched": rng.standard_normal((n, vit.image_size, vit.image_size, 3)).astype(np.float32),
        "txt_mask_batched": np.ones(n, np.int32), "image_mask_batched": np.ones(n, np.int32),
        "p_did_list": np.arange(n // 2, dtype=np.int64),
    }
    params = list(model.parameters())
    before = (attn_mod.attention.launches, attn_mod.attention_bwd.launches)
    out = blip_loss(state, batch, ALPHA)
    grads = torch.autograd.grad(out["loss"], params)
    blocks = vit.layers - 1  # the trimmed last block and MED take the einsum path
    assert (attn_mod.attention.launches, attn_mod.attention_bwd.launches) == (before[0] + 2 * blocks, before[1] + blocks)
    layers.attention = attn_mod.attention_twin
    try:
        ref = blip_loss(state, batch, ALPHA)
        ref_grads = torch.autograd.grad(ref["loss"], params)
    finally:
        layers.attention = attn_mod.attention
    assert abs(out["loss"].item() - ref["loss"].item()) <= 1e-2
    largest = max(r.abs().max().item() for r in ref_grads)
    for (key, _), g, r in zip(_named(model), grads, ref_grads):
        assert torch.isfinite(g).all(), key
        if key.endswith("self.key.bias"):  # true gradient 0 (`_key_bias`): rounding noise on both sides
            assert max(g.abs().max().item(), r.abs().max().item()) <= 1e-2 * largest, key
        elif g.numel() > 1:
            assert _cosine(g, r) >= BF16_MIN_COSINE, key


@pytest.mark.gpu
def test_blip_ff_with_remat_is_bit_equal_to_without_dropout_on_gpu(cuda):
    """The remat test on the card, as the trainer runs it there: a CUDA
    generator (its Philox seed and offset saved and set again around each
    recompute), bf16 compute and the ViT's attention through K1 forward /
    K3 backward (head width 64, L = 17).  K1 and K3 are deterministic, so
    loss, gradients and two train steps' parameters stay bit-equal."""
    from uniir_tpu_torch.ops import attention as attn_mod

    vit = dataclasses.replace(DP_VIT, width=128)  # 2 heads of 64
    before = (attn_mod.attention.launches, attn_mod.attention_bwd.launches)
    _assert_remat_is_bit_equal(vit=vit, med=dataclasses.replace(MED, encoder_width=vit.width), dtype=torch.bfloat16,
                               device=cuda)
    assert attn_mod.attention.launches > before[0] and attn_mod.attention_bwd.launches > before[1]
