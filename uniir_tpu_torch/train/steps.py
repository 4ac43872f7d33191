"""Train and eval steps of the four retrievers and the embed step: the
counterpart of uniir_tpu/train/steps.py.

A step takes a collated batch (numpy arrays or tensors) and runs eagerly on
the model's device.  The train steps' forwards go through kernel K1 (K10
where a CLIP model was built with `attn_splitk`) and their backwards
through K3 (`ops.attention`).  Metrics come back as 0-d device tensors, so a
loop can defer fetching them (`train.engine`).  No GradScaler: bf16 needs
no loss scaling.

Dropout draws from one `torch.Generator` on the model's device, seeded
anew from (`seed`, `state.step`) at the top of every step -- the
counterpart of `fold_in(PRNGKey(seed), state.step)` -- so a resumed run
draws the masks the uninterrupted run would have drawn and a checkpoint
saves no generator state.  Over several processes the rank is folded into
the seed as well, so two ranks draw different masks for their local row i,
as JAX's global-array dropout draws a mask for every row of the global
batch; one process keeps the (`seed`, `state.step`) stream.  The masks
cannot equal flax's, bit for bit.
CLIP-FF's T5 fusion stack is the CLIP family's one stochastic part: the
CLIP train step puts it in train mode only `with_dropout`.  BLIP's train
step (on by default, as the JAX trainer runs it) puts the whole online
model in train mode: the ViT's drop-path and MED's dropout.  The eval and
embed steps are deterministic.

BLIP's step keeps the JAX order of work: clamp `temp` to [0.001, 0.5] in
place, the EMA update of the momentum twin, the twin's forward (eval mode,
no gradient), the online forward, the momentum-distilled loss, backward and
update, then the enqueue.  With hard negatives a fair coin picks whether
the positives or the first hard negatives are enqueued; it is drawn on the
host from a generator seeded with (`seed` + 1, `state.step`), the
counterpart of `fold_in(PRNGKey(seed + 1), step)`, and cannot match JAX's
draw bit for bit either.  The coin is one decision for the global batch:
it does not depend on the rank.

Over several processes (`core.mesh`) each rank holds its block of the
host-major global batch.  The steps take `n_hosts = process_count()`, as
the JAX steps take `jax.process_count()`: the rank's embeddings (and
BLIP's momentum embeddings and dids, without a gradient) are gathered
with `gather_rows`, every rank computes the JAX global loss, and the
update averages the gradients over the ranks (`TrainState.
apply_gradients`).  The metrics are global and equal on every rank.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from uniir_tpu_torch.core import mesh
from uniir_tpu_torch.train.losses import inbatch_contrastive_loss, momentum_distill_contrastive_loss
from uniir_tpu_torch.train.state import MomentumTrainState, TrainState


def to_device(x, device: torch.device):
    """A collated array (numpy or tensor) on `device`; BLIP's text input, a
    dict {"input_ids", "attention_mask"}, moves entry by entry."""
    if isinstance(x, dict):
        return {key: to_device(value, device) for key, value in x.items()}
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x).to(device)


def model_inputs(batch: Dict[str, Any], device: torch.device):
    """(txt, image, txt_mask, image_mask) of a collated batch, on `device`."""
    return tuple(
        to_device(batch[key], device)
        for key in ("txt_batched", "image_batched", "txt_mask_batched", "image_mask_batched")
    )


def infer_flat_bs(batch: Dict[str, Any], hard_neg_num: int) -> int:
    """Static per-batch query count from the flat layout N = bs * (2 + neg)."""
    n_rows = batch["image_batched"].shape[0]
    bs = n_rows // (2 + hard_neg_num)
    if bs * (2 + hard_neg_num) != n_rows:
        raise ValueError(f"{n_rows} rows do not split into queries, positives and {hard_neg_num} negatives each")
    return bs


def clip_loss(model: torch.nn.Module, batch: Dict[str, Any], hard_neg_num: int = 0, in_batch_neg_num: int = 0,
              n_hosts: int = 1):
    """The train step's forward: {"loss", "accuracy"} of one collated batch;
    with `n_hosts` > 1 `batch` is this rank's block of the global batch,
    whose loss it returns."""
    emb = model(*model_inputs(batch, model.logit_scale.device))
    if n_hosts > 1:
        emb = mesh.gather_rows(emb)
    return inbatch_contrastive_loss(
        emb, infer_flat_bs(batch, hard_neg_num) * n_hosts, model.logit_scale.exp(), hard_neg_num, in_batch_neg_num,
        n_hosts,
    )


def _set_fusion_mode(model: torch.nn.Module, training: bool) -> None:
    """Train / eval mode of the T5 fusion stack, if the model has one (the
    CLIP towers have no stochastic layer)."""
    fusion = getattr(model, "t5_layers", None)
    if fusion is not None:
        fusion.train(training)


def step_seed(seed: int, step: int, rank: Optional[int] = None) -> int:
    """The dropout generator's seed for micro-batch `step` of a run seeded
    with `seed`: a function of the pair alone, distinct across both; with
    `rank` (a run over several processes) of the triple."""
    entropy = [int(seed), int(step)] + ([] if rank is None else [int(rank)])
    return int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0] >> np.uint64(1))


def _dropout_seed(seed: int, step: int, n_hosts: int) -> int:
    """`step_seed` of this rank: the rank folded in over several processes."""
    return step_seed(seed, step, mesh.process_index() if n_hosts > 1 else None)


def make_clip_train_step(
    model: torch.nn.Module,
    hard_neg_num: int = 0,
    in_batch_neg_num: int = 0,
    with_dropout: bool = False,
    seed: int = 0,
) -> Callable[[TrainState, Dict[str, Any]], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Train step for the CLIP family (SF and FF share the loss): forward,
    in-batch contrastive loss, backward and one `TrainState.apply_gradients`.
    step(state, batch) returns (state, {"loss", "inbatch_accuracy"}) with the
    metrics as device tensors.  `with_dropout` switches on CLIP-FF's fusion
    dropout, drawn from a generator that every step seeds from (`seed`,
    `state.step`, and the rank over several processes), `seed` being
    config.seed."""
    n_hosts = mesh.process_count()
    generator = None
    if with_dropout:
        if not hasattr(model, "t5_layers"):
            raise ValueError(f"with_dropout: {type(model).__name__} has no stochastic layer")
        generator = torch.Generator(device=model.logit_scale.device)

    def step(state: TrainState, batch: Dict[str, Any]):
        _set_fusion_mode(model, with_dropout)
        if generator is not None:
            model.t5_layers.set_dropout_generator(generator.manual_seed(_dropout_seed(seed, state.step, n_hosts)))
        out = clip_loss(model, batch, hard_neg_num, in_batch_neg_num, n_hosts)
        out["loss"].backward()
        state.apply_gradients()
        return state, {"loss": out["loss"].detach(), "inbatch_accuracy": out["accuracy"]}

    return step


def make_clip_eval_step(model: torch.nn.Module, hard_neg_num: int = 0, in_batch_neg_num: int = 0) -> Callable:
    """No-grad twin of the train step: step(batch) -> {"loss", "inbatch_accuracy"}."""
    n_hosts = mesh.process_count()

    def step(batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        _set_fusion_mode(model, False)
        with torch.inference_mode():
            out = clip_loss(model, batch, hard_neg_num, in_batch_neg_num, n_hosts)
        return {"loss": out["loss"], "inbatch_accuracy": out["accuracy"]}

    return step


def enqueue_coin(seed: int, step: int) -> bool:
    """With hard negatives, whether micro-batch `step` enqueues the positives
    (True) or the first hard negatives: a fair coin from a host generator
    seeded with step_seed(seed + 1, step)."""
    generator = torch.Generator().manual_seed(step_seed(seed + 1, step))
    return bool(torch.rand((), generator=generator) < 0.5)


def blip_loss(state: MomentumTrainState, batch: Dict[str, Any], alpha, hard_neg_num: int = 0,
              temp: Optional[torch.Tensor] = None, n_hosts: int = 1) -> Dict[str, torch.Tensor]:
    """The momentum twin's forward (no gradient), the online model's forward
    in the mode it is in, and the momentum-distilled loss against the
    queues; `temp` defaults to the model's parameter.  With `n_hosts` > 1
    `batch` is this rank's block: both models' rows and the dids are
    gathered into the global batch.  The global dids come back as "p_dids"
    and "n_dids" beside the loss."""
    device = state.queue_query.device
    inputs = model_inputs(batch, device)
    p_dids = to_device(batch["p_did_list"], device)
    n_dids = to_device(batch["nc_dids_list"], device) if hard_neg_num > 0 else None
    with torch.no_grad():
        emb_m = state.model_m(*inputs)
    emb = state.model(*inputs)
    if n_hosts > 1:
        with torch.no_grad():
            emb_m, p_dids = mesh.gather_rows(emb_m), mesh.gather_rows(p_dids)
            n_dids = None if n_dids is None else mesh.gather_rows(n_dids)
        emb = mesh.gather_rows(emb)
    out = momentum_distill_contrastive_loss(
        emb, emb_m, infer_flat_bs(batch, hard_neg_num) * n_hosts, p_dids,
        state.queue_query, state.queue_cand, state.queue_idx, state.model.temp if temp is None else temp, alpha,
        hard_neg_num=hard_neg_num, n_dids=n_dids, n_hosts=n_hosts,
    )
    return dict(out, p_dids=p_dids, n_dids=n_dids)


def make_blip_train_step(
    model: torch.nn.Module, hard_neg_num: int = 0, with_dropout: bool = True, seed: int = 0
) -> Callable[[MomentumTrainState, Dict[str, Any], float], Tuple[MomentumTrainState, Dict[str, torch.Tensor]]]:
    """Train step for the BLIP family (SF and FF share it).  step(state,
    batch, alpha) returns (state, {"loss", "inbatch_accuracy"}); `alpha`,
    the distillation weight, is passed per step (the engine warms it up in
    epoch 0).  `with_dropout` switches the online model's drop-path and
    dropout on, drawn from a generator that every step seeds from (`seed`,
    `state.step`, and the rank over several processes), `seed` being
    config.seed.  Every rank enqueues the same global rows, so the queues
    stay equal across the ranks."""
    n_hosts = mesh.process_count()
    generator = torch.Generator(device=model.temp.device) if with_dropout else None

    def step(state: MomentumTrainState, batch: Dict[str, Any], alpha):
        model = state.model
        with torch.no_grad():
            model.temp.clamp_(0.001, 0.5)
        state.momentum_update()
        state.model_m.eval()
        model.train(with_dropout)
        if generator is not None:
            model.set_dropout_generator(generator.manual_seed(_dropout_seed(seed, state.step, n_hosts)))
        out = blip_loss(state, batch, alpha, hard_neg_num, n_hosts=n_hosts)
        out["loss"].backward()
        coin_step = state.step
        state.apply_gradients()
        cand, idx = out["enqueue_pos_cand"], out["p_dids"]
        if hard_neg_num > 0 and not enqueue_coin(seed, coin_step):
            cand, idx = out["enqueue_neg_cand"], out["n_dids"][:, 0]
        state.enqueue(out["enqueue_query"], cand, idx)
        return state, {"loss": out["loss"].detach(), "inbatch_accuracy": out["accuracy"]}

    return step


def make_blip_eval_step(hard_neg_num: int = 0) -> Callable:
    """No-grad BLIP eval: step(state, batch, alpha) -> {"loss",
    "inbatch_accuracy"} against the current queues, both models in eval
    mode and `temp` clamped out of place.  It changes nothing of the state
    (PARITY row 3: the reference snapshots and restores it around eval)."""
    n_hosts = mesh.process_count()

    def step(state: MomentumTrainState, batch: Dict[str, Any], alpha) -> Dict[str, torch.Tensor]:
        state.model.eval()
        state.model_m.eval()
        with torch.inference_mode():
            out = blip_loss(state, batch, alpha, hard_neg_num, temp=state.model.temp.clamp(0.001, 0.5),
                            n_hosts=n_hosts)
        return {"loss": out["loss"], "inbatch_accuracy": out["accuracy"]}

    return step


def make_embed_step(model: torch.nn.Module, out_dtype: torch.dtype = torch.float16) -> Callable:
    """Embedding forward for the eval pipeline: the model's compute dtype in,
    `out_dtype` (fp16 artifacts on disk, reference mbeir_embedder.py:56,110) out.

    step(batch) takes a collated numpy batch and returns a tensor on the
    model's device."""
    device = next(model.parameters()).device

    def step(batch: Dict[str, Any]) -> torch.Tensor:
        model.eval()  # deterministic, whatever mode a train step left the model in
        with torch.inference_mode():
            return model(*model_inputs(batch, device)).to(out_dtype)

    return step
