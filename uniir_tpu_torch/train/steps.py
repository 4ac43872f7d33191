"""Train and eval steps (CLIP-SF, CLIP-FF) and the embed step (all four
retrievers): the counterpart of uniir_tpu/train/steps.py.

A step takes a collated batch (numpy arrays or tensors) and runs eagerly on
the model's device.  The train step's forward goes through kernel K1 (K10
where the model was built with `attn_splitk`) and its backward through K3
(`ops.attention`).  Metrics come back as 0-d device tensors, so a loop can
defer fetching them (`train.engine`).  No GradScaler: bf16 needs no loss
scaling.

CLIP-FF's T5 fusion stack is the one part with stochastic layers.  The
train step puts it in train mode only `with_dropout`, and its dropout then
draws from one `torch.Generator` on the model's device, seeded anew from
(`seed`, `state.step`) at the top of every step -- the counterpart of
`fold_in(PRNGKey(seed), state.step)` -- so a resumed run draws the masks the
uninterrupted run would have drawn and a checkpoint saves no generator
state.  The eval and embed steps run the stack in eval mode, deterministic.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from uniir_tpu_torch.train.losses import inbatch_contrastive_loss
from uniir_tpu_torch.train.state import TrainState


def _to_device(x, device: torch.device):
    """A collated array (numpy or tensor) on `device`; BLIP's text input, a
    dict {"input_ids", "attention_mask"}, moves entry by entry."""
    if isinstance(x, dict):
        return {key: _to_device(value, device) for key, value in x.items()}
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x).to(device)


def model_inputs(batch: Dict[str, Any], device: torch.device):
    """(txt, image, txt_mask, image_mask) of a collated batch, on `device`."""
    return tuple(
        _to_device(batch[key], device)
        for key in ("txt_batched", "image_batched", "txt_mask_batched", "image_mask_batched")
    )


def infer_flat_bs(batch: Dict[str, Any], hard_neg_num: int) -> int:
    """Static per-batch query count from the flat layout N = bs * (2 + neg)."""
    n_rows = batch["image_batched"].shape[0]
    bs = n_rows // (2 + hard_neg_num)
    if bs * (2 + hard_neg_num) != n_rows:
        raise ValueError(f"{n_rows} rows do not split into queries, positives and {hard_neg_num} negatives each")
    return bs


def clip_loss(model: torch.nn.Module, batch: Dict[str, Any], hard_neg_num: int = 0, in_batch_neg_num: int = 0):
    """The train step's forward: {"loss", "accuracy"} of one collated batch."""
    emb = model(*model_inputs(batch, model.logit_scale.device))
    return inbatch_contrastive_loss(
        emb, infer_flat_bs(batch, hard_neg_num), model.logit_scale.exp(), hard_neg_num, in_batch_neg_num
    )


def _set_fusion_mode(model: torch.nn.Module, training: bool) -> None:
    """Train / eval mode of the T5 fusion stack, if the model has one (the
    CLIP towers have no stochastic layer)."""
    fusion = getattr(model, "t5_layers", None)
    if fusion is not None:
        fusion.train(training)


def step_seed(seed: int, step: int) -> int:
    """The dropout generator's seed for micro-batch `step` of a run seeded
    with `seed`: a function of the pair alone, distinct across both."""
    return int(np.random.SeedSequence([int(seed), int(step)]).generate_state(1, np.uint64)[0] >> np.uint64(1))


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
    `state.step`), `seed` being config.seed."""
    generator = None
    if with_dropout:
        if not hasattr(model, "t5_layers"):
            raise ValueError(f"with_dropout: {type(model).__name__} has no stochastic layer")
        generator = torch.Generator(device=model.logit_scale.device)

    def step(state: TrainState, batch: Dict[str, Any]):
        _set_fusion_mode(model, with_dropout)
        if generator is not None:
            model.t5_layers.set_dropout_generator(generator.manual_seed(step_seed(seed, state.step)))
        out = clip_loss(model, batch, hard_neg_num, in_batch_neg_num)
        out["loss"].backward()
        state.apply_gradients()
        return state, {"loss": out["loss"].detach(), "inbatch_accuracy": out["accuracy"]}

    return step


def make_clip_eval_step(model: torch.nn.Module, hard_neg_num: int = 0, in_batch_neg_num: int = 0) -> Callable:
    """No-grad twin of the train step: step(batch) -> {"loss", "inbatch_accuracy"}."""

    def step(batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        _set_fusion_mode(model, False)
        with torch.inference_mode():
            out = clip_loss(model, batch, hard_neg_num, in_batch_neg_num)
        return {"loss": out["loss"], "inbatch_accuracy": out["accuracy"]}

    return step


def make_embed_step(model: torch.nn.Module, out_dtype: torch.dtype = torch.float16) -> Callable:
    """Embedding forward for the eval pipeline: the model's compute dtype in,
    `out_dtype` (fp16 artifacts on disk, reference mbeir_embedder.py:56,110) out.

    step(batch) takes a collated numpy batch and returns a tensor on the
    model's device."""
    device = next(model.parameters()).device

    def step(batch: Dict[str, Any]) -> torch.Tensor:
        _set_fusion_mode(model, False)  # deterministic, as the eval step
        with torch.inference_mode():
            return model(*model_inputs(batch, device)).to(out_dtype)

    return step
