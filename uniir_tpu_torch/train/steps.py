"""Train, eval and embed steps (counterpart of uniir_tpu/train/steps.py, CLIP-SF).

A step takes a collated batch (numpy arrays or tensors) and runs eagerly on
the model's device.  The train step's forward goes through kernel K1 and
its backward through K3 (`ops.attention`).  Metrics come back as 0-d
device tensors, so a loop can defer fetching them (`train.engine`).  No
GradScaler: bf16 needs no loss scaling.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from uniir_tpu_torch.train.losses import inbatch_contrastive_loss
from uniir_tpu_torch.train.state import TrainState


def _model_inputs(batch: Dict[str, Any], device: torch.device):
    return tuple(
        torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x).to(device)
        for x in (batch[key] for key in ("txt_batched", "image_batched", "txt_mask_batched", "image_mask_batched"))
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
    emb = model(*_model_inputs(batch, model.logit_scale.device))
    return inbatch_contrastive_loss(
        emb, infer_flat_bs(batch, hard_neg_num), model.logit_scale.exp(), hard_neg_num, in_batch_neg_num
    )


def make_clip_train_step(
    model: torch.nn.Module,
    hard_neg_num: int = 0,
    in_batch_neg_num: int = 0,
    with_dropout: bool = False,
) -> Callable[[TrainState, Dict[str, Any]], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Train step for CLIP-SF: forward, in-batch contrastive loss, backward
    and one `TrainState.apply_gradients`.  step(state, batch) returns
    (state, {"loss", "inbatch_accuracy"}) with the metrics as device tensors."""
    if with_dropout:
        raise NotImplementedError(
            "stochastic layers belong to CLIP-FF's T5 fusion, which is not ported to uniir_tpu_torch yet "
            "(ROADMAP.md, Queue 1 item 4)"
        )

    def step(state: TrainState, batch: Dict[str, Any]):
        out = clip_loss(model, batch, hard_neg_num, in_batch_neg_num)
        out["loss"].backward()
        state.apply_gradients()
        return state, {"loss": out["loss"].detach(), "inbatch_accuracy": out["accuracy"]}

    return step


def make_clip_eval_step(model: torch.nn.Module, hard_neg_num: int = 0, in_batch_neg_num: int = 0) -> Callable:
    """No-grad twin of the train step: step(batch) -> {"loss", "inbatch_accuracy"}."""

    def step(batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
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
        with torch.inference_mode():
            return model(*_model_inputs(batch, device)).to(out_dtype)

    return step
