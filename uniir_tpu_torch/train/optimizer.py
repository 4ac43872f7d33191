"""AdamW in the CLIP parameter groups, BLIP's single AdamW group and the
cosine schedule (counterpart of uniir_tpu/train/optimizer.py).

Parameters with ndim < 2, or whose name contains bn / ln / bias /
logit_scale, get no weight decay; the rest get `weight_decay` (0.2 for
CLIP) -- the reference's split AdamW groups, which the JAX package writes
as an optax decay mask.  `torch.optim.AdamW` with betas (0.9, 0.98) and eps
1e-6 computes optax.adamw's update (decay on the pre-update parameter).
The schedule is optax's cosine decay to 0 over the optimizer updates, with
an optional linear warm-up from 0, evaluated at the update count before
each update.  CLIP-FF adds a group: parameters whose name contains "t5"
(the fusion stack) train at `fusion_learning_rate` on a cosine schedule of
their own, with the same decay split -- the JAX package's
optax.multi_transform over {backbone, fusion}.  Gradient accumulation (optax.MultiSteps' meaning: the mean
of k micro-batch gradients, one update every k micro-batches) lives in
`train.state.TrainState`.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

_NO_DECAY_SUBSTRINGS = ("bn", "ln", "bias", "logit_scale")


def clip_decay_mask(model: nn.Module) -> Dict[str, bool]:
    """Parameter name -> True where weight decay applies."""
    return {
        name: not (p.ndim < 2 or any(s in name.lower() for s in _NO_DECAY_SUBSTRINGS))
        for name, p in model.named_parameters()
    }


def cosine_schedule(lr: float, total_steps: int, warmup_steps: int = 0) -> Callable[[int], float]:
    """Learning rate at update `count` (0-based): optax's
    warmup_cosine_decay_schedule(0, lr, warmup_steps, total_steps, 0) when
    warmup_steps > 0, else cosine_decay_schedule(lr, max(1, total_steps))."""
    decay_steps = total_steps - warmup_steps if warmup_steps > 0 else max(1, total_steps)
    if decay_steps <= 0:
        raise ValueError(f"total_steps={total_steps} must exceed warmup_steps={warmup_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return lr * count / warmup_steps
        t = min(count - warmup_steps, decay_steps)
        return lr * 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))

    return schedule


def make_clip_optimizer(
    model: nn.Module,
    learning_rate: float,
    total_steps: int,
    weight_decay: float = 0.2,
    warmup_steps: int = 0,
    fusion_learning_rate: Optional[float] = None,
    fusion_name_sub: str = "t5",
) -> Tuple[torch.optim.AdamW, torch.optim.lr_scheduler.LambdaLR]:
    """AdamW(betas=(0.9, 0.98), eps=1e-6) over the CLIP groups, and its
    per-update cosine schedules: {decay, no decay} at `learning_rate`, and
    with `fusion_learning_rate` the same pair for the parameters whose name
    contains `fusion_name_sub`, at that rate."""
    mask = clip_decay_mask(model)
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    rates = {False: learning_rate}
    if fusion_learning_rate is not None:
        rates[True] = fusion_learning_rate

    def is_fusion(name: str) -> bool:
        return fusion_learning_rate is not None and fusion_name_sub in name.lower()

    groups = [
        {"params": [p for n, p in named if is_fusion(n) == fusion and mask[n] == decay],
         "weight_decay": weight_decay if decay else 0.0, "lr": lr}
        for fusion, lr in rates.items() for decay in (True, False)
    ]
    optimizer = torch.optim.AdamW(groups, lr=learning_rate, betas=(0.9, 0.98), eps=1e-6)

    def factor(lr: float) -> Callable[[int], float]:
        # LambdaLR multiplies the group's initial lr by the factor
        schedule = cosine_schedule(lr, total_steps, warmup_steps)
        return lambda count: schedule(count) / lr if lr else 0.0

    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, [factor(g["lr"]) for g in groups])
    return optimizer, scheduler


def make_blip_optimizer(
    model: nn.Module,
    learning_rate: float,
    total_steps: int,
    weight_decay: float = 0.05,
    warmup_steps: int = 0,
) -> Tuple[torch.optim.AdamW, torch.optim.lr_scheduler.LambdaLR]:
    """BLIP: one AdamW group over every trainable parameter, weight decay on
    all of them (LayerNorm, biases and `temp` too: optax.adamw without a
    mask, reference uniir_blip/train.py:192-197), optax's defaults betas
    (0.9, 0.999) and eps 1e-8, on the shared cosine schedule.  A parameter
    with requires_grad=False is left out: no step and no decay, what the JAX
    package's `optax.set_to_zero` label does for a frozen subtree.  The
    port's BLIP-SF has no cross-attention modules, so nothing is frozen
    there; BLIP-FF trains its cross-attention."""
    params = [p for p in model.parameters() if p.requires_grad]
    optimizer = torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
    schedule = cosine_schedule(learning_rate, total_steps, warmup_steps)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda count: schedule(count) / learning_rate if learning_rate else 0.0
    )
    return optimizer, scheduler
