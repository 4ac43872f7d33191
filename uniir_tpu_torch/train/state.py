"""Train state (counterpart of uniir_tpu/train/state.py, the CLIP family).

`TrainState` holds the model (its fp32 master parameters), the AdamW
optimizer, its learning-rate scheduler and the step count.  `step` counts
micro-batches, as the JAX TrainState's does; with `accumulation_steps` k
the gradients of k micro-batches are summed in `.grad` by their backward
passes and averaged before one optimizer update, optax.MultiSteps' meaning.
BLIP's MomentumTrainState waits for BLIP (ROADMAP.md, Queue 1 item 5).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    accumulation_steps: int = 1
    step: int = 0

    def apply_gradients(self) -> None:
        """Count one micro-batch whose gradients are in `.grad`; on every
        k-th, update with their mean and clear them."""
        self.step += 1
        if self.step % self.accumulation_steps:
            return
        if self.accumulation_steps > 1:
            for group in self.optimizer.param_groups:
                for p in group["params"]:
                    if p.grad is not None:
                        p.grad.div_(self.accumulation_steps)
        self.optimizer.step()
        self.scheduler.step()
        self.optimizer.zero_grad(set_to_none=True)
