"""Train states (counterpart of uniir_tpu/train/state.py).

`TrainState` holds the model (its fp32 master parameters), the AdamW
optimizer, its learning-rate scheduler and the step count.  `step` counts
micro-batches, as the JAX TrainState's does; with `accumulation_steps` k
the gradients of k micro-batches are summed in `.grad` by their backward
passes and averaged before one optimizer update, optax.MultiSteps' meaning.
Over several processes the update first averages the gradients over the
ranks, in one all-reduce an update (`core.mesh.all_reduce_mean_`), not one
a micro-batch: every rank then takes the same step.

`MomentumTrainState` adds BLIP's machinery (reference blip_sf.py:60-67,
344-366): `model_m`, the momentum twin -- a second module holding an EMA of
the parameters, never trained -- and the contrastive queues, row-major
`[queue_size, D]` fp32 (the reference keeps them column-major), an int64
id queue filled with -100 (never a real hashed did) and the ring pointer,
a host int.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
import torch
from torch import nn

from uniir_tpu_torch.core import mesh


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    accumulation_steps: int = 1
    step: int = 0

    def apply_gradients(self) -> None:
        """Count one micro-batch whose gradients are in `.grad`; on every
        k-th, update with their mean (over the micro-batches and the ranks)
        and clear them."""
        self.step += 1
        if self.step % self.accumulation_steps:
            return
        grads = [p.grad for group in self.optimizer.param_groups for p in group["params"] if p.grad is not None]
        mesh.all_reduce_mean_(grads)
        if self.accumulation_steps > 1:
            torch._foreach_div_(grads, self.accumulation_steps)
        self.optimizer.step()
        self.scheduler.step()
        self.optimizer.zero_grad(set_to_none=True)


@dataclass(kw_only=True)
class MomentumTrainState(TrainState):
    model_m: nn.Module
    queue_query: torch.Tensor
    queue_cand: torch.Tensor
    queue_idx: torch.Tensor
    queue_ptr: int = 0
    momentum: float = 0.995

    @classmethod
    def create(cls, model: nn.Module, optimizer, scheduler, queue_size: int, embed_dim: int,
               momentum: float = 0.995, accumulation_steps: int = 1) -> "MomentumTrainState":
        """The momentum twin starts as a copy of `model` (the JAX state's
        `params_m`); the queues are normal draws from a seed-0 generator on
        the model's device, L2-normalised per row."""
        device = next(model.parameters()).device
        generator = torch.Generator(device=device).manual_seed(0)
        model_m = copy.deepcopy(model).eval().requires_grad_(False)
        model_m.set_dropout_generator(None)  # it runs in eval mode only

        def queue():
            q = torch.randn(queue_size, embed_dim, generator=generator, device=device)
            return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)

        return cls(
            model=model, optimizer=optimizer, scheduler=scheduler, accumulation_steps=accumulation_steps,
            model_m=model_m, queue_query=queue(), queue_cand=queue(),
            queue_idx=torch.full((queue_size,), -100, dtype=torch.int64, device=device), momentum=momentum,
        )

    @torch.no_grad()
    def momentum_update(self) -> None:
        """EMA over every parameter, temp included: pm = pm * m + p * (1 - m)."""
        m = self.momentum
        pm = list(self.model_m.parameters())
        torch._foreach_mul_(pm, m)
        torch._foreach_add_(pm, list(self.model.parameters()), alpha=1.0 - m)

    @torch.no_grad()
    def enqueue(self, query_feats: torch.Tensor, cand_feats: torch.Tensor, idxs: torch.Tensor) -> None:
        """Write the rows at the pointer and advance it, modulo the queue
        size, which must be a multiple of the batch (the reference's
        invariant: a slice past the end would corrupt the ring)."""
        bs, size = query_feats.shape[0], self.queue_query.shape[0]
        if size % bs:
            raise ValueError(f"queue_size {size} must be divisible by global batch {bs}")
        rows = slice(self.queue_ptr, self.queue_ptr + bs)
        self.queue_query[rows] = query_feats
        self.queue_cand[rows] = cand_feats
        self.queue_idx[rows] = idxs.reshape(-1)
        self.queue_ptr = (self.queue_ptr + bs) % size
