"""Epoch engines (counterpart of uniir_tpu/train/engine.py).

`train_one_epoch` feeds every collated batch of an iterable to the train
step.  Metrics stay 0-d device tensors and are fetched only every
`print_freq` steps and at the end: a `.item()` per step would wait for the
card after every step and leave it idle while the host prepares the next
batch.  The learning rate is logged from the host-side schedule.  BLIP's
steps also take `alpha`, the distillation weight, warmed up over epoch 0
as alpha * min(1, i / n_batches) (reference blip engine :29-32).  Over
several processes each rank feeds its own batches; the metrics the steps
return are the global batch's, equal on every rank, and only rank 0
prints them.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

from uniir_tpu_torch.core import mesh
from uniir_tpu_torch.utils.logging import MetricLogger

# collator keys the steps do not read
_DROP_KEYS = ("n_valid", "index_mapping", "qid_list", "task_id_list")


def _prep_batch(batch: dict) -> dict:
    for k in _DROP_KEYS:
        batch.pop(k, None)
    return batch


def train_one_epoch(
    step_fn: Callable,
    state,
    loader: Iterable,
    epoch: int,
    config,
    lr_schedule: Optional[Callable[[int], float]] = None,
    is_blip: bool = False,
    alpha: float = 0.4,
) -> tuple:
    """One epoch over `loader` (an iterable with a length when `is_blip`);
    returns (state, averaged stats dict)."""
    metric_logger = MetricLogger()
    print_freq = int(getattr(config.trainer_config, "print_freq", 50))
    header = f"Train Epoch: [{epoch}]"
    n_batches = len(loader) if is_blip else 0
    pending = []

    def flush():
        for metrics in pending:
            metric_logger.update(**{k: float(v) for k, v in metrics.items()})
        pending.clear()

    for i, batch in enumerate(metric_logger.log_every(loader, print_freq, header)):
        if is_blip:
            alpha_i = alpha * min(1.0, i / max(1, n_batches)) if epoch == 0 else alpha
            state, metrics = step_fn(state, _prep_batch(batch), alpha_i)
        else:
            state, metrics = step_fn(state, _prep_batch(batch))
        if lr_schedule is not None:
            # indexed by the optimizer update count (micro-batches collapsed
            # by accumulation), after this step's update
            metrics = dict(metrics, lr=lr_schedule(state.step // state.accumulation_steps))
        pending.append(metrics)
        if print_freq and (i + 1) % print_freq == 0:
            flush()

    flush()
    metric_logger.synchronize_between_processes()
    if mesh.is_main_process():
        print(f"Averaged stats: {metric_logger}")
    return state, metric_logger.global_avg_dict()


def eval_engine(eval_step: Callable, loader: Iterable, config, state=None, alpha: Optional[float] = None) -> dict:
    """In-batch validation (reference engine.py:58-84; blip engine :77-112):
    averaged loss and accuracy.  A CLIP eval step takes the batch; BLIP's
    takes (state, batch, alpha), and leaves the state as it was."""
    metric_logger = MetricLogger()
    print_freq = int(getattr(config.evaluator, "print_freq", 10))
    for batch in metric_logger.log_every(loader, print_freq, "Eval:"):
        batch = _prep_batch(batch)
        metrics = eval_step(batch) if alpha is None else eval_step(state, batch, alpha)
        metric_logger.update(**{k: float(v) for k, v in metrics.items()})
    metric_logger.synchronize_between_processes()
    if mesh.is_main_process():
        print(f"Averaged eval stats: {metric_logger}")
    return metric_logger.global_avg_dict()
