"""Profiling utilities (counterpart of uniir_tpu/utils/profiling.py) on torch.profiler.

Usage:
    with trace("/tmp/uniir-trace"):          # Chrome trace (chrome://tracing, Perfetto)
        loss = train_step(batch)

    with annotate("embed-sweep"):            # named region inside a trace
        ...

    timer = StepTimer()
    with timer:                               # wall-time a host-side block
        ...
    print(timer.elapsed)
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block's CPU work and, where a card is visible, its CUDA
    kernels; the Chrome trace goes to `log_dir` when the block ends."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    handler = torch.profiler.tensorboard_trace_handler(log_dir)
    with torch.profiler.profile(activities=activities, on_trace_ready=handler) as prof:
        yield prof


def annotate(name: str):
    """Named trace region (shows up in the profiler timeline)."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Minimal wall-clock context timer for host-side phases."""

    def __init__(self) -> None:
        self.elapsed: float = 0.0
        self._t0: Optional[float] = None

    def __enter__(self) -> "StepTimer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.elapsed = time.perf_counter() - self._t0


def device_memory_stats() -> dict:
    """Per-card `torch.cuda.memory_stats` (allocated / reserved bytes etc.),
    keyed by device name; empty where no card is visible."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": torch.cuda.memory_stats(i) for i in range(torch.cuda.device_count())}
