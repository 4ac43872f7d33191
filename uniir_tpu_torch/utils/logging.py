"""Windowed metric logging (counterpart of uniir_tpu/utils/logging.py, without JAX).

`SmoothedValue` keeps a deque window and a global sum and count;
`MetricLogger.log_every` wraps an iterable and prints iteration time,
data-loading time, an ETA and, on a card, the device memory in use.  The
global aggregates are summed across processes only when a
`torch.distributed` group of more than one process is initialised (the
reference all-reduces [count, total], utils.py:62-73).
"""

from __future__ import annotations

import datetime
import time
from collections import defaultdict, deque

import numpy as np
import torch


class SmoothedValue:
    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        value = float(value)
        self.deque.append(value)
        self.count += n
        self.total += value * n

    def synchronize_between_processes(self):
        dist = torch.distributed
        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            agg = torch.tensor([self.count, self.total], dtype=torch.float64)
            dist.all_reduce(agg)
            self.count, self.total = int(agg[0].item()), float(agg[1].item())

    @property
    def median(self) -> float:
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self) -> float:
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(1, self.count)

    @property
    def max(self) -> float:
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self) -> str:
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg, max=self.max, value=self.value
        )


def device_memory_mb() -> float:
    """Device memory held by tensors on the current card, 0.0 without one."""
    if not torch.cuda.is_available():  # a CPU run (asked for by the caller) holds no device memory
        return 0.0
    return torch.cuda.memory_allocated() / (1024.0 * 1024.0)


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters: dict = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(f"MetricLogger has no attribute {attr!r}")

    def __str__(self) -> str:
        return self.delimiter.join(f"{name}: {meter}" for name, meter in self.meters.items())

    def synchronize_between_processes(self):
        for meter in self.meters.values():
            meter.synchronize_between_processes()

    def global_avg_dict(self, prefix: str = "") -> dict:
        return {f"{prefix}{k}": f"{m.global_avg:.4f}" for k, m in self.meters.items()}

    def log_every(self, iterable, print_freq: int, header: str = ""):
        i = 0
        start_time = time.time()
        end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        try:
            total = len(iterable)
        except TypeError:
            total = None
        space_fmt = f"{len(str(total))}d" if total else "d"
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if print_freq and (i % print_freq == 0 or (total and i == total - 1)):
                eta_string = ""
                if total:
                    eta_seconds = iter_time.global_avg * (total - i)
                    eta_string = f"eta: {datetime.timedelta(seconds=int(eta_seconds))}  "
                count = f"[{format(i, space_fmt)}/{total}]" if total else f"[{i}]"
                mem = device_memory_mb()
                mem_str = f"  mem: {mem:.0f}MB" if mem else ""
                print(
                    f"{header} {count}  {eta_string}{self}  time: {iter_time}  data: {data_time}{mem_str}",
                    flush=True,
                )
            i += 1
            end = time.time()
        total_time = time.time() - start_time
        avg = total_time / max(1, i)
        print(f"{header} Total time: {datetime.timedelta(seconds=int(total_time))} ({avg:.4f} s / it)", flush=True)
