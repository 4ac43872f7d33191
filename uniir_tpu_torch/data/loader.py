"""Samplers and a threaded prefetching loader (torch DataLoader replacement):
the port's copy of uniir_tpu/data/loader.py, held equal to it by
tests/test_torch_data.py.

  * `EpochShuffleSampler`  -- per-host shard of a global epoch-seeded
    permutation (replaces torch DistributedSampler(shuffle=True) + set_epoch,
    reference train.py:235-240,122-123).
  * `ContiguousSampler`    -- host r takes rows [r*ceil(N/W), ...): preserves
    global order for gather-free embedding writes (reference
    ContiguousDistributedSampler, src/common/dist_utils.py:94-115).
  * `MBEIRLoader`          -- map-style loader with a thread pool decoding
    images ahead of the train step (replaces DataLoader(num_workers=5,
    pin_memory=True)).  Threads (not processes) because the work is
    PIL/numpy which releases the GIL during decode/resize.

Batches are dicts of numpy arrays; the step moves them to the device.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np


class EpochShuffleSampler:
    """Global permutation keyed by (seed, epoch); rank takes a strided shard."""

    def __init__(self, n: int, num_replicas: int = 1, rank: int = 0, seed: int = 0, drop_last: bool = True):
        self.n = n
        self.num_replicas = num_replicas
        self.rank = rank
        self.seed = seed
        self.epoch = 0
        self.drop_last = drop_last

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def indices(self) -> np.ndarray:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, self.epoch]))
        perm = rng.permutation(self.n)
        if self.drop_last:
            usable = (self.n // self.num_replicas) * self.num_replicas
            perm = perm[:usable]
        else:
            pad = (-len(perm)) % self.num_replicas
            if pad:
                perm = np.concatenate([perm, perm[:pad]])
        return perm[self.rank :: self.num_replicas]

    def __iter__(self) -> Iterator[int]:
        return iter(self.indices().tolist())

    def __len__(self) -> int:
        if self.drop_last:
            return self.n // self.num_replicas
        return -(-self.n // self.num_replicas)


class ContiguousSampler:
    """Rank r gets the contiguous slice [r*chunk, (r+1)*chunk) (global order preserved)."""

    def __init__(self, n: int, num_replicas: int = 1, rank: int = 0):
        self.n = n
        self.num_replicas = num_replicas
        self.rank = rank
        chunk = -(-n // num_replicas)
        self.start = min(rank * chunk, n)
        self.stop = min((rank + 1) * chunk, n)

    def indices(self) -> np.ndarray:
        return np.arange(self.start, self.stop)

    def __iter__(self) -> Iterator[int]:
        return iter(range(self.start, self.stop))

    def __len__(self) -> int:
        return self.stop - self.start


class MBEIRLoader:
    """Threaded map-style batch loader.

    Each batch's items are fetched by a thread pool (image decode + transform
    dominate); collation runs on the submitting thread.  `prefetch` batches
    are kept in flight so device steps overlap host-side decode.
    """

    def __init__(
        self,
        dataset,
        collate_fn: Callable,
        batch_size: int,
        sampler=None,
        num_workers: int = 8,
        drop_last: bool = True,
        prefetch: int = 2,
        pad_last: bool = False,
    ):
        self.dataset = dataset
        self.collate_fn = collate_fn
        self.batch_size = batch_size
        self.sampler = sampler
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.prefetch = max(1, prefetch)
        self.pad_last = pad_last

    def _batches_of_indices(self) -> List[np.ndarray]:
        if self.sampler is not None:
            idx = np.asarray(self.sampler.indices() if hasattr(self.sampler, "indices") else list(self.sampler))
        else:
            idx = np.arange(len(self.dataset))
        nb = len(idx) // self.batch_size
        rem = len(idx) - nb * self.batch_size
        batches = [idx[i * self.batch_size : (i + 1) * self.batch_size] for i in range(nb)]
        if rem and not self.drop_last:
            tail = idx[nb * self.batch_size :]
            if self.pad_last:
                # Pad by repeating the last row so shapes stay static; consumers
                # use the returned `n_valid` to trim.
                pad = np.full(self.batch_size - rem, tail[-1], dtype=tail.dtype)
                tail = np.concatenate([tail, pad])
            batches.append(tail)
        return batches

    def __len__(self) -> int:
        n = len(self.sampler) if self.sampler is not None else len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        batches = self._batches_of_indices()
        # one executor for the whole epoch (per-batch pool spin-up costs ~ms)
        pool = ThreadPoolExecutor(max_workers=self.num_workers)

        def make_batch(indices: np.ndarray, n_valid: int):
            items = list(pool.map(self.dataset.__getitem__, indices.tolist()))
            out = self.collate_fn(items)
            if isinstance(out, dict):
                out["n_valid"] = np.int32(n_valid)
            return out

        work: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        # Real (unpadded) row count per batch; only the padded tail differs.
        real_counts = [len(b) for b in batches]
        if batches and self.pad_last and not self.drop_last:
            total = len(self.sampler) if self.sampler is not None else len(self.dataset)
            consumed = sum(real_counts[:-1])
            real_counts[-1] = min(real_counts[-1], total - consumed)

        def put_or_abandon(item) -> bool:
            # bounded put that re-checks `stop`: a plain blocking put would
            # deadlock the producer forever if the consumer abandons the
            # iterator (break / exception) while the queue is full
            while not stop.is_set():
                try:
                    work.put(item, timeout=0.25)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for b, n_valid in zip(batches, real_counts):
                    if stop.is_set():
                        return
                    if not put_or_abandon(make_batch(b, n_valid)):
                        return
                put_or_abandon(None)
            except Exception as e:
                put_or_abandon(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = work.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            pool.shutdown(wait=False, cancel_futures=True)
