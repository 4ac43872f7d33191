"""Index search (counterpart of uniir_tpu/retrieval/search.py).

Uploads a DenseIndex to the device once and runs exact top-k with the sweep
kernels (ops/topk.py).  Returns (scores, hashed ids) with the FAISS path's
shapes.  Unlike the TPU package, every pool size goes through the sweep
kernels on the card (the small-pool XLA path was a TPU choice).  Over
several processes each rank holds one row shard of the pool and the ranks
merge their partial top-k (`ops.topk.sharded_topk`).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from uniir_tpu_torch.core import mesh
from uniir_tpu_torch.core.device import resolve_device
from uniir_tpu_torch.ops.topk import prepare_pool, shard_pool, sharded_topk, topk
from uniir_tpu_torch.retrieval.index import DenseIndex, normalize_l2

POOL_DTYPES = ("bf16", "int8", "int8_bucket")


def search_dense_index(
    query_embeddings: np.ndarray,
    index: DenseIndex,
    num_cand_to_retrieve: int = 10,
    batch_size: int = 1024,
    pool_dtype: Optional[str] = None,
    stats: Optional[dict] = None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact inner-product search; queries are L2-normalised first.

    `pool_dtype` "bf16" (the default; the environment's `UNIIR_TOPK_POOL`
    when None, as in the JAX package) sweeps the bf16 pool (K2).  "int8"
    sweeps the int8 pool with one scale per row (K4), "int8_bucket" (the
    port's own value: the JAX search quantises per row only) the int8 pool
    with one scale per strided bucket (K11); both select twice the candidate
    buckets, rescore them against the bf16 pool and run the certainty guard
    on every batch; a batch in which any query fails the guard is re-run
    whole on the exact bf16 sweep, so results stay exact w.r.t. bf16 scores.  `stats` receives
    `pool_dtype`, `guard_pass_rate` and `exact_reruns`.  k is clamped to the
    pool size.  Queries go `batch_size` at a time, which bounds the fp32
    maxima on the card ([batch, N/16]: 1.4 GB at 1024 x 5.6M).  `device`
    None means the card; without one it raises (pass "cpu" to run there).

    Over several processes every rank calls it with all the queries: each
    holds one row shard of the pool (`shard_pool`) and sweeps it with K2,
    and the ranks merge their partial top-k (`sharded_topk`); every rank
    returns the whole result.  As in the JAX package's multi-device branch,
    that search sweeps the exact bf16 pool whatever `pool_dtype` says."""
    pool_dtype = pool_dtype or os.environ.get("UNIIR_TOPK_POOL", "bf16")
    if pool_dtype not in POOL_DTYPES:
        raise ValueError(f"pool_dtype must be one of {POOL_DTYPES}, got {pool_dtype!r}")
    device = resolve_device(device)
    q = normalize_l2(np.asarray(query_embeddings))
    k = min(num_cand_to_retrieve, index.ntotal)
    if mesh.process_count() > 1:
        return _sharded_search(q, index, k, batch_size, stats, device)

    pool, pool_quant = prepare_pool(
        index.embeds, device, int8=pool_dtype != "bf16", per_bucket=pool_dtype == "int8_bucket"
    )
    n_guard, n_guard_ok, n_reruns = 0, 0, 0
    all_scores, all_idx = [], []
    for i in range(0, q.shape[0], batch_size):
        qb = torch.from_numpy(q[i : i + batch_size]).to(device)
        if pool_quant is not None:
            s, idx, ok = topk(qb, pool, k, valid_n=index.ntotal, pool_quant=pool_quant, with_guard=True)
            n_guard += ok.numel()
            n_ok = int(ok.sum())
            n_guard_ok += n_ok
            if n_ok < ok.numel():
                n_reruns += 1
                s, idx = topk(qb, pool, k, valid_n=index.ntotal)
        else:
            s, idx = topk(qb, pool, k, valid_n=index.ntotal)
        all_scores.append(s.cpu().numpy())
        all_idx.append(idx.cpu().numpy())
    if stats is not None:
        stats["pool_dtype"] = pool_dtype
        stats["guard_pass_rate"] = (n_guard_ok / n_guard) if n_guard else None
        stats["exact_reruns"] = n_reruns
    scores = np.vstack(all_scores)
    pool_rows = np.vstack(all_idx)
    return scores, index.ids[np.clip(pool_rows, 0, index.ntotal - 1)]


def _sharded_search(q: np.ndarray, index: DenseIndex, k: int, batch_size: int, stats: Optional[dict], device):
    """The multi-process search: this rank's shard of the bf16 pool, every
    query batch through `sharded_topk`."""
    shard, shard_rows = shard_pool(index.embeds, device)
    all_scores, all_idx = [], []
    for i in range(0, q.shape[0], batch_size):
        s, idx = sharded_topk(torch.from_numpy(q[i : i + batch_size]).to(device), shard, k, index.ntotal, shard_rows)
        all_scores.append(s.cpu().numpy())
        all_idx.append(idx.cpu().numpy())
    if stats is not None:
        stats.update(pool_dtype="bf16", guard_pass_rate=None, exact_reruns=0)
    return np.vstack(all_scores), index.ids[np.vstack(all_idx)]


def search_index(
    query_embed_path: str,
    cand_index_path: str,
    batch_size: int = 2048,
    num_cand_to_retrieve: int = 10,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """File-level API of the reference's search_index: a query `.npy` against
    a saved `.index`, at the default pool type."""
    return search_dense_index(
        np.load(query_embed_path), DenseIndex.load(cand_index_path),
        num_cand_to_retrieve=num_cand_to_retrieve, batch_size=batch_size, device=device,
    )
