"""The process group (counterpart of uniir_tpu/core/mesh.py).

The JAX package runs one program over a device mesh and lets XLA place the
collectives; the torch idiom is one process a card, joined in a
`torch.distributed` process group (the reference's `torchrun
--nproc_per_node` over NCCL).  This module keeps the JAX module's name and
its process-level API -- `process_count`, `process_index`,
`is_main_process`, `barrier(name)`, `maybe_initialize_distributed` -- and
adds the three collectives the port needs:

  * `gather_rows`: the global batch from every rank's block of rows, in
    rank order (the host-major layout `[q_0|p_0|n_0 | q_1|p_1|n_1 | ...]`
    that `train.losses.split_flat_batch(..., n_hosts)` un-interleaves), with
    a gradient: the backward sums the incoming gradient over the ranks and
    keeps this rank's rows;
  * `all_reduce_mean_`: one coalesced all-reduce of a list of tensors (the
    fp32 master gradients), divided by the world size;
  * `broadcast_`: rank 0's values into every rank's tensors (the initial
    parameters).

Each is built from `all_reduce` and `broadcast` alone, the two collectives
every backend the port names takes on CUDA tensors (gloo's table lists no
all-gather there; two ranks that share one card cannot use NCCL): an
all-gather is an all-reduce of a zero buffer in which each rank wrote its
block, exact because x + 0 = x.  The gathered batch is a few hundred rows
of embeddings (840 x 768 fp32 is 2.6 MB), so every rank computes the
whole global loss, as the JAX step does; DisCo-CLIP's split of the loss
over the ranks pays off only at batches of tens of thousands.

With no process group every call is the one-process constant or no-op.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional, Sequence

import torch
import torch.distributed as dist

COLLECTIVE_TIMEOUT_S = 300.0  # how long a collective waits for the other ranks before it raises


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def is_main_process() -> bool:
    """Reference utils.is_main_process (src/models/uniir_clip/utils.py)."""
    return process_index() == 0


def barrier(name: str) -> None:
    """Cross-process barrier at filesystem boundaries (reference dist.barrier
    discipline, mbeir_embedder.py:79-116, train.py:167).  Every process must
    call it, in the same order; `name` says which one a hung rank waits at.
    A no-op in one process."""
    if process_count() == 1:
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def maybe_initialize_distributed(
    device=None,
    init_method: Optional[str] = None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    backend: Optional[str] = None,
    timeout_s: float = COLLECTIVE_TIMEOUT_S,
) -> bool:
    """Join the process group when `UNIIR_TPU_MULTIHOST=1` (reference
    init_distributed_mode, dist_utils.py:62-91); returns whether a group is
    up.  A no-op without the variable, or when a group already exists.

    Rank and world size default to torchrun's `RANK` / `WORLD_SIZE`, the
    rendezvous to `env://` (`MASTER_ADDR` / `MASTER_PORT`); tests pass a
    `file://` `init_method`.  The backend is NCCL for a CUDA `device` and
    gloo for the CPU, unless `backend` names one (gloo for ranks that share
    a card: NCCL refuses two ranks on one device).  A collective that waits
    longer than `timeout_s` raises instead of hanging."""
    if os.environ.get("UNIIR_TPU_MULTIHOST", "0") != "1":
        return False
    if is_initialized():
        return True
    device = torch.device(device) if device is not None else torch.device("cpu")
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    rank = int(os.environ["RANK"]) if rank is None else int(rank)
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else int(world_size)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend=backend, init_method=init_method or "env://", rank=rank, world_size=world_size,
        timeout=timedelta(seconds=timeout_s),
    )
    return True


def collective_device() -> torch.device:
    """Where the group reduces a tensor made for a collective: the card for
    NCCL, the host for gloo (and for no group)."""
    if is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def destroy() -> None:
    """Leave the process group, if there is one."""
    if is_initialized():
        dist.destroy_process_group()


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        rows, rank = x.shape[0], process_index()
        ctx.block = slice(rank * rows, (rank + 1) * rows)
        out = x.new_zeros((process_count() * rows, *x.shape[1:]))
        out[ctx.block] = x
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        return grad[ctx.block]


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's `[rows, ...]` block, in rank order: `[W * rows, ...]`
    (all ranks hold as many rows).  Differentiable: each rank computes the
    same loss of the gathered rows, so the backward sums the W equal
    gradients (W times this rank's share) and `all_reduce_mean_` of the
    parameter gradients divides by W again.  `x` itself in one process."""
    if process_count() == 1:
        return x
    return _GatherRows.apply(x)


def all_reduce_mean_(tensors: Sequence[torch.Tensor]) -> None:
    """In place: each tensor becomes its mean over the ranks, by one
    all-reduce of their concatenation (all of one dtype and device)."""
    tensors = list(tensors)
    if process_count() == 1 or not tensors:
        return
    flat = torch._utils._flatten_dense_tensors(tensors)
    dist.all_reduce(flat)
    flat.div_(process_count())
    for t, reduced in zip(tensors, torch._utils._unflatten_dense_tensors(flat, tensors)):
        t.copy_(reduced)


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """In place: rank `src`'s values into every rank's tensors, one
    broadcast for each dtype among them."""
    if process_count() == 1:
        return
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch._utils._flatten_dense_tensors(group)
        dist.broadcast(flat, src)
        for t, value in zip(group, torch._utils._unflatten_dense_tensors(flat, group)):
            t.copy_(value)


def broadcast_module_(module: torch.nn.Module, src: int = 0) -> None:
    """Rank `src`'s parameters and buffers into every rank's copy of `module`."""
    with torch.no_grad():
        broadcast_([t.data for t in (*module.parameters(), *module.buffers())], src)
