"""The device an entry point runs on: the card, unless the caller asks otherwise."""

from __future__ import annotations

import os

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means the CUDA card -- under torchrun
    (`LOCAL_RANK` set) the rank's own card, `cuda:LOCAL_RANK`.  With no card
    and no device named this raises: the CPU runs only when the caller asks
    for it (`device="cpu"`, `--device cpu`), never as a silent fallback; nor
    does a rank whose card is missing share another's."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device found: uniir_tpu_torch runs on the card by default; "
            'pass device="cpu" (--device cpu on the command line) to run on the CPU'
        )
    local_rank = os.environ.get("LOCAL_RANK")
    if local_rank is None:
        return torch.device("cuda")
    index, count = int(local_rank), torch.cuda.device_count()
    if index >= count:
        raise RuntimeError(
            f"LOCAL_RANK={index} but this host has {count} CUDA device(s): one process a card; "
            "name the device explicitly to share one"
        )
    return torch.device("cuda", index)
