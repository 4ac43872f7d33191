"""The device an entry point runs on: the card, unless the caller asks otherwise."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means the CUDA card.  With no card
    and no device named this raises: the CPU runs only when the caller asks
    for it (`device="cpu"`, `--device cpu`), never as a silent fallback."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device found: uniir_tpu_torch runs on the card by default; "
            'pass device="cpu" (--device cpu on the command line) to run on the CPU'
        )
    return torch.device("cuda")
