"""Forward steps (counterpart of uniir_tpu/train/steps.py): the embed step only.

The training steps wait for the training path (ROADMAP.md, Queue 1 item 3).
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch


def _model_inputs(batch: Dict[str, Any], device: torch.device):
    return tuple(
        torch.as_tensor(np.asarray(batch[key])).to(device)
        for key in ("txt_batched", "image_batched", "txt_mask_batched", "image_mask_batched")
    )


def make_embed_step(model: torch.nn.Module, out_dtype: torch.dtype = torch.float16) -> Callable:
    """Embedding forward for the eval pipeline: the model's compute dtype in,
    `out_dtype` (fp16 artifacts on disk, reference mbeir_embedder.py:56,110) out.

    step(batch) takes a collated numpy batch and returns a tensor on the
    model's device."""
    device = next(model.parameters()).device

    def step(batch: Dict[str, Any]) -> torch.Tensor:
        with torch.inference_mode():
            return model(*_model_inputs(batch, device)).to(out_dtype)

    return step
