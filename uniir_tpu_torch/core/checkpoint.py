"""Train checkpoints of the port (counterpart of uniir_tpu/core/checkpoint.py).

`save_train_checkpoint` writes `<ckpt_dir>/<name>_epoch_<epoch>/` holding

  * `checkpoint.pth`: one torch file in the reference UniIR layout,
    {"model", "optimizer", "scheduler", "epoch", "config"} (reference
    clip_scorefusion/train.py:64-79; no GradScaler state, bf16 needs none),
    whose `model` entry is the module's state dict (CLIP-SF, or CLIP-FF's
    `clip_model.*` / `t5_layers.*`), so `models.registry.
    load_torch_checkpoint` / `load_clip_ff_checkpoint` serve a trained
    checkpoint;
  * `meta.json`: the JAX package's marker {"epoch", "step", "items",
    "config"}, written last, so its presence means the checkpoint is whole.

Reading the JAX package's orbax checkpoints is not ported (ROADMAP.md,
Queue 1 item 3).
"""

from __future__ import annotations

import json
import os

import torch

CHECKPOINT_FILE = "checkpoint.pth"
ITEMS = ("model", "optimizer", "scheduler")


def _config_dict(config):
    if config is None:
        return None
    return config.to_dict(resolve=False) if hasattr(config, "to_dict") else dict(config)


def save_train_checkpoint(ckpt_dir: str, name: str, state, epoch: int, config=None) -> str:
    """Write `<ckpt_dir>/<name>_epoch_<epoch>` (overwriting it); returns its path."""
    path = os.path.abspath(os.path.join(ckpt_dir, f"{name}_epoch_{epoch}"))
    os.makedirs(path, exist_ok=True)
    meta_path = os.path.join(path, "meta.json")
    if os.path.exists(meta_path):  # an overwrite is incomplete until the new meta.json lands
        os.remove(meta_path)
    blob = {
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "scheduler": state.scheduler.state_dict(),
        "epoch": epoch,
        "config": _config_dict(config),
    }
    tmp = os.path.join(path, CHECKPOINT_FILE + ".tmp")
    torch.save(blob, tmp)
    os.replace(tmp, os.path.join(path, CHECKPOINT_FILE))
    meta = {"epoch": epoch, "step": int(state.step), "items": list(ITEMS), "config": blob["config"]}
    with open(meta_path, "w") as f:
        json.dump(meta, f, default=str)
    print(f"Saved checkpoint to {path}")
    return path


def load_train_checkpoint(path: str, state):
    """Restore a train state saved by `save_train_checkpoint` in place;
    returns (state, epoch)."""
    path = os.path.abspath(path)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    blob = torch.load(os.path.join(path, CHECKPOINT_FILE), map_location="cpu", weights_only=True)
    state.model.load_state_dict(blob["model"])
    state.optimizer.load_state_dict(blob["optimizer"])
    state.scheduler.load_state_dict(blob["scheduler"])
    state.step = int(meta["step"])
    return state, int(meta["epoch"])
