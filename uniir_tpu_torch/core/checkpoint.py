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

A BLIP state (`train.state.MomentumTrainState`) adds its extra items to
the same file -- `model_m` (the momentum twin's state dict), the three
queues and `queue_ptr` -- so a resumed run continues bit-equal; the serving
loaders read only `model`.

Over several processes rank 0 alone writes the directory, and every rank
then meets at a barrier, so no rank reads a checkpoint before it is whole;
on resume every rank loads the same file.

Reading the JAX package's orbax checkpoints is not ported: that bridge
reads a JAX train checkpoint and writes `checkpoint.pth`, and needs both
packages (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import json
import os

import torch

from uniir_tpu_torch.core import mesh

CHECKPOINT_FILE = "checkpoint.pth"
ITEMS = ("model", "optimizer", "scheduler")
MOMENTUM_ITEMS = ("model_m", "queue_query", "queue_cand", "queue_idx", "queue_ptr")


def _config_dict(config):
    if config is None:
        return None
    return config.to_dict(resolve=False) if hasattr(config, "to_dict") else dict(config)


def save_train_checkpoint(ckpt_dir: str, name: str, state, epoch: int, config=None) -> str:
    """Write `<ckpt_dir>/<name>_epoch_<epoch>` (overwriting it); returns its
    path.  Every rank calls it; rank 0 writes, and all meet at a barrier."""
    path = os.path.abspath(os.path.join(ckpt_dir, f"{name}_epoch_{epoch}"))
    if mesh.is_main_process():
        _write_checkpoint(path, state, epoch, config)
    mesh.barrier(f"checkpoint_{name}_epoch_{epoch}")
    return path


def _write_checkpoint(path: str, state, epoch: int, config) -> None:
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
    items = list(ITEMS)
    if hasattr(state, "model_m"):
        blob.update(model_m=state.model_m.state_dict(), queue_query=state.queue_query, queue_cand=state.queue_cand,
                    queue_idx=state.queue_idx, queue_ptr=state.queue_ptr)
        items += MOMENTUM_ITEMS
    tmp = os.path.join(path, CHECKPOINT_FILE + ".tmp")
    torch.save(blob, tmp)
    os.replace(tmp, os.path.join(path, CHECKPOINT_FILE))
    meta = {"epoch": epoch, "step": int(state.step), "items": items, "config": blob["config"]}
    with open(meta_path, "w") as f:
        json.dump(meta, f, default=str)
    print(f"Saved checkpoint to {path}")


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
    if hasattr(state, "model_m"):
        state.model_m.load_state_dict(blob["model_m"])
        for name in ("queue_query", "queue_cand", "queue_idx"):
            getattr(state, name).copy_(blob[name])
        state.queue_ptr = int(blob["queue_ptr"])
    state.step = int(meta["step"])
    return state, int(meta["epoch"])
