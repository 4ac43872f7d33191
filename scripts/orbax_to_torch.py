#!/usr/bin/env python3
"""Carry a checkpoint of the JAX package (`uniir_tpu`) into the PyTorch port
(`uniir_tpu_torch`), so what was trained with JAX is served or resumed on a
GPU.

    python scripts/orbax_to_torch.py --config <train.yaml> --ckpt <ckpt_dir>/<name>_epoch_<n> --out <dir>
    python scripts/orbax_to_torch.py --config <embed.yaml> --ckpt params.msgpack --out weights.pth --params-only

It runs where both packages, JAX, orbax and torch are installed (it imports
both), on the CPU, and writes nothing under `uniir_tpu/`.  It reads:

  * a train checkpoint directory of `uniir_tpu.core.checkpoint.
    save_train_checkpoint` -- one orbax item a component, or the legacy
    single-file `state.msgpack` -- restored by the JAX package's own
    `load_train_checkpoint` into a template of shapes (`jax.eval_shape`)
    built from the config its `meta.json` holds (else `--config`): the model by
    `uniir_tpu.models.registry.build_model_from_config` (no checkpoint
    loaded into it but a `pretrained_torch_ckpt` that exists, whose tree a
    run started from), the optimizer by `uniir_tpu.train.optimizer` as the
    JAX trainer builds it, the train state around them.  It is written as
    the port's `<out>/<short_name>_epoch_<n>/` (`checkpoint.pth` with the
    model, AdamW's moments and counts, the scheduler, the epoch and BLIP's
    momentum items; `meta.json` with the micro-batch step) through
    `uniir_tpu_torch.core.checkpoint.write_jax_train_state`, which the
    port's `load_train_checkpoint` and the trainer's `resume_training` read,
    and which `model.ckpt_config` serves;
  * with `--params-only`, a `save_params` msgpack (or a train checkpoint's
    parameters), written as a torch state dict that the port's registry
    reads as `model.pretrained_torch_ckpt`.

A state saved inside a gradient accumulation (optax MultiSteps' mini_step
not 0) is refused: the port's checkpoint holds no accumulated gradient.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

BLIP_MODELS = ("BLIPScoreFusion", "BLIPFeatureFusion")


def jax_template_config(config):
    """The config the JAX template is built from: no checkpoint to load into
    it but a `pretrained_torch_ckpt` file that exists (a run that started
    from one has its tree), no int8 serving."""
    from uniir_tpu.core.config import Config as JaxConfig

    cfg = JaxConfig.from_dict(copy.deepcopy(config.to_dict(resolve=False) if hasattr(config, "to_dict") else config))
    model = cfg.model
    if not os.path.isfile(str(getattr(model, "pretrained_torch_ckpt", None) or "")):
        model.pretrained_torch_ckpt = None
    if getattr(model, "ckpt_config", None) is not None:
        model.ckpt_config.ckpt_name = ""
    model.int8 = False
    return cfg


def jax_train_state(config):
    """A JAX train state of the config's model and optimizer, and the model's
    bundle: the template the checkpoint is restored into (called under
    `jax.eval_shape`, it only has shapes)."""
    from uniir_tpu.models.registry import build_model_from_config
    from uniir_tpu.train.optimizer import make_blip_optimizer, make_clip_optimizer
    from uniir_tpu.train.state import MomentumTrainState, TrainState

    bundle = build_model_from_config(config)
    trainer = config.trainer_config
    accum = int(getattr(trainer, "gradient_accumulation_steps", 1))
    warmup = int(getattr(trainer, "warmup_steps", 0))
    lr = float(trainer.learning_rate)
    name = config.model.name
    if name in BLIP_MODELS:
        tx = make_blip_optimizer(bundle.params, lr, warmup + 2, weight_decay=float(getattr(trainer, "weight_decay", 0.05)),
                                 warmup_steps=warmup, accumulation_steps=accum,
                                 freeze_path_sub="crossattention" if name == "BLIPScoreFusion" else None)
        return MomentumTrainState.create(bundle.params, tx, queue_size=bundle.extra["queue_size"],
                                         embed_dim=bundle.embed_dim, momentum=bundle.extra["momentum"]), bundle
    fusion_lr = getattr(trainer, "t5_learning_rate", None)
    tx = make_clip_optimizer(bundle.params, lr, warmup + 2, weight_decay=float(getattr(trainer, "weight_decay", 0.2)),
                             warmup_steps=warmup, accumulation_steps=accum,
                             fusion_learning_rate=float(fusion_lr) if fusion_lr else None)
    return TrainState.create(params=bundle.params, tx=tx), bundle


def _numpy(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def _meta_config(ckpt: str):
    meta_path = os.path.join(ckpt, "meta.json")
    if os.path.isdir(ckpt) and os.path.isfile(meta_path):
        with open(meta_path) as f:
            return json.load(f).get("config")
    return None


def convert_train_checkpoint(config, ckpt: str, out: str) -> str:
    """The JAX train checkpoint directory `ckpt` as the port's
    `<out>/<short_name>_epoch_<n>/`; returns that directory."""
    from uniir_tpu.core.checkpoint import _state_to_pytree, load_train_checkpoint

    from uniir_tpu_torch.core.checkpoint import write_jax_train_state

    import jax

    cfg = jax_template_config(_meta_config(ckpt) or config)
    template = jax.eval_shape(lambda: jax_train_state(cfg)[0])  # shapes only: nothing is initialised
    state, epoch = load_train_checkpoint(ckpt, template)
    tree = _numpy(_state_to_pytree(state))
    name = str(config.model.short_name).lower()
    return write_jax_train_state(config, tree, out, name, epoch)


def convert_params(config, ckpt: str, out: str) -> str:
    """A `save_params` msgpack (or a train checkpoint's parameters) as a
    torch state dict at `out`; returns `out`."""
    import torch
    from uniir_tpu.core.checkpoint import load_params, load_train_params
    from uniir_tpu.models.registry import build_model_from_config

    from uniir_tpu_torch.models.convert import state_dict_from_jax

    import jax

    cfg = jax_template_config(_meta_config(ckpt) or config)
    like = jax.eval_shape(lambda: build_model_from_config(cfg).params)
    is_train = os.path.isdir(ckpt) or os.path.basename(ckpt) == "state.msgpack"
    params = load_train_params(ckpt, like) if is_train else load_params(ckpt, like)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    torch.save(state_dict_from_jax(_numpy(params)), out)
    return out


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", required=True, help="the YAML config the port builds the model and optimizer from")
    parser.add_argument("--ckpt", required=True, help="a JAX train checkpoint directory, its state.msgpack, or a "
                                                      "save_params msgpack (with --params-only)")
    parser.add_argument("--out", required=True, help="the directory the port's <name>_epoch_<n>/ is written in; with "
                                                     "--params-only the .pth file")
    parser.add_argument("--params-only", action="store_true", help="write the parameters alone, as a torch state dict")
    args = parser.parse_args(argv)

    from uniir_tpu_torch.core.config import load_config

    config = load_config(args.config)
    ckpt = args.ckpt[: -len("/state.msgpack")] if args.ckpt.endswith("/state.msgpack") and not args.params_only \
        else args.ckpt
    path = convert_params(config, ckpt, args.out) if args.params_only else convert_train_checkpoint(config, ckpt, args.out)
    print(f"Wrote {path}")
    return path


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")  # a conversion needs no accelerator
    main()
