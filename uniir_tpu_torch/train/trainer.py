"""Trainer entry point for the four retrievers, on one card or one process
a card (counterpart of uniir_tpu/train/trainer.py).

    python -m uniir_tpu_torch.train.trainer --config_path configs/clip_sf/large/train/inbatch/inbatch.yaml \
        --uniir_dir /data/UniIR --mbeir_data_dir /data/UniIR/mbeir_data

    UNIIR_TPU_MULTIHOST=1 torchrun --nproc_per_node 8 -m uniir_tpu_torch.train.trainer --config_path ...

build the model with fp32 master weights -> AdamW in the CLIP groups with
the cosine schedule over all updates (CLIP-FF: the T5 fusion stack at
`trainer_config.t5_learning_rate`, and its dropout on) -> train state -> resume -> loaders
(epoch-shuffled) -> epoch loop with a checkpoint per epoch and optional
in-batch validation, logged to wandb when `wandb_config.enabled` and the
package is installed.  The file-reading data path is the port's own
(`uniir_tpu_torch/data`: `build_mbeir_dataset_from_config`, `MBEIRLoader`,
`EpochShuffleSampler`; JPEG and PNG images decoded by `data.jpeg` for the
model's device; BLIP's train-time augmentation on numpy arrays);
`train_one_epoch` takes any iterable of collated batches.

BLIP-SF / BLIP-FF train by momentum distillation: one AdamW group (wd
`trainer_config.weight_decay`, 0.05) over every parameter, a
`MomentumTrainState` with the momentum twin and the queues
(`model.queue_size`, `model.momentum`), the BLIP train step with dropout
on, and `model.alpha` warmed up over epoch 0; the in-batch validation reads
the queues and changes nothing.

Over several processes (`UNIIR_TPU_MULTIHOST=1` under torchrun, one
process a card: `cuda:LOCAL_RANK`, NCCL) `main` joins the process group
first (`core.mesh.maybe_initialize_distributed`), rank 0's initial
parameters are broadcast to every rank, each rank reads its strided shard
of the epoch's permutation (`EpochShuffleSampler` by rank, train and
validation) and seeds numpy with `seed + rank`, the steps compute the
global-batch loss (`train.steps`), rank 0 alone writes the checkpoint
behind a barrier, and only rank 0 logs to its file and to wandb.  A
`train_batch_size` is a rank's, as the reference's per-GPU batch.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from uniir_tpu_torch.core import mesh
from uniir_tpu_torch.core.checkpoint import load_train_checkpoint, save_train_checkpoint
from uniir_tpu_torch.core.config import load_config
from uniir_tpu_torch.core.device import module_device, resolve_device
from uniir_tpu_torch.data.data_utils import DatasetType, build_mbeir_dataset_from_config
from uniir_tpu_torch.data.loader import EpochShuffleSampler, MBEIRLoader
from uniir_tpu_torch.models.registry import build_model_from_config
from uniir_tpu_torch.train.engine import eval_engine, train_one_epoch
from uniir_tpu_torch.train.optimizer import cosine_schedule, make_blip_optimizer, make_clip_optimizer
from uniir_tpu_torch.train.state import MomentumTrainState, TrainState
from uniir_tpu_torch.train.steps import (
    make_blip_eval_step,
    make_blip_train_step,
    make_clip_eval_step,
    make_clip_train_step,
)

BLIP_MODELS = ("BLIPScoreFusion", "BLIPFeatureFusion")


def log_results(train_stats, val_stats, test_stats, epoch=None, best_epoch=None) -> dict:
    log_stats = {}
    if train_stats:
        log_stats.update({f"train_{k}": v for k, v in train_stats.items()})
    if val_stats:
        log_stats.update({f"val_{k}": v for k, v in val_stats.items()})
    if test_stats:
        log_stats.update({f"test_{k}": v for k, v in test_stats.items()})
    if epoch is not None:
        log_stats["epoch"] = epoch
    if best_epoch is not None:
        log_stats["best_epoch"] = best_epoch
    return log_stats


def build_train_setup(config, bundle=None, device=None) -> dict:
    """Everything main() needs, reusable from tests: returns a dict."""
    model_name = config.model.name
    is_blip = model_name in BLIP_MODELS
    trainer_config, data_config = config.trainer_config, config.data_config
    if bundle is None:
        bundle = build_model_from_config(config, device, train=True)
    mesh.broadcast_module_(bundle.model)  # every rank starts from rank 0's parameters
    hard_neg_num = int(getattr(data_config, "hard_neg_num", 0))
    in_batch_neg_num = int(getattr(data_config, "in_batch_neg_num", 0))

    def loader(dataset_type: DatasetType, img_preprocess_fn, batch_size):
        dataset, collator = build_mbeir_dataset_from_config(
            config=config, tokenizer=bundle.tokenizer, img_preprocess_fn=img_preprocess_fn, dataset_type=dataset_type,
            device=module_device(bundle.model),
        )
        sampler = EpochShuffleSampler(
            len(dataset), num_replicas=mesh.process_count(), rank=mesh.process_index(), seed=int(config.seed)
        )
        return dataset, sampler, MBEIRLoader(
            dataset, collator, batch_size=int(batch_size), sampler=sampler,
            num_workers=int(config.dataloader_config.num_workers), drop_last=True,
        )

    train_dataset, train_sampler, train_loader = loader(
        DatasetType.MAIN_TRAIN, bundle.img_preprocess_fn, config.dataloader_config.train_batch_size
    )
    valid_loader = None
    if config.evaluator.enable_eval:
        valid_loader = loader(
            DatasetType.IN_BATCH_VAL, bundle.img_preprocess_fn_eval, config.dataloader_config.valid_batch_size
        )[2]

    accum = int(getattr(trainer_config, "gradient_accumulation_steps", 1))
    num_epochs = int(trainer_config.num_train_epochs)
    t_total = len(train_loader) // accum * num_epochs
    lr = float(trainer_config.learning_rate)
    warmup = int(getattr(trainer_config, "warmup_steps", 0))

    model = bundle.model
    state = make_train_state(config, bundle, t_total)
    if is_blip:
        train_step = make_blip_train_step(model, hard_neg_num=hard_neg_num, seed=int(config.seed))
        eval_step = make_blip_eval_step(hard_neg_num=hard_neg_num)
    else:
        train_step = make_clip_train_step(
            model, hard_neg_num=hard_neg_num, in_batch_neg_num=in_batch_neg_num,
            with_dropout=(model_name == "CLIPFeatureFusion"),  # T5 fusion dropout
            seed=int(config.seed),
        )
        eval_step = make_clip_eval_step(model, hard_neg_num=hard_neg_num, in_batch_neg_num=in_batch_neg_num)
    return {
        "bundle": bundle,
        "is_blip": is_blip,
        "state": state,
        "train_step": train_step,
        "eval_step": eval_step,
        "train_loader": train_loader,
        "train_sampler": train_sampler,
        "train_dataset": train_dataset,
        "valid_loader": valid_loader,
        "lr_schedule": cosine_schedule(lr, t_total, warmup),
        "num_epochs": num_epochs,
    }


def make_train_state(config, bundle, t_total: int):
    """The train state of `bundle`'s model by `config.trainer_config`: AdamW
    in the CLIP groups (CLIP-FF's T5 group at `t5_learning_rate`) or BLIP's
    one group, its cosine schedule over `t_total` updates, and for BLIP the
    momentum twin and queues; `gradient_accumulation_steps` micro-batches an
    update."""
    trainer_config = config.trainer_config
    accum = int(getattr(trainer_config, "gradient_accumulation_steps", 1))
    lr = float(trainer_config.learning_rate)
    warmup = int(getattr(trainer_config, "warmup_steps", 0))
    model = bundle.model
    if config.model.name in BLIP_MODELS:
        optimizer, scheduler = make_blip_optimizer(
            model, lr, t_total, weight_decay=float(getattr(trainer_config, "weight_decay", 0.05)), warmup_steps=warmup
        )
        return MomentumTrainState.create(
            model, optimizer, scheduler, queue_size=bundle.extra["queue_size"],
            embed_dim=bundle.embed_dim, momentum=bundle.extra["momentum"], accumulation_steps=accum,
        )
    fusion_lr = getattr(trainer_config, "t5_learning_rate", None)
    optimizer, scheduler = make_clip_optimizer(
        model, lr, t_total, weight_decay=float(getattr(trainer_config, "weight_decay", 0.2)), warmup_steps=warmup,
        fusion_learning_rate=float(fusion_lr) if fusion_lr else None,
    )
    return TrainState(model, optimizer, scheduler, accumulation_steps=accum)


def _setup_file_logging(config) -> None:
    """Mirror the reference's train.log file handler (train.py:353-368), on rank 0."""
    import logging

    logger_cfg = getattr(config, "logger_config", None)
    if logger_cfg is None or not mesh.is_main_process():
        return
    out_dir = os.path.join(config.uniir_dir, logger_cfg.logger_out_dir)
    os.makedirs(out_dir, exist_ok=True)
    logging.basicConfig(
        format="[%(asctime)s] %(levelname)s: %(message)s",
        level=logging.INFO,
        datefmt="%d-%m-%Y %H:%M:%S",
        handlers=[logging.FileHandler(os.path.join(out_dir, logger_cfg.logger_out_file_name)), logging.StreamHandler()],
    )
    logging.getLogger("PIL").setLevel(logging.WARNING)
    logging.getLogger(__name__).info(config.to_dict())


def main(config, bundle=None, device=None, wandb_run=None) -> dict:
    """Train by `config`; over several processes every rank calls it (see
    the module's docstring).  `device` None means the card (`cuda:LOCAL_RANK`
    under torchrun)."""
    device = resolve_device(device) if bundle is None else next(bundle.model.parameters()).device
    mesh.maybe_initialize_distributed(device)
    np.random.seed(int(config.seed) + mesh.process_index())
    torch.manual_seed(int(config.seed))
    _setup_file_logging(config)

    setup = build_train_setup(config, bundle=bundle, device=device)
    state = setup["state"]
    ckpt_config = config.model.ckpt_config
    ckpt_dir = os.path.join(config.uniir_dir, ckpt_config.ckpt_dir)
    short_name = config.model.short_name.lower()

    start_epoch = 0
    if getattr(ckpt_config, "resume_training", False):
        resume_path = os.path.join(ckpt_dir, ckpt_config.ckpt_name)
        if not os.path.exists(resume_path):
            raise FileNotFoundError(f"Checkpoint file {resume_path} does not exist.")
        state, last_epoch = load_train_checkpoint(resume_path, state)
        start_epoch = last_epoch + 1
        print(f"Resuming training from epoch {start_epoch}")

    is_blip = setup["is_blip"]
    blip = {"alpha": setup["bundle"].extra["alpha"]} if is_blip else {}  # the distillation weight
    best_inbatch_accuracy = 0.0
    best_epoch = 0
    last_stats: dict = {}
    eval_freq = int(getattr(config.evaluator, "eval_freq", 1))
    for epoch in range(start_epoch, setup["num_epochs"]):
        setup["train_sampler"].set_epoch(epoch)
        setup["train_dataset"].seed(int(config.seed) + epoch)
        state, train_stats = train_one_epoch(
            setup["train_step"], state, setup["train_loader"], epoch, config, lr_schedule=setup["lr_schedule"],
            is_blip=is_blip, **blip,
        )
        val_stats = None
        if setup["valid_loader"] is not None and epoch % eval_freq == 0:
            val_stats = eval_engine(setup["eval_step"], setup["valid_loader"], config,
                                    state=state, **blip)
            inbatch_accuracy = float(val_stats.get("inbatch_accuracy", 0.0))
            if inbatch_accuracy >= best_inbatch_accuracy:
                best_inbatch_accuracy = inbatch_accuracy
                best_epoch = epoch
        save_train_checkpoint(ckpt_dir, short_name, state, epoch, config)
        last_stats = log_results(train_stats, val_stats, None, epoch, best_epoch)
        if wandb_run is not None and mesh.is_main_process():
            wandb_run.log(last_stats)
    return {"state": state, "stats": last_stats, "best_epoch": best_epoch}


def init_wandb(config):
    """A wandb run when `wandb_config.enabled` and the package is there, on
    rank 0 (call it after the process group is up); None, with a printed
    reason, when it is missing or offline (the reference gates it the same
    way and trains on)."""
    wandb_cfg = getattr(config, "wandb_config", None)
    if wandb_cfg is None or not getattr(wandb_cfg, "enabled", False) or not mesh.is_main_process():
        return None
    try:
        import wandb

        return wandb.init(
            project=os.environ.get("WANDB_PROJECT"), entity=os.environ.get("WANDB_ENTITY"),
            name=wandb_cfg.experiment_name, config=config.to_dict(),
        )
    except Exception as e:  # wandb not installed / offline: say so and go on
        print(f"wandb disabled: {e}")
        return None


def cli(argv=None):
    parser = argparse.ArgumentParser(description="uniir_tpu_torch trainer (CLIP-SF / CLIP-FF / BLIP-SF / BLIP-FF)")
    parser.add_argument("--config_path", default="config.yaml", help="Path to the config file.")
    parser.add_argument("--uniir_dir", type=str, default="/data/UniIR")
    parser.add_argument("--mbeir_data_dir", type=str, default="/data/UniIR/mbeir_data")
    parser.add_argument("--device", default=None,
                        help="cuda (the default: cuda:LOCAL_RANK under torchrun; without a card it is an error) or cpu")
    args = parser.parse_args(argv)
    config = load_config(args.config_path)
    config.uniir_dir = args.uniir_dir
    config.mbeir_data_dir = args.mbeir_data_dir
    device = resolve_device(args.device)
    mesh.maybe_initialize_distributed(device)
    wandb_run = init_wandb(config)
    result = main(config, device=device, wandb_run=wandb_run)
    if wandb_run is not None:
        wandb_run.finish()
    return result


if __name__ == "__main__":
    cli()
