"""Trainer entry point for CLIP-SF, one process on one device
(counterpart of uniir_tpu/train/trainer.py).

    python -m uniir_tpu_torch.train.trainer --config_path configs/clip_sf/large/train/inbatch/inbatch.yaml \
        --uniir_dir /data/UniIR --mbeir_data_dir /data/UniIR/mbeir_data

build the model with fp32 master weights -> AdamW in the CLIP groups with
the cosine schedule over all updates -> train state -> resume -> loaders
(epoch-shuffled) -> epoch loop with a checkpoint per epoch and optional
in-batch validation.  The file-reading data path is the port's own
(`uniir_tpu_torch/data`: dataset, collator, `MBEIRLoader`,
`EpochShuffleSampler`; Pillow is needed only once an image is opened);
`train_one_epoch` takes any iterable of collated batches.  The other retrievers, and training
over several processes, raise until they are ported (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from uniir_tpu_torch.core.checkpoint import load_train_checkpoint, save_train_checkpoint
from uniir_tpu_torch.core.config import load_config, parse_image_size
from uniir_tpu_torch.data.collator import MBEIRMainCollator
from uniir_tpu_torch.data.dataset import MBEIRMainDataset, Mode
from uniir_tpu_torch.data.loader import EpochShuffleSampler, MBEIRLoader
from uniir_tpu_torch.models.registry import build_model_from_config
from uniir_tpu_torch.train.engine import eval_engine, train_one_epoch
from uniir_tpu_torch.train.optimizer import cosine_schedule, make_clip_optimizer
from uniir_tpu_torch.train.state import TrainState
from uniir_tpu_torch.train.steps import make_clip_eval_step, make_clip_train_step


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
    if model_name != "CLIPScoreFusion":
        raise NotImplementedError(
            f"training {model_name} is not ported to uniir_tpu_torch yet (ROADMAP.md, Queue 1 items 4-5)"
        )
    trainer_config, data_config = config.trainer_config, config.data_config
    if bundle is None:
        bundle = build_model_from_config(config, device, train=True)
    hard_neg_num = int(getattr(data_config, "hard_neg_num", 0))
    in_batch_neg_num = int(getattr(data_config, "in_batch_neg_num", 0))
    returns = getattr(data_config, "returns", None)
    returns = dict(returns.items()) if returns is not None and hasattr(returns, "items") else (returns or {})

    def loader(split: str, img_preprocess_fn, batch_size):
        # uniir_tpu/data/data_utils.py's MAIN_TRAIN / IN_BATCH_VAL datasets
        # (in-batch validation computes the train loss, as the reference)
        dataset = MBEIRMainDataset(
            mbeir_data_dir=config.mbeir_data_dir,
            query_data_path=getattr(data_config, f"{split}_query_data_path"),
            cand_pool_path=getattr(data_config, f"{split}_cand_pool_path"),
            query_instruct_path=data_config.query_instruct_path,
            img_preprocess_fn=img_preprocess_fn,
            mode=Mode.TRAIN,
            enable_query_instruct=data_config.enable_query_instruct,
            shuffle_cand=data_config.shuffle_cand,
            hard_neg_num=hard_neg_num,
            returns={"hashed_p_did": True, "hashed_n_dids": hard_neg_num > 0, **returns},
        )
        collator = MBEIRMainCollator(
            tokenizer=bundle.tokenizer, image_size=parse_image_size(data_config.image_size), mode=Mode.TRAIN,
            hard_neg_num=hard_neg_num,
        )
        sampler = EpochShuffleSampler(len(dataset), num_replicas=1, rank=0, seed=int(config.seed))
        return dataset, sampler, MBEIRLoader(
            dataset, collator, batch_size=int(batch_size), sampler=sampler,
            num_workers=int(config.dataloader_config.num_workers), drop_last=True,
        )

    train_dataset, train_sampler, train_loader = loader(
        "train", bundle.img_preprocess_fn, config.dataloader_config.train_batch_size
    )
    valid_loader = None
    if config.evaluator.enable_eval:
        valid_loader = loader("val", bundle.img_preprocess_fn_eval, config.dataloader_config.valid_batch_size)[2]

    accum = int(getattr(trainer_config, "gradient_accumulation_steps", 1))
    num_epochs = int(trainer_config.num_train_epochs)
    t_total = len(train_loader) // accum * num_epochs
    lr = float(trainer_config.learning_rate)
    warmup = int(getattr(trainer_config, "warmup_steps", 0))

    model = bundle.model
    optimizer, scheduler = make_clip_optimizer(
        model, lr, t_total, weight_decay=float(getattr(trainer_config, "weight_decay", 0.2)), warmup_steps=warmup
    )
    return {
        "bundle": bundle,
        "state": TrainState(model, optimizer, scheduler, accumulation_steps=accum),
        "train_step": make_clip_train_step(model, hard_neg_num=hard_neg_num, in_batch_neg_num=in_batch_neg_num),
        "eval_step": make_clip_eval_step(model, hard_neg_num=hard_neg_num, in_batch_neg_num=in_batch_neg_num),
        "train_loader": train_loader,
        "train_sampler": train_sampler,
        "train_dataset": train_dataset,
        "valid_loader": valid_loader,
        "lr_schedule": cosine_schedule(lr, t_total, warmup),
        "num_epochs": num_epochs,
    }


def _setup_file_logging(config) -> None:
    """Mirror the reference's train.log file handler (train.py:353-368)."""
    import logging

    logger_cfg = getattr(config, "logger_config", None)
    if logger_cfg is None:
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


def main(config, bundle=None, device=None) -> dict:
    np.random.seed(int(config.seed))
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

    best_inbatch_accuracy = 0.0
    best_epoch = 0
    last_stats: dict = {}
    eval_freq = int(getattr(config.evaluator, "eval_freq", 1))
    for epoch in range(start_epoch, setup["num_epochs"]):
        setup["train_sampler"].set_epoch(epoch)
        setup["train_dataset"].seed(int(config.seed) + epoch)
        state, train_stats = train_one_epoch(
            setup["train_step"], state, setup["train_loader"], epoch, config, lr_schedule=setup["lr_schedule"]
        )
        val_stats = None
        if setup["valid_loader"] is not None and epoch % eval_freq == 0:
            val_stats = eval_engine(setup["eval_step"], setup["valid_loader"], config)
            inbatch_accuracy = float(val_stats.get("inbatch_accuracy", 0.0))
            if inbatch_accuracy >= best_inbatch_accuracy:
                best_inbatch_accuracy = inbatch_accuracy
                best_epoch = epoch
        save_train_checkpoint(ckpt_dir, short_name, state, epoch, config)
        last_stats = log_results(train_stats, val_stats, None, epoch, best_epoch)
    return {"state": state, "stats": last_stats, "best_epoch": best_epoch}


def cli(argv=None):
    parser = argparse.ArgumentParser(description="uniir_tpu_torch trainer (CLIP-SF, one device)")
    parser.add_argument("--config_path", default="config.yaml", help="Path to the config file.")
    parser.add_argument("--uniir_dir", type=str, default="/data/UniIR")
    parser.add_argument("--mbeir_data_dir", type=str, default="/data/UniIR/mbeir_data")
    args = parser.parse_args(argv)
    config = load_config(args.config_path)
    config.uniir_dir = args.uniir_dir
    config.mbeir_data_dir = args.mbeir_data_dir
    wandb_cfg = getattr(config, "wandb_config", None)
    if wandb_cfg is not None and getattr(wandb_cfg, "enabled", False):
        raise NotImplementedError("wandb logging is not ported to uniir_tpu_torch yet (ROADMAP.md, Queue 1 item 7)")
    return main(config)


if __name__ == "__main__":
    cli()
