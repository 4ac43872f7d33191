"""Offline static-int8 activation calibration CLI (counterpart of
uniir_tpu/tools/calibrate_int8.py), for any of the four retrievers.

Produces the calibration artifact that `UNIIR_INT8_BACKEND=static` serving
consumes: activation scales per int8 layer owner (pre-LN MLP and attention
pairs, T5's attention and FFN pairs, MED's attention triples and FFN pairs),
measured by running the float model in its compute dtype over real M-BEIR
probe batches (BLIP's carry the token dict).  The .npz has the JAX
package's format (whose loader refuses MED's triples).

    python -m uniir_tpu_torch.tools.calibrate_int8 \\
        --config_path configs/clip_sf/large/eval/inbatch/embed.yaml \\
        --uniir_dir /data/UniIR --mbeir_data_dir /data/UniIR/mbeir_data \\
        --out calib_clip_sf_large.npz --num_batches 8

Then serve with `model.int8: true`, `model.int8_calibration:
calib_clip_sf_large.npz` and `UNIIR_INT8_BACKEND=static`
(`models/registry.py` loads the artifact into the quantised model).

Probe data: the first enabled split / dataset of the embed config's sweep --
query batches exercise both towers, so one pass calibrates every block.
See `ops/calibrate.py` for the measurement itself.
"""

from __future__ import annotations

import argparse
import itertools
import os

from uniir_tpu_torch.core.config import load_config, parse_image_size
from uniir_tpu_torch.core.device import module_device
from uniir_tpu_torch.data.collator import MBEIRMainCollator
from uniir_tpu_torch.data.dataset import MBEIRMainDataset, Mode
from uniir_tpu_torch.data.loader import ContiguousSampler, MBEIRLoader
from uniir_tpu_torch.models.registry import build_model_from_config
from uniir_tpu_torch.ops.calibrate import calibrate_act_scales, save_act_scales

MODEL_INPUT_KEYS = ("txt_batched", "image_batched", "txt_mask_batched", "image_mask_batched")


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(description="uniir_tpu_torch static-int8 calibration")
    parser.add_argument("--uniir_dir", type=str, default="/data/UniIR")
    parser.add_argument("--mbeir_data_dir", type=str, default="/data/UniIR/mbeir_data")
    parser.add_argument("--config_path", default="config.yaml", help="embed.yaml-style config")
    parser.add_argument("--out", required=True, help="output .npz calibration artifact")
    parser.add_argument("--num_batches", type=int, default=8, help="probe batches to observe")
    parser.add_argument("--batch_size", type=int, default=0, help="0 = config's dataloader batch size")
    parser.add_argument("--margin", type=float, default=1.1, help="amax clip headroom multiplier")
    parser.add_argument("--device", default=None, help="cuda (the default; without a card it is an error) or cpu")
    return parser.parse_args(argv)


def first_probe_loader(bundle, config, batch_size: int):
    """Query loader for the first enabled split/dataset of the embed sweep."""
    data_config = config.data_config
    embed_config = config.embed_config
    for split_name in ("test", "val", "train"):
        ds_cfg = getattr(embed_config, f"{split_name}_datasets_config", None)
        if not (ds_cfg and ds_cfg.enable_embed):
            continue
        split_dir = getattr(data_config, f"{split_name}_dir_name")
        dataset_name = ds_cfg.datasets_name[0].lower()
        cand_pool_name = ds_cfg.correspond_cand_pools_name[0].lower()
        dataset = MBEIRMainDataset(
            mbeir_data_dir=config.mbeir_data_dir,
            query_data_path=os.path.join(split_dir, f"mbeir_{dataset_name}_{split_name}.jsonl"),
            cand_pool_path=os.path.join(data_config.cand_pool_dir_name, f"mbeir_{cand_pool_name}_cand_pool.jsonl"),
            query_instruct_path=data_config.query_instruct_path,
            img_preprocess_fn=bundle.img_preprocess_fn_eval,
            mode=Mode.EVAL,
            enable_query_instruct=data_config.enable_query_instruct,
            shuffle_cand=data_config.shuffle_cand,
            device=module_device(bundle.model),
        )
        collator = MBEIRMainCollator(
            tokenizer=bundle.tokenizer, image_size=parse_image_size(data_config.image_size), mode=Mode.EVAL
        )
        return MBEIRLoader(
            dataset,
            collator,
            batch_size=batch_size,
            sampler=ContiguousSampler(len(dataset), num_replicas=1, rank=0),
            num_workers=config.dataloader_config.num_workers,
            drop_last=False,
            pad_last=True,
        )
    raise ValueError("no enabled split in embed config to probe from")


def probe_batches(loader, num_batches: int) -> list:
    """The first `num_batches` collated batches as model-argument tuples."""
    return [tuple(batch[key] for key in MODEL_INPUT_KEYS) for batch in itertools.islice(iter(loader), num_batches)]


def calibrate(bundle, config, out: str, num_batches: int = 8, batch_size: int = 0, margin: float = 1.1) -> dict:
    """Probe `bundle`'s float model over the config's first enabled split and
    write the artifact to `out`; returns the scales."""
    loader = first_probe_loader(bundle, config, batch_size or config.dataloader_config.batch_size)
    batches = probe_batches(loader, num_batches)
    if not batches:
        raise ValueError("probe loader yielded no batches")
    scales = calibrate_act_scales(bundle.model, batches, margin=margin)
    save_act_scales(out, scales)
    print(f"Calibrated {len(scales)} act-scale entries over {len(batches)} batches -> {out}")
    return scales


def main(argv=None, bundle=None):
    """`bundle`: a prebuilt float ModelBundle (tests); else built from the config."""
    args = parse_arguments(argv)
    config = load_config(args.config_path)
    config.uniir_dir = args.uniir_dir
    config.mbeir_data_dir = args.mbeir_data_dir
    # calibration observes the FLOAT model's activations
    if getattr(config.model, "int8", False):
        config.model.int8 = False
    if bundle is None:
        bundle = build_model_from_config(config, device=args.device)
    calibrate(bundle, config, args.out, args.num_batches, args.batch_size, args.margin)


if __name__ == "__main__":
    main()
