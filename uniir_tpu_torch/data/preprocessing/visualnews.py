"""VisualNews -> M-BEIR converter (reference visualnews_data_preprocessor.py).

News (image, caption) pairs from four sources -> bidirectional t2i/i2t
entries; per-source balanced train/val/test split (reference split_data
:213-229).
"""

from __future__ import annotations

import argparse
import json
import os
import random

from uniir_tpu_torch.data.preprocessing.base import CandPoolBuilder, build_training_cand_pool, checked_image, finalize_queries, new_query_entry
from uniir_tpu_torch.data.preprocessing.io_utils import (
    add_device_argument,
    load_jsonl_as_list,
    load_mbeir_format_pool_file_as_dict,
    parallel_process_image_directory,
    save_list_as_jsonl,
)
from uniir_tpu_torch.data.registry import format_string

DATASET = "VisualNews"
SOURCES = ["washington_post", "guardian", "bbc", "usa_today"]


def vn_image_rel_path(raw_path: str) -> str:
    # raw paths look like './guardian/images/.../x.jpg'
    return os.path.join("mbeir_images", "visualnews_images", raw_path[2:])


def generate_visualnews_candidate_pool(source_file_path: str, cand_pool_path: str, mbeir_data_dir: str) -> CandPoolBuilder:
    with open(source_file_path) as f:
        data = json.load(f)
    pool = CandPoolBuilder(DATASET)
    for entry in data:
        img_path = vn_image_rel_path(entry["image_path"])
        caption = format_string(entry["caption"])
        if caption:
            pool.add(caption, None, "text")
        else:
            print(f"Warning: Empty caption: {img_path}")
        if checked_image(mbeir_data_dir, img_path):
            pool.add(None, img_path, "image")
        else:
            print(f"Warning: Invalid image: {img_path}")
    pool.save(cand_pool_path)
    return pool


def visualnews_to_mbeir_entry(entry: dict, pool: dict, mbeir_data_dir: str) -> list:
    img_path = vn_image_rel_path(entry["image_path"])
    if not checked_image(mbeir_data_dir, img_path):
        print(f"Warning: Invalid image: {img_path}")
        return []
    txt = format_string(entry["caption"])
    if not txt:
        print(f"Warning: Empty caption: {entry}")
        return []

    img2txt = new_query_entry(query_img_path=img_path, query_modality="image")
    txt_did = pool.get(f"{txt}-text")
    assert txt_did, f"Cannot find candidate for {txt}"
    img2txt["pos_cand_list"].append(txt_did)

    txt2img = new_query_entry(query_txt=txt, query_modality="text")
    img_did = pool.get(f"{img_path}-image")
    assert img_did, f"Cannot find candidate for {img_path}"
    txt2img["pos_cand_list"].append(img_did)
    return [img2txt, txt2img]


def visualnews_to_mbeir(data: list, candidate_pool_file_path: str, mbeir_data_dir: str) -> list:
    pool = load_mbeir_format_pool_file_as_dict(candidate_pool_file_path, doc_key_to_content=False)
    out = []
    for entry in data:
        out.extend(visualnews_to_mbeir_entry(entry, pool, mbeir_data_dir))
    return out


def split_data(data: list, train_samples: int, val_samples: int, test_samples: int):
    """Per-source balanced split with seed 2023 (reference :213-229)."""
    train, val, test = [], [], []
    for source in SOURCES:
        source_data = [e for e in data if e["source"] == source]
        random.seed(2023)
        random.shuffle(source_data)
        train.extend(source_data[:train_samples])
        val.extend(source_data[train_samples : train_samples + val_samples])
        test.extend(source_data[train_samples + val_samples : train_samples + val_samples + test_samples])
    return train, val, test


def main():
    parser = argparse.ArgumentParser(description="Format VisualNews and refactor dataset to MBEIR format.")
    parser.add_argument("--mbeir_data_dir", type=str, default="/data/UniIR/mbeir_data/")
    parser.add_argument("--visualnews_images_dir", type=str, default="mbeir_images/visualnews_images/")
    parser.add_argument("--visualnews_dir", type=str, default="src_data/visualnews")
    parser.add_argument("--enable_image_processing", action="store_true")
    parser.add_argument("--enable_candidate_pool", action="store_true")
    parser.add_argument("--enable_mbeir_conversion", action="store_true")
    parser.add_argument("--enable_training_candidate_pool", action="store_true")
    add_device_argument(parser)
    parser.add_argument("--train_samples", type=int, default=25_000)
    parser.add_argument("--val_samples", type=int, default=2_500)
    parser.add_argument("--test_samples", type=int, default=2_500)
    args = parser.parse_args()

    vn_dir = os.path.join(args.mbeir_data_dir, args.visualnews_dir)
    pool_path = os.path.join(vn_dir, "mbeir_visualnews_cand_pool.jsonl")
    source_path = os.path.join(vn_dir, "origin", "data.json")

    if args.enable_image_processing:
        parallel_process_image_directory(os.path.join(args.mbeir_data_dir, args.visualnews_images_dir), device=args.device)
    if args.enable_candidate_pool:
        generate_visualnews_candidate_pool(source_path, pool_path, args.mbeir_data_dir)
    if args.enable_mbeir_conversion:
        with open(source_path) as f:
            data = json.load(f)
        for split, split_data_ in zip(("train", "val", "test"), split_data(data, args.train_samples, args.val_samples, args.test_samples)):
            entries = visualnews_to_mbeir(split_data_, pool_path, args.mbeir_data_dir)
            finalize_queries(entries, DATASET, os.path.join(vn_dir, f"mbeir_visualnews_{split}.jsonl"), pool_path)
    if args.enable_training_candidate_pool:
        full_pool = load_mbeir_format_pool_file_as_dict(pool_path, doc_key_to_content=True, key_type="did")
        train = load_jsonl_as_list(os.path.join(vn_dir, "mbeir_visualnews_train.jsonl"))
        save_list_as_jsonl(
            build_training_cand_pool(train, full_pool), os.path.join(vn_dir, "mbeir_visualnews_train_cand_pool.jsonl")
        )


if __name__ == "__main__":
    main()
