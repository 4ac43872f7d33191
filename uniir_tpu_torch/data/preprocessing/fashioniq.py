"""FashionIQ -> M-BEIR converter (reference fashioniq_data_preprocessor.py).

Composed (reference image + modification captions) -> target image retrieval.
Captions are lowercased/de-perioded and joined with " and " (reference
format_fashioniq_sentence :84-92).
"""

from __future__ import annotations

import argparse
import json
import os

from uniir_tpu_torch.data.preprocessing.base import CandPoolBuilder, build_training_cand_pool, checked_image, finalize_queries, new_query_entry
from uniir_tpu_torch.data.preprocessing.io_utils import (
    add_device_argument,
    load_jsonl_as_list,
    load_mbeir_format_pool_file_as_dict,
    parallel_process_image_directory,
    save_list_as_jsonl,
)
from uniir_tpu_torch.data.registry import format_string

DATASET = "FashionIQ"
CATEGORIES = ("dress", "shirt", "toptee")


def fiq_image_rel_path(image_id: str) -> str:
    return os.path.join("mbeir_images", "fashioniq_images", image_id + ".jpg")


def format_fashioniq_sentence(sentence: str) -> str:
    sentence = sentence.strip()
    if not sentence:
        return sentence
    sentence = sentence[0].lower() + sentence[1:]
    return sentence[:-1] if sentence.endswith(".") else sentence


def load_fiq_pool_as_dict(pool_file_path: str) -> dict:
    """Pool keyed by raw image id (reference :143-157)."""
    out = {}
    for entry in load_jsonl_as_list(pool_file_path):
        image_id = os.path.splitext(os.path.basename(entry["img_path"]))[0]
        out[image_id] = entry
    return out


def generate_fashioniq_candidate_pool(image_ids: list, cand_pool_path: str, mbeir_data_dir: str) -> CandPoolBuilder:
    pool = CandPoolBuilder(DATASET)
    for image_id in image_ids:
        img_path = fiq_image_rel_path(image_id)
        if checked_image(mbeir_data_dir, img_path):
            pool.add(None, img_path, "image")
    pool.save(cand_pool_path)
    return pool


def fashioniq_to_mbeir_entry(entry: dict, pool: dict, mbeir_data_dir: str, include_src_content: bool = True, concatenate_captions: bool = True) -> list:
    if concatenate_captions:
        filtered = [format_fashioniq_sentence(c) for c in entry["captions"] if c]
        caption = format_string(" and ".join(filtered))
        if not caption:
            return []
        captions = [caption]
    else:
        captions = [format_string(c) for c in entry["captions"] if format_string(c)]

    out = []
    for caption in captions:
        query_img_path = fiq_image_rel_path(entry["candidate"])
        if not checked_image(mbeir_data_dir, query_img_path):
            print(f"Warning: Invalid query_img_path : {query_img_path}")
            continue
        src = json.dumps({"candidate_img_id": entry["candidate"]}) if include_src_content else None
        mbeir_entry = new_query_entry(
            query_txt=caption, query_img_path=query_img_path, query_modality="image,text", query_src_content=src
        )
        pos = pool.get(entry["target"])
        if not pos:
            print(f"Warning: No positive candidate for {entry['target']}")
            continue
        mbeir_entry["pos_cand_list"].append(pos["did"])
        out.append(mbeir_entry)
    return out


def fashioniq_to_mbeir(data: list, candidate_pool_file_path: str, mbeir_data_dir: str) -> list:
    pool = load_fiq_pool_as_dict(candidate_pool_file_path)
    out = []
    for entry in data:
        out.extend(fashioniq_to_mbeir_entry(entry, pool, mbeir_data_dir))
    return out


def main():
    parser = argparse.ArgumentParser(description="Format FashionIQ and refactor dataset to MBEIR format.")
    parser.add_argument("--mbeir_data_dir", type=str, default="/data/UniIR/mbeir_data/")
    parser.add_argument("--fashioniq_images_dir", type=str, default="mbeir_images/fashioniq_images/")
    parser.add_argument("--fashioniq_dir", type=str, default="src_data/fashioniq")
    parser.add_argument("--enable_image_processing", action="store_true")
    parser.add_argument("--enable_candidate_pool", action="store_true")
    parser.add_argument("--enable_mbeir_conversion", action="store_true")
    parser.add_argument("--enable_training_candidate_pool", action="store_true")
    add_device_argument(parser)
    args = parser.parse_args()

    fiq_dir = os.path.join(args.mbeir_data_dir, args.fashioniq_dir)
    pool_path = os.path.join(fiq_dir, "mbeir_fashioniq_cand_pool.jsonl")

    if args.enable_image_processing:
        parallel_process_image_directory(os.path.join(args.mbeir_data_dir, args.fashioniq_images_dir), device=args.device)
    if args.enable_candidate_pool:
        image_ids = []
        for cat in CATEGORIES:
            for split in ("train", "val", "test"):
                p = os.path.join(fiq_dir, "image_splits", f"split.{cat}.{split}.json")
                if os.path.exists(p):
                    with open(p) as f:
                        image_ids.extend(json.load(f))
        generate_fashioniq_candidate_pool(image_ids, pool_path, args.mbeir_data_dir)
    if args.enable_mbeir_conversion:
        for split in ("train", "val"):
            data = []
            for cat in CATEGORIES:
                p = os.path.join(fiq_dir, "captions", f"cap.{cat}.{split}.json")
                if os.path.exists(p):
                    with open(p) as f:
                        data.extend(json.load(f))
            entries = fashioniq_to_mbeir(data, pool_path, args.mbeir_data_dir)
            finalize_queries(entries, DATASET, os.path.join(fiq_dir, f"mbeir_fashioniq_{split}.jsonl"), pool_path)
    if args.enable_training_candidate_pool:
        full_pool = load_mbeir_format_pool_file_as_dict(pool_path, doc_key_to_content=True, key_type="did")
        train = load_jsonl_as_list(os.path.join(fiq_dir, "mbeir_fashioniq_train.jsonl"))
        save_list_as_jsonl(
            build_training_cand_pool(train, full_pool), os.path.join(fiq_dir, "mbeir_fashioniq_train_cand_pool.jsonl")
        )


if __name__ == "__main__":
    main()
