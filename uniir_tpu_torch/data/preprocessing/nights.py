"""NIGHTS -> M-BEIR converter (reference nights_data_preprocessor.py).

Perceptual image-similarity triplets: reference image is the query; the
human-voted (left/right) image is positive, the other negative.  Pool keys
are `<000-dir>/<filename>` (reference get_key_from_path :106-110).
"""

from __future__ import annotations

import argparse
import csv
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

DATASET = "NIGHTS"


def nights_image_rel_path(raw_path: str) -> str:
    return os.path.join("mbeir_images", "nights_images", os.path.splitext(raw_path)[0] + ".jpg")


def get_key_from_path(img_path: str) -> str:
    """`<000 folder>/<filename-no-ext>` content key (reference :106-110)."""
    _, tail = os.path.split(os.path.split(img_path)[0])
    filename = os.path.splitext(os.path.basename(img_path))[0]
    return os.path.join(tail, filename)


def load_nights_pool_as_dict(pool_file_path: str) -> dict:
    """Pool keyed by the 000-dir/filename key."""
    out = {}
    for entry in load_jsonl_as_list(pool_file_path):
        out[get_key_from_path(entry["img_path"])] = entry
    return out


def get_deduplicated_nights_data(nights_data: list) -> list:
    seen: dict = {}
    for entry in nights_data:
        if entry["id"] not in seen:
            seen[entry["id"]] = entry
    return list(seen.values())


def generate_nights_candidate_pool(nights_data: list, cand_pool_path: str, mbeir_data_dir: str) -> CandPoolBuilder:
    pool = CandPoolBuilder(DATASET)
    for entry in nights_data:
        for field in ("left_path", "right_path"):
            img_path = nights_image_rel_path(entry[field])
            if checked_image(mbeir_data_dir, img_path):
                pool.add(None, img_path, "image")
    pool.save(cand_pool_path)
    return pool


def nights_to_mbeir_entry(entry: dict, pool: dict, mbeir_data_dir: str, include_src_content: bool = True):
    query_img_path = nights_image_rel_path(entry["ref_path"])
    if not checked_image(mbeir_data_dir, query_img_path):
        print(f"Warning: Invalid query_img_path: {query_img_path}")
        return None
    src = None
    if include_src_content:
        src = json.dumps(
            {"id": entry["id"], "target": entry["right_vote"], "split": entry["split"], "is_imagenet": entry["is_imagenet"]}
        )
    mbeir_entry = new_query_entry(query_img_path=query_img_path, query_modality="image", query_src_content=src)

    if str(entry["right_vote"]) == "0":
        pos_key, neg_key = get_key_from_path(entry["left_path"]), get_key_from_path(entry["right_path"])
    elif str(entry["right_vote"]) == "1":
        pos_key, neg_key = get_key_from_path(entry["right_path"]), get_key_from_path(entry["left_path"])
    else:
        raise ValueError(f"Invalid right_vote value: {entry['right_vote']}")

    pos = pool.get(pos_key)
    neg = pool.get(neg_key)
    if not pos or not neg:
        print(f"Warning: Missing candidate for nights entry {entry['id']}")
        return None
    mbeir_entry["pos_cand_list"].append(pos["did"])
    mbeir_entry["neg_cand_list"].append(neg["did"])
    return mbeir_entry


def nights_to_mbeir(nights_data: list, candidate_pool_file_path: str, mbeir_data_dir: str) -> list:
    pool = load_nights_pool_as_dict(candidate_pool_file_path)
    out = []
    for entry in get_deduplicated_nights_data(nights_data):
        e = nights_to_mbeir_entry(entry, pool, mbeir_data_dir)
        if e is not None:
            out.append(e)
    return out


def load_nights_csv(path: str) -> list:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def main():
    parser = argparse.ArgumentParser(description="Format NIGHTS and refactor dataset to MBEIR format.")
    parser.add_argument("--mbeir_data_dir", type=str, default="/data/UniIR/mbeir_data/")
    parser.add_argument("--nights_images_dir", type=str, default="mbeir_images/nights_images/")
    parser.add_argument("--nights_dir", type=str, default="src_data/nights")
    parser.add_argument("--enable_image_processing", action="store_true")
    parser.add_argument("--enable_candidate_pool", action="store_true")
    parser.add_argument("--enable_mbeir_conversion", action="store_true")
    parser.add_argument("--enable_training_candidate_pool", action="store_true")
    add_device_argument(parser)
    args = parser.parse_args()

    nights_dir = os.path.join(args.mbeir_data_dir, args.nights_dir)
    pool_path = os.path.join(nights_dir, "mbeir_nights_cand_pool.jsonl")
    csv_path = os.path.join(nights_dir, "data.csv")

    if args.enable_image_processing:
        parallel_process_image_directory(os.path.join(args.mbeir_data_dir, args.nights_images_dir), device=args.device)
    if args.enable_candidate_pool:
        generate_nights_candidate_pool(load_nights_csv(csv_path), pool_path, args.mbeir_data_dir)
    if args.enable_mbeir_conversion:
        data = load_nights_csv(csv_path)
        for split in ("train", "val", "test"):
            split_data = [e for e in data if e.get("split") == split]
            entries = nights_to_mbeir(split_data, pool_path, args.mbeir_data_dir)
            finalize_queries(entries, DATASET, os.path.join(nights_dir, f"mbeir_nights_{split}.jsonl"), pool_path)
    if args.enable_training_candidate_pool:
        full_pool = load_mbeir_format_pool_file_as_dict(pool_path, doc_key_to_content=True, key_type="did")
        train = load_jsonl_as_list(os.path.join(nights_dir, "mbeir_nights_train.jsonl"))
        save_list_as_jsonl(
            build_training_cand_pool(train, full_pool), os.path.join(nights_dir, "mbeir_nights_train_cand_pool.jsonl")
        )


if __name__ == "__main__":
    main()
