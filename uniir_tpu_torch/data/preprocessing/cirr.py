"""CIRR -> M-BEIR converter (reference cirr_data_preprocessor.py).

Composed image retrieval: (reference image + relative caption) query; targets
from `target_soft` -- score 1.0 positive, anything else negative (reference
:113-121).  Pool keyed by the raw image name.
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

DATASET = "CIRR"


def cirr_image_rel_path(image_name: str, split_subdir: str) -> str:
    return os.path.join("mbeir_images", "cirr_images", split_subdir, image_name + ".jpg")


def load_cirr_pool_as_dict(pool_file_path: str) -> dict:
    """Pool keyed by raw image name (reference :132-146)."""
    out = {}
    for entry in load_jsonl_as_list(pool_file_path):
        name = os.path.splitext(os.path.basename(entry["img_path"]))[0]
        out[name] = entry
    return out


def get_deduplicated_cirr_data(cirr_data: list) -> list:
    """Merge entries sharing (reference, caption) -- union their targets."""
    seen: dict = {}
    for entry in cirr_data:
        key = (entry["reference"], entry["caption"])
        if key not in seen:
            seen[key] = dict(entry)
            seen[key]["target_soft"] = dict(entry["target_soft"])
        else:
            seen[key]["target_soft"].update(entry["target_soft"])
    return list(seen.values())


def generate_cirr_candidate_pool(image_split_map: dict, cand_pool_path: str, mbeir_data_dir: str) -> CandPoolBuilder:
    """image_split_map: {image_name: relative path under cirr_images}."""
    pool = CandPoolBuilder(DATASET)
    for image_name, rel in image_split_map.items():
        img_path = os.path.join("mbeir_images", "cirr_images", os.path.splitext(rel)[0] + ".jpg")
        if checked_image(mbeir_data_dir, img_path):
            pool.add(None, img_path, "image")
    pool.save(cand_pool_path)
    return pool


def cirr_to_mbeir_entry(entry: dict, pool: dict, mbeir_data_dir: str, include_src_content: bool = True):
    query = pool.get(entry["reference"])
    if not query:
        print(f"Warning: Can not fetch query image path for reference {entry['reference']}")
        return None
    query_img_path = query["img_path"]
    if not checked_image(mbeir_data_dir, query_img_path):
        print(f"Warning: Invalid query_img_path : {query_img_path}")
        return None
    query_txt = format_string(entry["caption"])
    if not query_txt:
        return None

    src = json.dumps({"id": str(entry.get("reference", ""))}) if include_src_content else None
    mbeir_entry = new_query_entry(
        query_txt=query_txt, query_img_path=query_img_path, query_modality="image,text", query_src_content=src
    )
    for target, value in entry["target_soft"].items():
        candidate = pool.get(target)
        if not candidate:
            print(f"Warning: Can not fetch candidate pool info from target {target}")
            continue
        if value == 1.0:
            mbeir_entry["pos_cand_list"].append(candidate["did"])
        else:  # 0.2 / 0.5 / -1 are negatives
            mbeir_entry["neg_cand_list"].append(candidate["did"])
    if not mbeir_entry["pos_cand_list"]:
        print(f"Warning: No positive candidate for reference {entry['reference']}")
        return None
    return mbeir_entry


def cirr_to_mbeir(cirr_data: list, candidate_pool_file_path: str, mbeir_data_dir: str) -> list:
    pool = load_cirr_pool_as_dict(candidate_pool_file_path)
    out = []
    for entry in get_deduplicated_cirr_data(cirr_data):
        e = cirr_to_mbeir_entry(entry, pool, mbeir_data_dir)
        if e is not None:
            out.append(e)
    return out


def main():
    parser = argparse.ArgumentParser(description="Format CIRR and refactor dataset to MBEIR format.")
    parser.add_argument("--mbeir_data_dir", type=str, default="/data/UniIR/mbeir_data/")
    parser.add_argument("--cirr_images_dir", type=str, default="mbeir_images/cirr_images/")
    parser.add_argument("--cirr_dir", type=str, default="src_data/cirr")
    parser.add_argument("--enable_image_processing", action="store_true")
    parser.add_argument("--enable_candidate_pool", action="store_true")
    parser.add_argument("--enable_mbeir_conversion", action="store_true")
    parser.add_argument("--enable_training_candidate_pool", action="store_true")
    add_device_argument(parser)
    args = parser.parse_args()

    cirr_dir = os.path.join(args.mbeir_data_dir, args.cirr_dir)
    pool_path = os.path.join(cirr_dir, "mbeir_cirr_cand_pool.jsonl")

    if args.enable_image_processing:
        parallel_process_image_directory(os.path.join(args.mbeir_data_dir, args.cirr_images_dir), device=args.device)
    if args.enable_candidate_pool:
        image_split_map = {}
        for split in ("train", "val", "test1"):
            p = os.path.join(cirr_dir, "image_splits", f"split.rc2.{split}.json")
            if os.path.exists(p):
                with open(p) as f:
                    image_split_map.update(json.load(f))
        generate_cirr_candidate_pool(image_split_map, pool_path, args.mbeir_data_dir)
    if args.enable_mbeir_conversion:
        for split in ("train", "val"):
            p = os.path.join(cirr_dir, "captions", f"cap.rc2.{split}.json")
            if not os.path.exists(p):
                continue
            with open(p) as f:
                data = json.load(f)
            entries = cirr_to_mbeir(data, pool_path, args.mbeir_data_dir)
            finalize_queries(entries, DATASET, os.path.join(cirr_dir, f"mbeir_cirr_{split}.jsonl"), pool_path)
    if args.enable_training_candidate_pool:
        full_pool = load_mbeir_format_pool_file_as_dict(pool_path, doc_key_to_content=True, key_type="did")
        train = load_jsonl_as_list(os.path.join(cirr_dir, "mbeir_cirr_train.jsonl"))
        save_list_as_jsonl(
            build_training_cand_pool(train, full_pool), os.path.join(cirr_dir, "mbeir_cirr_train_cand_pool.jsonl")
        )


if __name__ == "__main__":
    main()
