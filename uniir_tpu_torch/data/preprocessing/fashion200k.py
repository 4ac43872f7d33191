"""Fashion200K -> M-BEIR converter (reference fashion200k_data_preprocessor.py).

Product (image, description) pairs -> bidirectional t2i/i2t entries over a
text+image pool; raw label files `<img_path> <score> <description>` per split.
"""

from __future__ import annotations

import argparse
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

DATASET = "Fashion200K"


def f200k_image_rel_path(raw_img_path: str) -> str:
    # raw: 'women/<category>/.../x.jpeg' -> drop 'women/', .jpg extension
    parts = raw_img_path.split("/")
    base, _ = os.path.splitext("/".join(parts[1:]))
    return os.path.join("mbeir_images", "fashion200k_images", base + ".jpg")


def load_label_files(label_dir: str, split: str) -> list:
    """Parse `<img_path>\t<score>\t<description>` label lines for a split."""
    entries = []
    for fname in sorted(os.listdir(label_dir)):
        if split not in fname or not fname.endswith(".txt"):
            continue
        with open(os.path.join(label_dir, fname)) as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) < 3:
                    parts = line.split()
                    parts = [parts[0], parts[1], " ".join(parts[2:])]
                entries.append({"img_path": parts[0], "txt": parts[2]})
    return entries


def get_deduplicated_fashion200k_data(data: list) -> list:
    seen: dict = {}
    for entry in data:
        if entry["img_path"] not in seen:
            seen[entry["img_path"]] = entry
    return list(seen.values())


def generate_fashion200k_candidate_pool(data: list, cand_pool_path: str, mbeir_data_dir: str) -> CandPoolBuilder:
    pool = CandPoolBuilder(DATASET)
    for entry in data:
        txt = format_string(entry["txt"])
        img_path = f200k_image_rel_path(entry["img_path"])
        if txt:
            pool.add(txt, None, "text")
        if checked_image(mbeir_data_dir, img_path):
            pool.add(None, img_path, "image")
    pool.save(cand_pool_path)
    return pool


def fashion200k_to_mbeir_entry(entry: dict, pool: dict, mbeir_data_dir: str):
    img_path = f200k_image_rel_path(entry["img_path"])
    txt = format_string(entry["txt"])
    if not checked_image(mbeir_data_dir, img_path):
        print(f"Warning: Invalid query_img_path: {img_path}")
        return None

    img2txt = new_query_entry(query_img_path=img_path, query_modality="image")
    txt_did = pool.get(f"{txt}-text")
    if not txt_did:
        print(f"Warning: No positive candidate for query_img_path {img_path}")
        return None
    img2txt["pos_cand_list"].append(txt_did)

    txt2img = new_query_entry(query_txt=txt, query_modality="text")
    img_did = pool.get(f"{img_path}-image")
    if not img_did:
        print(f"Warning: No positive candidate for query_txt {txt}")
        return None
    txt2img["pos_cand_list"].append(img_did)
    return [img2txt, txt2img]


def fashion200k_to_mbeir(data: list, candidate_pool_file_path: str, mbeir_data_dir: str) -> list:
    pool = load_mbeir_format_pool_file_as_dict(candidate_pool_file_path, doc_key_to_content=False)
    out = []
    for entry in get_deduplicated_fashion200k_data(data):
        entries = fashion200k_to_mbeir_entry(entry, pool, mbeir_data_dir)
        if entries:
            out.extend(entries)
    return out


def main():
    parser = argparse.ArgumentParser(description="Format fashion200k and refactor dataset to MBEIR format.")
    parser.add_argument("--mbeir_data_dir", type=str, default="/data/UniIR/mbeir_data/")
    parser.add_argument("--fashion200k_images_dir", type=str, default="mbeir_images/fashion200k_images/")
    parser.add_argument("--fashion200k_dir", type=str, default="src_data/fashion200k")
    parser.add_argument("--enable_image_processing", action="store_true")
    parser.add_argument("--enable_candidate_pool", action="store_true")
    parser.add_argument("--enable_mbeir_conversion", action="store_true")
    parser.add_argument("--enable_training_candidate_pool", action="store_true")
    add_device_argument(parser)
    args = parser.parse_args()

    f_dir = os.path.join(args.mbeir_data_dir, args.fashion200k_dir)
    label_dir = os.path.join(f_dir, "labels")
    pool_path = os.path.join(f_dir, "mbeir_fashion200k_cand_pool.jsonl")

    if args.enable_image_processing:
        parallel_process_image_directory(os.path.join(args.mbeir_data_dir, args.fashion200k_images_dir), device=args.device)
    if args.enable_candidate_pool:
        all_data = load_label_files(label_dir, "train") + load_label_files(label_dir, "test")
        generate_fashion200k_candidate_pool(all_data, pool_path, args.mbeir_data_dir)
    if args.enable_mbeir_conversion:
        for split in ("train", "test"):
            data = load_label_files(label_dir, split)
            entries = fashion200k_to_mbeir(data, pool_path, args.mbeir_data_dir)
            finalize_queries(entries, DATASET, os.path.join(f_dir, f"mbeir_fashion200k_{split}.jsonl"), pool_path)
    if args.enable_training_candidate_pool:
        full_pool = load_mbeir_format_pool_file_as_dict(pool_path, doc_key_to_content=True, key_type="did")
        train = load_jsonl_as_list(os.path.join(f_dir, "mbeir_fashion200k_train.jsonl"))
        save_list_as_jsonl(
            build_training_cand_pool(train, full_pool), os.path.join(f_dir, "mbeir_fashion200k_train_cand_pool.jsonl")
        )


if __name__ == "__main__":
    main()
