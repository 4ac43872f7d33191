"""MSCOCO -> M-BEIR converter (reference mscoco_data_preprocessor.py).

Karpathy-split caption JSONs -> bidirectional (t2i, i2t) query entries over a
content-deduplicated pool of images + captions (first 5 captions per image),
with separate val/test text/image sub-pools and a 100K trim of the t2i train
queries (reference :474-486).
"""

from __future__ import annotations

import argparse
import json
import os
import random

from uniir_tpu_torch.data.preprocessing.base import CandPoolBuilder, checked_image, finalize_queries, new_query_entry
from uniir_tpu_torch.data.preprocessing.io_utils import (
    add_device_argument,
    load_jsonl_as_list,
    load_mbeir_format_pool_file_as_dict,
    parallel_process_image_directory,
    save_list_as_jsonl,
)
from uniir_tpu_torch.data.preprocessing.base import build_training_cand_pool
from uniir_tpu_torch.data.registry import format_string

DATASET = "MSCOCO"


def coco_image_rel_path(raw_image: str) -> str:
    sub_directory, base = os.path.split(raw_image)
    return os.path.join("mbeir_images", "mscoco_images", sub_directory, os.path.splitext(base)[0] + ".jpg")


def _captions(entry: dict) -> list:
    caps = entry["caption"] if isinstance(entry["caption"], list) else [entry["caption"]]
    return [format_string(c) for c in caps[:5] if format_string(c)]


def generate_mscoco_candidate_pool(mscoco_dir: str, mbeir_data_dir: str, out_paths: dict) -> CandPoolBuilder:
    """Build the full pool + split-specific text/image sub-pools.

    out_paths keys: all, txt_val, txt_test, img_val, img_test.
    """
    pool = CandPoolBuilder(DATASET)
    sub = {k: [] for k in ("txt_val", "txt_test", "img_val", "img_test")}
    seen_sub = {k: set() for k in sub}

    files = sorted(
        os.path.join(mscoco_dir, f)
        for f in os.listdir(mscoco_dir)
        if f.endswith(".json") and "coco_karpathy" in f
    )
    for path in files:
        base = os.path.basename(path)
        split = "val" if "val" in base else ("test" if "test" in base else None)
        with open(path) as f:
            data = json.load(f)
        for entry in data:
            img_path = checked_image(mbeir_data_dir, coco_image_rel_path(entry["image"]))
            if img_path:
                img_cand = pool.add(None, img_path, "image")
                if split and img_path not in seen_sub[f"img_{split}"]:
                    sub[f"img_{split}"].append(img_cand)
                    seen_sub[f"img_{split}"].add(img_path)
            else:
                print(f"Warning: Invalid image: {coco_image_rel_path(entry['image'])}")
            for txt in _captions(entry):
                txt_cand = pool.add(txt, None, "text")
                if split and txt not in seen_sub[f"txt_{split}"]:
                    sub[f"txt_{split}"].append(txt_cand)
                    seen_sub[f"txt_{split}"].add(txt)

    pool.save(out_paths["all"])
    for key in sub:
        save_list_as_jsonl(sub[key], out_paths[key])
        print(f"{key} candidate pool saved to {out_paths[key]} ({len(sub[key])} entries)")
    return pool


def mscoco_to_mbeir_entry(entry: dict, pool, mbeir_data_dir: str) -> list:
    img_path = coco_image_rel_path(entry["image"])
    if not checked_image(mbeir_data_dir, img_path):
        print(f"Warning: Invalid image: {img_path}")
        return []
    out = []
    img2txt = new_query_entry(query_img_path=img_path, query_modality="image")
    for txt in _captions(entry):
        did = pool.get(f"{txt}-text")
        did = did["did"] if isinstance(did, dict) else did
        assert did, f"Cannot find candidate for {txt}"
        img2txt["pos_cand_list"].append(did)
        txt2img = new_query_entry(query_txt=txt, query_modality="text")
        img_did = pool.get(f"{img_path}-image")
        img_did = img_did["did"] if isinstance(img_did, dict) else img_did
        assert img_did, f"Cannot find candidate for {img_path}"
        txt2img["pos_cand_list"].append(img_did)
        out.append(txt2img)
    out.append(img2txt)
    return out


def mscoco_to_mbeir(mscoco_data: list, candidate_pool_file_path: str, mbeir_data_dir: str) -> list:
    pool = load_mbeir_format_pool_file_as_dict(candidate_pool_file_path, doc_key_to_content=False)
    out = []
    for entry in mscoco_data:
        out.extend(mscoco_to_mbeir_entry(entry, pool, mbeir_data_dir))
    return out


def convert_splits(mscoco_dir: str, mbeir_data_dir: str, candidate_pool_path: str, trim_train_t2i: int = 100_000):
    for split in ("train", "val", "test"):
        src = os.path.join(mscoco_dir, f"coco_karpathy_{split}.json")
        with open(src) as f:
            data = json.load(f)
        entries = mscoco_to_mbeir(data, candidate_pool_path, mbeir_data_dir)
        from uniir_tpu_torch.data.preprocessing.io_utils import aggregate_candidates_for_mbeir_format_dataset

        entries = aggregate_candidates_for_mbeir_format_dataset(entries, print_duplicate=False)
        if split == "train":  # trim t2i queries to 100K (reference :474-486)
            t2i = [e for e in entries if e["query_modality"] == "text"]
            i2t = [e for e in entries if e["query_modality"] != "text"]
            random.seed(2023)
            random.shuffle(t2i)
            entries = t2i[:trim_train_t2i] + i2t
            random.shuffle(entries)
        finalize_queries(
            entries,
            DATASET,
            os.path.join(mscoco_dir, f"mbeir_mscoco_{split}.jsonl"),
            candidate_pool_path,
            aggregate=False,
        )


def separate_val_test_to_txt_img(mscoco_dir: str) -> None:
    for split in ("val", "test"):
        data = load_jsonl_as_list(os.path.join(mscoco_dir, f"mbeir_mscoco_{split}.jsonl"))
        txt = [e for e in data if e["query_modality"] == "text"]
        img = [e for e in data if e["query_modality"] != "text"]
        save_list_as_jsonl(txt, os.path.join(mscoco_dir, f"mbeir_mscoco_txt_{split}.jsonl"))
        save_list_as_jsonl(img, os.path.join(mscoco_dir, f"mbeir_mscoco_img_{split}.jsonl"))


def main():
    parser = argparse.ArgumentParser(description="Format mscoco images and refactor dataset to MBEIR format.")
    parser.add_argument("--mbeir_data_dir", type=str, default="/data/UniIR/mbeir_data/")
    parser.add_argument("--mscoco_images_dir", type=str, default="mbeir_images/mscoco_images/")
    parser.add_argument("--mscoco_dir", type=str, default="src_data/mscoco")
    parser.add_argument("--enable_image_processing", action="store_true")
    parser.add_argument("--enable_candidate_pool", action="store_true")
    parser.add_argument("--enable_mbeir_conversion", action="store_true")
    parser.add_argument("--enable_training_candidate_pool", action="store_true")
    add_device_argument(parser)
    parser.add_argument("--separate_val_test_to_txt_img", action="store_true")
    args = parser.parse_args()

    mscoco_dir = os.path.join(args.mbeir_data_dir, args.mscoco_dir)
    pool_path = os.path.join(mscoco_dir, "mbeir_mscoco_cand_pool.jsonl")

    if args.enable_image_processing:
        parallel_process_image_directory(os.path.join(args.mbeir_data_dir, args.mscoco_images_dir), device=args.device)
    if args.enable_candidate_pool:
        generate_mscoco_candidate_pool(
            mscoco_dir,
            args.mbeir_data_dir,
            {
                "all": pool_path,
                "txt_val": os.path.join(mscoco_dir, "mbeir_mscoco_txt_val_cand_pool.jsonl"),
                "txt_test": os.path.join(mscoco_dir, "mbeir_mscoco_txt_test_cand_pool.jsonl"),
                "img_val": os.path.join(mscoco_dir, "mbeir_mscoco_img_val_cand_pool.jsonl"),
                "img_test": os.path.join(mscoco_dir, "mbeir_mscoco_img_test_cand_pool.jsonl"),
            },
        )
    if args.enable_mbeir_conversion:
        convert_splits(mscoco_dir, args.mbeir_data_dir, pool_path)
    if args.enable_training_candidate_pool:
        full_pool = load_mbeir_format_pool_file_as_dict(pool_path, doc_key_to_content=True, key_type="did")
        train = load_jsonl_as_list(os.path.join(mscoco_dir, "mbeir_mscoco_train.jsonl"))
        save_list_as_jsonl(
            build_training_cand_pool(train, full_pool),
            os.path.join(mscoco_dir, "mbeir_mscoco_train_cand_pool.jsonl"),
        )
    if args.separate_val_test_to_txt_img:
        separate_val_test_to_txt_img(mscoco_dir)


if __name__ == "__main__":
    main()
