"""EDIS -> M-BEIR converter (reference edis_data_preprocessor.py).

Text queries over (image, headline) candidates with graded scores: score 3 ->
positive, scores 1/2 -> negative (reference :117-137).
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

DATASET = "EDIS"


def edis_image_rel_path(raw_image: str) -> str:
    return os.path.join("mbeir_images", "edis_images", raw_image)


def _candidate_args(candidate: dict, mbeir_data_dir: str):
    img_path = edis_image_rel_path(candidate["image"])
    txt = format_string(candidate["headline"])
    if txt and checked_image(mbeir_data_dir, img_path):
        return txt, img_path
    return None, None


def generate_edis_candidate_pool(edis_data: list, cand_pool_path: str, mbeir_data_dir: str) -> CandPoolBuilder:
    pool = CandPoolBuilder(DATASET)
    for entry in edis_data:
        for candidate in entry["candidates"]:
            txt, img_path = _candidate_args(candidate, mbeir_data_dir)
            if txt:
                pool.add(txt, img_path, "image,text")
    pool.save(cand_pool_path)
    return pool


def edis_to_mbeir_entry(entry: dict, pool: dict, mbeir_data_dir: str, include_src_content: bool = True):
    query_txt = format_string(entry["query"])
    if not query_txt:
        return None
    mbeir_entry = new_query_entry(query_txt=query_txt, query_modality="text")
    src = {"id": str(entry["id"]), "pos_cand_candidate_id_scores": [], "neg_cand_candidate_id_scores": []}

    for candidate in entry["candidates"]:
        txt, img_path = _candidate_args(candidate, mbeir_data_dir)
        if not txt:
            continue
        did = pool.get("-".join(p for p in (txt, img_path, "image,text") if p))
        assert did is not None, f"Document ID not found for candidate: {candidate}"
        record = {"candidate_id": str(candidate["candidate_id"]), "score": str(candidate["score"])}
        if candidate["score"] == 3:
            mbeir_entry["pos_cand_list"].append(did)
            src["pos_cand_candidate_id_scores"].append(record)
        else:  # scores 1 and 2 are negatives
            mbeir_entry["neg_cand_list"].append(did)
            src["neg_cand_candidate_id_scores"].append(record)

    if include_src_content:
        mbeir_entry["query_src_content"] = json.dumps(src)
    if not mbeir_entry["pos_cand_list"]:
        print(f"Warning: No positive candidates for query: {query_txt}")
        return None
    return mbeir_entry


def edis_to_mbeir(edis_data: list, candidate_pool_file_path: str, mbeir_data_dir: str) -> list:
    pool = load_mbeir_format_pool_file_as_dict(candidate_pool_file_path, doc_key_to_content=False)
    out = []
    for entry in edis_data:
        e = edis_to_mbeir_entry(entry, pool, mbeir_data_dir)
        if e is not None:
            out.append(e)
    return out


def main():
    parser = argparse.ArgumentParser(description="Format EDIS and refactor dataset to MBEIR format.")
    parser.add_argument("--mbeir_data_dir", type=str, default="/data/UniIR/mbeir_data/")
    parser.add_argument("--edis_images_dir", type=str, default="mbeir_images/edis_images/")
    parser.add_argument("--edis_dir", type=str, default="src_data/edis")
    parser.add_argument("--enable_image_processing", action="store_true")
    parser.add_argument("--enable_candidate_pool", action="store_true")
    parser.add_argument("--enable_mbeir_conversion", action="store_true")
    parser.add_argument("--enable_training_candidate_pool", action="store_true")
    add_device_argument(parser)
    args = parser.parse_args()

    edis_dir = os.path.join(args.mbeir_data_dir, args.edis_dir)
    pool_path = os.path.join(edis_dir, "mbeir_edis_cand_pool.jsonl")

    if args.enable_image_processing:
        parallel_process_image_directory(os.path.join(args.mbeir_data_dir, args.edis_images_dir), device=args.device)
    if args.enable_candidate_pool:
        all_data = []
        for split in ("train", "val", "test"):
            p = os.path.join(edis_dir, f"{split}.json")
            if os.path.exists(p):
                with open(p) as f:
                    all_data.extend(json.load(f))
        generate_edis_candidate_pool(all_data, pool_path, args.mbeir_data_dir)
    if args.enable_mbeir_conversion:
        for split in ("train", "val", "test"):
            p = os.path.join(edis_dir, f"{split}.json")
            if not os.path.exists(p):
                continue
            with open(p) as f:
                data = json.load(f)
            entries = edis_to_mbeir(data, pool_path, args.mbeir_data_dir)
            finalize_queries(entries, DATASET, os.path.join(edis_dir, f"mbeir_edis_{split}.jsonl"), pool_path)
    if args.enable_training_candidate_pool:
        full_pool = load_mbeir_format_pool_file_as_dict(pool_path, doc_key_to_content=True, key_type="did")
        train = load_jsonl_as_list(os.path.join(edis_dir, "mbeir_edis_train.jsonl"))
        save_list_as_jsonl(
            build_training_cand_pool(train, full_pool), os.path.join(edis_dir, "mbeir_edis_train_cand_pool.jsonl")
        )


if __name__ == "__main__":
    main()
