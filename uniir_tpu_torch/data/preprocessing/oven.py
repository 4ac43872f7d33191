"""OVEN -> M-BEIR converter (reference oven_data_preprocessor.py).

Open-domain visual entity recognition: (image, question) queries against the
6M-entity Wiki pool.  Candidates are "<title>. <summary truncated to 100
tokens>" plus the entity's wiki image when valid (modality image,text else
text); pool chunks are built in parallel with contiguous did ranges.
"""

from __future__ import annotations

import argparse
import json
import os
import multiprocessing
from multiprocessing import cpu_count

from uniir_tpu_torch.data.preprocessing.base import build_training_cand_pool, checked_image, finalize_queries, new_query_entry
from uniir_tpu_torch.data.preprocessing.io_utils import (
    add_device_argument,
    load_jsonl_as_list,
    load_mbeir_format_pool_file_as_dict,
    parallel_process_image_directory,
    save_list_as_jsonl,
)
from uniir_tpu_torch.data.registry import format_string, get_dataset_id

DATASET = "OVEN"
DATASET_ID = get_dataset_id(DATASET)
WIKI_IMAGES_SUBDIR = os.path.join("mbeir_images", "oven_images", "wikipedia_images_full")


def get_directory_for_id(wikidata_id: str) -> str:
    return wikidata_id[:4] if len(wikidata_id) > 4 else wikidata_id


def truncate_summary_to_max_tokens(summary: str, max_tokens: int = 100) -> str:
    return " ".join((summary or "").split()[:max_tokens])


def oven_query_image_rel_path(image_id: str) -> str:
    # images are bucketed by the two chars at [-8:-6] of the id
    return os.path.join("mbeir_images", "oven_images", image_id[-8:-6], f"{image_id}.jpg")


def wiki_image_rel_path(wikidata_id: str) -> str:
    return os.path.join(WIKI_IMAGES_SUBDIR, get_directory_for_id(wikidata_id), f"{wikidata_id}.jpg")


def get_deduplicated_data(entries: list, key: str = "wikidata_id") -> list:
    seen: dict = {}
    for e in entries:
        if e[key] not in seen:
            seen[e[key]] = e
    return list(seen.values())


def _wiki_entry_to_candidate(wiki_entry: dict, document_id: int, mbeir_data_dir: str, include_src_content: bool = True):
    wikidata_id = wiki_entry["wikidata_id"]
    modality, img_path = "text", None
    if wiki_entry.get("wikipedia_image_url"):
        img_path = wiki_image_rel_path(wikidata_id)
        if checked_image(mbeir_data_dir, img_path):
            modality = "image,text"
        else:
            img_path = None
    txt = format_string(f"{wiki_entry['wikipedia_title']}. {truncate_summary_to_max_tokens(wiki_entry.get('wikipedia_content', ''))}")
    if not txt:
        return None
    entry = {"txt": txt, "img_path": img_path, "modality": modality, "did": f"{DATASET_ID}:{document_id}"}
    if include_src_content:
        entry["src_content"] = json.dumps(
            {"wikidata_id": wikidata_id, "wikipedia_title": wiki_entry.get("wikipedia_title", "")}
        )
    return entry


def _pool_chunk(args):
    chunk, start_id, mbeir_data_dir, include_src = args
    out = []
    did = start_id
    for wiki_entry in chunk:
        cand = _wiki_entry_to_candidate(wiki_entry, did, mbeir_data_dir, include_src)
        if cand is not None:
            out.append(cand)
        did += 1  # ids advance per input row so chunk ranges stay contiguous
    return out


def parallel_generate_oven_candidate_pool(wiki6m_file_path: str, cand_pool_path: str, mbeir_data_dir: str, include_src_content: bool = True, num_processes: int = 0):
    data = get_deduplicated_data(load_jsonl_as_list(wiki6m_file_path))
    num_processes = num_processes or max(1, cpu_count() // 4)
    chunk_size = -(-len(data) // num_processes)
    chunks = [data[i : i + chunk_size] for i in range(0, len(data), chunk_size)]
    start_ids = [1]
    for c in chunks[:-1]:
        start_ids.append(start_ids[-1] + len(c))
    # spawn, not fork: fork of a multithreaded JAX process deadlocks / wedges
    # the parent's pool-teardown join (see io_utils.parallel_process_image_directory)
    with multiprocessing.get_context("spawn").Pool(len(chunks)) as p:
        results = p.map(_pool_chunk, [(chunks[i], start_ids[i], mbeir_data_dir, include_src_content) for i in range(len(chunks))])
    pool_entries = [e for chunk in results for e in chunk]
    save_list_as_jsonl(pool_entries, cand_pool_path)
    print(f"OVEN candidate pool saved to {cand_pool_path} ({len(pool_entries)} entries)")
    return pool_entries


def load_oven_pool_by_wikidata_id(pool_file_path: str, doc_key_to_content: bool = False) -> dict:
    out = {}
    for entry in load_jsonl_as_list(pool_file_path):
        wikidata_id = json.loads(entry["src_content"])["wikidata_id"]
        out[wikidata_id] = entry if doc_key_to_content else entry["did"]
    return out


def oven_to_mbeir_entry(entry: dict, pool: dict, mbeir_data_dir: str, include_src_content: bool = True):
    query_img_path = oven_query_image_rel_path(entry["image_id"])
    if not checked_image(mbeir_data_dir, query_img_path):
        print(f"Warning: Invalid image {query_img_path} for oven entry {entry['data_id']}")
        return None
    mbeir_entry = new_query_entry(
        query_txt=format_string(entry["question"]), query_img_path=query_img_path, query_modality="image,text"
    )
    pos_did = pool.get(entry["entity_id"])
    if not pos_did:
        print(f"Warning: No positive candidate for oven entry {entry['data_id']}")
        return None
    mbeir_entry["pos_cand_list"].append(pos_did)
    if include_src_content:
        mbeir_entry["query_src_content"] = json.dumps(
            {
                "data_id": entry["data_id"],
                "image_id": entry["image_id"],
                "entity_id": entry["entity_id"],
                "data_split": entry["data_split"],
            }
        )
    return mbeir_entry


def oven_to_mbeir(oven_data: list, candidate_pool_file_path: str, mbeir_data_dir: str) -> list:
    pool = load_oven_pool_by_wikidata_id(candidate_pool_file_path)
    out = []
    for entry in get_deduplicated_data(oven_data, key="data_id"):
        e = oven_to_mbeir_entry(entry, pool, mbeir_data_dir)
        if e is not None:
            out.append(e)
    return out


def main():
    parser = argparse.ArgumentParser(description="Format OVEN and refactor dataset to MBEIR format.")
    parser.add_argument("--mbeir_data_dir", type=str, default="/data/UniIR/mbeir_data/")
    parser.add_argument("--oven_images_dir", type=str, default="mbeir_images/oven_images/")
    parser.add_argument("--oven_dir", type=str, default="src_data/oven")
    parser.add_argument("--enable_image_processing", action="store_true")
    parser.add_argument("--enable_candidate_pool", action="store_true")
    parser.add_argument("--enable_mbeir_conversion", action="store_true")
    parser.add_argument("--enable_training_candidate_pool", action="store_true")
    add_device_argument(parser)
    args = parser.parse_args()

    oven_dir = os.path.join(args.mbeir_data_dir, args.oven_dir)
    pool_path = os.path.join(oven_dir, "mbeir_oven_cand_pool.jsonl")
    wiki6m = os.path.join(oven_dir, "Wiki6M_ver_1_0.jsonl")

    if args.enable_image_processing:
        parallel_process_image_directory(os.path.join(args.mbeir_data_dir, args.oven_images_dir), device=args.device)
    if args.enable_candidate_pool:
        parallel_generate_oven_candidate_pool(wiki6m, pool_path, args.mbeir_data_dir)
    if args.enable_mbeir_conversion:
        for split in ("train", "val"):
            p = os.path.join(oven_dir, f"oven_entity_{split}.jsonl")
            if not os.path.exists(p):
                continue
            entries = oven_to_mbeir(load_jsonl_as_list(p), pool_path, args.mbeir_data_dir)
            finalize_queries(entries, DATASET, os.path.join(oven_dir, f"mbeir_oven_{split}.jsonl"), pool_path)
    if args.enable_training_candidate_pool:
        full_pool = load_mbeir_format_pool_file_as_dict(pool_path, doc_key_to_content=True, key_type="did")
        train = load_jsonl_as_list(os.path.join(oven_dir, "mbeir_oven_train.jsonl"))
        save_list_as_jsonl(
            build_training_cand_pool(train, full_pool), os.path.join(oven_dir, "mbeir_oven_train_cand_pool.jsonl")
        )


if __name__ == "__main__":
    main()
