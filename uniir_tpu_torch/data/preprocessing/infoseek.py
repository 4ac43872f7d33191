"""INFOSEEK -> M-BEIR converter (reference infoseek_data_preprocessor.py).

Knowledge-seeking VQA over wiki entities: (image, question) queries; the
positive entity is resolved via the withkb mapping and kept only when its
wikipedia content string-contains the answer (reference contains_answer
:38-49).  The raw candidate pool collects those positives, then is converted
to M-BEIR format with the wikipedia content split into 100-token chunks,
each as a separate candidate "<title>. <chunk>" (reference :104-176).
"""

from __future__ import annotations

import argparse
import json
import os

from uniir_tpu_torch.data.preprocessing.base import build_training_cand_pool, checked_image, finalize_queries, new_query_entry
from uniir_tpu_torch.data.preprocessing.io_utils import (
    load_jsonl_as_list,
    load_mbeir_format_pool_file_as_dict,
    save_list_as_jsonl,
)
from uniir_tpu_torch.data.preprocessing.oven import (
    get_deduplicated_data,
    oven_query_image_rel_path,
    wiki_image_rel_path,
)
from uniir_tpu_torch.data.registry import format_string, get_dataset_id

DATASET = "INFOSEEK"
DATASET_ID = get_dataset_id(DATASET)


def contains_answer(wikipedia_content: str, answer: list, answer_eval: list) -> bool:
    for string in answer:
        if string in wikipedia_content:
            return True
    for entry in answer_eval:
        if isinstance(entry, str) and entry in wikipedia_content:
            return True
    return False


def split_into_substrings(txt: str, token_limit: int = 100) -> list:
    tokens = txt.split()
    return [" ".join(tokens[i : i + token_limit]) for i in range(0, len(tokens), token_limit)]


def convert_raw_infoseek_cand_pool_to_mbeir_format(raw_cand_pool_file_path: str, mbeir_data_dir: str, include_src_content: bool = True, skip_set=None) -> list:
    """Raw wiki entries -> per-100-token-chunk M-BEIR candidates (ref :104-176)."""
    raw = load_jsonl_as_list(raw_cand_pool_file_path)
    output = []
    document_id = 1
    for cand in raw:
        wikidata_id = cand["wikidata_id"]
        if skip_set and wikidata_id in skip_set:
            continue
        modality, img_path = "text", None
        if cand.get("wikipedia_image_url"):
            img_path = wiki_image_rel_path(wikidata_id)
            if checked_image(mbeir_data_dir, img_path):
                modality = "image,text"
            else:
                img_path = None
        wiki_content = format_string(cand["wikipedia_content"])
        if not wiki_content:
            print(f"Warning: Empty wiki_content for wikidata_id {wikidata_id}")
            continue
        for chunk in split_into_substrings(wiki_content, 100):
            entry = {
                "txt": format_string(f"{cand['wikipedia_title']}. {chunk}"),
                "img_path": img_path,
                "modality": modality,
                "did": f"{DATASET_ID}:{document_id}",
            }
            if include_src_content:
                entry["src_content"] = json.dumps(
                    {"wikidata_id": wikidata_id, "wikipedia_title": cand["wikipedia_title"]}
                )
            document_id += 1
            output.append(entry)
    return output


def infoseek_to_mbeir_entry(entry: dict, oven_cand_dict: dict, kb_dict: dict, qtype_dict, mbeir_data_dir: str, include_src_content: bool = True):
    """Returns (mbeir_entry, raw_pos_candidate) or (None, None)."""
    query_txt = format_string(entry["question"])
    if not query_txt:
        return None, None
    query_img_path = oven_query_image_rel_path(entry["image_id"])
    if not checked_image(mbeir_data_dir, query_img_path):
        print(f"Warning: Invalid image {query_img_path} for infoseek entry {entry['data_id']}")
        return None, None

    entity_id = kb_dict.get(entry["data_id"])
    pos_candidate = oven_cand_dict.get(entity_id)
    if not pos_candidate:
        print(f"Warning: No positive candidate for infoseek entry {entry['data_id']}")
        return None, None

    mbeir_entry = new_query_entry(query_txt=query_txt, query_img_path=query_img_path, query_modality="image,text")
    if include_src_content:
        src = {
            "data_id": entry["data_id"],
            "answer": entry["answer"],
            "answer_eval": entry["answer_eval"],
            "data_split": entry["data_split"],
            "entity_id": entity_id,
        }
        if qtype_dict:
            src["question_type"] = qtype_dict.get(entry["data_id"])
            assert src["question_type"] is not None, "Question type is missing!"
        mbeir_entry["query_src_content"] = json.dumps(src)

    if contains_answer(pos_candidate["wikipedia_content"], entry["answer"], entry["answer_eval"]):
        return mbeir_entry, pos_candidate
    return None, None


def infoseek_to_mbeir_and_create_raw_cand_pool(infoseek_data: list, oven_wiki6m_file_path: str, raw_cand_pool_file_path: str, kb_file_path: str, qtype_file_path, mbeir_data_dir: str) -> list:
    oven_cand_dict = {
        e["wikidata_id"]: e for e in load_jsonl_as_list(oven_wiki6m_file_path)
    }
    kb_dict = {e["data_id"]: e["entity_id"] for e in load_jsonl_as_list(kb_file_path)}
    qtype_dict = None
    if qtype_file_path:
        qtype_dict = {e["data_id"]: e["question_type"] for e in load_jsonl_as_list(qtype_file_path)}

    mbeir_entries = []
    raw_pool = []
    seen_wikidata = set()
    for entry in get_deduplicated_data(infoseek_data, key="data_id"):
        mbeir_entry, pos = infoseek_to_mbeir_entry(entry, oven_cand_dict, kb_dict, qtype_dict, mbeir_data_dir)
        if mbeir_entry is not None:
            mbeir_entries.append(mbeir_entry)
            if pos["wikidata_id"] not in seen_wikidata:
                raw_pool.append(pos)
                seen_wikidata.add(pos["wikidata_id"])
    save_list_as_jsonl(raw_pool, raw_cand_pool_file_path)
    return mbeir_entries


def update_mbeir_format_infoseek_data_with_cand_pool(mbeir_entries: list, cand_pool: list) -> list:
    """Resolve each query's positive dids: every chunk-candidate of its entity."""
    by_wikidata: dict = {}
    for cand in cand_pool:
        wikidata_id = json.loads(cand["src_content"])["wikidata_id"]
        by_wikidata.setdefault(wikidata_id, []).append(cand["did"])
    out = []
    for entry in mbeir_entries:
        entity_id = json.loads(entry["query_src_content"])["entity_id"]
        dids = by_wikidata.get(entity_id, [])
        if not dids:
            print(f"Warning: No candidates for entity {entity_id}")
            continue
        entry["pos_cand_list"] = dids
        out.append(entry)
    return out


def main():
    parser = argparse.ArgumentParser(description="Format INFOSEEK and refactor dataset to MBEIR format.")
    parser.add_argument("--mbeir_data_dir", type=str, default="/data/UniIR/mbeir_data/")
    parser.add_argument("--infoseek_dir", type=str, default="src_data/infoseek")
    parser.add_argument("--oven_dir", type=str, default="src_data/oven")
    parser.add_argument("--enable_mbeir_conversion", action="store_true")
    parser.add_argument("--enable_candidate_pool", action="store_true")
    parser.add_argument("--enable_training_candidate_pool", action="store_true")
    args = parser.parse_args()

    info_dir = os.path.join(args.mbeir_data_dir, args.infoseek_dir)
    oven_dir = os.path.join(args.mbeir_data_dir, args.oven_dir)
    wiki6m = os.path.join(oven_dir, "Wiki6M_ver_1_0.jsonl")
    raw_pool_path = os.path.join(info_dir, "infoseek_raw_cand_pool.jsonl")
    pool_path = os.path.join(info_dir, "mbeir_infoseek_cand_pool.jsonl")

    if args.enable_mbeir_conversion:
        for split in ("train", "val"):
            data_path = os.path.join(info_dir, f"infoseek_{split}.jsonl")
            if not os.path.exists(data_path):
                continue
            kb_path = os.path.join(info_dir, f"infoseek_{split}_withkb.jsonl")
            qtype_path = os.path.join(info_dir, f"infoseek_{split}_qtype.jsonl")
            entries = infoseek_to_mbeir_and_create_raw_cand_pool(
                load_jsonl_as_list(data_path),
                wiki6m,
                raw_pool_path,
                kb_path,
                qtype_path if os.path.exists(qtype_path) else None,
                args.mbeir_data_dir,
            )
            if args.enable_candidate_pool:
                cand_pool = convert_raw_infoseek_cand_pool_to_mbeir_format(raw_pool_path, args.mbeir_data_dir)
                save_list_as_jsonl(cand_pool, pool_path)
                entries = update_mbeir_format_infoseek_data_with_cand_pool(entries, cand_pool)
            finalize_queries(
                entries, DATASET, os.path.join(info_dir, f"mbeir_infoseek_{split}.jsonl"),
                pool_path if os.path.exists(pool_path) else None,
            )
    if args.enable_training_candidate_pool:
        full_pool = load_mbeir_format_pool_file_as_dict(pool_path, doc_key_to_content=True, key_type="did")
        train = load_jsonl_as_list(os.path.join(info_dir, "mbeir_infoseek_train.jsonl"))
        save_list_as_jsonl(
            build_training_cand_pool(train, full_pool), os.path.join(info_dir, "mbeir_infoseek_train_cand_pool.jsonl")
        )


if __name__ == "__main__":
    main()
