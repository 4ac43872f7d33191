"""Shared machinery for the 10 raw-dataset -> M-BEIR converters.

Every reference preprocessor (src/data/preprocessing/*_data_preprocessor.py)
follows the same skeleton: build a content-deduplicated candidate pool with
dids counted from 1, convert raw entries into query entries that reference the
pool by content key, aggregate duplicate queries, then assign qids counted
from 1.  `CandPoolBuilder` and `finalize_queries` capture that skeleton once.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional

from uniir_tpu_torch.data.preprocessing.io_utils import (
    aggregate_candidates_for_mbeir_format_dataset,
    count_entries_in_file,
    generate_mbeir_format_doc_key,
    is_valid_image,
    load_mbeir_format_pool_file_as_dict,
    print_mbeir_format_cand_pool_stats,
    print_mbeir_format_dataset_stats,
    save_list_as_jsonl,
)
from uniir_tpu_torch.data.registry import get_dataset_id


class CandPoolBuilder:
    """Content-keyed candidate pool with dids `<dataset_id>:<n>` from n=1."""

    def __init__(self, dataset_name: str, key_fn: Optional[Callable[[dict], str]] = None):
        self.dataset_id = get_dataset_id(dataset_name)
        assert self.dataset_id is not None, "Unknown dataset name!"
        self.key_fn = key_fn or generate_mbeir_format_doc_key
        self.entries: List[dict] = []
        self.by_key: dict = {}
        self._next_id = 1

    def add(self, txt: Optional[str], img_path: Optional[str], modality: str, src_content: Optional[str] = None) -> dict:
        """Add (or fetch existing) candidate; returns the pool entry."""
        entry = {"txt": txt, "img_path": img_path, "modality": modality, "did": None, "src_content": src_content}
        key = self.key_fn(entry)
        if key in self.by_key:
            return self.by_key[key]
        entry["did"] = f"{self.dataset_id}:{self._next_id}"
        self._next_id += 1
        self.entries.append(entry)
        self.by_key[key] = entry
        return entry

    def get_did(self, txt: Optional[str] = None, img_path: Optional[str] = None, modality: str = "") -> Optional[str]:
        key = self.key_fn({"txt": txt, "img_path": img_path, "modality": modality})
        entry = self.by_key.get(key)
        return entry["did"] if entry else None

    def save(self, path: str, print_stats: bool = True) -> None:
        save_list_as_jsonl(self.entries, path)
        print(f"Candidate pool saved to {path}")
        if print_stats:
            print_mbeir_format_cand_pool_stats(path, print_duplicate=False)


def new_query_entry(query_txt=None, query_img_path=None, query_modality=None, query_src_content=None) -> dict:
    return {
        "qid": None,
        "query_txt": query_txt,
        "query_img_path": query_img_path,
        "query_modality": query_modality,
        "query_src_content": query_src_content,
        "pos_cand_list": [],
        "neg_cand_list": [],
    }


def finalize_queries(
    mbeir_entries: List[dict],
    dataset_name: str,
    out_path: str,
    cand_pool_path: Optional[str] = None,
    aggregate: bool = True,
    print_stats: bool = True,
) -> List[dict]:
    """Aggregate duplicates, assign qids from 1, save, print stats."""
    dataset_id = get_dataset_id(dataset_name)
    if aggregate:
        mbeir_entries = aggregate_candidates_for_mbeir_format_dataset(mbeir_entries, print_duplicate=False)
    for i, entry in enumerate(mbeir_entries):
        entry["qid"] = f"{dataset_id}:{i + 1}"
    save_list_as_jsonl(mbeir_entries, out_path)
    total, data = count_entries_in_file(out_path)
    print(f"MBEIR format {dataset_name} data saved to {out_path} ({total} entries)")
    if print_stats and cand_pool_path:
        pool = load_mbeir_format_pool_file_as_dict(cand_pool_path, doc_key_to_content=True, key_type="did")
        print_mbeir_format_dataset_stats(data, pool)
    return mbeir_entries


def build_training_cand_pool(train_data: List[dict], full_pool_by_did: dict) -> List[dict]:
    """Pool restricted to candidates referenced by the train split (the
    reference's --enable_training_candidate_pool step)."""
    out: dict = {}
    for entry in train_data:
        for did in entry["pos_cand_list"] + entry.get("neg_cand_list", []):
            if did not in out:
                out[did] = full_pool_by_did[did]
    pool = list(out.values())
    pool.sort(key=lambda x: int(x["did"].split(":")[1]))
    return pool


def checked_image(mbeir_data_dir: str, rel_img_path: str) -> Optional[str]:
    """Return rel_img_path when the image on disk is a valid JPEG, else None."""
    return rel_img_path if is_valid_image(os.path.join(mbeir_data_dir, rel_img_path)) else None
