"""M-BEIR union data generator (reference src/data/mbeir_data_generator.py).

Builds the union train set with per-dataset up-sampling targets
(100K/50K/15K), union train/val/test/all candidate pools sorted by did,
task-id assignment, qrels (`qid 0 did 1 task_id`), held-out ablation splits,
and the hard-negatives union.
"""

from __future__ import annotations

import os
import random
from typing import Optional

from uniir_tpu_torch.data.preprocessing.io_utils import (
    load_jsonl_as_list,
    load_mbeir_format_pool_file_as_dict,
    print_mbeir_format_cand_pool_stats,
    save_and_print_mbeir_format_dataset_stats,
    save_list_as_jsonl,
)
from uniir_tpu_torch.data.registry import get_dataset_name, get_mbeir_task_id

_100K, _50K, _15K = 100_000, 50_000, 15_000

# Per-dataset union targets (reference mbeir_data_generator.py:194-205).
DEFAULT_DATASETS_INFO = {
    "VisualNews": {"target": _100K, "up_sampling": False, "include": True},
    "MSCOCO": {"target": _100K, "up_sampling": False, "include": True},
    "Fashion200K": {"target": _15K, "up_sampling": False, "include": True},
    "WebQA": {"target": _100K, "up_sampling": True, "include": True},
    "EDIS": {"target": _50K, "up_sampling": True, "include": True},
    "NIGHTS": {"target": _50K, "up_sampling": True, "include": True},
    "OVEN": {"target": _100K, "up_sampling": False, "include": True},
    "INFOSEEK": {"target": _100K, "up_sampling": False, "include": True},
    "FashionIQ": {"target": _50K, "up_sampling": True, "include": True},
    "CIRR": {"target": _50K, "up_sampling": True, "include": True},
}

# Test-split per-task pool names (reference :253-267; MSCOCO pools are
# test-split-specific).
TEST_POOL_NAMES = {
    "VisualNews": ["visualnews_task0", "visualnews_task3"],
    "MSCOCO": ["mscoco_task0_test", "mscoco_task3_test"],
    "Fashion200K": ["fashion200k_task0", "fashion200k_task3"],
    "WebQA": ["webqa_task1", "webqa_task2"],
    "EDIS": ["edis_task2"],
    "NIGHTS": ["nights_task4"],
    "OVEN": ["oven_task6", "oven_task8"],
    "INFOSEEK": ["infoseek_task6", "infoseek_task8"],
    "FashionIQ": ["fashioniq_task7"],
    "CIRR": ["cirr_task7"],
}

VAL_POOL_NAMES = {**TEST_POOL_NAMES, "MSCOCO": ["mscoco_task0_val", "mscoco_task3_val"]}
VAL_DATA_NAMES = {**TEST_POOL_NAMES, "MSCOCO": ["mscoco_task0", "mscoco_task3"]}
ALL_POOL_NAMES = {name: [name.lower()] for name in DEFAULT_DATASETS_INFO}

HELD_OUT_DATASETS = ["OVEN", "CIRR", "WebQA", "VisualNews", "Fashion200K"]
HELD_OUT_TASKS = [0, 2, 8]
HELD_OUT_DOMAIN_DATASETS = ["EDIS", "VisualNews"]  # domain "news"


def _sort_by_id(entries: list, key: str) -> None:
    entries.sort(key=lambda x: (int(x[key].split(":")[0]), int(x[key].split(":")[1])))


def load_and_upsample(file_path: str, target_size: int, enable_upsampling: bool, rng: Optional[random.Random] = None):
    rng = rng or random
    data = load_jsonl_as_list(file_path)
    original_size = len(data)
    if enable_upsampling and original_size != target_size:
        while len(data) < target_size:
            data.extend(rng.choices(data, k=target_size - len(data)))
    return data, original_size


def unify_upsample_mbeir_data(data_dir: str, data_split: str, upsample: bool, datasets_info: dict, shuffle: bool = True, rng: Optional[random.Random] = None) -> list:
    rng = rng or random
    union_data: list = []
    for name, info in datasets_info.items():
        if not info["include"]:
            continue
        file_path = os.path.join(data_dir, f"mbeir_{name.lower()}_{data_split}.jsonl")
        if upsample:
            data, _ = load_and_upsample(file_path, info["target"], info["up_sampling"], rng)
        else:
            data = load_jsonl_as_list(file_path)
        union_data.extend(data)
    if shuffle:
        rng.shuffle(union_data)
    else:
        _sort_by_id(union_data, "qid")
    return union_data


def unify_mbeir_cand_pool(cand_pool_dir: str, name_map: dict, datasets_info: dict, shuffle: bool = False) -> list:
    union_pool: list = []
    for name, info in datasets_info.items():
        if not info["include"]:
            continue
        for middle in name_map[name]:
            union_pool.extend(load_jsonl_as_list(os.path.join(cand_pool_dir, f"mbeir_{middle}_cand_pool.jsonl")))
    if shuffle:
        random.shuffle(union_pool)
    else:
        _sort_by_id(union_pool, "did")
    return union_pool


def generate_union_train_cand_pool(mbeir_data_dir: str, datasets_info: dict = DEFAULT_DATASETS_INFO) -> str:
    train_pool_dir = os.path.join(mbeir_data_dir, "cand_pool", "train_cand_pool")
    union_pool_dir = os.path.join(mbeir_data_dir, "cand_pool", "union_pool")
    union_pool: list = []
    for name, info in datasets_info.items():
        if info["include"]:
            union_pool.extend(
                load_jsonl_as_list(os.path.join(train_pool_dir, f"mbeir_{name.lower()}_train_cand_pool.jsonl"))
            )
    _sort_by_id(union_pool, "did")
    out = os.path.join(union_pool_dir, "mbeir_union_train_cand_pool.jsonl")
    save_list_as_jsonl(union_pool, out)
    print_mbeir_format_cand_pool_stats(out, print_duplicate=False)
    return out


def generate_union_test_cand_pool(mbeir_data_dir: str, datasets_info: dict = DEFAULT_DATASETS_INFO) -> str:
    cand_pool_dir = os.path.join(mbeir_data_dir, "cand_pool")
    pool = unify_mbeir_cand_pool(cand_pool_dir, TEST_POOL_NAMES, datasets_info)
    out = os.path.join(cand_pool_dir, "union_pool", "mbeir_union_test_cand_pool.jsonl")
    save_list_as_jsonl(pool, out)
    print_mbeir_format_cand_pool_stats(out, print_duplicate=False)
    return out


def generate_union_all_cand_pool(mbeir_data_dir: str, datasets_info: dict = DEFAULT_DATASETS_INFO) -> str:
    unsplit_dir = os.path.join(mbeir_data_dir, "cand_pool", "unsplit_cand_pool")
    pool = unify_mbeir_cand_pool(unsplit_dir, ALL_POOL_NAMES, datasets_info)
    out = os.path.join(mbeir_data_dir, "cand_pool", "union_pool", "mbeir_union_all_cand_pool.jsonl")
    save_list_as_jsonl(pool, out)
    print_mbeir_format_cand_pool_stats(out, print_duplicate=False)
    return out


def unify_train_data(mbeir_data_dir: str, upsample: bool, datasets_info: dict = DEFAULT_DATASETS_INFO, rng: Optional[random.Random] = None) -> str:
    train_dir = os.path.join(mbeir_data_dir, "train")
    union_data = unify_upsample_mbeir_data(train_dir, "train", upsample, datasets_info, shuffle=True, rng=rng)
    name = "mbeir_union_up_train.jsonl" if upsample else "mbeir_union_train.jsonl"
    out = os.path.join(train_dir, "union_train", name)
    union_pool = os.path.join(mbeir_data_dir, "cand_pool", "union_pool", "mbeir_union_train_cand_pool.jsonl")
    save_and_print_mbeir_format_dataset_stats(union_data, out, union_pool)
    return out


def assign_task_ids(mbeir_data_dir: str) -> None:
    """Stamp task_id on every query entry (reference :336-384)."""
    cand_pool_dir = os.path.join(mbeir_data_dir, "cand_pool")
    union_pool_dir = os.path.join(cand_pool_dir, "union_pool")
    for split in ["train", "val", "test", os.path.join("train", "union_train")]:
        data_dir = os.path.join(mbeir_data_dir, split)
        if not os.path.isdir(data_dir):
            continue
        if "train" in split:
            cand_pool_dict = load_mbeir_format_pool_file_as_dict(
                os.path.join(union_pool_dir, "mbeir_union_train_cand_pool.jsonl"), doc_key_to_content=True, key_type="did"
            )
        for data_file in os.listdir(data_dir):
            if not data_file.endswith(".jsonl"):
                continue
            if "train" not in split:
                parts = os.path.splitext(data_file)[0].split("_")
                middle_name = "_".join(parts[1:-1])
                pool_path = os.path.join(cand_pool_dir, f"mbeir_{middle_name}_cand_pool.jsonl")
                if "mscoco" in middle_name:  # MSCOCO pools are split-specific
                    pool_path = os.path.join(cand_pool_dir, f"mbeir_{middle_name}_{split}_cand_pool.jsonl")
                cand_pool_dict = load_mbeir_format_pool_file_as_dict(pool_path, doc_key_to_content=True, key_type="did")
            path = os.path.join(data_dir, data_file)
            data = load_jsonl_as_list(path)
            for entry in data:
                pos_cand_modality = cand_pool_dict[entry["pos_cand_list"][0]]["modality"]
                entry["task_id"] = get_mbeir_task_id(entry["query_modality"], pos_cand_modality)
            save_list_as_jsonl(data, path)
            print(f"Saved {path} with task ids")


def generate_qrels(mbeir_data_dir: str) -> None:
    """qrels `qid 0 did 1 task_id` per split file (reference :477-507)."""
    qrels_dir = os.path.join(mbeir_data_dir, "qrels")
    os.makedirs(qrels_dir, exist_ok=True)
    for split in ("train", "val", "test"):
        data_dir = os.path.join(mbeir_data_dir, split)
        if not os.path.isdir(data_dir):
            continue
        for data_file in os.listdir(data_dir):
            if not data_file.endswith(".jsonl"):
                continue
            parts = os.path.splitext(data_file)[0].split("_")
            dataset_split = parts[-1]
            middle_name = "_".join(parts[1:-1])
            qrels_file = os.path.join(qrels_dir, f"mbeir_{middle_name}_{dataset_split}_qrels.txt")
            data = load_jsonl_as_list(os.path.join(data_dir, data_file))
            with open(qrels_file, "w") as out:
                for entry in data:
                    for cand_id in entry["pos_cand_list"]:
                        out.write(f"{entry['qid']} 0 {cand_id} 1 {entry['task_id']}\n")
            print(f"Generated qrels file {qrels_file}")


def generate_union_val_data(mbeir_data_dir: str, datasets_info: dict = DEFAULT_DATASETS_INFO) -> str:
    """Union val queries + trimmed union val pool (reference :387-474)."""
    val_dir = os.path.join(mbeir_data_dir, "val")
    union_val: list = []
    for name, info in datasets_info.items():
        if not info["include"]:
            continue
        for middle in VAL_DATA_NAMES[name]:
            union_val.extend(load_jsonl_as_list(os.path.join(val_dir, f"mbeir_{middle}_val.jsonl")))
    _sort_by_id(union_val, "qid")
    out = os.path.join(val_dir, "union_val", "mbeir_union_val.jsonl")
    save_list_as_jsonl(union_val, out)

    cand_pool_dir = os.path.join(mbeir_data_dir, "cand_pool")
    union_val_pool = unify_mbeir_cand_pool(cand_pool_dir, VAL_POOL_NAMES, datasets_info)
    pool_by_did = {e["did"]: e for e in union_val_pool}
    # trim to candidates actually referenced by the union val data
    trimmed: dict = {}
    for entry in union_val:
        for did in entry["pos_cand_list"] + entry.get("neg_cand_list", []):
            trimmed[did] = pool_by_did[did]
    pool_out = os.path.join(cand_pool_dir, "union_pool", "mbeir_union_val_cand_pool.jsonl")
    save_list_as_jsonl(list(trimmed.values()), pool_out)
    print_mbeir_format_cand_pool_stats(pool_out, print_duplicate=False)
    return out


def _held_in_filter(mbeir_data_dir: str, keep_fn, out_rel_path: str) -> str:
    union_train_dir = os.path.join(mbeir_data_dir, "train", "union_train")
    data = load_jsonl_as_list(os.path.join(union_train_dir, "mbeir_union_up_train.jsonl"))
    held_in = [e for e in data if keep_fn(e)]
    out = os.path.join(mbeir_data_dir, "train", "EXP", out_rel_path)
    union_pool = os.path.join(mbeir_data_dir, "cand_pool", "union_pool", "mbeir_union_train_cand_pool.jsonl")
    save_and_print_mbeir_format_dataset_stats(held_in, out, union_pool)
    return out


def generate_held_n_dataset_out_data(mbeir_data_dir: str) -> str:
    return _held_in_filter(
        mbeir_data_dir,
        lambda e: get_dataset_name(e["qid"]) not in HELD_OUT_DATASETS,
        os.path.join("HeldNDataOut", "mbeir_held_n_dataset_out_train.jsonl"),
    )


def generate_held_n_task_out_data(mbeir_data_dir: str) -> str:
    return _held_in_filter(
        mbeir_data_dir,
        lambda e: e["task_id"] not in HELD_OUT_TASKS,
        os.path.join("HeldNTaskOut", "mbeir_held_n_task_out_train.jsonl"),
    )


def generate_held_1_domain_out_data(mbeir_data_dir: str) -> str:
    return _held_in_filter(
        mbeir_data_dir,
        lambda e: get_dataset_name(e["qid"]) not in HELD_OUT_DOMAIN_DATASETS,
        os.path.join("Held1DomainOut", "mbeir_held_1_domain_out_train.jsonl"),
    )


def unify_and_upsample_train_data_with_hard_negs(mbeir_data_dir: str, hard_negs_dir_name: str, datasets_info: dict = DEFAULT_DATASETS_INFO) -> str:
    hard_negs_dir = os.path.join(mbeir_data_dir, "train", hard_negs_dir_name)
    union_data = unify_upsample_mbeir_data(hard_negs_dir, "hard_negs_train", True, datasets_info, shuffle=False)
    out = os.path.join(mbeir_data_dir, "train", "union_train", "mbeir_union_up_hard_negs_train.jsonl")
    union_all_pool = os.path.join(mbeir_data_dir, "cand_pool", "union_pool", "mbeir_union_all_cand_pool.jsonl")
    save_and_print_mbeir_format_dataset_stats(union_data, out, union_all_pool)
    return out


def main():
    import argparse

    parser = argparse.ArgumentParser(description="Manage mbeir_train datasets.")
    parser.add_argument("--mbeir_data_dir", default="/data/UniIR/mbeir_data")
    for flag in (
        "print_original_train_data_sizes",
        "generate_union_train_cand_pool",
        "generate_union_test_cand_pool",
        "generate_union_all_cand_pool",
        "unify_train_data",
        "unify_and_upsample_train_data",
        "unify_and_upsample_train_data_with_hard_negs",
        "generate_qrels",
        "assign_task_ids",
        "generate_union_val_data",
        "generate_held_n_dataset_out_data",
        "generate_held_n_task_out_data",
        "generate_held_1_domain_out_data",
    ):
        parser.add_argument(f"--{flag}", action="store_true")
    parser.add_argument("--hard_negs_dir_name", default="hard_negs_dir")
    args = parser.parse_args()
    d = args.mbeir_data_dir

    if args.print_original_train_data_sizes:
        for name in DEFAULT_DATASETS_INFO:
            path = os.path.join(d, "train", f"mbeir_{name.lower()}_train.jsonl")
            print(f"Dataset {name}: Size = {len(load_jsonl_as_list(path))}")
    if args.generate_union_train_cand_pool:
        generate_union_train_cand_pool(d)
    if args.generate_union_test_cand_pool:
        generate_union_test_cand_pool(d)
    if args.generate_union_all_cand_pool:
        generate_union_all_cand_pool(d)
    if args.unify_train_data:
        unify_train_data(d, upsample=False)
    if args.unify_and_upsample_train_data:
        unify_train_data(d, upsample=True)
    if args.assign_task_ids:
        assign_task_ids(d)
    if args.generate_union_val_data:
        generate_union_val_data(d)
    if args.generate_qrels:
        generate_qrels(d)
    if args.generate_held_n_dataset_out_data:
        generate_held_n_dataset_out_data(d)
    if args.generate_held_n_task_out_data:
        generate_held_n_task_out_data(d)
    if args.generate_held_1_domain_out_data:
        generate_held_1_domain_out_data(d)
    if args.unify_and_upsample_train_data_with_hard_negs:
        unify_and_upsample_train_data_with_hard_negs(d, args.hard_negs_dir_name)


if __name__ == "__main__":
    main()
