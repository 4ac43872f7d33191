"""Automatic error analysis (counterpart of uniir_tpu/retrieval/analyst.py).

Classifies the rank-1 false positives of each run file by task:
  Type1 -- the retrieved candidate has the wrong modality
  Type2 -- right modality, wrong domain (the dataset domain table)
  Type3 -- right modality and domain: a same-kind miss
and writes them as a TSV of the retrieval report's shape.
"""

from __future__ import annotations

import os
from collections import defaultdict
from datetime import datetime
from typing import Dict, List

from uniir_tpu_torch.data.dataset import load_jsonl
from uniir_tpu_torch.data.registry import (
    MBEIR_DATASET_TO_DOMAIN,
    get_dataset_name,
    get_mbeir_query_modality_cand_modality_from_task_id,
    get_mbeir_task_name,
)
from uniir_tpu_torch.retrieval.eval import load_qrel, write_tsv_report

ERROR_TYPES = ["Type1", "Type2", "Type3"]


def load_runfile_with_ranks(run_file_path: str) -> Dict[str, List[dict]]:
    run: Dict[str, List[dict]] = defaultdict(list)
    with open(run_file_path, "r") as f:
        for line in f:
            qid, _, did, rank, score, run_id, task_id = line.strip().split()
            run[qid].append({"rank": int(rank), "did": did, "score": float(score), "task_id": task_id})
    return run


def load_pool_as_dict(path: str) -> dict:
    return {e["did"]: e for e in load_jsonl(path)}


def analyze_run(query_data: list, run_results: Dict[str, List[dict]], cand_pool_dict: dict, qid_to_taskid: dict):
    """Classify the rank-1 false positives; returns (per-task error rates,
    the number of false positives)."""
    error_values_by_task: Dict[str, Dict[str, list]] = defaultdict(lambda: defaultdict(list))
    total_fp = 0
    for query_entry in query_data:
        qid = query_entry["qid"]
        task_id = qid_to_taskid[qid]
        query_modality, gt_candidate_modality = get_mbeir_query_modality_cand_modality_from_task_id(int(task_id))
        if query_modality != query_entry["query_modality"]:
            raise ValueError(f"query {qid}: modality {query_entry['query_modality']!r} against task {task_id}")
        errors = {t: 0 for t in ERROR_TYPES}
        for rr in run_results[qid]:
            if rr["rank"] == 1:
                did = rr["did"]
                cand = cand_pool_dict[did]
                if did not in query_entry["pos_cand_list"]:
                    total_fp += 1
                    if gt_candidate_modality != cand["modality"]:
                        errors["Type1"] += 1
                    elif MBEIR_DATASET_TO_DOMAIN[get_dataset_name(qid)] != MBEIR_DATASET_TO_DOMAIN[get_dataset_name(did)]:
                        errors["Type2"] += 1
                    else:
                        errors["Type3"] += 1
                break  # only the top-ranked result
        for t in ERROR_TYPES:
            error_values_by_task[task_id][t].append(errors[t])
    per_task = {
        task_id: {t: round(sum(v) / max(1, total_fp), 4) for t, v in errs.items()}
        for task_id, errs in error_values_by_task.items()
    }
    return per_task, total_fp


def run_automatic_error_analysis(config) -> List[dict]:
    """Error rates of every run file analysis_config names; the TSV under
    `error_tsv/` when `write_to_tsv`."""
    mbeir_data_dir = config.mbeir_data_dir
    analysis_config = config.analysis_config
    exp_results_dir = os.path.join(config.uniir_dir, analysis_config.results_dir_name, config.experiment.path_suffix)
    exp_run_file_dir = os.path.join(exp_results_dir, "run_files")
    exp_error_tsv_dir = os.path.join(exp_results_dir, "error_tsv")
    os.makedirs(exp_error_tsv_dir, exist_ok=True)

    splits = []
    for split_name in ("train", "val", "test"):
        ds_cfg = getattr(analysis_config, f"{split_name}_datasets_config", None)
        if ds_cfg and ds_cfg.enable_retrieve:
            splits.append((split_name, ds_cfg.datasets_name, ds_cfg.correspond_cand_pools_name,
                           ds_cfg.correspond_qrels_name, ds_cfg.correspond_metrics_name))

    eval_results = []
    union_pool_cache = None
    qrel_dir = os.path.join(mbeir_data_dir, analysis_config.qrel_dir_name)
    for split, *columns in splits:
        for dataset_name, cand_pool_name, qrel_name, metric_names in zip(*columns):
            dataset_name, cand_pool_name, qrel_name = dataset_name.lower(), cand_pool_name.lower(), qrel_name.lower()
            qrel_path = os.path.join(qrel_dir, split, f"mbeir_{qrel_name}_{split}_qrels.txt")
            if not os.path.exists(qrel_path):  # the reference reads a flat qrel directory here
                qrel_path = os.path.join(qrel_dir, f"mbeir_{qrel_name}_{split}_qrels.txt")
            _, qid_to_taskid = load_qrel(qrel_path)

            metric_recall_list = [m.strip() for m in metric_names.split(",") if "recall" in m.lower()]
            k = max(int(m.split("@")[1]) for m in metric_recall_list)
            pool_kind = "union_pool" if cand_pool_name == "union" else "single_pool"
            run_id = f"mbeir_{dataset_name}_{pool_kind}_{split}_k{k}"
            run_results = load_runfile_with_ranks(os.path.join(exp_run_file_dir, f"{run_id}_run.txt"))
            query_data = load_jsonl(os.path.join(mbeir_data_dir, split, f"mbeir_{dataset_name}_{split}.jsonl"))

            if cand_pool_name == "union":
                if union_pool_cache is None:
                    union_pool_cache = load_pool_as_dict(
                        os.path.join(mbeir_data_dir, "cand_pool", "union_pool", "mbeir_union_test_cand_pool.jsonl")
                    )
                cand_pool_dict = union_pool_cache
            else:
                cand_pool_dict = load_pool_as_dict(
                    os.path.join(mbeir_data_dir, "cand_pool", f"mbeir_{cand_pool_name}_cand_pool.jsonl")
                )

            per_task, total_fp = analyze_run(query_data, run_results, cand_pool_dict, qid_to_taskid)
            print(f"Error Analyst: Total number of false positives: {total_fp}")
            for task_id, errors in per_task.items():
                eval_results.append({
                    "TaskID": int(task_id),
                    "Task": get_mbeir_task_name(int(task_id)),
                    "Dataset": dataset_name,
                    "Split": split,
                    "CandPool": cand_pool_name,
                    **errors,
                })

    if analysis_config.write_to_tsv:
        date_time = datetime.now().strftime("%m-%d-%H")
        tsv_path = os.path.join(exp_error_tsv_dir, f"error_analysis_results_{date_time}.tsv")
        write_tsv_report(eval_results, tsv_path, metrics=ERROR_TYPES)
        print(f"Error Analyst: Results saved to {tsv_path}")
    return eval_results
