"""Retrieval evaluation (counterpart of uniir_tpu/retrieval/eval.py).

Same byte formats as the JAX package and the reference:
  * qrels:    `qid 0 did relevance task_id` rows
  * run file: `qid Q0 did rank score run_id task_id`
  * Recall@k: hit rate -- 1.0 if any relevant doc is in the top k
  * TSV:      TaskID/Task/Dataset/Split/Metric/CandPool/Value/UnionPool/UnionValue
  * raw retrieval (UniRAG): `retrieved_candidates/{run_id}_retrieved.jsonl`
    rows {query, candidates[, complement_candidates]}
The JAX module imports its search at the top, hence this port-local copy.
Over several processes every rank searches (the pool sharded over the
ranks) and rank 0 alone writes the files, as the JAX `run_retrieval` does.
"""

from __future__ import annotations

import csv
import json
import os
from collections import defaultdict
from datetime import datetime
from typing import Dict, List, Tuple

import numpy as np

from uniir_tpu_torch.core import mesh
from uniir_tpu_torch.data.dataset import load_candidates
from uniir_tpu_torch.data.registry import get_mbeir_task_name, unhash_did, unhash_qid
from uniir_tpu_torch.retrieval.index import DenseIndex
from uniir_tpu_torch.retrieval.search import search_dense_index

AVAILABLE_RECALL_METRICS = ["Recall@1", "Recall@5", "Recall@10", "Recall@20", "Recall@50"]

# Sort orders of the reference's report (mbeir_retriever.py:507-534).
DATASET_ORDER = {
    "visualnews_task0": 1,
    "mscoco_task0": 2,
    "fashion200k_task0": 3,
    "webqa_task1": 4,
    "edis_task2": 5,
    "webqa_task2": 6,
    "visualnews_task3": 7,
    "mscoco_task3": 8,
    "fashion200k_task3": 9,
    "nights_task4": 10,
    "oven_task6": 11,
    "infoseek_task6": 12,
    "fashioniq_task7": 13,
    "cirr_task7": 14,
    "oven_task8": 15,
    "infoseek_task8": 16,
}
SPLIT_ORDER = {"val": 1, "test": 2}
CAND_POOL_ORDER = {"union": 99}


def compute_recall_at_k(relevant_docs, retrieved_indices, k: int) -> float:
    """Hit-rate recall."""
    if not relevant_docs:
        return 0.0
    return 1.0 if set(relevant_docs).intersection(set(retrieved_indices[:k])) else 0.0


def load_qrel(filename: str) -> Tuple[Dict[str, list], Dict[str, str]]:
    """qrels + qid -> task_id map."""
    qrel: Dict[str, list] = {}
    qid_to_taskid: Dict[str, str] = {}
    with open(filename, "r") as f:
        for line in f:
            query_id, _, doc_id, relevance_score, task_id = line.strip().split()
            if int(relevance_score) > 0:
                qrel.setdefault(query_id, []).append(doc_id)
                qid_to_taskid.setdefault(query_id, task_id)
    print(f"Retriever: Loaded {len(qrel)} queries from {filename}")
    return qrel, qid_to_taskid


def write_run_file(run_file_path, retrieved_dist, retrieved_indices, hashed_query_ids, qid_to_taskid, run_id):
    """TREC-style run file."""
    os.makedirs(os.path.dirname(run_file_path) or ".", exist_ok=True)
    with open(run_file_path, "w") as run_file:
        for idx, (distances, indices) in enumerate(zip(retrieved_dist, retrieved_indices)):
            qid = unhash_qid(hashed_query_ids[idx])
            task_id = qid_to_taskid[qid]
            for rank, (hashed_doc_id, score) in enumerate(zip(indices, distances), start=1):
                run_file.write(f"{qid} Q0 {unhash_did(hashed_doc_id)} {rank} {score} {run_id} {task_id}\n")


def load_run_file(run_file_path: str) -> Dict[str, list]:
    """qid -> [did, ...] in rank order."""
    run: Dict[str, list] = defaultdict(list)
    with open(run_file_path, "r") as f:
        for line in f:
            qid, _, did, rank, score, run_id, task_id = line.strip().split()
            run[qid].append((int(rank), did, float(score), task_id))
    return {qid: [did for _, did, _, _ in sorted(rows)] for qid, rows in run.items()}


def evaluate_recall(retrieved_indices, hashed_query_ids, qrel, qid_to_taskid, metric_recall_list) -> Dict[str, Dict[str, float]]:
    """Per-task mean Recall@k."""
    recall_values_by_task: Dict[str, Dict[str, list]] = defaultdict(lambda: defaultdict(list))
    for i, retrieved in enumerate(retrieved_indices):
        retrieved_dids = [unhash_did(x) for x in retrieved]
        qid = unhash_qid(hashed_query_ids[i])
        task_id = qid_to_taskid[qid]
        for metric in metric_recall_list:
            k = int(metric.split("@")[1])
            recall_values_by_task[task_id][metric].append(compute_recall_at_k(qrel[qid], retrieved_dids, k))
    return {
        task_id: {m: round(sum(v) / len(v), 4) for m, v in recalls.items()}
        for task_id, recalls in recall_values_by_task.items()
    }


def sort_eval_results(eval_results: List[dict]) -> List[dict]:
    return sorted(
        eval_results,
        key=lambda x: (
            x["TaskID"],
            DATASET_ORDER.get(x["Dataset"].lower(), 99),
            SPLIT_ORDER.get(x["Split"].lower(), 99),
            CAND_POOL_ORDER.get(x["CandPool"].lower(), 0),
        ),
    )


def write_tsv_report(eval_results: List[dict], tsv_file_path: str, metrics=AVAILABLE_RECALL_METRICS) -> None:
    """Grouped TSV with single-pool vs UNION columns, a row per metric of
    `metrics` (Recall@k here, the analyst's error types there)."""
    grouped: Dict[tuple, Dict[str, dict]] = defaultdict(lambda: defaultdict(dict))
    for result in sort_eval_results(eval_results):
        key = (result["TaskID"], result["Task"], result["Dataset"], result["Split"])
        for metric in metrics:
            grouped[key][result["CandPool"]].update({metric: result.get(metric, None)})

    rows = [["TaskID", "Task", "Dataset", "Split", "Metric", "CandPool", "Value", "UnionPool", "UnionValue"]]
    for (task_id, task, dataset, split), cand_pools in grouped.items():
        union_results = cand_pools.get("union", {})
        for metric in metrics:
            for cand_pool, values in cand_pools.items():
                value = values.get(metric, None)
                if cand_pool == "union" or value is None:
                    continue
                row = [task_id, task, dataset, split, metric, cand_pool, value]
                row.extend(["union", union_results.get(metric, "N/A")] if union_results else ["", ""])
                rows.append(row)

    os.makedirs(os.path.dirname(tsv_file_path) or ".", exist_ok=True)
    with open(tsv_file_path, "w", newline="") as tsvfile:
        writer = csv.writer(tsvfile, delimiter="\t")
        for row in rows:
            writer.writerow(row)


COMPLEMENT_MODALITIES = {"text": "image", "image": "text"}


def get_raw_retrieved_candidates(queries_path: str, candidates_path: str, retrieved_indices, hashed_query_ids,
                                 complement_retriever=None) -> dict:
    """qid -> {query, candidates} for UniRAG.  With a complement retriever,
    each text or image candidate is sent back as a query of its own modality
    towards the other one, and the first hit of that other modality that is
    not the query's own image or text becomes its complement (None if none of
    the top 10 is), so the results form (image, text) pairs."""
    qid_to_queries = {}
    with open(queries_path, "r") as f:
        for line in f:
            q = json.loads(line.strip())
            if q["qid"] in qid_to_queries:
                raise ValueError(f"qids must be unique: {q['qid']} repeats in {queries_path}")
            qid_to_queries[q["qid"]] = q
    did_to_candidates = load_candidates(candidates_path)

    retrieved_dict = {}
    complement_queries_list = []
    for idx, indices in enumerate(retrieved_indices):
        qid = unhash_qid(hashed_query_ids[idx])
        retrieved_cands = [did_to_candidates[unhash_did(h)] for h in indices]
        retrieved_dict[qid] = {"query": qid_to_queries[qid], "candidates": retrieved_cands}
        if complement_retriever:
            complement_queries = [
                (c.get("modality"), c.get("txt"), c.get("img_path"), COMPLEMENT_MODALITIES[c.get("modality")])
                for c in retrieved_cands
                if c["modality"] in COMPLEMENT_MODALITIES
            ]
            complement_queries_list.append((qid, complement_queries))
            complement_retriever.add_queries(complement_queries)

    if complement_retriever:
        retrieved_complements = iter(complement_retriever.retrieve(k=10))
        for qid, complement_queries in complement_queries_list:
            query = retrieved_dict[qid]["query"]
            complement_candidates = []
            for q_modality, *_ in complement_queries:
                complement_cand = None
                for cand in next(retrieved_complements):
                    if cand["modality"] != COMPLEMENT_MODALITIES[q_modality]:
                        continue
                    # never the original query itself
                    if (cand.get("img_path") and cand.get("img_path") != query.get("query_img_path")) or (
                        cand.get("txt") and cand.get("txt") != query.get("query_txt")
                    ):
                        complement_cand = cand
                        break
                complement_candidates.append(complement_cand)
            retrieved_dict[qid]["complement_candidates"] = complement_candidates
    return retrieved_dict


def run_retrieval(config, device=None, stats_out: list | None = None, query_embedder_config=None,
                  bundle=None) -> List[dict]:
    """Retrieval sweep driven by retrieval.yaml: run files, Recall@k, TSV,
    and with `raw_retrieval` the retrieved candidates of every query.

    `stats_out`, when given, receives one dict per search (run_id plus the
    search stats: pool_dtype, guard_pass_rate, exact_reruns).  With
    `retrieve_image_text_pairs` the complement retriever embeds through
    `bundle`, or a model built from `query_embedder_config` when None.

    Every rank calls it; rank 0 writes the run files, the retrieved jsonl
    and the TSV, and all meet at the barrier `run_retrieval_done` before it
    returns, so no rank reads a file before it is written."""
    main_proc = mesh.is_main_process()
    retrieval_config = config.retrieval_config
    raw_retrieval = getattr(retrieval_config, "raw_retrieval", False)
    uniir_dir, expt_dir_name = config.uniir_dir, config.experiment.path_suffix
    exp_results_dir = os.path.join(uniir_dir, retrieval_config.results_dir_name, expt_dir_name)
    exp_run_file_dir = os.path.join(exp_results_dir, "run_files")
    exp_tsv_results_dir = os.path.join(exp_results_dir, "final_tsv")
    exp_retrieved_cands_dir = os.path.join(exp_results_dir, "retrieved_candidates")
    for d in (exp_run_file_dir, exp_tsv_results_dir, exp_retrieved_cands_dir):
        if main_proc:
            os.makedirs(d, exist_ok=True)

    splits = []
    for split_name in ("train", "val", "test"):
        ds_cfg = getattr(retrieval_config, f"{split_name}_datasets_config", None)
        if ds_cfg and ds_cfg.enable_retrieve:
            columns = (
                ds_cfg.datasets_name, ds_cfg.correspond_cand_pools_name,
                ds_cfg.correspond_qrels_name, ds_cfg.correspond_metrics_name,
            )
            if len({len(c) for c in columns}) != 1:
                raise ValueError("Mismatch between datasets and candidate pools and qrels.")
            splits.append((split_name, columns))

    eval_results = []
    cand_index_dir = os.path.join(uniir_dir, retrieval_config.index_dir_name, expt_dir_name, "cand_pool")
    qrel_dir = os.path.join(config.mbeir_data_dir, retrieval_config.qrel_dir_name)
    for split, columns in splits:
        dataset_embed_dir = os.path.join(uniir_dir, retrieval_config.embed_dir_name, expt_dir_name, split)
        for dataset_name, cand_pool_name, qrel_name, metric_names in zip(*columns):
            dataset_name, cand_pool_name, qrel_name = dataset_name.lower(), cand_pool_name.lower(), qrel_name.lower()
            qrel, qid_to_taskid = load_qrel(os.path.join(qrel_dir, split, f"mbeir_{qrel_name}_{split}_qrels.txt"))
            hashed_query_ids = np.load(os.path.join(dataset_embed_dir, f"mbeir_{dataset_name}_{split}_ids.npy"))
            query_embeds = np.load(os.path.join(dataset_embed_dir, f"mbeir_{dataset_name}_{split}_embed.npy"))
            cand_index_path = os.path.join(cand_index_dir, f"mbeir_{cand_pool_name}_cand_pool.index")
            index = DenseIndex.load(cand_index_path)

            metric_recall_list = [m.strip() for m in metric_names.split(",") if "recall" in m.lower()]
            k = max(int(m.split("@")[1]) for m in metric_recall_list)
            print(f"Retriever: query:{dataset_name} | split:{split} | pool:{cand_pool_name} | k={k}")
            search_stats: dict = {}
            retrieved_dist, retrieved_indices = search_dense_index(
                query_embeds, index, num_cand_to_retrieve=k,
                pool_dtype=getattr(retrieval_config, "pool_dtype", None), stats=search_stats, device=device,
            )
            if search_stats["pool_dtype"] != "bf16":
                print(
                    f"Retriever: {search_stats['pool_dtype']} pool sweep, guard_pass_rate="
                    f"{search_stats['guard_pass_rate']:.4f}, exact_reruns={search_stats['exact_reruns']}"
                )

            pool_kind = "union_pool" if cand_pool_name == "union" else "single_pool"
            run_id = f"mbeir_{dataset_name}_{pool_kind}_{split}_k{k}"
            if stats_out is not None:
                stats_out.append({"run_id": run_id, **search_stats})
            run_file_path = os.path.join(exp_run_file_dir, f"{run_id}_run.txt")
            if main_proc:
                write_run_file(run_file_path, retrieved_dist, retrieved_indices, hashed_query_ids, qid_to_taskid, run_id)
                print(f"Retriever: Run file saved to {run_file_path}")

            if raw_retrieval:
                mbeir_data_dir = config.mbeir_data_dir
                queries_path = os.path.join(
                    mbeir_data_dir, retrieval_config.query_dir_name, split, f"mbeir_{dataset_name}_{split}.jsonl"
                )
                cand_dir = os.path.join(mbeir_data_dir, retrieval_config.candidate_dir_name)
                candidates_path = os.path.join(cand_dir, f"mbeir_{cand_pool_name}_{split}_cand_pool.jsonl")
                if not os.path.exists(candidates_path):
                    candidates_path = os.path.join(cand_dir, f"mbeir_{cand_pool_name}_cand_pool.jsonl")
                complement_retriever = None
                if getattr(retrieval_config, "retrieve_image_text_pairs", False):
                    from uniir_tpu_torch.retrieval.interactive import InteractiveRetriever

                    # MSCOCO has both text -> image and image -> text tasks
                    complement_retriever = InteractiveRetriever(
                        cand_index_path, candidates_path, "MSCOCO", query_embedder_config, bundle=bundle, device=device
                    )
                retrieved_dict = get_raw_retrieved_candidates(
                    queries_path, candidates_path, retrieved_indices, hashed_query_ids, complement_retriever
                )
                retrieved_file_path = os.path.join(exp_retrieved_cands_dir, f"{run_id}_retrieved.jsonl")
                if main_proc:
                    with open(retrieved_file_path, "w") as rf:
                        for v in retrieved_dict.values():
                            json.dump(v, rf)
                            rf.write("\n")
                    print(f"Retriever: Retrieved file saved to {retrieved_file_path}")

            per_task = evaluate_recall(retrieved_indices, hashed_query_ids, qrel, qid_to_taskid, metric_recall_list)
            for task_id, metrics in per_task.items():
                eval_results.append({
                    "TaskID": int(task_id),
                    "Task": get_mbeir_task_name(int(task_id)),
                    "Dataset": dataset_name,
                    "Split": split,
                    "CandPool": cand_pool_name,
                    **metrics,
                })

    if retrieval_config.write_to_tsv and main_proc:
        tsv_file_path = os.path.join(exp_tsv_results_dir, f"eval_results_{datetime.now().strftime('%m-%d-%H')}.tsv")
        write_tsv_report(eval_results, tsv_file_path)
        print(f"Retriever: Results saved to {tsv_file_path}")
    mesh.barrier("run_retrieval_done")
    return eval_results
