"""Hard-negative mining (counterpart of uniir_tpu/retrieval/hard_negs.py).

Search the first train dataset's queries against its pool's index, drop the
dids already in a query's positive or negative list, pad by cycling to
`num_hard_negs`, append them to `neg_cand_list` and write
`mbeir_{ds}_hard_negs_train.jsonl`.
"""

from __future__ import annotations

import os

import numpy as np

from uniir_tpu_torch.data.dataset import load_jsonl, save_jsonl
from uniir_tpu_torch.data.registry import unhash_did, unhash_qid
from uniir_tpu_torch.retrieval.index import DenseIndex
from uniir_tpu_torch.retrieval.search import search_dense_index


def mine_hard_negatives(retrieved_dids: list, pos_cand_list: list, neg_cand_list: list, num_hard_negs: int) -> list:
    """The retrieved dids that are neither positives nor negatives yet, cycled
    to `num_hard_negs` where fewer are left (none if none is)."""
    hard_negatives = [d for d in retrieved_dids if d not in pos_cand_list and d not in neg_cand_list]
    if 0 < len(hard_negatives) < num_hard_negs:
        multiplier, remainder = divmod(num_hard_negs, len(hard_negatives))
        hard_negatives = hard_negatives * multiplier + hard_negatives[:remainder]
    return hard_negatives[:num_hard_negs]


def run_hard_negative_mining(config, device=None) -> str:
    """Mine the first train dataset of retrieval.yaml; returns the path written."""
    retrieval_config = config.retrieval_config
    expt_dir_name = config.experiment.path_suffix
    train_cfg = retrieval_config.train_datasets_config
    if not train_cfg.enable_retrieve:
        raise ValueError("Hard negative mining is not enabled for training data")
    dataset_name = train_cfg.datasets_name[0].lower()  # the first dataset only, as the reference
    split = "train"

    query_data_list = load_jsonl(os.path.join(config.mbeir_data_dir, "train", f"mbeir_{dataset_name}_{split}.jsonl"))
    dataset_embed_dir = os.path.join(config.uniir_dir, retrieval_config.embed_dir_name, expt_dir_name, split)
    query_ids = np.load(os.path.join(dataset_embed_dir, f"mbeir_{dataset_name}_{split}_ids.npy"))
    query_embeds = np.load(os.path.join(dataset_embed_dir, f"mbeir_{dataset_name}_{split}_embed.npy"))
    cand_pool_name = train_cfg.correspond_cand_pools_name[0].lower()
    index = DenseIndex.load(os.path.join(
        config.uniir_dir, retrieval_config.index_dir_name, expt_dir_name, "cand_pool",
        f"mbeir_{cand_pool_name}_cand_pool.index",
    ))

    num_hard_negs = int(retrieval_config.num_hard_negs)
    _, retrieved_indices = search_dense_index(
        query_embeds, index, num_cand_to_retrieve=int(retrieval_config.k), device=device
    )
    if len(query_data_list) < len(query_ids):
        raise ValueError(f"{len(query_ids)} train query embeddings but {len(query_data_list)} queries")

    for query_id, query_data, retrieved in zip(query_ids, query_data_list, retrieved_indices):
        if unhash_qid(query_id) != query_data["qid"]:
            raise ValueError(f"embedding id {unhash_qid(query_id)} against query {query_data['qid']}")
        hard_negatives = mine_hard_negatives(
            [unhash_did(x) for x in retrieved], query_data["pos_cand_list"], query_data["neg_cand_list"], num_hard_negs
        )
        if not hard_negatives:
            print("Warning: hard_negatives list is empty.")
        query_data["neg_cand_list"].extend(hard_negatives)

    out_path = os.path.join(
        config.mbeir_data_dir, "train", retrieval_config.hard_negs_dir_name, f"mbeir_{dataset_name}_hard_negs_{split}.jsonl"
    )
    save_jsonl(query_data_list, out_path)
    print(f"MBEIR Train Data with Hard Negatives saved to {out_path} ({len(query_data_list)} entries)")
    return out_path
