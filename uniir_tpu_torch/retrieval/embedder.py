"""Embedding generation (counterpart of uniir_tpu/retrieval/embedder.py).

For every enabled split / dataset / pool of embed.yaml: build the dataset and
loader, run the embed step per collated batch, and save fp16
`mbeir_{name}_{split}_embed.npy` + `_ids.npy` artifacts with the reference's
naming.  The union pool is the concatenation of the per-pool artifacts,
written by rank 0.

Over several processes (`core.mesh`) rank r embeds the contiguous rows
[r * ceil(N / W), ...) (`ContiguousSampler`; its last batch padded by
repeating its last row and trimmed by `n_valid`, so no pad row reaches a
file) and writes `<path>.part{r}.npy`; after a barrier rank 0 concatenates
the parts in rank order into `<path>`, deletes them, and a second barrier
follows (the reference's tmp-file variant, mbeir_embedder.py:123-191).
"""

from __future__ import annotations

import os
from typing import Callable, Iterable

import numpy as np
import torch

from uniir_tpu_torch.core import mesh
from uniir_tpu_torch.core.config import parse_image_size
from uniir_tpu_torch.data.collator import MBEIRCandidatePoolCollator, MBEIRMainCollator
from uniir_tpu_torch.data.dataset import MBEIRCandidatePoolDataset, MBEIRMainDataset, Mode
from uniir_tpu_torch.data.loader import ContiguousSampler, MBEIRLoader
from uniir_tpu_torch.train.steps import make_embed_step


def generate_embeds_and_ids_for_dataset(embed_step: Callable, data_loader: Iterable):
    """Embed every collated batch of `data_loader` (dicts in the collator's
    format, with `did_list` or `qid_list` and optionally `n_valid`);
    returns (embeddings [N, D], ids [N])."""
    embeddings, ids = [], []
    for batch in data_loader:
        n_valid = int(batch.pop("n_valid", batch["image_batched"].shape[0]))
        id_list = batch.pop("did_list", None)
        if id_list is None:
            id_list = batch.pop("qid_list", None)
        batch.pop("task_id_list", None)
        batch.pop("index_mapping", None)
        if id_list is None:
            raise ValueError("id_list must be provided.")
        emb = embed_step(batch).cpu().numpy()
        embeddings.append(emb[:n_valid])
        ids.append(np.asarray(id_list)[:n_valid])
    embedding_list = np.concatenate(embeddings, axis=0)
    id_list = np.concatenate(ids, axis=0)
    if len(set(id_list.tolist())) != len(id_list):
        raise ValueError("IDs should be unique")
    return embedding_list, id_list


def _loader_for(split_name, dataset_name, cand_pool_name, bundle, config, image_size):
    data_config = config.data_config
    split_dir = getattr(data_config, f"{split_name}_dir_name")
    if split_name == "cand_pool":
        dataset = MBEIRCandidatePoolDataset(
            mbeir_data_dir=config.mbeir_data_dir,
            cand_pool_data_path=os.path.join(split_dir, f"mbeir_{cand_pool_name}_{split_name}.jsonl"),
            img_preprocess_fn=bundle.img_preprocess_fn_eval,
        )
        collator = MBEIRCandidatePoolCollator(tokenizer=bundle.tokenizer, image_size=image_size)
    else:
        dataset = MBEIRMainDataset(
            mbeir_data_dir=config.mbeir_data_dir,
            query_data_path=os.path.join(split_dir, f"mbeir_{dataset_name}_{split_name}.jsonl"),
            cand_pool_path=os.path.join(data_config.cand_pool_dir_name, f"mbeir_{cand_pool_name}_cand_pool.jsonl"),
            query_instruct_path=data_config.query_instruct_path,
            img_preprocess_fn=bundle.img_preprocess_fn_eval,
            mode=Mode.EVAL,
            enable_query_instruct=data_config.enable_query_instruct,
            shuffle_cand=data_config.shuffle_cand,
        )
        collator = MBEIRMainCollator(tokenizer=bundle.tokenizer, image_size=image_size, mode=Mode.EVAL)
    sampler = ContiguousSampler(len(dataset), num_replicas=mesh.process_count(), rank=mesh.process_index())
    return MBEIRLoader(
        dataset, collator, batch_size=config.dataloader_config.batch_size, sampler=sampler,
        num_workers=config.dataloader_config.num_workers, drop_last=False, pad_last=True,
    )


def save_embeddings(embed_path: str, id_path: str, embeddings: np.ndarray, ids: np.ndarray, tag: str) -> None:
    """Write the artifacts; over several processes this rank's part files,
    concatenated in rank order by rank 0 between two barriers named after
    `tag` (every rank must call it)."""
    n_proc, rank = mesh.process_count(), mesh.process_index()
    if n_proc == 1:
        np.save(embed_path, embeddings)
        np.save(id_path, ids)
        return
    np.save(f"{embed_path}.part{rank}", embeddings)
    np.save(f"{id_path}.part{rank}", ids)
    mesh.barrier(f"embed_{tag}")
    if rank == 0:
        for path in (embed_path, id_path):
            parts = [f"{path}.part{r}.npy" for r in range(n_proc)]
            np.save(path, np.concatenate([np.load(part) for part in parts], axis=0))
            for part in parts:
                os.remove(part)
    mesh.barrier(f"embed_{tag}_done")


def generate_embeds_for_config(bundle, config) -> list:
    """Run the embed sweep of embed.yaml; returns the paths written."""
    embed_config = config.embed_config
    data_config = config.data_config
    image_size = parse_image_size(data_config.image_size)
    out_root = os.path.join(config.uniir_dir, embed_config.embed_dir_name, config.experiment.path_suffix)
    use_fp16 = bool(getattr(embed_config, "use_fp16", True))
    embed_step = make_embed_step(bundle.model, out_dtype=torch.float16 if use_fp16 else torch.float32)

    splits = []
    for split_name in ("train", "val", "test"):
        ds_cfg = getattr(embed_config, f"{split_name}_datasets_config", None)
        if ds_cfg and ds_cfg.enable_embed:
            names, pools = ds_cfg.datasets_name, ds_cfg.correspond_cand_pools_name
            if len(names) != len(pools):
                raise ValueError("Mismatch between datasets and candidate pools.")
            splits.append((split_name, names, pools))
    cand_cfg = getattr(embed_config, "cand_pools_config", None)
    if cand_cfg and cand_cfg.enable_embed:
        pool_names = cand_cfg.cand_pools_name_to_embed
        splits.append(("cand_pool", [None] * len(pool_names), pool_names))

    written = []
    for split_name, dataset_names, pool_names in splits:
        out_dir = os.path.join(out_root, split_name)
        for dataset_name, cand_pool_name in zip(dataset_names, pool_names):
            cand_pool_name = cand_pool_name.lower()
            dataset_name = dataset_name.lower() if dataset_name else None
            loader = _loader_for(split_name, dataset_name, cand_pool_name, bundle, config, image_size)
            embedding_list, id_list = generate_embeds_and_ids_for_dataset(embed_step, loader)
            mid_name = cand_pool_name if split_name == "cand_pool" else dataset_name
            os.makedirs(out_dir, exist_ok=True)
            embed_path = os.path.join(out_dir, f"mbeir_{mid_name}_{split_name}_embed.npy")
            id_path = os.path.join(out_dir, f"mbeir_{mid_name}_{split_name}_ids.npy")
            save_embeddings(embed_path, id_path, embedding_list, id_list, f"{mid_name}_{split_name}")
            print(f"Embedder Log: Saved embeddings to {embed_path} ({len(id_list)} rows of rank {mesh.process_index()}).")
            written.extend([embed_path, id_path])

        if split_name == "cand_pool" and getattr(cand_cfg, "embed_union_pool", False) and mesh.is_main_process():
            written.extend(write_union_pool(out_dir, pool_names))
    return written


def write_union_pool(cand_pool_dir: str, pool_names) -> list:
    """Union pool = concatenation of the per-pool artifacts, never re-encoded."""
    split_name = "cand_pool"
    parts = [f"mbeir_{name.lower()}_{split_name}" for name in pool_names]
    embeds = np.concatenate([np.load(os.path.join(cand_pool_dir, f"{p}_embed.npy")) for p in parts], axis=0)
    ids = np.concatenate([np.load(os.path.join(cand_pool_dir, f"{p}_ids.npy")) for p in parts], axis=0)
    paths = [os.path.join(cand_pool_dir, f"mbeir_union_{split_name}_{kind}.npy") for kind in ("embed", "ids")]
    np.save(paths[0], embeds)
    np.save(paths[1], ids)
    print(f"Embedder Log: Saved union pool ({len(ids)} rows).")
    return paths
