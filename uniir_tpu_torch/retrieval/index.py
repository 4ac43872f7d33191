"""Dense index build / load (counterpart of uniir_tpu/retrieval/index.py).

The index is the L2-normalised fp16 embedding matrix plus hashed ids, in
the same `.index` npz format, so either package reads the other's files.
Kept port-local because `uniir_tpu/retrieval/__init__.py` imports the JAX
search.  Single process: multi-process part files wait for a later PR.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


def normalize_l2(x: np.ndarray) -> np.ndarray:
    """faiss.normalize_L2 semantics in fp32 (zero rows stay zero)."""
    x = x.astype(np.float32)
    norms = np.linalg.norm(x, axis=1, keepdims=True)
    return x / np.where(norms == 0, 1.0, norms)


@dataclass
class DenseIndex:
    embeds: np.ndarray  # [N, D] fp16, L2-normalised
    ids: np.ndarray  # [N] int64 hashed ids

    @property
    def ntotal(self) -> int:
        return self.embeds.shape[0]

    @property
    def dim(self) -> int:
        return self.embeds.shape[1]

    @classmethod
    def build(cls, embeds: np.ndarray, ids: np.ndarray) -> "DenseIndex":
        ids = np.asarray(ids, dtype=np.int64)
        if len(ids) != len(set(ids.tolist())):
            raise ValueError("IDs should be unique")
        if embeds.shape[0] != ids.shape[0]:
            raise ValueError(f"{embeds.shape[0]} embeddings for {ids.shape[0]} ids")
        return cls(embeds=normalize_l2(embeds).astype(np.float16), ids=ids)

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".npz"  # np.savez appends .npz; write then move
        np.savez(tmp, embeds=self.embeds, ids=self.ids)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "DenseIndex":
        with np.load(path) as z:
            return cls(embeds=z["embeds"], ids=z["ids"])


def create_index(config) -> list:
    """Build `mbeir_{pool}_cand_pool.index` for every pool in index_config
    from the embedder's `_embed.npy` / `_ids.npy` artifacts."""
    index_config = config.index_config
    expt_dir_name = config.experiment.path_suffix
    idx_cfg = index_config.cand_pools_config
    if not idx_cfg.enable_idx:
        raise ValueError("Indexing is not enabled for candidate pool")
    split_name = "cand_pool"
    written = []
    for cand_pool_name in idx_cfg.cand_pools_name_to_idx:
        cand_pool_name = cand_pool_name.lower()
        embed_dir = os.path.join(config.uniir_dir, index_config.embed_dir_name, expt_dir_name, split_name)
        embeds = np.load(os.path.join(embed_dir, f"mbeir_{cand_pool_name}_{split_name}_embed.npy"))
        ids = np.load(os.path.join(embed_dir, f"mbeir_{cand_pool_name}_{split_name}_ids.npy"))
        faiss_cfg = getattr(index_config, "faiss_config", None)
        if faiss_cfg is not None and getattr(faiss_cfg, "dim", None) and faiss_cfg.dim != embeds.shape[1]:
            raise ValueError("The dimension of the index does not match the dimension of the embeddings!")
        index = DenseIndex.build(embeds, ids)
        index_path = os.path.join(
            config.uniir_dir, index_config.index_dir_name, expt_dir_name, split_name,
            f"mbeir_{cand_pool_name}_{split_name}.index",
        )
        index.save(index_path)
        print(f"Successfully indexed {index.ntotal} documents")
        print(f"Index saved to: {index_path}")
        written.append(index_path)
    return written
