"""Programmatic retrieval API (counterpart of uniir_tpu/retrieval/interactive.py).

`InteractiveRetriever(cand_index_path, candidates_path, dataset_name, config)`
-> `add_queries([(modality, txt, img_path, cand_modality), ...])` ->
`retrieve(k)` -> per-query lists of raw candidate dicts.  It is also the
complement retriever of raw retrieval (retrieval/eval.py).

Embeddings stay in memory between the embed step and the search.  Every
`retrieve` embeds every query added so far and uploads the pool again, as
the JAX retriever does.
"""

from __future__ import annotations

from enum import Enum
from typing import List, Optional, Tuple

import numpy as np
import torch

from uniir_tpu_torch.core.config import parse_image_size
from uniir_tpu_torch.core.device import module_device, resolve_device
from uniir_tpu_torch.data.collator import MBEIRInferenceOnlyCollator
from uniir_tpu_torch.data.dataset import MBEIRInferenceOnlyDataset, load_candidates
from uniir_tpu_torch.data.loader import MBEIRLoader
from uniir_tpu_torch.data.registry import DATASET_IDS, MBEIR_TASK, unhash_did
from uniir_tpu_torch.retrieval.embedder import generate_embeds_and_ids_for_dataset
from uniir_tpu_torch.retrieval.index import DenseIndex
from uniir_tpu_torch.retrieval.search import search_dense_index
from uniir_tpu_torch.train.steps import make_embed_step


class Modality(Enum):
    TEXT = "text"
    IMAGE = "image"
    IMAGE_TEXT = "image,text"


class InteractiveRetriever:
    def __init__(self, cand_index_path: str, candidates_path: str, dataset_name: str, config, bundle=None, device=None):
        """`bundle` None builds the model from `config` on `device`; `device`
        None means the card (the search runs there too)."""
        self.device = resolve_device(device)
        if bundle is None:
            from uniir_tpu_torch.models.registry import build_model_from_config

            bundle = build_model_from_config(config, device=self.device)
        self.dataset_id = DATASET_IDS[dataset_name]
        self.bundle = bundle
        self.config = config
        self.index = DenseIndex.load(cand_index_path)
        self.embed_step = make_embed_step(bundle.model, torch.float16)
        self.queries: List[dict] = []
        self.did_to_candidates = load_candidates(candidates_path)

    def add_queries(self, queries: List[Tuple[str, Optional[str], Optional[str], str]]) -> None:
        """Validated (modality, txt, img_path, cand_modality) tuples."""
        for query_modality, query_txt, query_img_path, candidate_modality in queries:
            if query_modality == Modality.TEXT.value:
                if not query_txt or query_img_path is not None:
                    raise ValueError("Query with 'text' modality must have non-null 'query_txt' and null 'query_img_path'")
            elif query_modality == Modality.IMAGE.value:
                if query_txt is not None or not query_img_path:
                    raise ValueError("Query with 'image' modality must have null 'query_txt' and non-null 'query_img_path'")
            elif query_modality == Modality.IMAGE_TEXT.value:
                if not query_txt or not query_img_path:
                    raise ValueError("Query with 'image,text' modality must have non-null 'query_txt' and 'query_img_path'")
            else:
                raise ValueError("Only 'text', 'image' and 'image,text' query modalities are supported.")
            self.queries.append({
                "qid": f"{self.dataset_id}:{len(self.queries) + 1}",
                "query_modality": query_modality,
                "query_txt": query_txt,
                "query_img_path": query_img_path,
                "task_id": MBEIR_TASK[f"{query_modality} -> {candidate_modality}"],
                "candidate_modality": candidate_modality,
            })

    def _query_loader(self) -> MBEIRLoader:
        """Collated batches of every query added so far, the last one padded."""
        data_config = self.config.data_config
        dataset = MBEIRInferenceOnlyDataset(
            self.config.mbeir_data_dir,
            self.queries,
            data_config.query_instruct_path,
            self.bundle.img_preprocess_fn_eval,
            enable_query_instruct=data_config.enable_query_instruct,
            device=module_device(self.bundle.model),
        )
        collator = MBEIRInferenceOnlyCollator(
            tokenizer=self.bundle.tokenizer, image_size=parse_image_size(data_config.image_size)
        )
        return MBEIRLoader(
            dataset,
            collator,
            batch_size=int(self.config.dataloader_config.batch_size),
            num_workers=int(self.config.dataloader_config.num_workers),
            drop_last=False,
            pad_last=True,
        )

    def _embed_queries(self) -> np.ndarray:
        embeds, _ = generate_embeds_and_ids_for_dataset(self.embed_step, self._query_loader())
        return embeds

    def retrieve(self, k: int = 1, batch_size: int = 100) -> List[list]:
        """The top k candidates of every query added so far, one full pool
        sweep per `batch_size` queries, the pool type by `UNIIR_TOPK_POOL`."""
        _, retrieved = search_dense_index(
            self._embed_queries(), self.index, num_cand_to_retrieve=k, batch_size=batch_size, device=self.device
        )
        return [[self.did_to_candidates[unhash_did(h)] for h in indices] for indices in retrieved]
