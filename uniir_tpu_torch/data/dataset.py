"""M-BEIR datasets (host-side, framework-free): the port's copy of
uniir_tpu/data/dataset.py, held equal to it by tests/test_torch_data.py.
Pillow is imported where an image is opened, not with the module.

Re-implements the behavioral contract of the reference datasets
(reference src/data/mbeir_dataset.py:32-411) without torch: items are plain
dicts of python strings and numpy images; batching/tokenization happens in
the collators (`uniir_tpu_torch.data.collator`), which produce static-shape
numpy batches ready for the device.

Behavioral parity points:
  * jsonl loading + path asserts                 (mbeir_dataset.py:53-67)
  * instruction TSV keyed by (dataset_id, query_modality, cand_modality)
                                                 (mbeir_dataset.py:75-90)
  * random instruction sampling + format_string  (mbeir_dataset.py:102-108)
  * EVAL-mode positive filtering by query dataset id (OVEN/INFOSEEK hack)
                                                 (mbeir_dataset.py:202-205)
  * hard-negative sampling with wrap-around      (mbeir_dataset.py:226-241)
"""

from __future__ import annotations

import json
import os
import random
from enum import Enum
from typing import Any, Callable, List, Optional

import numpy as np
from uniir_tpu_torch.data.registry import (
    format_string,
    get_mbeir_task_id,
    hash_did,
    hash_qid,
)


class Mode(Enum):
    TRAIN = "train"
    EVAL = "eval"


def load_jsonl(path: str) -> list:
    """jsonl -> list of entries (blank lines skipped)."""
    with open(path, "r") as f:
        return [json.loads(line) for line in f if line.strip()]


def load_candidates(candidates_path: str) -> dict:
    """did -> candidate entry of a candidate-pool jsonl; a repeated did is an error."""
    did_to_candidates = {}
    for c in load_jsonl(candidates_path):
        if c["did"] in did_to_candidates:
            raise ValueError(f"dids must be unique: {c['did']} repeats in {candidates_path}")
        did_to_candidates[c["did"]] = c
    return did_to_candidates


def save_jsonl(entries: list, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for e in entries:
            f.write(json.dumps(e) + "\n")


class MBEIRDatasetBase:
    def __init__(self, mbeir_data_dir: str, img_preprocess_fn: Optional[Callable]):
        self.mbeir_data_dir = mbeir_data_dir
        self.img_preprocess_fn = img_preprocess_fn or (lambda x: x)
        self.query_instructions = {}
        self.rng = random.Random()

    def seed(self, seed: int) -> None:
        """Deterministic per-epoch reseeding (replaces global `random` use)."""
        self.rng.seed(seed)

    def __len__(self) -> int:
        raise NotImplementedError

    def _load_data(self, data_path: str) -> list:
        full = os.path.join(self.mbeir_data_dir, data_path)
        assert os.path.exists(full), f"Data Path {full} does not exist"
        assert full.endswith(".jsonl"), f"Data Path {full} is not a jsonl file"
        return load_jsonl(full)

    def _load_query_data(self, query_data_path: str) -> None:
        self.query_data = self._load_data(query_data_path)

    def _load_cand_pool(self, cand_pool_data_path: str) -> None:
        self.cand_pool = self._load_data(cand_pool_data_path)

    def _load_query_instructions(self, instructions_path: str) -> None:
        full = os.path.join(self.mbeir_data_dir, instructions_path)
        assert os.path.exists(full), f"Instructions Path {full} does not exist"
        assert full.endswith(".tsv"), f"Instructions Path {full} is not a tsv file"
        prompts_dict = {}
        with open(full, "r") as f:
            next(f)  # header
            for line in f.readlines():
                parts = line.strip().split("\t")
                # key: dataset_id, query_modality, cand_modality (ref :87)
                key = f"{parts[3]}, {parts[0]}, {parts[1]}"
                prompts_dict[key] = [p for p in parts[4:] if p]
        self.query_instructions = prompts_dict

    def _load_and_preprocess_image(self, img_path: Optional[str]):
        if not img_path:
            return None
        full = os.path.join(self.mbeir_data_dir, img_path)
        assert os.path.exists(full), f"Image Path {full} does not exist"
        from PIL import Image

        image = Image.open(full).convert("RGB")
        return self.img_preprocess_fn(image)

    def _get_random_query_prompt(self, dataset_id, query_modality, cand_modality) -> str:
        key = f"{dataset_id}, {query_modality}, {cand_modality}"
        prompts = self.query_instructions.get(key, [])
        assert prompts, f"Cannot find prompts for {key}"
        prompt = format_string(self.rng.choice(prompts))
        assert prompt, f"Prompt is empty for {key}"
        return prompt

    def __getitem__(self, index: int) -> dict:
        raise NotImplementedError


class MBEIRMainDataset(MBEIRDatasetBase):
    """Query-side train/eval dataset (reference MBEIRMainDataset :114-279)."""

    def __init__(
        self,
        mbeir_data_dir: str,
        query_data_path: str,
        cand_pool_path: str,
        query_instruct_path: str,
        img_preprocess_fn: Optional[Callable],
        mode: Mode = Mode.TRAIN,
        enable_query_instruct: bool = True,
        shuffle_cand: bool = True,
        hard_neg_num: int = 0,
        returns: Optional[dict] = None,
        print_config: bool = False,
    ):
        super().__init__(mbeir_data_dir, img_preprocess_fn)
        self._load_query_data(query_data_path)
        self._load_cand_pool_as_dict(cand_pool_path)
        self._load_query_instructions(query_instruct_path)

        self.mode = mode
        self.shuffle_cand = shuffle_cand
        self.enable_query_instruct = enable_query_instruct
        self.hard_neg_num = hard_neg_num
        returns = {} if returns is None else dict(returns)
        self.returns = {"hashed_qid": True, "task_id": False, "hashed_p_did": False, **returns}
        if print_config:
            print(
                f"MBEIRMainDataset(mode={mode}, query={query_data_path}, pool={cand_pool_path}, "
                f"instruct={enable_query_instruct}, shuffle_cand={shuffle_cand}, hard_neg_num={hard_neg_num})"
            )

    def _load_cand_pool_as_dict(self, cand_pool_data_path: str) -> None:
        self._load_cand_pool(cand_pool_data_path)
        pool = {}
        for entry in self.cand_pool:
            did = entry.get("did")
            assert did, f"Cannot find did for {entry}"
            pool[did] = entry
        self.cand_pool = pool

    def __len__(self) -> int:
        return len(self.query_data)

    def _select_cand(self, cand_list: list):
        return self.rng.choice(cand_list) if self.shuffle_cand else cand_list[0]

    def __getitem__(self, index: int) -> dict:
        entry = self.query_data[index]
        query_txt = entry.get("query_txt") or ""
        query_img_path = entry.get("query_img_path", None)
        query_modality = entry.get("query_modality", None)
        qid = entry.get("qid", None)
        query_dataset_id = qid.split(":")[0] if qid else None

        pos_cand_list = entry.get("pos_cand_list", [])
        assert len(pos_cand_list) > 0, f"Cannot find positive candidates for {entry}"

        # EVAL: keep only positives from the query's own dataset (OVEN/INFOSEEK
        # pools mix datasets; reference mbeir_dataset.py:202-205).
        if self.mode == Mode.EVAL:
            pos_cand_list = [d for d in pos_cand_list if d.split(":")[0] == query_dataset_id]
            assert len(pos_cand_list) > 0, (
                f"EVAL pos-candidate filter left no candidates from dataset "
                f"{query_dataset_id} for query {qid}"
            )

        selected_pos_cand_did = self._select_cand(pos_cand_list)
        pos_cand = self.cand_pool.get(selected_pos_cand_did)
        assert pos_cand, f"Cannot find positive candidate {selected_pos_cand_did} for {entry}"
        pos_cand_modality = pos_cand.get("modality", None)
        pos_cand_txt = format_string(pos_cand.get("txt") or "")

        query_prompt = self._get_random_query_prompt(query_dataset_id, query_modality, pos_cand_modality)
        query_txt_with_prompt = format_string(f"{query_prompt} {query_txt}")
        query_txt_without_prompt = format_string(query_txt)

        # Hard negatives with wrap-around (reference :226-241).
        selected_neg_cands = []
        selected_neg_dids: List[str] = []
        if self.mode == Mode.TRAIN and self.hard_neg_num > 0:
            neg_ids = list(entry.get("neg_cand_list", []))
            assert len(neg_ids) > 0, f"Cannot find negative candidates for {entry}"
            if self.shuffle_cand:
                self.rng.shuffle(neg_ids)
            for i in range(self.hard_neg_num):
                did = neg_ids[i % len(neg_ids)]
                neg = self.cand_pool.get(did)
                # explicit message, matching reference mbeir_dataset.py:236-239
                assert neg is not None, f"Cannot find negative candidate {did} for query {qid}"
                neg = dict(neg)
                neg["txt"] = format_string(neg.get("txt") or "")
                selected_neg_cands.append(neg)
                selected_neg_dids.append(did)

        def _prep(txt, img_path):
            return {"txt": txt, "img": self._load_and_preprocess_image(img_path)}

        instance: dict = {
            "query": _prep(
                query_txt_with_prompt if self.enable_query_instruct else query_txt_without_prompt,
                query_img_path,
            )
        }

        if self.mode == Mode.EVAL:
            if self.returns.get("hashed_qid"):
                instance["qid"] = hash_qid(qid)
            if self.returns.get("task_id"):
                instance["task_id"] = get_mbeir_task_id(query_modality, pos_cand_modality)

        if self.mode == Mode.TRAIN:
            if self.returns.get("hashed_p_did"):
                instance["p_did"] = hash_did(selected_pos_cand_did)
            instance["pos_cand"] = _prep(pos_cand_txt, pos_cand.get("img_path", None))
            neg_list = [_prep(n["txt"], n.get("img_path", None)) for n in selected_neg_cands]
            if neg_list:
                instance["neg_cand_list"] = neg_list
                if self.returns.get("hashed_n_dids"):
                    instance["n_dids"] = [hash_did(d) for d in selected_neg_dids]
        return instance


class MBEIRInferenceOnlyDataset(MBEIRDatasetBase):
    """Ad-hoc query list (reference MBEIRInferenceOnlyDataset :282-354)."""

    def __init__(
        self,
        mbeir_data_dir: str,
        queries: list,
        query_instruct_path: str,
        img_preprocess_fn: Optional[Callable],
        enable_query_instruct: bool = True,
        returns: Optional[dict] = None,
    ):
        super().__init__(mbeir_data_dir, img_preprocess_fn)
        self.query_data = queries
        self._load_query_instructions(query_instruct_path)
        self.enable_query_instruct = enable_query_instruct
        returns = {} if returns is None else dict(returns)
        self.returns = {"hashed_qid": True, "task_id": False, **returns}

    def __len__(self) -> int:
        return len(self.query_data)

    def __getitem__(self, index: int) -> dict:
        entry = self.query_data[index]
        query_txt = entry.get("query_txt") or ""
        query_img_path = entry.get("query_img_path", None)
        query_modality = entry.get("query_modality", None)
        candidate_modality = entry.get("candidate_modality", None)
        qid = entry.get("qid", None)
        query_dataset_id = qid.split(":")[0] if qid else None

        query_prompt = self._get_random_query_prompt(query_dataset_id, query_modality, candidate_modality)
        query_txt_with_prompt = format_string(f"{query_prompt} {query_txt}")
        query_txt_without_prompt = format_string(query_txt)

        instance = {
            "query": {
                "txt": query_txt_with_prompt if self.enable_query_instruct else query_txt_without_prompt,
                "img": self._load_and_preprocess_image(query_img_path),
            }
        }
        if self.returns.get("hashed_qid"):
            instance["qid"] = hash_qid(qid)
        if self.returns.get("task_id"):
            instance["task_id"] = get_mbeir_task_id(query_modality, candidate_modality)
        return instance


class MBEIRCandidatePoolDataset(MBEIRDatasetBase):
    """Candidate pool iteration for embedding (reference :357-411)."""

    def __init__(
        self,
        mbeir_data_dir: str,
        cand_pool_data_path: str,
        img_preprocess_fn: Optional[Callable],
        returns: Optional[dict] = None,
    ):
        super().__init__(mbeir_data_dir, img_preprocess_fn)
        self._load_cand_pool(cand_pool_data_path)
        returns = {} if returns is None else dict(returns)
        self.returns = {"src_content": False, "hashed_did": True, **returns}

    def __len__(self) -> int:
        return len(self.cand_pool)

    def __getitem__(self, index: int) -> dict:
        entry = self.cand_pool[index]
        instance = {
            "txt": format_string(entry.get("txt") or ""),
            "img": self._load_and_preprocess_image(entry.get("img_path", None)),
            "modality": entry.get("modality", None),
        }
        if self.returns.get("hashed_did"):
            instance["did"] = hash_did(entry.get("did"))
        if self.returns.get("src_content"):
            instance["src_content"] = entry.get("src_content", None)
        return instance
