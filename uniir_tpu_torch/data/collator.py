"""Static-shape collators producing numpy batches: the port's copy of
uniir_tpu/data/collator.py, held equal to it by tests/test_torch_data.py.

Reference contract (src/data/mbeir_dataset.py:414-610): flatten query + pos +
negs into ONE tensor batch, pad missing modality with a black (all-zero) image
or empty string plus 0/1 masks, and expose `index_mapping` {query, pos_cand,
neg_cand_list -> flat indices}.

Change from the reference: it builds the flat batch in arrival order with
Python index lists (dynamic shapes).  Here the layout is *static* so the
train step can slice instead of gather:

    rows [0, bs)                      -> queries
    rows [bs, 2*bs)                   -> positive candidates
    rows [2*bs + i*neg + j]           -> j-th hard negative of query i

`index_mapping` is still emitted (as int32 arrays with the reference's
nesting: query [bs,1], pos_cand [bs,1], neg_cand_list [bs,neg]) so any
consumer written against the reference contract works unchanged.

Images are NHWC float32; missing images are all-zero arrays,
matching the reference's ``torch.zeros`` padded image (mbeir_dataset.py:427).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Union

import numpy as np

from uniir_tpu_torch.data.dataset import Mode


class CollatorBase:
    def __init__(self, tokenizer: Callable[[List[str]], Any], image_size: Union[tuple, int]):
        self.tokenizer = tokenizer
        image_size = (image_size, image_size) if isinstance(image_size, int) else tuple(image_size)
        self.H, self.W = image_size
        self.padded_txt = ""

    def _padded_image(self) -> np.ndarray:
        return np.zeros((self.H, self.W, 3), dtype=np.float32)

    def _pack_text(self, txt) -> tuple:
        return (txt, 1) if txt not in [None, ""] else (self.padded_txt, 0)

    def _pack_image(self, img) -> tuple:
        return (np.asarray(img, dtype=np.float32), 1) if img is not None else (self._padded_image(), 0)

    def _assemble(self, txt_list, img_list, txt_mask, img_mask) -> Dict[str, Any]:
        txt_batched = self.tokenizer(txt_list)
        batch = {
            "txt_batched": txt_batched,
            "image_batched": np.stack(img_list, axis=0),
            "txt_mask_batched": np.asarray(txt_mask, dtype=np.int32),
            "image_mask_batched": np.asarray(img_mask, dtype=np.int32),
        }
        n = txt_batched["input_ids"].shape[0] if isinstance(txt_batched, dict) else len(txt_batched)
        assert n == batch["image_batched"].shape[0]
        assert n == batch["txt_mask_batched"].shape[0]
        assert n == batch["image_mask_batched"].shape[0]
        return batch


class MBEIRMainCollator(CollatorBase):
    def __init__(self, tokenizer, image_size, mode: Mode = Mode.TRAIN, hard_neg_num: int = 0):
        super().__init__(tokenizer, image_size)
        self.mode = mode
        self.hard_neg_num = hard_neg_num

    def __call__(self, batch: List[dict]) -> Dict[str, Any]:
        bs = len(batch)
        neg = self.hard_neg_num if self.mode == Mode.TRAIN else 0
        has_negs = self.mode == Mode.TRAIN and neg > 0 and "neg_cand_list" in batch[0]

        txt_list: List[str] = []
        img_list: List[np.ndarray] = []
        txt_mask: List[int] = []
        img_mask: List[int] = []

        def push(item: dict) -> None:
            t, tm = self._pack_text(item["txt"])
            im, im_m = self._pack_image(item["img"])
            txt_list.append(t)
            img_list.append(im)
            txt_mask.append(tm)
            img_mask.append(im_m)

        for inst in batch:  # queries
            push(inst["query"])
        if self.mode == Mode.TRAIN:
            for inst in batch:  # positives
                push(inst["pos_cand"])
            if has_negs:
                for inst in batch:
                    negs = inst["neg_cand_list"]
                    assert len(negs) == neg, f"expected {neg} negatives, got {len(negs)}"
                    for n_item in negs:
                        push(n_item)

        index_mapping: Dict[str, np.ndarray] = {
            "query": np.arange(bs, dtype=np.int32).reshape(bs, 1),
        }
        if self.mode == Mode.TRAIN:
            index_mapping["pos_cand"] = (bs + np.arange(bs, dtype=np.int32)).reshape(bs, 1)
            if has_negs:
                index_mapping["neg_cand_list"] = (2 * bs + np.arange(bs * neg, dtype=np.int32)).reshape(bs, neg)

        out = self._assemble(txt_list, img_list, txt_mask, img_mask)
        out["index_mapping"] = index_mapping

        if self.mode == Mode.EVAL:
            qid_list = [inst["qid"] for inst in batch if "qid" in inst]
            task_id_list = [inst["task_id"] for inst in batch if "task_id" in inst]
            if qid_list:
                out["qid_list"] = np.asarray(qid_list, dtype=np.int64)
            if task_id_list:
                out["task_id_list"] = np.asarray(task_id_list, dtype=np.int32)
        else:
            p_did_list = [inst["p_did"] for inst in batch if "p_did" in inst]
            if p_did_list:
                out["p_did_list"] = np.asarray(p_did_list, dtype=np.int64)
            n_dids = [inst["n_dids"] for inst in batch if "n_dids" in inst]
            if n_dids:
                out["nc_dids_list"] = np.asarray(n_dids, dtype=np.int64)
        return out


class MBEIRInferenceOnlyCollator(CollatorBase):
    def __call__(self, batch: List[dict]) -> Dict[str, Any]:
        txt_list, img_list, txt_mask, img_mask = [], [], [], []
        qid_list, task_id_list = [], []
        for inst in batch:
            q = inst["query"]
            t, tm = self._pack_text(q["txt"])
            im, im_m = self._pack_image(q["img"])
            txt_list.append(t)
            img_list.append(im)
            txt_mask.append(tm)
            img_mask.append(im_m)
            if "qid" in inst:
                qid_list.append(inst["qid"])
            if "task_id" in inst:
                task_id_list.append(inst["task_id"])
        out = self._assemble(txt_list, img_list, txt_mask, img_mask)
        out["qid_list"] = np.asarray(qid_list, dtype=np.int64)
        out["task_id_list"] = np.asarray(task_id_list, dtype=np.int32)
        return out


class MBEIRCandidatePoolCollator(CollatorBase):
    def __call__(self, batch: List[dict]) -> Dict[str, Any]:
        txt_list, img_list, txt_mask, img_mask, did_list = [], [], [], [], []
        for inst in batch:
            t, tm = self._pack_text(inst["txt"])
            im, im_m = self._pack_image(inst["img"])
            txt_list.append(t)
            img_list.append(im)
            txt_mask.append(tm)
            img_mask.append(im_m)
            if "did" in inst:
                did_list.append(inst["did"])
        out = self._assemble(txt_list, img_list, txt_mask, img_mask)
        if did_list:
            out["did_list"] = np.asarray(did_list, dtype=np.int64)
        return out
