"""M-BEIR task table and id hashing used by retrieval (counterpart of uniir_tpu/data/registry.py).

Byte-compatible with the JAX package's tables and hash scheme (a test holds
them equal).  Kept port-local because `uniir_tpu/data/__init__.py` imports
the image dataset and with it Pillow, which the GPU host does not have.
"""

from __future__ import annotations

MBEIR_TASK = {
    "text -> image": 0,
    "text -> text": 1,
    "text -> image,text": 2,
    "image -> text": 3,
    "image -> image": 4,
    "image -> text,image": 5,  # not a valid task; kept for table parity
    "image,text -> text": 6,
    "image,text -> image": 7,
    "image,text -> image,text": 8,
}

DATASET_CAN_NUM_UPPER_BOUND = 10_000_000  # max candidates per dataset
DATASET_QUERY_NUM_UPPER_BOUND = 500_000  # max queries per dataset


def hash_qid(qid: str) -> int:
    dataset_id, data_within_id = map(int, qid.split(":"))
    return dataset_id * DATASET_QUERY_NUM_UPPER_BOUND + data_within_id


def unhash_qid(hashed_qid: int) -> str:
    hashed_qid = int(hashed_qid)
    return f"{hashed_qid // DATASET_QUERY_NUM_UPPER_BOUND}:{hashed_qid % DATASET_QUERY_NUM_UPPER_BOUND}"


def hash_did(did: str) -> int:
    dataset_id, data_within_id = map(int, did.split(":"))
    return dataset_id * DATASET_CAN_NUM_UPPER_BOUND + data_within_id


def unhash_did(hashed_did: int) -> str:
    hashed_did = int(hashed_did)
    return f"{hashed_did // DATASET_CAN_NUM_UPPER_BOUND}:{hashed_did % DATASET_CAN_NUM_UPPER_BOUND}"


def get_mbeir_task_name(task_id: int):
    for name, id_ in MBEIR_TASK.items():
        if id_ == task_id:
            return name
    return None
