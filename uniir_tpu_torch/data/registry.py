"""M-BEIR dataset and task tables, id hashing and text canonicalisation
(counterpart of uniir_tpu/data/registry.py).

Byte-compatible with the JAX package's tables and hash scheme (a test holds
them equal).  The port keeps its own copy: it imports nothing of the JAX
package.
"""

from __future__ import annotations

DATASET_IDS = {
    "VisualNews": 0,
    "Fashion200K": 1,
    "WebQA": 2,
    "EDIS": 3,
    "NIGHTS": 4,
    "OVEN": 5,
    "INFOSEEK": 6,
    "FashionIQ": 7,
    "CIRR": 8,
    "MSCOCO": 9,
}

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

MBEIR_DATASET_TO_DOMAIN = {
    "VisualNews": "news",
    "Fashion200K": "fashion",
    "WebQA": "wiki",
    "EDIS": "news",
    "NIGHTS": "common",
    "OVEN": "wiki",
    "INFOSEEK": "wiki",
    "FashionIQ": "fashion",
    "CIRR": "common",
    "MSCOCO": "common",
}

IMAGE_SHORT_SIDE = 256

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


def get_dataset_id(dataset_name: str):
    return DATASET_IDS.get(dataset_name, None)


def get_dataset_name(id_str: str):
    dataset_id = int(id_str.split(":")[0])
    for name, id_ in DATASET_IDS.items():
        if id_ == dataset_id:
            return name
    return None


def get_mbeir_task_name(task_id: int):
    for name, id_ in MBEIR_TASK.items():
        if id_ == task_id:
            return name
    return None


def get_mbeir_task_id(source_modality, target_modality):
    return MBEIR_TASK.get(f"{source_modality} -> {target_modality}", None)


def get_mbeir_query_modality_cand_modality_from_task_id(task_id: int):
    for name, id_ in MBEIR_TASK.items():
        if id_ == task_id:
            return name.split(" -> ")
    return None


def format_string(s) -> str:
    """Canonicalize a text string (reference utils.py:110-116).

    Strip, remove carriage returns and surrounding double quotes, capitalize
    the first character, and terminate with '.' unless already punctuated.
    """
    s = (s or "").replace("\r", "").strip().strip('"')
    if s:
        s = s[0].upper() + s[1:]
        s = s + "." if s[-1] not in [".", "?", "!"] else s
    return s
