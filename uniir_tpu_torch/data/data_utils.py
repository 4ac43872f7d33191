"""Dataset/collator factory (reference src/data/mbeir_data_utils.py:20-101):
the port's copy of uniir_tpu/data/data_utils.py."""

from __future__ import annotations

from enum import Enum

from uniir_tpu_torch.core.config import parse_image_size
from uniir_tpu_torch.data.collator import MBEIRCandidatePoolCollator, MBEIRMainCollator
from uniir_tpu_torch.data.dataset import MBEIRCandidatePoolDataset, MBEIRMainDataset, Mode


class DatasetType(Enum):
    MAIN_TRAIN = "main_train"
    IN_BATCH_VAL = "in_batch_val"
    CAND = "cand"


def build_mbeir_dataset_from_config(config, tokenizer, img_preprocess_fn, dataset_type: DatasetType):
    """Build (dataset, collator) for a DatasetType (reference :20-66)."""
    data_config = config.data_config
    image_size = parse_image_size(data_config.image_size)
    mbeir_data_dir = config.mbeir_data_dir
    query_instruct_path = data_config.query_instruct_path
    hard_neg_num = int(getattr(data_config, "hard_neg_num", 0))
    returns = getattr(data_config, "returns", None)
    returns = dict(returns.items()) if returns is not None and hasattr(returns, "items") else (returns or {})

    if dataset_type == DatasetType.MAIN_TRAIN:
        dataset = MBEIRMainDataset(
            mbeir_data_dir=mbeir_data_dir,
            query_data_path=data_config.train_query_data_path,
            cand_pool_path=data_config.train_cand_pool_path,
            query_instruct_path=query_instruct_path,
            img_preprocess_fn=img_preprocess_fn,
            mode=Mode.TRAIN,
            enable_query_instruct=data_config.enable_query_instruct,
            shuffle_cand=data_config.shuffle_cand,
            hard_neg_num=hard_neg_num,
            returns={"hashed_p_did": True, "hashed_n_dids": hard_neg_num > 0, **returns},
        )
        collator = MBEIRMainCollator(
            tokenizer=tokenizer, image_size=image_size, mode=Mode.TRAIN, hard_neg_num=hard_neg_num
        )
    elif dataset_type == DatasetType.IN_BATCH_VAL:
        dataset = MBEIRMainDataset(
            mbeir_data_dir=mbeir_data_dir,
            query_data_path=data_config.val_query_data_path,
            cand_pool_path=data_config.val_cand_pool_path,
            query_instruct_path=query_instruct_path,
            img_preprocess_fn=img_preprocess_fn,
            mode=Mode.TRAIN,  # in-batch val computes the train loss (reference)
            enable_query_instruct=data_config.enable_query_instruct,
            shuffle_cand=data_config.shuffle_cand,
            hard_neg_num=hard_neg_num,
            returns={"hashed_p_did": True, "hashed_n_dids": hard_neg_num > 0, **returns},
        )
        collator = MBEIRMainCollator(
            tokenizer=tokenizer, image_size=image_size, mode=Mode.TRAIN, hard_neg_num=hard_neg_num
        )
    elif dataset_type == DatasetType.CAND:
        dataset = MBEIRCandidatePoolDataset(
            mbeir_data_dir=mbeir_data_dir,
            cand_pool_data_path=data_config.cand_pool_path,
            img_preprocess_fn=img_preprocess_fn,
            returns=returns,
        )
        collator = MBEIRCandidatePoolCollator(tokenizer=tokenizer, image_size=image_size)
    else:
        raise ValueError(f"Unknown dataset type {dataset_type}")
    return dataset, collator
