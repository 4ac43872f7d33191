"""The port's own data path (`uniir_tpu_torch/data`) against the JAX
package's (`uniir_tpu/data`) on the miniature M-BEIR tree of
tests/test_data.py: dataset items, collated batches, samplers, the padded
last batch, the CLIP transform and BPE ids are equal array for array."""

import threading
import time

import numpy as np
import pytest
from PIL import Image

from tests.helpers import build_mbeir_fixture, identity_image_transform, simple_tokenizer, tiny_clip_merges
from uniir_tpu.data import collator as jax_collator
from uniir_tpu.data import dataset as jax_dataset
from uniir_tpu.data import loader as jax_loader
from uniir_tpu.data import preprocess as jax_preprocess
from uniir_tpu.data import registry as jax_registry
from uniir_tpu.data.tokenizers.clip_bpe import CLIPTokenizer as JaxCLIPTokenizer
from uniir_tpu_torch.data import collator, dataset, loader, preprocess, registry
from uniir_tpu_torch.data.tokenizers.clip_bpe import CLIPTokenizer


@pytest.fixture(scope="module")
def mbeir_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("mbeir_torch")
    build_mbeir_fixture(str(root))
    return str(root)


def assert_same(a, b, where="item"):
    """Nested dicts / lists of arrays, strings and numbers are equal."""
    assert type(a) is type(b) or (np.isscalar(a) and np.isscalar(b)), f"{where}: {type(a)} vs {type(b)}"
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


def main_datasets(root, mode, hard_neg_num=0, returns=None):
    kwargs = dict(mbeir_data_dir=root, query_data_path="queries.jsonl", cand_pool_path="cand_pool.jsonl",
                  query_instruct_path="instructions.tsv", img_preprocess_fn=identity_image_transform(32),
                  hard_neg_num=hard_neg_num, returns=returns)
    ours = dataset.MBEIRMainDataset(mode=dataset.Mode[mode], **kwargs)
    theirs = jax_dataset.MBEIRMainDataset(mode=jax_dataset.Mode[mode], **kwargs)
    ours.seed(5), theirs.seed(5)
    return ours, theirs


@pytest.mark.parametrize("mode,hard_neg_num", [("TRAIN", 0), ("TRAIN", 7), ("EVAL", 0)])
def test_main_dataset_items_equal(mbeir_root, mode, hard_neg_num):
    returns = {"hashed_p_did": True, "hashed_n_dids": hard_neg_num > 0, "task_id": True}
    ours, theirs = main_datasets(mbeir_root, mode, hard_neg_num, returns)
    assert len(ours) == len(theirs) == 12
    for i in range(len(ours)):
        assert_same(ours[i], theirs[i], f"item {i}")


def test_cand_pool_and_inference_datasets_equal(mbeir_root):
    transform = identity_image_transform(32)
    ours = dataset.MBEIRCandidatePoolDataset(mbeir_root, "cand_pool.jsonl", transform, returns={"src_content": True})
    theirs = jax_dataset.MBEIRCandidatePoolDataset(mbeir_root, "cand_pool.jsonl", transform, returns={"src_content": True})
    assert len(ours) == len(theirs) == 24
    for i in range(len(ours)):
        assert_same(ours[i], theirs[i], f"candidate {i}")
    queries = [{"qid": "9:3", "query_txt": "red dress", "query_modality": "text", "candidate_modality": "image"}]
    a = dataset.MBEIRInferenceOnlyDataset(mbeir_root, queries, "instructions.tsv", transform, returns={"task_id": True})
    b = jax_dataset.MBEIRInferenceOnlyDataset(mbeir_root, queries, "instructions.tsv", transform, returns={"task_id": True})
    a.seed(1), b.seed(1)
    assert_same(a[0], b[0])


def test_jsonl_round_trip_and_registry_helpers(tmp_path):
    entries = [{"did": "9:1", "txt": "a"}, {"did": "9:2", "modality": "image"}]
    path = str(tmp_path / "sub" / "x.jsonl")
    dataset.save_jsonl(entries, path)
    assert dataset.load_jsonl(path) == jax_dataset.load_jsonl(path) == entries
    for s in ["  hello world", '"quoted"\r', "done.", "why?", "", None]:
        assert registry.format_string(s) == jax_registry.format_string(s)
    assert registry.MBEIR_TASK == jax_registry.MBEIR_TASK
    for q, c in [("text", "image"), ("image,text", "image,text"), ("image", "audio")]:
        assert registry.get_mbeir_task_id(q, c) == jax_registry.get_mbeir_task_id(q, c)
    assert registry.DATASET_IDS == jax_registry.DATASET_IDS
    assert registry.MBEIR_DATASET_TO_DOMAIN == jax_registry.MBEIR_DATASET_TO_DOMAIN
    assert registry.IMAGE_SHORT_SIDE == jax_registry.IMAGE_SHORT_SIDE
    for name in [*jax_registry.DATASET_IDS, "mscoco", "M-BEIR"]:
        assert registry.get_dataset_id(name) == jax_registry.get_dataset_id(name)
    for id_str in ["0:1", "9:123", "5:0", "10:4", "99:1"]:
        assert registry.get_dataset_name(id_str) == jax_registry.get_dataset_name(id_str)
    for task_id in range(-1, 11):
        assert (registry.get_mbeir_query_modality_cand_modality_from_task_id(task_id)
                == jax_registry.get_mbeir_query_modality_cand_modality_from_task_id(task_id))


@pytest.mark.parametrize("hard_neg_num", [0, 2])
def test_train_collator_batches_equal(mbeir_root, hard_neg_num):
    returns = {"hashed_p_did": True, "hashed_n_dids": hard_neg_num > 0}
    ours, theirs = main_datasets(mbeir_root, "TRAIN", hard_neg_num, returns)
    tok = simple_tokenizer()
    a = collator.MBEIRMainCollator(tok, 32, mode=dataset.Mode.TRAIN, hard_neg_num=hard_neg_num)
    b = jax_collator.MBEIRMainCollator(tok, 32, mode=jax_dataset.Mode.TRAIN, hard_neg_num=hard_neg_num)
    batch_a, batch_b = a([ours[i] for i in range(4)]), b([theirs[i] for i in range(4)])
    assert batch_a["image_batched"].shape == (4 * (2 + hard_neg_num), 32, 32, 3)
    assert_same(batch_a, batch_b, "batch")


def test_eval_and_cand_pool_collator_batches_equal(mbeir_root):
    ours, theirs = main_datasets(mbeir_root, "EVAL", returns={"task_id": True})
    tok = simple_tokenizer()
    a = collator.MBEIRMainCollator(tok, 32, mode=dataset.Mode.EVAL)
    b = jax_collator.MBEIRMainCollator(tok, 32, mode=jax_dataset.Mode.EVAL)
    assert_same(a([ours[i] for i in range(5)]), b([theirs[i] for i in range(5)]), "eval batch")
    transform = identity_image_transform(32)
    pool_a = dataset.MBEIRCandidatePoolDataset(mbeir_root, "cand_pool.jsonl", transform)
    pool_b = jax_dataset.MBEIRCandidatePoolDataset(mbeir_root, "cand_pool.jsonl", transform)
    batch_a = collator.MBEIRCandidatePoolCollator(tok, 32)([pool_a[i] for i in range(6)])
    batch_b = jax_collator.MBEIRCandidatePoolCollator(tok, 32)([pool_b[i] for i in range(6)])
    assert batch_a["did_list"][0] == 9 * 10_000_000
    assert_same(batch_a, batch_b, "candidate batch")


@pytest.mark.parametrize("sampler", ["EpochShuffleSampler", "ContiguousSampler"])
def test_samplers_equal(sampler):
    n, world = 103, 8
    for rank in range(world):
        kwargs = {"seed": 7} if sampler == "EpochShuffleSampler" else {}
        a = getattr(loader, sampler)(n, world, rank, **kwargs)
        b = getattr(jax_loader, sampler)(n, world, rank, **kwargs)
        np.testing.assert_array_equal(a.indices(), b.indices())
        if sampler == "EpochShuffleSampler":
            a.set_epoch(3), b.set_epoch(3)
            np.testing.assert_array_equal(a.indices(), b.indices())


def test_loader_batches_equal_with_padded_last_batch(mbeir_root):
    transform = identity_image_transform(32)
    tok = simple_tokenizer()
    a = loader.MBEIRLoader(dataset.MBEIRCandidatePoolDataset(mbeir_root, "cand_pool.jsonl", transform),
                           collator.MBEIRCandidatePoolCollator(tok, 32), batch_size=10, num_workers=2,
                           drop_last=False, pad_last=True)
    b = jax_loader.MBEIRLoader(jax_dataset.MBEIRCandidatePoolDataset(mbeir_root, "cand_pool.jsonl", transform),
                               jax_collator.MBEIRCandidatePoolCollator(tok, 32), batch_size=10, num_workers=2,
                               drop_last=False, pad_last=True)
    batches_a, batches_b = list(a), list(b)
    assert len(batches_a) == len(batches_b) == 3  # 24 items -> 10, 10, 4 (+6 pad)
    assert all(x["image_batched"].shape[0] == 10 for x in batches_a) and int(batches_a[-1]["n_valid"]) == 4
    assert_same(batches_a, batches_b, "batches")


def test_loader_producer_unblocks_on_abandon():
    """Abandoning iteration with a full prefetch queue leaves no blocked producer thread."""

    class Toy:
        def __len__(self):
            return 64

        def __getitem__(self, i):
            return i

    batches = loader.MBEIRLoader(Toy(), collate_fn=lambda items: {"x": np.asarray(items)}, batch_size=4, prefetch=1)
    before = threading.active_count()
    it = iter(batches)
    next(it)  # start the producer; the queue fills behind the consumer
    del it  # abandon: closing the generator sets the stop flag
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before, "producer thread still alive after abandon"


@pytest.mark.parametrize("size", [(64, 48), (30, 90), (224, 224)])
def test_clip_transform_and_raw_resize_equal(size):
    rng = np.random.default_rng(3)
    img = Image.fromarray(rng.integers(0, 255, size=(size[1], size[0], 3), dtype=np.uint8))
    out = preprocess.clip_transform(32)(img)
    assert out.shape == (32, 32, 3) and out.dtype == np.float32
    np.testing.assert_array_equal(out, jax_preprocess.clip_transform(32)(img))
    np.testing.assert_array_equal(preprocess.raw_resize_uint8(32)(img), jax_preprocess.raw_resize_uint8(32)(img))
    np.testing.assert_array_equal(preprocess.blip_transform(32, is_train=False)(img),
                                  jax_preprocess.blip_transform(32, is_train=False)(img))


def test_blip_train_transform_equal_under_one_seed():
    import random

    rng = np.random.default_rng(4)
    img = Image.fromarray(rng.integers(0, 255, size=(60, 80, 3), dtype=np.uint8))
    outs = []
    for module in (preprocess, jax_preprocess):
        random.seed(11)
        fn = module.blip_transform(32, is_train=True)
        outs.append([fn(img) for _ in range(6)])  # six draws walk several RandAugment ops
    assert_same(outs[0], outs[1], "augmented")


def test_clip_bpe_ids_equal():
    ours, theirs = CLIPTokenizer(merges=tiny_clip_merges()), JaxCLIPTokenizer(merges=tiny_clip_merges())
    texts = ["red dress", "A cat   photo!", "it's 42 dogs &amp; cats", "naïve café — news", "cat " * 200, ""]
    np.testing.assert_array_equal(ours(texts), theirs(texts))
    np.testing.assert_array_equal(ours(texts, context_length=16), theirs(texts, context_length=16))
    out = ours(texts)
    assert out.shape == (6, 77) and out.dtype == np.int32 and out[0, 0] == ours.sot_id
    assert (out == ours.eot_id).any(axis=1).all()
    assert ours.decode(ours.encode("red dress")) == theirs.decode(theirs.encode("red dress"))
    with pytest.raises(RuntimeError, match="too long"):
        ours(["cat " * 200], context_length=16, truncate=False)


@pytest.mark.parametrize("kind", ["MAIN_TRAIN", "IN_BATCH_VAL", "CAND"])
def test_dataset_factory_equals_jax(mbeir_root, kind):
    """`build_mbeir_dataset_from_config` builds the same dataset and collator in both packages."""
    from uniir_tpu.core.config import Config as JaxConfig
    from uniir_tpu.data import data_utils as jax_data_utils
    from uniir_tpu_torch.core.config import Config
    from uniir_tpu_torch.data import data_utils

    as_dict = {"mbeir_data_dir": mbeir_root, "data_config": {
        "image_size": "32, 32", "hard_neg_num": 2, "shuffle_cand": False, "enable_query_instruct": True,
        "query_instruct_path": "instructions.tsv", "train_query_data_path": "queries.jsonl",
        "train_cand_pool_path": "cand_pool.jsonl", "val_query_data_path": "queries.jsonl",
        "val_cand_pool_path": "cand_pool.jsonl", "cand_pool_path": "cand_pool.jsonl"}}
    tok, transform = simple_tokenizer(), identity_image_transform(32)
    ours_ds, ours_coll = data_utils.build_mbeir_dataset_from_config(
        Config.from_dict(as_dict), tok, transform, data_utils.DatasetType[kind])
    theirs_ds, theirs_coll = jax_data_utils.build_mbeir_dataset_from_config(
        JaxConfig.from_dict(as_dict), tok, transform, jax_data_utils.DatasetType[kind])
    ours_ds.seed(2), theirs_ds.seed(2)
    assert len(ours_ds) == len(theirs_ds)
    assert_same(ours_coll([ours_ds[i] for i in range(3)]), theirs_coll([theirs_ds[i] for i in range(3)]), kind)


# --------------------------------------------------- BERT WordPiece tokenizer


BERT_TEXTS = [
    "A red dress.", "the cats photo", "", "Dogs matching the style of news images",
    "unknownword red", "café  dog\tphoto\n", "red " * 60, "blue-shirt, (cat)!", "狗 cat",
]


@pytest.mark.parametrize("max_length", [8, 16, 50])
def test_bert_tokenizer_equals_jax(max_length):
    from tests.helpers import tiny_bert_vocab
    from uniir_tpu.data.tokenizers.bert_wordpiece import BertTokenizer as JaxBertTokenizer
    from uniir_tpu_torch.data.tokenizers.bert_wordpiece import BertTokenizer

    ours, theirs = BertTokenizer(tiny_bert_vocab()), JaxBertTokenizer(tiny_bert_vocab())
    assert_same(ours(BERT_TEXTS, max_length=max_length), theirs(BERT_TEXTS, max_length=max_length), "batch")
    out = ours(BERT_TEXTS, max_length=max_length)
    assert out["input_ids"].dtype == np.int32 and out["input_ids"].shape == (len(BERT_TEXTS), max_length)
    # truncation keeps [CLS] first and [SEP] last; padding is masked out
    long_row = out["input_ids"][6]
    assert long_row[0] == ours.cls_token_id and long_row[-1] == ours.sep_token_id and out["attention_mask"][6].all()
    assert (out["input_ids"][2][:2] == [ours.cls_token_id, ours.sep_token_id]).all() and out["attention_mask"][2].sum() == 2
    assert ((out["attention_mask"] == 0) <= (out["input_ids"] == ours.pad_token_id)).all()
    for text in BERT_TEXTS:
        assert ours.tokenize(text) == theirs.tokenize(text) and ours.encode(text) == theirs.encode(text)


def test_bert_tokenizer_blip_special_tokens_and_vocab_file(tmp_path):
    from tests.helpers import tiny_bert_vocab
    from uniir_tpu.data.tokenizers.bert_wordpiece import BertTokenizer as JaxBertTokenizer
    from uniir_tpu_torch.data.tokenizers.bert_wordpiece import DEC, ENC, BertTokenizer

    words = tiny_bert_vocab()
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(words) + "\n", encoding="utf-8")
    ours, theirs = BertTokenizer(str(path)), JaxBertTokenizer(str(path))
    # BLIP appends [DEC] and [ENC] after the vocabulary (30522 + 2 for bert-base-uncased)
    assert ours.vocab == theirs.vocab and ours.vocab_size == len(words) + 2
    assert (ours.bos_token_id, ours.enc_token_id) == (ours.vocab[DEC], ours.vocab[ENC]) == (len(words), len(words) + 1)
    assert (ours.bos_token_id, ours.enc_token_id) == (theirs.bos_token_id, theirs.enc_token_id)
    plain = BertTokenizer(words, add_blip_special_tokens=False)
    assert plain.vocab_size == len(words) and plain.enc_token_id is None
    assert_same(ours("a red dress", max_length=8), theirs("a red dress", max_length=8), "single string")
