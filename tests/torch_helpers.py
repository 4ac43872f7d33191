"""Helpers shared by the port's tests (tests/test_torch_*.py)."""

from __future__ import annotations

import zlib

import numpy as np
from PIL import Image


def _word_id(word: str) -> int:
    # tests.helpers' tokenizers take hash(word), which Python salts in each process (PYTHONHASHSEED): the
    # same texts then give other token ids, and other near ties in a seeded model's scores, in every run
    return zlib.crc32(word.encode())


def stable_tokenizer(max_len: int = 16, vocab_size: int = 97):
    """tests.helpers.simple_tokenizer with a word id that is the same in every process: CLIP-style int32
    [N, L]."""

    def fn(texts):
        out = np.zeros((len(texts), max_len), dtype=np.int32)
        for i, t in enumerate(texts):
            toks = [1] + [2 + (_word_id(w) % (vocab_size - 3)) for w in t.lower().split()][: max_len - 2]
            toks.append(vocab_size - 1)
            out[i, : len(toks)] = toks
        return out

    return fn


def stable_bert_tokenizer(max_len: int = 16, vocab_size: int = 97):
    """tests.helpers.simple_bert_tokenizer with a word id that is the same in every process: BERT-style
    dict batches."""

    def fn(texts):
        input_ids = np.zeros((len(texts), max_len), dtype=np.int32)
        mask = np.zeros((len(texts), max_len), dtype=np.int32)
        for i, t in enumerate(texts):
            toks = [1] + [4 + (_word_id(w) % (vocab_size - 5)) for w in t.lower().split()][: max_len - 2] + [2]
            input_ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1
        return {"input_ids": input_ids, "attention_mask": mask}

    return fn


def on_array(fn):
    """A transform of PIL images (the JAX package's, or tests.helpers') as
    the port's datasets call theirs: on the decoded uint8 HWC array, which
    is Pillow's pixels bit for bit (tests/test_torch_jpeg.py)."""

    def wrapped(arr):
        return fn(Image.fromarray(arr))

    return wrapped
