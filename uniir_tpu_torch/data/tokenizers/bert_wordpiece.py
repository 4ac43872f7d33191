"""BERT WordPiece tokenizer (pure Python and numpy) for the BLIP text encoders:
the port's copy of uniir_tpu/data/tokenizers/bert_wordpiece.py, held equal
to it by tests/test_torch_data.py.

Replaces the HF ``BertTokenizer('bert-base-uncased')`` + [DEC]/[ENC] special
tokens used by BLIP (reference src/models/uniir_blip/backbone/blip.py:221-226)
with a self-contained implementation over a standard ``vocab.txt``.  Output is
a dict of fixed-shape int32 numpy arrays ``{"input_ids", "attention_mask"}``
matching the ``padding="max_length", truncation=True`` call in
reference blip_ff.py:70-80.
"""

from __future__ import annotations

import os
import unicodedata
from typing import Dict, List, Union

import numpy as np

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"
DEC, ENC = "[DEC]", "[ENC]"  # BLIP's additional special tokens


def _is_whitespace(ch: str) -> bool:
    return ch in (" ", "\t", "\n", "\r") or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        (0x4E00 <= cp <= 0x9FFF)
        or (0x3400 <= cp <= 0x4DBF)
        or (0x20000 <= cp <= 0x2A6DF)
        or (0x2A700 <= cp <= 0x2B73F)
        or (0x2B740 <= cp <= 0x2B81F)
        or (0x2B820 <= cp <= 0x2CEAF)
        or (0xF900 <= cp <= 0xFAFF)
        or (0x2F800 <= cp <= 0x2FA1F)
    )


class BasicTokenizer:
    def __init__(self, lowercase: bool = True):
        self.lowercase = lowercase

    def tokenize(self, text: str) -> List[str]:
        # Clean: drop control chars, normalize whitespace, pad CJK.
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            if _is_cjk(cp):
                out.extend([" ", ch, " "])
            elif _is_whitespace(ch):
                out.append(" ")
            else:
                out.append(ch)
        text = "".join(out)

        tokens: List[str] = []
        for tok in text.split():
            if self.lowercase:
                tok = tok.lower()
                tok = "".join(c for c in unicodedata.normalize("NFD", tok) if unicodedata.category(c) != "Mn")
            # split on punctuation
            buf: List[str] = []
            for ch in tok:
                if _is_punctuation(ch):
                    if buf:
                        tokens.append("".join(buf))
                        buf = []
                    tokens.append(ch)
                else:
                    buf.append(ch)
            if buf:
                tokens.append("".join(buf))
        return tokens


class WordPieceTokenizer:
    def __init__(self, vocab: Dict[str, int], unk_token: str = UNK, max_chars_per_word: int = 100):
        self.vocab = vocab
        self.unk_token = unk_token
        self.max_chars_per_word = max_chars_per_word

    def tokenize(self, word: str) -> List[str]:
        if len(word) > self.max_chars_per_word:
            return [self.unk_token]
        tokens: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            tokens.append(cur)
            start = end
        return tokens


class BertTokenizer:
    """End-to-end uncased BERT tokenizer over a vocab.txt file or dict."""

    def __init__(self, vocab: Union[str, Dict[str, int], List[str]], lowercase: bool = True, add_blip_special_tokens: bool = True):
        if isinstance(vocab, str):
            assert os.path.exists(vocab), f"vocab file {vocab} does not exist"
            with open(vocab, "r", encoding="utf-8") as f:
                words = [line.rstrip("\n") for line in f if line.rstrip("\n")]
            vocab = {w: i for i, w in enumerate(words)}
        elif isinstance(vocab, list):
            vocab = {w: i for i, w in enumerate(vocab)}
        self.vocab = dict(vocab)
        if add_blip_special_tokens:
            for tok in (DEC, ENC):
                if tok not in self.vocab:
                    self.vocab[tok] = len(self.vocab)
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        self.basic = BasicTokenizer(lowercase)
        self.wordpiece = WordPieceTokenizer(self.vocab)
        for tok in (PAD, UNK, CLS, SEP):
            assert tok in self.vocab, f"vocab is missing required special token {tok}"
        self.pad_token_id = self.vocab[PAD]
        self.cls_token_id = self.vocab[CLS]
        self.sep_token_id = self.vocab[SEP]
        self.unk_token_id = self.vocab[UNK]
        self.enc_token_id = self.vocab.get(ENC)
        self.bos_token_id = self.vocab.get(DEC)
        self.vocab_size = len(self.vocab)

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for word in self.basic.tokenize(text):
            out.extend(self.wordpiece.tokenize(word))
        return out

    def encode(self, text: str) -> List[int]:
        return [self.vocab.get(t, self.unk_token_id) for t in self.tokenize(text)]

    def __call__(self, texts: Union[str, List[str]], max_length: int = 64, padding: str = "max_length", truncation: bool = True) -> Dict[str, np.ndarray]:
        if isinstance(texts, str):
            texts = [texts]
        input_ids = np.full((len(texts), max_length), self.pad_token_id, dtype=np.int32)
        attention_mask = np.zeros((len(texts), max_length), dtype=np.int32)
        for i, text in enumerate(texts):
            ids = [self.cls_token_id] + self.encode(text)
            ids = ids[: max_length - 1] + [self.sep_token_id]
            input_ids[i, : len(ids)] = ids
            attention_mask[i, : len(ids)] = 1
        return {"input_ids": input_ids, "attention_mask": attention_mask}
