"""CLIP byte-pair-encoding tokenizer (pure Python): the port's copy of
uniir_tpu/data/tokenizers/clip_bpe.py, held equal to it by
tests/test_torch_data.py.  CLIP's pre-tokenizer pattern (`_WORD_PAT`, which
the reference compiles with the `regex` package for its \\p classes) is
matched by a hand-written scanner, `words`, so nothing beyond the standard
library is needed (the GPU host has no `regex`).

Replacement for the external ``clip.tokenize`` dependency
(reference src/models/uniir_clip/clip_scorefusion/clip_sf.py:26,36-41): the
standard lowercased byte-level BPE over the public CLIP merges vocabulary,
emitting fixed 77-token int32 rows (sot + tokens + eot, zero padded,
truncate-with-eot) so the text tower sees exactly the shapes the published
CLIP weights were trained with.

The merges file (``bpe_simple_vocab_16e6.txt.gz``) ships with every public
CLIP distribution; pass its path (or set ``UNIIR_CLIP_BPE``).  Differences
from the reference stack: we do not run ``ftfy.fix_text`` (not available in
this environment) -- mojibake-free corpora like M-BEIR are unaffected.
"""

from __future__ import annotations

import gzip
import html
import os
import re
import unicodedata
from functools import lru_cache
from typing import List, Sequence, Union

import numpy as np

CONTEXT_LENGTH = 77
SOT_TOKEN = "<|startoftext|>"
EOT_TOKEN = "<|endoftext|>"

# the reference's pattern, compiled there with regex.IGNORECASE; `words` matches it
_WORD_PAT = r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"""
_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")
# `regex`'s \s: the Unicode White_Space property (str.isspace also takes U+001C..U+001F)
_SPACE_CHARS = "\t\n\x0b\x0c\r \x85\xa0\u1680\u2000\u2001\u2002\u2003\u2004\u2005\u2006\u2007\u2008\u2009\u200a\u2028\u2029\u202f\u205f\u3000"
_SPACES = re.compile(f"[{_SPACE_CHARS}]+")
# not a letter, yet excluded from [^\s\p{L}\p{N}] under IGNORECASE: its case variants are letters
_FOLDS_TO_LETTER = "\u0345"


def _fold(ch: str) -> str:
    """`ch` as IGNORECASE compares it with the pattern's ASCII literals
    (simple case folding: U+017F LONG S matches s)."""
    return "s" if ch == "\u017f" else ch.lower() if ch.isascii() else ch


def _matches_at(text: str, i: int, literal: str) -> bool:
    return len(text) - i >= len(literal) and all(_fold(text[i + k]) == c for k, c in enumerate(literal))


def _kind(ch: str) -> str:
    """"L" (\\p{L}), "N" (\\p{N}), "s" (\\s, or U+0345: matched by no branch) or "o" (the rest)."""
    if ch in _SPACE_CHARS or ch in _FOLDS_TO_LETTER:
        return "s"
    category = unicodedata.category(ch)[0]
    return category if category in "LN" else "o"


def words(text: str) -> List[str]:
    """`regex.findall(_WORD_PAT, text, regex.IGNORECASE)`: at each position
    the first branch that matches -- the special tokens, the contractions,
    a run of letters, one number character, a run of other non-space
    characters -- else the character is skipped."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        special = next((t for t in (SOT_TOKEN, EOT_TOKEN) if ch == "<" and _matches_at(text, i, t)), None)
        tail = next((t for t in _CONTRACTIONS if ch == "'" and _matches_at(text, i + 1, t)), None)
        if special is not None or tail is not None:
            j = i + (len(special) if special is not None else 1 + len(tail))
        else:
            kind = _kind(ch)
            j = i + 1
            if kind == "s":
                i = j
                continue
            if kind != "N":
                while j < n and _kind(text[j]) == kind:
                    j += 1
        out.append(text[i:j])
        i = j
    return out


@lru_cache()
def bytes_to_unicode():
    """Reversible byte <-> printable-unicode map (standard byte-level BPE trick)."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1)) + list(range(ord("\xae"), ord("\xff") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def _clean_text(text: str) -> str:
    text = html.unescape(html.unescape(text))
    text = _SPACES.sub(" ", text)
    return text.strip().lower()


def default_bpe_path() -> str | None:
    p = os.environ.get("UNIIR_CLIP_BPE")
    if p and os.path.exists(p):
        return p
    here = os.path.join(os.path.dirname(__file__), "bpe_simple_vocab_16e6.txt.gz")
    return here if os.path.exists(here) else None


class CLIPTokenizer:
    def __init__(self, bpe_path: str | None = None, merges: Sequence[tuple] | None = None):
        """Build from a merges file (gz or plain text) or an explicit merge list.

        `merges` exists so tests can construct tiny deterministic vocabularies
        without the 1.3MB public file.
        """
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}

        if merges is None:
            bpe_path = bpe_path or default_bpe_path()
            if bpe_path is None:
                raise FileNotFoundError(
                    "CLIP BPE merges file not found. Pass bpe_path= or set UNIIR_CLIP_BPE "
                    "to a bpe_simple_vocab_16e6.txt.gz from any public CLIP distribution."
                )
            if bpe_path.endswith(".gz"):
                raw = gzip.open(bpe_path).read().decode("utf-8")
            else:
                with open(bpe_path, "r", encoding="utf-8") as f:
                    raw = f.read()
            lines = raw.split("\n")
            # The public file's payload is lines [1, 49152-256-2+1) after the header.
            lines = lines[1 : 49152 - 256 - 2 + 1]
            merges = [tuple(line.split()) for line in lines if line.strip()]

        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend([SOT_TOKEN, EOT_TOKEN])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {SOT_TOKEN: SOT_TOKEN, EOT_TOKEN: EOT_TOKEN}
        self.sot_id = self.encoder[SOT_TOKEN]
        self.eot_id = self.encoder[EOT_TOKEN]
        self.vocab_size = len(self.encoder)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        text = _clean_text(text)
        for token in words(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder[int(i)] for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    def __call__(self, texts: Union[str, List[str]], context_length: int = CONTEXT_LENGTH, truncate: bool = True) -> np.ndarray:
        """Tokenize to an int32 array [N, context_length] (clip.tokenize parity)."""
        if isinstance(texts, str):
            texts = [texts]
        result = np.zeros((len(texts), context_length), dtype=np.int32)
        for i, text in enumerate(texts):
            tokens = [self.sot_id] + self.encode(text) + [self.eot_id]
            if len(tokens) > context_length:
                if truncate:
                    tokens = tokens[:context_length]
                    tokens[-1] = self.eot_id
                else:
                    raise RuntimeError(f"Input {texts[i]!r} is too long for context length {context_length}")
            result[i, : len(tokens)] = tokens
        return result
