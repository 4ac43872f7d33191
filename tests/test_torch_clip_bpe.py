"""The port's CLIP pre-tokenizer scanner (`clip_bpe.words`, no `regex`)
against `regex.findall` of the reference pattern, and the port's BPE
tokenizer against the JAX package's on the same merges.

Unicode versions: Python 3.12's `unicodedata` is Unicode 15.0 and `regex`
carries its own, newer tables, so the two disagree on code points that 15.0
leaves unassigned.  Random text is therefore drawn from code points that
Unicode 15.0 assigns (category other than Cn) and that are not surrogates:
those are the ones on which the scanner is held to `regex`."""

import sys
import unicodedata

import numpy as np
import pytest
import regex
from hypothesis import given, settings
from hypothesis import strategies as st

from tests.helpers import WORDS, tiny_clip_merges
from uniir_tpu.data.tokenizers import clip_bpe as jax_clip_bpe
from uniir_tpu.data.tokenizers.clip_bpe import CLIPTokenizer as JaxCLIPTokenizer
from uniir_tpu_torch.data.tokenizers import clip_bpe
from uniir_tpu_torch.data.tokenizers.clip_bpe import CLIPTokenizer

PATTERN = regex.compile(clip_bpe._WORD_PAT, regex.IGNORECASE)

CORPUS = [
    "A red dress on a mannequin.", "two dogs playing in the snow", "It's the cat's toy; they're here, we'll go",
    "IT'S LOUD 'S 'T 'RE 'VE 'M 'LL 'D", "don't Won'T I'M", "'s's''s", "''", "'x 'sx",
    "42 dogs, 3.14159 and 1,000,000 cats", "½ ¾ ² ⅷ ٣ ३", "naïve café résumé Ångström",
    "東京の夜景 한국어 文本", "emoji 🐶🐱 👍🏽 family 👨‍👩‍👧", "!!! ... ?!?! --- (()) [[]] {{}}",
    "tabs\tand\nnewlines\r\nand\x0bvertical\x0cfeed", "nbsp\xa0here em　ideographic",
    "\x1cfile\x1dgroup\x1erecord\x1funit", "<|startoftext|>a photo<|endoftext|>", "<|StartOfText|> <|ENDOFTEXT|>",
    "<|startof", "ſ 'ſ <|ſtartoftext|>", "ιͅ combining ypogegrammeni", "&amp;lt; html &quot;quoted&quot;",
    "a b c\x85d", "", "   ", "x",
]

ASSIGNED = st.characters(exclude_categories=("Cn", "Cs"))


@pytest.mark.parametrize("text", CORPUS, ids=range(len(CORPUS)))
def test_scanner_equals_regex_on_corpus(text):
    assert clip_bpe.words(text) == PATTERN.findall(text)
    assert clip_bpe.words(text.lower()) == PATTERN.findall(text.lower())
    assert clip_bpe._clean_text(text) == jax_clip_bpe._clean_text(text)


@settings(max_examples=300, deadline=None)
@given(st.lists(st.one_of(st.text(ASSIGNED, max_size=6),
                          st.sampled_from(["'s", "'LL", "'d", "'", " ", "\t", "\xa0", "<|endoftext|>", "<|", "1", "ſ"])),
                max_size=12).map("".join))
def test_scanner_equals_regex_on_assigned_code_points(text):
    assert clip_bpe.words(text) == PATTERN.findall(text)
    assert clip_bpe._clean_text(text) == jax_clip_bpe._clean_text(text)


def test_scanner_classes_equal_regex_on_every_assigned_code_point():
    """One code point at a time, in a context that shows its class: a letter
    run, a number, a run of the rest, or skipped (\\s, and U+0345)."""
    differ = []
    for cp in range(sys.maxunicode + 1):
        ch = chr(cp)
        if unicodedata.category(ch) in ("Cn", "Cs"):
            continue
        text = f"a{ch}{ch}1"
        if clip_bpe.words(text) != PATTERN.findall(text):
            differ.append(hex(cp))
    assert differ == []


def test_bpe_ids_equal_jax_on_tiny_and_learned_merges():
    learned = []  # a few hundred merges, learned greedily from the corpus and the test words
    words = [w for text in CORPUS + [" ".join(WORDS)] * 3 for w in text.lower().split()]
    seqs = [list(w) for w in words if w]
    for _ in range(300):
        counts = {}
        for s in seqs:
            for a, b in zip(s, s[1:]):
                counts[(a, b)] = counts.get((a, b), 0) + 1
        if not counts:
            break
        best = max(sorted(counts), key=counts.get)
        learned.append(best)
        for s in seqs:
            i = 0
            while i < len(s) - 1:
                if (s[i], s[i + 1]) == best:
                    s[i : i + 2] = [s[i] + s[i + 1]]
                i += 1
    for merges in (tiny_clip_merges(), learned):
        ours, theirs = CLIPTokenizer(merges=merges), JaxCLIPTokenizer(merges=merges)
        np.testing.assert_array_equal(ours(CORPUS), theirs(CORPUS))
        np.testing.assert_array_equal(ours(CORPUS, context_length=8), theirs(CORPUS, context_length=8))


def test_bpe_file_read_equals_jax(tmp_path):
    """A merges file (the public format: a header line, then one merge a line) reads to the same ids."""
    path = tmp_path / "merges.txt"
    path.write_text("#version: test\n" + "\n".join(" ".join(m) for m in tiny_clip_merges()) + "\n")
    ours, theirs = CLIPTokenizer(bpe_path=str(path)), JaxCLIPTokenizer(bpe_path=str(path))
    np.testing.assert_array_equal(ours(CORPUS), theirs(CORPUS))
