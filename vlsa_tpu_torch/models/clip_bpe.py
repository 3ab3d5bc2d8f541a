"""OpenAI CLIP's byte-pair encoding tokenizer in plain Python (counterpart of
vlsa_tpu/models/clip_bpe.py): html-unescape twice, whitespace collapsed,
lowercase, the text split into words, each word's UTF-8 bytes mapped to
printable characters, its last one marked `</w>`, merged by the ranks of
the bundled `bpe_simple_vocab_16e6.txt.gz`; `<|startoftext|>` ...
`<|endoftext|>` in a 77-token context.

vlsa_tpu splits with the `regex` package's pattern

    <\\|startoftext\\|>|<\\|endoftext\\|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+

under IGNORECASE.  The card's machine has no `regex`, and `re`'s `\\w`
and `\\d` are not those classes (`\\w` takes "²" and "½", category No, as
word characters, so "mg/m²" would give the word "m²" where `regex` gives
"m", "²", and with `</w>` other ids).  `unicode_class` builds the classes
from the Unicode database instead: `\\p{L}` every code point of category
L*, `\\p{N}` of N*, `\\s` the White_Space property (which `regex` and
Oniguruma use; `re`'s `\\s` also takes U+001C..U+001F).  IGNORECASE then
changes one thing on lowercased text: U+0345, a combining mark that
case-folds to a Greek iota, is matched by no class, so `regex` drops it,
and so does this split.  Checked on every code point against `regex`
(and, for `split_pattern(case_insensitive=False)`, against the HF
tokenizer's Oniguruma split): the splits agree but on code points that
this Python's Unicode database (15.0 on Python 3.12) has not assigned and
a later one has.
"""
from __future__ import annotations

import gzip
import html
import os
import re
import unicodedata
from functools import lru_cache
from typing import Dict, List, Tuple, Union

import numpy as np

from ..data.io import ASSET_DIR

DEFAULT_BPE_PATH = os.path.join(ASSET_DIR, "tokenizers", "bpe_simple_vocab_16e6.txt.gz")
N_MERGES = 49152 - 256 - 2  # the merges CLIP's vocabulary takes from the file
CONTEXT_LENGTH = 77

# the White_Space property: `\s` of `regex` and of Oniguruma
WHITESPACE = "\t\n\x0b\x0c\r \x85\xa0\u1680\u2000-\u200a\u2028\u2029\u202f\u205f\u3000"
WHITESPACE_RUN = re.compile(f"[{WHITESPACE}]+")


@lru_cache()
def unicode_class(major: str) -> str:
    """The body of a `re` character class of every code point whose Unicode
    category starts with `major` ("L", "N"), as ranges."""
    ranges, start = [], None
    for cp in range(0x110001):
        inside = cp <= 0x10FFFF and unicodedata.category(chr(cp))[0] == major
        if inside and start is None:
            start = cp
        elif not inside and start is not None:
            ranges.append((start, cp - 1))
            start = None
    return "".join(re.escape(chr(a)) if a == b else f"{re.escape(chr(a))}-{re.escape(chr(b))}"
                   for a, b in ranges)


@lru_cache()
def split_pattern(case_insensitive: bool = True) -> "re.Pattern":
    """CLIP's word split: with `case_insensitive`, that of vlsa_tpu's
    `regex` pattern (special tokens and contractions first); without, the HF
    tokenizer's (contractions, then the same classes, case-sensitive)."""
    letters, numbers = unicode_class("L"), unicode_class("N")
    others = f"[^{WHITESPACE}{letters}{numbers}]+"
    if case_insensitive:
        # under IGNORECASE `regex` matches U+0345 by no class: it is dropped
        others = f"[^{WHITESPACE}{letters}{numbers}\\u0345]+"
        head = r"(?i:<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d)"
    else:
        head = r"'s|'t|'re|'ve|'m|'ll|'d"
    return re.compile(f"{head}|[{letters}]+|[{numbers}]|{others}")


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible map of the 256 byte values to printable characters."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def bpe_merge(word: Tuple[str, ...], ranks: Dict[Tuple[str, str], int]) -> Tuple[str, ...]:
    """Merge the pair of lowest rank, every occurrence left to right, until no
    pair has a rank."""
    while len(word) > 1:
        pairs = set(zip(word, word[1:]))
        bigram = min(pairs, key=lambda p: ranks.get(p, float("inf")))
        if bigram not in ranks:
            break
        first, second = bigram
        merged, i = [], 0
        while i < len(word):
            try:
                j = word.index(first, i)
            except ValueError:
                merged.extend(word[i:])
                break
            merged.extend(word[i:j])
            i = j
            if i < len(word) - 1 and word[i + 1] == second:
                merged.append(first + second)
                i += 2
            else:
                merged.append(word[i])
                i += 1
        word = tuple(merged)
    return word


def read_merges(bpe_path: str = DEFAULT_BPE_PATH) -> List[str]:
    """CLIP's merge lines of the gzipped BPE file (its header line dropped)."""
    with gzip.open(bpe_path) as f:
        lines = f.read().decode("utf-8").split("\n")
    return lines[1:N_MERGES + 1]


def basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


def whitespace_clean(text: str) -> str:
    return WHITESPACE_RUN.sub(" ", text).strip()


class ClipBPETokenizer:
    def __init__(self, bpe_path: str = DEFAULT_BPE_PATH):
        self.byte_encoder = bytes_to_unicode()
        merges = [tuple(m.split()) for m in read_merges(bpe_path)]
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {"<|startoftext|>": "<|startoftext|>", "<|endoftext|>": "<|endoftext|>"}
        self.pat = split_pattern(case_insensitive=True)
        self.sot_token = self.encoder["<|startoftext|>"]
        self.eot_token = self.encoder["<|endoftext|>"]

    def bpe(self, token: str) -> str:
        """The word's merged symbols, space-separated."""
        if token in self.cache:
            return self.cache[token]
        word = " ".join(bpe_merge(tuple(token[:-1]) + (token[-1] + "</w>",), self.bpe_ranks))
        self.cache[token] = word
        return word

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in self.pat.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids


def clip_tokenize(tokenizer: ClipBPETokenizer, texts: Union[str, List[str]],
                  context_length: int = CONTEXT_LENGTH, truncate: bool = False) -> np.ndarray:
    """[B, context_length] int64 ids, zero-padded; a text longer than the
    context raises, or with `truncate` keeps its first ids and ends in
    <|endoftext|>."""
    if isinstance(texts, str):
        texts = [texts]
    sot, eot = tokenizer.sot_token, tokenizer.eot_token
    result = np.zeros((len(texts), context_length), dtype=np.int64)
    for i, text in enumerate(texts):
        tokens = [sot] + tokenizer.encode(text) + [eot]
        if len(tokens) > context_length:
            if not truncate:
                raise RuntimeError(f"Input {text} is too long for context length "
                                   f"{context_length}")
            tokens = tokens[:context_length]
            tokens[-1] = eot
        result[i, :len(tokens)] = tokens
    return result
