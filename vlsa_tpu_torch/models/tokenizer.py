"""CONCH tokenizer in pure Python (counterpart of vlsa_tpu/models/tokenizer.py).

The JAX package drives the bundled `conch_byte_level_bpe_uncased.json`
through `transformers.PreTrainedTokenizerFast`.  This module reads the same
file and reproduces that pipeline with the standard library alone:

  * added special tokens are split off the raw text first;
  * normaliser: NFD, strip combining marks, lowercase;
  * ByteLevel pre-tokeniser without a prefix space, splitting with GPT-2's
    pattern rewritten for `re` (`\\p{L}` -> `[^\\W\\d_]`, `\\p{N}` -> `\\d`,
    `[^\\s\\p{L}\\p{N}]` -> `(?:[^\\s\\w]|_)`);
  * bytes mapped to GPT-2's printable unicode alphabet, then BPE by merge rank;
  * template `<start_of_text> ... <end_of_text>`, truncation to 127 ids,
    padding to 127 and one appended pad that makes room for the `<cls>` slot.
"""
from __future__ import annotations

import json
import os
import re
import unicodedata
from typing import Dict, List, Tuple, Union

import numpy as np

ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "assets")
CONCH_TOKENIZER_JSON = os.path.join(ASSET_DIR, "tokenizers",
                                    "conch_byte_level_bpe_uncased.json")

_SPLIT = re.compile(
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?[^\W\d_]+| ?\d+| ?(?:[^\s\w]|_)+|\s+(?!\S)|\s+""")

CONCH_MAX_LENGTH = 127  # ids per text before the appended <cls> slot


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


def normalize(text: str) -> str:
    """NFD, drop combining marks (Unicode category M*), lowercase."""
    text = unicodedata.normalize("NFD", text)
    text = "".join(ch for ch in text if not unicodedata.category(ch).startswith("M"))
    return text.lower()


class ByteLevelBPE:
    """The byte-level BPE model of a `tokenizers` JSON file.

    The file asks its ByteLevel pre-tokeniser for `add_prefix_space`, but
    transformers' PreTrainedTokenizerFast, through which the reference reads
    it, rebuilds the pre-tokeniser with its own default, False: "The"
    encodes as `the`, not `Ġthe`.  The ids here follow that reference."""

    def __init__(self, path: str = CONCH_TOKENIZER_JSON):
        with open(path, "r", encoding="utf-8") as f:
            spec = json.load(f)
        model = spec["model"]
        if model["type"] != "BPE":
            raise ValueError(f"expected a BPE model, got {model['type']}")
        self.vocab: Dict[str, int] = model["vocab"]
        merges = [tuple(m.split(" ")) if isinstance(m, str) else tuple(m)
                  for m in model["merges"]]
        self.ranks: Dict[Tuple[str, str], int] = {m: i for i, m in enumerate(merges)}
        self.special: Dict[str, int] = {t["content"]: t["id"] for t in spec["added_tokens"]}
        self._special_split = re.compile(
            "(" + "|".join(re.escape(t) for t in
                           sorted(self.special, key=len, reverse=True)) + ")")
        self.byte_map = bytes_to_unicode()
        self._cache: Dict[str, List[int]] = {}

    def _bpe(self, word: str) -> List[int]:
        cached = self._cache.get(word)
        if cached is not None:
            return cached
        parts = list(word)
        while len(parts) > 1:
            best, best_rank = None, None
            for pair in zip(parts, parts[1:]):
                r = self.ranks.get(pair)
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = pair, r
            if best is None:
                break
            merged, i = [], 0
            while i < len(parts):
                if i + 1 < len(parts) and (parts[i], parts[i + 1]) == best:
                    merged.append(parts[i] + parts[i + 1])
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        ids = [self.vocab[p] for p in parts]
        self._cache[word] = ids
        return ids

    def encode(self, text: str) -> List[int]:
        """Token ids of `text`, without the start/end template."""
        ids: List[int] = []
        for piece in self._special_split.split(text):
            if not piece:
                continue
            if piece in self.special:
                ids.append(self.special[piece])
                continue
            for word in _SPLIT.findall(normalize(piece)):
                mapped = "".join(self.byte_map[b] for b in word.encode("utf-8"))
                ids.extend(self._bpe(mapped))
        return ids


class Tokenizer:
    """CONCH tokenizer facade (the `api="CONCH"` surface of
    vlsa_tpu.models.tokenizer.Tokenizer)."""

    def __init__(self, path: str = CONCH_TOKENIZER_JSON):
        self.api = "CONCH"
        self.bpe = ByteLevelBPE(path)
        self.pad_token_id = self.bpe.special["<pad>"]
        self.bos_token_id = self.bpe.special["<start_of_text>"]
        self.eos_token_id = self.bpe.special["<end_of_text>"]

    def tokenize(self, texts: List[str]) -> np.ndarray:
        """[len(texts), 128] ids: 127 template ids (truncated, then padded)
        plus one appended pad for the <cls> slot."""
        out = np.full((len(texts), CONCH_MAX_LENGTH + 1), self.pad_token_id, np.int64)
        for i, text in enumerate(texts):
            body = self.bpe.encode(text)[:CONCH_MAX_LENGTH - 2]
            ids = [self.bos_token_id] + body + [self.eos_token_id]
            out[i, :len(ids)] = ids
        return out

    def __call__(self, text: Union[str, List[str]], return_raw_tokens: bool = True,
                 return_num_tokens: bool = True):
        single = isinstance(text, str)
        token_ids = self.tokenize([text] if single else list(text))
        # <sot> and <eot> are excluded from the count
        token_cnt = np.argmax((token_ids == self.eos_token_id).astype(np.int32), axis=-1) - 1
        if return_raw_tokens:
            token_ids = token_ids[:, 1:int(token_cnt.max()) + 1]
        if single:
            token_ids = token_ids[0]
            token_cnt = int(token_cnt[0])
        if return_num_tokens:
            return token_ids, token_cnt
        return token_ids
