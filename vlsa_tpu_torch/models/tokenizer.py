"""The tokenizer facade in pure Python (counterpart of
vlsa_tpu/models/tokenizer.py): `Tokenizer(root, name, api)` with api CLIP,
HF or CONCH gives token ids, the token count without <sot>/<eot>, and
optionally the "raw tokens" (<sot> and the trailing padding stripped).

CLIP: OpenAI's BPE of the bundled `bpe_simple_vocab_16e6.txt.gz`
(models/clip_bpe.py), 77 ids zero-padded, an overlong text refused.

HF: the tokenizer directory `root/name` (`vocab.json`, `merges.txt`,
`tokenizer_config.json` naming a CLIP tokenizer class, optionally
`special_tokens_map.json`: what models/hf_export.py writes and an HF CLIP
model directory holds), as transformers' CLIPTokenizerFast runs it in
vlsa_tpu: NFC, whitespace runs to one space, each character lowercased on
its own (no final-sigma rule), the special tokens split off the normalised
text, the other words split as CLIP's (case-sensitive) and BPE-merged with
`</w>`; `<|startoftext|> ... <|endoftext|>`, no html unescaping and no
truncation; a batch padded to its longest text with the directory's pad
token.

CONCH: the bundled `conch_byte_level_bpe_uncased.json`, which vlsa_tpu
drives through `transformers.PreTrainedTokenizerFast`:

  * added special tokens are split off the raw text first;
  * normaliser: NFD, strip combining marks, then each character lowercased
    on its own, as the `tokenizers` Lowercase normaliser does (str.lower()
    of the whole text would turn a word-final capital sigma into "ς", the
    normaliser into "σ");
  * ByteLevel pre-tokeniser without a prefix space, splitting with GPT-2's
    pattern rewritten for `re` (`\\p{L}` -> `[^\\W\\d_]`, `\\p{N}` -> `\\d`,
    `[^\\s\\p{L}\\p{N}]` -> `(?:[^\\s\\w]|_)`).  That rewrite splits some text
    otherwise than the exact classes (`\\w` takes "²", category No, as a
    letter: "m²" stays one word), but byte-level BPE marks no word end, so
    the ids come out the same (tests/test_torch_tokenizer.py holds them
    against transformers on such text);
  * bytes mapped to GPT-2's printable unicode alphabet, then BPE by merge rank;
  * template `<start_of_text> ... <end_of_text>`, truncation to 127 ids,
    padding to 127 and one appended pad that makes room for the `<cls>` slot.
"""
from __future__ import annotations

import json
import os
import re
import unicodedata
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from .clip_bpe import (CONTEXT_LENGTH, N_MERGES, WHITESPACE_RUN, ClipBPETokenizer,
                       bpe_merge, bytes_to_unicode, clip_tokenize, split_pattern)

ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "assets")
CONCH_TOKENIZER_JSON = os.path.join(ASSET_DIR, "tokenizers",
                                    "conch_byte_level_bpe_uncased.json")

_SPLIT = re.compile(
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?[^\W\d_]+| ?\d+| ?(?:[^\s\w]|_)+|\s+(?!\S)|\s+""")

CONCH_MAX_LENGTH = 127  # ids per text before the appended <cls> slot


def lowercase(text: str) -> str:
    """Each character lowercased on its own (the `tokenizers` Lowercase
    normaliser)."""
    return "".join(ch.lower() for ch in text)


def normalize(text: str) -> str:
    """NFD, drop combining marks (Unicode category M*), lowercase."""
    text = unicodedata.normalize("NFD", text)
    return lowercase("".join(ch for ch in text if not unicodedata.category(ch).startswith("M")))


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
        ids = self._cache.get(word)
        if ids is None:
            ids = self._cache[word] = [self.vocab[p] for p in bpe_merge(tuple(word), self.ranks)]
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



_HF_FILES = ("vocab.json", "merges.txt", "tokenizer_config.json")
_HF_CLASSES = ("CLIPTokenizer", "CLIPTokenizerFast")
# CLIPTokenizer's defaults, where the directory names no such token
_HF_SPECIAL_DEFAULTS = {"bos_token": "<|startoftext|>", "eos_token": "<|endoftext|>",
                        "pad_token": "<|endoftext|>", "unk_token": "<|endoftext|>"}


def _token_text(value) -> str:
    return value["content"] if isinstance(value, dict) else value


class HFClipTokenizer:
    """The HF api's tokenizer of an HF CLIP tokenizer directory (see the
    module's docstring).  The special tokens are those of
    `special_tokens_map.json`, else of `tokenizer_config.json`, else
    CLIPTokenizer's defaults, as transformers resolves them; the merges
    the file's first 48,894, as CLIPTokenizer reads them."""

    def __init__(self, path: str):
        missing = [f for f in _HF_FILES if not os.path.isfile(os.path.join(path, f))]
        if missing:
            raise ValueError(f"HF tokenizer directory {path!r} lacks {missing}: this package "
                             f"reads a CLIP tokenizer's {list(_HF_FILES)}")
        with open(os.path.join(path, "tokenizer_config.json"), encoding="utf-8") as f:
            config = json.load(f)
        if config.get("tokenizer_class") not in _HF_CLASSES:
            raise ValueError(f"HF tokenizer directory {path!r}: tokenizer_class "
                             f"{config.get('tokenizer_class')!r}, this package reads "
                             f"{list(_HF_CLASSES)} only")
        special = dict(_HF_SPECIAL_DEFAULTS)
        special.update({k: _token_text(config[k]) for k in special if config.get(k)})
        special_map = os.path.join(path, "special_tokens_map.json")
        if os.path.isfile(special_map):
            with open(special_map, encoding="utf-8") as f:
                special.update({k: _token_text(v) for k, v in json.load(f).items()
                                if k in special and v})
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            self.vocab: Dict[str, int] = json.load(f)
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            merges = f.read().strip().split("\n")[1:N_MERGES + 1]
        self.ranks = {tuple(m.split()): i for i, m in enumerate(merges)}
        unknown = sorted({t for t in special.values() if t not in self.vocab})
        if unknown:
            raise ValueError(f"HF tokenizer directory {path!r}: special tokens {unknown} are "
                             f"not in vocab.json")
        self.special_ids = {t: self.vocab[t] for t in special.values()}
        self.ids = {k[:-len("_token")]: self.vocab[t] for k, t in special.items()}
        self._special_split = re.compile(
            "(" + "|".join(re.escape(t) for t in
                           sorted(self.special_ids, key=len, reverse=True)) + ")")
        self.byte_map = bytes_to_unicode()
        self.pat = split_pattern(case_insensitive=False)
        self._cache: Dict[str, List[int]] = {}

    def _bpe(self, word: str) -> List[int]:
        ids = self._cache.get(word)
        if ids is None:
            merged = bpe_merge(tuple(word[:-1]) + (word[-1] + "</w>",), self.ranks)
            ids = self._cache[word] = [self.vocab.get(t, self.ids["unk"]) for t in merged]
        return ids

    def encode(self, text: str) -> List[int]:
        """Token ids of `text`, without the start/end template."""
        text = lowercase(WHITESPACE_RUN.sub(" ", unicodedata.normalize("NFC", text)))
        ids: List[int] = []
        for piece in self._special_split.split(text):
            if piece in self.special_ids:
                ids.append(self.special_ids[piece])
                continue
            for word in self.pat.findall(piece):
                ids.extend(self._bpe("".join(self.byte_map[b] for b in word.encode("utf-8"))))
        return ids

    def __call__(self, texts: List[str]) -> np.ndarray:
        """[B, longest] int64: <|startoftext|> ids <|endoftext|>, padded."""
        rows = [[self.ids["bos"]] + self.encode(t) + [self.ids["eos"]] for t in texts]
        out = np.full((len(rows), max(map(len, rows))), self.ids["pad"], np.int64)
        for i, r in enumerate(rows):
            out[i, :len(r)] = r
        return out


class Tokenizer:
    """api in {"CLIP", "HF", "CONCH"}; `root`/`name`: the HF api's tokenizer
    directory (`root/name`); `context_length`: the CLIP api's."""

    def __init__(self, root: Optional[str] = None, name: Optional[str] = None,
                 api: str = "CONCH", context_length: int = CONTEXT_LENGTH):
        self.api = api
        self.context_length = context_length
        if api == "CLIP":
            self.tokenizer = ClipBPETokenizer()
            self.pad_token_id, self.bos_token_id, self.eos_token_id = (
                0, self.tokenizer.sot_token, self.tokenizer.eot_token)
        elif api == "HF":
            if not (root or name):
                raise ValueError("the HF api needs a tokenizer directory (root/name)")
            path = os.path.join(root, name) if root and name else (root or name)
            self.tokenizer = HFClipTokenizer(path)
            self.pad_token_id, self.bos_token_id, self.eos_token_id = (
                self.tokenizer.ids[k] for k in ("pad", "bos", "eos"))
        elif api == "CONCH":
            self.tokenizer = ByteLevelBPE(CONCH_TOKENIZER_JSON)
            self.pad_token_id = self.tokenizer.special["<pad>"]
            self.bos_token_id = self.tokenizer.special["<start_of_text>"]
            self.eos_token_id = self.tokenizer.special["<end_of_text>"]
        else:
            raise ValueError(f"Got an invalid api ({api}).")

    def tokenize(self, texts: List[str]) -> np.ndarray:
        """The api's full ids: CLIP [B, 77]; HF [B, longest]; CONCH [B, 128]
        (127 template ids, truncated, then padded, plus one appended pad for
        the <cls> slot)."""
        if self.api == "CLIP":
            return clip_tokenize(self.tokenizer, texts, context_length=self.context_length)
        if self.api == "HF":
            return self.tokenizer(texts)
        out = np.full((len(texts), CONCH_MAX_LENGTH + 1), self.pad_token_id, np.int64)
        for i, text in enumerate(texts):
            body = self.tokenizer.encode(text)[:CONCH_MAX_LENGTH - 2]
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
