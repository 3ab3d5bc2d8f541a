"""Write an HF CLIP tokenizer directory from the bundled BPE asset
(counterpart of vlsa_tpu/models/hf_export.py, the same four files byte for
byte): `vocab.json`, `merges.txt`, `tokenizer_config.json` and
`special_tokens_map.json`, which the `HF` api's tokenizer
(models/tokenizer.py) reads, as transformers' AutoTokenizer does in
vlsa_tpu, with no network access.
"""
from __future__ import annotations

import json
import os

from .clip_bpe import DEFAULT_BPE_PATH, ClipBPETokenizer, read_merges

SPECIAL_TOKENS = {"bos_token": "<|startoftext|>", "eos_token": "<|endoftext|>",
                  "pad_token": "<|endoftext|>", "unk_token": "<|endoftext|>"}


def export_hf_clip_tokenizer(dst_dir: str, bpe_path: str = DEFAULT_BPE_PATH) -> str:
    os.makedirs(dst_dir, exist_ok=True)
    with open(os.path.join(dst_dir, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(ClipBPETokenizer(bpe_path).encoder, f, ensure_ascii=False)
    with open(os.path.join(dst_dir, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
        f.write("\n".join(read_merges(bpe_path)) + "\n")
    with open(os.path.join(dst_dir, "tokenizer_config.json"), "w", encoding="utf-8") as f:
        json.dump({"tokenizer_class": "CLIPTokenizer", "model_max_length": 77,
                   **SPECIAL_TOKENS}, f)
    with open(os.path.join(dst_dir, "special_tokens_map.json"), "w", encoding="utf-8") as f:
        json.dump(SPECIAL_TOKENS, f)
    return dst_dir
