"""The port's pure-Python CONCH tokenizer gives the ids of the JAX package's
transformers-backed one, exactly: raw and full ids, and token counts.  The
"unicode" texts are tests/test_torch_clip_text.py's, where CLIP's split
needs the exact Unicode classes; the CONCH split's `re` rewrite gives the
same ids on them (byte-level BPE marks no word end), and "ΟΔΟΣ" holds the
normaliser's per-character lowercase (no final sigma)."""
import json
import os

import numpy as np
import pytest

from test_torch_clip_text import OVERFLOW, UNICODE_CASES
from vlsa_tpu.models.tokenizer import Tokenizer as JaxTokenizer
from vlsa_tpu_torch.models.tokenizer import Tokenizer

ASSETS = os.path.join(os.path.dirname(__file__), "..", "vlsa_tpu_torch", "assets", "tools")


def _prototype_texts():
    with open(os.path.join(ASSETS, "survival_text_prototypes.json")) as f:
        return [t for texts in json.load(f).values() for t in texts]


def _prompt_texts():
    with open(os.path.join(ASSETS, "survival_prompts.json")) as f:
        prompts = json.load(f)
    names = [n for ns in prompts["class_names"].values() for n in ns]
    filled = [c.replace("CLASSNAME", n) for c in prompts["context_templates"] for n in names]
    return prompts["context_templates"] + names + filled


CRAFTED = ["X.", "Café naïve résumé, ÀÉÎÕÜ ñ ß œ", "H&E stained, grade_3 __init__",
           "Ki-67 1,234.5 40x 0.25mm", "  leading spaces\tand\nnewlines  ",
           "it's we're they've I'm you'll he'd IT'S", "<|person|> said <|date|>x",
           "²½ ① Ⅳ", "a" * 300, ""]


@pytest.fixture(scope="module")
def tokenizers():
    return Tokenizer(), JaxTokenizer(api="CONCH")


@pytest.mark.parametrize("texts", [_prototype_texts(), _prompt_texts(), CRAFTED,
                                   UNICODE_CASES + [OVERFLOW]],
                         ids=["prototypes", "prompts", "crafted", "unicode"])
def test_ids_match_transformers(tokenizers, texts):
    port, ref = tokenizers
    for raw in (True, False):
        ids, cnt = port(texts, return_raw_tokens=raw)
        ref_ids, ref_cnt = ref(texts, return_raw_tokens=raw)
        np.testing.assert_array_equal(ids, ref_ids)
        np.testing.assert_array_equal(cnt, ref_cnt)
        for t in texts:  # the single-string surface
            ids1, cnt1 = port(t, return_raw_tokens=raw)
            ref1, rcnt1 = ref(t, return_raw_tokens=raw)
            np.testing.assert_array_equal(ids1, ref1)
            assert cnt1 == rcnt1


def test_special_ids_and_template(tokenizers):
    port, ref = tokenizers
    assert (port.pad_token_id, port.bos_token_id, port.eos_token_id) == \
        (ref.pad_token_id, ref.bos_token_id, ref.eos_token_id)
    full = port(["X."], return_raw_tokens=False, return_num_tokens=False)
    assert full.shape == (1, 128)
    assert full[0, 0] == port.bos_token_id and full[0, 3] == port.eos_token_id
    assert (full[0, 4:] == port.pad_token_id).all()
