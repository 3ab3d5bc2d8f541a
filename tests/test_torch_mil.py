"""VLFAN, the PromptAdapter heads and the prompt learners of the port against
vlsa_tpu's, with vlsa_tpu's initial parameters bridged into the port.

Everything runs in f32 on both sides; tolerance 1e-5 (max|a-b| / max|b|),
summation order apart."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlsa_tpu.models.mil import VLFAN as JaxVLFAN
from vlsa_tpu.models.prompt_build import build_prompt_learner as jax_build_prompt_learner
from vlsa_tpu.models.prompt_learners import PromptAdapter as JaxPromptAdapter
from vlsa_tpu.models.tokenizer import Tokenizer as JaxTokenizer
from vlsa_tpu_torch.models.mil import VLFAN
from vlsa_tpu_torch.models.prompt_build import build_prompt_learner
from vlsa_tpu_torch.models.prompt_learners import PromptAdapter
from vlsa_tpu_torch.models.tokenizer import Tokenizer
from vlsa_tpu_torch.utils.weights import state_dict_from_jax

C = 64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _params(module, *args, **kwargs):
    params = module.init(jax.random.PRNGKey(0), *args, **kwargs).get("params", {})
    return jax.tree.map(np.asarray, params)


def _load(module, params):
    module.load_state_dict(state_dict_from_jax(params), strict=True)
    return module.eval()


def _bags(seed=0, lengths=(96, 61, 0)):
    rng = np.random.default_rng(seed)
    x = np.zeros((len(lengths), max(lengths), C), np.float32)
    mask = np.zeros(x.shape[:2], bool)
    for j, n in enumerate(lengths):
        x[j, :n] = rng.normal(size=(n, C))
        mask[j, :n] = True
    return x, mask


VLFAN_CASES = {
    "param_gated_max_featproj": dict(query="Parameter", num_query=5, gated_query=True,
                                     query_pooling="max", use_feat_proj=True),
    "param_weight_identity": dict(query="Parameter", num_query=7, query_pooling="weight",
                                  use_feat_proj=False, pred_head="Identity"),
    "text_mean": dict(query="Text", num_query=6, query_pooling="mean",
                      use_feat_proj=False),
}


@pytest.mark.parametrize("case", list(VLFAN_CASES))
def test_vlfan_matches(case):
    kw = VLFAN_CASES[case]
    x, mask = _bags()
    query = None
    if kw["query"] == "Text":
        query = np.random.default_rng(1).normal(size=(kw["num_query"], C)).astype(np.float32)
    ref = JaxVLFAN(dim_in=C, **kw)
    jq = None if query is None else jnp.asarray(query)
    params = _params(ref, jnp.asarray(x), jnp.asarray(mask), query=jq)
    want = ref.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask), query=jq)
    port = _load(VLFAN(dim_in=C, **kw), params)
    tq = None if query is None else torch.from_numpy(query)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(mask), query=tq)
        assert _rel(got.numpy(), want) < 1e-5
        for last_div in (True, False):
            jl = ref.apply({"params": params}, query=jq, last_div=last_div,
                           method=ref.query_div_loss)
            assert abs(float(port.query_div_loss(tq, last_div=last_div)) - float(jl)) < 1e-6


@pytest.mark.parametrize("method", ["default", "FC", "Adapter", "TaskRes"])
@pytest.mark.parametrize("with_neg", [False, True])
def test_prompt_adapter_matches(method, with_neg):
    rng = np.random.default_rng(2)
    features = rng.normal(size=(6, C)).astype(np.float32)
    neg = rng.normal(size=(1, C)).astype(np.float32) if with_neg else None
    ref = JaxPromptAdapter(method=method, num_prompts=6, prompt_features=features,
                           neg_prompt_features=neg)
    params = _params(ref)
    want = ref.apply({"params": params})
    port = _load(PromptAdapter(features, method=method, num_prompts=6,
                               neg_prompt_features=neg), params)
    with torch.no_grad():
        got = port()
    assert got.shape == want.shape
    assert _rel(got.numpy(), want) < 1e-5


@pytest.mark.parametrize("method", ["plain", "rank"])
@pytest.mark.parametrize("position", ["tail", "front", "middle"])
def test_prompt_learner_matches(method, position):
    table = np.random.default_rng(3).normal(0, 0.02, size=(32007, C)).astype(np.float32)
    cfg = {"num_ranks": 8, "num_base_ranks": 4, "num_tokens_per_rank": 4,
           "num_context_tokens": 8, "rank_tokens_position": position,
           "init_prompt_path": "vlsa_tpu/assets/tools/survival_prompts.json"}
    jax_cfg = dict(cfg, init_prompt_path=os.path.join(REPO, cfg["init_prompt_path"]))
    ref = jax_build_prompt_learner(method, jax_cfg, JaxTokenizer(api="CONCH"), table, 127, C)
    port = build_prompt_learner(method, cfg, Tokenizer(), table, 127, C)  # its own copy
    np.testing.assert_array_equal(port.pseudo_sentence_tokens.numpy(),
                                  ref.pseudo_sentence_tokens)
    np.testing.assert_array_equal(port.sentence_template.numpy(), ref.sentence_template)
    params = _params(ref)
    want = ref.apply({"params": params})
    _load(port, params)
    with torch.no_grad():
        got = port()
    assert got.shape == want.shape == (8, 127, C)
    assert _rel(got.numpy(), want) < 1e-6
