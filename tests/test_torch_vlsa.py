"""The whole small flagship VLSA in both packages: vlsa_tpu builds it and
initialises its parameters, the bridge (vlsa_tpu_torch.utils.weights) carries
them into the port, and both score the same ragged bags.

The flagship settings are those of __graft_entry__._build_flagship with a
small tower (width 64, 4 heads, 2 layers, output 512): CoOp rank prompts
(12 ranks from 4 base ranks, 4 tokens per rank, 8 context tokens, rank
tokens at the tail), VLFAN with dim_in 512, no feature projecter, 12 TaskRes
text queries from tcga_blca_0 and mean query pooling.

Tolerances (max|a-b| / max|b|): text features and queries 1e-5 (f32 on both
sides); logits 1e-4.  The JAX model on the CPU takes its plain co-attention,
which normalises bf16 rows in bf16; its TPU kernel and the port compute in
f32 on the stored values, so the JAX side gets the bf16 bags as f32 values.
"""
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from vlsa_tpu.data.pipeline import feats_inv_norms, quantize_feats_int8
from vlsa_tpu.models.vlsa_build import build_vlsa as jax_build_vlsa
from vlsa_tpu_torch.models.vlsa_build import build_vlsa
from vlsa_tpu_torch.utils.weights import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOWER = {"dtype": "float32", "width": 64, "heads": 4, "layers": 2, "output_dim": 512}


def flagship_cfgs(asset_root: str):
    image = {"name": "VLFAN", "dim_in": 512, "dim_hid": 256, "use_feat_proj": False,
             "drop_rate": 0.25, "pred_head": "default", "query": "Text", "num_query": 12,
             "query_pooling": "mean", "gated_query": False,
             "query_text_method": "TaskRes", "query_text_res_ratio": 0.5,
             "query_text_load_path": asset_root + "/tools/survival_text_prototypes.json",
             "query_text_load_idx": "tcga_blca_0"}
    prompt = {"name": "CoOp", "method": "rank", "pretrained": False, "num_ranks": 12,
              "num_base_ranks": 4, "num_tokens_per_rank": 4, "num_context_tokens": 8,
              "rank_tokens_position": "tail",
              "init_prompt_path": asset_root + "/tools/survival_prompts.json",
              "init_prompt_context_idx": 0, "init_prompt_rank_idx": 0,
              "rank_specific_context": False}
    return {"name": "mahmoodlab/conch", "frozen": True}, image, prompt


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.fixture(scope="module")
def pair():
    text, image, prompt = flagship_cfgs(os.path.join(REPO, "vlsa_tpu", "assets"))
    jmodel, jparams, _tok = jax_build_vlsa(
        vlsa_api="CONCH", text_encoder_cfg=text, image_encoder_cfg=image,
        prompt_learner_cfg=prompt, rng=jax.random.PRNGKey(0), tower_overrides=TOWER)
    jparams = jax.tree.map(np.asarray, dict(jparams))
    sd = state_dict_from_jax(jparams)
    text, image, prompt = flagship_cfgs("vlsa_tpu/assets")  # the port's own copies
    model, _ = build_vlsa(text, image, prompt, tower_overrides=TOWER, device="cpu",
                          state_dict=sd)
    return jmodel, jparams, model, sd


def test_bridge_maps_every_leaf_once(pair):
    _jm, jparams, model, sd = pair
    assert len(sd) == len(jax.tree.leaves(jparams))
    assert set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k].to(v.dtype)), k


def test_text_precompute_matches(pair):
    jmodel, jparams, model, _sd = pair
    assert model.text_trim_len == jmodel.text_trim_len
    jtext, jquery = jmodel.apply({"params": jparams}, method=jmodel.text_precompute)
    with torch.no_grad():
        text, query = model.text_precompute()
    assert text.shape == (12, 512) and query.shape == (12, 512)
    assert _rel(text.numpy(), jtext) < 1e-5
    assert _rel(query.numpy(), jquery) < 1e-5


def _bags(seed=0, lengths=(300, 217, 123), D=512):
    rng = np.random.default_rng(seed)
    x = np.zeros((len(lengths), max(lengths), D), np.float32)
    mask = np.zeros(x.shape[:2], bool)
    for j, n in enumerate(lengths):
        x[j, :n] = rng.normal(size=(n, D))
        mask[j, :n] = True
    return x, mask


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
def test_logits_match(pair, storage):
    jmodel, jparams, model, _sd = pair
    x, mask = _bags()
    jkw, tkw = {}, {}
    if storage == "int8":
        xq, scale = quantize_feats_int8(x)
        inv = feats_inv_norms(xq)
        jx, tx = jnp.asarray(xq), torch.from_numpy(xq)
        jkw = {"x_scale": jnp.asarray(scale), "x_inv": jnp.asarray(inv)}
        tkw = {"x_scale": torch.from_numpy(scale), "x_inv": torch.from_numpy(inv)}
    elif storage == "bfloat16":
        stored = x.astype(ml_dtypes.bfloat16).astype(np.float32)
        jx, tx = jnp.asarray(stored), torch.from_numpy(x).to(torch.bfloat16)
    else:
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    want, _img, _txt = jmodel.apply({"params": jparams}, jx, jnp.asarray(mask), **jkw)
    with torch.no_grad():
        got, _img, _txt = model(tx, torch.from_numpy(mask), **tkw)
    assert got.shape == (3, 12) and torch.isfinite(got).all()
    assert _rel(got.numpy(), want) < 1e-4
