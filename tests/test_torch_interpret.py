"""Interpretation in the port (vlsa_tpu_torch.interpret) against vlsa_tpu's
(vlsa_tpu.interpret), on the same numpy inputs and the same weights (the
port's carried over from vlsa_tpu's by utils.weights, strict loads).

Tolerances:
  - Shapley values: 1e-5 of max|phi| against vlsa_tpu (f32, summed in
    another order; the port sums in f64) and 1e-6 against a float64
    enumeration of the coalitions in the reference's order
    (ref utils/model_inference.py:23-79);
  - every array of the similarity dicts and of the cohort: 1e-5 (max|a-b| /
    max|b|), f32 on both sides with the text tower in f32; the Shapley
    importances among them 1e-5 of max|phi|;
  - the efficiency axiom: |sum phi - (v(all) - 1)| <= 1e-6 max(1, |v(all)|),
    v in float64 from the returned similarities.
"""
import csv
import itertools
import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlsa_tpu.interpret import calc_abmil_text_img_similarity as jax_calc_abmil
from vlsa_tpu.interpret import calc_text_img_similarity as jax_calc
from vlsa_tpu.interpret.cohort import interpret_cohort as jax_interpret_cohort
from vlsa_tpu.interpret.shapley import batched_shapley as jax_batched_shapley
from vlsa_tpu.interpret.shapley import evaluate_prototype_shap_imp as jax_shap
from vlsa_tpu.models.vlsa_build import build_vlsa as jax_build_vlsa
from vlsa_tpu_torch.interpret import (batched_shapley, calc_abmil_text_img_similarity,
                                      calc_text_img_similarity, evaluate_prototype_shap_imp,
                                      get_model_cfg, interpret_cohort, load_vlsa_from_run,
                                      shapley_values)
from vlsa_tpu_torch.models.vlsa_build import build_vlsa
from vlsa_tpu_torch.utils.weights import state_dict_from_jax

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_runner_e2e import make_cohort, vlsa_cfg  # noqa: E402
from test_torch_vlsa import flagship_cfgs  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOWER = {"dtype": "float32", "width": 32, "heads": 4, "layers": 2, "output_dim": 64}
D = 64
TOL = 1e-5


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def reference_shapley(sim: np.ndarray, logit_scale: float) -> np.ndarray:
    """The reference's enumeration in float64: coalition j holds prior i
    when bit i of j is set; v(empty) = 1."""
    sim = np.asarray(sim, np.float64)
    P, K = sim.shape

    def risk(members):
        z = logit_scale * sim[members].mean(0)
        p = np.exp(z - z.max())
        return float(np.sum((K - np.arange(K)) * p / p.sum()))

    V = [1.0] + [risk([i for i in range(P) if j >> i & 1]) for j in range(1, 2 ** P)]
    fac = [math.factorial(i) for i in range(P + 1)]
    W = [fac[s] * fac[P - s - 1] / fac[P] for s in range(P)]
    return np.array([sum(W[bin(j).count("1")] * (V[j + 2 ** i] - V[j])
                         for j in range(2 ** P) if not j >> i & 1) for i in range(P)])


def _sims(P, K, seed=0, B=None):
    rng = np.random.default_rng(seed + 100 * P + K)
    shape = (P, K) if B is None else (B, P, K)
    return rng.uniform(-1, 1, size=shape).astype(np.float32)


@pytest.mark.parametrize("logit_scale", [1.0, 14.3, 100.0])
@pytest.mark.parametrize("K", [4, 12])
@pytest.mark.parametrize("P", [1, 2, 7, 12])
def test_shapley_matches_jax(P, K, logit_scale):
    sim = _sims(P, K)
    got = evaluate_prototype_shap_imp(sim, logit_scale)
    want = np.asarray(jax_shap(sim, logit_scale))
    assert got.shape == (P,) and got.dtype == np.float32
    assert np.max(np.abs(got - want)) <= TOL * np.max(np.abs(want))
    if P <= 7:  # the reference's loop, in float64
        ref = reference_shapley(sim, logit_scale)
        assert np.max(np.abs(got - ref)) <= 1e-6 * np.max(np.abs(ref))


def test_batched_matches_single_and_jax():
    sims = _sims(12, 12, B=5)
    batched = batched_shapley(torch.from_numpy(sims), 14.3).numpy()
    want = np.asarray(jax_batched_shapley(jnp.asarray(sims), 14.3))
    assert batched.shape == (5, 12)
    assert np.max(np.abs(batched - want)) <= TOL * np.max(np.abs(want))
    for b in range(5):
        single = shapley_values(torch.from_numpy(sims[b]), 14.3).numpy()
        np.testing.assert_allclose(batched[b], single, rtol=0, atol=1e-7)


@pytest.mark.parametrize("P,K", [(6, 5), (12, 12)])
def test_efficiency_axiom(P, K):
    sim = _sims(P, K, seed=3)
    ls = 10.0
    shap = evaluate_prototype_shap_imp(sim, ls)
    z = ls * sim.astype(np.float64).mean(0)
    p = np.exp(z - z.max())
    v_all = float(np.sum((K - np.arange(K)) * p / p.sum()))
    assert abs(float(shap.astype(np.float64).sum()) - (v_all - 1.0)) <= 1e-6 * max(1.0, v_all)


# ------------------------------------------------------------ similarity

def _vlsa_pair(image_changes=None, prompt_changes=None, seed=0):
    """A small VLSA in both packages (tower width 32, 2 layers, D=64) with
    the same weights."""
    text, image, prompt = flagship_cfgs(os.path.join(REPO, "vlsa_tpu", "assets"))
    image = dict(image, dim_in=D, dim_hid=32, **(image_changes or {}))
    prompt = dict(prompt, num_ranks=4, num_base_ranks=2, num_tokens_per_rank=2,
                  num_context_tokens=4, **(prompt_changes or {}))
    jmodel, jparams, _tok = jax_build_vlsa(
        vlsa_api="CONCH", text_encoder_cfg=text, image_encoder_cfg=image,
        prompt_learner_cfg=prompt, rng=jax.random.PRNGKey(seed), tower_overrides=TOWER)
    jparams = jax.tree.map(np.asarray, dict(jparams))
    model, _ = build_vlsa(text, image, prompt, tower_overrides=TOWER, device="cpu",
                          state_dict=state_dict_from_jax(jparams))
    return jmodel, jparams, model


VLFAN_CASES = {
    "text": dict(query="Text", num_query=12, gated_query=False),
    "text_gated": dict(query="Text", num_query=12, gated_query=True),
    "parameter": dict(query="Parameter", num_query=6, gated_query=False),
    "parameter_gated_attention_pool": dict(query="Parameter", num_query=6, gated_query=True,
                                           query_pooling="attention"),
}


def _check_dicts(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if w is None:
            assert g is None, k
        elif k == "logit_scale":
            assert abs(g - w) <= 1e-6 * abs(w), k
        else:
            w = np.asarray(w)
            assert g.shape == w.shape, k
            assert _rel(g, w) <= TOL, (k, _rel(g, w))


@pytest.fixture(scope="module", params=sorted(VLFAN_CASES))
def vlfan_vlsa(request, tmp_path_factory):
    changes = dict(VLFAN_CASES[request.param])
    if changes["query"] == "Text" and changes["gated_query"]:
        # the gate query's sentences (`prompt_normal_tissue`), which the
        # shipped prototype file does not hold
        path = tmp_path_factory.mktemp("prompts") / "prototypes_with_negatives.json"
        src = os.path.join(REPO, "vlsa_tpu", "assets", "tools", "survival_text_prototypes.json")
        with open(src) as f:
            texts = json.load(f)
        texts["prompt_normal_tissue"] = ["normal tissue.",
                                         "a histopathology image of normal tissue."]
        with open(path, "w") as f:
            json.dump(texts, f)
        changes["query_text_load_path"] = str(path)
    return request.param, _vlsa_pair(changes)


def _bag(n=300, seed=0):
    return np.random.default_rng(seed).normal(size=(n, D)).astype(np.float32)


@pytest.mark.parametrize("axis", ["V", "L"])
def test_calc_text_img_similarity_matches_jax(vlfan_vlsa, axis):
    case, (jmodel, jparams, model) = vlfan_vlsa
    X = _bag()
    want = jax_calc(jmodel, jparams, X, axis_softmax=axis)
    got = calc_text_img_similarity(model, X, axis_softmax=axis)
    _check_dicts(got, want)
    P = 6 if case.startswith("parameter") else 12
    assert got["coattn_score"].shape == (P, 300) and got["decoupled_similarity"].shape == (P, 4)
    assert (got["attention"] is None) == case.startswith("parameter")
    np.testing.assert_allclose(got["coattn_score"].sum(-1), np.ones(P), atol=1e-5)


def test_calc_text_img_similarity_masks_padding(vlfan_vlsa):
    """A bag padded to 384 rows (garbage in the padding) gives the unpadded
    bag's attention, zero on the padding, and its similarities."""
    _case, (jmodel, jparams, model) = vlfan_vlsa
    X = _bag(300, seed=1)
    padded = np.concatenate([X, _bag(84, seed=2) * 5])[None]
    mask = np.zeros((1, 384), bool)
    mask[0, :300] = True
    got = calc_text_img_similarity(model, padded, mask=mask)
    want = jax_calc(jmodel, jparams, padded, mask=mask)
    alone = calc_text_img_similarity(model, X)
    _check_dicts(got, want)
    assert float(np.abs(got["coattn_score"][:, 300:]).max()) == 0.0
    for k in ("coattn_score", "probs", "decoupled_similarity", "shap_importance"):
        g = got[k][:, :300] if k == "coattn_score" else got[k]
        assert _rel(g, alone[k]) <= TOL, k


ABMIL_CASES = {
    "deepmil_attention": dict(name="DeepMIL", dim_hid=32, use_feat_proj=False,
                              pred_head="Adapter", mil_pooling="attention"),
    "deepmil_gated": dict(name="DeepMIL", dim_hid=32, use_feat_proj=False,
                          pred_head="Adapter", mil_pooling="gated_attention"),
    "dsmil": dict(name="DSMIL", dim_hid=32, use_feat_proj=False, num_cls=64),
}


@pytest.fixture(scope="module", params=sorted(ABMIL_CASES))
def abmil_vlsa(request):
    """tests/test_interpret.py::_small_abmil_vlsa's model (CoOp rank prompts,
    4 ranks), with each encoder."""
    image = {"name": None, "dim_in": D, "drop_rate": 0.25, "pooling": "attention"}
    image.update(ABMIL_CASES[request.param])
    text = {"name": "mahmoodlab/conch", "frozen": True}
    prompt = {"name": "CoOp", "method": "rank", "pretrained": False, "num_ranks": 4,
              "num_base_ranks": 2, "num_tokens_per_rank": 2, "num_context_tokens": 4,
              "rank_tokens_position": "tail",
              "init_prompt_path": "vlsa_tpu/assets/tools/survival_prompts.json",
              "init_prompt_context_idx": 0, "init_prompt_rank_idx": 0,
              "rank_specific_context": False}
    jmodel, jparams, _tok = jax_build_vlsa(
        vlsa_api="CONCH", text_encoder_cfg=text, image_encoder_cfg=image,
        prompt_learner_cfg=prompt, tower_overrides=TOWER, rng=jax.random.PRNGKey(0))
    jparams = jax.tree.map(np.asarray, dict(jparams))
    model, _ = build_vlsa(text, image, prompt, tower_overrides=TOWER, device="cpu",
                          state_dict=state_dict_from_jax(jparams))
    return request.param, jmodel, jparams, model


def test_calc_abmil_text_img_similarity_matches_jax(abmil_vlsa):
    _case, jmodel, jparams, model = abmil_vlsa
    X = _bag(300, seed=4)
    got = calc_abmil_text_img_similarity(model, X)
    _check_dicts(got, jax_calc_abmil(jmodel, jparams, X))
    assert got["attention"].shape == (1, 300) and got["probs"].shape == (1, 4)
    assert abs(float(got["attention"].sum()) - 1.0) <= 1e-5


def test_calc_abmil_masks_padding(abmil_vlsa):
    _case, jmodel, jparams, model = abmil_vlsa
    X = np.random.default_rng(1).normal(size=(1, 64, D)).astype(np.float32)
    mask = np.ones((1, 64), bool)
    mask[:, 48:] = False
    got = calc_abmil_text_img_similarity(model, X, mask=mask)
    _check_dicts(got, jax_calc_abmil(jmodel, jparams, X, mask=mask))
    assert float(np.abs(got["attention"][0, 48:]).max()) == 0.0
    assert abs(float(got["attention"].sum()) - 1.0) <= 1e-5


# ---------------------------------------------------------------- cohort

@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """The small VLSA cohort of tests/test_interpret.py::test_interpret_cohort
    (16 patients, bags `synthetic://N=96,D=64`), vlsa_tpu's handler and the
    port's from the same weights, and both packages' cohort attributions of
    its test split (batch 4, min bucket 64)."""
    from vlsa_tpu.runner import VLSAHandler as JaxVLSAHandler
    from vlsa_tpu_torch.runner.train import make_dataset
    from vlsa_tpu_torch.runner.vlsa import VLSAHandler

    root = tmp_path_factory.mktemp("interpret_cohort")
    table, split = make_cohort(root, n_patients=16)
    cfg = vlsa_cfg(root, table, split)
    cfg.update(epochs=1, save_path=str(root / "jax"),
               _test_tower_overrides=dict(cfg["_test_tower_overrides"], dtype="float32"))
    jhandler = JaxVLSAHandler(dict(cfg))
    jset = jhandler.func_prepare_dataset(jhandler.data_split["test"], "test", jhandler.cfg,
                                         jhandler.data_meta)
    want = jax_interpret_cohort(jhandler.model, jhandler.params, jset, batch_size=4,
                                min_bucket=64, save_path=str(root / "jax.csv"))
    sd = state_dict_from_jax(jax.tree.map(np.asarray, dict(jhandler.params)))
    handler = VLSAHandler(dict(cfg, save_path=str(root / "port")), device="cpu",
                          state_dict=sd)
    tset = make_dataset(handler.cfg, handler.data_meta, handler.data_split["test"])
    got = interpret_cohort(handler.model, tset, batch_size=4, min_bucket=64,
                           save_path=str(root / "port.csv"))
    return {"root": root, "cfg": cfg, "handler": handler, "dataset": tset, "got": got,
            "want": want}


def _read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], [r[0] for r in rows[1:]], np.array([[float(v) for v in r[1:]]
                                                        for r in rows[1:]])


def test_interpret_cohort_matches_jax(cohort):
    got, want = cohort["got"], cohort["want"]
    assert got["uid"] == list(want["uid"]) and len(got["uid"]) == len(cohort["dataset"])
    for k in ("decoupled_similarity", "shap_importance", "probs"):
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32
        assert _rel(got[k], want[k]) <= TOL, (k, _rel(got[k], want[k]))
    np.testing.assert_allclose(got["probs"].sum(-1), 1.0, atol=1e-5)
    # the efficiency axiom per patient, v(all) from the returned similarities
    sims = got["decoupled_similarity"].astype(np.float64)
    ls = float(torch.exp(cohort["handler"].model.logit_scale.detach()))
    z = ls * sims.mean(1)
    p = np.exp(z - z.max(-1, keepdims=True))
    K = sims.shape[-1]
    v_all = (p / p.sum(-1, keepdims=True)) @ (K - np.arange(K))
    gap = np.abs(got["shap_importance"].astype(np.float64).sum(-1) - (v_all - 1.0))
    assert np.all(gap <= 1e-6 * np.maximum(1.0, np.abs(v_all)))


def test_interpret_cohort_csv_matches_jax(cohort):
    root = cohort["root"]
    g_head, g_ids, g_vals = _read_csv(root / "port.csv")
    w_head, w_ids, w_vals = _read_csv(root / "jax.csv")
    P, K = cohort["got"]["shap_importance"].shape[1], cohort["got"]["probs"].shape[1]
    assert g_head == w_head == (["patient_id"] + [f"shap_prior_{i}" for i in range(P)]
                                + [f"incidence_{k}" for k in range(K)])
    assert g_ids == w_ids == cohort["got"]["uid"]
    assert _rel(g_vals, w_vals) <= TOL
    np.testing.assert_array_equal(g_vals[:, :P], cohort["got"]["shap_importance"])


def test_load_vlsa_from_run_round_trip(cohort):
    """A port run from its seed, trained 1 epoch, rebuilt from its
    directory: the same logits as the trained model, bit for bit, and the
    same cohort (the frozen tower, left out of the checkpoint, is rebuilt
    from the seed)."""
    from vlsa_tpu_torch.runner.vlsa import VLSAHandler

    handler = VLSAHandler(dict(cohort["cfg"], save_path=str(cohort["root"] / "run")),
                          device="cpu")
    handler.exec()
    run = handler.cfg["save_path"]
    model, cfg = load_vlsa_from_run(run, ckpt_type="last", return_cfg=True, device="cpu")
    assert cfg == get_model_cfg(run) and not model.training
    trained = handler.model.eval()
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(3, 80, D)).astype(np.float32))
    mask = torch.ones(3, 80, dtype=torch.bool)
    mask[2, 50:] = False
    with torch.inference_mode():
        assert torch.equal(model(x, mask)[0], trained(x, mask)[0])
    again = interpret_cohort(model, cohort["dataset"], batch_size=4, min_bucket=64)
    want = interpret_cohort(trained, cohort["dataset"], batch_size=4, min_bucket=64)
    for k in ("decoupled_similarity", "shap_importance", "probs"):
        np.testing.assert_array_equal(again[k], want[k])
    with pytest.raises(RuntimeError, match="not found"):
        get_model_cfg(str(cohort["root"]))


def test_coalition_order_is_the_references():
    """Coalition j holds prior i when bit i of j is set (the reference's
    int2bin): swapping two priors' similarities swaps their values."""
    sim = _sims(5, 4, seed=9)
    phi = evaluate_prototype_shap_imp(sim, 20.0)
    for i, j in itertools.combinations(range(5), 2):
        swapped = sim.copy()
        swapped[[i, j]] = sim[[j, i]]
        phi_s = evaluate_prototype_shap_imp(swapped, 20.0)
        np.testing.assert_allclose(phi_s[[i, j]], phi[[j, i]], rtol=0, atol=1e-6)


def test_int8_bag_with_its_scales_matches_its_dequantized_values(vlfan_vlsa):
    """A bag passed as int8 with its per-patch scales (rows 3/4 on the
    card) gives what its dequantized f32 values give: the plain pooling
    dequantizes, so the same f32 products up to summation order."""
    from vlsa_tpu_torch.data.quant import quantize_feats_int8
    _case, (_jm, _jp, model) = vlfan_vlsa
    q, scale = quantize_feats_int8(_bag(200, seed=6))
    got = calc_text_img_similarity(model, torch.from_numpy(q), x_scale=torch.from_numpy(scale))
    want = calc_text_img_similarity(model, q.astype(np.float32) * scale[:, None])
    for k, w in want.items():
        if k != "logit_scale" and w is not None:
            assert _rel(got[k], w) <= TOL, k


def test_abmil_int8_bag_with_its_scales(abmil_vlsa):
    from vlsa_tpu_torch.data.quant import quantize_feats_int8
    _case, _jm, _jp, model = abmil_vlsa
    q, scale = quantize_feats_int8(_bag(200, seed=7))
    got = calc_abmil_text_img_similarity(model, torch.from_numpy(q),
                                         x_scale=torch.from_numpy(scale))
    # DeepMIL's attention pooling dequantizes int8 in f32; the gated pooling
    # and DSMIL take it dequantized to bf16, as in serving
    stored = torch.from_numpy(q).float() * torch.from_numpy(scale)[:, None]
    if _case != "deepmil_attention":
        stored = stored.to(torch.bfloat16).float()
    want = calc_abmil_text_img_similarity(model, stored.numpy())
    for k in ("attention", "probs", "similarity"):
        assert _rel(got[k], want[k]) <= TOL, k
