"""The port's serving engine against vlsa_tpu's evaluation pass.

Both packages build the model of configs/IFMLE/tcga_blca/cfg_vlsa_conch.yaml
(its bf16 frozen tower included) with a tiny tower; the bridge gives the
port vlsa_tpu's weights.  vlsa_tpu answers with TrainEngine.text_precompute
plus eval_step_precomputed, the port with InferEngine.predict, on the same
synthetic bags.  Tolerances are max|a-b| / max|b|:

  * 1e-4 for the request path (co-attention pooling, head, softmax) fed
    vlsa_tpu's text features and queries;
  * 1e-3 for the whole pass, the port's own text precompute included: the
    bf16 tower rounds its matmul operands to bf16 on both sides, and where an
    f32 value lies within the summation-order difference of a bf16 rounding
    boundary the two round apart by 2^-8 relative (measured: most prototype
    and query rows agree to 3e-7, single rows differ by 4e-4 to 1.5e-3, and
    the probabilities by 1.2e-4).

The JAX side gets bf16 bags as their f32 values (see test_torch_vlsa.py).
"""
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from vlsa_tpu.config import fetch_kws as jax_fetch_kws
from vlsa_tpu.data.io import synthetic_bag as jax_synthetic_bag
from vlsa_tpu.data.pipeline import feats_inv_norms, pad_bag, quantize_feats_int8
from vlsa_tpu.models.precision import cast_frozen_tower_weights as jax_cast
from vlsa_tpu.models.vlsa_build import build_vlsa as jax_build_vlsa
from vlsa_tpu.runner.engine import TrainEngine
from vlsa_tpu_torch.config import load_config, serving_config
from vlsa_tpu_torch.data.io import synthetic_bag
from vlsa_tpu_torch.data.quant import quantize_bag
from vlsa_tpu_torch.models.vlsa_build import build_vlsa_from_config
from vlsa_tpu_torch.runner.engine import InferEngine, incidence_outputs
from vlsa_tpu_torch.runner.serve import request_bags
from vlsa_tpu_torch.utils.weights import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "IFMLE", "tcga_blca", "cfg_vlsa_conch.yaml")
PATH_PATCH = "synthetic://N=200,D=512,seed=7"


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.fixture(scope="module")
def served():
    cfg = serving_config(load_config(CONFIG))
    cfg["_test_tower_overrides"] = {"width": 64, "heads": 4, "layers": 2, "output_dim": 512}
    cfg["path_patch"] = PATH_PATCH
    assert cfg["vlsa_txt_encoder_dtype"] == "bfloat16"
    # vlsa_tpu's handler wiring (runner/vlsa.py::func_load_model)
    jcfg = dict(cfg)
    for key in ("vlsa_img_encoder_query_text_load_path",
                "vlsa_pmt_learner_coop_init_prompt_path"):
        jcfg[key] = os.path.join(REPO, cfg[key])
    prompt = jax_fetch_kws(jcfg, prefix="vlsa_pmt_learner_coop")
    prompt.update(name="CoOp", pretrained=False)
    jmodel, jparams, _tok = jax_build_vlsa(
        vlsa_api="CONCH", text_encoder_cfg=jax_fetch_kws(jcfg, prefix="vlsa_txt_encoder"),
        image_encoder_cfg=jax_fetch_kws(jcfg, prefix="vlsa_img_encoder"),
        prompt_learner_cfg=prompt, rng=jax.random.PRNGKey(0),
        tower_overrides=jcfg["_test_tower_overrides"])
    jparams = jax_cast(jax.tree.map(np.asarray, dict(jparams)))
    engine = TrainEngine(jmodel, None, None, uses_vl=True)
    text_features, query = engine.text_precompute()(jparams)
    model, _ = build_vlsa_from_config(cfg, device="cpu",
                                      state_dict=state_dict_from_jax(jparams))
    return cfg, engine, jparams, text_features, query, model


def _jax_probs(engine, params, text_features, query, bags, storage):
    target = max(b.shape[0] for b in bags)
    feats = np.stack([pad_bag(b, target)[0] for b in bags])
    mask = np.stack([pad_bag(b, target)[1] for b in bags])
    batch = {"mask": jnp.asarray(mask)}
    if storage == "int8":
        q, scale = quantize_feats_int8(feats)
        batch.update(feats=jnp.asarray(q), feats_scale=jnp.asarray(scale),
                     feats_inv=jnp.asarray(feats_inv_norms(q)))
    elif storage == "bfloat16":
        batch["feats"] = jnp.asarray(feats.astype(ml_dtypes.bfloat16).astype(np.float32))
    else:
        batch["feats"] = jnp.asarray(feats)
    raw = engine.eval_step_precomputed()(params, batch, text_features, query)
    return np.asarray(jax.nn.softmax(raw, axis=-1))


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
def test_incidence_probabilities_match(served, storage):
    cfg, engine, jparams, text_features, query, model = served
    bags = request_bags(cfg["path_patch"], 0, 3)
    want = _jax_probs(engine, jparams, text_features, query, bags, storage)
    infer = InferEngine(model, feats_dtype=storage)
    out = infer.predict(bags)
    assert out["probs"].shape == (3, 12)
    assert _rel(out["probs"], want) < 1e-3

    batch = infer.prepare(bags)
    with torch.no_grad():
        logits, _img, _txt = model(
            batch["feats"], batch["mask"],
            text_features=torch.from_numpy(np.array(text_features)),
            query=torch.from_numpy(np.array(query)),
            x_scale=batch.get("feats_scale"), x_inv=batch.get("feats_inv"))
    assert _rel(incidence_outputs(logits)["probs"].numpy(), want) < 1e-4
    np.testing.assert_allclose(out["probs"].sum(-1), 1.0, atol=1e-5)
    surv = out["survival"]
    assert (surv >= 0).all() and (np.diff(surv, axis=-1) <= 1e-7).all()
    np.testing.assert_allclose(surv, np.clip(1 - np.cumsum(out["probs"], -1), 0, None),
                               atol=1e-6)


def test_int8_bags_with_sidecars_match_host_quantization(served):
    """Pre-quantized bags (int8 plus scale and 1/||q||) give what quantizing
    the same f32 bags in the engine gives."""
    cfg, *_rest, model = served
    bags = request_bags(cfg["path_patch"], 1, 2)
    engine = InferEngine(model, feats_dtype="int8")
    from_f32 = engine.predict(bags)
    from_q8 = engine.predict([quantize_bag(b) for b in bags])
    np.testing.assert_allclose(from_q8["probs"], from_f32["probs"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("uid", ["request0_bag0", "TCGA-XX-0001"])
def test_synthetic_bags_are_bit_identical(uid):
    np.testing.assert_array_equal(synthetic_bag(uid, PATH_PATCH),
                                  jax_synthetic_bag(uid, PATH_PATCH))


def test_serve_cli_answers_requests(tmp_path, capsys):
    import yaml
    from vlsa_tpu_torch.runner import serve
    cfg = load_config(CONFIG)
    cfg["_test_tower_overrides"] = {"width": 32, "heads": 4, "layers": 1, "output_dim": 512}
    cfg["path_patch"] = "synthetic://N=64,D=512,seed=7"
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    summary = serve.main(["--config", str(path), "--n_requests", "2",
                          "--bags_per_request", "3", "--device", "cpu"])
    assert summary["requests"] == 2 and summary["feats_dtype"] == "bfloat16"
    assert sum(summary["coattn_launches"].values()) == 0  # the CPU runs no kernel
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3 and '"request": 1' in lines[1]
