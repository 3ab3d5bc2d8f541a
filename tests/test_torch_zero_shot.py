"""Zero-shot (MI-Zero) evaluation in both packages: `masked_topk_mean` and
`logit_pooling` against vlsa_tpu's (ragged masks, k above a bag's valid
count and above N, an empty bag), FeatMIL's three poolings, the zero-shot
VLSA forward from bridged weights in f32, bf16 and int8 with scales, the
zero-shot handler against vlsa_tpu's on the cohort of
tests/test_runner_modes.py::test_vlsa_zero_shot with the text tower
imported from a written CONCH checkpoint (`path_clip_model`), and `main
--multi_run` over the shipped config's three poolings.

Tolerances: the pooling primitives within 1e-6 of the largest logit (the
same selections of the same f32 values, summed in another order), the
argmax and an empty bag's values exactly.  FeatMIL exactly for max and
identity, the f32 mean within 1e-6 of the largest feature, the bf16 mean
within one bf16 ulp (2^-8 relative; its sum is rounded to bf16 in both).  Zero-shot logits (max|a-b| / max|b|) 1e-5 in f32; in bf16 and
int8 2e-3: both normalise the bf16 patch rows in bf16, and a sum of
squares accumulated in another order can round to the neighbouring bf16
value, one ulp (2^-8) of a row's norm; scaled by exp(logit_scale) and
divided by the largest logit that stays below 2e-3.  vlsa_tpu's forward
runs compiled, as its engine runs it.  Handler runs: metrics 1e-4 and
C-indices equal with an f32 tower (as tests/test_torch_lifecycle.py),
prediction CSVs 1e-5; with the bf16 tower and bf16 or int8 features (the
shipped config) metrics and CSVs 2e-3 (the bf16 tower's text features
agree within 2e-3, ROADMAP §C); the losses through vlsa_tpu's evaluator
(see assert_losses_match).
"""
import copy
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import yaml

from test_runner_e2e import make_cohort, vlsa_cfg
from test_torch_lifecycle import jax_multi_run_paths, read_csv, read_events, read_metric_table
from test_torch_weights_import import write_conch_checkpoint
from vlsa_tpu.data.pipeline import quantize_feats_int8
from vlsa_tpu.models.mil import FeatMIL as JaxFeatMIL
from vlsa_tpu.models.mil import logit_pooling as jax_logit_pooling
from vlsa_tpu.models.vlsa_build import build_vlsa as jax_build_vlsa
from vlsa_tpu.ops.masked import masked_topk_mean as jax_masked_topk_mean
from vlsa_tpu.runner import VLSAHandler as JaxVLSAHandler
from vlsa_tpu_torch import main as port_main
from vlsa_tpu_torch.models.mil import FeatMIL, logit_pooling
from vlsa_tpu_torch.models.vlsa_build import build_vlsa
from vlsa_tpu_torch.ops.masked import NEG_INF, masked_topk_mean
from vlsa_tpu_torch.runner.vlsa import VLSAHandler
from vlsa_tpu_torch.utils.weights import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_LOGITS = {"float32": 1e-5, "bfloat16": 2e-3, "int8": 2e-3}
POOLINGS = ("logit_top10", "logit_max", "logit_mean")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def ragged_logits(seed=0, valid=(20, 7, 1, 0), N=20, C=4):
    """Per-patch logits [B, N, C] and the mask of bags with `valid` patches
    (the last one empty)."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(len(valid), N, C)).astype(np.float32) * 5
    mask = np.arange(N)[None, :] < np.asarray(valid)[:, None]
    return logits, mask


@pytest.mark.parametrize("topk", [1, 5, 10, 20, 25])
def test_masked_topk_mean_matches_jax(topk):
    """k within every bag, above the valid count of some (7, 1), equal to N
    and above N; an empty bag gives NEG_INF."""
    logits, mask = ragged_logits()
    want = np.asarray(jax_masked_topk_mean(jnp.asarray(logits), jnp.asarray(mask), topk))
    got = masked_topk_mean(torch.from_numpy(logits), torch.from_numpy(mask), topk).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(logits).max())
    assert np.all(got[-1] == NEG_INF)
    # a bag of one valid patch gives that patch's logits for every k
    np.testing.assert_array_equal(got[2], logits[2, 0])
    # the unbatched form
    np.testing.assert_array_equal(
        masked_topk_mean(torch.from_numpy(logits[1]), torch.from_numpy(mask[1]), topk).numpy(),
        got[1])


@pytest.mark.parametrize("method", ["logit_max", "logit_top3", "logit_top10", "logit_top50",
                                    "logit_mean"])
def test_logit_pooling_matches_jax(method):
    logits, mask = ragged_logits(seed=1)
    jpreds, jpooled = jax_logit_pooling(jnp.asarray(logits), method, jnp.asarray(mask))
    preds, pooled = logit_pooling(torch.from_numpy(logits), method, torch.from_numpy(mask))
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jpooled), rtol=0,
                               atol=1e-6 * np.abs(logits).max())
    np.testing.assert_array_equal(preds.numpy(), np.asarray(jpreds))
    # the empty bag: NEG_INF under top-k, 0 under the mean
    assert np.all(pooled[-1].numpy() == (0.0 if method == "logit_mean" else NEG_INF))


def test_unknown_logit_pooling_raises():
    with pytest.raises(NotImplementedError):
        logit_pooling(torch.zeros(2, 3, 4), "logit_median")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pooling", ["mean", "max", "identity"])
def test_featmil_poolings_match_jax(pooling, dtype):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 50, 16)).astype(np.float32)
    mask = np.arange(50)[None, :] < np.array([50, 13, 1])[:, None]
    if dtype == "bfloat16":
        jx, tx = jnp.asarray(x.astype(ml_dtypes.bfloat16)), torch.from_numpy(x).bfloat16()
    else:
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    want = np.asarray(JaxFeatMIL(pooling=pooling).apply({}, jx, jnp.asarray(mask)),
                      np.float32)
    got = FeatMIL(pooling).forward(tx, torch.from_numpy(mask)).float().numpy()
    assert got.shape == want.shape == ((3, 50, 16) if pooling == "identity" else (3, 16))
    rtol, atol = 0.0, 0.0
    if pooling == "mean" and dtype == "float32":
        atol = 1e-6 * np.abs(x).max()
    elif pooling == "mean":
        rtol = 2.0 ** -8
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    assert list(FeatMIL(pooling).parameters()) == []


# ---------------------------------------------------------------- the forward

SMALL_TOWER = {"width": 32, "heads": 4, "layers": 2, "output_dim": 64}


def zero_shot_cfgs(asset_root, pooling):
    image = {"name": "FeatMIL", "dim_in": 64, "pooling": pooling}
    prompt = {"name": "CoOp", "method": "plain", "pretrained": False, "num_ranks": 4,
              "num_base_ranks": 4, "num_tokens_per_rank": 4, "num_context_tokens": 8,
              "rank_tokens_position": "tail",
              "init_prompt_path": asset_root + "/tools/survival_prompts.json",
              "init_prompt_context_idx": 4, "init_prompt_rank_idx": 0,
              "rank_specific_context": False,
              "frozen_context_embeds": True, "frozen_rank_embeds": True}
    return {"name": "mahmoodlab/conch", "frozen": True}, image, prompt


@pytest.fixture(scope="module", params=POOLINGS)
def zero_shot_pair(request):
    tower = dict(SMALL_TOWER, dtype="float32")
    text, image, prompt = zero_shot_cfgs(os.path.join(REPO, "vlsa_tpu", "assets"), request.param)
    jmodel, jparams, _ = jax_build_vlsa(vlsa_api="CONCH", text_encoder_cfg=text,
                                        image_encoder_cfg=image, prompt_learner_cfg=prompt,
                                        rng=jax.random.PRNGKey(0), tower_overrides=tower)
    jparams = jax.tree.map(np.asarray, dict(jparams))
    text, image, prompt = zero_shot_cfgs("vlsa_tpu/assets", request.param)
    model, _ = build_vlsa(text, image, prompt, tower_overrides=tower, device="cpu",
                          state_dict=state_dict_from_jax(jparams))
    return jmodel, jparams, model


def _bags(seed=0, lengths=(300, 217, 1, 123), D=64):
    rng = np.random.default_rng(seed)
    x = np.zeros((len(lengths), max(lengths), D), np.float32)
    mask = np.zeros(x.shape[:2], bool)
    for j, n in enumerate(lengths):
        x[j, :n] = rng.normal(size=(n, D))
        mask[j, :n] = True
    return x, mask


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
def test_zero_shot_forward_matches_jax(zero_shot_pair, storage):
    """Per-patch logits through FeatMIL and MI-Zero pooling; int8 bags
    dequantized to bf16 (with their scales) in both."""
    jmodel, jparams, model = zero_shot_pair
    x, mask = _bags()
    jkw, tkw = {}, {}
    if storage == "int8":
        xq, scale = quantize_feats_int8(x)
        jx, tx = jnp.asarray(xq), torch.from_numpy(xq)
        jkw, tkw = {"x_scale": jnp.asarray(scale)}, {"x_scale": torch.from_numpy(scale)}
    elif storage == "bfloat16":
        jx, tx = jnp.asarray(x.astype(ml_dtypes.bfloat16)), torch.from_numpy(x).bfloat16()
    else:
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    # compiled, as vlsa_tpu's engine runs it (XLA keeps bf16 quotients in f32)
    want, jimg, _ = jax.jit(jmodel.apply)({"params": jparams}, jx, jnp.asarray(mask), **jkw)
    with torch.no_grad():
        got, img, _ = model(tx, torch.from_numpy(mask), **tkw)
    assert img.shape == (4, 300, 64) and img.dtype == (torch.float32 if storage == "float32"
                                                       else torch.bfloat16)
    assert got.shape == (4, 4) and got.dtype == torch.float32 and torch.isfinite(got).all()
    assert _rel(got.numpy(), want) <= TOL_LOGITS[storage]


def test_zero_shot_model_has_no_trainable_parameters_but_the_frozen_ones(zero_shot_pair):
    """The tower is a submodule (CoOp runs through it); FeatMIL adds none."""
    _jm, jparams, model = zero_shot_pair
    names = {k.split(".")[0] for k, _ in model.named_parameters()}
    assert names == {"logit_scale", "prompt_encoder", "prompt_learner"} == set(jparams)


# ---------------------------------------------------------------- the handler

def zero_shot_run_cfg(tmp_path, pooling, feats_dtype, tower_dtype, ckpt):
    """test_runner_modes.py::test_vlsa_zero_shot's cohort with the shipped
    zero-shot config's settings (frozen plain CoOp from the survival
    prompts, frozen logit scale, FeatMIL) and the tower of `ckpt`."""
    table, split = make_cohort(tmp_path, n_patients=24)
    cfg = vlsa_cfg(tmp_path, table, split)
    cfg.update({
        "num_shot": 0, "save_path": str(tmp_path / "result-zs"),
        "path_clip_model": str(ckpt), "vlsa_frozen_logit_scale": True,
        "vlsa_img_encoder_name": "FeatMIL", "vlsa_img_encoder_frozen": True,
        "vlsa_img_encoder_pooling": pooling, "vlsa_pmt_learner_coop_method": "plain",
        "vlsa_pmt_learner_coop_init_prompt_context_idx": 4,
        "vlsa_pmt_learner_coop_frozen_context_embeds": True,
        "vlsa_pmt_learner_coop_frozen_rank_embeds": True,
        "loss_type": "SurvIFMLE", "feats_dtype": feats_dtype,
        "_test_tower_overrides": dict(cfg["_test_tower_overrides"], dtype=tower_dtype)})
    return cfg


def record_passes(handler):
    """Keep every evaluation pass's collected predictions, by split, in
    the returned dict (either package's handler)."""
    passes = {}
    test_model = handler.test_model

    def recording(*args, **kws):
        out = test_model(*args, **kws)
        passes.setdefault(out["pred"]["name"], []).append(out["pred"])
        return out
    handler.test_model = recording
    return passes


def jax_losses(handler, cltor, rows):
    """vlsa_tpu's evaluation of the loss metrics on the patients `rows`."""
    sub = {k: (v[rows] if isinstance(v, np.ndarray) else [v[i] for i in np.flatnonzero(rows)])
           for k, v in cltor.items() if k != "name"}
    names = [m for m in handler.metrics_list if m.startswith("loss")]
    return handler.evaluator.compute(dict(sub, name=cltor["name"]), names,
                                     kws_ext_loss=handler.loss,
                                     loss_weight=handler.loss_weight,
                                     logit_scale=handler.get_logit_scale_value())


def assert_losses_match(jax_handler, want_pred, got_pred, tol):
    """The IF-MLE loss of a censored patient is -log(max(1 - CIF_t, 1e-7)):
    where the CIF nears 1 (always in the last time bin, where it is 1 in
    exact arithmetic; in earlier bins when a prediction saturates) the
    term is the f32 rounding of the CIF's sum, which an ulp of the
    predictions moves by up to 0.7.  So the losses are held, through
    vlsa_tpu's evaluator, on the other patients (1 - CIF_t >= 1e-2 in
    vlsa_tpu's predictions, where an ulp moves the term by < 2e-5), and
    each held-out patient's 1 - CIF_t is below 2e-2 in the port's too."""
    assert got_pred["uid"] == want_pred["uid"]
    t, e = want_pred["y"][:, 0].astype(int), want_pred["y"][:, 1]

    def survival(pred):
        cif = np.cumsum(pred["y_hat"].astype(np.float64), axis=1)
        return 1.0 - cif[np.arange(len(t)), t]
    fragile = (e == 0) & (survival(want_pred) < 1e-2)
    assert np.all(survival(got_pred)[fragile] < 2e-2)
    assert np.count_nonzero(~fragile) >= len(t) / 2, "most patients are held out"
    want = jax_losses(jax_handler, want_pred, ~fragile)
    got = jax_losses(jax_handler, got_pred, ~fragile)
    assert want.keys() == got.keys() and len(want) >= 2
    for k in want:
        assert abs(got[k] - want[k]) <= tol, (k, got[k], want[k])


def assert_events_match(jax_path, path, tol, equal_c_index):
    """metrics.jsonl: the same events, every metric but the losses within
    `tol` (the C-indices equal with `equal_c_index`)."""
    want_events, got_events = read_events(jax_path), read_events(path)
    assert [e["event"] for e in got_events] == [e["event"] for e in want_events]
    for want, got in zip(want_events, got_events):
        assert got.keys() == want.keys()
        if want["event"] != "eval":
            continue
        for k, v in want.items():
            if k in ("event", "at", "ts") or k.split("/")[-1].startswith("loss"):
                continue
            if equal_c_index and k.endswith(("/c_index", "/c_index2")):
                assert got[k] == v, k
            assert abs(got[k] - v) <= tol, (k, got[k], v)
    return want_events


@pytest.fixture(scope="module", params=[("logit_top10", "float32", "float32"),
                                        ("logit_max", "bfloat16", "bfloat16"),
                                        ("logit_mean", "int8", "bfloat16")],
                ids=lambda p: "-".join(p))
def handler_pair(request, tmp_path_factory):
    """Both packages' zero-shot runs: {"jax"/"port": (handler, metrics,
    save path, the evaluation passes' collected predictions by split)}."""
    pooling, feats_dtype, tower_dtype = request.param
    root = tmp_path_factory.mktemp("zero_shot")
    write_conch_checkpoint(root / "conch" / "pytorch_model.bin")
    out = {}
    for name, make, kws in (("jax", JaxVLSAHandler, {}), ("port", VLSAHandler, {"device": "cpu"})):
        cfg = zero_shot_run_cfg(root, pooling, feats_dtype, tower_dtype, root / "conch")
        cfg["save_path"] += "-" + name
        handler = make(copy.deepcopy(cfg), **kws)
        passes = record_passes(handler)
        out[name] = (handler, handler.exec(), handler.cfg["save_path"], passes)
    return request.param, out


def test_zero_shot_handler_matches_jax(handler_pair):
    """Every metric of the run within the tolerance, the C-indices equal
    with the f32 tower, the losses as `assert_losses_match` holds them."""
    (_pooling, _feats, tower_dtype), runs = handler_pair
    tol = 1e-4 if tower_dtype == "float32" else 2e-3
    (jh, jmetrics, jpath, jpasses), (handler, metrics, path, passes) = runs["jax"], runs["port"]
    assert set(metrics) == set(jmetrics) == {"test"}
    assert set(passes) == set(jpasses) == {"test"} and len(passes["test"]) == 1
    assert_losses_match(jh, jpasses["test"][0], passes["test"][0], tol)
    events = assert_events_match(jpath, path, tol, equal_c_index=tower_dtype == "float32")
    assert [e["event"] for e in events] == ["eval"]
    assert dict(metrics["test"])["pred_c_index"] == pytest.approx(
        dict(jmetrics["test"])["pred_c_index"], abs=tol)
    want = read_metric_table(os.path.join(jpath, "zero-shot_metrics-best.txt"))
    got = read_metric_table(os.path.join(path, "zero-shot_metrics-best.txt"))
    assert got.keys() == want.keys() and len(got) == 2
    # no training: the model is as built, the logit scale the checkpoint's
    assert handler.optimizer is None and handler.engine is None
    assert handler.model.logit_scale.item() == 4.0
    assert handler.timings["epochs"] == [] and [p["split"] for p in handler.timings["eval"]] \
        == ["test"]


def test_zero_shot_prediction_csvs_match_jax(handler_pair):
    (_pooling, _feats, tower_dtype), runs = handler_pair
    tol = 1e-5 if tower_dtype == "float32" else 2e-3
    name = "vlsa_zero-shot_last_pred_test.csv"
    h_want, ids_want, want = read_csv(os.path.join(runs["jax"][2], name))
    h_got, ids_got, got = read_csv(os.path.join(runs["port"][2], name))
    assert h_got == h_want and ids_got == ids_want and len(ids_got) > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_zero_shot_run_writes_the_files_jax_writes(handler_pair):
    _p, runs = handler_pair
    got = sorted(os.listdir(runs["port"][2]))
    assert got == sorted(os.listdir(runs["jax"][2]))
    assert got == ["config.yaml", "metrics.jsonl", "print_config.txt",
                   "vlsa_zero-shot_last_pred_test.csv", "zero-shot_metrics-best.txt"]


def test_a_model_with_nothing_to_train_refuses_to_train(tmp_path):
    ckpt = tmp_path / "conch" / "pytorch_model.bin"
    write_conch_checkpoint(ckpt)
    cfg = zero_shot_run_cfg(tmp_path, "logit_max", "float32", "float32", ckpt)
    cfg.update(num_shot=-1, epochs=1)
    with pytest.raises(ValueError, match="nothing to train"):
        VLSAHandler(cfg, device="cpu").exec()


def test_main_multi_run_over_the_poolings(tmp_path):
    """`main --multi_run` on a zero-shot config with the shipped grid of
    poolings: one zero-shot run each, in the directories vlsa_tpu's
    main.py names."""
    ckpt = tmp_path / "conch" / "pytorch_model.bin"
    write_conch_checkpoint(ckpt)
    cfg = zero_shot_run_cfg(tmp_path, list(POOLINGS), "bfloat16", "bfloat16", tmp_path / "conch")
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    runs = port_main.main(["--config", str(path), "--handler", "VLSA", "--multi_run",
                           "--device", "cpu"])
    assert len(runs) == 3 and all(set(m) == {"test"} for m in runs)
    want = jax_multi_run_paths(cfg)
    assert len(set(want)) == 3 and all(p.startswith(cfg["save_path"] + "-") for p in want)
    for p in want:
        assert os.path.exists(os.path.join(p, "zero-shot_metrics-best.txt"))
        assert os.path.exists(os.path.join(p, "vlsa_zero-shot_last_pred_test.csv"))
        assert not any(f.endswith(".ckpt") for f in os.listdir(p))


def test_serving_the_shipped_zero_shot_config(tmp_path):
    """runner.serve.make_engine on configs/IFMLE/tcga_blca/
    cfg_zero_shot_conch.yaml (one pooling, the small tower of a written
    checkpoint through `path_clip_model`, bf16 tower and bags as shipped):
    the probabilities of vlsa_tpu's model built from the same checkpoint,
    within 2e-3 (the bf16 tower, as the handler runs above)."""
    from vlsa_tpu.config import load_config as jax_load_config
    from vlsa_tpu.utils.torch_import import import_text_tower_from_checkpoint
    from vlsa_tpu_torch.config import load_config, serving_config
    from vlsa_tpu_torch.runner.serve import make_engine

    write_conch_checkpoint(tmp_path / "conch" / "mahmoodlab" / "conch" / "pytorch_model.bin",
                           output=512)
    path = os.path.join(REPO, "configs/IFMLE/tcga_blca/cfg_zero_shot_conch.yaml")
    tower = dict(SMALL_TOWER, output_dim=512, dtype="bfloat16")
    cfg = dict(load_config(path), vlsa_img_encoder_pooling="logit_top10",
               path_clip_model=str(tmp_path / "conch"), _test_tower_overrides=tower)
    engine = make_engine(serving_config(cfg), device="cpu")
    assert engine.model.logit_scale.item() == 4.0
    x, mask = _bags(D=512, lengths=(300, 17, 123))
    bags = [x[j, :n] for j, n in enumerate(mask.sum(1))]
    got = engine.predict(bags)["probs"]

    jcfg = jax_load_config(path)
    text = {"name": jcfg["vlsa_txt_encoder_name"], "frozen": True}
    _t, image, prompt = zero_shot_cfgs(os.path.join(REPO, "vlsa_tpu", "assets"), "logit_top10")
    image.update(dim_in=512)
    jmodel, jparams, _ = jax_build_vlsa(
        vlsa_api="CONCH", text_encoder_cfg=text, image_encoder_cfg=image,
        prompt_learner_cfg=prompt, rng=jax.random.PRNGKey(0), tower_overrides=tower,
        vl_weights=import_text_tower_from_checkpoint(
            str(tmp_path / "conch" / "mahmoodlab" / "conch" / "pytorch_model.bin")))
    logits = jax.jit(jmodel.apply)({"params": jparams},
                                   jnp.asarray(x.astype(ml_dtypes.bfloat16)),
                                   jnp.asarray(mask))[0]
    want = np.asarray(jax.nn.softmax(logits, axis=-1))
    assert got.shape == want.shape == (3, 4)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
