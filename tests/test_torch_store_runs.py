"""Whole runs (`exec()`) from feature stores, the port's handlers against
vlsa_tpu's from the same initial weights, on the cohort of
tests/test_torch_lifecycle.py (36 synthetic patients split 21 / 7 / 8, its
bags `synthetic://N=96,D=64,seed=3` written as slide files):

- a few-shot flagship VLSA run (`num_shot: 2`) from a `.npy` store, every
  port batch built by the native loader;
- an SA run with continuous labels (`time_format: origin`), `loss_type:
  SurvPLE`, the Cox evaluator and no output converter (net_dims
  64-32-1), from a `.q8npz` store in the SA config's f32 storage (so the
  bags are dequantized on the numpy path, as vlsa_tpu does).  It trains
  with SGD: the Cox loss does not change when every risk shifts by one
  constant, so the gradient of the head's last bias is rounding noise, which
  Adam would scale into steps of +-lr that differ between the packages.

Tolerances, those of tests/test_torch_lifecycle.py: every metric of every
epoch and of the final evaluation within 1e-4, the C-indices equal,
prediction CSVs within 1e-5, the last checkpoint within 1e-5 of
vlsa_tpu's."""
import contextlib
import os

import numpy as np
import pytest

from test_torch_lifecycle import (TOL_CKPT, TOL_METRIC, TOL_PRED, jax_abmil_interpret,
                                  jax_initial_state, lifecycle_cfg, read_csv, read_events,
                                  read_metric_table, write_cohort)
from vlsa_tpu.runner import SAHandler as JaxSAHandler
from vlsa_tpu.runner import VLSAHandler as JaxVLSAHandler
from vlsa_tpu.runner.ckpt import load_checkpoint as jax_load_checkpoint
from vlsa_tpu_torch.data import pipeline
from vlsa_tpu_torch.data.bags import FewShotSurvBagDataset
from vlsa_tpu_torch.data.convert import convert_dir
from vlsa_tpu_torch.data.io import synthetic_bag
from vlsa_tpu_torch.runner.ckpt import load_checkpoint
from vlsa_tpu_torch.runner.sa import SAHandler
from vlsa_tpu_torch.runner.vlsa import VLSAHandler
from vlsa_tpu_torch.utils.weights import _flatten, jax_tree_from_state_dict

SYNTH = "synthetic://N=96,D=64,seed=3"
RUNS = {
    "fewshot_vlsa": dict(kind="vlsa", store="npy", cohort_seed=11,
                         overrides=dict(num_shot=2, seed_shot=3)),
    "cox_sa": dict(kind="sa", store="q8npz", cohort_seed=20,
                   overrides=dict(loss_type="SurvPLE", time_format="origin", evaluator="Cox",
                                  net_output_converter=None, net_dims="64-32-1", opt_name="sgd",
                                  opt_lr=0.05)),
}


def write_store(root, table, fmt):
    """Every slide of the table's synthetic bag as `<sid>.npy`, converted to
    `.q8npz` for fmt q8npz; returns the store's directory."""
    npy = os.path.join(root, "store_npy")
    os.makedirs(npy)
    with open(table) as f:
        sids = [line.split(",")[0] for line in f.read().splitlines()[1:]]
    for sid in sids:
        np.save(os.path.join(npy, sid + ".npy"), synthetic_bag(sid, SYNTH))
    if fmt == "npy":
        return npy
    q8 = os.path.join(root, "store_q8npz")
    convert_dir(npy, q8, dtype="int8", verbose=False)
    return q8


@pytest.fixture(scope="module", params=sorted(RUNS))
def run(request, tmp_path_factory):
    return run_store_pair(request.param, tmp_path_factory.mktemp(request.param))


def run_store_pair(name, root, spec=None):
    """{"name", "kind", "jax"/"port": (handler, metrics, save path),
    "jax_train_set", "batches": the port's batch counts}."""
    spec = spec or RUNS[name]
    table, split = write_cohort(str(root), seed=spec["cohort_seed"])
    store = write_store(str(root), table, spec["store"])
    overrides = dict(spec["overrides"], path_patch=store, feat_format=spec["store"])
    out = {"name": name, "kind": spec["kind"]}
    vlsa = spec["kind"] == "vlsa"
    cfg = lifecycle_cfg(spec["kind"], root, table, split, root / "jax", **overrides)
    with jax_abmil_interpret() if not vlsa else contextlib.nullcontext():
        handler = (JaxVLSAHandler if vlsa else JaxSAHandler)(cfg)
        init = jax_initial_state(handler)
        out["jax_train_set"] = handler.func_prepare_dataset(
            handler.data_split["train"], "train", cfg, handler.data_meta)
        out["jax"] = (handler, handler.exec(), cfg["save_path"])
    cfg = lifecycle_cfg(spec["kind"], root, table, split, root / "port", **overrides)
    handler = (VLSAHandler if vlsa else SAHandler)(cfg, device="cpu", state_dict=init)
    pipeline.reset_batch_counts()
    out["port"] = (handler, handler.exec(), cfg["save_path"])
    out["batches"] = dict(pipeline.BATCHES)
    return out


def test_every_metric_matches_jax(run):
    jax_events, port_events = read_events(run["jax"][2]), read_events(run["port"][2])
    assert [e["event"] for e in port_events] == [e["event"] for e in jax_events]
    n_metrics = 0
    for want, got in zip(jax_events, port_events):
        assert got.keys() == want.keys()
        if want["event"] != "eval":
            continue
        for k, v in want.items():
            if k in ("event", "at", "ts"):
                continue
            n_metrics += 1
            assert np.isfinite(got[k]), k
            if k.endswith(("/c_index", "/c_index2")):
                assert got[k] == v, k
            assert abs(got[k] - v) <= TOL_METRIC, (k, got[k], v)
    handler = run["port"][0]
    # each training loss again as a metric, where the evaluator computes them (not Cox)
    per_pass = len(handler.metrics_list) + (
        len(handler.loss) if hasattr(handler.evaluator, "_eval_ext_loss") else 0)
    assert n_metrics == 9 * per_pass
    for split, rows in run["jax"][1].items():
        got = dict(run["port"][1][split])
        for name, v in rows:
            assert abs(got[name] - v) <= TOL_METRIC, (split, name)
    want = read_metric_table(os.path.join(run["jax"][2], "train_metrics-last.txt"))
    got = read_metric_table(os.path.join(run["port"][2], "train_metrics-last.txt"))
    assert got.keys() == want.keys() and len(got) == 6
    for k in want:
        assert abs(got[k] - want[k]) <= TOL_METRIC, k


def test_predictions_and_files_match_jax(run):
    kind = run["kind"]
    assert sorted(os.listdir(run["port"][2])) == sorted(os.listdir(run["jax"][2]))
    n_train = len(run["jax_train_set"])
    for split, n in (("train", n_train), ("validation", 7), ("test", 8)):
        name = f"{kind}_train_last_pred_{split}.csv"
        h_want, ids_want, want = read_csv(os.path.join(run["jax"][2], name))
        h_got, ids_got, got = read_csv(os.path.join(run["port"][2], name))
        assert h_got == h_want and ids_got == ids_want and len(ids_got) == n
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL_PRED, err_msg=name)
    if run["name"] == "cox_sa":  # one risk a patient: t, e, pred
        assert h_got == ["patient_id", "t", "e", "pred"]


def test_last_checkpoint_matches_jax(run):
    want = jax_load_checkpoint(os.path.join(run["jax"][2], "train_model-last.ckpt"))
    got = load_checkpoint(os.path.join(run["port"][2], "train_model-last.ckpt"))
    a = {"/".join(k): v for k, v in _flatten(jax_tree_from_state_dict(got["model"]))}
    b = {"/".join(k): v for k, v in _flatten(want["model"])}
    assert set(a) == set(b)
    for k in b:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=TOL_CKPT, err_msg=k)


def test_batches_and_training_set(run):
    """The few-shot run trains on vlsa_tpu's sample, every batch from the
    .npy store built natively; the f32 run from .q8npz dequantizes every
    batch on the numpy path.  Each epoch records its wait and build
    seconds."""
    handler = run["port"][0]
    want = run["jax_train_set"]
    train_set = handler.trainer.dataset
    if run["name"] == "fewshot_vlsa":
        assert isinstance(train_set, FewShotSurvBagDataset)
        assert train_set.few_shot_idx == want.few_shot_idx and len(train_set) < 21
        assert run["batches"]["numpy"] == 0 and run["batches"]["native"] > 0
    else:
        assert len(train_set) == len(want) == 21
        assert run["batches"]["native"] == 0 and run["batches"]["numpy"] > 0
        assert handler.data_meta.label_format == "continuous_time"
        assert handler.cfg["net_dims"] == "64-32-1" and handler.cfg["time_bins"] is None
    assert handler.uid["train"] == want.uid
    for ep in handler.timings["epochs"]:
        assert ep["build_s"] > 0 and 0 <= ep["prep_s"] <= ep["wall_s"]
