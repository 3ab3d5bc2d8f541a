"""The CLF slice (slide classification) against vlsa_tpu: the losses and
their gradients, the evaluators (scikit-learn's metrics in numpy), the
dataset and its draws, the prediction CSV, and whole runs of the handler.

Tolerances: losses and gradients 1e-6 (f32 on both sides); the evaluators
1e-12 (float64 on both sides, the same operations); the datasets, draws and
CSVs exactly.  The runs: tests/test_clf_e2e.py's cohort and config at
net_dims 32-16-2 (40 patients, 28 train / 12 validation, bags
`synthetic://N=64,D=32,seed=5`), 2 epochs from the same initial weights,
vlsa_tpu's ABMIL kernels in interpret mode as tests/test_torch_lifecycle.py
runs them: every metric of every epoch within 1e-4, as
tests/test_torch_store_runs.py holds its runs, and the prediction CSVs
within 1e-5.  The threshold metrics (acc, recall, precision, f1_score,
acc_best, the multi-class argmax) are compared as the rest: the packages'
probabilities differ by at most ~8e-8 here, the closest two of a split by
~2e-5 (`test_no_prediction_pair_is_near_a_flip` holds a margin of 10), so
no prediction changes side between them.
"""
import contextlib
import csv
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import vlsa_tpu.ops.abmil as jax_abmil
from vlsa_tpu.data.io import save_prediction_clf as jax_save_prediction_clf
from vlsa_tpu.eval.clf_metrics import BinClfEvaluator as JaxBin
from vlsa_tpu.eval.clf_metrics import MultiClfEvaluator as JaxMulti
from vlsa_tpu.losses import clf as jclf
from vlsa_tpu.losses import registry as jreg
from vlsa_tpu.runner import CLFHandler as JaxCLFHandler
from vlsa_tpu.runner import clf as jrun
from vlsa_tpu_torch import main as port_main
from vlsa_tpu_torch.data.io import read_prediction_clf, save_prediction_clf
from vlsa_tpu_torch.eval import load_evaluator
from vlsa_tpu_torch.losses import clf as tclf
from vlsa_tpu_torch.losses import registry as treg
from vlsa_tpu_torch.runner import clf as prun
from vlsa_tpu_torch.runner.clf import CLFHandler
from vlsa_tpu_torch.utils.weights import state_dict_from_jax

TOL_LOSS = 1e-6
TOL_EVAL = 1e-12
TOL_METRIC = 1e-4
TOL_PRED = 1e-5
MARGIN = 10


# ---------------------------------------------------------------- losses

def _logits(C, B=7, seed=0):
    rng = np.random.default_rng(seed)
    return (3 * rng.normal(size=(B, C))).astype(np.float32), rng.integers(0, C, B)


def _loss_pair(fn_name, x, target, **kws):
    """(value, d value / d x) of the JAX and port losses, summed when
    per-element."""
    jfn, tfn = getattr(jclf, fn_name), getattr(tclf, fn_name)
    jkws = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kws.items()}
    tkws = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kws.items()}

    def jsum(xx):
        return jnp.sum(jfn(xx, jnp.asarray(target), **jkws))
    jval, jgrad = jax.value_and_grad(jsum)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    tval = tfn(xt, torch.from_numpy(target), **tkws).sum()
    tval.backward()
    return (float(jval), np.asarray(jgrad)), (float(tval.detach()), xt.grad.numpy())


LOSS_CASES = [
    ("binary_cross_entropy", {}), ("binary_cross_entropy", {"smoothing": 0.0}),
    ("binary_cross_entropy", {"target_threshold": 0.2}),
    ("binary_cross_entropy", {"weight": "classes", "pos_weight": "classes"}),
    ("binary_cross_entropy", {"ret_mean": False}),
    ("label_smoothing_cross_entropy", {}),
    ("label_smoothing_cross_entropy", {"smoothing": 0.0, "weight": "rows"}),
    ("label_smoothing_cross_entropy", {"ret_mean": False}),
    ("soft_target_cross_entropy", {}), ("soft_target_cross_entropy", {"smoothing": 0.3}),
    ("soft_target_cross_entropy", {"weight": "classes", "ret_mean": False}),
]


@pytest.mark.parametrize("C", [2, 4])
@pytest.mark.parametrize("fn_name,kws", LOSS_CASES,
                         ids=[f"{n}-{'-'.join(k) or 'default'}" for n, k in LOSS_CASES])
def test_losses_and_gradients_match(fn_name, kws, C):
    x, target = _logits(C, seed=C)
    rng = np.random.default_rng(11)
    shapes = {"classes": (C,), "rows": (x.shape[0],)}
    kws = {k: (rng.uniform(0.5, 2.0, shapes[v]).astype(np.float32) if v in shapes else v)
           for k, v in kws.items()}
    (jv, jg), (tv, tg) = _loss_pair(fn_name, x, target, **kws)
    assert abs(tv - jv) <= TOL_LOSS * max(1.0, abs(jv))
    np.testing.assert_allclose(tg, jg, atol=TOL_LOSS, rtol=0)


def test_soft_targets_match():
    """A target of x's shape is used as it is (soft labels)."""
    x, _t = _logits(3, seed=5)
    soft = np.random.default_rng(5).dirichlet(np.ones(3), size=x.shape[0]).astype(np.float32)
    for name in ("binary_cross_entropy", "soft_target_cross_entropy"):
        (jv, jg), (tv, tg) = _loss_pair(name, x, soft)
        assert abs(tv - jv) <= TOL_LOSS and np.abs(tg - jg).max() <= TOL_LOSS


def test_registry_matches():
    kws = {"loss_type": ["BCE", "CE", "LabelSmoothingCrossEntropy", "BinaryCrossEntropy"],
           "BCE": {"smoothing": 0.05, "target_thresh": 0.3, "weight": 2.0},
           "CE": {"smoothing": 0.2},
           "LabelSmoothingCrossEntropy": {"smoothing": 0.15, "weight": 0.5},
           "BinaryCrossEntropy": {}}
    jl, tl = jreg.load_loss("clf", **kws), treg.load_loss("clf", **kws)
    assert list(jl) == list(tl)
    x, t = _logits(3, seed=9)
    for name in tl:
        for ret_mean in (True, False):
            got = tl[name](torch.from_numpy(x), torch.from_numpy(t), ret_mean=ret_mean)
            want = jl[name](jnp.asarray(x), jnp.asarray(t), ret_mean=ret_mean)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL_LOSS, rtol=0)
    with pytest.raises(ValueError):
        treg.load_loss("clf", loss_type=["SurvIFMLE"])


# ---------------------------------------------------------------- evaluators

def _compare_metrics(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        if np.isnan(want[k]):
            assert np.isnan(got[k]), k
        else:
            assert abs(got[k] - want[k]) <= TOL_EVAL, (k, got[k], want[k])


def _binary(p, y):
    p = np.asarray(p, np.float32)
    return {"y": np.asarray(y, np.float32), "y_hat": np.stack([1 - p, p], 1)}


BINARY_CASES = {
    "ties": _binary([0.5, 0.5, 0.25, 0.75, 0.25, 0.75, 0.5, 0.5], [1, 0, 0, 1, 1, 0, 1, 0]),
    "one_class": _binary([0.1, 0.7, 0.3, 0.9], [1, 1, 1, 1]),
    "no_positive": _binary([0.1, 0.7, 0.3, 0.9], [0, 0, 0, 0]),
    "zero_and_one": _binary([0.0, 1.0, 1.0, 0.0, 0.3, 1.0], [0, 1, 0, 0, 1, 1]),
    "random": _binary(np.random.default_rng(2).random(57), np.random.default_rng(3).random(57) < 0.4),
}


@pytest.mark.parametrize("case", list(BINARY_CASES))
def test_binary_evaluator_matches_sklearn(case):
    data = BINARY_CASES[case]
    metrics = JaxBin().valid_metrics
    with np.errstate(invalid="ignore"), pytest.warns() if case in ("one_class", "no_positive") \
            else contextlib.nullcontext():
        want = JaxBin().compute(data, metrics)
    got = load_evaluator("clf", "Binary").compute(data, metrics)
    _compare_metrics(got, want)
    if case in ("one_class", "no_positive"):
        assert np.isnan(got["auc"])


def _multi(y, C, seed=0, quantize=False):
    rng = np.random.default_rng(seed)
    lo = rng.normal(size=(len(y), C))
    p = np.exp(lo) / np.exp(lo).sum(1, keepdims=True)
    if quantize:  # ties between rows
        p = np.round(p * 4) / 4
        p /= p.sum(1, keepdims=True)
    return {"y": np.asarray(y), "y_hat": p.astype(np.float32)}


MULTI_CASES = {
    "all_present": _multi([0, 1, 2, 2, 1, 0, 2, 1, 0, 1], 3),
    "ties": _multi([0, 1, 2, 2, 1, 0, 2, 1, 0, 1, 2, 0], 3, seed=1, quantize=True),
    "absent_class": _multi([0, 1, 1, 0, 1, 0], 3, seed=2),
    "one_class": _multi([2, 2, 2, 2], 4, seed=3),
    "two_columns": _multi([0, 1, 1, 0], 2, seed=4),
    "four_classes": _multi(np.random.default_rng(5).integers(0, 4, 40), 4, seed=5),
}


@pytest.mark.parametrize("case", list(MULTI_CASES))
def test_multiclass_evaluator_matches_sklearn(case):
    data = MULTI_CASES[case]
    metrics = JaxMulti().valid_metrics
    want = JaxMulti().compute(data, metrics)
    got = load_evaluator("clf", "Multi-class").compute(data, metrics)
    _compare_metrics(got, want)
    if case in ("absent_class", "one_class", "two_columns"):
        assert np.isnan(got["auc"])


# ---------------------------------------------------------------- the dataset

def _write_slides(root, n=6, D=8):
    rng = np.random.default_rng(0)
    table = os.path.join(root, "table.csv")
    with open(table, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["patient_id", "pathology_id", "label"])
        for i in range(n):
            w.writerow([f"p{i}", f"s{i}", i % 3])
    for sub in ("orig", "augA", "augB"):
        os.makedirs(os.path.join(root, sub, "feats"))
        for i in range(n):
            feats = rng.normal(size=(12 + i, D)).astype(np.float32)
            np.save(os.path.join(root, sub, "feats", f"s{i}.npy"), feats)
    return table, os.path.join(root, "orig", "feats")


def test_dataset_draws_match_global_numpy(tmp_path):
    """vlsa_tpu draws from numpy's global generator, the port from a
    RandomState seeded alike: the same labels, path switches and masks."""
    table, feats = _write_slides(str(tmp_path))
    pids = [f"p{i}" for i in range(6)][::-1]
    kws = dict(read_format="npy", aug_path_choices=["augA", "augB"], ratio_mask=0.4)
    ref = jrun.ClfBagDataset(pids, feats, table, **kws)
    port = prun.ClfBagDataset(pids, feats, table, np.random.RandomState(7), **kws)
    assert port.sids == ref.sids == [f"s{i}" for i in range(6)]  # the table's order
    assert port.bag_paths(0) is None  # items draw: the numpy path
    np.random.seed(7)
    ref.corrupt_labels(0.5)
    port.corrupt_labels(0.5)
    assert port.new_sid2label == ref.new_sid2label
    for _ in range(3):
        for i in range(len(ref)):
            _idx, (want, _z), want_label = ref[i]
            got, got_label = port[i]
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got_label, want_label)
    ref.resume_labels()
    port.resume_labels()
    np.testing.assert_array_equal(port[0][1], ref[0][2])


@pytest.mark.parametrize("mask_way", ["mask_zero", "discard"])
@pytest.mark.parametrize("scale", [1, 2])
def test_random_mask_instance_matches(mask_way, scale):
    bag = np.random.default_rng(1).normal(size=(36, 5)).astype(np.float32)
    np.random.seed(3)
    want = [jrun.random_mask_instance(bag, r, scale=scale, mask_way=mask_way)
            for r in (0.3, 0.9, 1.0, 0.0)]
    rng = np.random.RandomState(3)
    got = [prun.random_mask_instance(bag, r, rng, scale=scale, mask_way=mask_way)
           for r in (0.3, 0.9, 1.0, 0.0)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_native_paths_without_draws(tmp_path):
    table, feats = _write_slides(str(tmp_path))
    ds = prun.ClfBagDataset(["p1", "p4"], feats, table, np.random.RandomState(0),
                            read_format="npy")
    assert ds.bag_paths(1) == [os.path.join(feats, "s4.npy")]
    np.testing.assert_array_equal(ds.bag_label(1), [1.0, 0.0])
    np.testing.assert_array_equal(ds[1][0], np.load(os.path.join(feats, "s4.npy")))


@pytest.mark.parametrize("binary", [True, False])
def test_prediction_csv_matches(tmp_path, binary):
    rng = np.random.default_rng(4)
    C = 2 if binary else 3
    y = rng.integers(0, C, 9).astype(np.float32 if binary else np.int64)
    lo = rng.normal(size=(9, C))
    p = (np.exp(lo) / np.exp(lo).sum(1, keepdims=True)).astype(np.float32)
    p[0] = [1.0] + [0.0] * (C - 1)
    uids = [f"S{i}" for i in range(9)]
    jax_save_prediction_clf(uids, y, p, str(tmp_path / "a.csv"), binary=binary)
    save_prediction_clf(uids, y, p, str(tmp_path / "b.csv"), binary=binary)
    assert (tmp_path / "a.csv").read_bytes() == (tmp_path / "b.csv").read_bytes()
    back = read_prediction_clf(str(tmp_path / "b.csv"))
    assert back["uid"] == uids
    np.testing.assert_array_equal(back["y"], y.astype(np.float32))
    np.testing.assert_array_equal(back["y_hat"][:, -1], p[:, -1])


# ---------------------------------------------------------------- the handler

def make_cohort(root, n=40, seed=9, classes=2):
    """tests/test_clf_e2e.py's cohort (labels from its generator), written
    with csv: 28 training and 12 validation patients."""
    rng = np.random.default_rng(seed)
    pids = [f"P{i:03d}" for i in range(n)]
    table, split = os.path.join(root, "clf.csv"), os.path.join(root, "splits.csv")
    with open(table, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["patient_id", "pathology_id", "label"])
        for pid in pids:
            label = int(rng.random() < 0.5) if classes == 2 else int(rng.integers(0, classes))
            w.writerow([pid, pid + "-s", label])
    with open(split, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["", "train", "val"])
        for i in range(28):
            w.writerow([i, pids[i], pids[28 + i] if 28 + i < n else ""])
    return table, split


def clf_cfg(table, split, save_path, **overrides):
    cfg = {"task": "clf", "seed": 1, "save_path": str(save_path), "save_prediction": True,
           "ckpt_for_eval": "last", "num_shot": -1, "dataset_name": "tcga_test",
           "path_patch": "synthetic://N=64,D=32,seed=5", "path_table": table,
           "data_mode": "patch", "feat_format": "pt", "data_split_path": split,
           "data_split_seed": 0, "arch": "DeepMIL", "init_wt": False,
           "net_output_converter": "softmax", "net_dims": "32-16-2",
           "deepmil_network": "ABMIL", "deepmil_use_feat_proj": False,
           "loss_type": "CE", "loss_ce_smoothing": 0.1, "evaluator": "Binary",
           "opt_name": "adam", "opt_lr": 0.001, "opt_weight_decay": 0.0, "epochs": 2,
           "batch_size": 1, "bp_every_batch": 8, "es": False, "lrs": False, "test": False,
           "min_bucket": 64, "monitor_metrics": "loss"}
    cfg.update(overrides)
    return cfg


@contextlib.contextmanager
def jax_abmil_interpret():
    old = jax_abmil.INTERPRET, jax_abmil.abmil_pool
    jax_abmil.INTERPRET = True
    jax_abmil.abmil_pool = functools.partial(old[1], use_pallas=True)
    try:
        yield
    finally:
        jax_abmil.INTERPRET, jax_abmil.abmil_pool = old


KINDS = {"binary": {},
         "multi": {"net_dims": "32-16-3", "evaluator": "Multi-class",
                   "loss_type": "LabelSmoothingCrossEntropy",
                   "loss_labelsmoothingcrossentropy_smoothing": 0.1}}


@pytest.fixture(scope="module", params=list(KINDS))
def runs(request, tmp_path_factory):
    kind = request.param
    root = tmp_path_factory.mktemp(f"clf_{kind}")
    table, split = make_cohort(str(root), classes=2 if kind == "binary" else 3)
    with jax_abmil_interpret():
        handler = JaxCLFHandler(clf_cfg(table, split, root / "jax", **KINDS[kind]))
        init = state_dict_from_jax(jax.tree.map(np.asarray, dict(handler.params)))
        jax_metrics = handler.exec()
    port = CLFHandler(clf_cfg(table, split, root / "port", **KINDS[kind]), device="cpu",
                      state_dict=init)
    return kind, (jax_metrics, str(root / "jax")), (port, port.exec(), str(root / "port"))


def _events(path):
    with open(os.path.join(path, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], [r[0] for r in rows[1:]], np.array([[float(x) for x in r[1:]]
                                                        for r in rows[1:]])


def test_every_metric_of_every_epoch_matches_jax(runs):
    kind, (jax_metrics, jax_path), (handler, metrics, path) = runs
    want, got = _events(jax_path), _events(path)
    assert [e["event"] for e in got] == [e["event"] for e in want]
    n = 0
    for w, g in zip(want, got):
        assert g.keys() == w.keys()
        if w["event"] != "eval":
            continue
        for k, v in w.items():
            if k in ("event", "at", "ts"):
                continue
            n += 1
            assert abs(g[k] - v) <= TOL_METRIC, (k, g[k], v)
    # train and validation in each of 2 epochs, then the final 2 passes
    assert n == 6 * len(handler.metrics_list)
    assert len(handler.metrics_list) == (10 if kind == "binary" else 5)
    for split, rows in jax_metrics.items():
        for name, v in rows:
            assert abs(dict(metrics[split])[name] - v) <= TOL_METRIC, (split, name)


def test_prediction_csvs_match_jax(runs):
    kind, (_jm, jax_path), (_h, _m, path) = runs
    names = sorted(p for p in os.listdir(jax_path) if p.endswith(".csv"))
    assert names == sorted(p for p in os.listdir(path) if p.endswith(".csv")) == \
        ["clf_train_last_pred_test.csv", "clf_train_last_pred_train.csv"]
    for name in names:
        h_want, ids_want, want = _csv(os.path.join(jax_path, name))
        h_got, ids_got, got = _csv(os.path.join(path, name))
        assert h_got == h_want and ids_got == ids_want
        np.testing.assert_array_equal(got[:, 0], want[:, 0])
        assert np.abs(got[:, 1:] - want[:, 1:]).max() <= TOL_PRED


def test_no_prediction_pair_is_near_a_flip(runs):
    """The threshold metrics cannot count a prediction on another side in
    one package than in the other: on every split's final predictions, the
    gaps that decide them (binary: between any two P(1), and from P(1) to
    0.5; multi-class: each row's two largest probabilities) are at least
    MARGIN times the packages' largest difference."""
    kind, (_jm, jax_path), (_h, _m, path) = runs
    for split in ("train", "test"):
        _h, _ids, want = _csv(os.path.join(jax_path, f"clf_train_last_pred_{split}.csv"))
        _h, _ids, got = _csv(os.path.join(path, f"clf_train_last_pred_{split}.csv"))
        noise = np.abs(got[:, 1:] - want[:, 1:]).max()
        if kind == "binary":
            p = want[:, 1]
            gaps = np.concatenate([np.diff(np.sort(p)), np.abs(p - 0.5)])
        else:
            top2 = np.sort(want[:, 1:], axis=1)[:, -2:]
            gaps = top2[:, 1] - top2[:, 0]
        assert gaps.min() >= MARGIN * noise, (split, gaps.min(), noise)


def test_metrics_from_the_csv_equal_the_run(runs):
    """The port's evaluator on a run's own prediction CSV gives the metrics
    the run reported, exactly (the CSV keeps the float32 values)."""
    kind, _jax, (handler, _metrics, path) = runs
    last = [e for e in _events(path) if e["event"] == "eval"][-1]
    data = read_prediction_clf(os.path.join(path, "clf_train_last_pred_test.csv"))
    got = handler.evaluator.compute(data, handler.metrics_list)
    for k, v in got.items():
        want = last[f"lastckpt/train/test/pred/{k}"]
        assert v == want or (np.isnan(v) and np.isnan(want)), k


def test_main_runs_clf_on_the_cpu(tmp_path):
    table, split = make_cohort(str(tmp_path))
    cfg = clf_cfg(table, split, tmp_path / "run", epochs=1)
    path = str(tmp_path / "cfg.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    metrics = port_main.main(["--config", path, "--handler", "CLF", "--device", "cpu"])
    assert set(metrics) == {"train", "test"}
    assert 0.0 <= dict(metrics["test"])["pred_auc"] <= 1.0
    assert os.path.exists(str(tmp_path / "run" / "clf_train_last_pred_test.csv"))


def test_train_cli_takes_clf_steps_on_the_cpu(tmp_path, capsys):
    from vlsa_tpu_torch.runner import train as train_cli
    table, split = make_cohort(str(tmp_path))
    path = str(tmp_path / "cfg.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(clf_cfg(table, split, tmp_path / "run"), f)
    summary = train_cli.main(["--config", path, "--steps", "2", "--device", "cpu"])
    assert summary["steps"] == 2 and summary["num_bins"] is None
    assert summary["train_bags"] == 28


def test_serve_cli_answers_clf_requests_on_the_cpu(tmp_path):
    from vlsa_tpu_torch.runner import serve as serve_cli
    table, split = make_cohort(str(tmp_path))
    path = str(tmp_path / "cfg.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(clf_cfg(table, split, tmp_path / "run", net_dims="32-16-3"), f)
    summary = serve_cli.main(["--config", path, "--n_requests", "2", "--bags_per_request", "3",
                              "--device", "cpu"])
    assert summary["requests"] == 2 and sum(summary["abmil_launches"].values()) == 0


def test_handler_refuses_other_tasks_and_evaluators(tmp_path):
    table, split = make_cohort(str(tmp_path))
    with pytest.raises(ValueError, match="Expected task = `clf`"):
        CLFHandler(clf_cfg(table, split, tmp_path / "a", task="sa"), device="cpu")
    with pytest.raises(ValueError, match="Binary or Multi-class"):
        CLFHandler(clf_cfg(table, split, tmp_path / "b", evaluator="NLL"), device="cpu")
