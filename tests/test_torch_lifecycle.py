"""The run lifecycle end to end: vlsa_tpu's VLSAHandler and SAHandler and
the port's, from the same initial weights, each training 2 epochs and
evaluating every split each epoch and at the end (`exec()`).

The cohort: 36 synthetic patients (event rate ~0.65) split 21 / 7 / 8 into
train, validation and test columns, bags `synthetic://N=96,D=64,seed=3`, a
small f32 text tower.  `lrs: True` with `lrs_patience: 0` and `es` on, with
the validation loss as the monitor.  Each kind's cohort seed (COHORT_SEED)
is one whose validation loss rises in the second epoch, so both packages
halve the rate there, write it into their optimizer state and count one
epoch without improvement; and one whose final predictions leave no
comparable pair within 1e-4, so that the C-indices' agreement is a test.  vlsa_tpu's SA handler runs its
ABMIL kernels in interpret mode, as tests/test_torch_sa_train.py does (its
plain pooling gives fc2_bias a rounding-noise gradient that Adam turns into
+-lr steps).  The port runs on the CPU, on its plain versions.

Tolerances: every metric of each epoch's metrics.jsonl events and of
metrics-last.txt within 1e-4 (f32 on both sides, summed in another order),
the C-indices equal, with no comparable pair closer than 1e-4 in either
estimate the C-indices rank by (so no pair can flip); prediction CSVs within
1e-5; the last checkpoint's tensors within 1e-5 of vlsa_tpu's msgpack
checkpoint, over the same filtered key set.
"""
import contextlib
import csv
import functools
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

import vlsa_tpu.ops.abmil as jax_abmil
from test_runner_e2e import base_cfg, vlsa_cfg
from vlsa_tpu.runner import SAHandler as JaxSAHandler
from vlsa_tpu.runner import VLSAHandler as JaxVLSAHandler
from vlsa_tpu.runner.ckpt import load_checkpoint as jax_load_checkpoint
from vlsa_tpu_torch import main as port_main
from vlsa_tpu_torch.eval import predict_mean_survival_time
from vlsa_tpu_torch.runner.ckpt import load_checkpoint
from vlsa_tpu_torch.runner.sa import SAHandler
from vlsa_tpu_torch.runner.vlsa import VLSAHandler
from vlsa_tpu_torch.utils.weights import _flatten, jax_tree_from_state_dict, state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_METRIC = 1e-4
TOL_PRED = 1e-5
TOL_CKPT = 1e-5
MIN_PAIR_GAP = 1e-4
N_PATIENTS = 36
SPLIT_SIZES = (21, 7, 8)
COHORT_SEED = {"vlsa": 11, "sa": 20}


def write_cohort(root, n=N_PATIENTS, seed=11, event_rate=0.65, folds=(0,)):
    """survival.csv (one slide a patient) and splits_<fold>.csv with train,
    val and test columns; returns their paths (`{2}` for the fold)."""
    rng = np.random.default_rng(seed)
    pids = [f"P{i:03d}" for i in range(n)]
    with open(os.path.join(root, "survival.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["pathology_id", "patient_id", "e", "t"])
        for pid in pids:
            w.writerow([pid + "-slide", pid, int(rng.random() < event_rate),
                        round(float(rng.uniform(2, 90)), 2)])
    for fold in folds:
        order = list(np.random.default_rng(fold).permutation(pids)) if fold else pids
        a, b = SPLIT_SIZES[0], SPLIT_SIZES[0] + SPLIT_SIZES[1]
        cols = [order[:a], order[a:b], order[b:]]
        with open(os.path.join(root, f"splits_{fold}.csv"), "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["", "train", "val", "test"])
            for i in range(max(map(len, cols))):
                w.writerow([i] + [c[i] if i < len(c) else "" for c in cols])
    return os.path.join(root, "survival.csv"), os.path.join(root, "splits_{2}.csv")


def lifecycle_cfg(kind, root, table, split, save_path, **overrides):
    """A small flagship VLSA or SA baseline config of the lifecycle runs."""
    make = vlsa_cfg if kind == "vlsa" else base_cfg
    cfg = make(root, table, split.replace("{2}", "0"))
    cfg.update(save_path=str(save_path), lrs=True, lrs_patience=0, es=True, es_patience=5,
               monitor_metrics="loss")
    if kind == "vlsa":
        cfg["_test_tower_overrides"] = dict(cfg["_test_tower_overrides"], dtype="float32")
    cfg.update(overrides)
    return cfg


@contextlib.contextmanager
def jax_abmil_interpret():
    """vlsa_tpu's ABMIL Pallas kernels in interpret mode, at trace time."""
    old = jax_abmil.INTERPRET, jax_abmil.abmil_pool
    jax_abmil.INTERPRET = True
    jax_abmil.abmil_pool = functools.partial(old[1], use_pallas=True)
    try:
        yield
    finally:
        jax_abmil.INTERPRET, jax_abmil.abmil_pool = old


def jax_initial_state(handler) -> dict:
    return state_dict_from_jax(jax.tree.map(np.asarray, dict(handler.params)))


def run_pair(kind, tmp_path_factory):
    """Both packages' handlers on one cohort: {"jax"/"port": (handler,
    metrics, save path)}."""
    root = tmp_path_factory.mktemp(f"lifecycle_{kind}")
    table, split = write_cohort(str(root), seed=COHORT_SEED[kind])
    out = {}
    cfg = lifecycle_cfg(kind, root, table, split, root / "jax")
    with jax_abmil_interpret() if kind == "sa" else contextlib.nullcontext():
        handler = (JaxVLSAHandler if kind == "vlsa" else JaxSAHandler)(cfg)
        init = jax_initial_state(handler)
        out["jax"] = (handler, handler.exec(), cfg["save_path"])
    cfg = lifecycle_cfg(kind, root, table, split, root / "port")
    handler = (VLSAHandler if kind == "vlsa" else SAHandler)(cfg, device="cpu", state_dict=init)
    out["port"] = (handler, handler.exec(), cfg["save_path"])
    return out


@pytest.fixture(scope="module")
def vlsa_pair(tmp_path_factory):
    return run_pair("vlsa", tmp_path_factory)


@pytest.fixture(scope="module")
def sa_pair(tmp_path_factory):
    return run_pair("sa", tmp_path_factory)


@pytest.fixture(params=["vlsa", "sa"])
def pair(request):
    return request.param, request.getfixturevalue(f"{request.param}_pair")


def read_events(save_path):
    with open(os.path.join(save_path, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def read_metric_table(path):
    rows = {}
    with open(path) as f:
        for line in f:
            if "-->" in line:
                k, v = line.split("-->")
                rows[k.strip()] = float(v)
    return rows


def read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], [r[0] for r in rows[1:]], np.array([[float(x) for x in r[1:]]
                                                        for r in rows[1:]])


def comparable_pairs(t, e):
    """(i, j) with an event at t_i and t_j later, or censored at t_i (the
    pairs `_estimate_concordance_index` counts)."""
    t, e = np.asarray(t), np.asarray(e).astype(bool)
    return [(i, j) for i in np.flatnonzero(e) for j in range(len(t))
            if t[j] > t[i] or (t[j] == t[i] and not e[j])]


def test_every_metric_of_every_epoch_matches_jax(pair):
    kind, runs = pair
    jax_events, port_events = read_events(runs["jax"][2]), read_events(runs["port"][2])
    assert [e["event"] for e in port_events] == [e["event"] for e in jax_events]
    assert [e.get("epoch") for e in port_events] == [e.get("epoch") for e in jax_events]
    n_metrics = 0
    for want, got in zip(jax_events, port_events):
        assert got.keys() == want.keys()
        if want["event"] != "eval":
            continue
        assert got["at"] == want["at"]
        for k, v in want.items():
            if k in ("event", "at", "ts"):
                continue
            n_metrics += 1
            if k.endswith(("/c_index", "/c_index2")):
                assert got[k] == v, k
            assert abs(got[k] - v) <= TOL_METRIC, (k, got[k], v)
    # train, validation and test in each of 2 epochs, then the final 3 passes
    assert n_metrics == 9 * len(runs["port"][0].metrics_list + list(runs["port"][0].loss))
    for split, rows in runs["jax"][1].items():
        got = dict(runs["port"][1][split])
        for name, v in rows:
            assert abs(got[name] - v) <= TOL_METRIC, (split, name)
    want = read_metric_table(os.path.join(runs["jax"][2], "train_metrics-last.txt"))
    got = read_metric_table(os.path.join(runs["port"][2], "train_metrics-last.txt"))
    assert got.keys() == want.keys() and len(got) == 6
    for k in want:
        assert abs(got[k] - want[k]) <= TOL_METRIC, k


def test_no_comparable_pair_is_near_a_flip(pair):
    """The equal C-indices are not luck: on the final predictions of every
    split, each comparable pair's gap in risk (sum of the survival curve,
    c_index2) and in predicted mean survival time (c_index) is at least
    1e-4 and 10x the largest difference between the packages."""
    kind, runs = pair
    handler = runs["port"][0]
    coords = handler.data_meta.time_coordinates
    for split in ("train", "validation", "test"):
        name = f"{kind}_train_last_pred_{split}.csv"
        _h, _ids, want = read_csv(os.path.join(runs["jax"][2], name))
        _h, _ids, got = read_csv(os.path.join(runs["port"][2], name))
        t, e = want[:, 0], want[:, 1]
        actual = handler.data_meta.get_patient_data(pids=_ids, ret_columns=["t", "e"])
        pairs = comparable_pairs(t, e) + comparable_pairs(actual["t"], actual["e"])
        assert pairs
        for est in ((lambda m: m[:, 2]),
                    (lambda m: np.array([predict_mean_survival_time(s, coords)
                                         for s in m[:, 3:]]))):
            a, b = est(want), est(got)
            gap = min(abs(a[i] - a[j]) for i, j in pairs)
            assert gap >= max(MIN_PAIR_GAP, 10 * np.abs(a - b).max()), (split, gap)


def test_prediction_csvs_match_jax(pair):
    kind, runs = pair
    names = sorted(os.path.basename(p) for p in os.listdir(runs["jax"][2])
                   if p.endswith(".csv"))
    assert names == [f"{kind}_train_last_pred_{s}.csv" for s in ("test", "train", "validation")]
    for name in names:
        h_want, ids_want, want = read_csv(os.path.join(runs["jax"][2], name))
        h_got, ids_got, got = read_csv(os.path.join(runs["port"][2], name))
        assert h_got == h_want and ids_got == ids_want
        assert len(ids_got) == {"train": SPLIT_SIZES[0], "validation": SPLIT_SIZES[1],
                                "test": SPLIT_SIZES[2]}[name.split("_")[-1][:-4]]
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL_PRED, err_msg=name)
        assert np.all(np.diff(got[:, 3:], axis=1) <= 0), "a survival curve rises"


def test_run_writes_the_files_jax_writes(pair):
    _kind, runs = pair
    assert sorted(os.listdir(runs["port"][2])) == sorted(os.listdir(runs["jax"][2]))


def test_last_checkpoint_matches_jax(pair):
    kind, runs = pair
    want = jax_load_checkpoint(os.path.join(runs["jax"][2], "train_model-last.ckpt"))
    got = load_checkpoint(os.path.join(runs["port"][2], "train_model-last.ckpt"))
    assert got["epoch"] == want["epoch"] == 2
    a = {"/".join(k): v for k, v in _flatten(jax_tree_from_state_dict(got["model"]))}
    b = {"/".join(k): v for k, v in _flatten(want["model"])}
    assert set(a) == set(b)
    if kind == "vlsa":  # model_saver_module_filter: prompt_encoder
        assert not any(k.startswith("prompt_encoder/") for k in a)
        assert any(k.startswith("prompt_learner/") for k in a)
    for k in b:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=TOL_CKPT, err_msg=k)
    assert got["optimizer"]["state"], "Adam's moments were not saved"


def test_learning_rate_is_reduced_in_both(pair):
    _kind, runs = pair
    jax_handler, port_handler = runs["jax"][0], runs["port"][0]
    lr = jax_handler.cfg["opt_lr"] * jax_handler.cfg.get("lrs_factor", 0.5)
    assert float(jax_handler.opt_state.hyperparams["learning_rate"]) == pytest.approx(lr)
    assert port_handler.lr_value == jax_handler.lr_value == lr
    assert all(g["lr"] == lr for g in port_handler.optimizer.param_groups)
    ckpt = load_checkpoint(os.path.join(runs["port"][2], "train_model-last.ckpt"))
    assert all(g["lr"] == lr for g in ckpt["optimizer"]["param_groups"])
    assert port_handler.es.counter == jax_handler.es.counter == 1


def test_eval_pass_restores_train_mode_and_fresh_text(vlsa_pair):
    """An evaluation pass puts the model back in train mode, and computes
    the text prototypes from the current weights (a changed prompt learner
    changes the predictions)."""
    handler = vlsa_pair["port"][0]
    test_set = handler.trainer.dataset
    before = handler.test_model(test_set, "train")["pred"]["y_hat"]
    assert handler.model.training
    embeds = handler.model.prompt_learner.context_embeds
    saved = embeds.detach().clone()
    with torch.no_grad():
        embeds.add_(torch.randn(embeds.shape, generator=torch.Generator().manual_seed(0)))
    try:
        after = handler.test_model(test_set, "train")["pred"]["y_hat"]
    finally:
        with torch.no_grad():
            embeds.copy_(saved)
    assert handler.model.training
    assert np.abs(after - before).max() > 1e-4


def test_exec_test_evaluates_the_saved_run(sa_pair, tmp_path):
    """`test: True` evaluates `test_load_path`'s last checkpoint on the
    split `test_path` and gives the run's final metrics of that split (the
    tester's own seeded weights are all replaced: SA filters nothing)."""
    handler, metrics, save_path = sa_pair["port"]
    cfg = dict(handler.cfg, test=True, test_load_path=save_path, test_path="test",
               test_save_path=str(tmp_path / "exec-test"), save_prediction=True)
    tester = SAHandler(cfg, device="cpu")
    got = dict(tester.exec_test()["exec-test"])
    for name, v in metrics["test"]:
        assert got[name] == pytest.approx(v, abs=1e-6), name
    assert os.path.exists(tmp_path / "exec-test" / "sa_test_mode_last_pred_exec-test.csv")
    assert os.path.exists(tmp_path / "exec-test" / "test_mode_metrics-last.txt")


def write_small_config(tmp_path, kind, **overrides):
    table, split = write_cohort(str(tmp_path), folds=(0, 1))
    cfg = lifecycle_cfg(kind, tmp_path, table, split, tmp_path / "result", epochs=1, **overrides)
    cfg["data_split_path"] = split
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path), cfg


def jax_multi_run_paths(config):
    """The save paths main.py's multi_run gives a config's grid."""
    sys.path.insert(0, REPO)
    import main as jax_main
    paths = []

    class Recorder:
        def __init__(self, cfg):
            paths.append(cfg["save_path"])

        def exec(self):
            return {}

    with contextlib.redirect_stdout(None):
        jax_main.multi_run_main(Recorder, dict(config), sleep=0)
    return paths


def test_main_multi_run_writes_each_grid_run(tmp_path):
    path, cfg = write_small_config(tmp_path, "sa", data_split_seed=[0, 1], num_shot=[-1])
    runs = port_main.main(["--config", path, "--handler", "SA", "--multi_run",
                           "--device", "cpu"])
    assert len(runs) == 2 and all("test" in m for m in runs)
    want = jax_multi_run_paths(cfg)
    assert want == [cfg["save_path"] + "-fold_0", cfg["save_path"] + "-fold_1"]
    for p in want:
        assert os.path.exists(os.path.join(p, "train_model-last.ckpt"))
        assert os.path.exists(os.path.join(p, "sa_train_last_pred_test.csv"))
        assert os.path.exists(os.path.join(p, "train_metrics-last.txt"))


def test_main_runs_vlsa_and_refuses_clf(tmp_path):
    path, _cfg = write_small_config(tmp_path, "vlsa")
    metrics = port_main.main(["--config", path, "--handler", "VLSA", "--device", "cpu"])
    assert 0.0 <= dict(metrics["test"])["pred_c_index"] <= 1.0
    with pytest.raises(NotImplementedError, match="A.11"):
        port_main.main(["--config", path, "--handler", "CLF", "--device", "cpu"])


@pytest.mark.parametrize("key,value,item", [("vlsa_api", "CLIP", "A.15"),
                                            ("ckpt_backend", "orbax", "A.6"),
                                            ("mesh", {"data": 4}, "A.17")])
def test_unported_settings_are_refused(tmp_path, key, value, item):
    _path, cfg = write_small_config(tmp_path, "vlsa", **{key: value})
    with pytest.raises(NotImplementedError, match=item):
        VLSAHandler(cfg, device="cpu")


def test_main_runs_on_cuda_unless_told(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    path, _cfg = write_small_config(tmp_path, "sa")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main.main(["--config", path, "--handler", "SA"])
