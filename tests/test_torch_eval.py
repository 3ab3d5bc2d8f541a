"""The survival evaluator: each module of vlsa_tpu_torch/eval against its
vlsa_tpu original on the same draws (survival curves, times, events and a
training cohort, made with numpy from a seed).

Tolerances: 1e-10 relative for the numpy metrics (the same float64
arithmetic on both sides); 1e-6 for the losses that the evaluators compute
again (f32 torch against f32 JAX).  A split without comparable pairs raises
NoComparablePairException in both packages.
"""
import csv

import numpy as np
import pytest

import vlsa_tpu.eval as J
import vlsa_tpu_torch.eval as P
from vlsa_tpu.data.label_converter import MetaSurvData as JaxMeta
from vlsa_tpu.eval.concordance import NoComparablePairException as JaxNoPair
from vlsa_tpu.losses import load_loss as jax_load_loss
from vlsa_tpu_torch.data.label_converter import MetaSurvData
from vlsa_tpu_torch.losses import load_loss

RTOL = 1e-10
RTOL_LOSS = 1e-6
K = 6


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=0)


def _draw(n, seed, event_rate=0.65):
    rng = np.random.default_rng(seed)
    t = np.round(rng.uniform(1.0, 100.0, n), 2)
    t[: n // 8] = t[n // 8: 2 * (n // 8)]  # tied times
    e = (rng.random(n) < event_rate).astype(np.int64)
    return t, e


def _curves(n, seed):
    """Non-increasing survival curves over K time coordinates."""
    rng = np.random.default_rng(seed)
    inc = rng.dirichlet(np.ones(K + 1), size=n)[:, :K]
    return 1.0 - np.cumsum(inc, axis=1), inc


@pytest.fixture(scope="module")
def cohort():
    t_train, e_train = _draw(60, 1)
    t_test, e_test = _draw(30, 2)
    surv, inc = _curves(30, 3)
    coords = np.linspace(0.0, 95.0, K)
    return dict(t_train=t_train, e_train=e_train, t=t_test, e=e_test, surv=surv,
                inc=inc, coords=coords)


def test_kaplan_meier(cohort):
    c = cohort
    x = np.linspace(0, 110, 57)
    for cls in ("KaplanMeier", "KaplanMeierArea"):
        a, b = getattr(P, cls)(c["t_train"], c["e_train"]), getattr(J, cls)(c["t_train"],
                                                                              c["e_train"])
        _close(a.predict(x), b.predict(x))
        _close(a.survival_probabilities, b.survival_probabilities)
        _close(a.survival_times, b.survival_times)
    a = P.KaplanMeierArea(c["t_train"], c["e_train"])
    b = J.KaplanMeierArea(c["t_train"], c["e_train"])
    _close(a.area, b.area)
    _close(a.km_linear_zero, b.km_linear_zero)
    _close(a.best_guess(c["t"][c["e"] == 0]), b.best_guess(c["t"][c["e"] == 0]))


def test_breslow(cohort):
    c = cohort
    lp = np.random.default_rng(4).normal(size=len(c["t_train"]))
    a = P.BreslowEstimator().fit(lp, c["e_train"], c["t_train"])
    b = J.BreslowEstimator().fit(lp, c["e_train"], c["t_train"])
    ta, sa = a.get_survival_function(lp[:9], ret_ndarray=True)
    tb, sb = b.get_survival_function(lp[:9], ret_ndarray=True)
    _close(ta, tb)
    _close(sa, sb)
    x = np.linspace(a.unique_times_[0], a.unique_times_[-1], 11)
    _close(a.get_cumulative_hazard_function(lp[:3])[1](x),
           b.get_cumulative_hazard_function(lp[:3])[1](x))


@pytest.mark.parametrize("pair_method", ["Comparable", "Margin"])
@pytest.mark.parametrize("ties", ["None", "Risk", "Time", "All"])
def test_concordance(cohort, ties, pair_method):
    c = cohort
    pred = np.array([P.predict_mean_survival_time(s, c["coords"]) for s in c["surv"]])
    pred_j = np.array([J.predict_mean_survival_time(s, c["coords"]) for s in c["surv"]])
    _close(pred, pred_j)
    pred[3] = pred[4]  # a tied prediction
    args = (pred, c["t"], c["e"].astype(bool), c["t_train"], c["e_train"], pair_method, ties)
    _close(P.concordance(*args), J.concordance(*args))


@pytest.mark.parametrize("type_pred", ["hazard", "incidence", "hazard_ratio"])
def test_concordance_index(cohort, type_pred):
    c = cohort
    y = np.stack([c["t"], c["e"]], 1)
    y_pred = (c["inc"] if type_pred == "incidence" else
              np.random.default_rng(5).uniform(0.05, 0.6, (30, 1 if type_pred == "hazard_ratio"
                                                              else K)))
    _close(P.concordance_index(y, y_pred, type_pred=type_pred),
           J.concordance_index(y, y_pred, type_pred=type_pred))


def test_no_comparable_pair_raises_in_both():
    y = np.array([[5.0, 0.0], [3.0, 1.0], [2.0, 0.0]])  # the event's time is no one's before
    y[1, 0] = 9.0
    pred = np.array([[0.2], [0.1], [0.3]])
    for mod, exc in ((P, P.NoComparablePairException), (J, JaxNoPair)):
        with pytest.raises(exc):
            mod.concordance_index(y, pred, type_pred="hazard_ratio")
        with pytest.raises(exc):
            mod.concordance(-pred[:, 0], y[:, 0], y[:, 1].astype(bool))


@pytest.mark.parametrize("ipcw", [True, False])
def test_brier_and_ibs(cohort, ipcw):
    c = cohort
    evals = [mod.SurvivalEvaluator(c["surv"], c["coords"], c["t"], c["e"], c["t_train"],
                                   c["e_train"]) for mod in (P, J)]
    _close(evals[0].brier_score(target_time=40.0, IPCW_weighted=ipcw),
           evals[1].brier_score(target_time=40.0, IPCW_weighted=ipcw))
    _close(evals[0].integrated_brier_score(IPCW_weighted=ipcw),
           evals[1].integrated_brier_score(IPCW_weighted=ipcw))
    _close(evals[0].integrated_brier_score(num_points=17, IPCW_weighted=ipcw),
           evals[1].integrated_brier_score(num_points=17, IPCW_weighted=ipcw))
    probs = evals[1].predict_multi_probabilities_from_curve(np.linspace(0, 90, 7))
    args = (probs, c["t"], c["e"], c["t_train"], c["e_train"], np.linspace(0, 90, 7), ipcw)
    _close(P.brier_multiple_points(*args), J.brier_multiple_points(*args))


@pytest.mark.parametrize("method", ["Uncensored", "Hinge", "Margin", "IPCW-v1", "IPCW-v2",
                                    "Pseudo_obs", "Pseudo_obs_pop"])
def test_mean_error(cohort, method):
    c = cohort
    pred = np.array([J.predict_mean_survival_time(s, c["coords"]) for s in c["surv"]])
    for error_type, weighted, log_scale in (("absolute", True, False),
                                            ("squared", False, True)):
        args = (pred, c["t"], c["e"], c["t_train"], c["e_train"], error_type, method,
                weighted, log_scale)
        _close(P.mean_error(*args), J.mean_error(*args))


def test_d_calibration_and_survival_evaluator_readouts(cohort):
    c = cohort
    a, b = (mod.SurvivalEvaluator(c["surv"], c["coords"], c["t"], c["e"], c["t_train"],
                                  c["e_train"]) for mod in (P, J))
    probs = b.predict_probability_from_curve(c["t"])
    pa, ha = P.d_calibration(probs, c["e"])
    pb, hb = J.d_calibration(probs, c["e"])
    _close(pa, pb)
    _close(ha, hb)
    _close(a.predicted_event_times, b.predicted_event_times)
    _close(a.d_calibration()[0], b.d_calibration()[0])
    _close(a.mae(method="Hinge"), b.mae(method="Hinge"))
    _close(a.concordance(ties="All")[0], b.concordance(ties="All")[0])
    _close(a.auc(), b.auc())
    _close(a.km_calibration(), b.km_calibration())
    _close(a.one_calibration()[0], b.one_calibration()[0])
    # the setters drop the cached event times in both
    a.predicted_curves = b.predicted_curves = c["surv"][::-1]
    _close(a.predicted_event_times, b.predicted_event_times)
    a.time_coordinates = b.time_coordinates = c["coords"] * 1.5
    _close(a.predicted_event_times, b.predicted_event_times)


# ---------------------------------------------------------------- evaluators

@pytest.fixture(scope="module")
def metas(tmp_path_factory):
    """Both packages' label tables of one cohort (some patients with two
    slides), with discrete labels from the training split."""
    d = tmp_path_factory.mktemp("eval_meta")
    t, e = _draw(40, 7)
    pids = [f"P{i:03d}" for i in range(40)]
    path = d / "survival.csv"
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["pathology_id", "patient_id", "e", "t"])
        for i, pid in enumerate(pids):
            w.writerow([pid + "-a", pid, e[i], t[i]])
            if i % 5 == 0:  # a second slide whose row must not be read
                w.writerow([pid + "-b", pid, 1 - e[i], t[i] + 1])
    split = {"train": pids[:28], "test": pids[28:]}
    out = []
    for cls in (MetaSurvData, JaxMeta):
        meta = cls(str(path), data_split=split)
        meta.generate_discrete_label(num_bins=K, use_quantiles=False)
        out.append(meta)
    return out, pids, split


def test_patient_data_is_the_first_row_in_pid_order(metas):
    (pm, jm), pids, split = metas
    order = pids[35:20:-1] + ["absent"]
    got = pm.get_patient_data(pids=order, ret_columns=["patient_id", "t", "e"])
    want = jm.get_patient_data(pids=order, ret_columns=["patient_id", "t", "e"])
    assert list(got["patient_id"]) == list(want["patient_id"])
    _close(got["t"], want["t"].values)
    np.testing.assert_array_equal(got["e"], want["e"].values)
    _close(pm.time_coordinates, jm.time_coordinates)
    got = pm.get_patient_data(split="test", ret_columns=["t", "y_t"])
    want = jm.get_patient_data(split="test", ret_columns=["t", "y_t"])
    np.testing.assert_array_equal(got["y_t"], want["y_t"].values)


def _cltor(meta_pids, seed, y_hat, name="test"):
    rng = np.random.default_rng(seed)
    n = len(meta_pids)
    y = np.stack([rng.integers(0, K, n), (rng.random(n) < 0.65)], 1).astype(np.float32)
    return {"y": y, "y_hat": y_hat.astype(np.float32),
            "raw_y_hat": np.log(np.clip(y_hat, 1e-6, None)).astype(np.float32),
            "uid": list(meta_pids), "name": name}


def _compare(res_p, res_j, loss_keys):
    assert res_p.keys() == res_j.keys()
    for k in res_p:
        _close(res_p[k], res_j[k], RTOL_LOSS if k.startswith("loss") else RTOL)
    assert set(loss_keys) <= set(res_p)


@pytest.mark.parametrize("task,name", [("sa", "NLL"), ("sa", "NLL-IF"), ("vlsa", "VL"),
                                       ("vlsa", "VL-IF")])
def test_nll_evaluator_with_losses_computed_again(metas, task, name):
    (pm, jm), _pids, split = metas
    incidence = name.endswith("IF")
    rng = np.random.default_rng(9)
    logits = rng.normal(size=(len(split["test"]), K))
    y_hat = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True) if incidence
             else 1.0 / (1.0 + np.exp(-logits)))
    data = _cltor(split["test"], 10, y_hat)
    ev_p, ev_j = P.load_evaluator(task, name, meta_data=pm), J.load_evaluator(task, name,
                                                                              meta_data=jm)
    assert ev_p.valid_metrics == ev_j.valid_metrics
    main = "SurvIFMLE" if incidence else "SurvMLE"
    kws = {"loss_type": [main, "SurvEMD"], main: {"alpha": 0.1}, "SurvEMD": {"p": 2}}
    ext = dict(loss_weight={main: 1.0, "SurvEMD": 0.5}, logit_scale=14.3)
    res_p = ev_p.compute(data, ev_p.valid_metrics, kws_ext_loss=load_loss(task, **kws), **ext)
    res_j = ev_j.compute(data, ev_j.valid_metrics, kws_ext_loss=jax_load_loss(task, **kws),
                         **ext)
    _compare(res_p, res_j, ["loss", f"loss_{main}", "loss_SurvEMD"])


def test_cox_evaluator(metas):
    (pm, jm), _pids, split = metas
    rng = np.random.default_rng(11)
    ev_p, ev_j = P.load_evaluator("sa", "Cox", meta_data=pm), J.load_evaluator(
        "sa", "Cox", meta_data=jm)
    for name, pids in (("train", split["train"]), ("test", split["test"])):
        data = _cltor(pids, 12, rng.normal(size=(len(pids), 1)), name=name)
        _compare(ev_p.compute(data, ev_p.valid_metrics), ev_j.compute(data, ev_j.valid_metrics),
                 ["loss_ple"])


def test_reg_evaluator(metas):
    (pm, _jm), _pids, split = metas
    rng = np.random.default_rng(13)
    data = _cltor(split["test"], 14, rng.uniform(0, K, (len(split["test"]), 1)))
    ev_p, ev_j = (mod.load_evaluator("sa", "Reg", end_time=pm.max_t) for mod in (P, J))
    _compare(ev_p.compute(data, ev_p.valid_metrics), ev_j.compute(data, ev_j.valid_metrics),
             ["loss_rank", "loss_recon"])


def test_clf_evaluators_are_refused():
    """The classification evaluators are ported (tests/test_torch_clf.py holds
    them); only names the registry does not know are refused."""
    assert type(P.load_evaluator("clf", "Binary")).__name__ == "BinClfEvaluator"
    assert type(P.load_evaluator("clf", "Multi-class")).__name__ == "MultiClfEvaluator"
    with pytest.raises(KeyError):
        P.load_evaluator("clf", "VL")
    with pytest.raises(ValueError):
        P.load_evaluator("sa", "VL")
