"""Task-level survival evaluators and the registry of every task's
evaluators (counterpart of vlsa_tpu/eval/evaluators.py).

The NLL evaluator (hazard or incidence outputs: NLL, NLL-IF, VL, VL-IF), the
Cox evaluator (a Breslow baseline fitted on the training pass) and the
continuous-regression one, with the metric names of vlsa_tpu.  Inputs are
numpy arrays on the host; the losses computed again on the collected
predictions are the port's torch losses on CPU tensors (f32, as the JAX
package computes them).
"""
from __future__ import annotations

from functools import partial

import numpy as np
import torch

from ..losses import surv as _surv_losses
from .breslow import BreslowEstimator
from .clf_metrics import BinClfEvaluator, MultiClfEvaluator
from .concordance import concordance_index
from .survival_evaluator import SurvivalEvaluator


def _to_np(x):
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _tensor(x) -> torch.Tensor:
    """A CPU tensor of a host array (f32 for float arrays, as jnp makes them)."""
    t = torch.as_tensor(np.asarray(x))
    return t.float() if t.is_floating_point() else t


def _torch_loss(fn, *arrays, **kws) -> float:
    return float(fn(*(_tensor(a) for a in arrays), **kws))


def load_survival_eval(meta_data, time_coordinates=None, predict_time_method="Mean"):
    """A SurvivalEvaluator on the test split's labels, the training split's
    as its reference cohort."""
    if time_coordinates is None:
        time_coordinates = meta_data.time_coordinates
    train = meta_data.get_patient_data(split="train", ret_columns=["t", "e"])
    test = meta_data.get_patient_data(split="test", ret_columns=["t", "e"])
    temp = np.ones((1, len(time_coordinates)), dtype=np.float32)
    return SurvivalEvaluator(temp, time_coordinates, test["t"], test["e"],
                             train["t"], train["e"], predict_time_method=predict_time_method)


class NLLSurvEvaluator:
    """Evaluator of discrete models with hazard or incidence outputs."""

    def __init__(self, prediction_type: str, backend="SurvivalEVAL", **kws):
        assert prediction_type in ("hazard", "incidence")
        self.type = prediction_type
        self.kws = kws
        self.backend = backend
        self.meta_data = None
        self.aux_evaluator = None
        if backend == "SurvivalEVAL":
            assert "meta_data" in kws, "meta_data required for SurvivalEVAL backend."
            self.meta_data = kws["meta_data"]
            self.aux_evaluator = load_survival_eval(self.meta_data, predict_time_method="Mean")
            self.valid_functions = {
                "c_index": self._aux_c_index,
                "c_index2": self._c_index,
                "loss": self._loss_mle_org,
                "loss_mle": self._loss_mle,
                "loss_mle_org": self._loss_mle_org,
                "IBS": self._aux_ibs,
                "MAE": self._aux_mae,
                "D_calibration": self._aux_dcal,
            }
            self.valid_metrics = ["c_index", "loss", "loss_mle", "loss_mle_org",
                                  "IBS", "MAE", "D_calibration", "c_index2"]
        else:
            self.valid_functions = {
                "c_index": self._c_index,
                "loss": self._loss_mle_org,
                "loss_mle": self._loss_mle,
                "loss_mle_org": self._loss_mle_org,
            }
            self.valid_metrics = ["c_index", "loss", "loss_mle", "loss_mle_org"]

    def _pre_compute(self, data):
        self.y = _to_np(data["y"])
        self.t = self.y[:, 0]
        self.e = self.y[:, 1]
        self.y_hat = _to_np(data.get("avg_y_hat", data["y_hat"]))
        self.raw_y_hat = _to_np(data["raw_y_hat"]) if "raw_y_hat" in data else None
        cur_uid = data["uid"]

        if self.type == "incidence":
            surv = 1.0 - np.cumsum(self.y_hat, axis=1)
        else:
            surv = np.cumprod(1.0 - self.y_hat, axis=1)
        surv[surv < 0] = 0
        self.survival_hat = surv

        if self.backend == "SurvivalEVAL":
            self.aux_evaluator.predicted_curves = self.survival_hat
            actual = self.meta_data.get_patient_data(pids=cur_uid, ret_columns=["t", "e"])
            assert len(actual["t"]) == len(self.survival_hat), "Pred/label length mismatch."
            self.aux_evaluator.actual_survival_time = actual["t"]
            self.aux_evaluator.actual_survival_event = actual["e"]

    def _c_index(self):
        return concordance_index(self.y, self.y_hat, type_pred=self.type)

    def _loss_fn(self, alpha):
        if self.type == "incidence":
            return partial(_surv_losses.surv_ifmle, alpha=alpha)
        return partial(_surv_losses.surv_mle, alpha=alpha)

    def _loss_mle(self):
        return _torch_loss(self._loss_fn(0.0), self.y_hat, self.t, self.e)

    def _loss_mle_org(self):
        return _torch_loss(self._loss_fn(0.0), self.y_hat, self.t, self.e)

    def _aux_c_index(self, ties="All"):
        cindex, _, _ = self.aux_evaluator.concordance(ties=ties)
        return cindex

    def _aux_ibs(self, IPCW_weighted=True):
        return self.aux_evaluator.integrated_brier_score(
            num_points=None, IPCW_weighted=IPCW_weighted)

    def _aux_mae(self, method="Hinge", reduction=True):
        return self.aux_evaluator.mae(method=method, reduction=reduction)

    def _aux_dcal(self):
        p_value, _ = self.aux_evaluator.d_calibration()
        return p_value

    def _eval_ext_loss(self, loss_name, loss_func, **kws):
        """Each training loss again on the collected predictions."""
        t, e = self.t, self.e
        weight = kws.get("weight", 1)
        if loss_name == "SurvEMD":
            loss = weight * _torch_loss(partial(loss_func, cur_logit_scale=kws["logit_scale"]),
                                        self.y_hat, t, e)
        elif loss_name == "SurvT2I":
            loss = weight * _torch_loss(partial(loss_func, cur_logit_scale=kws["logit_scale"]),
                                        self.raw_y_hat, t, e)
        elif loss_name == "QueryDiv":
            loss = weight * float(loss_func())
        else:
            loss = weight * _torch_loss(loss_func, self.y_hat, t, e)
        return float(loss)

    def compute(self, data, metrics, kws_ext_loss=None, **kws):
        self._pre_compute(data)
        res = {m: self.valid_functions[m]() for m in metrics}
        if kws_ext_loss is not None:
            for loss_name, loss_func in kws_ext_loss.items():
                weight = kws.get("loss_weight", {}).get(loss_name, 1)
                logit_scale = kws.get("logit_scale", 10.0)
                res["loss_" + loss_name] = self._eval_ext_loss(
                    loss_name, loss_func, weight=weight, logit_scale=logit_scale)
        return res


class CoxSurvEvaluator:
    """Cox-head evaluator with a Breslow baseline."""

    def __init__(self, backend="SurvivalEVAL", meta_data=None, **kws):
        self.backend = backend
        self.meta_data = meta_data
        assert meta_data is not None, "meta_data required."
        data_train = meta_data.get_patient_data(split="train", ret_columns=["t"])
        self.time_points = np.unique(data_train["t"])
        self.aux_evaluator = None
        if backend == "SurvivalEVAL":
            self.aux_evaluator = load_survival_eval(
                meta_data, time_coordinates=self.time_points, predict_time_method="Mean")
            self.valid_functions = {
                "c_index": self._aux_c_index,
                "c_index2": self._c_index,
                "loss": self._ple_loss,
                "loss_ple": self._ple_loss,
                "IBS": self._aux_ibs,
                "MAE": self._aux_mae,
                "D_calibration": self._aux_dcal,
            }
            self.valid_metrics = ["c_index", "loss", "loss_ple", "IBS", "MAE",
                                  "D_calibration", "c_index2"]
        else:
            self.valid_functions = {
                "c_index": self._c_index, "loss": self._ple_loss, "loss_ple": self._ple_loss,
            }
            self.valid_metrics = ["c_index", "loss", "loss_ple"]
        self._baseline_model = BreslowEstimator()

    def _pre_compute(self, data):
        self.y = _to_np(data["y"])
        self.t = self.y[:, 0]
        self.e = self.y[:, 1]
        self.y_hat = np.squeeze(_to_np(data.get("avg_y_hat", data["y_hat"])))
        cur_uid = data["uid"]
        if data.get("name") == "train":
            train_label = self.meta_data.get_patient_data(pids=cur_uid, ret_columns=["t", "e"])
            train_tp = np.unique(train_label["t"])
            self.aux_evaluator.time_coordinates = train_tp
            self.time_points = train_tp
            self._baseline_model.fit(self.y_hat, train_label["e"], train_label["t"])
        _tp, self.survival_hat = self._baseline_model.get_survival_function(
            self.y_hat, ret_ndarray=True)
        # the curves' time grid is the train-fitted baseline's
        assert set(np.asarray(_tp).tolist()) == set(
            np.asarray(self.time_points).tolist()), "Consistency check failed."
        if self.backend == "SurvivalEVAL":
            self.aux_evaluator.predicted_curves = self.survival_hat
            actual = self.meta_data.get_patient_data(pids=cur_uid, ret_columns=["t", "e"])
            assert len(actual["t"]) == len(self.survival_hat)
            self.aux_evaluator.actual_survival_time = actual["t"]
            self.aux_evaluator.actual_survival_event = actual["e"]

    def _c_index(self):
        return concordance_index(self.y, self.y_hat.reshape(-1, 1), type_pred="hazard_ratio")

    def _ple_loss(self):
        return _torch_loss(_surv_losses.surv_ple, self.y_hat, self.t, self.e)

    def _aux_c_index(self, ties="All"):
        cindex, _, _ = self.aux_evaluator.concordance(ties=ties)
        return cindex

    def _aux_ibs(self, IPCW_weighted=True):
        return self.aux_evaluator.integrated_brier_score(num_points=None,
                                                         IPCW_weighted=IPCW_weighted)

    def _aux_mae(self, method="Hinge"):
        return self.aux_evaluator.mae(method=method)

    def _aux_dcal(self):
        p_value, _ = self.aux_evaluator.d_calibration()
        return p_value

    def compute(self, data, metrics, **kws):
        self._pre_compute(data)
        return {m: self.valid_functions[m]() for m in metrics}


class RegSurvEvaluator:
    """Continuous-time evaluator."""

    def __init__(self, **kws):
        self.end_time = kws["end_time"]
        self.valid_functions = {
            "c_index": self._c_index,
            "loss": self._recon_loss_org,
            "loss_rank": self._rank_loss,
            "loss_recon": self._recon_loss,
            "loss_recon_org": self._recon_loss_org,
            "event_t_rae": self._evt_rae,
            "nonevent_t_rae": self._noevt_rae,
            "event_t_nre": self._evt_nre,
            "nonevent_t_nre": self._noevt_nre,
        }
        self.valid_metrics = list(self.valid_functions.keys())

    def _pre_compute(self, data):
        self.y = _to_np(data["y"])
        self.t = self.y[:, 0]
        self.e = self.y[:, 1]
        self.y_hat = np.squeeze(_to_np(data.get("avg_y_hat", data["y_hat"])))

    def _c_index(self):
        # predicted survival time: longer predicted time = lower risk
        return concordance_index(self.y, self.y_hat.reshape(-1, 1), type_pred="survival_time")

    def _rank_loss(self):
        return _torch_loss(_surv_losses.rank_loss, self.y_hat, self.t, self.e)

    def _recon_loss(self):
        return _torch_loss(_surv_losses.recon_loss, self.y_hat, self.t, self.e)

    def _recon_loss_org(self):
        return _torch_loss(partial(_surv_losses.recon_loss, alpha=0.0),
                           self.y_hat, self.t, self.e)

    def _evt_rae(self):
        idx = self.e == 1
        return float(np.mean(np.abs(self.t[idx] - self.y_hat[idx]) / self.end_time))

    def _noevt_rae(self):
        idx = self.e == 0
        return float(np.mean(np.maximum(self.t[idx] - self.y_hat[idx], 0) / self.end_time))

    def _evt_nre(self):
        idx = self.e == 1
        return float(np.mean((self.y_hat[idx] - self.t[idx]) / self.end_time))

    def _noevt_nre(self):
        idx = self.e == 0
        return float(np.mean(-np.maximum(-(self.y_hat[idx] - self.t[idx]), 0) / self.end_time))

    def compute(self, data, metrics, **kws):
        self._pre_compute(data)
        return {m: self.valid_functions[m]() for m in metrics}


def load_evaluator(task, *args, **kws):
    """task x name -> evaluator."""
    name = args[0]
    if task == "clf":
        return {"Binary": BinClfEvaluator, "Multi-class": MultiClfEvaluator}[name](**kws)
    if task == "sa":
        if name == "Reg":
            return RegSurvEvaluator(**kws)
        if name == "NLL":
            return NLLSurvEvaluator(prediction_type="hazard", **kws)
        if name == "NLL-IF":
            return NLLSurvEvaluator(prediction_type="incidence", **kws)
        if name == "Cox":
            return CoxSurvEvaluator(**kws)
    if task == "vlsa":
        if name == "VL":
            return NLLSurvEvaluator(prediction_type="hazard", **kws)
        if name == "VL-IF":
            return NLLSurvEvaluator(prediction_type="incidence", **kws)
    raise ValueError(f"unknown evaluator {task}/{name}")
