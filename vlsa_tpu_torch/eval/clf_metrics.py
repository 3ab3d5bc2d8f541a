"""Classification evaluators (counterpart of vlsa_tpu/eval/clf_metrics.py):
binary AUC/ACC/recall/precision/F1/ECE/MCE and multi-class AUC/ACC/F1.

vlsa_tpu computes them with scikit-learn, which the card's machine lacks;
the functions below compute what scikit-learn 1.9's do, with numpy alone:

  * `roc_curve`: scores sorted in descending order, one point a distinct
    score (ties collapse), (0, 0) prepended with the threshold +inf; fpr
    (tpr) all nan when there is no negative (positive) sample;
    `drop_intermediate` drops the collinear points;
  * `auc`: trapezoids, negated for a decreasing x, refused for a
    non-monotonic one;
  * `calibration_curve`: uniform bins, the bin of p by `searchsorted` on the
    inner edges, empty bins dropped;
  * `roc_auc_ovr`: `roc_auc_score(multi_class="ovr")`'s macro mean of the
    one-vs-rest AUCs, nan wherever scikit-learn raises (vlsa_tpu turns its
    ValueError into nan): a class of the columns absent from the labels,
    rows that do not sum to 1, two columns or fewer;
  * `f1_score`: the per-label 2 tp / (true + pred) over the labels found in
    either array (0 where both counts are 0), their mean ("macro") or
    2 sum(tp) / (sum(true) + sum(pred)) ("micro").
"""
from __future__ import annotations

import numpy as np


def _to_np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.squeeze(np.asarray(x))


def roc_curve(y_true, y_score, pos_label=1, drop_intermediate: bool = True):
    """(fpr, tpr, thresholds), thresholds decreasing from +inf."""
    y_true = (np.asarray(y_true) == pos_label).astype(np.float64)
    y_score = np.asarray(y_score)
    order = np.argsort(-y_score, kind="stable")
    y_score, y_true = y_score[order], y_true[order]
    idx = np.concatenate([np.nonzero(np.diff(y_score))[0], [y_true.size - 1]])
    tps = np.cumsum(y_true)[idx]
    fps = 1 + idx.astype(np.float64) - tps
    thresholds = y_score[idx]
    if drop_intermediate and fps.shape[0] > 2:
        keep = np.concatenate([[True], np.logical_or(np.diff(fps, 2), np.diff(tps, 2)),
                               [True]])
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps = np.concatenate([[0.0], tps])
    fps = np.concatenate([[0.0], fps])
    thresholds = np.concatenate([[np.inf], thresholds.astype(np.float64)])
    fpr = np.full(fps.shape, np.nan) if fps[-1] <= 0 else fps / fps[-1]
    tpr = np.full(tps.shape, np.nan) if tps[-1] <= 0 else tps / tps[-1]
    return fpr, tpr, thresholds


def auc(x, y) -> float:
    x, y = np.asarray(x), np.asarray(y)
    if x.shape[0] < 2:
        raise ValueError(f"At least 2 points are needed to compute area under curve, "
                         f"but x.shape = {x.shape}")
    direction = 1
    dx = np.diff(x)
    if np.any(dx < 0):
        if not np.all(dx <= 0):
            raise ValueError(f"x is neither increasing nor decreasing : {x}.")
        direction = -1
    return float(direction * np.sum(dx * (y[1:] + y[:-1]) / 2.0))


def calibration_curve(y_true, y_prob, n_bins: int = 10):
    """(fraction of positives, mean predicted probability) of each non-empty
    uniform bin; labels 0/1 (or -1/1), positive 1."""
    y_true, y_prob = np.asarray(y_true), np.asarray(y_prob)
    labels = np.unique(y_true)
    if not set(labels.tolist()) <= {0, 1} and not set(labels.tolist()) <= {-1, 1}:
        raise ValueError(f"y_true takes value in {labels.tolist()} and pos_label is not "
                         f"specified")
    if y_prob.min() < 0 or y_prob.max() > 1:
        raise ValueError("y_prob has values outside [0, 1].")
    y_true = y_true == 1
    bins = np.linspace(0.0, 1.0, n_bins + 1)
    binids = np.searchsorted(bins[1:-1], y_prob)
    bin_sums = np.bincount(binids, weights=y_prob, minlength=n_bins)
    bin_true = np.bincount(binids, weights=y_true, minlength=n_bins)
    bin_total = np.bincount(binids, minlength=n_bins)
    nonzero = bin_total != 0
    return bin_true[nonzero] / bin_total[nonzero], bin_sums[nonzero] / bin_total[nonzero]


def _binary_roc_auc(y_true, y_score) -> float:
    if len(np.unique(y_true)) != 2:
        return float("nan")
    fpr, tpr, _ = roc_curve(y_true, y_score)
    return auc(fpr, tpr)


def roc_auc_ovr(y_true, y_score) -> float:
    """Macro one-vs-rest AUC of labels [n] against probabilities [n, C]."""
    y_true, y_score = np.asarray(y_true), np.asarray(y_score)
    classes = np.unique(y_true)
    if y_score.ndim != 2 or y_score.shape[1] <= 2:
        # scikit-learn's binary path: one column of scores, which [n, C] is not
        return float("nan")
    if not np.allclose(1, y_score.sum(axis=1)) or len(classes) != y_score.shape[1]:
        return float("nan")
    onehot = (y_true[:, None] == classes[None, :]).astype(np.int64)
    scores = np.array([_binary_roc_auc(onehot[:, c], y_score[:, c])
                       for c in range(len(classes))])
    return float(np.mean(scores))


def f1_score(y_true, y_pred, average: str = "macro") -> float:
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    labels = np.union1d(y_true, y_pred)
    tp = np.array([np.sum((y_true == c) & (y_pred == c)) for c in labels], np.int64)
    true = np.array([np.sum(y_true == c) for c in labels], np.int64)
    pred = np.array([np.sum(y_pred == c) for c in labels], np.int64)
    if average == "micro":
        tp, true, pred = tp.sum(keepdims=True), true.sum(keepdims=True), pred.sum(keepdims=True)
    elif average != "macro":
        raise ValueError(f"average must be macro or micro, got {average!r}")
    denom = true.astype(np.float64) + pred.astype(np.float64)
    zero = denom == 0
    denom[zero] = 1
    f = 2.0 * tp.astype(np.float64) / denom
    f[zero] = 0.0
    return float(np.mean(f))


class BinClfEvaluator:
    """Metrics of 2-column probabilities against 0/1 labels; the threshold
    metrics at the ROC point that maximises tpr - fpr (first of ties)."""

    def __init__(self, pos_label=1, **kws):
        self.pos_label = pos_label
        self.valid_functions = {
            "auc": self._auc,
            "loss": self._loss,
            "acc": self._acc,
            "acc_best": self._acc_best,
            "acc@mid": self._acc_mid_threshold,
            "recall": self._recall,
            "precision": self._precision,
            "f1_score": self._f1_score,
            "ece": self._ece,
            "mce": self._mce,
        }
        self.valid_metrics = list(self.valid_functions.keys())

    def _pre_compute(self, data):
        self.y = _to_np(data["y"])
        y_hat_full = _to_np(data["y_hat"])
        assert y_hat_full.ndim > 1 and y_hat_full.shape[-1] == 2, "Invalid prediction input."
        assert ((y_hat_full >= 0) & (y_hat_full <= 1)).all(), "Predictions must be probabilities."
        self.y_hat = y_hat_full[:, -1]
        self.fpr, self.tpr, self.thresholds = roc_curve(
            self.y, self.y_hat, pos_label=self.pos_label, drop_intermediate=False)
        self.threshold_optimal = self.thresholds[np.argmin(self.fpr - self.tpr, axis=0)]
        self.cali_y, self.cali_yhat = calibration_curve(self.y, self.y_hat, n_bins=10)

    def _loss(self):
        p = np.clip(self.y_hat, 1e-7, 1 - 1e-7)
        return float(-np.mean(self.y * np.log(p) + (1 - self.y) * np.log(1 - p)))

    def _auc(self):
        return auc(self.fpr, self.tpr)

    def _pred(self, threshold):
        threshold = self.threshold_optimal if threshold is None else threshold
        return (self.y_hat > threshold).astype(int)

    def _acc(self, threshold=None):
        return float(np.sum(self._pred(threshold) == self.y) / self.y.shape[0])

    def _recall(self, threshold=None):
        with np.errstate(invalid="ignore"):  # no positive: nan, as vlsa_tpu
            return float(np.sum(self._pred(threshold)[self.y == 1]) / np.sum(self.y))

    def _precision(self, threshold=None):
        pred = self._pred(threshold)
        return float(np.sum(self.y[pred == 1]) / np.maximum(np.sum(pred), 1))

    def _f1_score(self, threshold=None):
        rec, pre = self._recall(threshold), self._precision(threshold)
        return 2 * rec * pre / max(rec + pre, 1e-12)

    def _acc_best(self):
        return max(self._acc(th) for th in self.thresholds)

    def _acc_mid_threshold(self):
        return self._acc(0.5)

    def _ece(self):
        return float(np.abs(self.cali_y - self.cali_yhat).mean())

    def _mce(self):
        return float(np.abs(self.cali_y - self.cali_yhat).max())

    def compute(self, data, metrics, **kws):
        self._pre_compute(data)
        return {m: self.valid_functions[m]() for m in metrics}


class MultiClfEvaluator:
    """Metrics of [n, C] probabilities against class labels."""

    def __init__(self, **kws):
        self.valid_functions = {
            "auc": self._auc,
            "loss": self._loss,
            "acc": self._acc,
            "macro_f1_score": lambda: f1_score(self.y, self.pred_cls, "macro"),
            "micro_f1_score": lambda: f1_score(self.y, self.pred_cls, "micro"),
        }
        self.valid_metrics = list(self.valid_functions.keys())

    def _pre_compute(self, data):
        self.y = _to_np(data["y"]).astype(int)
        self.y_hat = _to_np(data["y_hat"])
        self.pred_cls = np.argmax(self.y_hat, axis=-1)

    def _loss(self):
        p = np.clip(self.y_hat[np.arange(len(self.y)), self.y], 1e-7, 1.0)
        return float(-np.mean(np.log(p)))

    def _auc(self):
        return roc_auc_ovr(self.y, self.y_hat)

    def _acc(self):
        return float(np.mean(self.pred_cls == self.y))

    def compute(self, data, metrics, **kws):
        self._pre_compute(data)
        return {m: self.valid_functions[m]() for m in metrics}
