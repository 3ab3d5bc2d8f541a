"""(Integrated) Brier score with IPCW weighting.

Behavioural port of ref eval/SurvivalEVAL/Evaluations/BrierScore.py:65-215.

The port's own copy of vlsa_tpu/eval/brier.py (numpy only, the same
float64 arithmetic); tests/test_torch_eval.py holds it against the original.
"""
from __future__ import annotations

import numpy as np

from .km import KaplanMeier


def single_brier_score(
    predict_probs: np.ndarray,
    event_times: np.ndarray,
    event_indicators: np.ndarray,
    train_event_times: np.ndarray,
    train_event_indicators: np.ndarray,
    target_time: float = None,
    ipcw: bool = True,
) -> float:
    if target_time is None:
        target_time = np.median(event_times)
    event_indicators = np.asarray(event_indicators).astype(bool)
    train_event_indicators = np.asarray(train_event_indicators).astype(bool)
    if ipcw:
        ipc_model = KaplanMeier(train_event_times, 1 - train_event_indicators)
        ipc_pred = ipc_model.predict(event_times)
        ipc_pred[ipc_pred == 0] = np.inf
        weight_cat1 = ((event_times <= target_time) & event_indicators) / ipc_pred
        weight_cat1[np.isnan(weight_cat1)] = 0
        weight_cat2 = (event_times > target_time) / ipc_model.predict(np.array([target_time]))
        weight_cat2[np.isnan(weight_cat2)] = 0
    else:
        weight_cat1 = ((event_times <= target_time) & event_indicators).astype(float)
        weight_cat2 = (event_times > target_time).astype(float)
    return float((np.square(predict_probs) * weight_cat1
                  + np.square(1 - predict_probs) * weight_cat2).mean())


def brier_multiple_points(
    predict_probs_mat: np.ndarray,
    event_times: np.ndarray,
    event_indicators: np.ndarray,
    train_event_times: np.ndarray,
    train_event_indicators: np.ndarray,
    target_times: np.ndarray,
    ipcw: bool = True,
) -> np.ndarray:
    """Brier scores at multiple time points via one matrix op (ref BrierScore.py:148-215)."""
    target_times = np.asarray(target_times, dtype=float)
    if target_times.ndim != 1:
        raise TypeError("'target_times' is not a one-dimensional array.")
    event_times = np.asarray(event_times, dtype=float)
    event_indicators = np.asarray(event_indicators).astype(bool)

    target_mat = np.repeat(target_times.reshape(1, -1), len(event_times), axis=0)
    etime_mat = np.repeat(event_times.reshape(-1, 1), len(target_times), axis=1)
    eind_mat = np.repeat(event_indicators.reshape(-1, 1), len(target_times), axis=1)

    if ipcw:
        ipc_model = KaplanMeier(train_event_times, 1 - np.asarray(train_event_indicators))
        ipc_pred = ipc_model.predict(etime_mat)
        ipc_pred[ipc_pred == 0] = np.inf
        weight_cat1 = ((etime_mat <= target_mat) & eind_mat) / ipc_pred
        weight_cat1[np.isnan(weight_cat1)] = 0
        ipc_target = ipc_model.predict(target_mat)
        ipc_target[ipc_target == 0] = np.inf
        weight_cat2 = (etime_mat > target_mat) / ipc_target
        weight_cat2[np.isnan(weight_cat2)] = 0
    else:
        weight_cat1 = ((etime_mat <= target_mat) & eind_mat).astype(float)
        weight_cat2 = (etime_mat > target_mat).astype(float)

    sq_err = np.square(predict_probs_mat) * weight_cat1 \
        + np.square(1 - predict_probs_mat) * weight_cat2
    return np.mean(sq_err, axis=0)
