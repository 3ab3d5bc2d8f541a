"""Concordance index — both variants the reference reports:

  * `concordance_index` ("c_index2"): risk = -sum(survival curve), sksurv-style
    estimator (ref: eval/cindex.py:7-43,113-207),
  * `concordance` ("c_index"): SurvivalEVAL's predicted-event-time concordance
    with ties handling (ref: eval/SurvivalEVAL/Evaluations/Concordance.py:74-177);
    the runner calls it with ties="All".

The per-event inner loops are vectorised; results are numerically identical.

The port's own copy of vlsa_tpu/eval/concordance.py (numpy only, the same
float64 arithmetic); tests/test_torch_eval.py holds it against the original.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


class NoComparablePairException(ValueError):
    pass


def _estimate_concordance_index(event_indicator, event_time, estimate, tied_tol=1e-8):
    """Core comparable-pair counting (ref eval/cindex.py:113-150).

    Comparable pairs for an event i: every sample with a strictly later time,
    plus censored samples sharing i's time.
    """
    event_indicator = np.asarray(event_indicator).astype(bool)
    event_time = np.asarray(event_time, dtype=float)
    estimate = np.asarray(estimate, dtype=float)
    if len(event_time) < 2:
        raise ValueError("Need a minimum of two samples")
    if not event_indicator.any():
        raise ValueError("All samples are censored")

    concordant = 0
    discordant = 0
    tied_risk = 0
    tied_time = 0
    numerator = 0.0
    denominator = 0.0
    for i in np.where(event_indicator)[0]:
        same_time_censored = (event_time == event_time[i]) & (~event_indicator)
        comparable = (event_time > event_time[i]) | same_time_censored
        tied_time += int(same_time_censored.sum())
        n_comp = int(comparable.sum())
        if n_comp == 0:
            continue
        est = estimate[comparable]
        ties = np.abs(est - estimate[i]) <= tied_tol
        n_ties = int(ties.sum())
        n_con = int(((est < estimate[i]) & ~ties).sum())
        numerator += n_con + 0.5 * n_ties
        denominator += n_comp
        tied_risk += n_ties
        concordant += n_con
        discordant += n_comp - n_con - n_ties
    if denominator == 0:
        raise NoComparablePairException(
            "Data has no comparable pairs, cannot estimate concordance index.")
    return numerator / denominator, concordant, discordant, tied_risk, tied_time


def concordance_index_censored(event_indicator, event_time, estimate, tied_tol=1e-8):
    """sksurv-compatible c-index for right-censored data (ref eval/cindex.py:152-207)."""
    return _estimate_concordance_index(event_indicator, event_time, estimate, tied_tol)


def concordance_index(y_true, y_pred, **kws) -> float:
    """Risk-from-curve c-index used as `c_index2` (ref eval/cindex.py:7-43).

    y_true: [B, 2] (time, event).  y_pred: [B, 1] hazard ratio for coxph or
    [B, K] per-bin hazard/incidence for discrete models.
    """
    y_true = np.asarray(y_true, dtype=float)
    y_pred = np.asarray(y_pred, dtype=float)
    if y_pred.shape[1] == 1:
        if "type_pred" in kws:
            # the reference only accepts 'hazard_ratio' here and would raise on
            # the RegSurv evaluator's 'survival_time' (latent bug, ref
            # eval/cindex.py:29-35 vs evaluator_surv.py:419-422); we accept both
            # with identical negation semantics.
            assert kws["type_pred"] in ("hazard_ratio", "survival_time")
        t, e = y_true[:, 0], y_true[:, 1].astype(bool)
        return concordance_index_censored(e, t, -np.squeeze(y_pred), tied_tol=1e-08)[0]
    t, e = y_true[:, 0], y_true[:, 1].astype(bool)
    if kws.get("type_pred") == "incidence":
        survival = 1.0 - np.cumsum(y_pred, axis=1)
    else:
        survival = np.cumprod(1.0 - y_pred, axis=1)
    risk = np.sum(survival, axis=1)
    return concordance_index_censored(e, t, -risk, tied_tol=1e-08)[0]


def _weighted_all_pairs_concordance(orig_event, orig_time, bg_time, pw,
                                    estimate, tied_tol=1e-8):
    """Margin-method core: every sample acts as an event at its (best-guess)
    time; pair (i, j) weight = pw[i]*pw[j] unless the pair is comparable
    under the true censoring, which keeps weight 1.  Returns the same tuple
    as `_estimate_concordance_index` (tied_time is 0: with every sample an
    event there are no censored-at-same-time pairs)."""
    n = len(bg_time)
    concordant = discordant = tied_risk = 0.0
    numerator = denominator = 0.0
    for i in range(n):
        comp = bg_time > bg_time[i]
        if not comp.any():
            continue
        w = pw * pw[i]
        if orig_event[i]:
            orig_comp = (orig_time > orig_time[i]) | (
                (orig_time == orig_time[i]) & ~orig_event)
            w = np.where(orig_comp, 1.0, w)
        est, wj = estimate[comp], w[comp]
        ties = np.abs(est - estimate[i]) <= tied_tol
        n_ties = float(wj @ ties)
        n_con = float(wj @ ((est < estimate[i]) & ~ties))
        numerator += n_con + 0.5 * n_ties
        denominator += wj.sum()
        tied_risk += n_ties
        concordant += n_con
        discordant += wj.sum() - n_con - n_ties
    if denominator == 0:
        raise NoComparablePairException(
            "Data has no comparable pairs, cannot estimate concordance index.")
    return numerator / denominator, concordant, discordant, tied_risk, 0.0


def concordance(
    predicted_times: np.ndarray,
    event_times: np.ndarray,
    event_indicators: np.ndarray,
    train_event_times: Optional[np.ndarray] = None,
    train_event_indicators: Optional[np.ndarray] = None,
    pair_method: str = "Comparable",
    ties: str = "Risk",
):
    """SurvivalEVAL concordance over predicted event times (ref Concordance.py:74-177)."""
    event_indicators = np.asarray(event_indicators).astype(bool)
    predicted_times = np.asarray(predicted_times, dtype=float)
    event_times = np.asarray(event_times, dtype=float)

    if pair_method == "Comparable":
        risks = -1.0 * predicted_times
        cindex, concordant_pairs, discordant_pairs, risk_ties, time_ties = (
            _estimate_concordance_index(event_indicators, event_times, risks))
    elif pair_method == "Margin":
        # All-pairs concordance with KM best-guess de-censoring
        # (ref Concordance.py:127-149,180-238): censored subjects get a
        # best-guess event time from the train KM curve and pair weight
        # w_i*w_j with w = 1-KM(censor time); pairs already comparable under
        # the true censoring keep weight 1.  We implement the intended
        # product-weight semantics directly — the reference indexes its
        # order-space weight vector with original-space indices
        # (Concordance.py:211-212), a latent bug that cancels only when the
        # sort happens to be the identity.
        if train_event_times is None or train_event_indicators is None:
            raise ValueError(
                "If 'Margin' is chosen, training set information must be provided.")
        from .km import KaplanMeierArea
        km = KaplanMeierArea(np.asarray(train_event_times, dtype=float),
                             np.asarray(train_event_indicators).astype(bool))
        min_surv = float(np.min(km.survival_probabilities))
        max_t = float(np.max(km.survival_times))
        km_linear_zero = max_t / (1.0 - min_surv) if min_surv < 1.0 else max_t
        predicted_times = np.clip(predicted_times, None, km_linear_zero)
        risks = -1.0 * predicted_times

        censor_times = event_times[~event_indicators]
        pw = np.ones(len(event_times), dtype=float)
        pw[~event_indicators] = 1.0 - km.predict(censor_times)
        bg = km.best_guess(censor_times)
        late = censor_times > km_linear_zero
        bg[late] = censor_times[late]
        bg_times = event_times.copy()
        bg_times[~event_indicators] = bg

        cindex, concordant_pairs, discordant_pairs, risk_ties, time_ties = (
            _weighted_all_pairs_concordance(event_indicators, event_times,
                                            bg_times, pw, risks))
    else:
        raise TypeError("Method for calculating concordance is unrecognized.")

    if ties == "None":
        total_pairs = concordant_pairs + discordant_pairs
        cindex = concordant_pairs / total_pairs
    elif ties == "Time":
        total_pairs = concordant_pairs + discordant_pairs + time_ties
        concordant_pairs = concordant_pairs + 0.5 * time_ties
        cindex = concordant_pairs / total_pairs
    elif ties == "Risk":
        total_pairs = concordant_pairs + discordant_pairs + risk_ties
        concordant_pairs = concordant_pairs + 0.5 * risk_ties
        cindex = concordant_pairs / total_pairs
    elif ties == "All":
        total_pairs = concordant_pairs + discordant_pairs + risk_ties + time_ties
        concordant_pairs = concordant_pairs + 0.5 * (risk_ties + time_ties)
        cindex = concordant_pairs / total_pairs
    else:
        raise TypeError("Please enter one of 'None', 'Time', 'Risk', or 'All' for ties.")
    return cindex, concordant_pairs, total_pairs
