"""Cohort-level survival evaluator over predicted survival curves.

Behavioural port of the SurvivalEVAL `SurvivalEvaluator` the reference vends
(ref: eval/SurvivalEVAL/Evaluator.py:24-537): settable predicted curves /
labels, cached mean-survival-time readout, concordance / IBS / MAE /
D-calibration.  All per-sample curve readouts are vectorised.

The port's own copy of vlsa_tpu/eval/survival_evaluator.py (numpy only, the same
float64 arithmetic); tests/test_torch_eval.py holds it against the original.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .brier import brier_multiple_points, single_brier_score
from .concordance import concordance
from .curves import (
    predict_mean_survival_time,
    predict_median_survival_time,
    predict_multi_probs_from_curve,
    predict_prob_from_curve,
)
from .d_calibration import d_calibration
from .mean_error import mean_error


class SurvivalEvaluator:
    def __init__(
        self,
        predicted_survival_curves: np.ndarray,
        time_coordinates: np.ndarray,
        test_event_times: np.ndarray,
        test_event_indicators: np.ndarray,
        train_event_times: Optional[np.ndarray] = None,
        train_event_indicators: Optional[np.ndarray] = None,
        predict_time_method: str = "Mean",
        interpolation: str = "Linear",
    ):
        self._predicted_curves = np.asarray(predicted_survival_curves, dtype=float)
        self._time_coordinates = np.asarray(time_coordinates, dtype=float)
        self.event_times = np.asarray(test_event_times, dtype=float)
        self.event_indicators = np.asarray(test_event_indicators, dtype=float)
        self.train_event_times = (
            None if train_event_times is None else np.asarray(train_event_times, dtype=float))
        self.train_event_indicators = (
            None if train_event_indicators is None else np.asarray(train_event_indicators, dtype=float))
        if predict_time_method == "Mean":
            self.predict_time_method = predict_mean_survival_time
        elif predict_time_method == "Median":
            self.predict_time_method = predict_median_survival_time
        else:
            raise TypeError("predict_time_method must be 'Mean' or 'Median'.")
        self.interpolation = interpolation
        self._predicted_event_times = None

    # --- settable state with cache invalidation (ref Evaluator.py:82-128) ---
    @property
    def predicted_curves(self):
        return self._predicted_curves

    @predicted_curves.setter
    def predicted_curves(self, val):
        self._predicted_curves = np.asarray(val, dtype=float)
        self._predicted_event_times = None

    @property
    def time_coordinates(self):
        return self._time_coordinates

    @time_coordinates.setter
    def time_coordinates(self, val):
        self._time_coordinates = np.asarray(val, dtype=float)
        self._predicted_event_times = None

    @property
    def actual_survival_time(self):
        return self.event_times

    @actual_survival_time.setter
    def actual_survival_time(self, val):
        self.event_times = np.asarray(val, dtype=float)

    @property
    def actual_survival_event(self):
        return self.event_indicators

    @actual_survival_event.setter
    def actual_survival_event(self, val):
        self.event_indicators = np.asarray(val, dtype=float)

    @property
    def predicted_event_times(self):
        if self._predicted_event_times is None:
            self._predicted_event_times = np.array([
                self.predict_time_method(self._predicted_curves[i, :], self._time_coordinates)
                for i in range(self._predicted_curves.shape[0])
            ])
        return self._predicted_event_times

    # --- curve readouts ---
    def predict_probability_from_curve(self, target_time):
        if isinstance(target_time, (float, int)):
            target_time = target_time * np.ones_like(self.event_times)
        return np.array([
            predict_prob_from_curve(self._predicted_curves[i, :], self._time_coordinates,
                                    target_time[i])
            for i in range(self._predicted_curves.shape[0])
        ])

    def predict_multi_probabilities_from_curve(self, target_times):
        return np.stack([
            predict_multi_probs_from_curve(self._predicted_curves[i, :],
                                           self._time_coordinates, target_times)
            for i in range(self._predicted_curves.shape[0])
        ])

    # --- metrics ---
    def concordance(self, ties: str = "None", pair_method: str = "Comparable"):
        return concordance(self.predicted_event_times, self.event_times,
                           self.event_indicators.astype(bool),
                           self.train_event_times, self.train_event_indicators,
                           pair_method, ties)

    def brier_score(self, target_time=None, IPCW_weighted: bool = True):
        if target_time is None:
            target_time = np.quantile(
                np.concatenate((self.event_times, self.train_event_times)), 0.5)
        probs = self.predict_probability_from_curve(target_time)
        return single_brier_score(probs, self.event_times, self.event_indicators,
                                  self.train_event_times, self.train_event_indicators,
                                  target_time, IPCW_weighted)

    def integrated_brier_score(self, num_points=None, IPCW_weighted: bool = True,
                               draw_figure: bool = False):
        """ref Evaluator.py:337-407 — default grid = unique censored test times."""
        max_target_time = np.max(np.concatenate((self.event_times, self.train_event_times)))
        if num_points is None:
            censored_times = self.event_times[self.event_indicators == 0]
            time_points = np.unique(censored_times)
            if time_points.size < 2:
                # degenerate default grid (no/one censored subject in the
                # test set — the reference would crash here); fall back to a
                # uniform grid over the observed range
                time_points = np.linspace(0, max_target_time, 10)
            time_range = np.max(time_points) - np.min(time_points)
        else:
            time_points = np.linspace(0, max_target_time, num_points)
            time_range = max_target_time
        probs_mat = self.predict_multi_probabilities_from_curve(time_points)
        b_scores = brier_multiple_points(probs_mat, self.event_times, self.event_indicators,
                                         self.train_event_times, self.train_event_indicators,
                                         time_points, IPCW_weighted)
        integral = np.trapezoid(b_scores, time_points)
        return integral / time_range

    def mae(self, method: str = "Hinge", weighted: bool = True, log_scale: bool = False,
            reduction: bool = True, verbose: bool = False):
        return mean_error(self.predicted_event_times, self.event_times,
                          self.event_indicators, self.train_event_times,
                          self.train_event_indicators, "absolute", method,
                          weighted, log_scale, reduction)

    def d_calibration(self, num_bins: int = 10):
        probs = self.predict_probability_from_curve(self.event_times)
        return d_calibration(probs, self.event_indicators, num_bins)

    def auc(self, target_time=None):
        """Single-time cumulative/dynamic AUC (ref SurvivalEVAL
        Evaluations/AreaUnderCurve.py behaviour): cases are subjects with an
        observed event by `target_time`, controls those still at risk past
        it; censored-before-target subjects are not comparable.  Ties in the
        predicted event probability count 0.5."""
        if target_time is None:
            target_time = np.quantile(
                np.concatenate((self.event_times, self.train_event_times)), 0.5)
        event_prob = 1.0 - self.predict_probability_from_curve(target_time)
        cases = (self.event_times <= target_time) & (self.event_indicators == 1)
        controls = self.event_times > target_time
        n_pairs = cases.sum() * controls.sum()
        if n_pairs == 0:
            return float("nan")
        diff = event_prob[cases][:, None] - event_prob[controls][None, :]
        return float(((diff > 0).sum() + 0.5 * (diff == 0).sum()) / n_pairs)

    def one_calibration(self, target_time=None, num_bins: int = 10):
        """Hosmer-Lemeshow style single-time calibration (D'Agostino-Nam;
        ref SurvivalEVAL Evaluations/OneCalibration.py behaviour): group by
        predicted event probability at `target_time`, compare the group mean
        against the KM-observed event rate inside the group.  Returns
        (p_value, observed_rates, expected_rates)."""
        from scipy.stats import chi2
        from .km import KaplanMeier
        if target_time is None:
            target_time = np.quantile(
                np.concatenate((self.event_times, self.train_event_times)), 0.5)
        pred = 1.0 - self.predict_probability_from_curve(target_time)
        order = np.argsort(-pred)
        bins = np.array_split(order, num_bins)
        hl, observed, expected = 0.0, [], []
        for idx in bins:
            if idx.size == 0:
                continue
            mean_p = float(np.clip(pred[idx].mean(), 1e-10, 1 - 1e-10))
            km = KaplanMeier(self.event_times[idx], self.event_indicators[idx])
            obs = 1.0 - float(km.predict(np.asarray([target_time]))[0])
            observed.append(obs)
            expected.append(mean_p)
            hl += (idx.size * (obs - mean_p) ** 2) / (mean_p * (1.0 - mean_p))
        p_value = float(1.0 - chi2.cdf(hl, max(len(observed) - 1, 1)))
        return p_value, np.asarray(observed), np.asarray(expected)

    def km_calibration(self, draw_figure: bool = False):
        """Integrated squared difference between the cohort-mean predicted
        survival curve and the test-set Kaplan-Meier curve, normalised by the
        time range (ref SurvivalEVAL Evaluations/KMCalibration.py
        behaviour).  0 = perfectly KM-calibrated."""
        from .km import KaplanMeier
        km = KaplanMeier(self.event_times, self.event_indicators)
        grid = self._time_coordinates
        km_curve = km.predict(np.asarray(grid, dtype=float))
        mean_curve = self._predicted_curves.mean(axis=0)
        rng = max(float(grid[-1] - grid[0]), 1e-12)
        return float(np.trapezoid((mean_curve - km_curve) ** 2, grid) / rng)
