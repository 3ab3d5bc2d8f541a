"""Kaplan-Meier estimators (vectorised numpy).

Behavioural port of the KM machinery the reference's metric stack relies on
(ref: eval/SurvivalEVAL/Evaluations/util.py:485-632): step-function predict
via np.digitize, trapezoid area-under-KM, linear-extension zero crossing, and
the censored best-guess (residual mean survival) used by MAE-Margin and the
few-shot sampler.

The port's own copy of vlsa_tpu/eval/km.py (numpy only, the same
float64 arithmetic); tests/test_torch_eval.py holds it against the original.
"""
from __future__ import annotations

import numpy as np


class KaplanMeier:
    """KM curve over unique event times; `predict` matches the reference's
    digitize-based step lookup exactly."""

    def __init__(self, event_times: np.ndarray, event_indicators: np.ndarray):
        event_times = np.asarray(event_times, dtype=float)
        event_indicators = np.asarray(event_indicators).astype(float)
        index = np.lexsort((event_indicators, event_times))
        unique_times, counts = np.unique(event_times[index], return_counts=True)
        self.survival_times = unique_times
        self.population_count = np.flip(np.flip(counts).cumsum())

        # events per unique time: segmented sum of sorted indicators
        event_counter = np.append(0, counts.cumsum()[:-1])
        sorted_ind = event_indicators[index]
        self.events = np.add.reduceat(sorted_ind, event_counter)

        event_ratios = 1.0 - self.events / self.population_count
        self.survival_probabilities = np.cumprod(event_ratios)
        self.cumulative_dens = 1.0 - self.survival_probabilities
        self.probability_dens = np.diff(np.append(self.cumulative_dens, 1.0))

    def predict(self, prediction_times: np.ndarray) -> np.ndarray:
        prediction_times = np.asarray(prediction_times, dtype=float)
        idx = np.digitize(prediction_times, self.survival_times)
        idx = np.where(idx == self.survival_times.size + 1, idx - 1, idx)
        return np.append(1.0, self.survival_probabilities)[idx]


class KaplanMeierArea(KaplanMeier):
    """KM with cached area-under-curve suffixes for best-guess de-censoring
    (ref util.py:531-590)."""

    def __init__(self, event_times: np.ndarray, event_indicators: np.ndarray):
        super().__init__(event_times, event_indicators)
        area_probabilities = np.append(1.0, self.survival_probabilities)
        area_times = np.append(0.0, self.survival_times)
        with np.errstate(divide="ignore"):
            self.km_linear_zero = -1.0 / ((area_probabilities[-1] - 1.0) / area_times[-1])
        if self.survival_probabilities[-1] != 0:
            area_times = np.append(area_times, self.km_linear_zero)
            area_probabilities = np.append(area_probabilities, 0.0)
        area_diff = np.diff(area_times, 1)
        average_probabilities = (area_probabilities[:-1] + area_probabilities[1:]) / 2
        area = np.flip(np.flip(area_diff * average_probabilities).cumsum())
        self.area_times = np.append(area_times, np.inf)
        self.area_probabilities = area_probabilities
        self.area = np.append(area, 0.0)

    @property
    def mean(self) -> float:
        return float(self.best_guess(np.array([0.0])).item())

    def best_guess(self, censor_times: np.ndarray) -> np.ndarray:
        """Residual-mean-survival best guess for censored times (ref util.py:562-590)."""
        censor_times = np.asarray(censor_times, dtype=float)
        slope = (1.0 - min(self.survival_probabilities)) / (0.0 - max(self.survival_times))
        before_last = censor_times <= max(self.survival_times)
        after_last = censor_times > max(self.survival_times)
        surv_prob = np.empty_like(censor_times, dtype=float)
        surv_prob[after_last] = 1.0 + censor_times[after_last] * slope
        surv_prob[before_last] = self.predict(censor_times[before_last])
        surv_prob = np.clip(surv_prob, a_min=1e-10, a_max=None)

        censor_idx = np.digitize(censor_times, self.area_times)
        censor_idx = np.where(censor_idx == self.area_times.size + 1, censor_idx - 1, censor_idx)
        beyond = censor_idx > len(self.area_times) - 2
        censor_area = np.zeros_like(censor_times, dtype=float)
        nb = ~beyond
        censor_area[nb] = (
            (self.area_times[censor_idx[nb]] - censor_times[nb])
            * (self.area_probabilities[censor_idx[nb]] + surv_prob[nb]) * 0.5
        )
        censor_area[nb] += self.area[censor_idx[nb]]
        return censor_times + censor_area / surv_prob
