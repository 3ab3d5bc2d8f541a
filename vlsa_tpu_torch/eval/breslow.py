"""Breslow baseline-hazard estimator for Cox-head models.

Behavioural port of ref eval/utils_coxph.py (itself sksurv semantics):
baseline cumulative hazard at unique event times with exp(linear_predictor)
risk weights; per-sample survival S(t|x) = S0(t)^exp(f(x)).  The per-time
risk-set divisor is computed vectorised instead of the incremental loop.

The port's own copy of vlsa_tpu/eval/breslow.py (numpy only, the same
float64 arithmetic); tests/test_torch_eval.py holds it against the original.
"""
from __future__ import annotations

import numpy as np


class StepFunction:
    """f(z) = a * y_i + b for x_i <= z < x_{i+1} (ref utils_coxph.py:81-175)."""

    def __init__(self, x, y, a=1.0, b=0.0, domain=(0, None)):
        self.x = np.asarray(x, dtype=float)
        self.y = np.asarray(y, dtype=float)
        self.a = a
        self.b = b
        lo = self.x[0] if domain[0] is None else domain[0]
        hi = self.x[-1] if domain[1] is None else domain[1]
        self._domain = (float(lo), float(hi))

    @property
    def domain(self):
        return self._domain

    def __call__(self, v):
        v = np.atleast_1d(np.asarray(v, dtype=float))
        if not np.isfinite(v).all():
            raise ValueError("x must be finite")
        if np.min(v) < self._domain[0] or np.max(v) > self._domain[1]:
            raise ValueError(f"x must be within [{self._domain[0]:f}; {self._domain[1]:f}]")
        v = np.clip(v, a_min=self.x[0], a_max=None)
        i = np.searchsorted(self.x, v, side="left")
        not_exact = self.x[np.minimum(i, len(self.x) - 1)] != v
        i[not_exact] -= 1
        value = self.a * self.y[i] + self.b
        return value[0] if value.shape[0] == 1 else value


class BreslowEstimator:
    """Breslow cumulative baseline hazard (ref utils_coxph.py:178-281)."""

    def fit(self, linear_predictor, event, time):
        linear_predictor = np.squeeze(np.asarray(linear_predictor, dtype=float))
        event = np.squeeze(np.asarray(event)).astype(bool)
        time = np.squeeze(np.asarray(time, dtype=float))

        risk_score = np.exp(linear_predictor)
        order = np.argsort(time, kind="mergesort")
        sorted_time = time[order]
        sorted_risk = risk_score[order]
        sorted_event = event[order]

        uniq_times, first_idx, counts = np.unique(
            sorted_time, return_index=True, return_counts=True)
        n_events = np.add.reduceat(sorted_event.astype(int), first_idx)
        # risk-set denominator: total risk minus risk of samples with earlier times
        cum_risk_before = np.concatenate([[0.0], np.cumsum(sorted_risk)])[first_idx]
        divisor = np.sum(sorted_risk) - cum_risk_before

        y = np.cumsum(n_events / divisor)
        self.cum_baseline_hazard_ = StepFunction(uniq_times, y)
        self.baseline_survival_ = StepFunction(uniq_times, np.exp(-y))
        self.unique_times_ = uniq_times
        return self

    def get_cumulative_hazard_function(self, linear_predictor):
        risk_score = np.exp(np.squeeze(np.asarray(linear_predictor, dtype=float)))
        return [
            StepFunction(self.cum_baseline_hazard_.x, self.cum_baseline_hazard_.y, a=r)
            for r in np.atleast_1d(risk_score)
        ]

    def get_survival_function(self, linear_predictor, ret_ndarray=False):
        risk_score = np.exp(np.squeeze(np.asarray(linear_predictor, dtype=float)))
        if ret_ndarray:
            n = np.atleast_1d(risk_score).shape[0]
            return (self.baseline_survival_.x,
                    np.power(self.baseline_survival_.y, np.atleast_1d(risk_score).reshape(n, 1)))
        return [
            StepFunction(self.baseline_survival_.x, np.power(self.baseline_survival_.y, r))
            for r in np.atleast_1d(risk_score)
        ]
