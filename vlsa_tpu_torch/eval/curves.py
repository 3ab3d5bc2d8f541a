"""Survival-curve readout: mean/median survival time and probability-at-time.

Behavioural port of ref eval/SurvivalEVAL/Evaluations/util.py:153-374 with one
deliberate change: the reference integrates the *piecewise-linear* curve with
scipy.integrate.quad; here the same integral is computed in closed form
(exact for linear interpolation, and orders of magnitude faster for
whole-cohort evaluation).

The port's own copy of vlsa_tpu/eval/curves.py (numpy only, the same
float64 arithmetic); tests/test_torch_eval.py holds it against the original.
"""
from __future__ import annotations

import warnings

import numpy as np


def _interp_linear(times: np.ndarray, probs: np.ndarray, x: np.ndarray) -> np.ndarray:
    """scipy interp1d(kind='linear', fill_value='extrapolate') equivalent."""
    times = np.asarray(times, dtype=float)
    probs = np.asarray(probs, dtype=float)
    x = np.asarray(x, dtype=float)
    if times.size == 1:
        return np.full_like(x, probs[0])
    idx = np.clip(np.searchsorted(times, x) - 1, 0, times.size - 2)
    t0, t1 = times[idx], times[idx + 1]
    p0, p1 = probs[idx], probs[idx + 1]
    slope = (p1 - p0) / (t1 - t0)
    return p0 + slope * (x - t0)


def _integrate_linear_interp(times: np.ndarray, probs: np.ndarray, a: float, b: float) -> float:
    """Exact integral of the linear interpolant (with linear extrapolation)
    over [a, b]."""
    if b <= a:
        return 0.0
    knots = np.asarray(times, dtype=float)
    inner = knots[(knots > a) & (knots < b)]
    xs = np.concatenate([[a], inner, [b]])
    ys = _interp_linear(times, probs, xs)
    return float(np.trapezoid(ys, xs))


def predict_prob_from_curve(survival_curve, times_coordinate, target_time,
                            interpolation: str = "Linear") -> float:
    """Survival probability at `target_time` (ref util.py:163-208)."""
    if interpolation != "Linear":
        raise NotImplementedError("only Linear interpolation is supported")
    times = np.asarray(times_coordinate, dtype=float)
    curve = np.asarray(survival_curve, dtype=float)
    max_time = float(np.max(times))
    s_end = float(_interp_linear(times, curve, np.array([max_time]))[0])
    slope = (1.0 - s_end) / (0.0 - max_time)
    if target_time > max_time:
        return max(slope * float(target_time) + 1.0, 0.0)
    return float(_interp_linear(times, curve, np.array([float(target_time)]))[0])


def predict_multi_probs_from_curve(survival_curve, times_coordinate, target_times,
                                   interpolation: str = "Linear") -> np.ndarray:
    """Vectorised probability-at-times (ref util.py:211-256)."""
    if interpolation != "Linear":
        raise NotImplementedError("only Linear interpolation is supported")
    times = np.asarray(times_coordinate, dtype=float)
    curve = np.asarray(survival_curve, dtype=float)
    target = np.asarray(target_times, dtype=float)
    max_time = float(np.max(times))
    s_end = float(_interp_linear(times, curve, np.array([max_time]))[0])
    slope = (1.0 - s_end) / (0.0 - max_time)
    probs = _interp_linear(times, curve, target)
    beyond = target > max_time
    probs[beyond] = np.maximum(slope * target[beyond] + 1.0, 0.0)
    return probs


def predict_mean_survival_time(survival_curve, times_coordinate,
                               interpolation: str = "Linear") -> float:
    """Mean survival time = area under the (linearly extended) curve
    (ref util.py:259-311)."""
    if interpolation != "Linear":
        raise NotImplementedError("only Linear interpolation is supported")
    times = np.asarray(times_coordinate, dtype=float)
    curve = np.asarray(survival_curve, dtype=float)
    if np.all(curve == 1):
        warnings.warn("All the predicted probabilities are 1, the integral will be infinite.")
        return np.inf
    max_time = float(np.max(times))
    s_end = float(_interp_linear(times, curve, np.array([max_time]))[0])
    slope = (1.0 - s_end) / (0.0 - max_time)
    if 0 in curve:
        zero_time = float(np.min(times[np.where(curve == 0)]))
    else:
        zero_time = max_time + (0.0 - s_end) / slope

    # integral of spline on [0, min(zero_time, max_time)] plus the linear
    # tail 1 + t*slope on [max_time, zero_time] when zero_time > max_time
    if zero_time <= max_time:
        return _integrate_linear_interp(times, curve, 0.0, zero_time)
    head = _integrate_linear_interp(times, curve, 0.0, max_time)
    a, b = max_time, zero_time
    tail = (b - a) + slope * (b * b - a * a) / 2.0
    return head + tail


def predict_median_survival_time(survival_curve, times_coordinate,
                                 interpolation: str = "Linear") -> float:
    """Time where the curve crosses 0.5 (ref util.py:314-374)."""
    if interpolation != "Linear":
        raise NotImplementedError("only Linear interpolation is supported")
    times = np.asarray(times_coordinate, dtype=float)
    curve = np.asarray(survival_curve, dtype=float)
    if np.all(curve == 1):
        warnings.warn("All the predicted probabilities are 1, the median will be infinite.")
        return np.inf
    min_prob = float(np.min(curve))
    if 0.5 in curve:
        return float(times[np.where(curve == 0.5)[0][0]])
    if min_prob < 0.5:
        idx_before = np.where(curve > 0.5)[0][-1]
        idx_after = np.where(curve < 0.5)[0][0]
        t0, t1 = float(times[idx_before]), float(times[idx_after])
        slope = (curve[idx_after] - curve[idx_before]) / (t1 - t0)
        intercept = curve[idx_before] - slope * t0
        return float((0.5 - intercept) / slope)
    max_time = float(np.max(times))
    slope = (1.0 - min_prob) / (0.0 - max_time)
    return float(-0.5 / slope)
