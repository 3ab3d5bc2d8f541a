"""Mean absolute/squared error for predicted survival times under censoring.

Behavioural port of ref eval/SurvivalEVAL/Evaluations/MeanError.py:125-344.
The runner reports MAE with method="Hinge" and KM confidence weights.

The port's own copy of vlsa_tpu/eval/mean_error.py (numpy only, the same
float64 arithmetic); tests/test_torch_eval.py holds it against the original.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .km import KaplanMeierArea


def mean_error(
    predicted_times: np.ndarray,
    event_times: np.ndarray,
    event_indicators: np.ndarray,
    train_event_times: Optional[np.ndarray] = None,
    train_event_indicators: Optional[np.ndarray] = None,
    error_type: str = "absolute",
    method: str = "Hinge",
    weighted: bool = True,
    log_scale: bool = False,
    reduction: bool = True,
) -> float:
    predicted_times = np.asarray(predicted_times, dtype=float)
    event_times = np.asarray(event_times, dtype=float)
    event_indicators = np.asarray(event_indicators).astype(bool)
    n_test = event_times.size
    if train_event_indicators is not None:
        train_event_indicators = np.asarray(train_event_indicators).astype(bool)

    if method in ("Margin", "IPCW-v1", "IPCW-v2", "Pseudo_obs", "Pseudo_obs_pop"):
        if train_event_times is None or train_event_indicators is None:
            raise ValueError(f"If method is '{method}', training set values must be included.")
        km_model = KaplanMeierArea(train_event_times, train_event_indicators)
        km_linear_zero = km_model.km_linear_zero
        if np.isinf(km_linear_zero):
            km_linear_zero = max(km_model.survival_times)
        censor_times = event_times[~event_indicators]
        weights = np.ones(n_test)
        if weighted:
            weights[~event_indicators] = 1 - km_model.predict(censor_times)

    error_func = np.abs if error_type == "absolute" else np.square
    if error_type not in ("absolute", "squared"):
        raise TypeError("Please enter one of 'absolute' or 'squared'.")

    if method == "Uncensored":
        if log_scale:
            errors = np.log(event_times[event_indicators]) - np.log(predicted_times[event_indicators])
        else:
            errors = event_times[event_indicators] - predicted_times[event_indicators]
        return error_func(errors) if not reduction else float(error_func(errors).mean())

    if method == "Hinge":
        # early predictions only; censored errors clamped at 0 (ref lines 207-225)
        weights = np.ones(predicted_times.size)
        if weighted:
            if train_event_times is None or train_event_indicators is None:
                raise ValueError("'weighted' Hinge requires training set values.")
            km_model = KaplanMeierArea(train_event_times, train_event_indicators)
            censor_times = event_times[~event_indicators]
            weights[~event_indicators] = 1 - km_model.predict(censor_times)
        if log_scale:
            errors = np.log(event_times) - np.log(predicted_times)
        else:
            errors = event_times - predicted_times
        errors[~event_indicators] = np.maximum(errors[~event_indicators], 0)
        if not reduction:
            return error_func(errors)
        return float(np.average(error_func(errors), weights=weights))

    if method == "Margin":
        best_guesses = km_model.best_guess(censor_times)
        best_guesses[censor_times > km_linear_zero] = censor_times[censor_times > km_linear_zero]
        errors = np.empty(predicted_times.size)
        if log_scale:
            errors[event_indicators] = (np.log(event_times[event_indicators])
                                        - np.log(predicted_times[event_indicators]))
            errors[~event_indicators] = np.log(best_guesses) - np.log(predicted_times[~event_indicators])
        else:
            errors[event_indicators] = event_times[event_indicators] - predicted_times[event_indicators]
            errors[~event_indicators] = best_guesses - predicted_times[~event_indicators]
        if not reduction:
            return error_func(errors)
        return float(np.average(error_func(errors), weights=weights))

    if method == "IPCW-v1":
        # surrogate = mean train event time after each censor time (ref lines 243-265)
        best_guesses = np.empty(n_test)
        train_events = train_event_times[train_event_indicators == 1]
        for i in range(n_test):
            if event_indicators[i]:
                best_guesses[i] = event_times[i]
            else:
                after = train_events[train_events > event_times[i]]
                best_guesses[i] = np.mean(after) if after.size else np.nan
        nan_idx = np.argwhere(np.isnan(best_guesses))
        predicted_times = np.delete(predicted_times, nan_idx)
        best_guesses = np.delete(best_guesses, nan_idx)
        weights = np.delete(weights, nan_idx)
        if log_scale:
            errors = np.log(best_guesses) - np.log(predicted_times)
        else:
            errors = best_guesses - predicted_times
        if not reduction:
            return error_func(errors)
        return float(np.average(error_func(errors), weights=weights))

    if method == "IPCW-v2":
        # IPCW-D: event-only errors divided by censoring-KM weight
        # (ref MeanError.py:266-281)
        ipc_model = KaplanMeierArea(train_event_times, 1 - train_event_indicators)
        ipc_pred = ipc_model.predict(event_times)
        ipc_pred[ipc_pred == 0] = np.inf
        if log_scale:
            errors = np.log(event_times) - np.log(predicted_times)
        else:
            errors = event_times - predicted_times
        if not reduction:
            return error_func(errors)[event_indicators] / ipc_pred[event_indicators]
        return float((error_func(errors)[event_indicators] / ipc_pred[event_indicators]).mean())

    if method == "Pseudo_obs":
        # pseudo-observation surrogate: leave-one-in KM recomputation per
        # censored subject (ref MeanError.py:282-329)
        best_guesses = _pseudo_obs_best_guesses(
            event_times, event_indicators, train_event_times, train_event_indicators, km_model)
        if log_scale:
            errors = np.log(best_guesses) - np.log(predicted_times)
        else:
            errors = best_guesses - predicted_times
        if not reduction:
            return error_func(errors)
        return float(np.average(error_func(errors), weights=weights))

    if method == "Pseudo_obs_pop":
        # population-mean surrogate (ref MeanError.py:330-341)
        sub_expect_time = km_model.mean
        best_guesses = event_times.copy().astype(float)
        best_guesses[~event_indicators] = sub_expect_time
        if log_scale:
            errors = np.log(best_guesses) - np.log(predicted_times)
        else:
            errors = best_guesses - predicted_times
        if not reduction:
            return error_func(errors)
        return float(np.average(error_func(errors), weights=weights))

    raise ValueError(f"Unknown method '{method}'.")


def km_mean(times: np.ndarray, survival_probabilities: np.ndarray) -> float:
    """Mean of a KM curve via trapezoid + linear zero extension
    (ref eval/SurvivalEVAL/Evaluations/util.py:421-458)."""
    area_probabilities = np.append(1, survival_probabilities)
    area_times = np.append(0, times)
    km_linear_zero = -1 / ((area_probabilities[-1] - 1) / area_times[-1])
    if survival_probabilities[-1] != 0:
        area_times = np.append(area_times, km_linear_zero)
        area_probabilities = np.append(area_probabilities, 0)
    area_diff = np.diff(area_times, 1)
    average_probabilities = (area_probabilities[:-1] + area_probabilities[1:]) / 2
    area = np.flip(np.flip(area_diff * average_probabilities).cumsum())
    area = np.append(area, 0)
    probability_index = np.digitize(0, times)
    surv_prob = np.append(1, survival_probabilities)[probability_index]
    return area[0] / surv_prob


def _pseudo_obs_best_guesses(event_times, event_indicators, train_event_times,
                             train_event_indicators, km_model: KaplanMeierArea):
    """Per-censored-subject KM pseudo-observation (ref MeanError.py:282-320)."""
    n_train = train_event_times.size
    n_test = event_times.size
    events = km_model.events.copy()
    population_counts = km_model.population_count.copy()
    times = km_model.survival_times.copy()
    probs = km_model.survival_probabilities.copy()
    unique_idx = np.where(events != 0)[0]
    if unique_idx[-1] != len(events) - 1:
        unique_idx = np.append(unique_idx, len(events) - 1)
    times = times[unique_idx]
    population_counts = population_counts[unique_idx]
    events = events[unique_idx]
    probs = probs[unique_idx]
    sub_expect_time = km_mean(times.copy(), probs.copy())

    multiplier = 1 - events / population_counts
    multiplier_total = 1 - events / (population_counts + 1)
    best_guesses = event_times.copy().astype(float)
    for i in range(n_test):
        if event_indicators[i] != 1:
            total_multiplier = multiplier.copy()
            insert_index = np.searchsorted(times, event_times[i], side="right")
            total_multiplier[:insert_index] = multiplier_total[:insert_index]
            survival_probabilities = np.cumprod(total_multiplier)
            if insert_index == len(times):
                times_addition = np.append(times, event_times[i])
                surv_addition = np.append(survival_probabilities, survival_probabilities[-1])
                total_expect_time = km_mean(times_addition, surv_addition)
            else:
                total_expect_time = km_mean(times, survival_probabilities)
            best_guesses[i] = (n_train + 1) * total_expect_time - n_train * sub_expect_time
    return best_guesses
