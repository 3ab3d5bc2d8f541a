"""Distribution calibration (D-Calibration) chi-square test.

Behavioural port of ref eval/SurvivalEVAL/Evaluations/D_Calibration.py:54-198:
events histogram directly into probability deciles; censored subjects are
"blurred" across bins below their survival probability.

The port's own copy of vlsa_tpu/eval/d_calibration.py (numpy and scipy only, the same
float64 arithmetic); tests/test_torch_eval.py holds it against the original.
"""
from __future__ import annotations

import numpy as np
from scipy.stats import chisquare


def create_censor_binning(probability: float, num_bins: int) -> np.ndarray:
    quantile = np.linspace(1, 0, num_bins + 1)
    censor_binning = np.zeros(num_bins)
    for i in range(num_bins):
        if probability == 1:
            censor_binning += 0.1
            break
        elif quantile[i] > probability >= quantile[i + 1]:
            first_bin = (probability - quantile[i + 1]) / probability if probability != 0 else 1
            rest_bins = 1 / (num_bins * probability) if probability != 0 else 0
            censor_binning[i] += first_bin
            censor_binning[i + 1:] += rest_bins
            break
    return censor_binning


def d_calibration(predict_probs, event_indicators, num_bins: int = 10):
    """Returns (p-value, combined histogram)."""
    predict_probs = np.asarray(predict_probs, dtype=float)
    event_indicators = np.asarray(event_indicators)
    quantile = np.linspace(1, 0, num_bins + 1)
    censor_indicators = 1 - event_indicators

    event_probabilities = predict_probs[event_indicators.astype(bool)]
    event_position = np.digitize(event_probabilities, quantile)
    event_position[event_position == 0] = 1  # probability == 1 -> first bin

    event_binning = np.zeros([num_bins])
    for pos in event_position:
        event_binning[pos - 1] += 1

    censored_probabilities = predict_probs[censor_indicators.astype(bool)]
    censor_binning = np.zeros([num_bins])
    for prob in censored_probabilities:
        censor_binning += create_censor_binning(prob, num_bins)

    combine_binning = event_binning + censor_binning
    _, pvalue = chisquare(combine_binning)
    return pvalue, combine_binning
