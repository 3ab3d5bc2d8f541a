"""Exact Shapley values over the prognostic priors (counterpart of
vlsa_tpu/interpret/shapley.py).

The value of a coalition S of the P priors is the expected risk

    v(S) = sum_k (K - k) * softmax(logit_scale * mean_{p in S} sim[p])_k,

v(empty) = 1, and the Shapley value of prior i is

    phi_i = sum_{S not containing i} W[|S|] * (v(S + i) - v(S)),
    W[s] = s! (P - s - 1)! / P!.

The reference enumerates the 2^P coalitions in a Python loop
(ref utils/model_inference.py:23-79); here the [2^P, P] membership masks
(bit i of a coalition's index = prior i, the reference's int2bin order)
evaluate every coalition of every patient in one batched product and
softmax, and each prior's sum is a masked weighted reduction over the
coalitions: [B, P, K] -> [B, P].  Torch ops on the input's device: vlsa_tpu
computes this in XLA, outside any kernel.

The value function and the sums run in float64 and the result is returned
in float32: each phi_i is a sum of 2^(P-1) differences of values near each
other, which f32 would leave with ~1e-6 of absolute rounding; f64 costs
nothing at 2^12 coalitions.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

_CONSTANTS: Dict[Tuple[int, str], Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}


def _coalition_constants(num_p: int, device: torch.device):
    """(masks [2^P, P] f64, partners [P, 2^P] long, weights [P, 2^P] f64),
    cached per (P, device): partners[i, c] = c | 2^i, weights[i, c] =
    W[|c|] where prior i is not in coalition c, else 0."""
    key = (num_p, str(device))
    if key not in _CONSTANTS:
        idx = np.arange(2 ** num_p, dtype=np.int64)
        bits = (idx[None, :] >> np.arange(num_p)[:, None]) & 1        # [P, C]
        sizes = bits.sum(0)                                           # [C]
        fac = [math.factorial(i) for i in range(num_p + 1)]
        w_by_size = np.array([fac[s] * fac[num_p - s - 1] / fac[num_p]
                              for s in range(num_p)] + [0.0])
        weights = np.where(bits == 0, w_by_size[sizes][None, :], 0.0)
        partners = idx[None, :] | (1 << np.arange(num_p))[:, None]
        _CONSTANTS[key] = (torch.tensor(bits.T, dtype=torch.float64, device=device),
                           torch.tensor(partners, device=device),
                           torch.tensor(weights, dtype=torch.float64, device=device))
    return _CONSTANTS[key]


def batched_shapley(decoupled_similarities: torch.Tensor, logit_scale: float) -> torch.Tensor:
    """[B, P, K] prior-by-bin similarities -> [B, P] Shapley importances
    (f32, on the input's device)."""
    sim = torch.as_tensor(decoupled_similarities).to(torch.float64)
    B, num_p, num_k = sim.shape
    masks, partners, weights = _coalition_constants(num_p, sim.device)
    counts = masks.sum(1).clamp(min=1.0)                              # [C]
    mean_sim = torch.einsum("cp,bpk->bck", masks, sim) / counts[None, :, None]
    prob = torch.softmax(float(logit_scale) * mean_sim, dim=-1)       # [B, C, K]
    k_weights = num_k - torch.arange(num_k, dtype=torch.float64, device=sim.device)
    V = prob @ k_weights                                              # [B, C]
    V[:, 0] = 1.0                                                     # v(empty)
    gain = V[:, partners] - V[:, None, :]                             # [B, P, C]
    return torch.sum(weights * gain, dim=-1).to(torch.float32)


def shapley_values(decoupled_similarity: torch.Tensor, logit_scale: float) -> torch.Tensor:
    """[P, K] -> [P]: one patient's Shapley importances."""
    return batched_shapley(torch.as_tensor(decoupled_similarity)[None], logit_scale)[0]


def evaluate_prototype_shap_imp(decoupled_similarity, logit_scale, verbose: bool = False
                                ) -> np.ndarray:
    """The reference function's interface: numpy (or a tensor) in, numpy
    [P] out."""
    if not isinstance(decoupled_similarity, torch.Tensor):
        decoupled_similarity = torch.as_tensor(np.asarray(decoupled_similarity, np.float32))
    out = shapley_values(decoupled_similarity, float(logit_scale))
    if verbose:
        print("[SHAP] Sum over SHAP values =", float(out.sum()))
    return out.cpu().numpy()
