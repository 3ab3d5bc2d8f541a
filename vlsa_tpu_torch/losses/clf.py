"""Classification losses (counterpart of vlsa_tpu/losses/clf.py): binary
cross-entropy with smoothing and thresholding, label-smoothing
cross-entropy and soft-target cross-entropy, over logits `x` [B, C].

A target of another shape than `x` holds class indices [B]; BCE and the
soft-target loss turn it into smoothed one-hot rows.  `ret_mean=False`
returns the per-element loss (BCE [B, C], the others [B]), which the CLF
handler's objective averages over the valid rows.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _smooth_one_hot(target: torch.Tensor, num_classes: int, smoothing: float,
                    dtype: torch.dtype) -> torch.Tensor:
    off_value = smoothing / num_classes
    on_value = 1.0 - smoothing + off_value
    one_hot = F.one_hot(target.reshape(-1).long(), num_classes).to(dtype)
    return one_hot * (on_value - off_value) + off_value


def binary_cross_entropy(x: torch.Tensor, target: torch.Tensor, smoothing: float = 0.1,
                         target_threshold: Optional[float] = None,
                         weight: Optional[torch.Tensor] = None,
                         pos_weight: Optional[torch.Tensor] = None,
                         ret_mean: bool = True) -> torch.Tensor:
    """BCE with logits: -(pw t log s(x) + (1 - t) log s(-x)), the log-sigmoid
    pair (finite for any logit)."""
    if target.shape != x.shape:
        target = _smooth_one_hot(target, x.shape[-1], smoothing, x.dtype)
    if target_threshold is not None:
        target = (target > target_threshold).to(x.dtype)
    pw = 1.0 if pos_weight is None else pos_weight
    loss = -(pw * target * F.logsigmoid(x) + (1.0 - target) * F.logsigmoid(-x))
    if weight is not None:
        loss = loss * weight
    return loss.mean() if ret_mean else loss


def label_smoothing_cross_entropy(x: torch.Tensor, target: torch.Tensor,
                                  smoothing: float = 0.1,
                                  weight: Optional[torch.Tensor] = None,
                                  ret_mean: bool = True) -> torch.Tensor:
    """(1 - smoothing) NLL + smoothing x the mean negative log-probability."""
    logprobs = torch.log_softmax(x, dim=-1)
    nll = -torch.gather(logprobs, 1, target.reshape(-1, 1).long())[:, 0]
    loss = (1.0 - smoothing) * nll + smoothing * -logprobs.mean(dim=-1)
    if weight is not None:
        loss = loss * weight
    return loss.mean() if ret_mean else loss


def soft_target_cross_entropy(x: torch.Tensor, target: torch.Tensor, smoothing: float = 0.1,
                              weight: Optional[torch.Tensor] = None,
                              ret_mean: bool = True) -> torch.Tensor:
    """Cross-entropy against (smoothed) soft labels."""
    if target.shape != x.shape:
        target = _smooth_one_hot(target, x.shape[-1], smoothing, x.dtype)
    logprobs = torch.log_softmax(x, dim=-1)
    if weight is not None:
        loss = torch.sum(-target * weight * logprobs, dim=-1)
    else:
        loss = torch.sum(-target * logprobs, dim=-1)
    return loss.mean() if ret_mean else loss
