"""Mask-aware pooling primitives (counterpart of vlsa_tpu/ops/masked.py).

Every reduction over a bag's patch axis must ignore padded positions once
bags are padded to a common length; these helpers are the single source of
truth for that masking.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """x / sqrt(max(sum(x^2), eps^2)): rows of zeros stay zero and get a zero
    gradient, as `torch.nn.functional.normalize` gives them."""
    sq = torch.sum(x * x, dim=dim, keepdim=True)
    return x / torch.sqrt(torch.clamp(sq, min=eps * eps))


def masked_softmax(logits: torch.Tensor, mask: Optional[torch.Tensor],
                   dim: int = -1) -> torch.Tensor:
    """Softmax that gives masked positions exactly zero probability (a row
    with no valid position is all zeros)."""
    if mask is None:
        return torch.softmax(logits, dim=dim)
    mask = mask.to(torch.bool)
    neg = torch.where(mask, 0.0, NEG_INF).to(logits.dtype)
    probs = torch.softmax(logits + neg, dim=dim)
    return torch.where(mask, probs, torch.zeros((), dtype=probs.dtype,
                                                device=probs.device))


def _expand(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    while mask.dim() < ndim:
        mask = mask[..., None]
    return mask


def masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor], dim: int) -> torch.Tensor:
    if mask is None:
        return torch.mean(x, dim=dim)
    m = _expand(mask.to(x.dtype), x.dim())
    cnt = torch.clamp(torch.sum(m, dim=dim), min=1.0)
    return torch.sum(x * m, dim=dim) / cnt


def masked_max(x: torch.Tensor, mask: Optional[torch.Tensor], dim: int) -> torch.Tensor:
    if mask is None:
        return torch.amax(x, dim=dim)
    m = _expand(mask.to(torch.bool), x.dim())
    return torch.amax(torch.where(m, x, torch.full((), NEG_INF, dtype=x.dtype,
                                                   device=x.device)), dim=dim)
