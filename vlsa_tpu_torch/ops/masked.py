"""Mask-aware pooling primitives (counterpart of vlsa_tpu/ops/masked.py).

Every reduction over a bag's patch axis must ignore padded positions once
bags are padded to a common length; these helpers are the single source of
truth for that masking.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def compute_float(x: torch.Tensor) -> torch.Tensor:
    """x in f32, the compute type of every plain path; a float64 tensor stays
    float64, so a model cast to float64 computes in float64 throughout (the
    CPU tests hold identities there that f32 rounding would blur)."""
    return x if x.dtype == torch.float64 else x.float()


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


def masked_topk_mean(logits: torch.Tensor, mask: Optional[torch.Tensor],
                     topk: int) -> torch.Tensor:
    """Mean of the top-k per-class logits over a bag's valid patches (MI-Zero
    pooling), as vlsa_tpu computes it: k is clamped to N, then to the bag's
    valid count (at least 1); masked rows are NEG_INF, so an empty bag gives
    NEG_INF.

    logits [N, C] or [B, N, C]; mask [N] / [B, N] -> [C] / [B, C]."""
    if logits.dim() == 2:
        return masked_topk_mean(logits[None], None if mask is None else mask[None], topk)[0]
    B, N, _C = logits.shape
    if mask is None:
        mask = torch.ones(B, N, dtype=torch.bool, device=logits.device)
    mask = mask.to(torch.bool)
    masked = torch.where(mask[..., None], logits,
                         torch.full((), NEG_INF, dtype=logits.dtype, device=logits.device))
    k = min(topk, N)
    vals = torch.topk(masked.transpose(1, 2), k, dim=-1).values  # [B, C, k], descending
    take = torch.clamp(mask.sum(dim=1), min=1).clamp(max=k)  # [B]
    w = (torch.arange(k, device=logits.device)[None, :] < take[:, None]).to(logits.dtype)
    return torch.sum(vals * w[:, None, :], dim=-1) / torch.clamp(w.sum(-1), min=1.0)[:, None]
