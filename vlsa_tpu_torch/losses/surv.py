"""Survival losses over [B, K] predictions (counterpart of
vlsa_tpu/losses/surv.py).

Discrete labels `t` are integer bins [B], event indicators `e` [B] (1 = event
observed, 0 = censored).  Every loss takes an optional `sample_mask` [B] so
the padded rows of a ragged tail batch weigh nothing; reductions are means
over the valid samples.
"""
from __future__ import annotations

from typing import Optional

import torch


def _masked_mean(x: torch.Tensor, sample_mask: Optional[torch.Tensor]) -> torch.Tensor:
    if sample_mask is None:
        return torch.mean(x)
    w = sample_mask.to(x.dtype).reshape(x.shape)
    return torch.sum(x * w) / torch.clamp(torch.sum(w), min=1.0)


def _reduce(x: torch.Tensor, reduction: str,
            sample_mask: Optional[torch.Tensor]) -> torch.Tensor:
    if reduction == "mean":
        return _masked_mean(x, sample_mask)
    if reduction == "sum":
        if sample_mask is not None:
            x = x * sample_mask.to(x.dtype).reshape(x.shape)
        return torch.sum(x)
    if reduction == "none":
        return x
    raise ValueError(f"invalid reduction {reduction!r}")


def _at(values: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """values[b, index[b]] for each row b."""
    return torch.gather(values, 1, index[:, None])[:, 0]


def surv_mle(hazards_hat: torch.Tensor, t: torch.Tensor, e: torch.Tensor,
             alpha: float = 0.0, eps: float = 1e-7, cur_alpha: Optional[float] = None,
             sample_mask: Optional[torch.Tensor] = None,
             reduction: str = "mean") -> torch.Tensor:
    """Discrete-hazard negative log-likelihood:
      S = cumprod(1 - h); S_padded = [1, S]
      uncensored: -(log S_padded[t] + log h[t]);  censored: -log S_padded[t+1]
      loss = (1-a) * (cen + unc) + a * unc"""
    B, _K = hazards_hat.shape
    t = t.reshape(B).long()
    e = e.reshape(B).to(hazards_hat.dtype)
    c = 1.0 - e
    S = torch.cumprod(1.0 - hazards_hat, dim=1)
    S_padded = torch.cat([torch.ones_like(S[:, :1]), S], dim=1)
    s_t, h_t, s_t1 = _at(S_padded, t), _at(hazards_hat, t), _at(S_padded, t + 1)
    uncensored = -(1.0 - c) * (torch.log(torch.clamp(s_t, min=eps))
                               + torch.log(torch.clamp(h_t, min=eps)))
    censored = -c * torch.log(torch.clamp(s_t1, min=eps))
    a = alpha if cur_alpha is None else cur_alpha
    loss = (1.0 - a) * (censored + uncensored) + a * uncensored
    return _reduce(loss, reduction, sample_mask)


def surv_ifmle(incidence_hat: torch.Tensor, t: torch.Tensor, e: torch.Tensor,
               alpha: float = 0.0, eps: float = 1e-7, cur_alpha: Optional[float] = None,
               sample_mask: Optional[torch.Tensor] = None,
               reduction: str = "mean") -> torch.Tensor:
    """Incidence-function NLL (DeepHit-style) on softmaxed incidence [B, K]:
      CIF = cumsum(incidence)
      uncensored: -log incidence[t];  censored: -log(1 - CIF[t])"""
    B, _K = incidence_hat.shape
    t = t.reshape(B).long()
    e = e.reshape(B).to(incidence_hat.dtype)
    c = 1.0 - e
    cif = torch.cumsum(incidence_hat, dim=1)
    inc_t, cif_t = _at(incidence_hat, t), _at(cif, t)
    uncensored = -(1.0 - c) * torch.log(torch.clamp(inc_t, min=eps))
    censored = -c * torch.log(torch.clamp(1.0 - cif_t, min=eps))
    a = alpha if cur_alpha is None else cur_alpha
    loss = (1.0 - a) * (censored + uncensored) + a * uncensored
    return _reduce(loss, reduction, sample_mask)


def surv_ple(y_hat: torch.Tensor, t: torch.Tensor, e: torch.Tensor,
             sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cox partial likelihood (Breslow), with the risk set as one outer
    compare: R[i, j] = 1 if t_j >= t_i."""
    theta = torch.clamp(y_hat.reshape(-1), max=10.0)  # overflow clamp
    t = t.reshape(-1)
    e = e.reshape(-1).to(theta.dtype)
    R = (t[None, :] >= t[:, None]).to(theta.dtype)
    if sample_mask is not None:
        m = sample_mask.reshape(-1).to(theta.dtype)
        R = R * m[None, :]
        e = e * m
        denom = torch.clamp(torch.sum(m), min=1.0)
    else:
        denom = theta.shape[0]
    log_risk = torch.log(torch.sum(torch.exp(theta)[None, :] * R, dim=1))
    return -torch.sum((theta - log_risk) * e) / denom


def recon_loss(pred_t: torch.Tensor, t: torch.Tensor, e: torch.Tensor,
               alpha: float = 0.0, gamma: float = 1.0, norm: str = "l1",
               cur_alpha: Optional[float] = None,
               sample_mask: Optional[torch.Tensor] = None, **_) -> torch.Tensor:
    """Continuous-time reconstruction loss."""
    pred_t = pred_t.reshape(-1)
    t = t.reshape(-1).to(pred_t.dtype)
    e = e.reshape(-1).to(pred_t.dtype)
    loss_obs = e * torch.abs(pred_t - t)
    loss_cen = (1.0 - e) * torch.relu(gamma - (pred_t - t))
    if norm == "l2":
        loss_obs = loss_obs * loss_obs
        loss_cen = loss_cen * loss_cen
    a = alpha if cur_alpha is None else cur_alpha
    loss = (1.0 - a) * (loss_obs + loss_cen) + a * loss_obs
    return _masked_mean(loss, sample_mask)


def rank_loss(pred_t: torch.Tensor, t: torch.Tensor, e: torch.Tensor,
              gamma: float = 1.0, norm: str = "l1", add_weight: bool = False,
              sample_mask: Optional[torch.Tensor] = None, **_) -> torch.Tensor:
    """Pairwise ranking hinge over comparable pairs (i, j): e_i = 1 and
    t_i < t_j, on gamma + pred_i - pred_j; 0 when no pair exists."""
    pred_t = pred_t.reshape(-1)
    t = t.reshape(-1)
    e = e.reshape(-1)
    pair_mask = ((t[:, None] < t[None, :]) & (e[:, None] == 1)).to(pred_t.dtype)
    if sample_mask is not None:
        m = sample_mask.reshape(-1).to(pred_t.dtype)
        pair_mask = pair_mask * m[:, None] * m[None, :]
    pair_diff = pred_t[:, None] - pred_t[None, :]
    pair_loss = torch.relu(gamma + pair_diff)
    if norm == "l2":
        pair_loss = pair_loss * pair_loss
    elif norm != "l1":
        raise NotImplementedError(f"norm must be l1/l2, got {norm}")
    if add_weight:
        # masked log-softmax over the pair differences
        maxx = torch.max(pair_diff * pair_mask + (1.0 - 1.0 / (pair_mask + 1e-5)))
        log_ex = pair_diff - maxx
        log_softmax = log_ex - torch.log(torch.sum(torch.exp(log_ex * pair_mask) * pair_mask))
        normed_weight = torch.exp(log_softmax * pair_mask) * pair_mask
    else:
        normed_weight = pair_mask / torch.clamp(torch.sum(pair_mask), min=1e-12)
    return torch.sum(pair_loss * normed_weight)


def mse_loss(pred_t: torch.Tensor, t: torch.Tensor, e: torch.Tensor,
             include_censored: bool = False,
             sample_mask: Optional[torch.Tensor] = None, **_) -> torch.Tensor:
    """Event-only (optionally all-sample) squared error."""
    pred_t = pred_t.reshape(-1)
    t = t.reshape(-1).to(pred_t.dtype)
    e = e.reshape(-1).to(pred_t.dtype)
    loss = e * (pred_t - t) ** 2
    if include_censored:
        loss = loss + (1.0 - e) * (pred_t - t) ** 2
    return _masked_mean(loss, sample_mask)
