"""Ordinal and vision-language survival losses (counterpart of
vlsa_tpu/losses/surv_ext.py)."""
from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = -1e30


def cdf_loss(pred_dist: torch.Tensor, target_dist: torch.Tensor, p: int = 1,
             normalize_dist: bool = True, ret_raw: bool = False) -> torch.Tensor:
    """Wasserstein-p distance between 1-D distributions via their CDFs;
    per-row distances [B]."""
    if normalize_dist:
        pred_dist = pred_dist / (torch.sum(pred_dist, dim=-1, keepdim=True) + 1e-14)
        target_dist = target_dist / (torch.sum(target_dist, dim=-1, keepdim=True) + 1e-14)
    diff = torch.cumsum(pred_dist, dim=-1) - torch.cumsum(target_dist, dim=-1)
    if p == 1:
        return torch.sum(torch.abs(diff), dim=-1)
    if p == 2:
        raw = torch.sum(diff * diff, dim=-1)
        return raw if ret_raw else torch.sqrt(raw)
    raw = torch.sum(torch.abs(diff) ** p, dim=-1)
    return raw if ret_raw else raw ** (1.0 / p)


def convert_survival_label(t: torch.Tensor, e: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Censoring-aware target [B, K] (int64): one-hot at bin t; a censored
    row (e=0) also sets every bin after t."""
    t = t.reshape(-1).long()
    e = e.reshape(-1).long()
    k = torch.arange(n_bins, device=t.device)[None, :]
    onehot = (k == t[:, None]).long()
    after = (k > t[:, None]).long()
    return onehot + after * (1 - e[:, None])


def _as_scale(cur_logit_scale, like: torch.Tensor) -> torch.Tensor:
    """The logit scale as a detached tensor (its gradient is stopped)."""
    return torch.as_tensor(cur_logit_scale, dtype=like.dtype, device=like.device).detach()


def surv_emd(y_hat: torch.Tensor, t: torch.Tensor, e: torch.Tensor, cur_logit_scale=10.0,
             p: int = 2, raw_distance: bool = True, reduction: str = "mean",
             sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """EMD^p ordinal loss between the softmaxed incidence y_hat [B, K] and a
    censoring-aware target; `cur_logit_scale` (logit_scale.exp()) is
    detached."""
    _B, n_bins = y_hat.shape
    ls = _as_scale(cur_logit_scale, y_hat)
    e_col = e.reshape(-1, 1).to(y_hat.dtype)
    target = convert_survival_label(t, e, n_bins).to(y_hat.dtype)
    target_dist = torch.softmax((2.0 * target - 1.0) * ls, dim=-1)
    # censored rows: target slots take the (large) logit scale, so the
    # softmax puts the mass on the plausible bins
    pred = (1.0 - e_col) * ((1.0 - target) * y_hat + target * ls) + e_col * y_hat
    pred_dist = torch.softmax(pred, dim=-1)
    loss = cdf_loss(pred_dist, target_dist, p=p, normalize_dist=False, ret_raw=raw_distance)
    if reduction == "mean":
        if sample_mask is None:
            return torch.mean(loss)
        w = sample_mask.to(loss.dtype).reshape(-1)
        return torch.sum(loss * w) / torch.clamp(torch.sum(w), min=1.0)
    if reduction == "sum":
        if sample_mask is not None:
            loss = loss * sample_mask.to(loss.dtype).reshape(-1)
        return torch.sum(loss)
    return loss


def sup_con_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Supervised contrastive loss."""
    logits = logits - torch.amax(logits, dim=1, keepdim=True).detach()
    log_prob = logits - torch.log(torch.sum(torch.exp(logits), dim=1, keepdim=True))
    mean_log_prob_pos = torch.sum(targets * log_prob, dim=1) / torch.sum(targets, dim=1)
    return -torch.mean(mean_log_prob_pos)


def surv_t2i(raw_y_hat: torch.Tensor, t: torch.Tensor, e: torch.Tensor,
             cur_logit_scale=10.0, loss: str = "CL", reduction: str = "mean",
             sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Text-to-image contrastive (CL) or KL loss over the per-bin logit
    columns, every bin a masked row computed at once:

      sel[k, b]   = not (target[k, b] == 1 and e_b == 0)   (drops the
                    ambiguous censored slots)
      valid bin k = any(sel[k]) and sum(target[k] * sel[k]) > 0
    """
    logits = raw_y_hat.T  # [K, B]
    n_bins, _bsz = logits.shape
    ls = _as_scale(cur_logit_scale, logits)
    targets = convert_survival_label(t, e, n_bins).to(logits.dtype).T  # [K, B]
    e_row = e.reshape(1, -1).to(logits.dtype)
    sel = ~((targets == 1.0) & (e_row == 0.0))
    if sample_mask is not None:
        sel = sel & sample_mask.reshape(1, -1).to(torch.bool)
    sel_f = sel.to(logits.dtype)
    pos = targets * sel_f
    valid = torch.any(sel, dim=1) & (torch.sum(pos, dim=1) > 0)  # [K]
    neg = torch.full_like(logits, _NEG_INF)

    if loss == "CL":
        row_max = torch.amax(torch.where(sel, logits, neg), dim=1, keepdim=True).detach()
        shifted = logits - row_max
        denom = torch.sum(torch.exp(shifted) * sel_f, dim=1, keepdim=True)
        log_prob = shifted - torch.log(torch.clamp(denom, min=1e-30))
        per_bin = -(torch.sum(pos * log_prob, dim=1)
                    / torch.clamp(torch.sum(pos, dim=1), min=1e-12))
    elif loss == "KL":
        t_logits = torch.where(sel, (2.0 * targets - 1.0) * ls, neg)
        t_exp = torch.exp(t_logits - torch.amax(t_logits, dim=1, keepdim=True)) * sel_f
        t_dist = t_exp / torch.clamp(torch.sum(t_exp, dim=1, keepdim=True), min=1e-30)
        p_max = torch.amax(torch.where(sel, logits, neg), dim=1, keepdim=True).detach()
        p_shift = logits - p_max
        p_denom = torch.sum(torch.exp(p_shift) * sel_f, dim=1, keepdim=True)
        log_pred = p_shift - torch.log(torch.clamp(p_denom, min=1e-30))
        log_t = torch.where(t_dist > 0, torch.log(torch.clamp(t_dist, min=1e-30)), 0.0)
        per_bin = torch.sum(torch.where(sel, t_dist * (log_t - log_pred), 0.0), dim=1)
    else:
        raise NotImplementedError(f"Expected loss = CL or KL, but got {loss}.")

    valid_f = valid.to(per_bin.dtype)
    total = torch.sum(per_bin * valid_f)
    num_slot = torch.sum(valid_f)
    if reduction == "mean":
        return torch.where(num_slot > 0, total / torch.clamp(num_slot, min=1.0),
                           torch.zeros_like(total))
    return total
