"""Loss registry (counterpart of vlsa_tpu/losses/registry.py):
`load_loss(task, loss_type=[...], **per_loss_kws)` returns {name: callable}.

A survival callable (tasks sa, vlsa) has the signature fn(pred, t, e,
**runtime_kws) -> scalar; a classification one (task clf) fn(logits,
target, ret_mean=True).  `QueryDiv` maps to None: the runner binds it to
the network's query-diversity regulariser.
"""
from __future__ import annotations

import functools

import torch

from . import clf as _clf
from . import surv as _surv
from . import surv_ext as _surv_ext

_SURV_FUNCS = {
    "SurvMLE": _surv.surv_mle,
    "SurvIFMLE": _surv.surv_ifmle,
    "SurvPLE": _surv.surv_ple,
    "recon_loss": _surv.recon_loss,
    "rank_loss": _surv.rank_loss,
    "MSE_loss": _surv.mse_loss,
    "SurvEMD": _surv_ext.surv_emd,
    "SurvT2I": _surv_ext.surv_t2i,
}


_CLF_FUNCS = {
    "BCE": _clf.binary_cross_entropy,
    "CE": _clf.soft_target_cross_entropy,
    "LabelSmoothingCrossEntropy": _clf.label_smoothing_cross_entropy,
    "SoftTargetCrossEntropy": _clf.soft_target_cross_entropy,
    "BinaryCrossEntropy": _clf.binary_cross_entropy,
}


def _filter_kws(kws: dict) -> dict:
    return {k: v for k, v in kws.items() if k != "weight"}


def _cross_entropy(pred, t, e, **_):
    """Cross-entropy over discrete bins (ablation configs)."""
    logprobs = torch.log(torch.clamp(pred, min=1e-12))
    return -torch.mean(torch.gather(logprobs, 1, t.reshape(-1, 1).long()))


def load_surv_loss_func(loss_type: str, **loss_cfg):
    if loss_type == "QueryDiv":
        return None
    if loss_type == "CE":
        return _cross_entropy
    if loss_type not in _SURV_FUNCS:
        raise ValueError(f"unknown survival loss: {loss_type}")
    fn = _SURV_FUNCS[loss_type]
    cfg = _filter_kws(loss_cfg)
    return functools.partial(fn, **cfg) if cfg else fn


def load_clf_loss_func(loss_type: str, **loss_cfg):
    """BCE and CE take only `smoothing` (and BCE `target_thresh`) from the
    config; the other names every key but `weight`."""
    if loss_type == "BCE":
        return functools.partial(_clf.binary_cross_entropy,
                                 smoothing=loss_cfg.get("smoothing", 0.1),
                                 target_threshold=loss_cfg.get("target_thresh"))
    if loss_type == "CE":
        return functools.partial(_clf.soft_target_cross_entropy,
                                 smoothing=loss_cfg.get("smoothing", 0.1))
    if loss_type not in _CLF_FUNCS:
        raise ValueError(f"unknown clf loss: {loss_type}")
    cfg = _filter_kws(loss_cfg)
    fn = _CLF_FUNCS[loss_type]
    return functools.partial(fn, **cfg) if cfg else fn


def load_loss(task: str, **kws):
    """{loss_name: fn} for each name of `loss_type`, configured by the
    per-loss keyword dict of the same name."""
    if task not in ("clf", "sa", "vlsa"):
        raise NotImplementedError(f"cannot recognize the task {task}.")
    if "loss_type" not in kws:
        raise ValueError("The key `loss_type` is not found in kws.")
    loader = load_clf_loss_func if task == "clf" else load_surv_loss_func
    return {name: loader(name, **kws.get(name, {})) for name in kws["loss_type"]}
