"""Loss registry for the sa/vlsa tasks (counterpart of
vlsa_tpu/losses/registry.py): `load_loss(task, loss_type=[...],
**per_loss_kws)` returns {name: callable}.

Every callable has the signature fn(pred, t, e, **runtime_kws) -> scalar.
`QueryDiv` maps to None: the runner binds it to the network's
query-diversity regulariser.  The classification task's losses are not
ported yet.
"""
from __future__ import annotations

import functools

import torch

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
    cfg = {k: v for k, v in loss_cfg.items() if k != "weight"}
    return functools.partial(fn, **cfg) if cfg else fn


def load_loss(task: str, **kws):
    """{loss_name: fn} for each name of `loss_type`, configured by the
    per-loss keyword dict of the same name."""
    if task == "clf":
        raise NotImplementedError("the classification losses are not ported yet")
    if task not in ("sa", "vlsa"):
        raise NotImplementedError(f"cannot recognize the task {task}.")
    if "loss_type" not in kws:
        raise ValueError("The key `loss_type` is not found in kws.")
    return {name: load_surv_loss_func(name, **kws.get(name, {}))
            for name in kws["loss_type"]}
