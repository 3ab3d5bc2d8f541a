"""Optimizer factory with timm's weight-decay split and parameter freezing
(counterpart of vlsa_tpu/optim/factory.py).

  * parameters with ndim == 1 (biases, LayerNorm weights) get no weight
    decay; everything else, the scalar logit_scale included, does, as in
    timm;
  * `adam` is torch.optim.Adam: L2 coupled (added to the gradient before the
    moments); `adamw` decouples it;
  * frozen parameters have requires_grad=False, so they get no gradient, no
    optimizer state and no update.

The learning rate lives in each optimizer's `param_groups`, where a
scheduler can change it.  nadam, radam, adadelta, adafactor, novograd,
rmsprop, adamp, sgdp, adahessian and lookahead are not ported yet.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import torch
from torch import nn

OPTIMIZERS = ("adam", "adamw", "sgd", "nesterov", "momentum")


def decay_mask(model: nn.Module) -> Dict[str, bool]:
    """{name: True where weight decay applies}: every parameter whose ndim is
    not 1."""
    return {name: p.dim() != 1 for name, p in model.named_parameters()}


def frozen_mask_from_cfg(model: nn.Module, frozen_paths: Iterable[str]) -> Dict[str, bool]:
    """Freeze the parameters under `frozen_paths` (top-level or nested names,
    "a/b" or "a.b") with requires_grad_(False); returns {name: frozen}."""
    prefixes = [p.replace("/", ".") for p in frozen_paths]
    frozen = {}
    for name, p in model.named_parameters():
        frozen[name] = any(name == fp or name.startswith(fp + ".") for fp in prefixes)
        if frozen[name]:
            p.requires_grad_(False)
    return frozen


def _param_groups(model: nn.Module, weight_decay: float) -> List[dict]:
    decays = decay_mask(model)
    decay: List[Tuple[str, nn.Parameter]] = []
    no_decay: List[Tuple[str, nn.Parameter]] = []
    for name, p in model.named_parameters():
        if p.requires_grad:
            (decay if decays[name] else no_decay).append((name, p))
    groups = [{"params": [p for _n, p in decay], "names": [n for n, _p in decay],
               "weight_decay": weight_decay},
              {"params": [p for _n, p in no_decay], "names": [n for n, _p in no_decay],
               "weight_decay": 0.0}]
    return [g for g in groups if g["params"]]


def create_optimizer(opt_name: str, lr: float, weight_decay: float, model: nn.Module,
                     **kws) -> torch.optim.Optimizer:
    """The optimizer over `model`'s trainable parameters (call
    `frozen_mask_from_cfg` first to freeze some)."""
    name = opt_name.lower()
    if name not in OPTIMIZERS:
        raise NotImplementedError(f"optimizer {opt_name!r}: this port has {OPTIMIZERS}")
    wd = weight_decay or 0.0
    eps = kws.get("opt_eps") or 1e-8
    betas = tuple(kws.get("opt_betas") or (0.9, 0.999))
    momentum = kws.get("momentum") or 0.9
    groups = _param_groups(model, wd)
    if name == "adam":
        return torch.optim.Adam(groups, lr=lr, betas=betas, eps=eps)
    if name == "adamw":
        return torch.optim.AdamW(groups, lr=lr, betas=betas, eps=eps)
    return torch.optim.SGD(groups, lr=lr, momentum=momentum,
                           nesterov=name in ("sgd", "nesterov"))
