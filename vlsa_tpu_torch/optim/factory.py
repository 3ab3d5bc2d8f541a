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
scheduler can change it.  Every name of vlsa_tpu's factory is built: the
rest of them (nadam, radam, adadelta, adafactor, novograd / nvnovograd,
rmsprop / rmsproptf, adamp, sgdp, adahessian) by `optim.extra`, each
following vlsa_tpu's optax chain; `lookahead_<name>` wraps any of them but
adahessian in `extra.Lookahead` (k=6, alpha=0.5).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import torch
from torch import nn

from . import extra

OPTIMIZERS = ("adam", "adamw", "sgd", "nesterov", "momentum", "nadam", "radam", "adadelta",
              "adafactor", "novograd", "nvnovograd", "rmsprop", "rmsproptf", "adamp", "sgdp",
              "adahessian")


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


def _base_optimizer(name: str, lr: float, groups: List[dict], **kws) -> torch.optim.Optimizer:
    eps = kws.get("opt_eps") or 1e-8
    betas = tuple(kws.get("opt_betas") or (0.9, 0.999))
    momentum = kws.get("momentum") or 0.9
    if name == "adam":
        return torch.optim.Adam(groups, lr=lr, betas=betas, eps=eps)
    if name == "adamw":
        return torch.optim.AdamW(groups, lr=lr, betas=betas, eps=eps)
    if name in ("sgd", "nesterov", "momentum"):
        return torch.optim.SGD(groups, lr=lr, momentum=momentum,
                               nesterov=name in ("sgd", "nesterov"))
    if name == "nadam":
        return extra.Nadam(groups, lr, betas=betas, eps=eps)
    if name == "radam":
        return extra.RAdam(groups, lr, betas=betas, eps=eps)
    if name == "adadelta":
        return extra.Adadelta(groups, lr)
    if name == "adafactor":
        return extra.Adafactor(groups, lr)
    if name in ("novograd", "nvnovograd"):
        return extra.NovoGrad(groups, lr, betas=betas, eps=eps)
    if name in ("rmsprop", "rmsproptf"):
        return extra.RMSprop(groups, lr, eps=eps, momentum=momentum)
    if name == "adamp":
        return extra.AdamP(groups, lr, betas=betas, eps=eps)
    if name == "sgdp":
        return extra.SGDP(groups, lr, momentum=momentum, eps=eps)
    return extra.Adahessian(groups, lr, betas=betas, eps=eps)


def split_opt_name(opt_name: str) -> Tuple[str, bool]:
    """(the base optimizer's name, whether `opt_name` is
    `lookahead_<base>`), lower case."""
    name = opt_name.lower()
    parts = name.split("_")
    lookahead = len(parts) > 1 and parts[0] == "lookahead"
    return ("_".join(parts[1:]) if lookahead else name), lookahead


def create_optimizer(opt_name: str, lr: float, weight_decay: float, model: nn.Module,
                     **kws) -> torch.optim.Optimizer:
    """The optimizer over `model`'s trainable parameters (call
    `frozen_mask_from_cfg` first to freeze some): one of OPTIMIZERS, or
    `lookahead_<one of them>` (adahessian excepted, as in vlsa_tpu)."""
    base, lookahead = split_opt_name(opt_name)
    if base not in OPTIMIZERS:
        raise NotImplementedError(f"optimizer {opt_name!r}: vlsa_tpu's factory has {OPTIMIZERS} "
                                  "and lookahead_<one of them>")
    opt = _base_optimizer(base, lr, _param_groups(model, weight_decay or 0.0), **kws)
    if lookahead:
        opt = extra.Lookahead(opt)
    return opt
