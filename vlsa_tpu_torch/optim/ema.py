"""Exponential moving average of a model's parameters (counterpart of
vlsa_tpu/optim/ema.py, itself the reference's vendored timm EMA; no runner of
either package calls it):

    shadow <- decay * shadow + (1 - decay) * params
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn


class ModelEma:
    """The shadow of every parameter of `model` (by name, detached copies on
    the parameters' devices), moved towards the parameters by `update`."""

    def __init__(self, model: nn.Module, decay: float = 0.9999):
        self.decay = decay
        self.shadow: Dict[str, torch.Tensor] = {
            name: p.detach().clone() for name, p in model.named_parameters()}

    @torch.no_grad()
    def update(self, model: nn.Module) -> Dict[str, torch.Tensor]:
        for name, p in model.named_parameters():
            s = self.shadow[name]
            s.copy_(self.decay * s + (1.0 - self.decay) * p.detach())
        return self.shadow

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return self.shadow
