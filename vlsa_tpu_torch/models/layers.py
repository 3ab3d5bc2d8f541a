"""Shared layers (counterpart of vlsa_tpu/models/layers.py)."""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


class TorchLinear(nn.Linear):
    """nn.Linear with torch's default initialisation drawn from an explicit
    generator: weight and bias ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        self._generator = generator
        super().__init__(in_features, out_features, bias=bias)

    def reset_parameters(self) -> None:
        bound = 1.0 / math.sqrt(self.in_features)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=self._generator)
            if self.bias is not None:
                self.bias.uniform_(-bound, bound, generator=self._generator)


class Adapter(nn.Module):
    """Bottleneck MLP adapter: relu(fc2(relu(fc1(x))))."""

    def __init__(self, dim: int, reduction: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc1 = TorchLinear(dim, dim // reduction, bias=False, generator=generator)
        self.fc2 = TorchLinear(dim // reduction, dim, bias=False, generator=generator)

    def forward(self, x):
        return torch.relu(self.fc2(torch.relu(self.fc1(x))))


class FeatProjecter(nn.Module):
    """Linear + LayerNorm projector."""

    def __init__(self, in_dim: int, out_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.linear = TorchLinear(in_dim, out_dim, generator=generator)
        self.norm = nn.LayerNorm(out_dim, eps=1e-5)

    def forward(self, x):
        return self.norm(self.linear(x))
