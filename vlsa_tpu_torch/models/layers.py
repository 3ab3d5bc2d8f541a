"""Shared layers (counterpart of vlsa_tpu/models/layers.py)."""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..ops.abmil import abmil_pool


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


class AttentionPooling(nn.Module):
    """ABMIL global attention pooling: x [B, N, D], mask [B, N] -> pooled
    [B, D] f32 through `ops.abmil.abmil_pool` (the Hopper kernels for CUDA
    tensors).

    The parameters keep the vlsa_tpu tree's names and layouts, fc1_kernel
    [D, hid], fc1_bias [hid], fc2_kernel [hid, 1] and fc2_bias [1], so the
    weight bridge maps them one to one and the decay split (ndim != 1)
    decays the same leaves, fc2_kernel included.  Torch's default Linear
    initialisation, U(+-1/sqrt(fan_in)), from `generator`.  fc2_bias cancels
    in the softmax and gets no gradient.  The attention map itself (the
    interpretation route) is not ported yet."""

    def __init__(self, dim: int, hid_dim: int = 512,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        b_in, b_hid = 1.0 / math.sqrt(dim), 1.0 / math.sqrt(hid_dim)
        self.fc1_kernel = nn.Parameter(torch.empty(dim, hid_dim).uniform_(
            -b_in, b_in, generator=generator))
        self.fc1_bias = nn.Parameter(torch.empty(hid_dim).uniform_(
            -b_in, b_in, generator=generator))
        self.fc2_kernel = nn.Parameter(torch.empty(hid_dim, 1).uniform_(
            -b_hid, b_hid, generator=generator))
        self.fc2_bias = nn.Parameter(torch.empty(1).uniform_(-b_hid, b_hid, generator=generator))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                x_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
        return abmil_pool(x, mask, self.fc1_kernel.T, self.fc1_bias, self.fc2_kernel[:, 0],
                          self.fc2_bias[0], x_scale=x_scale)
