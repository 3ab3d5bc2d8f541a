"""Shared layers (counterpart of vlsa_tpu/models/layers.py)."""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..ops.abmil import abmil_pool
from ..ops.coattn import dequantize_feats
from ..ops.masked import compute_float, masked_softmax


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


class SeededDropout(nn.Module):
    """Dropout whose masks come from a `torch.Generator` of its own on the
    input's device, seeded with `seed` at its first use there: two models
    built with one seed drop the same units in the same calls, on any
    device, and the global RNG is left alone.  Active only when the caller
    passes `train=True` (vlsa_tpu's `deterministic=not train`); a kept unit
    is scaled by 1/(1-p).  The generators' state is not part of the state
    dict.  vlsa_tpu draws its masks from threefry, so the masks, and with
    them train-mode outputs, agree with vlsa_tpu's only in distribution."""

    def __init__(self, p: float, seed: int = 0):
        super().__init__()
        if not 0.0 <= p < 1.0:
            raise ValueError(f"dropout rate must be in [0, 1), got {p}")
        self.p = float(p)
        self.seed = int(seed)
        self._generators = {}

    def generator(self, device: torch.device) -> torch.Generator:
        key = str(device)
        if key not in self._generators:
            self._generators[key] = torch.Generator(device=device).manual_seed(self.seed)
        return self._generators[key]

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train or self.p == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.generator(x.device), device=x.device,
                          dtype=torch.float32) >= self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros((), dtype=x.dtype,
                                                                 device=x.device))


class AttentionPooling(nn.Module):
    """ABMIL global attention pooling: x [B, N, D], mask [B, N] -> pooled
    [B, D] f32 through `ops.abmil.abmil_pool` (the Hopper kernels for CUDA
    tensors).

    With `need_attn` the explicit path of vlsa_tpu (its `fused_ok` excludes
    `need_attn`) runs instead, as plain ops on every device, and returns
    (pooled, attention): a_raw = tanh(x W1 + b1) w2 + b2 [B, N] (b2
    included) with `ret_raw_attn`, else its masked softmax.  int8 is
    dequantized there, without a gradient, and the products are f32.

    The parameters keep the vlsa_tpu tree's names and layouts, fc1_kernel
    [D, hid], fc1_bias [hid], fc2_kernel [hid, 1] and fc2_bias [1], so the
    weight bridge maps them one to one and the decay split (ndim != 1)
    decays the same leaves, fc2_kernel included.  Torch's default Linear
    initialisation, U(+-1/sqrt(fan_in)), from `generator`.  fc2_bias cancels
    in the softmax and gets no gradient."""

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
                x_scale: Optional[torch.Tensor] = None, need_attn: bool = False,
                ret_raw_attn: bool = True):
        if not need_attn:
            return abmil_pool(x, mask, self.fc1_kernel.T, self.fc1_bias,
                              self.fc2_kernel[:, 0], self.fc2_bias[0], x_scale=x_scale)
        if x.dtype == torch.int8:
            x = dequantize_feats(x, x_scale).detach()
        x = x.float()
        h = torch.tanh(x @ self.fc1_kernel + self.fc1_bias)
        a_raw = (h @ self.fc2_kernel)[..., 0] + self.fc2_bias[0]  # [B, N]
        attn = masked_softmax(a_raw, mask, dim=-1)
        pooled = torch.einsum("bn,bnd->bd", attn, x)
        return pooled, (a_raw if ret_raw_attn else attn)


class GatedAttentionPooling(nn.Module):
    """Gated ABMIL pooling (counterpart of vlsa_tpu/models/layers.py::
    GatedAttentionPooling): x [B, N, D], mask [B, N] ->
    (pooled [B, D] f32, or float64 for float64 x, attention [B, N]), with
        a_raw = fc2(Dropout(tanh(fc1(x))) * Dropout(sigmoid(score(x))))
    and the attention its masked softmax (a_raw itself with
    `ret_raw_attn`).  Plain ops in f32 on every device: vlsa_tpu has no
    kernel here.  The Dropout (`train=True` only) draws its masks from the
    module's `SeededDropout`, seeded with `seed`: train-mode outputs agree
    with vlsa_tpu's in distribution, not bit for bit (vlsa_tpu draws from
    threefry); in eval mode they agree to rounding."""

    def __init__(self, dim: int, hid_dim: int = 512, dropout: float = 0.5, seed: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc1 = TorchLinear(dim, hid_dim, generator=generator)
        self.score = TorchLinear(dim, hid_dim, generator=generator)
        self.fc2 = TorchLinear(hid_dim, 1, generator=generator)
        self.dropout = SeededDropout(dropout, seed)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                ret_raw_attn: bool = False, train: bool = False):
        x = compute_float(x)
        emb = self.dropout(torch.tanh(self.fc1(x)), train)
        scr = self.dropout(torch.sigmoid(self.score(x)), train)
        a_raw = self.fc2(emb * scr)[..., 0]  # [B, N]
        attn = masked_softmax(a_raw, mask, dim=-1)
        pooled = torch.einsum("bn,bnd->bd", attn, x)
        return pooled, (a_raw if ret_raw_attn else attn)
