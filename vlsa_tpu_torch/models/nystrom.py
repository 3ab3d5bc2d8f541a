"""Nyström self-attention (counterpart of vlsa_tpu/models/nystrom.py), used
by TransMIL.

Landmark means over ceil(N/m) segments of the sequence (masked), the
three-matrix Nyström factorisation
    out = softmax(q k_l^T) @ pinv(softmax(q_l k_l^T)) @ (softmax(q_l k^T) v)
with the key mask on the third factor only, the pseudo-inverse by six
Newton-Schulz steps (13/15/7), and a 33-tap depthwise convolution of the
values over the sequence axis, per head, added as a residual.  Plain torch
ops: vlsa_tpu has no kernel here (XLA ops).

With `return_cls_attn` the layer also gives the first query's attention row
[B, h, 1, N], `attn1[:, :, :1] @ pinv @ attn3`: vlsa_tpu forms the whole
[B, h, N, N] map and slices row 0, the same function without an N x N
tensor (at N = 16,384 that would not fit).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.masked import NEG_INF
from .layers import SeededDropout, TorchLinear


def moore_penrose_pinv(x: torch.Tensor, iters: int = 6) -> torch.Tensor:
    """Iterative pseudo-inverse of each matrix of x [..., m, m]: z0 = x^T /
    (max row sum * max column sum of |x|), then
    z <- z/4 (13 I - xz (15 I - xz (7 I - xz)))."""
    abs_x = x.abs()
    col = abs_x.sum(-1).amax(-1)
    row = abs_x.sum(-2).amax(-1)
    z = x.transpose(-1, -2) / (col * row)[..., None, None]
    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    for _ in range(iters):
        xz = x @ z
        z = 0.25 * z @ (13 * eye - xz @ (15 * eye - xz @ (7 * eye - xz)))
    return z


class NystromAttention(nn.Module):
    """x [B, N, dim], mask [B, N] -> [B, N, dim].  Parameters keep vlsa_tpu's
    names: `to_qkv` (no bias), `to_out`, and `res_conv_kernel` in torch's
    depthwise layout [heads, 1, 33, 1] (vlsa_tpu's HWIO (33, 1, 1, heads);
    utils.weights converts), initialised U(+-1/sqrt(33)) as vlsa_tpu's
    variance_scaling(1/3, fan_in) is."""

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8,
                 num_landmarks: int = 256, pinv_iterations: int = 6, residual: bool = True,
                 residual_conv_kernel: int = 33, dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None, seed: int = 0):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.num_landmarks = num_landmarks
        self.pinv_iterations = pinv_iterations
        self.residual = residual
        self.kernel = residual_conv_kernel
        inner = dim_head * heads
        self.to_qkv = TorchLinear(dim, inner * 3, bias=False, generator=generator)
        if residual:
            bound = 1.0 / math.sqrt(residual_conv_kernel)
            self.res_conv_kernel = nn.Parameter(torch.empty(
                heads, 1, residual_conv_kernel, 1).uniform_(-bound, bound, generator=generator))
        self.to_out = TorchLinear(inner, dim, generator=generator)
        self.dropout = SeededDropout(dropout, seed)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                return_cls_attn: bool = False, train: bool = False):
        B, N, _ = x.shape
        h, m, d = self.heads, self.num_landmarks, self.dim_head
        q, k, v = self.to_qkv(x).chunk(3, dim=-1)
        q, k, v = (t.reshape(B, N, h, d).transpose(1, 2) for t in (q, k, v))  # [B, h, N, d]
        q = q * d ** -0.5
        if mask is None:
            mask = torch.ones(B, N, dtype=torch.bool, device=x.device)
        mf = mask[:, None, :, None].to(x.dtype)  # [B, 1, N, 1]
        seg = -(-N // m)
        pad = seg * m - N
        cnt = F.pad(mf, (0, 0, 0, pad)).reshape(B, 1, m, seg, 1).sum(3)

        def seg_mean(t):
            tp = F.pad(t * mf, (0, 0, 0, pad)).reshape(B, h, m, seg, d).sum(3)
            return tp / torch.clamp(cnt, min=1.0)

        q_l, k_l = seg_mean(q), seg_mean(k)  # [B, h, m, d]
        sim1 = torch.einsum("bhnd,bhmd->bhnm", q, k_l)
        sim2 = torch.einsum("bhmd,bhld->bhml", q_l, k_l)
        sim3 = torch.einsum("bhmd,bhnd->bhmn", q_l, k)
        sim3 = torch.where(mask[:, None, None, :], sim3,
                           torch.full((), NEG_INF, dtype=sim3.dtype, device=x.device))
        attn1, attn2, attn3 = (torch.softmax(s, dim=-1) for s in (sim1, sim2, sim3))
        attn2_inv = moore_penrose_pinv(attn2, self.pinv_iterations)
        out = attn1 @ attn2_inv @ (attn3 @ v)  # [B, h, N, d]
        if self.residual:
            out = out + F.conv2d(v, self.res_conv_kernel, padding=(self.kernel // 2, 0),
                                 groups=h)
        out = out.transpose(1, 2).reshape(B, N, h * d)
        out = self.dropout(self.to_out(out), train)
        if return_cls_attn:
            return out, attn1[:, :, :1] @ attn2_inv @ attn3  # [B, h, 1, N]
        return out
