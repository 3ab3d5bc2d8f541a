"""Sequence-parallel ABMIL attention pooling (counterpart of
vlsa_tpu/parallel/abmil_sp.py): the SA family's pool over a patch axis
split across the model group,

    a_n = w2 . tanh(W1 x_n + b1)   (b2 cancels in the softmax),

each rank's chunk through the forward kernel (row 7), which returns its
(out_i, m_i, l_i); the chunks merge as in parallel/coattn_sp.py (one max,
one sum over the group, O(B D) values a bag).  The backward kernel (row 8)
runs on the chunk with the merged (out, m, l): the chunks' dW1, db1 and dw2
partials, summed over the model group inside the backward, are the whole
gradients, and dX (when the features need one, behind the projecter) is
the chunk's rows of the whole one.

On the CPU the same Function runs the plain versions (`abmil_fwd_reference`
and the backward's plain version, which for bf16 rounds W1 and dz as the
kernel does).  Inside `ops.flags.disable_kernels()` the pool is vlsa_tpu's
`shard_fn` in plain, twice-differentiable operations (`abmil_shard_fn`),
as parallel/coattn_sp.py's is.  int8 features are dequantized to bf16
first (vlsa_tpu/models/mil.py:231-238).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from ..ops import abmil as ab
from ..ops.flags import kernels_disabled
from ..ops.masked import NEG_INF
from .collectives import all_reduce, copy_to_group
from .coattn_sp import merge_partials, merge_plain
from .sharding import Mesh


def abmil_shard_fn(x, mask, w1, b1, w2, group) -> torch.Tensor:
    """vlsa_tpu/parallel/abmil_sp.py's shard_fn in plain operations, in f32
    (float64 for float64 features), the replicated weights entering through
    `copy_to_group`."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    w1, b1, w2 = (copy_to_group(t, group).to(xf.dtype) for t in (w1, b1, w2))
    logits = torch.where(mask, torch.tanh(xf @ w1.T + b1) @ w2, NEG_INF)
    m = logits.amax(-1).detach()
    p = torch.where(mask, torch.exp(logits - m[:, None]), 0.0)
    return merge_plain(m, p.sum(-1), torch.einsum("bn,bnd->bd", p, xf), group)


class AbmilPoolSP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mask, w1, b1, w2, group):
        if x.is_cuda:
            out, m, l = ab.abmil_fwd(x, mask, w1, b1, w2)
        else:
            with torch.no_grad():
                out, m, l = ab.abmil_fwd_reference(x, mask, w1, b1, w2)
        out, m, l = merge_partials(out, m, l, group)
        ctx.save_for_backward(x, mask, w1, b1, w2, out, m, l)
        ctx.group = group
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, mask, w1, b1, w2, out, m, l = ctx.saved_tensors
        g = g.contiguous()
        need_dx = ctx.needs_input_grad[0]
        if x.is_cuda:
            dx, dw1, db1, dw2 = ab.abmil_bwd(x, mask, w1, b1, w2, g, out, m, l, need_dx=need_dx)
        else:
            dx, dw1, db1, dw2 = ab._bwd_plain(x, mask, w1, b1, w2, g, out, m, l, None, need_dx,
                                              ab._precise_for(x.dtype, None))
        sizes = (dw1.numel(), db1.numel())
        flat = all_reduce(torch.cat([dw1.reshape(-1), db1, dw2]), ctx.group)
        dw1 = flat[:sizes[0]].view_as(dw1)
        db1 = flat[sizes[0]:sizes[0] + sizes[1]]
        dw2 = flat[sizes[0] + sizes[1]:]
        return dx, None, dw1, db1, dw2, None


def abmil_pool_sp(x: torch.Tensor, mask: Optional[torch.Tensor], w1: torch.Tensor,
                  b1: torch.Tensor, w2: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x [B, n, D] and mask [B, n] the rank's chunk of the patch axis, w1
    [hid, D], b1 [hid], w2 [hid] the same on every rank -> the whole bag's
    pooled features [B, D] f32, the same on every rank of the model group."""
    if x.dtype == torch.int8:
        raise ValueError("the sequence-parallel pool takes f32 or bf16 features: "
                         "dequantize int8 first")
    if mask is None:
        mask = torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
    if kernels_disabled():
        return abmil_shard_fn(x, mask, w1, b1, w2, mesh.model_group)
    return AbmilPoolSP.apply(x.contiguous(), mask.contiguous(), w1.contiguous(),
                             b1.contiguous(), w2.contiguous(), mesh.model_group)
