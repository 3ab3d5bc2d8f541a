"""Sequence-parallel co-attention pooling (counterpart of
vlsa_tpu/parallel/coattn_sp.py): each rank of a model group holds a
contiguous chunk of every bag's patches and the group merges the chunks'
partial softmax statistics, as the flash-style combine

    m = max_i m_i;  l = sum_i l_i e^{m_i - m};  out = sum_i out_i l_i e^{m_i - m} / l

in one max and one sum over the group (the sum carries the accumulators
and the normalisers in one buffer).  The forward kernel (row 1) already
returns a chunk's (out_i, m_i, l_i); a chunk with no valid patch gives
m = -1e30, l = 1e-30, out = 0, so its weight e^{m_i - m} is 0 unless the
whole bag is empty, whose output stays 0.

The backward runs the rank's backward kernel on its chunk with the merged
(out, m, l): a = e^{s - m}/l and dl = a (g.x - g.out) are then the global
softmax's, restricted to the chunk, so the chunks' dq partials sum to the
whole gradient (row 6, dQ; row 5, dq and dX when the features need one,
behind the projecter) and dX is the chunk's own rows of the whole one.  dq
is summed over the model group inside the backward, the counterpart of
shard_map's transpose psum: everything downstream of the pool is the same
on every rank of the group already.

On the CPU the same Function runs the plain versions of those kernels
(`coattn_fwd_reference`, `coattn_bwd_dq_reference`,
`coattn_bwd_dx_reference`).  Inside `ops.flags.disable_kernels()` (on the
card or the CPU) the pool is vlsa_tpu's `shard_fn` instead: plain,
twice-differentiable operations on the chunk, the max with its gradient
stopped, the queries entering through `copy_to_group` and the partials
summed by `reduce_from_group`, so that adahessian's Hessian-vector product
runs through it.  int8 features are dequantized to bf16 before the pool by
the model (vlsa_tpu/models/mil.py:167-174), which drops the storage
sidecars: the route runs the f32 and bf16 variants.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from ..ops import coattn as co
from ..ops.flags import kernels_disabled
from ..ops.masked import NEG_INF, l2_normalize
from .collectives import all_reduce, copy_to_group, reduce_from_group
from .sharding import Mesh


def merge_partials(out: torch.Tensor, m: torch.Tensor, l: torch.Tensor, group):
    """(out, m, l) of the whole bag from each rank's (out_i, m_i, l_i): out
    [B, ..., C], m and l [B, ...], f32."""
    m_g = all_reduce(m, group, "max")
    lc = l * torch.exp(m - m_g)
    acc = out * lc[..., None]
    n = acc.numel()
    flat = all_reduce(torch.cat([acc.reshape(-1), lc.reshape(-1)]), group)
    l_g = flat[n:].view_as(l)
    return flat[:n].view_as(acc) / torch.clamp(l_g, min=1e-30)[..., None], m_g, l_g


def merge_plain(m: torch.Tensor, l: torch.Tensor, pv: torch.Tensor, group) -> torch.Tensor:
    """vlsa_tpu's combine of a chunk's partials (m [B, ...] without a
    gradient, l [B, ...], the unnormalised pv [B, ..., C]) as differentiable
    operations: out = sum_i pv_i e^{m_i - m} / max(sum_i l_i e^{m_i - m},
    1e-30), the sums in one `reduce_from_group`."""
    corr = torch.exp(m - all_reduce(m, group, "max"))
    acc = pv * corr[..., None]
    n = acc.numel()
    flat = reduce_from_group(torch.cat([acc.reshape(-1), (l * corr).reshape(-1)]), group)
    return flat[:n].view_as(acc) / torch.clamp(flat[n:].view_as(l), min=1e-30)[..., None]


def coattn_shard_fn(q, x, mask, scale, group) -> torch.Tensor:
    """vlsa_tpu/parallel/coattn_sp.py's shard_fn in plain operations (its
    _local_partials, then the combine): norms and logits in f32 (float64
    for float64 features)."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    q = copy_to_group(q, group)
    logits = scale * torch.einsum("pc,bnc->bpn", q.to(xf.dtype), l2_normalize(xf, dim=-1))
    logits = torch.where(mask[:, None, :], logits, NEG_INF)
    m = logits.amax(-1).detach()
    p = torch.where(mask[:, None, :], torch.exp(logits - m[..., None]), 0.0)
    return merge_plain(m, p.sum(-1), torch.einsum("bpn,bnc->bpc", p, xf), group)


class CoattnPoolSP(torch.autograd.Function):
    """The pool over the model group: forward kernel on the chunk, merge,
    backward kernel on the chunk with the merged stats, dq summed."""

    @staticmethod
    def forward(ctx, q, x, mask, scale, group):
        if x.is_cuda:
            out, m, l = co.coattn_fwd(q, x, mask, scale)
        else:
            out, m, l = co.coattn_fwd_reference(
                q, x, mask, scale, dtype=torch.promote_types(x.dtype, torch.float32))
        out, m, l = merge_partials(out, m, l, group)
        ctx.save_for_backward(q, x, mask, out, m, l)
        ctx.scale, ctx.group = scale, group
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, x, mask, out, m, l = ctx.saved_tensors
        g = g.contiguous()
        need_dx = ctx.needs_input_grad[1]
        dx = None
        if x.is_cuda:
            if need_dx:
                dq, dx = co.coattn_bwd_dx(q, x, mask, ctx.scale, g, out, m, l)
            else:
                dq = co.coattn_bwd_dq(q, x, mask, ctx.scale, g, out, m, l)
        else:
            dtype = torch.promote_types(x.dtype, torch.float32)
            if need_dx:
                dq, dx = co.coattn_bwd_dx_reference(q, x, mask, ctx.scale, g, out, m, l,
                                                    dtype=dtype)
            else:
                dq = co.coattn_bwd_dq_reference(q, x, mask, ctx.scale, g, out, m, l,
                                                dtype=dtype)
        dq = all_reduce(dq, ctx.group) if ctx.needs_input_grad[0] else None
        return dq, dx, None, None, None


def coattn_pool_sp(q: torch.Tensor, x: torch.Tensor, mask: Optional[torch.Tensor], scale,
                   mesh: Mesh) -> torch.Tensor:
    """q [P, C] (the effective queries, the same on every rank), x [B, n, C]
    and mask [B, n] the rank's chunk of the patch axis -> the whole bag's
    pooled features [B, P, C] f32, the same on every rank of the model
    group.  x is f32 or bf16 (int8 dequantized by the caller); it gets a
    gradient (its chunk's) when it requires one.  Inside
    `ops.flags.disable_kernels()` it is `coattn_shard_fn`, which has a
    second derivative."""
    if x.dtype == torch.int8:
        raise ValueError("the sequence-parallel pool takes f32 or bf16 features: "
                         "dequantize int8 first")
    if mask is None:
        mask = torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
    if kernels_disabled():
        return coattn_shard_fn(q, x, mask, float(scale), mesh.model_group)
    return CoattnPoolSP.apply(q.contiguous(), x.contiguous(), mask.contiguous(), float(scale),
                              mesh.model_group)
