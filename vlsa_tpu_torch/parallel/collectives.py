"""Collectives of the port's multi-process runs (no counterpart in
vlsa_tpu, where XLA inserts them from the shardings).

* The backend follows from the layout (multihost.py::rank_layout): NCCL
  where each rank on a host has a card of its own, gloo otherwise (the CPU,
  or several ranks sharing one card).  It is never chosen by catching a
  failure.
* On gloo a CUDA tensor is staged through host memory: copied to the host,
  reduced or gathered there, copied back.  Compute stays on the card.
* Autograd-aware operators: `copy_to_group` (identity forward, sum of the
  gradient over the group backward), `reduce_from_group` (sum forward,
  identity backward), the pair that wraps a tensor-parallel MLP and merges
  a sequence-parallel pool's plain chunks (every rank of the group then
  computes the same downstream), and `gather_rows` (rows of every rank
  concatenated in rank order; backward: the gradient summed over the
  group, the rank's own rows kept), for an objective every rank computes on
  the whole batch.  Each backward is built from these operators (copy's of
  reduce_from_group, reduce's of copy_to_group, the gather's of a sum over
  the group that sums backward too, `sum_over_group`), so a gradient taken
  with create_graph=True has a second derivative through them (adahessian's
  Hessian-vector product on a mesh).
* `broadcast_object`: global rank 0's Python object on every rank (a
  checkpoint rank 0 read, so that every rank holds the same weights).

A group of None is a group of one rank: every operator is then the
identity.  `COLLECTIVES` counts the calls and their seconds on the host's
clock (staging included; on NCCL only the enqueueing).
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

# calls and host seconds of every collective this process ran
COLLECTIVES = {"calls": 0, "seconds": 0.0}


def reset_collectives() -> None:
    COLLECTIVES.update(calls=0, seconds=0.0)


def _staged(group) -> bool:
    return dist.get_backend(group) == "gloo"


def _timed(fn):
    def wrapped(*args, **kws):
        t = time.perf_counter()
        try:
            return fn(*args, **kws)
        finally:
            COLLECTIVES["calls"] += 1
            COLLECTIVES["seconds"] += time.perf_counter() - t
    return wrapped


@_timed
def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """A new tensor: `t` reduced over `group` (op "sum" or "max")."""
    if group is None:
        return t
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    if t.is_cuda and _staged(group):
        host = t.detach().to("cpu", copy=True).contiguous()
        dist.all_reduce(host, op=red, group=group)
        return host.to(t.device)
    out = t.detach().clone().contiguous()
    dist.all_reduce(out, op=red, group=group)
    return out


@_timed
def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's `t` (one shape on all of them) concatenated along `dim`
    in the group's rank order."""
    if group is None:
        return t
    src = t.detach()
    if src.is_cuda and _staged(group):
        src = src.to("cpu")
    src = src.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


@_timed
def broadcast_object(obj, world: bool):
    """Global rank 0's `obj` on every rank of the world (pickled; on NCCL
    through the rank's card, which bring-up made current); `obj` itself
    without a world (`world` false)."""
    if not world:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def sum_tensors_(tensors, group) -> None:
    """Sum `tensors` over `group` in place, in one collective (a flat buffer
    of every tensor, in order); None entries are skipped."""
    tensors = [t for t in tensors if t is not None]
    if group is None or not tensors:
        return
    flat = all_reduce(torch.cat([t.reshape(-1) for t in tensors]), group)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def sum_grads_(params, group) -> None:
    """Sum the gradients of `params` over `group` in place, in one
    collective."""
    sum_tensors_([p.grad for p in params], group)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return reduce_from_group(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return copy_to_group(g, ctx.group), None


class _SumOverGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return sum_over_group(g, ctx.group), None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        ctx.index = dist.get_rank(group)
        return all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        g = sum_over_group(g, ctx.group)
        lo = ctx.index * ctx.rows
        return g[lo:lo + ctx.rows], None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the gradient summed over `group` backward."""
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Summed over `group` forward; identity backward."""
    return x if group is None else _ReduceFromGroup.apply(x, group)


def sum_over_group(x: torch.Tensor, group) -> torch.Tensor:
    """Summed over `group` forward and backward: the sum as a function of
    every rank's input, whose ranks may each take another cotangent (the
    gather's backward, where each rank keeps its own rows)."""
    return x if group is None else _SumOverGroup.apply(x, group)


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's rows of `x` in rank order; backward, the gradient summed
    over `group` and the rank's own rows kept: with an objective that every
    rank computes on the whole batch and divides by the group's size, each
    term then counts once."""
    return x if group is None else _GatherRows.apply(x, group)

