"""Masked co-attention pooling -- the hot op of the VLFAN aggregator.

A bag of N patch features x [B, N, C] is reduced against P queries (any P >= 1):

    xn = l2norm(x);  A = softmax_N(scale * q @ xn^T);  out = A @ x

Counterpart of vlsa_tpu/ops/coattn.py: the pooling of the VLSA model (the
SA baseline pools through ops/abmil.py).  `coattn_pool` is the entry point:
a CPU tensor goes through the plain PyTorch version under ordinary autograd,
a CUDA tensor through the hand-written Hopper kernels: `csrc/coattn_fwd.cu`
forward and, for the backward, `csrc/coattn_bwd_dq.cu` when only the queries
need a gradient (`CoattnPoolDQ`: the patch features are constants, as in
every shipped VLSA config) or `csrc/coattn_bwd_dx.cu` when the patch
features need one too (`CoattnPoolFull`: VLFAN with a feature projecter).

Storage types of x: f32, bf16, or int8 with per-patch dequant scales
`x_scale` [B, N]; `x_inv` [B, N] optionally carries host-computed
1/||x_stored|| rows.  Features that need a gradient are f32 or bf16 with no
sidecars.  The plain versions compute in f32 on the stored values.  The
kernels run their products on the tensor cores with the TPU kernels'
rounding: q, the softmax weights, g and the logit cotangent as bf16 hi + lo
(f32 storage: every operand in split TF32); `coattn_fwd_rounded` models the
forward's.  Forward and backward share one launch plan (`fwd_plan`): one
persistent block per SM over flat ranges of tiles, by channel group of 512
above C=512.  The kernels take the queries in groups of 16 rows (one mma
tile; the last group zero-padded): the forward and dQ as the grid's third
dimension, so the groups' blocks share the wave (past 65,535 groups in
launches of that many groups each); the dX kernel above 16 queries loops
over the groups on each staged tile (P is its dX product's reduction), on
tiles of 32 patches (f32: 16), each group's stats staged with its rows.
Any P: no block's shared memory grows with it, and the backward's dq
partials [blocks, P, C] stay within `_DQ_WS_BYTES` (fewer blocks for a
large P).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from .flags import kernels_disabled
from .masked import l2_normalize, masked_softmax

# queries a group (csrc/coattn_common.cuh kRows: one mma tile of rows), and
# the most groups one launch of the forward or dQ takes (its grid's z; past
# that the kernels launch a chunk of groups at a time); the dX kernel above
# one group takes tiles of _DX_LOOP_TILE patches by storage (loop_tile_of,
# csrc/coattn_bwd.cuh)
_QUERY_ROWS, _MAX_QUERY_GROUPS = 16, 65535
# the most bytes of the backward's dq partials, [blocks, P, C] f32 (1 GiB)
_DQ_WS_BYTES = 1 << 30
_DX_LOOP_TILE = {torch.float32: 16, torch.bfloat16: 32}
# the kernels' warps each own _FWD_WARP_CH channels, at most _FWD_MAX_WARPS of
# them (a block's channel group of _FWD_GROUP_CH), and their tiles hold
# _FWD_TILE patches by storage (kWarpCh, kMaxWarps, tile_of in
# csrc/coattn_common.cuh)
_FWD_WARP_CH, _FWD_MAX_WARPS = 64, 8
_FWD_GROUP_CH = _FWD_WARP_CH * _FWD_MAX_WARPS
_FWD_TILE = {torch.float32: 32, torch.bfloat16: 64, torch.int8: 64}
_STORAGE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_STORAGE_NAME = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "int8"}

# Launches of the CUDA kernels by variant ("f32", "f32_inv", "bf16",
# "bf16_inv", "int8", "int8_inv"): one per call of `coattn_fwd` in LAUNCHES,
# one per call of `coattn_bwd_dq` in LAUNCHES_BWD; one per call of
# `coattn_bwd_dx` in LAUNCHES_DX, by storage ("f32", "bf16").  The forward's
# calls also count by instance in LAUNCHES_FWD_PATH, and both backward
# kernels' in LAUNCHES_BWD_PATH: "group" for C <= 512 (one channel group a
# block), "wide" for C > 512 (blocks by channel group).  All three kernels'
# calls count by query route in LAUNCHES_QUERY_PATH: "single" for P <= 16
# (one query group), "grid" for the forward and dQ above (query groups on
# the grid), "chunked" for them past 65,535 groups (the grid launched a chunk
# of groups at a time), "loop" for dX above 16 (query groups looped on each
# tile).
LAUNCHES = {f"{s}{i}": 0 for s in ("f32", "bf16", "int8") for i in ("", "_inv")}
LAUNCHES_BWD = dict(LAUNCHES)
LAUNCHES_DX = {"f32": 0, "bf16": 0}
LAUNCHES_FWD_PATH = {"group": 0, "wide": 0}
LAUNCHES_BWD_PATH = {"group": 0, "wide": 0}
LAUNCHES_QUERY_PATH = {"single": 0, "grid": 0, "chunked": 0, "loop": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, LAUNCHES_BWD, LAUNCHES_DX, LAUNCHES_FWD_PATH,
                   LAUNCHES_BWD_PATH, LAUNCHES_QUERY_PATH):
        for k in counts:
            counts[k] = 0


def variant_name(x_dtype: torch.dtype, host_inv: bool) -> str:
    return _STORAGE_NAME[x_dtype] + ("_inv" if host_inv else "")


def dequantize_feats(x: torch.Tensor, x_scale: Optional[torch.Tensor]) -> torch.Tensor:
    """Undo per-patch symmetric int8 quantization: x [.., N, C] int8,
    x_scale [.., N] f32 -> f32 features."""
    if x_scale is None:
        return x
    return x.to(torch.float32) * x_scale[..., None]


def _logits_reference(q, x, scale, x_scale, dtype=torch.float32):
    x = x.to(dtype) if x_scale is None else x.to(dtype) * x_scale.to(dtype)[..., None]
    xn = l2_normalize(x, dim=-1)
    return scale * torch.einsum("pc,bnc->bpn", q.to(dtype), xn), x


def coattn_pool_reference(q: torch.Tensor, x: torch.Tensor,
                          mask: Optional[torch.Tensor], scale,
                          x_scale: Optional[torch.Tensor] = None,
                          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version: q [P, C], x [B, N, C], mask [B, N] -> out [B, P, C] f32
    (computed in `dtype`: float64 gives the exact function that the f32
    kernels are held against, the f32 products' own rounding left out)."""
    logits, xf = _logits_reference(q, x, scale, x_scale, dtype)
    m = None if mask is None else mask[:, None, :]
    attn = masked_softmax(logits, m, dim=-1)
    return torch.einsum("bpn,bnc->bpc", attn, xf)


def coattn_attention_reference(q: torch.Tensor, x: torch.Tensor,
                               mask: Optional[torch.Tensor], scale,
                               x_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The attention matrix [B, P, N] (interpretation path)."""
    logits, _ = _logits_reference(q, x, scale, x_scale)
    m = None if mask is None else mask[:, None, :]
    return masked_softmax(logits, m, dim=-1)


def _stored_logits(q, x, mask, scale, x_inv, dtype=torch.float32):
    """(xf, inv, logits) as the kernels form them, in `dtype`: on the stored
    values (raw int8 for int8), logits = scale * inv[n] * (q . x[n]), -1e30
    where masked; inv = x_inv, else 1/max(|x[n]|, 1e-12)."""
    xf = x.to(dtype)
    if x_inv is None:
        inv = torch.rsqrt(torch.clamp((xf * xf).sum(-1), min=1e-24))
    else:
        inv = x_inv.to(dtype)
    logits = scale * torch.einsum("pc,bnc->bpn", q.to(dtype), xf) * inv[:, None, :]
    return xf, inv, torch.where(mask[:, None, :], logits, -1e30)


def coattn_fwd_reference(q: torch.Tensor, x: torch.Tensor, mask: torch.Tensor, scale,
                         x_scale: Optional[torch.Tensor] = None,
                         x_inv: Optional[torch.Tensor] = None,
                         dtype: torch.dtype = torch.float32
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of `coattn_fwd`: (out [B, P, C], m [B, P], l [B, P]) f32
    (or `dtype`, as `coattn_pool_reference`) with the kernel's stats: m the
    masked max of the logits (-1e30 for an empty bag), l the softmax
    normaliser clamped below at 1e-30."""
    xf, _inv, logits = _stored_logits(q, x, mask, scale, x_inv, dtype)
    m = logits.amax(-1)
    p = torch.where(mask[:, None, :], torch.exp(logits - m[..., None]), 0.0)
    l = torch.clamp(p.sum(-1), min=1e-30)
    w = p if x_scale is None else p * x_scale.to(dtype)[:, None, :]
    return torch.einsum("bpn,bnc->bpc", w, xf) / l[..., None], m, l


def _split_bf16(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """t = hi + lo as vlsa_tpu/ops/coattn.py::_mm_rows splits it: hi the bf16
    rounding of t, lo that of the residual (both returned in f32)."""
    hi = t.to(torch.bfloat16).float()
    return hi, (t - hi).to(torch.bfloat16).float()


def _split_tf32(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """t = hi + lo as csrc/coattn_common.cuh::split_tf32 splits it and the
    tensor cores read it: hi t rounded to TF32 (the 13 low bits rounded off,
    ties away), lo the residual truncated to TF32 (both returned in f32)."""
    bits = t.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return hi, ((t - hi).view(torch.int32) & -0x2000).view(torch.float32)


def coattn_fwd_rounded(q: torch.Tensor, x: torch.Tensor, mask: torch.Tensor, scale,
                       x_scale: Optional[torch.Tensor] = None,
                       x_inv: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain model of the forward kernel's rounding, (out, m, l) as
    `coattn_fwd_reference` returns them.  bf16 and int8 storage: q and the PV
    weights p * s enter the products as bf16 hi + lo, as the TPU kernel's
    `_stream_matmul` takes them for bf16 storage, and x multiplies as stored
    (int8 values are exact in bf16).  f32 storage: q, x and the weights in
    split TF32, three products lo.hi + hi.lo + hi.hi.  The sums are f32.  The
    kernel splits the weights of each tile relative to the running max, this
    model relative to the bag's max: the two differ by the split's own
    rounding (~2^-17 for bf16)."""
    xf = x.to(torch.float32)
    split = _split_tf32 if x.dtype == torch.float32 else _split_bf16
    qh, ql = split(q.to(torch.float32))

    def product(eq, a_hi, a_lo):  # a . x as the kernel's tensor cores form it
        if x.dtype != torch.float32:
            return torch.einsum(eq, a_hi + a_lo, xf)
        xh, xl = _split_tf32(xf)
        return (torch.einsum(eq, a_lo, xh) + torch.einsum(eq, a_hi, xl)
                + torch.einsum(eq, a_hi, xh))

    if x_inv is None:
        inv = torch.rsqrt(torch.clamp((xf * xf).sum(-1), min=1e-24))
    else:
        inv = x_inv.to(torch.float32)
    raw = product("pc,bnc->bpn", qh, ql)
    logits = torch.where(mask[:, None, :], scale * raw * inv[:, None, :], -1e30)
    m = logits.amax(-1)
    p = torch.where(mask[:, None, :], torch.exp(logits - m[..., None]), 0.0)
    l = torch.clamp(p.sum(-1), min=1e-30)
    w = p if x_scale is None else p * x_scale[:, None, :]
    return product("bpn,bnc->bpc", *split(w)) / l[..., None], m, l


def _weights_and_cotangent(q, x, mask, scale, g, out, m, l, x_scale=None, x_inv=None,
                           dtype=torch.float32):
    """(xf, inv, a, dl_inv) as the backward kernels form them, in `dtype`,
    from the output's cotangent g and the forward's (out, m, l): the
    attention weights a and the logit cotangent with the norm folded in,
    dl_inv[p, n] = a * (g[p] . x[n] - g[p] . out[p]) * inv[n]."""
    xf, inv, logits = _stored_logits(q, x, mask, scale, x_inv, dtype)
    g, out, m, l = (t.to(dtype) for t in (g, out, m, l))
    valid = mask[:, None, :]
    # a is masked to 0 first: an empty bag has m = -1e30, l = 1e-30, where
    # exp(0) / l = 1e30
    a = torch.where(valid, torch.exp(logits - m[..., None]) / l[..., None], 0.0)
    dA = torch.einsum("bpc,bnc->bpn", g, xf)
    if x_scale is not None:
        dA = dA * x_scale.to(dtype)[:, None, :]
    s_row = (g * out).sum(-1, keepdim=True)
    return xf, inv, a, a * (dA - s_row) * inv[:, None, :]


def coattn_bwd_dq_reference(q: torch.Tensor, x: torch.Tensor, mask: torch.Tensor,
                            scale, g: torch.Tensor, out: torch.Tensor, m: torch.Tensor,
                            l: torch.Tensor, x_scale: Optional[torch.Tensor] = None,
                            x_inv: Optional[torch.Tensor] = None,
                            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of `coattn_bwd_dq` (vlsa_tpu/ops/coattn.py::
    _coattn_bwd_dq_body in f32): the queries' gradient dq [P, C] f32 (or
    `dtype`, as `coattn_pool_reference`) from the output's cotangent g
    [B, P, C], the forward output and its stats."""
    xf, _inv, _a, dl_inv = _weights_and_cotangent(q, x, mask, scale, g, out, m, l,
                                                  x_scale, x_inv, dtype)
    return scale * torch.einsum("bpn,bnc->pc", dl_inv, xf)


def coattn_bwd_dx_reference(q: torch.Tensor, x: torch.Tensor, mask: torch.Tensor,
                            scale, g: torch.Tensor, out: torch.Tensor, m: torch.Tensor,
                            l: torch.Tensor, dtype: torch.dtype = torch.float32
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `coattn_bwd_dx` (vlsa_tpu/ops/coattn.py::
    _coattn_bwd_kernel): (dq [P, C] f32, dX [B, N, C] in x's type) from the
    output's cotangent g [B, P, C] and the forward's (out, m, l), for f32 or
    bf16 x.  For bf16 it rounds where the TPU kernel does: the logit
    cotangent dl and the weights a go into the dX products as bf16 (q
    stays f32, its :386-387), and so does g (:392); dX is rounded once at
    the end (:395); dq and everything else is f32 (or `dtype`, as
    `coattn_pool_reference`; dX still in x's type)."""
    xf, inv, a, dl_inv = _weights_and_cotangent(q, x, mask, scale, g, out, m, l, dtype=dtype)
    dq = scale * torch.einsum("bpn,bnc->pc", dl_inv, xf)
    g = g.to(dtype)

    def stored(t):  # t as the dX products take it: rounded to x's type
        return t.to(x.dtype).to(dtype)
    dxn_hat = scale * torch.einsum("bpn,pc->bnc", stored(dl_inv), q.to(dtype))
    proj = (xf * dxn_hat).sum(-1, keepdim=True) * (inv * inv)[..., None]
    dx = torch.einsum("bpn,bpc->bnc", stored(a), stored(g)) + (dxn_hat - xf * proj)
    return dq, dx.to(x.dtype)


def query_groups(P: int) -> int:
    """The kernels' query groups of 16 rows for P queries."""
    return -(-P // _QUERY_ROWS)


def grid_route(P: int) -> str:
    """The forward's and dQ's query route for P queries."""
    if P <= _QUERY_ROWS:
        return "single"
    return "chunked" if query_groups(P) > _MAX_QUERY_GROUPS else "grid"


@functools.lru_cache(maxsize=256)
def fwd_plan(dtype: torch.dtype, B: int, N: int, n_sm: int, C: int = _FWD_GROUP_CH,
             qgroups: int = 1, tile: Optional[int] = None) -> dict:
    """The co-attention kernels' launch plan for x of `dtype` and width C:
    the B * Tb tiles (Tb = ceil(N / tile) a bag, tile = _FWD_TILE[dtype]
    unless given) are cut into `blocks` flat ranges of L tiles, one
    persistent block each (one block fills an SM) for each of the `groups` =
    ceil(C / 512) channel groups and `qgroups` query groups on the grid (the
    forward's and dQ's ceil(P / 16), else 1), L = ceil(B * Tb / floor(n_sm /
    (qgroups * groups))), so every block but the last of a group takes the
    same number of tiles in one wave (qgroups * groups > n_sm: L = B * Tb,
    one range, qgroups * groups blocks).  A range may cross bags.  The
    forward's block k writes its partial of bag b to slot k - floor(b * Tb /
    L) of that bag, and `Smax` is the most slots a bag uses; the backward's
    block k writes one dq partial, row k of a [blocks, P, C] workspace,
    summed in block order."""
    tiles = -(-N // (tile or _FWD_TILE[dtype]))
    total, groups = B * tiles, -(-C // _FWD_GROUP_CH)
    if total == 0:
        return {"tiles_per_bag": 0, "L": 1, "blocks": 0, "Smax": 0, "groups": groups}
    L = -(-total // max(1, n_sm // (qgroups * groups)))
    smax = max(((b + 1) * tiles - 1) // L - (b * tiles) // L + 1 for b in range(B))
    return {"tiles_per_bag": tiles, "L": L, "blocks": -(-total // L), "Smax": smax,
            "groups": groups}


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the argument types of each library's entry point `<name>` (csrc/<name>.cu):
# pointers to q, x, [x_scale, x_inv: not coattn_bwd_dx] and mask, the scale,
# [the backward kernels: g, out, m, l], B, N, C, P, L, [the forward: Smax],
# storage and device, then the workspace ([coattn_bwd_dx: ws_dq, ws_srow]),
# output and stream pointers
_ARGTYPES = {
    "coattn_fwd": [_P] * 5 + [_F] + [_I] * 8 + [_P] * 7,
    "coattn_bwd_dq": [_P] * 5 + [_F] + [_P] * 4 + [_I] * 7 + [_P] * 3,
    "coattn_bwd_dx": [_P] * 3 + [_F] + [_P] * 4 + [_I] * 7 + [_P] * 5,
}


def _library(name: str):
    from ._build import load
    lib = load(name)
    if not getattr(lib, "_argtypes_set", False):
        entry, smem = getattr(lib, name), getattr(lib, f"{name}_smem_bytes")
        entry.argtypes, entry.restype = _ARGTYPES[name], _I
        smem.argtypes, smem.restype = [_I, _I, _I], ctypes.c_size_t
        lib._argtypes_set = True
    return lib


def _check_row(name, t, B, N, device):
    if t is None:
        return
    if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != (B, N) \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous f32 [{B}, {N}] tensor on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _check_inputs(q, x, mask, x_scale, x_inv, kernel: str) -> Tuple[int, int, int, int]:
    """The argument checks both kernels share; returns (B, N, C, P)."""
    if x.device.type != "cuda":
        raise ValueError(f"{kernel} launches a CUDA kernel; x is on {x.device}")
    device = x.device
    if x.dtype not in _STORAGE:
        raise ValueError(f"x must be f32, bf16 or int8, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous [B, N, C] tensor, got {tuple(x.shape)}")
    B, N, C = x.shape
    if C % 8 != 0:
        raise ValueError(f"the channel count C={C} must be a multiple of 8")
    if x.data_ptr() % 16 != 0:
        raise ValueError("x must be 16-byte aligned")
    if q.device != device or q.dtype != torch.float32 or q.dim() != 2 \
            or q.shape[1] != C or q.shape[0] < 1 or not q.is_contiguous():
        raise ValueError(f"q must be a contiguous f32 [P, {C}] tensor on {device}, P >= 1, "
                         f"got {q.dtype} {tuple(q.shape)} on {q.device}")
    if mask.device != device or mask.dtype != torch.bool \
            or tuple(mask.shape) != (B, N) or not mask.is_contiguous():
        raise ValueError(f"mask must be a contiguous bool [{B}, {N}] tensor on {device}")
    if (x.dtype == torch.int8) != (x_scale is not None):
        raise ValueError("x_scale is required for int8 x and taken for no other type")
    _check_row("x_scale", x_scale, B, N, device)
    _check_row("x_inv", x_inv, B, N, device)
    return B, N, C, q.shape[0]


def _check_forward_outputs(g, out, m, l, B, P, C, device) -> None:
    """The backward kernels' checks of the cotangent and the forward's outputs."""
    for name, t, shape in (("g", g, (B, P, C)), ("out", out, (B, P, C)),
                           ("m", m, (B, P)), ("l", l, (B, P))):
        if t.device != device or t.dtype != torch.float32 \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous f32 {list(shape)} tensor on "
                             f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def kernel_plan(name: str, dtype: torch.dtype, B: int, N: int, n_sm: int, C: int,
                P: int) -> dict:
    """The launch plan of kernel `name` ("coattn_fwd", "coattn_bwd_dq" or
    "coattn_bwd_dx") on a card of n_sm SMs: `fwd_plan` with the forward's
    and dQ's query groups on the grid; the dX kernel above 16 queries on its
    looped instance's tiles (_DX_LOOP_TILE), no query groups on the grid.
    The backward kernels' blocks each write a dq partial [P, C] f32: their
    plan takes at most max(1, _DQ_WS_BYTES // (4 P C)) blocks a query and
    channel group (as on a card of that many SMs), which only a large P
    reaches (the looped dX above ~8,000 queries at C = 512)."""
    qgroups = 1 if name == "coattn_bwd_dx" else query_groups(P)
    if name != "coattn_fwd":
        most = max(1, _DQ_WS_BYTES // (4 * P * C))
        n_sm = min(n_sm, most * qgroups * -(-C // _FWD_GROUP_CH))
    if name == "coattn_bwd_dx":
        return fwd_plan(dtype, B, N, n_sm, C,
                        tile=_DX_LOOP_TILE[dtype] if P > _QUERY_ROWS else None)
    return fwd_plan(dtype, B, N, n_sm, C, qgroups)


def _plan(lib, name: str, device, dtype, B, N, C, P) -> dict:
    """`kernel_plan` for one kernel's launch, after checking that its
    block's shared memory fits the card (a guard: no instance's grows with
    P, and every width's fits an H100's block)."""
    props = torch.cuda.get_device_properties(device)
    smem = getattr(lib, f"{name}_smem_bytes")(P, C, _STORAGE[dtype])
    if not 0 < smem <= props.shared_memory_per_block_optin:
        raise ValueError(f"{name} at C={C}, P={P} needs {smem} bytes of shared memory per "
                         f"block, the card gives {props.shared_memory_per_block_optin}")
    return kernel_plan(name, dtype, B, N, props.multi_processor_count, C, P)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _device_index(device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


def coattn_fwd(q: torch.Tensor, x: torch.Tensor, mask: torch.Tensor, scale: float,
               x_scale: Optional[torch.Tensor] = None,
               x_inv: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the Hopper kernel on CUDA tensors.  Returns (out [B, P, C],
    m [B, P], l [B, P]) f32: the pooled features and the softmax stats
    (running max and normaliser, l clamped below at 1e-30).  Any P >= 1
    (query groups of 16 rows on the grid, in launches of at most 65,535
    groups) and any C (a multiple of 8): above 512 the kernel's wide
    instance runs."""
    B, N, C, P = _check_inputs(q, x, mask, x_scale, x_inv, "coattn_fwd")
    device = x.device
    lib = _library("coattn_fwd")
    storage = _STORAGE[x.dtype]
    plan = _plan(lib, "coattn_fwd", device, x.dtype, B, N, C, P)
    S = plan["Smax"]

    f32 = dict(dtype=torch.float32, device=device)
    out = torch.empty(B, P, C, **f32)
    m = torch.empty(B, P, **f32)
    l = torch.empty(B, P, **f32)
    ws_m = torch.empty(B, S, P, **f32)
    ws_l = torch.empty(B, S, P, **f32)
    ws_acc = torch.empty(B, S, P, C, **f32)

    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.coattn_fwd(_ptr(q), _ptr(x), _ptr(x_scale), _ptr(x_inv), _ptr(mask),
                         float(scale), B, N, C, P, plan["L"], S, storage,
                         _device_index(device), _ptr(ws_m), _ptr(ws_l), _ptr(ws_acc),
                         _ptr(out), _ptr(m), _ptr(l), stream)
    if err != 0:
        raise RuntimeError(f"coattn_fwd kernel launch failed: cudaError {err}")
    LAUNCHES[variant_name(x.dtype, x_inv is not None)] += 1
    LAUNCHES_FWD_PATH["wide" if plan["groups"] > 1 else "group"] += 1
    LAUNCHES_QUERY_PATH[grid_route(P)] += 1
    return out, m, l


def coattn_bwd_dq(q: torch.Tensor, x: torch.Tensor, mask: torch.Tensor, scale: float,
                  g: torch.Tensor, out: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                  x_scale: Optional[torch.Tensor] = None,
                  x_inv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the Hopper dQ kernel on CUDA tensors: the queries' gradient
    dq [P, C] f32 from the output's cotangent g [B, P, C] and the forward's
    (out, m, l) as `coattn_fwd` returns them.  One partial a block of
    `kernel_plan`, summed in block order: repeated calls give the same
    bits.  Any P >= 1 (query groups of 16 rows on the grid, in launches of
    at most 65,535 groups) and any C (a multiple of 8): above 512 the
    kernel's wide instance runs."""
    B, N, C, P = _check_inputs(q, x, mask, x_scale, x_inv, "coattn_bwd_dq")
    device = x.device
    _check_forward_outputs(g, out, m, l, B, P, C, device)
    lib = _library("coattn_bwd_dq")
    plan = _plan(lib, "coattn_bwd_dq", device, x.dtype, B, N, C, P)

    dq = torch.empty(P, C, dtype=torch.float32, device=device)
    ws_dq = torch.empty(max(plan["blocks"], 1), P, C, dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.coattn_bwd_dq(_ptr(q), _ptr(x), _ptr(x_scale), _ptr(x_inv), _ptr(mask),
                            float(scale), _ptr(g), _ptr(out), _ptr(m), _ptr(l),
                            B, N, C, P, plan["L"], _STORAGE[x.dtype], _device_index(device),
                            _ptr(ws_dq), _ptr(dq), stream)
    if err != 0:
        raise RuntimeError(f"coattn_bwd_dq kernel launch failed: cudaError {err}")
    LAUNCHES_BWD[variant_name(x.dtype, x_inv is not None)] += 1
    LAUNCHES_BWD_PATH["wide" if plan["groups"] > 1 else "group"] += 1
    LAUNCHES_QUERY_PATH[grid_route(P)] += 1
    return dq


def coattn_bwd_dx(q: torch.Tensor, x: torch.Tensor, mask: torch.Tensor, scale: float,
                  g: torch.Tensor, out: torch.Tensor, m: torch.Tensor, l: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the Hopper full-backward kernel on CUDA tensors: (dq [P, C]
    f32, dX [B, N, C] in x's type) from the output's cotangent g [B, P, C]
    and the forward's (out, m, l) as `coattn_fwd` returns them.  x is f32 or
    bf16 (int8 features are constants) and its norms are computed in the
    kernel: there are no sidecars.  The dq reduction is `coattn_bwd_dq`'s,
    the plan too up to 16 queries; above, the kernel loops over the query
    groups on each tile (tiles of 32 patches, f32 16; no query groups on
    the grid), staging each group's stats (s_row = g . out from a small
    kernel before it, into a [B, P] workspace).  Any P and any C (a
    multiple of 8)."""
    B, N, C, P = _check_inputs(q, x, mask, None, None, "coattn_bwd_dx")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"coattn_bwd_dx takes f32 or bf16 x (int8 features are "
                         f"constants), got {x.dtype}")
    device = x.device
    _check_forward_outputs(g, out, m, l, B, P, C, device)
    lib = _library("coattn_bwd_dx")
    plan = _plan(lib, "coattn_bwd_dx", device, x.dtype, B, N, C, P)

    dq = torch.empty(P, C, dtype=torch.float32, device=device)
    dx = torch.empty_like(x)
    ws_dq = torch.empty(max(plan["blocks"], 1), P, C, dtype=torch.float32, device=device)
    ws_srow = (torch.empty(B, P, dtype=torch.float32, device=device)
               if P > _QUERY_ROWS else None)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.coattn_bwd_dx(_ptr(q), _ptr(x), _ptr(mask), float(scale), _ptr(g), _ptr(out),
                            _ptr(m), _ptr(l), B, N, C, P, plan["L"], _STORAGE[x.dtype],
                            _device_index(device), _ptr(ws_dq), _ptr(ws_srow), _ptr(dq),
                            _ptr(dx), stream)
    if err != 0:
        raise RuntimeError(f"coattn_bwd_dx kernel launch failed: cudaError {err}")
    LAUNCHES_DX[_STORAGE_NAME[x.dtype]] += 1
    LAUNCHES_BWD_PATH["wide" if plan["groups"] > 1 else "group"] += 1
    LAUNCHES_QUERY_PATH["loop" if P > _QUERY_ROWS else "single"] += 1
    return dq, dx


class CoattnPoolDQ(torch.autograd.Function):
    """Co-attention pooling with constant patch features on CUDA: the forward
    kernel, and the dQ kernel for the queries' gradient (the counterpart of
    vlsa_tpu's `_coattn_pool_tpu_nodx` / `_nodx_q8` custom VJPs).  x, its
    sidecars, the mask and the scale (a frozen buffer) get no gradient.  The
    backward is a kernel with no derivative of its own: a second backward
    through it raises (`ops.flags.disable_kernels` takes the plain
    version)."""

    @staticmethod
    def forward(ctx, q, x, mask, scale, x_scale, x_inv):
        out, m, l = coattn_fwd(q, x, mask, scale, x_scale, x_inv)
        ctx.save_for_backward(q, x, mask, x_scale, x_inv, out, m, l)
        ctx.scale = scale
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, x, mask, x_scale, x_inv, out, m, l = ctx.saved_tensors
        dq = coattn_bwd_dq(q, x, mask, ctx.scale, g.contiguous(), out, m, l,
                           x_scale=x_scale, x_inv=x_inv)
        return dq, None, None, None, None, None


class CoattnPoolFull(torch.autograd.Function):
    """Co-attention pooling on CUDA whose patch features need a gradient:
    the forward kernel, and the full-backward kernel for dX and dq (the
    counterpart of vlsa_tpu's `_coattn_pool_tpu` and its VJP
    `_coattn_bwd_rule`).  dq is returned only where q needs it; the mask and
    the scale (a frozen buffer) get no gradient.  No double backward, as
    `CoattnPoolDQ`."""

    @staticmethod
    def forward(ctx, q, x, mask, scale):
        out, m, l = coattn_fwd(q, x, mask, scale)
        ctx.save_for_backward(q, x, mask, out, m, l)
        ctx.scale = scale
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, x, mask, out, m, l = ctx.saved_tensors
        dq, dx = coattn_bwd_dx(q, x, mask, ctx.scale, g.contiguous(), out, m, l)
        return (dq if ctx.needs_input_grad[0] else None), dx, None, None


def coattn_pool(q: torch.Tensor, x: torch.Tensor, mask: Optional[torch.Tensor],
                scale, x_scale: Optional[torch.Tensor] = None,
                x_inv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked co-attention pooling: q [P, C] effective queries (normalised),
    x [B, N, C] raw patch features, mask [B, N] -> [B, P, C] f32 (float64
    for float64 features on the plain version).

    CPU tensors take the plain version under ordinary autograd (it ignores
    `x_inv`: it normalises the rows itself), as CUDA tensors do, on the
    card, inside `ops.flags.disable_kernels()`.  Otherwise CUDA tensors
    launch the forward kernel; for a gradient, `CoattnPoolFull` (the dX kernel) when x
    needs one, whether q does or not (`x_inv` is ignored there, as the JAX
    package ignores it), else `CoattnPoolDQ` (the dQ kernel) when q does.
    Features with a gradient must be f32 or bf16 with no `x_scale`: int8
    features are constants (ValueError, as vlsa_tpu's assert)."""
    if x.dtype == torch.int8 and x_scale is None:
        raise ValueError("int8 features need x_scale [B, N]")
    needs_dx = torch.is_grad_enabled() and (
        x.requires_grad or (x_scale is not None and x_scale.requires_grad))
    if needs_dx and x_scale is not None:
        raise ValueError("quantized (int8 + x_scale) features are constants: they "
                         "cannot back-propagate into a feature projecter")
    if mask is None:
        mask = torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"coattn_pool runs on cpu or cuda, not {x.device}")
    if x.device.type == "cpu" or kernels_disabled():
        return coattn_pool_reference(q, x, mask, scale, x_scale=x_scale,
                                     dtype=torch.promote_types(x.dtype, torch.float32))
    mask = mask.contiguous()
    if needs_dx:
        return CoattnPoolFull.apply(q.contiguous(), x, mask, float(scale))
    if torch.is_grad_enabled() and q.requires_grad:
        return CoattnPoolDQ.apply(q.contiguous(), x, mask, float(scale), x_scale, x_inv)
    out, _m, _l = coattn_fwd(q.contiguous(), x, mask, float(scale),
                             x_scale=x_scale, x_inv=x_inv)
    return out
