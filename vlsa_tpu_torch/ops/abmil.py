"""ABMIL attention pooling -- the hot op of the SA baseline (DeepMIL/ABMIL).

A bag of N patch features x [B, N, D] is pooled through a tanh bottleneck:

    h = tanh(x @ W1^T + b1);  a = softmax_N(h @ w2 + b2);  out = a @ x

Counterpart of vlsa_tpu/ops/abmil.py.  `abmil_pool` is the entry point: a
CPU tensor goes through the plain PyTorch version under ordinary autograd, a
CUDA tensor through the hand-written Hopper kernels: `csrc/abmil_fwd.cu`
forward and, when a gradient is wanted, `csrc/abmil_bwd.cu` for the backward
(`AbmilPool`, `AbmilPoolQ8`).  b2 shifts every logit alike and cancels in
the softmax: no route uses it, so `fc2_bias` gets no gradient, as under the
JAX custom VJPs.

Storage types of x: f32, bf16, or int8 with per-patch dequant scales
`x_scale` [B, N].  The plain versions follow the TPU kernels' rounding, not a
higher precision: bf16 storage multiplies x by W1 rounded to bf16 and, in
the backward, rounds dz (and W1) to bf16 for dX and dW1; int8 computes
s[n] * (x_i . W1^T) in f32 on the raw int8 values; f32 is true f32 (TF32 off,
`utils.device.disable_tf32`).  The int8 forward kernel multiplies the raw
int8 values by W1 split into two int8 parts, as the TPU kernel does
(`split_w1_i8`, ~15 bits); `abmil_fwd_rounded` is the plain model of that
split, `abmil_fwd_reference` the plain version both are held against.  The
f32 kernels form their products (x . W1^T, dz . W1, dz^T x) as split TF32 on
the tensor cores: each f32 operand is a TF32 hi plus a TF32 lo, and a product is lo.hi + hi.lo + hi.hi in f32, ~2^-21
relative against true f32's 2^-24 (as the TPU kernels' own f32 is the MXU's
multi-pass bf16), held against the true-f32 plain versions on the card.

Widths: the kernels take any D >= 1 and hid >= 1 (`kernel_widths_ok`;
Virchow's 2560-d features, odd widths, rows that are not 16-byte aligned,
D past 8192, hid past 1024), as the TPU kernels, which tile only N, take
any: a block holds b1, w2 and the backward's column sums of every hid
column in shared memory up to `_SMEM_HID` padded columns and past that
only a pass's columns of b1 and w2, the column sums in a per-block
workspace; D's vectors (the forward's PV sums, the backward's g) stay in
shared memory up to `_SMEM_D` channels and past that live in device
memory.  So no block's shared memory grows past the card's with the
widths, and the widths that fit keep their layout.  int8's products are exact in int32 up to D = 132,104 (D * 128 *
127 < 2^31), as vlsa_tpu's own int32 product is.
D=512, hid=256 runs the instances that keep x resident ("special"); every
other width, and bf16 in vlsa_tpu's precise mode (`VLSA_TPU_ABMIL_PRECISE=1`:
W1 and dz as bf16 hi + lo, `abmil_fwd_rounded` / `abmil_bwd_rounded` with
`precise=True` its plain model), the general instances, which stream x and
take W1 from a workspace zero-padded to hid_p = `gen_hid_pad(hid)` rows of
ld = `gen_ld(D)` values (a padded column adds tanh(0) * 0 to a logit and
gets dz = 0; int8's max|W1| is unchanged), in passes of 64, 128 or 256
columns (csrc/abmil_common.cuh: gen_pass_cols) (`route`).
"""
from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from .coattn import _device_index, _ptr
from .flags import kernels_disabled

# vlsa_tpu's precise mode (vlsa_tpu/ops/abmil.py:74-80), read once at import:
# bf16 storage forms x . W1^T against W1 as bf16 hi + lo, and the backward
# splits dz into bf16 hi + lo for dX and dW1 (twice the products); f32 and
# int8 do not change.  The CUDA kernels read it at each call from this
# module, so a test may set it.
_PRECISE = os.environ.get("VLSA_TPU_ABMIL_PRECISE", "0") == "1"

D_KERNEL, HID_KERNEL = 512, 256  # the widths of the resident-x instances (kD, kHid)
# Every width but D_KERNEL, HID_KERNEL (and bf16 in precise mode) runs the
# general instances (csrc/abmil_common.cuh: widths_ok takes any D, hid >= 1);
# they keep D's vectors in shared memory up to _SMEM_D channels (kSmemD),
# and b1, w2 and the backward's column sums of every column up to _SMEM_HID
# padded hid columns (kSmemHid; past that the sums in the plan's ws_sums)
_SMEM_D = 8192
_SMEM_HID = 1024
_GEN_TILE = 64  # patches a tile of the general instances (kGenM)
_GEN_PAD = 64   # the general instances' W1 rows and row length pad to multiples of this
# patches a tile of the backward's pass 1, every storage, and of the f32
# forward (kMF in csrc/abmil_common.cuh)
_TILE = {torch.float32: 64, torch.bfloat16: 64, torch.int8: 64}
# patches a tile of the forward (kMF; the bf16 and int8 kernel's kMQ in
# csrc/abmil_fwd.cu)
_FWD_TILE = {torch.float32: 64, torch.bfloat16: 128, torch.int8: 128}
# the int8 W1 scale workspace: s_w and the partial maxima of |W1|
# (kAmaxBlocks in csrc/abmil_common.cuh)
_AMAX_BLOCKS = 64
# the backward's weight-gradient pass (csrc/abmil_bwd.cu): a block for each
# [128, 128] tile of dW1 (kDwM, kDwN; _DW_TILES of them at D=512, hid=256)
# on each chunk of the B*N patch rows, chunks a multiple of the rows a
# stage holds (f32 kRowsDw, bf16 and int8 kRowsDwB); in precise mode a
# block adds its tensor-core sum into its partial every kDwChain rows
_DW_M = _DW_N = 128
_DW_TILES = 8
_DW_ROWS = {torch.float32: 32, torch.bfloat16: 64, torch.int8: 64}
_STORAGE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_STORAGE_NAME = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "int8"}

# Launches of the CUDA kernels by variant: one per call of `abmil_fwd` /
# `abmil_q8_fwd` in LAUNCHES ("f32", "bf16", "int8"), one per call of
# `abmil_bwd` / `abmil_q8_bwd` in LAUNCHES_BWD (those, and "f32_dx",
# "bf16_dx" for a backward that writes dX); and each call again by the
# instances it ran, in LAUNCHES_ROUTE (forward) and LAUNCHES_BWD_ROUTE:
# "special" (D=512, hid=256), "general" (any other width), "wide" (D past
# _SMEM_D, the general instances with D's vectors in device memory) and
# "precise" (bf16 in precise mode, the general instances).
LAUNCHES = {s: 0 for s in ("f32", "bf16", "int8")}
LAUNCHES_BWD = dict(LAUNCHES, f32_dx=0, bf16_dx=0)
LAUNCHES_ROUTE = {r: 0 for r in ("special", "general", "wide", "precise")}
LAUNCHES_BWD_ROUTE = dict(LAUNCHES_ROUTE)


def reset_launches() -> None:
    for counts in (LAUNCHES, LAUNCHES_BWD, LAUNCHES_ROUTE, LAUNCHES_BWD_ROUTE):
        for k in counts:
            counts[k] = 0


def kernel_widths_ok(D: int, hid: int) -> bool:
    """True for the widths the CUDA kernels take: any D >= 1 (ViT-S 384,
    CONCH 512, CTransPath 768, UNI 1024, Prov-GigaPath 1536, Virchow 2560,
    any other) and hid >= 1."""
    return D >= 1 and hid >= 1


def gen_hid_pad(hid: int) -> int:
    """The general instances' W1 rows: hid rounded up to a multiple of 64
    (csrc/abmil_common.cuh: gen_hid_pad)."""
    return -(-hid // _GEN_PAD) * _GEN_PAD


def gen_ld(D: int) -> int:
    """The general instances' W1 row length: D rounded up to a multiple of 64
    (gen_ld)."""
    return -(-D // _GEN_PAD) * _GEN_PAD


def _precise_for(dtype: torch.dtype, precise: Optional[bool]) -> bool:
    """Precise mode applies to bf16 storage only; None reads `_PRECISE`."""
    return dtype == torch.bfloat16 and (_PRECISE if precise is None else precise)


def route(dtype: torch.dtype, D: int, hid: int, precise: Optional[bool] = None) -> str:
    """The instances a call runs: "special" (x resident, D=512, hid=256),
    "precise" (bf16 in precise mode), "general", or "wide" (the general
    instances past D = _SMEM_D, D's vectors in device memory)."""
    if _precise_for(dtype, precise):
        return "precise"
    if (D, hid) == (D_KERNEL, HID_KERNEL):
        return "special"
    return "wide" if D > _SMEM_D else "general"


def bwd_variant(x_dtype: torch.dtype, with_dx: bool) -> str:
    return _STORAGE_NAME[x_dtype] + ("_dx" if with_dx else "")


# ---------------------------------------------------------------- plain versions

def _bf16_rounded(w: torch.Tensor) -> torch.Tensor:
    """w rounded to bf16 in value, in w's type, with the identity as its
    gradient."""
    return w + (w.to(torch.bfloat16).to(w.dtype) - w).detach()


def _bf16_split(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """t as bf16 hi + lo in value, in t's type (vlsa_tpu/ops/coattn.py::
    _mm_rows): hi its bf16 rounding, lo the bf16 rounding of t - hi."""
    hi = t.to(torch.bfloat16).to(t.dtype)
    return hi, (t - hi).to(torch.bfloat16).to(t.dtype)


def _h_pre(x, w1, x_scale, precise=False):
    """x . W1^T [B, N, hid] in W1's type (f32; f64 for the exact model) as
    the kernels form it for x's storage type; bf16 in precise mode against
    W1's hi and lo, two products summed."""
    xf = x.to(w1.dtype)
    if x.dtype == torch.int8:
        return (xf @ w1.T) * x_scale[..., None]
    if x.dtype == torch.bfloat16:
        if precise:
            hi, lo = _bf16_split(w1.detach())
            return xf @ hi.T + xf @ lo.T
        return xf @ _bf16_rounded(w1).T
    return xf @ w1.T


def _logits(x, mask, w1, b1, w2, x_scale, precise=False):
    h = torch.tanh(_h_pre(x, w1, x_scale, precise) + b1)
    return h, torch.where(mask, h @ w2, -1e30)


def _pool(x, mask, h_pre, b1, w2, x_scale):
    """(out, m, l) of the forward from the bottleneck's h_pre [B, N, hid]."""
    logits = torch.where(mask, torch.tanh(h_pre + b1) @ w2, -1e30)
    m = logits.amax(-1).detach()
    p = torch.where(mask, torch.exp(logits - m[:, None]), 0.0)
    l = torch.clamp(p.sum(-1), min=1e-30)
    w = p if x_scale is None else p * x_scale
    return torch.einsum("bn,bnd->bd", w, x.float()) / l[:, None], m, l


def abmil_fwd_reference(x: torch.Tensor, mask: torch.Tensor, w1: torch.Tensor,
                        b1: torch.Tensor, w2: torch.Tensor,
                        x_scale: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernels: x [B, N, D], mask [B, N] bool,
    w1 [hid, D], b1 [hid], w2 [hid] -> (out [B, D], m [B], l [B]) f32 with the
    kernels' stats: m the masked max logit (-1e30 for an empty bag), l the
    softmax normaliser clamped below at 1e-30.  Differentiable in x, w1, b1
    and w2 (the max is a constant shift)."""
    return _pool(x, mask, _h_pre(x, w1, x_scale), b1, w2, x_scale)


def split_w1_i8(w1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """W1 [hid, D] f32 split as the int8 forward kernel (csrc/abmil_fwd.cu::
    prep_w1_i8) and the TPU kernel (vlsa_tpu/ops/coattn.py::_mm_rows_i8)
    split it: s_w = max(max|W1|, 1e-30) / 127, v = W1 * (1 / s_w), hi =
    round(v), lo = round(254 (v - hi)), ties to even, in f32 ->
    (hi, lo int8 [hid, D], s_w f32 []).  W1 ~ s_w (hi + lo / 254)."""
    w = w1.detach().float()
    s = torch.clamp(w.abs().max(), min=1e-30) * torch.tensor(1.0 / 127.0, dtype=torch.float32)
    v = w * (1.0 / s)
    hi = torch.round(v)
    lo = torch.round((v - hi) * 254.0)
    return hi.to(torch.int8), lo.to(torch.int8), s


def abmil_fwd_rounded(x: torch.Tensor, mask: torch.Tensor, w1: torch.Tensor,
                      b1: torch.Tensor, w2: torch.Tensor,
                      x_scale: Optional[torch.Tensor] = None, precise: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain model of the forward kernels' rounding.  int8: `abmil_fwd_reference`
    with x_i . W1^T taken against W1 split by `split_w1_i8`, h_unit = s_w
    (P_hi + P_lo / 254) from the exact integer products; the PV sum keeps f32
    weights.  bf16 with `precise` (vlsa_tpu's precise mode): x . W1_hi^T +
    x . W1_lo^T, W1 split into bf16 hi + lo, as vlsa_tpu/ops/abmil.py::
    _h_matmul forms it.  Other storage types: `abmil_fwd_reference` (the bf16
    kernel rounds as it does).  No gradient."""
    if x.dtype != torch.int8:
        with torch.no_grad():
            return _pool(x, mask, _h_pre(x, w1, x_scale, _precise_for(x.dtype, precise)), b1,
                         w2, x_scale)
    with torch.no_grad():
        hi, lo, s = split_w1_i8(w1)
        xd = x.double()
        p_hi, p_lo = (xd @ part.double().T for part in (hi, lo))  # exact: |P| < 2^24
        h_unit = s * (p_hi.float() + p_lo.float() * (1.0 / 254.0))
        return _pool(x, mask, h_unit * x_scale[..., None], b1, w2, x_scale)


def abmil_bwd_reference(x: torch.Tensor, mask: torch.Tensor, w1: torch.Tensor,
                        b1: torch.Tensor, w2: torch.Tensor, g: torch.Tensor,
                        out: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                        x_scale: Optional[torch.Tensor] = None, need_dx: bool = True):
    """Plain version of the backward kernels (vlsa_tpu/ops/abmil.py::
    _abmil_bwd_kernel, _abmil_q8_bwd_kernel): from the output's cotangent
    g [B, D], the forward output and its stats -> (dX or None, dW1 [hid, D],
    db1 [hid], dw2 [hid]), all f32 except dX in the storage type.  int8 has
    no dX: stored features are data."""
    return _bwd_plain(x, mask, w1, b1, w2, g, out, m, l, x_scale, need_dx, False)


def abmil_bwd_rounded(x: torch.Tensor, mask: torch.Tensor, w1: torch.Tensor,
                      b1: torch.Tensor, w2: torch.Tensor, g: torch.Tensor,
                      out: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                      x_scale: Optional[torch.Tensor] = None, need_dx: bool = True,
                      precise: bool = False, exact: bool = False):
    """The backward counterpart of `abmil_fwd_rounded`: for bf16 with
    `precise`, h from W1's hi + lo, and dz split into bf16 hi + lo for dX
    (dz_hi . W1 + dz_lo . W1, W1 rounded to bf16 once) and dW1 (dz_hi^T x +
    dz_lo^T x), as vlsa_tpu/ops/abmil.py:99-111 and :250-253 form them;
    otherwise `abmil_bwd_reference`.  With `exact`, everything after those
    operand roundings is computed in f64 and returned in f64, dX not rounded
    to the storage type: no summation error of its own, what a kernel's f32
    sums and its rounding of dX are held against."""
    return _bwd_plain(x, mask, w1, b1, w2, g, out, m, l, x_scale, need_dx,
                      _precise_for(x.dtype, precise), exact)


def abmil_bwd_sum_scales(x: torch.Tensor, mask: torch.Tensor, w1: torch.Tensor,
                         b1: torch.Tensor, w2: torch.Tensor, g: torch.Tensor,
                         out: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                         x_scale: Optional[torch.Tensor] = None, precise: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum_n |dz_n| [hid], sum_n |ds_n h_n| [hid]) in f64: the sizes the
    error of db1's and dw2's f32 sums over every patch scales with, which
    sum_n ds_n = 0 does not cancel."""
    with torch.no_grad():
        exact = (t.double() for t in (w1, b1, w2, g, out, m, l))
        _xf, h, _a, ds, dz = _bwd_terms(x, mask, *exact,
                                        None if x_scale is None else x_scale.double(),
                                        _precise_for(x.dtype, precise))
        return dz.abs().sum((0, 1)), (ds.abs()[..., None] * h.abs()).sum((0, 1))


def bwd_model_gaps(got, exact, scales) -> dict:
    """A backward kernel's (dX or None, dW1, db1, dw2) against its exact
    model `exact` (`abmil_bwd_rounded(..., exact=True)`): dW1 by
    max|k - e| / max|e|; db1 and dw2 by max|k - e| over the largest of
    `scales` (`abmil_bwd_sum_scales`); bf16 dX by the part of |k - e| beyond
    half a bf16 ulp of e (the kernel rounds its f32 dX to bf16 once) over
    max|e|.  {leaf: gap}, dX only where there is one."""
    dx, dw1, db1, dw2 = (None if t is None else t.double() for t in got)
    gaps = {"dW1": float((dw1 - exact[1]).abs().max() / exact[1].abs().max().clamp_min(1e-300))}
    for name, k, e, sc in (("db1", db1, exact[2], scales[0]), ("dw2", dw2, exact[3], scales[1])):
        gaps[name] = float((k - e).abs().max() / sc.max().clamp_min(1e-300))
    if dx is not None:
        e = exact[0]
        half_ulp = torch.ldexp(torch.ones_like(e), torch.frexp(e)[1] - 9)
        gaps["dX"] = float(((dx - e).abs() - half_ulp).clamp_min(0).max()
                           / e.abs().max().clamp_min(1e-300))
    return gaps


def _bwd_terms(x, mask, w1, b1, w2, g, out, m, l, x_scale, precise):
    """(x, h, a, ds, dz) of the backward in W1's type."""
    xf = x.to(w1.dtype)
    h, logits = _logits(x, mask, w1, b1, w2, x_scale, precise)
    # a is masked to 0 first: an empty bag has m = -1e30, l = 1e-30
    a = torch.where(mask, torch.exp(logits - m[:, None]) / l[:, None], 0.0)
    gx = torch.einsum("bd,bnd->bn", g, xf)
    if x_scale is not None:
        gx = gx * x_scale
    ds = a * (gx - (g * out).sum(-1, keepdim=True))
    return xf, h, a, ds, ds[..., None] * w2 * (1.0 - h * h)


def _bwd_plain(x, mask, w1, b1, w2, g, out, m, l, x_scale, need_dx, precise, exact=False):
    with torch.no_grad():
        if exact:
            w1, b1, w2, g, out, m, l = (t.double() for t in (w1, b1, w2, g, out, m, l))
            x_scale = None if x_scale is None else x_scale.double()
        xf, h, a, ds, dz = _bwd_terms(x, mask, w1, b1, w2, g, out, m, l, x_scale, precise)
        db1, dw2 = dz.sum((0, 1)), torch.einsum("bn,bnh->h", ds, h)
        if x.dtype == torch.int8:
            return None, torch.einsum("bnh,bnd->hd", dz * x_scale[..., None], xf), db1, dw2
        # the parts dX and dW1 take dz in: bf16 rounds it, precise splits it
        parts = [dz]
        if x.dtype == torch.bfloat16:
            parts = list(_bf16_split(dz)) if precise else [_bf16_rounded(dz)]
        dw1 = sum(torch.einsum("bnh,bnd->hd", z, xf) for z in parts)
        dx = None
        if need_dx:
            w = _bf16_rounded(w1) if x.dtype == torch.bfloat16 else w1
            dx = a[..., None] * g[:, None, :] + sum(z @ w for z in parts)
            dx = dx if exact else dx.to(x.dtype)
        return dx, dw1, db1, dw2


def abmil_pool_reference(x: torch.Tensor, mask: Optional[torch.Tensor], w1: torch.Tensor,
                         b1: torch.Tensor, w2: torch.Tensor, b2,
                         x_scale: Optional[torch.Tensor] = None):
    """The plain module path in f32: (out [B, D], raw attention logits
    [B, N]) with b2 added, on dequantized features for int8."""
    xf = x.float() if x_scale is None else x.float() * x_scale[..., None]
    h = torch.tanh(xf @ w1.T + b1)
    raw = h @ w2 + b2
    if mask is None:
        attn = torch.softmax(raw, dim=-1)
    else:
        attn = torch.where(mask, torch.softmax(torch.where(mask, raw, -1e30), dim=-1), 0.0)
    return torch.einsum("bn,bnd->bd", attn, xf), raw


# ---------------------------------------------------------------- launch wrappers

_P, _I = ctypes.c_void_p, ctypes.c_int
# the argument types of each library's entry point `<name>` (csrc/<name>.cu)
_ARGTYPES = {
    # x, x_scale, mask, w1, b1, w2; B, N, D, hid, chunk, S, storage, precise,
    # device; w1_ws, w1_scale, ws_m, ws_l, ws_acc, out, m, l, stream
    "abmil_fwd": [_P] * 6 + [_I] * 9 + [_P] * 9,
    # x, x_scale, mask, w1, b1, w2, g, out, m, l; B, N, D, hid, chunk1, S1,
    # chunk2, S2, storage, precise, with_dx, device; w1_ws, w1_scale, ds,
    # ws_dw1, ws_sums, ws_db1, ws_dw2, dx, dw1, db1, dw2, stream
    "abmil_bwd": [_P] * 10 + [_I] * 12 + [_P] * 12,
}
# (storage, D, hid, precise) and, for the backward, the pass
_SMEM_ARGTYPES = {"abmil_fwd": [_I] * 4, "abmil_bwd": [_I] * 5}


def _library(name: str):
    from ._build import load
    lib = load(name)
    if not getattr(lib, "_argtypes_set", False):
        entry, smem = getattr(lib, name), getattr(lib, f"{name}_smem_bytes")
        entry.argtypes, entry.restype = _ARGTYPES[name], _I
        smem.argtypes, smem.restype = _SMEM_ARGTYPES[name], ctypes.c_size_t
        lib._argtypes_set = True
    return lib


# a block's fixed cost in tiles of work: its first slices' latency, the
# partial it writes and the merge (forward) or reduce (backward) that reads it
_BLOCK_COST_TILES = 0.25


@functools.lru_cache(maxsize=256)
def _split_waves(B: int, N: int, tile: int, n_sm: int) -> Tuple[int, int]:
    """(chunk, S): each bag's patches cut into S chunks of `chunk` patches
    (a multiple of the tile), one block each, for kernels whose block fills
    an SM (the forward's x tile and W1 stages take 197-209 KB of shared
    memory; the backward's pass 1 runs one block an SM): the chunk
    that ends soonest, ceil(B*S / n_sm) waves of chunk/tile tiles and a
    block's fixed cost each, and the fewest blocks among equals."""
    tiles = max(1, -(-N // tile))
    best = None
    for S in range(1, tiles + 1):
        per = -(-tiles // S)
        S = -(-tiles // per)
        key = (-(-B * S // n_sm) * (per + _BLOCK_COST_TILES), B * S)
        if best is None or key < best[0]:
            best = (key, per * tile, S)
    return best[1], best[2]


def dw_tiles(D: int, hid: int) -> int:
    """The weight-gradient pass's [128, 128] tiles of dW1 [hid, D] (the
    kernel's dw_tiles; the edge tiles masked)."""
    return -(-hid // _DW_M) * -(-D // _DW_N)


def _split_rows(K: int, n_sm: int, rows: int, tiles: int = _DW_TILES) -> Tuple[int, int]:
    """(chunk2, S2) of the backward's weight-gradient pass: the K = B*N
    patch rows in S2 chunks of chunk2 rows (a multiple of `rows`), so that
    the `tiles` tiles of each chunk fill about one wave of the card."""
    S2 = max(1, n_sm // tiles)
    chunk = -(-(-(-K // S2)) // rows) * rows
    return chunk, -(-K // chunk)


@functools.lru_cache(maxsize=256)
def fwd_plan(dtype: torch.dtype, B: int, N: int, n_sm: int, D: int = D_KERNEL,
             hid: int = HID_KERNEL, precise: bool = False) -> dict:
    """The forward's launch plan for x of `dtype` [B, N, D] and W1 [hid, D]
    on a card of n_sm SMs: its instances ("route", `route`), the chunk of
    patches a block takes (a multiple of "tile"), the blocks S a bag, and
    the workspace shapes the wrapper allocates: W1 for the kernel ("w1_ws",
    in x's type, [hid, D] on the resident instances and [hid_p, ld] --
    `gen_hid_pad`, `gen_ld` -- on the general ones: bf16 its rounding, hi
    and lo [2, ...] for int8 and for bf16 in precise mode; for f32 none on
    the resident instances, the padded copy, f32, on the general ones)
    and, for int8, "w1_scale" f32 (s_w and the partial maxima of |W1|)."""
    rt = route(dtype, D, hid, precise)
    tile = _FWD_TILE[dtype] if rt == "special" else _GEN_TILE
    chunk, S = _split_waves(B, N, tile, n_sm)
    two = dtype == torch.int8 or rt == "precise"
    rows, ld = (hid, D) if rt == "special" else (gen_hid_pad(hid), gen_ld(D))
    if dtype == torch.float32:
        w1_ws = None if rt == "special" else (rows, ld)
    else:
        w1_ws = (2, rows, ld) if two else (rows, ld)
    return {"route": rt, "tile": tile, "chunk": chunk, "S": S, "ws_m": (B, S), "ws_l": (B, S),
            "ws_acc": (B, S, D), "w1_ws": w1_ws,
            "w1_scale": (1 + _AMAX_BLOCKS,) if dtype == torch.int8 else None}


@functools.lru_cache(maxsize=256)
def bwd_plan(dtype: torch.dtype, B: int, N: int, n_sm: int, D: int = D_KERNEL,
             hid: int = HID_KERNEL, precise: bool = False) -> dict:
    """The backward's launch plan: pass 1 over chunks of chunk1 patches of
    each bag (S1 a bag; its block fills an SM), pass 2 over S2 chunks of
    chunk2 of the B*N patch rows, for each of its dw_tiles(D, hid) tiles of
    dW1 (S2 * tiles about one wave: ws_dw1 stays under ~n_sm * 64 KB, 8.7 MB
    on 132 SMs, where the tiles fit one wave; past that S2 = 1, ws_dw1 one
    dW1), and the workspace shapes: "ds" is the dz
    workspace [B, N, hid] of type "ds_dtype" (f32 for f32; bf16 for bf16,
    the TPU kernel's rounding of dz for dW1), for int8 and bf16 in precise
    mode [2, B, N, hid] bf16 (s dz's or dz's hi and lo), hid padded to
    `gen_hid_pad(hid)` on the general instances; the partials of dW1
    ("ws_dw1") come from pass 2, those of db1 and dw2 ("ws_b", each) from
    pass 1; W1 for pass 1 ([hid, D] on the resident instances, [hid_p, ld]
    on the general ones) is "w1_bf16" (bf16 and the special int8: bf16 hi
    and lo), for int8 at other widths the forward's int8 split "w1_i8" with
    its scales "w1_scale", for f32 its padded copy "w1_f32"; on the general
    instances past hid_p = `_SMEM_HID` pass 1's per-block column sums of db1
    and dw2 ("ws_sums", [B * S1, 4, hid_p], two row halves each; below it
    they stay in shared memory)."""
    rt = route(dtype, D, hid, precise)
    chunk1, S1 = _split_waves(B, N, _TILE[dtype], n_sm)
    chunk2, S2 = _split_rows(B * N, n_sm, _DW_ROWS[dtype], dw_tiles(D, hid))
    f32, i8 = dtype == torch.float32, dtype == torch.int8
    gen = rt != "special"
    gen_i8 = i8 and gen
    two = i8 or rt == "precise"
    rows, ld = (gen_hid_pad(hid), gen_ld(D)) if gen else (hid, D)
    return {"route": rt, "chunk1": chunk1, "S1": S1, "chunk2": chunk2, "S2": S2,
            "ds": (2, B, N, rows) if two else (B, N, rows),
            "ds_dtype": torch.float32 if f32 else torch.bfloat16,
            "ws_dw1": (S2, hid, D), "ws_b": (B * S1, hid),
            "w1_bf16": None if f32 or gen_i8 else (2, rows, ld),
            "w1_i8": (2, rows, ld) if gen_i8 else None,
            "w1_f32": (rows, ld) if f32 and gen else None,
            "w1_scale": (1 + _AMAX_BLOCKS,) if gen_i8 else None,
            "ws_sums": (B * S1, 4, rows) if gen and rows > _SMEM_HID else None}


def _tensor(name, t, shape, dtype, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} {list(shape)} tensor on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _check_inputs(x, x_scale, mask, w1, b1, w2, kernel: str) -> Tuple[int, int, int, int]:
    """The argument checks every wrapper shares; returns (B, N, D, hid)."""
    if x.device.type != "cuda":
        raise ValueError(f"{kernel} launches a CUDA kernel; x is on {x.device}")
    device = x.device
    if x.dtype not in _STORAGE:
        raise ValueError(f"x must be f32, bf16 or int8, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous() or x.shape[1] < 1:
        raise ValueError(f"x must be a contiguous [B, N>=1, D] tensor, got {tuple(x.shape)}")
    if x.data_ptr() % 16 != 0:
        raise ValueError("x must be 16-byte aligned")
    B, N, D = x.shape
    hid = w1.shape[0] if w1.dim() == 2 else -1
    if not kernel_widths_ok(D, hid):
        raise ValueError(f"x must have D >= 1 features and w1 be [hid >= 1, D], got "
                         f"D={D}, w1 {tuple(w1.shape)}")
    _tensor("mask", mask, (B, N), torch.bool, device)
    _tensor("w1", w1, (hid, D), torch.float32, device)
    _tensor("b1", b1, (hid,), torch.float32, device)
    _tensor("w2", w2, (hid,), torch.float32, device)
    if (x.dtype == torch.int8) != (x_scale is not None):
        raise ValueError("x_scale is required for int8 x and taken for no other type")
    if x_scale is not None:
        _tensor("x_scale", x_scale, (B, N), torch.float32, device)
    return B, N, D, hid


@functools.lru_cache(maxsize=256)
def _check_smem(lib, name, device_index, *args) -> None:
    """Raises if a block of `name` at `args` needs more shared memory than
    the card gives (checked once for each).  A guard: no instance's block
    grows with the widths past what an H100 gives (the sources check it at
    compile time)."""
    smem = getattr(lib, f"{name}_smem_bytes")(*args)
    optin = torch.cuda.get_device_properties(device_index).shared_memory_per_block_optin
    if smem > optin:
        raise ValueError(f"{name} needs {smem} bytes of shared memory per block, the "
                         f"card gives {optin}")


@functools.lru_cache(maxsize=16)
def _n_sm(device_index) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _empty(shape, dtype, device):
    """A workspace of the plan, or None where the plan has none."""
    return None if shape is None else torch.empty(shape, dtype=dtype, device=device)


def _fwd(x, x_scale, mask, w1, b1, w2, kernel):
    B, N, D, hid = _check_inputs(x, x_scale, mask, w1, b1, w2, kernel)
    device = x.device
    index = _device_index(device)
    lib = _library("abmil_fwd")
    storage, precise = _STORAGE[x.dtype], _precise_for(x.dtype, None)
    _check_smem(lib, "abmil_fwd", index, storage, D, hid, int(precise))
    plan = fwd_plan(x.dtype, B, N, _n_sm(index), D, hid, precise)
    chunk, S = plan["chunk"], plan["S"]
    f32 = dict(dtype=torch.float32, device=device)
    out, m, l = torch.empty(B, D, **f32), torch.empty(B, **f32), torch.empty(B, **f32)
    ws_m, ws_l = torch.empty(plan["ws_m"], **f32), torch.empty(plan["ws_l"], **f32)
    ws_acc = torch.empty(plan["ws_acc"], **f32)
    w1_ws = _empty(plan["w1_ws"], x.dtype, device)
    w1_scale = _empty(plan["w1_scale"], torch.float32, device)
    err = lib.abmil_fwd(_ptr(x), _ptr(x_scale), _ptr(mask), _ptr(w1), _ptr(b1), _ptr(w2),
                        B, N, D, hid, chunk, S, storage, int(precise), index,
                        _ptr(w1_ws), _ptr(w1_scale), _ptr(ws_m), _ptr(ws_l), _ptr(ws_acc),
                        _ptr(out), _ptr(m), _ptr(l), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {err}")
    LAUNCHES[_STORAGE_NAME[x.dtype]] += 1
    LAUNCHES_ROUTE[plan["route"]] += 1
    return out, m, l


def abmil_fwd(x: torch.Tensor, mask: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the Hopper forward on CUDA tensors, f32 or bf16 x [B, N, D],
    W1 [hid, D], any widths: (out [B, D], m [B], l [B]) f32, the
    pooled features and the softmax stats (running max and normaliser, l
    clamped below at 1e-30).  bf16 follows `_PRECISE`."""
    if x.dtype == torch.int8:
        raise ValueError("int8 features go through abmil_q8_fwd")
    return _fwd(x, None, mask, w1, b1, w2, "abmil_fwd")


def abmil_q8_fwd(x: torch.Tensor, x_scale: torch.Tensor, mask: torch.Tensor,
                 w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor):
    """`abmil_fwd` on raw int8 features with per-patch scales x_scale [B, N]."""
    if x.dtype != torch.int8:
        raise ValueError(f"abmil_q8_fwd takes int8 features, got {x.dtype}")
    return _fwd(x, x_scale, mask, w1, b1, w2, "abmil_q8_fwd")


def _bwd(x, x_scale, mask, w1, b1, w2, g, out, m, l, need_dx, kernel):
    B, N, D, hid = _check_inputs(x, x_scale, mask, w1, b1, w2, kernel)
    device = x.device
    _tensor("g", g, (B, D), torch.float32, device)
    _tensor("out", out, (B, D), torch.float32, device)
    _tensor("m", m, (B,), torch.float32, device)
    _tensor("l", l, (B,), torch.float32, device)
    index = _device_index(device)
    lib = _library("abmil_bwd")
    storage, precise = _STORAGE[x.dtype], _precise_for(x.dtype, None)
    for p in (1, 2):
        _check_smem(lib, "abmil_bwd", index, storage, D, hid, int(precise), p)
    plan = bwd_plan(x.dtype, B, N, _n_sm(index), D, hid, precise)
    chunk1, S1, chunk2, S2 = plan["chunk1"], plan["S1"], plan["chunk2"], plan["S2"]
    f32 = dict(dtype=torch.float32, device=device)
    dw1, db1, dw2 = torch.empty(hid, D, **f32), torch.empty(hid, **f32), torch.empty(hid, **f32)
    ds = torch.empty(plan["ds"], dtype=plan["ds_dtype"], device=device)
    ws_dw1 = torch.empty(plan["ws_dw1"], **f32)
    ws_db1, ws_dw2 = torch.empty(plan["ws_b"], **f32), torch.empty(plan["ws_b"], **f32)
    dx = torch.empty_like(x) if need_dx else None
    # the plan names at most one W1 workspace
    w1_ws = next((_empty(plan[k], t, device) for k, t in (
        ("w1_bf16", torch.bfloat16), ("w1_i8", torch.int8), ("w1_f32", torch.float32))
        if plan[k] is not None), None)
    w1s = _empty(plan["w1_scale"], torch.float32, device)
    ws_sums = _empty(plan["ws_sums"], torch.float32, device)
    err = lib.abmil_bwd(_ptr(x), _ptr(x_scale), _ptr(mask), _ptr(w1), _ptr(b1), _ptr(w2),
                        _ptr(g), _ptr(out), _ptr(m), _ptr(l), B, N, D, hid, chunk1, S1, chunk2,
                        S2, storage, int(precise), int(need_dx), index,
                        _ptr(w1_ws), _ptr(w1s), _ptr(ds), _ptr(ws_dw1), _ptr(ws_sums),
                        _ptr(ws_db1), _ptr(ws_dw2), _ptr(dx), _ptr(dw1), _ptr(db1), _ptr(dw2),
                        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {err}")
    LAUNCHES_BWD[bwd_variant(x.dtype, need_dx)] += 1
    LAUNCHES_BWD_ROUTE[plan["route"]] += 1
    return dx, dw1, db1, dw2


def abmil_bwd(x: torch.Tensor, mask: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, g: torch.Tensor, out: torch.Tensor, m: torch.Tensor,
              l: torch.Tensor, need_dx: bool = False):
    """Launch the Hopper backward on CUDA tensors, f32 or bf16 x: from the
    output's cotangent g [B, D] and the forward's (out, m, l) ->
    (dX [B, N, D] in x's type or None, dW1 [hid, D], db1, dw2 [hid] f32).
    dX is written only when `need_dx`; bf16 follows `_PRECISE`."""
    if x.dtype == torch.int8:
        raise ValueError("int8 features go through abmil_q8_bwd")
    return _bwd(x, None, mask, w1, b1, w2, g, out, m, l, need_dx, "abmil_bwd")


def abmil_q8_bwd(x: torch.Tensor, x_scale: torch.Tensor, mask: torch.Tensor,
                 w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, g: torch.Tensor,
                 out: torch.Tensor, m: torch.Tensor, l: torch.Tensor):
    """The weights-only backward on raw int8 features: (dW1, db1, dw2)."""
    if x.dtype != torch.int8:
        raise ValueError(f"abmil_q8_bwd takes int8 features, got {x.dtype}")
    return _bwd(x, x_scale, mask, w1, b1, w2, g, out, m, l, False, "abmil_q8_bwd")[1:]


# ---------------------------------------------------------------- autograd and entry

class AbmilPool(torch.autograd.Function):
    """ABMIL pooling of f32 or bf16 x on CUDA: the forward kernel, and the
    backward kernel for W1, b1, w2 and, when x needs one, x's gradient (the
    counterpart of vlsa_tpu's `_abmil_pool_tpu` custom VJP, whose backward
    writes dX always).  The backward is a kernel with no derivative of its
    own: a second backward through it raises (`ops.flags.disable_kernels`
    takes the plain version, which has one)."""

    @staticmethod
    def forward(ctx, x, mask, w1, b1, w2):
        out, m, l = abmil_fwd(x, mask, w1, b1, w2)
        ctx.save_for_backward(x, mask, w1, b1, w2, out, m, l)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, mask, w1, b1, w2, out, m, l = ctx.saved_tensors
        dx, dw1, db1, dw2 = abmil_bwd(x, mask, w1, b1, w2, g.contiguous(), out, m, l,
                                      need_dx=ctx.needs_input_grad[0])
        return dx, None, dw1, db1, dw2


class AbmilPoolQ8(torch.autograd.Function):
    """ABMIL pooling of raw int8 x on CUDA (`_abmil_pool_tpu_q8`): the
    features and their scales are data and get no gradient."""

    @staticmethod
    def forward(ctx, x, x_scale, mask, w1, b1, w2):
        out, m, l = abmil_q8_fwd(x, x_scale, mask, w1, b1, w2)
        ctx.save_for_backward(x, x_scale, mask, w1, b1, w2, out, m, l)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, x_scale, mask, w1, b1, w2, out, m, l = ctx.saved_tensors
        dw1, db1, dw2 = abmil_q8_bwd(x, x_scale, mask, w1, b1, w2, g.contiguous(), out, m, l)
        return None, None, None, dw1, db1, dw2


def abmil_pool(x: torch.Tensor, mask: Optional[torch.Tensor], w1: torch.Tensor,
               b1: torch.Tensor, w2: torch.Tensor, b2=None,
               x_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ABMIL attention pooling: x [B, N, D] (f32, bf16, or int8 with x_scale
    [B, N]), mask [B, N], w1 [hid, D], b1 [hid], w2 [hid] -> out [B, D] f32.
    b2 cancels in the softmax and is not used.

    CPU tensors take the plain version under ordinary autograd, as CUDA
    tensors do, on the card, inside `ops.flags.disable_kernels()`.  Otherwise
    CUDA tensors launch the forward kernel, through `AbmilPool` /
    `AbmilPoolQ8` when a gradient is wanted.  The JAX route takes its kernel only for N >= 256
    with a 128-aligned tile (vlsa_tpu/models/layers.py:103-105); these kernels
    take any N, so the CUDA route has no such guard."""
    if x.dtype == torch.int8 and x_scale is None:
        raise ValueError("int8 features need x_scale [B, N]")
    if mask is None:
        mask = torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"abmil_pool runs on cpu or cuda, not {x.device}")
    if x.device.type == "cpu" or kernels_disabled():
        return abmil_fwd_reference(x, mask, w1, b1, w2, x_scale=x_scale)[0]
    mask, w1, b1, w2 = (t.contiguous() for t in (mask, w1, b1, w2))
    wants_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, w1, b1, w2))
    if x.dtype == torch.int8:
        if wants_grad:
            return AbmilPoolQ8.apply(x, x_scale, mask, w1, b1, w2)
        return abmil_q8_fwd(x, x_scale, mask, w1, b1, w2)[0]
    if wants_grad:
        return AbmilPool.apply(x, mask, w1, b1, w2)
    return abmil_fwd(x, mask, w1, b1, w2)[0]
