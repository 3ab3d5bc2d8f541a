"""Masked co-attention pooling -- the hot op of the VLFAN aggregator.

A bag of N patch features x [B, N, C] is reduced against P <= 16 queries:

    xn = l2norm(x);  A = softmax_N(scale * q @ xn^T);  out = A @ x

Counterpart of vlsa_tpu/ops/coattn.py.  `coattn_pool` is the entry point:
a CPU tensor goes through the plain PyTorch version, a CUDA tensor through the
hand-written Hopper kernel `csrc/coattn_fwd.cu` (forward only; the backward
kernels come with the training slice).

Storage types of x: f32, bf16, or int8 with per-patch dequant scales
`x_scale` [B, N]; `x_inv` [B, N] optionally carries host-computed
1/||x_stored|| rows.  The plain version computes in f32 on the stored values,
as the kernel does.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .masked import l2_normalize, masked_softmax

MAX_QUERIES = 16
_TILE = 32  # patches per kernel tile (kTile in csrc/coattn_fwd.cu)
_STORAGE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_STORAGE_NAME = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "int8"}

# Launches of the CUDA kernel, one per call of `coattn_fwd`, by variant
# ("f32", "f32_inv", "bf16", "bf16_inv", "int8", "int8_inv").
LAUNCHES = {f"{s}{i}": 0 for s in ("f32", "bf16", "int8") for i in ("", "_inv")}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def variant_name(x_dtype: torch.dtype, host_inv: bool) -> str:
    return _STORAGE_NAME[x_dtype] + ("_inv" if host_inv else "")


def dequantize_feats(x: torch.Tensor, x_scale: Optional[torch.Tensor]) -> torch.Tensor:
    """Undo per-patch symmetric int8 quantization: x [.., N, C] int8,
    x_scale [.., N] f32 -> f32 features."""
    if x_scale is None:
        return x
    return x.to(torch.float32) * x_scale[..., None]


def _logits_reference(q, x, scale, x_scale):
    x = dequantize_feats(x, x_scale).to(torch.float32)
    xn = l2_normalize(x, dim=-1)
    return scale * torch.einsum("pc,bnc->bpn", q.to(torch.float32), xn), x


def coattn_pool_reference(q: torch.Tensor, x: torch.Tensor,
                          mask: Optional[torch.Tensor], scale,
                          x_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: q [P, C], x [B, N, C], mask [B, N] -> out [B, P, C] f32."""
    logits, xf = _logits_reference(q, x, scale, x_scale)
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


def split_plan(B: int, N: int, n_sm: int) -> Tuple[int, int]:
    """(chunk, S): the patch axis of each bag is cut into S chunks of `chunk`
    patches (a multiple of the tile), one block each, so that B*S blocks
    fill about two waves of the card's SMs even when B is small."""
    tiles = max(1, -(-N // _TILE))
    S = max(1, min(tiles, -(-2 * n_sm // B)))
    chunk = -(-tiles // S) * _TILE
    return chunk, max(1, -(-N // chunk))


def _library():
    from ._build import load
    lib = load("coattn_fwd")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.coattn_fwd.argtypes = [p, p, p, p, p, ctypes.c_float, i, i, i, i,
                                   i, i, i, i, p, p, p, p, p, p, p]
        lib.coattn_fwd.restype = ctypes.c_int
        lib.coattn_fwd_smem_bytes.argtypes = [i, i, i]
        lib.coattn_fwd_smem_bytes.restype = ctypes.c_size_t
        lib._argtypes_set = True
    return lib


def _check_row(name, t, B, N, device):
    if t is None:
        return
    if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != (B, N) \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous f32 [{B}, {N}] tensor on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def coattn_fwd(q: torch.Tensor, x: torch.Tensor, mask: torch.Tensor, scale: float,
               x_scale: Optional[torch.Tensor] = None,
               x_inv: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the Hopper kernel on CUDA tensors.  Returns (out [B, P, C],
    m [B, P], l [B, P]) f32: the pooled features and the softmax stats
    (running max and normaliser, l clamped below at 1e-30)."""
    if x.device.type != "cuda":
        raise ValueError(f"coattn_fwd launches a CUDA kernel; x is on {x.device}")
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
            or q.shape[1] != C or not 1 <= q.shape[0] <= MAX_QUERIES:
        raise ValueError(f"q must be an f32 [P<={MAX_QUERIES}, {C}] tensor on {device}, "
                         f"got {q.dtype} {tuple(q.shape)} on {q.device}")
    if mask.device != device or mask.dtype != torch.bool \
            or tuple(mask.shape) != (B, N) or not mask.is_contiguous():
        raise ValueError(f"mask must be a contiguous bool [{B}, {N}] tensor on {device}")
    if (x.dtype == torch.int8) != (x_scale is not None):
        raise ValueError("x_scale is required for int8 x and taken for no other type")
    _check_row("x_scale", x_scale, B, N, device)
    _check_row("x_inv", x_inv, B, N, device)
    q = q.contiguous()
    P = q.shape[0]

    lib = _library()
    storage = _STORAGE[x.dtype]
    props = torch.cuda.get_device_properties(device)
    smem = lib.coattn_fwd_smem_bytes(P, C, storage)
    if smem > props.shared_memory_per_block_optin:
        raise ValueError(f"C={C}, P={P} needs {smem} bytes of shared memory per "
                         f"block, the card gives {props.shared_memory_per_block_optin}")
    chunk, S = split_plan(B, N, props.multi_processor_count)

    f32 = dict(dtype=torch.float32, device=device)
    out = torch.empty(B, P, C, **f32)
    m = torch.empty(B, P, **f32)
    l = torch.empty(B, P, **f32)
    ws_m = torch.empty(B, S, P, **f32)
    ws_l = torch.empty(B, S, P, **f32)
    ws_acc = torch.empty(B, S, P, C, **f32)

    def ptr(t):
        return None if t is None else t.data_ptr()

    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.coattn_fwd(ptr(q), ptr(x), ptr(x_scale), ptr(x_inv), ptr(mask),
                         float(scale), B, N, C, P, chunk, S, storage,
                         device.index if device.index is not None else torch.cuda.current_device(),
                         ptr(ws_m), ptr(ws_l), ptr(ws_acc), ptr(out), ptr(m), ptr(l),
                         stream)
    if err != 0:
        raise RuntimeError(f"coattn_fwd kernel launch failed: cudaError {err}")
    LAUNCHES[variant_name(x.dtype, x_inv is not None)] += 1
    return out, m, l


def coattn_pool(q: torch.Tensor, x: torch.Tensor, mask: Optional[torch.Tensor],
                scale, x_scale: Optional[torch.Tensor] = None,
                x_inv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked co-attention pooling: q [P, C] effective queries (normalised),
    x [B, N, C] raw patch features, mask [B, N] -> [B, P, C] f32.

    CPU tensors take the plain version (which ignores `x_inv`: it normalises
    the rows itself); CUDA tensors launch the kernel.  The kernel is a
    forward only, so on CUDA a call that needs a gradient for q raises."""
    if x.dtype == torch.int8 and x_scale is None:
        raise ValueError("int8 features need x_scale [B, N]")
    if mask is None:
        mask = torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
    if x.device.type == "cpu":
        return coattn_pool_reference(q, x, mask, scale, x_scale=x_scale)
    if x.device.type != "cuda":
        raise ValueError(f"coattn_pool runs on cpu or cuda, not {x.device}")
    if torch.is_grad_enabled() and q.requires_grad:
        raise NotImplementedError(
            "coattn_pool on CUDA is forward-only: its gradient needs the port of "
            "the dQ backward kernel (vlsa_tpu/ops/coattn.py::_coattn_bwd_dq_body), "
            "which comes with the training slice; serve under torch.inference_mode()")
    out, _m, _l = coattn_fwd(q, x, mask.contiguous(), float(scale),
                             x_scale=x_scale, x_inv=x_inv)
    return out
