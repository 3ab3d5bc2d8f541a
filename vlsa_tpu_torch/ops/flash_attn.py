"""Non-causal self-attention of the ViT trunk -- the kernel of feature
extraction (counterpart of vlsa_tpu/models/vision_tower.py:312
`_flash_self_attention`, which reaches JAX's library Pallas TPU
`flash_attention`).

`flash_self_attention` is the entry point, in the JAX layout [B, H, L, hd]:
a CPU tensor goes through the plain version, a CUDA tensor through the
hand-written Hopper kernel `csrc/flash_attn_fwd.cu` (bf16 on the tensor
cores, f32 on the CUDA cores) or raises; there is no fallback.

Rounding follows the TPU kernel at the trunk's block sizes (the whole padded
sequence in one key block, so `_flash_attention_kernel_single_batch_single_
step` runs): f32 logits of the operands in their type, scaled by hd^-0.5,
P = exp(S - max) / l normalised in f32 and rounded to V's type, P V summed
in f32.  The result is f32 where the TPU kernel rounds it to q's type: the
trunk rounds it to its compute type at the proj linear either way, so the
block's result is the same.
"""
from __future__ import annotations

import ctypes

import torch

from .coattn import _device_index, _ptr

HD_KERNEL = 64  # the head dimension the kernels are built for (CONCH, CLIP ViT-B)
_DTYPE = {torch.float32: 0, torch.bfloat16: 1}
_DTYPE_NAME = {torch.float32: "f32", torch.bfloat16: "bf16"}

# Launches of the CUDA kernel by variant, one per call of `flash_attn_fwd`.
LAUNCHES = {"f32": 0, "bf16": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def flash_self_attention_reference(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor) -> torch.Tensor:
    """The plain version: q, k, v [B, H, L, hd] (f32 or bf16) -> f32
    [B, H, L, hd], rounding as the TPU kernel does.  It materialises the
    [B, H, L, L] f32 logits (1.9 GB at B=64, H=12, L=785)."""
    s = (q.float() @ k.float().transpose(-1, -2)) * (1.0 / q.shape[-1] ** 0.5)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    return p.to(v.dtype).float() @ v.float()


def _library():
    from ._build import load
    lib = load("flash_attn_fwd")
    if not getattr(lib, "_argtypes_set", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        # q, k, v, out; BH, L; scale; dtype, device; stream
        lib.flash_attn_fwd.argtypes = [P] * 4 + [I, I, ctypes.c_float, I, I, P]
        lib.flash_attn_fwd.restype = I
        lib.flash_attn_fwd_smem_bytes.argtypes = [I]
        lib.flash_attn_fwd_smem_bytes.restype = ctypes.c_size_t
        lib._argtypes_set = True
    return lib


def flash_attn_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Launch the Hopper kernel on CUDA tensors q, k, v [B, H, L, 64], all
    f32 or all bf16, contiguous -> f32 [B, H, L, 64]."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attn_fwd launches a CUDA kernel; q is on {q.device}")
    if q.dtype not in _DTYPE:
        raise ValueError(f"q, k, v must be f32 or bf16, got {q.dtype}")
    if q.dim() != 4 or q.shape[-1] != HD_KERNEL or q.shape[2] < 1:
        raise ValueError(f"q must be [B, H, L>=1, {HD_KERNEL}], got {tuple(q.shape)}: the "
                         f"kernel is built for hd={HD_KERNEL}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype or t.shape != q.shape \
                or not t.is_contiguous() or t.data_ptr() % 16 != 0:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned {q.dtype} "
                             f"{list(q.shape)} tensor on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    B, H, L, hd = q.shape
    lib = _library()
    smem = lib.flash_attn_fwd_smem_bytes(_DTYPE[q.dtype])
    optin = torch.cuda.get_device_properties(q.device).shared_memory_per_block_optin
    if smem > optin:
        raise ValueError(f"flash_attn_fwd needs {smem} bytes of shared memory per block, "
                         f"the card gives {optin}")
    out = torch.empty(B, H, L, hd, dtype=torch.float32, device=q.device)
    err = lib.flash_attn_fwd(_ptr(q), _ptr(k), _ptr(v), _ptr(out), B * H, L, 1.0 / hd ** 0.5,
                             _DTYPE[q.dtype], _device_index(q.device),
                             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd kernel launch failed: cudaError {err}")
    LAUNCHES[_DTYPE_NAME[q.dtype]] += 1
    return out


def flash_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd)) v over [B, H, L, hd] -> f32 [B, H, L, hd].

    CPU tensors take the plain version; CUDA tensors launch the kernel for
    every L (the JAX rule "TPU and L >= 256" is a TPU speed heuristic, not
    semantics) and raise for what it does not take (hd != 64, mixed types)."""
    if q.device.type == "cpu":
        return flash_self_attention_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_self_attention runs on cpu or cuda, not {q.device}")
    return flash_attn_fwd(q, k, v)
