"""Non-causal self-attention of the ViT trunk -- the kernel of feature
extraction (counterpart of vlsa_tpu/models/vision_tower.py:312
`_flash_self_attention`, which reaches JAX's library Pallas TPU
`flash_attention`).

`flash_self_attention` is the entry point, in the JAX layout [B, H, L, hd]:
a CPU tensor goes through the plain version, a CUDA tensor through the
hand-written Hopper kernel `csrc/flash_attn_fwd.cu` (bf16 on the tensor
cores, f32 on the CUDA cores) or raises `FlashKernelError`; there is no
fallback.  bf16 has two paths.  `flash_plan(L)` sends every L to `streamed`
(two sweeps on wgmma over 64-key tiles that TMA streams through shared
memory): on an H100 it beat `resident` (K and V of a head held in shared
memory, one sweep, L <= 800) at CONCH's 448 px (L = 785) and ViT-B/16's
224 px (L = 197) alike, and it alone takes CONCH at 512 px (L = 1025).  The
resident path stays reachable through `flash_attn_fwd(..., _force_path=
"resident")`, for the checks that hold and time it.

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
import functools

import torch

from .coattn import _device_index, _ptr
from .flags import kernels_disabled

HD_KERNEL = 64  # the head dimension the kernels are built for (CONCH, CLIP ViT-B)
_DTYPE = {torch.float32: 0, torch.bfloat16: 1}
_DTYPE_NAME = {torch.float32: "f32", torch.bfloat16: "bf16"}

# Launches of the CUDA kernel by variant, one per call of `flash_attn_fwd`,
# and the bf16 launches by path.
LAUNCHES = {"f32": 0, "bf16": 0}
LAUNCHES_PATH = {"resident": 0, "streamed": 0}

# The resident bf16 kernel (csrc/flash_attn_fwd.cu): the warps that share a
# query stripe's keys, its template instances (16-key chunks per warp, so an
# instance covers L <= 16 * RESIDENT_WARPS * chunks) and its capacity, set
# by shared memory: K and V of 800 keys (800 * 256 B) + 24,576 B of partial
# O + 1,024 B of row statistics = 230,400 of the 232,448 B a block may use
# on an H100.
RESIDENT_WARPS = 4
RESIDENT_CHUNKS = (2, 4, 7, 10, 13)
RESIDENT_CAPACITY = 800
SMEM_PER_BLOCK = 232448
_RESIDENT_FIXED_SMEM = 4 * (2 * (RESIDENT_WARPS - 1) * 16 * 64 + 2 * 2 * RESIDENT_WARPS * 16)
# The streamed bf16 kernel: query rows a block (one warpgroup), keys a
# stage, the ring's stages and its shared memory (a K and a V tile of 64 x
# 128 B a stage, an 8-byte mbarrier a stage, 1,024 B of alignment).
STREAMED_ROWS = 64
STREAMED_TILE_K = 64
STREAMED_STAGES = 3
STREAMED_SMEM = STREAMED_STAGES * (2 * STREAMED_TILE_K * 128 + 8) + 1024
_PATH = {"resident": 0, "streamed": 1}


class FlashKernelError(RuntimeError):
    """The flash kernel did not launch (a refused configuration, a failed
    build or launch); the call never falls back to another path."""


def reset_launches() -> None:
    for counts in (LAUNCHES, LAUNCHES_PATH):
        for k in counts:
            counts[k] = 0


def flash_plan(L: int) -> tuple:
    """The bf16 path for length L, from L alone: ("streamed", 0, its shared
    bytes per block) for every L >= 1."""
    if L < 1:
        raise ValueError(f"L must be >= 1, got {L}")
    return "streamed", 0, STREAMED_SMEM


def resident_plan(L: int) -> tuple:
    """The resident path at L <= RESIDENT_CAPACITY, which only
    `_force_path` takes: ("resident", chunks per warp, shared bytes per
    block); above the capacity ("resident", 0, the bytes it would need),
    which the kernel refuses."""
    if L < 1:
        raise ValueError(f"L must be >= 1, got {L}")
    keys = -(-L // 16) * 16
    chunks = next((c for c in RESIDENT_CHUNKS if 16 * RESIDENT_WARPS * c >= L), 0)
    return "resident", chunks if keys <= RESIDENT_CAPACITY else 0, \
        keys * 2 * 64 * 2 + _RESIDENT_FIXED_SMEM


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
        # q, k, v, out; BH, L; scale; dtype, path, chunks, device; stream
        lib.flash_attn_fwd.argtypes = [P] * 4 + [I, I, ctypes.c_float, I, I, I, I, P]
        lib.flash_attn_fwd.restype = I
        lib.flash_attn_fwd_smem_bytes.argtypes = [I, I, I]
        lib.flash_attn_fwd_smem_bytes.restype = ctypes.c_size_t
        lib._argtypes_set = True
    return lib


@functools.lru_cache(maxsize=None)
def _smem_optin(device: int) -> int:
    """Shared memory a block may opt into on CUDA device `device` (asked
    once: the query costs more host time than a short launch)."""
    return torch.cuda.get_device_properties(device).shared_memory_per_block_optin


def flash_attn_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   _force_path: str | None = None) -> torch.Tensor:
    """Launch the Hopper kernel on CUDA tensors q, k, v [B, H, L, 64], all
    f32 or all bf16, contiguous -> f32 [B, H, L, 64].  bf16 takes the path
    of `flash_plan(L)`; `_force_path` is a private hook for the checks that
    hold one path at a length the plan gives the other (no entry point
    passes it).  Raises FlashKernelError when the kernel does not launch."""
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
    path, chunks = None, 0
    if q.dtype == torch.bfloat16:
        path, chunks, _smem = (resident_plan if _force_path == "resident" else flash_plan)(L)
        if _force_path is not None:
            path = _force_path
    try:
        lib = _library()
    except RuntimeError as exc:  # nvcc failed: raised as the kernel's error, no other path
        raise FlashKernelError(f"flash_attn_fwd.cu did not build: {exc}") from exc
    dtype = _DTYPE[q.dtype]
    path_id = _PATH.get(path, -1) if path is not None else 0
    smem = lib.flash_attn_fwd_smem_bytes(dtype, path_id, L)
    optin = _smem_optin(_device_index(q.device))
    if smem > optin:
        raise FlashKernelError(f"flash_attn_fwd needs {smem} bytes of shared memory per block, "
                               f"the card gives {optin}")
    out = torch.empty(B, H, L, hd, dtype=torch.float32, device=q.device)
    err = lib.flash_attn_fwd(_ptr(q), _ptr(k), _ptr(v), _ptr(out), B * H, L, 1.0 / hd ** 0.5,
                             dtype, path_id, chunks, _device_index(q.device),
                             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise FlashKernelError(f"flash_attn_fwd[{_DTYPE_NAME[q.dtype]}"
                               f"{'' if path is None else ', ' + path}] at L={L} did not "
                               f"launch: cudaError {err}")
    LAUNCHES[_DTYPE_NAME[q.dtype]] += 1
    if path is not None:
        LAUNCHES_PATH[path] += 1
    return out


def flash_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd)) v over [B, H, L, hd] -> f32 [B, H, L, hd].

    CPU tensors take the plain version, as CUDA tensors do, on the card,
    inside `ops.flags.disable_kernels()`; otherwise CUDA tensors launch the
    kernel for every L (the JAX rule "TPU and L >= 256" is a TPU speed
    heuristic, not semantics) and raise for what it does not take (hd != 64,
    mixed types)."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_self_attention runs on cpu or cuda, not {q.device}")
    if q.device.type == "cpu" or kernels_disabled():
        return flash_self_attention_reference(q, k, v)
    return flash_attn_fwd(q, k, v)
