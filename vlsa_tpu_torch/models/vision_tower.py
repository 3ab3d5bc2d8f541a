"""The CONCH (CoCa) visual model: a timm ViT-B/16 trunk and attentional
poolers (counterpart of the CONCH part of vlsa_tpu/models/vision_tower.py,
`:352-601` and `:604-692`).

Modules and parameters carry the JAX tree's names (`trunk.block_0.qkv_weight`,
`attn_pool_contrast.ln_k.weight`, ...), so `utils.weights.state_dict_from_jax`
maps a vlsa_tpu parameter tree one to one and it loads with `strict=True`.
Weights keep the torch layout ([out, in]); `proj_contrast` is [in, out] and
applied as `x @ proj`.

The trunk's linears and the patch embedding take operands in the compute
type and give an f32 result, as JAX's `preferred_element_type=f32` does: on
the card one cuBLAS product with bf16 operands and f32 output
(`torch.mm(..., out_dtype=torch.float32)`), on the CPU an f32 product of
operands rounded to the compute type (exact products, f32 sums).  The
trunk's attention goes through `ops.flash_attn.flash_self_attention`: the
Hopper kernel for every L on a CUDA tensor, the plain version on a CPU
tensor.  The poolers compute in f32 (TF32 off, `utils.device.disable_tf32`).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attn import flash_self_attention

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def as_dtype(dtype) -> torch.dtype:
    return _DTYPES[dtype] if isinstance(dtype, str) else dtype


def _param(shape, std: float, generator: Optional[torch.Generator]) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape).normal_(0.0, std, generator=generator))


def linear_f32(h: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """h @ w.T with both operands in `dtype` and an f32 result."""
    if dtype == torch.float32:
        return h.float() @ w.float().T
    if h.device.type == "cuda":
        h2 = h.reshape(-1, h.shape[-1]).to(dtype)
        out = torch.mm(h2, w.to(dtype).T, out_dtype=torch.float32)
        return out.reshape(*h.shape[:-1], w.shape[0])
    return h.to(dtype).float() @ w.to(dtype).float().T


class TimmViTBlock(nn.Module):
    """timm vision_transformer.Block: pre-LN (eps 1e-6), fused qkv, exact-erf
    GELU MLP.  `residual_dtype` is the type the residual stream is carried
    in (f32, or bf16 to halve its bytes); LayerNorm statistics, linear sums
    and biases stay f32 either way."""

    def __init__(self, width: int, heads: int, mlp_ratio: float = 4.0,
                 compute_dtype="float32", residual_dtype="float32",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        D, hid = width, int(width * mlp_ratio)
        self.heads = heads
        self.compute_dtype = as_dtype(compute_dtype)
        self.residual_dtype = as_dtype(residual_dtype)
        self.norm1 = nn.LayerNorm(D, eps=1e-6)
        self.qkv_weight = _param((3 * D, D), D ** -0.5, generator)
        self.qkv_bias = nn.Parameter(torch.zeros(3 * D))
        self.proj_weight = _param((D, D), D ** -0.5, generator)
        self.proj_bias = nn.Parameter(torch.zeros(D))
        self.norm2 = nn.LayerNorm(D, eps=1e-6)
        self.fc1_weight = _param((hid, D), D ** -0.5, generator)
        self.fc1_bias = nn.Parameter(torch.zeros(hid))
        self.fc2_weight = _param((D, hid), hid ** -0.5, generator)
        self.fc2_bias = nn.Parameter(torch.zeros(D))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, L, D = x.shape
        H, cdt = self.heads, self.compute_dtype
        h = self.norm1(x.float())
        qkv = linear_f32(h, self.qkv_weight, cdt) + self.qkv_bias

        def heads(t):
            return t.reshape(B, L, H, D // H).transpose(1, 2).to(cdt).contiguous()

        q, k, v = (heads(t) for t in qkv.split(D, dim=-1))
        del qkv
        ctx = flash_self_attention(q, k, v).transpose(1, 2).reshape(B, L, D)
        x = x + (linear_f32(ctx, self.proj_weight, cdt) + self.proj_bias).to(self.residual_dtype)
        h = self.norm2(x.float())
        hid = F.gelu(linear_f32(h, self.fc1_weight, cdt) + self.fc1_bias)
        return x + (linear_f32(hid, self.fc2_weight, cdt) + self.fc2_bias).to(self.residual_dtype)


class TimmViTTrunk(nn.Module):
    """The timm 'vit_base' trunk of CONCH: all tokens out, cls included."""

    def __init__(self, image_size: int = 448, patch_size: int = 16, width: int = 768,
                 layers: int = 12, heads: int = 12, compute_dtype="float32",
                 residual_dtype="float32", generator: Optional[torch.Generator] = None):
        super().__init__()
        D, P = width, patch_size
        self.patch_size = patch_size
        self.grid = image_size // patch_size
        self.compute_dtype = as_dtype(compute_dtype)
        self.residual_dtype = as_dtype(residual_dtype)
        self.patch_embed_weight = _param((D, 3, P, P), (3 * P * P) ** -0.5, generator)
        self.patch_embed_bias = nn.Parameter(torch.zeros(D))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        self.pos_embed = _param((1, self.grid ** 2 + 1, D), 0.02, generator)
        self.layers = layers
        for i in range(layers):
            self.add_module(f"block_{i}", TimmViTBlock(
                D, heads, compute_dtype=compute_dtype, residual_dtype=residual_dtype,
                generator=generator))
        self.norm = nn.LayerNorm(D, eps=1e-6)

    def blocks(self):
        return [getattr(self, f"block_{i}") for i in range(self.layers)]

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images f32 [B, 3, S, S] -> tokens f32 [B, 1 + (S/P)^2, width]."""
        B = images.shape[0]
        P, g = self.patch_size, self.grid
        # the stride-P convolution as a per-patch product in the compute type
        # with f32 sums; patches flattened as (channel, row, column), the
        # weight's OIHW order
        x = images[:, :, :g * P, :g * P].to(self.compute_dtype)
        x = x.reshape(B, 3, g, P, g, P).permute(0, 2, 4, 1, 3, 5).reshape(B, g * g, 3 * P * P)
        w = self.patch_embed_weight.reshape(self.patch_embed_weight.shape[0], -1)
        x = linear_f32(x, w, self.compute_dtype) + self.patch_embed_bias
        D = x.shape[-1]
        x = torch.cat([self.cls_token.float().expand(B, 1, D), x], dim=1)
        x = (x + self.pos_embed).to(self.residual_dtype)
        for blk in self.blocks():
            x = blk(x)
        return self.norm(x.float())


class AttentionalPooler(nn.Module):
    """Learned queries cross-attend the LayerNormed context (torch
    MultiheadAttention with kdim = vdim = context_dim: separate q/k/v
    projections), in f32, LayerNorm eps 1e-5."""

    def __init__(self, d_model: int, context_dim: int, n_head: int = 8, n_queries: int = 256,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        Dm, Dc = d_model, context_dim
        self.n_head = n_head
        self.query = _param((n_queries, Dm), 1.0, generator)
        self.ln_k = nn.LayerNorm(Dc, eps=1e-5)
        self.ln_q = nn.LayerNorm(Dm, eps=1e-5)
        self.q_proj_weight = _param((Dm, Dm), Dm ** -0.5, generator)
        self.k_proj_weight = _param((Dm, Dc), Dc ** -0.5, generator)
        self.v_proj_weight = _param((Dm, Dc), Dc ** -0.5, generator)
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * Dm))
        self.out_proj_weight = _param((Dm, Dm), Dm ** -0.5, generator)
        self.out_proj_bias = nn.Parameter(torch.zeros(Dm))

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, N, context_dim], key_mask [B, N] (True = valid) -> [B, Q, d_model]."""
        B = x.shape[0]
        Q, Dm = self.query.shape
        H = self.n_head
        hd = Dm // H
        x = self.ln_k(x.float())
        b = self.in_proj_bias
        q = (self.ln_q(self.query) @ self.q_proj_weight.T + b[:Dm]).reshape(Q, H, hd).transpose(0, 1)
        k = (x @ self.k_proj_weight.T + b[Dm:2 * Dm]).reshape(B, -1, H, hd).transpose(1, 2)
        v = (x @ self.v_proj_weight.T + b[2 * Dm:]).reshape(B, -1, H, hd).transpose(1, 2)
        logits = torch.einsum("hqd,bhkd->bhqk", q, k) / math.sqrt(hd)
        if key_mask is not None:
            logits = torch.where(key_mask[:, None, None, :], logits, -1e30)
        ctx = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, dim=-1), v)
        return ctx.transpose(1, 2).reshape(B, Q, Dm) @ self.out_proj_weight.T + self.out_proj_bias


class ConchVisualModel(nn.Module):
    """CONCH's visual model with the conch_ViT-B-16 config: the trunk, an
    attentional contrast pool (1 query) and a caption pool (256 queries)."""

    def __init__(self, embed_dim_contrast: int = 512, embed_dim_caption: int = 768,
                 image_size: int = 448, patch_size: int = 16, width: int = 768,
                 layers: int = 12, heads: int = 12, attn_pooler_heads: int = 8,
                 n_queries_contrast: int = 1, n_queries_caption: int = 256,
                 output_tokens: bool = True, compute_dtype="float32",
                 trunk_residual_dtype="float32", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embed_dim_contrast = embed_dim_contrast
        self.output_tokens = output_tokens
        self.trunk = TimmViTTrunk(image_size, patch_size, width, layers, heads,
                                  compute_dtype, trunk_residual_dtype, generator)
        self.attn_pool_contrast = AttentionalPooler(embed_dim_contrast, width, attn_pooler_heads,
                                                    n_queries_contrast, generator)
        self.ln_contrast = nn.LayerNorm(embed_dim_contrast, eps=1e-5)
        self.proj_contrast = _param((embed_dim_contrast, embed_dim_contrast), width ** -0.5,
                                    generator)
        self.attn_pool_caption = AttentionalPooler(embed_dim_caption, width, attn_pooler_heads,
                                                   n_queries_caption, generator)
        self.ln_caption = nn.LayerNorm(embed_dim_caption, eps=1e-5)

    def forward(self, images: torch.Tensor):
        tokens = self.trunk(images)
        pooled = self.attn_pool_contrast(tokens)[:, 0]
        pooled = self.ln_contrast(pooled) @ self.proj_contrast
        cap = self.ln_caption(self.attn_pool_caption(tokens))
        return (pooled, cap) if self.output_tokens else pooled

    def forward_no_head(self, images: torch.Tensor, normalize: bool = False) -> torch.Tensor:
        """The MIL feature convention: the LayerNormed contrast pool,
        unprojected, [B, embed_dim_contrast]."""
        pooled = self.ln_contrast(self.attn_pool_contrast(self.trunk(images))[:, 0])
        if normalize:
            pooled = pooled / pooled.norm(dim=-1, keepdim=True)
        return pooled


# ---------------------------------------------------------------------------
# Checkpoint import (counterpart of import_conch_visual_state)
# ---------------------------------------------------------------------------

def _bilinear_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Dense [out, in] bilinear interpolation matrix with torch
    F.interpolate(..., mode='bilinear', align_corners=False, antialias=False)
    semantics: src = (dst + 0.5) * in/out - 0.5, negative clamped to 0."""
    c = (np.arange(out_size) + 0.5) * (in_size / out_size) - 0.5
    c = np.maximum(c, 0.0)
    i0 = np.floor(c).astype(np.int64)
    frac = c - i0
    i0 = np.clip(i0, 0, in_size - 1)
    i1 = np.clip(i0 + 1, 0, in_size - 1)
    M = np.zeros((out_size, in_size), np.float64)
    np.add.at(M, (np.arange(out_size), i0), 1.0 - frac)
    np.add.at(M, (np.arange(out_size), i1), frac)
    return M


def resize_pos_embed(pos_embed: np.ndarray, new_grid: Tuple[int, int],
                     num_prefix_tokens: int = 1) -> np.ndarray:
    """timm `resample_abs_pos_embed` (bilinear, antialias=False,
    align_corners=False) of a [1, prefix + g*g, C] table to `new_grid`: the
    released 224-trained CONCH weights load into a 448-input model so."""
    pos_embed = np.asarray(pos_embed, np.float32)
    if pos_embed.ndim != 3 or pos_embed.shape[0] != 1:
        raise ValueError(f"expected a [1, prefix + g*g, C] table, got {pos_embed.shape}")
    prefix = pos_embed[:, :num_prefix_tokens]
    grid = pos_embed[0, num_prefix_tokens:]
    g_old = int(round(np.sqrt(grid.shape[0])))
    if g_old * g_old != grid.shape[0]:
        raise ValueError("non-square pos-embed grid")
    gh, gw = new_grid
    if (g_old, g_old) == (gh, gw):
        return pos_embed
    x = grid.reshape(g_old, g_old, -1).astype(np.float64)  # [H, W, C]
    x = np.einsum("oh,hwc->owc", _bilinear_matrix(g_old, gh), x)
    x = np.einsum("ow,hwc->hoc", _bilinear_matrix(g_old, gw), x)
    out = x.reshape(1, gh * gw, -1).astype(np.float32)
    return np.concatenate([prefix, out], axis=1)


def _pooler_state(g, prefix: str, out: str) -> dict:
    sd = {f"{out}.query": g(prefix + "query")}
    for ln in ("ln_q", "ln_k"):
        for p in ("weight", "bias"):
            sd[f"{out}.{ln}.{p}"] = g(f"{prefix}{ln}.{p}")
    sd[f"{out}.in_proj_bias"] = g(prefix + "attn.in_proj_bias")
    sd[f"{out}.out_proj_weight"] = g(prefix + "attn.out_proj.weight")
    sd[f"{out}.out_proj_bias"] = g(prefix + "attn.out_proj.bias")
    try:  # kdim == embed_dim: torch MHA fuses the three projections
        W = g(prefix + "attn.in_proj_weight")
    except KeyError:
        for p in ("q", "k", "v"):
            sd[f"{out}.{p}_proj_weight"] = g(f"{prefix}attn.{p}_proj_weight")
    else:
        D = W.shape[0] // 3
        for i, p in enumerate(("q", "k", "v")):
            sd[f"{out}.{p}_proj_weight"] = W[i * D:(i + 1) * D]
    return sd


def load_conch_visual_state(state: dict, layers: int = 12, prefix: str = "visual.",
                            image_size: int = 448, patch_size: int = 16) -> dict:
    """A CONCH checkpoint's `visual.*` tensors (torch or numpy) -> this
    package's `ConchVisualModel` state dict, f32.  The positional table is
    resized to the target grid when the checkpoint was trained at another
    resolution (the released weights are 224-trained; CONCH runs at 448)."""
    def g(k):
        return np.asarray(state[prefix + k], np.float32)

    grid = image_size // patch_size
    sd = {
        "trunk.patch_embed_weight": g("trunk.patch_embed.proj.weight"),
        "trunk.patch_embed_bias": g("trunk.patch_embed.proj.bias"),
        "trunk.cls_token": g("trunk.cls_token"),
        "trunk.pos_embed": resize_pos_embed(g("trunk.pos_embed"), (grid, grid)),
        "trunk.norm.weight": g("trunk.norm.weight"),
        "trunk.norm.bias": g("trunk.norm.bias"),
    }
    names = {"norm1.weight": "norm1.weight", "norm1.bias": "norm1.bias",
             "norm2.weight": "norm2.weight", "norm2.bias": "norm2.bias",
             "qkv_weight": "attn.qkv.weight", "qkv_bias": "attn.qkv.bias",
             "proj_weight": "attn.proj.weight", "proj_bias": "attn.proj.bias",
             "fc1_weight": "mlp.fc1.weight", "fc1_bias": "mlp.fc1.bias",
             "fc2_weight": "mlp.fc2.weight", "fc2_bias": "mlp.fc2.bias"}
    for i in range(layers):
        for ours, theirs in names.items():
            sd[f"trunk.block_{i}.{ours}"] = g(f"trunk.blocks.{i}.{theirs}")
    sd.update(_pooler_state(g, "attn_pool_contrast.", "attn_pool_contrast"))
    sd.update(_pooler_state(g, "attn_pool_caption.", "attn_pool_caption"))
    for ln in ("ln_contrast", "ln_caption"):
        sd[f"{ln}.weight"] = g(f"{ln}.weight")
        sd[f"{ln}.bias"] = g(f"{ln}.bias")
    sd["proj_contrast"] = g("proj_contrast")
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}

