"""The vision towers (counterpart of vlsa_tpu/models/vision_tower.py):

  * `ConchVisualModel` -- CONCH (CoCa): a timm ViT-B/16 trunk and attentional
    poolers (`:352-601`, `:604-692`), its trunk's four linears optionally
    w8a8 (`trunk_quantized`);
  * `CLIPViT` -- OpenAI CLIP's VisionTransformer (`:42-121`);
  * `CLIPModifiedResNet` -- OpenAI CLIP's ModifiedResNet with inference
    BatchNorm and attention pooling (`:129-294`), f32 only.

Modules and parameters carry the JAX tree's names (`trunk.block_0.qkv_weight`,
`attn_pool_contrast.ln_k.weight`, `layer1_0.bn1.running_mean`, ...), so
`utils.weights.state_dict_from_jax` maps a vlsa_tpu parameter tree one to one
and it loads with `strict=True`.  Weights keep the torch layout ([out, in]);
`proj_contrast` and CLIPViT's `proj` are [in, out] and applied as `x @ proj`.

The trunk's linears and the patch embedding take operands in the compute
type and give an f32 result, as JAX's `preferred_element_type=f32` does: on
the card one cuBLAS product with bf16 operands and f32 output
(`torch.mm(..., out_dtype=torch.float32)`), on the CPU an f32 product of
operands rounded to the compute type (exact products, f32 sums).  The
trunk's attention goes through `ops.flash_attn.flash_self_attention`: the
Hopper kernel for every L on a CUDA tensor, the plain version on a CPU
tensor.  The poolers compute in f32 (TF32 off, `utils.device.disable_tf32`).

The w8a8 trunk (`TimmViTBlock(quantized=True)`) keeps its linears' weights
as int8 buffers with f32 per-row scales (`models/precision.py::
quantize_vision_tower_weights`) and quantizes each token's activations on
the fly (`int8_dynamic_linear`, an s8 x s8 -> s32 product by
`torch._int_mm`); attention stays on the flash kernel.  CLIPViT's blocks are
the text tower's `ResidualAttentionBlock` (QuickGELU, plain attention, as
vlsa_tpu's einsum attention there); its stem convolution runs in f32.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attn import flash_self_attention
from .text_encoder import ResidualAttentionBlock

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


_INT_MM_MIN_ROWS = 17  # torch._int_mm on CUDA takes more than 16 rows


def int8_dynamic_linear(h: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor) -> torch.Tensor:
    """w8a8 h @ w.T: h f32 [..., in] quantized per token (s_h = max|h| / 127,
    symmetric, ties to even), w_q int8 [out, in] with per-row scales w_s f32
    [out] (`precision.quantize_rows`); the s8 x s8 product sums exactly in
    int32 (`torch._int_mm`, cuBLAS on the card), then acc * (s_h * w_s) in
    f32 -- vlsa_tpu's `_int8_dynamic_linear` operation for operation, so the
    result is bit-equal to it on the same input, on the card as on the CPU
    (127 is a tensor filled on h's device: torch divides a CUDA tensor by a
    Python number as a product with its reciprocal).  No bias."""
    amax = h.abs().amax(dim=-1, keepdim=True)
    s_h = amax.clamp_min(1e-30) / amax.new_full((), 127.0)  # a true quotient on CUDA too
    h_q = torch.round(h / s_h).to(torch.int8).reshape(-1, h.shape[-1])
    m = h_q.shape[0]
    if m < _INT_MM_MIN_ROWS:
        h_q = torch.cat([h_q, h_q.new_zeros(_INT_MM_MIN_ROWS - m, h_q.shape[1])])
    acc = torch._int_mm(h_q, w_q.T)[:m].reshape(*h.shape[:-1], w_q.shape[0])
    return acc.float() * (s_h * w_s)


class TimmViTBlock(nn.Module):
    """timm vision_transformer.Block: pre-LN (eps 1e-6), fused qkv, exact-erf
    GELU MLP.  `residual_dtype` is the type the residual stream is carried
    in (f32, or bf16 to halve its bytes); LayerNorm statistics, linear sums
    and biases stay f32 either way.  `quantized` makes the four linears
    w8a8: `<name>_weight` an int8 buffer [out, in] beside `<name>_weight_scale`
    f32 [out] (loaded from `precision.quantize_vision_tower_weights`' state
    dict), their inputs quantized per token in f32."""

    def __init__(self, width: int, heads: int, mlp_ratio: float = 4.0,
                 compute_dtype="float32", residual_dtype="float32", quantized: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        D, hid = width, int(width * mlp_ratio)
        self.heads = heads
        self.compute_dtype = as_dtype(compute_dtype)
        self.residual_dtype = as_dtype(residual_dtype)
        self.quantized = quantized
        self.norm1 = nn.LayerNorm(D, eps=1e-6)
        self._linear_params("qkv", 3 * D, D, generator)
        self._linear_params("proj", D, D, generator)
        self.norm2 = nn.LayerNorm(D, eps=1e-6)
        self._linear_params("fc1", hid, D, generator)
        self._linear_params("fc2", D, hid, generator)

    def _linear_params(self, name: str, out_dim: int, in_dim: int, generator) -> None:
        if self.quantized:
            self.register_buffer(f"{name}_weight", torch.zeros(out_dim, in_dim, dtype=torch.int8))
            self.register_buffer(f"{name}_weight_scale", torch.ones(out_dim))
        else:
            setattr(self, f"{name}_weight", _param((out_dim, in_dim), in_dim ** -0.5, generator))
        setattr(self, f"{name}_bias", nn.Parameter(torch.zeros(out_dim)))

    def _linear(self, h: torch.Tensor, name: str) -> torch.Tensor:
        w = getattr(self, f"{name}_weight")
        if self.quantized:
            out = int8_dynamic_linear(h.float(), w, getattr(self, f"{name}_weight_scale"))
        else:
            out = linear_f32(h, w, self.compute_dtype)
        return out + getattr(self, f"{name}_bias")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, L, D = x.shape
        H, cdt = self.heads, self.compute_dtype
        qkv = self._linear(self.norm1(x.float()), "qkv")

        def heads(t):
            return t.reshape(B, L, H, D // H).transpose(1, 2).to(cdt).contiguous()

        q, k, v = (heads(t) for t in qkv.split(D, dim=-1))
        del qkv
        ctx = flash_self_attention(q, k, v).transpose(1, 2).reshape(B, L, D)
        x = x + self._linear(ctx, "proj").to(self.residual_dtype)
        hid = F.gelu(self._linear(self.norm2(x.float()), "fc1"))
        return x + self._linear(hid, "fc2").to(self.residual_dtype)


class TimmViTTrunk(nn.Module):
    """The timm 'vit_base' trunk of CONCH: all tokens out, cls included."""

    def __init__(self, image_size: int = 448, patch_size: int = 16, width: int = 768,
                 layers: int = 12, heads: int = 12, compute_dtype="float32",
                 residual_dtype="float32", quantized: bool = False,
                 generator: Optional[torch.Generator] = None):
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
                quantized=quantized, generator=generator))
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
                 trunk_residual_dtype="float32", trunk_quantized: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embed_dim_contrast = embed_dim_contrast
        self.output_tokens = output_tokens
        self.trunk = TimmViTTrunk(image_size, patch_size, width, layers, heads,
                                  compute_dtype, trunk_residual_dtype, trunk_quantized, generator)
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
# OpenAI CLIP: the ViT and the ModifiedResNet
# ---------------------------------------------------------------------------

class CLIPViT(nn.Module):
    """OpenAI CLIP's VisionTransformer: a stride-P f32 convolution (no bias),
    the class token and positional table, ln_pre, `layers` of the text
    tower's `ResidualAttentionBlock` with QuickGELU (its bf16 mode rounds
    the matmul operands and attention probabilities to bf16), ln_post on the
    class token, then `x @ proj` -> [B, output_dim]."""

    def __init__(self, input_resolution: int = 224, patch_size: int = 16, width: int = 768,
                 layers: int = 12, heads: int = 12, output_dim: int = 512,
                 compute_dtype="float32", generator: Optional[torch.Generator] = None):
        super().__init__()
        D, P = width, patch_size
        scale = D ** -0.5
        self.patch_size = patch_size
        self.layers = layers
        self.output_dim = output_dim
        self.conv1_weight = _param((D, 3, P, P), scale, generator)
        self.class_embedding = _param((D,), scale, generator)
        self.positional_embedding = _param(((input_resolution // P) ** 2 + 1, D), scale, generator)
        self.ln_pre = nn.LayerNorm(D, eps=1e-5)
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(D, heads, compute_dtype=as_dtype(compute_dtype),
                                   quick_gelu=True, generator=generator)
            for _ in range(layers))
        self.ln_post = nn.LayerNorm(D, eps=1e-5)
        self.proj = _param((D, output_dim), scale, generator)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, 3, H, W] -> [B, output_dim] f32."""
        B = images.shape[0]
        x = F.conv2d(images.float(), self.conv1_weight.float(), stride=self.patch_size)
        D = x.shape[1]
        x = x.reshape(B, D, -1).transpose(1, 2)
        x = torch.cat([self.class_embedding.expand(B, 1, D), x], dim=1) + self.positional_embedding
        x = self.ln_pre(x)
        for blk in self.resblocks:
            x = blk(x)
        return self.ln_post(x[:, 0, :]) @ self.proj


class BatchNorm(nn.Module):
    """Inference BatchNorm over [B, C, H, W] from running statistics, eps
    1e-5: (x - mean) * rsqrt(var + eps) * weight + bias.  The four vectors
    are parameters, as in vlsa_tpu's tree (the tower is frozen)."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.running_mean = nn.Parameter(torch.zeros(features))
        self.running_var = nn.Parameter(torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        inv = torch.rsqrt(self.running_var.reshape(shape) + 1e-5)
        return (x - self.running_mean.reshape(shape)) * inv * self.weight.reshape(shape) \
            + self.bias.reshape(shape)


def _conv_weight(out_ch: int, in_ch: int, k: int, generator) -> nn.Parameter:
    return _param((out_ch, in_ch, k, k), (in_ch * k * k) ** -0.5, generator)


class Bottleneck(nn.Module):
    """CLIP's anti-aliased bottleneck: stride-1 convolutions, a 2x2 average
    pool after conv2 when stride > 1, and a downsample branch (average pool,
    1x1 convolution, BatchNorm) when the stride or the width changes."""
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        out = planes * self.expansion
        self.stride = stride
        self.conv1_weight = _conv_weight(planes, inplanes, 1, generator)
        self.bn1 = BatchNorm(planes)
        self.conv2_weight = _conv_weight(planes, planes, 3, generator)
        self.bn2 = BatchNorm(planes)
        self.conv3_weight = _conv_weight(out, planes, 1, generator)
        self.bn3 = BatchNorm(out)
        self.downsample = stride > 1 or inplanes != out
        if self.downsample:
            self.downsample_conv_weight = _conv_weight(out, inplanes, 1, generator)
            self.downsample_bn = BatchNorm(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(F.conv2d(x, self.conv1_weight)))
        out = F.relu(self.bn2(F.conv2d(out, self.conv2_weight, padding=1)))
        if self.stride > 1:
            out = F.avg_pool2d(out, self.stride)
        out = self.bn3(F.conv2d(out, self.conv3_weight))
        identity = x
        if self.downsample:
            if self.stride > 1:
                identity = F.avg_pool2d(identity, self.stride)
            identity = self.downsample_bn(F.conv2d(identity, self.downsample_conv_weight))
        return F.relu(out + identity)


class AttentionPool2d(nn.Module):
    """CLIP's attention pooling: the spatial mean token prepended, a
    positional table added, the mean token's query attending every token
    (multi-head, f32), then c_proj."""

    def __init__(self, spacial_dim: int, embed_dim: int, num_heads: int,
                 output_dim: Optional[int] = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        C, out = embed_dim, output_dim or embed_dim
        self.num_heads = num_heads
        self.positional_embedding = _param((spacial_dim ** 2 + 1, C), C ** -0.5, generator)
        for name, rows in (("q", C), ("k", C), ("v", C), ("c", out)):
            setattr(self, f"{name}_proj_weight", _param((rows, C), C ** -0.5, generator))
            setattr(self, f"{name}_proj_bias", nn.Parameter(torch.zeros(rows)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, C, H, W] -> [B, output_dim]."""
        B, C = x.shape[:2]
        H = self.num_heads
        hd = C // H
        x = x.reshape(B, C, -1).transpose(1, 2)
        x = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1) + self.positional_embedding
        q = (x[:, :1] @ self.q_proj_weight.T + self.q_proj_bias).reshape(B, 1, H, hd).transpose(1, 2)
        k = (x @ self.k_proj_weight.T + self.k_proj_bias).reshape(B, -1, H, hd).transpose(1, 2)
        v = (x @ self.v_proj_weight.T + self.v_proj_bias).reshape(B, -1, H, hd).transpose(1, 2)
        attn = torch.softmax((q @ k.transpose(-1, -2)) / math.sqrt(hd), dim=-1)
        ctx = (attn @ v).transpose(1, 2).reshape(B, C)
        return ctx @ self.c_proj_weight.T + self.c_proj_bias


class CLIPModifiedResNet(nn.Module):
    """OpenAI CLIP's ModifiedResNet (RN50 by default: layers (3, 4, 6, 3),
    width 64, 32 heads, 224 px): a three-convolution stem and an average
    pool, four stages of `Bottleneck`, `AttentionPool2d`; f32 throughout."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), output_dim: int = 512,
                 heads: int = 32, input_resolution: int = 224, width: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        w = width
        self.layers = tuple(layers)
        self.output_dim = output_dim
        self.conv1_weight = _conv_weight(w // 2, 3, 3, generator)
        self.bn1 = BatchNorm(w // 2)
        self.conv2_weight = _conv_weight(w // 2, w // 2, 3, generator)
        self.bn2 = BatchNorm(w // 2)
        self.conv3_weight = _conv_weight(w, w // 2, 3, generator)
        self.bn3 = BatchNorm(w)
        inplanes = w
        self.stages = []
        for li, (mult, blocks) in enumerate(zip((1, 2, 4, 8), self.layers)):
            for b in range(blocks):
                name = f"layer{li + 1}_{b}"
                self.add_module(name, Bottleneck(inplanes, w * mult,
                                                 (1 if li == 0 else 2) if b == 0 else 1,
                                                 generator))
                self.stages.append(name)
                inplanes = w * mult * Bottleneck.expansion
        self.attnpool = AttentionPool2d(input_resolution // 32, w * 32, heads, output_dim,
                                        generator)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, 3, S, S] -> [B, output_dim] f32."""
        x = F.relu(self.bn1(F.conv2d(images.float(), self.conv1_weight, stride=2, padding=1)))
        x = F.relu(self.bn2(F.conv2d(x, self.conv2_weight, padding=1)))
        x = F.relu(self.bn3(F.conv2d(x, self.conv3_weight, padding=1)))
        x = F.avg_pool2d(x, 2)
        for name in self.stages:
            x = getattr(self, name)(x)
        return self.attnpool(x)


# ---------------------------------------------------------------------------
# Checkpoint import (counterparts of vlsa_tpu's importers)
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
    g = _reader(state, prefix)
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
    return _as_state_dict(sd)



def _reader(state: dict, prefix: str):
    def g(k):
        return np.asarray(state[prefix + k], np.float32)
    return g


def _as_state_dict(sd: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def load_clip_vit_state(state: dict, layers: int, prefix: str = "visual.",
                        image_size: Optional[int] = None,
                        patch_size: Optional[int] = None) -> dict:
    """An OpenAI CLIP checkpoint's `visual.*` tensors -> this package's
    `CLIPViT` state dict, f32.  Given `image_size` and `patch_size`, a
    positional table of another grid is resized to theirs (OpenAI's
    224-trained 197 positions -> 785 at 448 px), as vlsa_tpu's
    `import_clip_vit_state` does."""
    g = _reader(state, prefix)
    pos = g("positional_embedding")
    if image_size is not None and patch_size is not None:
        grid = image_size // patch_size
        if pos.shape[0] != grid * grid + 1:
            pos = resize_pos_embed(pos[None], (grid, grid))[0]
    sd = {"conv1_weight": g("conv1.weight"), "class_embedding": g("class_embedding"),
          "positional_embedding": pos, "proj": g("proj")}
    for ln in ("ln_pre", "ln_post"):
        for p in ("weight", "bias"):
            sd[f"{ln}.{p}"] = g(f"{ln}.{p}")
    names = {"ln_1.weight": "ln_1.weight", "ln_1.bias": "ln_1.bias",
             "ln_2.weight": "ln_2.weight", "ln_2.bias": "ln_2.bias",
             "attn.in_proj_weight": "attn.in_proj_weight",
             "attn.in_proj_bias": "attn.in_proj_bias",
             "attn.out_proj_weight": "attn.out_proj.weight",
             "attn.out_proj_bias": "attn.out_proj.bias",
             "c_fc_weight": "mlp.c_fc.weight", "c_fc_bias": "mlp.c_fc.bias",
             "c_proj_weight": "mlp.c_proj.weight", "c_proj_bias": "mlp.c_proj.bias"}
    for i in range(layers):
        for ours, theirs in names.items():
            sd[f"resblocks.{i}.{ours}"] = g(f"transformer.resblocks.{i}.{theirs}")
    return _as_state_dict(sd)


_BN_STATS = ("weight", "bias", "running_mean", "running_var")


def load_clip_resnet_state(state: dict, layers: Sequence[int], prefix: str = "visual.") -> dict:
    """An OpenAI CLIP checkpoint's `visual.*` ModifiedResNet tensors -> this
    package's `CLIPModifiedResNet` state dict, f32 (BatchNorm's
    `num_batches_tracked` is not read, as vlsa_tpu's
    `import_clip_resnet_state` does not)."""
    g = _reader(state, prefix)

    def bn(theirs, ours):
        return {f"{ours}.{p}": g(f"{theirs}.{p}") for p in _BN_STATS}

    sd = {}
    for c in ("conv1", "conv2", "conv3"):
        sd[f"{c}_weight"] = g(f"{c}.weight")
    for b in ("bn1", "bn2", "bn3"):
        sd.update(bn(b, b))
    sd["attnpool.positional_embedding"] = g("attnpool.positional_embedding")
    for p in ("q", "k", "v", "c"):
        sd[f"attnpool.{p}_proj_weight"] = g(f"attnpool.{p}_proj.weight")
        sd[f"attnpool.{p}_proj_bias"] = g(f"attnpool.{p}_proj.bias")
    for li, blocks in enumerate(layers):
        for b in range(blocks):
            theirs, ours = f"layer{li + 1}.{b}.", f"layer{li + 1}_{b}."
            for c in ("conv1", "conv2", "conv3"):
                sd[f"{ours}{c}_weight"] = g(f"{theirs}{c}.weight")
            for n in ("bn1", "bn2", "bn3"):
                sd.update(bn(theirs + n, ours + n))
            if (prefix + theirs + "downsample.0.weight") in state:
                sd[ours + "downsample_conv_weight"] = g(theirs + "downsample.0.weight")
                sd.update(bn(theirs + "downsample.1", ours + "downsample_bn"))
    return _as_state_dict(sd)
