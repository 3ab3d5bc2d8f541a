"""The text towers (CLIP, HF-CLIP, CONCH), driven by prompt embeddings or
token ids (counterpart of vlsa_tpu/models/text_encoder.py):

  * CONCH: 127 tokens plus an appended <cls> token, a causal mask plus the
    cls row's pad-key mask, ln_final on the pooled cls only, a 768->512
    projection, exact (erf) GELU;
  * CLIP: a causal mask, ln_final on every token, pooling at the <eot>
    position (the argmax of the pseudo tokens), QuickGELU x*sigmoid(1.702x);
  * HF: as CLIP, with the pad keys (pseudo token 0) masked as well.

Parameters keep the torch layout (`in_proj_weight [3D, D]`, weights as
[out, in]); LayerNorm eps is 1e-5.

Tensor parallelism (a multi-process run's `mesh` with model > 1,
parallel/sharding.py::shard_params, vlsa_tpu's `param_shardings`): each
rank of the model group computes its slice of every block's MLP, the rows
of `c_fc_weight` and `c_fc_bias` and the columns of `c_proj_weight`; the
MLP's input passes an identity-forward, all-reduce-backward operator, and
the partial `c_proj` products an all-reduce forward, identity backward,
with `c_proj_bias` added once after the sum.  The parameters stay whole on
every rank, computed with the rank's slice: the gradient of a sliced
parameter is then nonzero only on its slice, and one sum over the model
group makes it whole.  That keeps every optimizer exact (also those that
take norms: adamp, sgdp, lamb, global clipping) and the checkpoints whole.

`compute_dtype=bfloat16` reproduces the JAX package's bf16 mode, whose
matmuls take bf16 operands and accumulate in f32: the operands are rounded
to bf16 here and multiplied in f32, which is exact for the products and sums
in f32 -- so the result matches JAX up to summation order.  (A bf16
`torch.matmul` would round its output to bf16 as well, which JAX does not.)
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.masked import compute_float
from ..parallel.collectives import copy_to_group, reduce_from_group

NEG_INF = float("-inf")


def _mm(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x @ w.T with both operands rounded to `dtype`, accumulated in f32 (in
    float64 for float64)."""
    return compute_float(x.to(dtype)) @ compute_float(w.to(dtype)).T


def _normal(shape, std, generator):
    return torch.empty(shape).normal_(0.0, std, generator=generator)


class TorchMultiheadAttention(nn.Module):
    """torch nn.MultiheadAttention semantics with an additive mask
    ([L, L] or [K, 1, L, L]); softmax in f32."""

    def __init__(self, width: int, heads: int, compute_dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        D = width
        self.heads = heads
        self.compute_dtype = compute_dtype
        attn_std = D ** -0.5
        proj_std = (D ** -0.5) * ((2 * 12) ** -0.5)
        self.in_proj_weight = nn.Parameter(_normal((3 * D, D), attn_std, generator))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * D))
        self.out_proj_weight = nn.Parameter(_normal((D, D), proj_std, generator))
        self.out_proj_bias = nn.Parameter(torch.zeros(D))

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor] = None):
        K, L, D = x.shape
        H = self.heads
        hd = D // H
        cdt = self.compute_dtype
        qkv = _mm(x, self.in_proj_weight, cdt) + self.in_proj_bias
        q, k, v = qkv.split(D, dim=-1)

        def heads(t):
            return compute_float(t.reshape(K, L, H, hd).transpose(1, 2).to(cdt))

        q, k, v = heads(q), heads(k), heads(v)
        logits = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        if attn_mask is not None:
            logits = logits + attn_mask
        attn = torch.softmax(logits, dim=-1)
        ctx = compute_float(attn.to(cdt)) @ v
        ctx = ctx.transpose(1, 2).reshape(K, L, D)
        return _mm(ctx, self.out_proj_weight, cdt) + self.out_proj_bias


@dataclass(frozen=True)
class TensorParallel:
    """A block's share of its MLP: the model group, this rank's index in it
    and its size."""
    group: Any
    index: int
    size: int


def _quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class ResidualAttentionBlock(nn.Module):
    """Pre-LN transformer block with an exact-GELU MLP (QuickGELU with
    `quick_gelu`, OpenAI's and HF's CLIP towers)."""

    def __init__(self, width: int, heads: int, mlp_ratio: float = 4.0,
                 compute_dtype=torch.float32, quick_gelu: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        D = width
        mlp = int(D * mlp_ratio)
        fc_std = (2 * D) ** -0.5
        proj_std = (D ** -0.5) * ((2 * 12) ** -0.5)
        self.compute_dtype = compute_dtype
        self.act = _quick_gelu if quick_gelu else F.gelu
        self.ln_1 = nn.LayerNorm(D, eps=1e-5)
        self.attn = TorchMultiheadAttention(D, heads, compute_dtype, generator)
        self.ln_2 = nn.LayerNorm(D, eps=1e-5)
        self.c_fc_weight = nn.Parameter(_normal((mlp, D), fc_std, generator))
        self.c_fc_bias = nn.Parameter(torch.zeros(mlp))
        self.c_proj_weight = nn.Parameter(_normal((D, mlp), proj_std, generator))
        self.c_proj_bias = nn.Parameter(torch.zeros(D))
        self.tp: Optional[TensorParallel] = None

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor] = None):
        cdt = self.compute_dtype
        x = x + self.attn(self.ln_1(x), attn_mask)
        h = self.ln_2(x)
        if self.tp is None:
            hid = self.act(_mm(h, self.c_fc_weight, cdt) + self.c_fc_bias)
            return x + (_mm(hid, self.c_proj_weight, cdt) + self.c_proj_bias)
        tp = self.tp
        n = self.c_fc_weight.shape[0] // tp.size
        rows = slice(tp.index * n, (tp.index + 1) * n)
        h = copy_to_group(h, tp.group)
        hid = self.act(_mm(h, self.c_fc_weight[rows], cdt) + self.c_fc_bias[rows])
        out = reduce_from_group(_mm(hid, self.c_proj_weight[:, rows], cdt), tp.group)
        return x + (out + self.c_proj_bias)


def causal_mask(L: int, device=None) -> torch.Tensor:
    return torch.triu(torch.full((L, L), NEG_INF, device=device), diagonal=1)


def generate_pseudo_tokens(token_ids: np.ndarray, api: str = "CONCH", pad_id: int = 0,
                           eos_token_id: Optional[int] = None) -> np.ndarray:
    """Pseudo tokens: 1..sentence_len at real-token positions, 0 at pads.  The
    sentence ends at the <eot> id, the largest (CLIP), at `eos_token_id`
    (HF), or before the first `pad_id` (CONCH)."""
    token_ids = np.asarray(token_ids)
    if api == "CLIP":
        idx_eot = token_ids.argmax(axis=-1)
    elif api == "CONCH":
        idx_eot = (token_ids == pad_id).astype(np.int32).argmax(axis=-1) - 1
    elif api == "HF":
        if eos_token_id is None:
            raise ValueError("the HF api's pseudo tokens need eos_token_id")
        idx_eot = (token_ids == eos_token_id).astype(np.int32).argmax(axis=-1)
    else:
        raise ValueError(f"Got an invalid api ({api}).")
    pseudo = np.zeros_like(token_ids)
    for i in range(token_ids.shape[0]):
        sl = int(idx_eot[i]) + 1
        pseudo[i, :sl] = np.arange(sl) + 1
    return pseudo


APIS = ("CONCH", "CLIP", "HF")


class TextTower(nn.Module):
    """The text tower of `api` (see the module's docstring)."""

    def __init__(self, width: int = 768, heads: int = 12, layers: int = 12,
                 context_length: int = 128, vocab_size: int = 32007,
                 output_dim: int = 512, pad_id: int = 0, api: str = "CONCH",
                 compute_dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if api not in APIS:
            raise ValueError(f"Got an invalid api ({api}).")
        self.api = api
        self.width = width
        self.context_length = context_length
        self.pad_id = pad_id
        self.compute_dtype = compute_dtype
        self.token_embedding = nn.Parameter(_normal((vocab_size, width), 0.02, generator))
        self.positional_embedding = nn.Parameter(
            _normal((context_length, width), 0.01, generator))
        if api == "CONCH":
            self.cls_emb = nn.Parameter(_normal((width,), 0.01, generator))
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, compute_dtype=compute_dtype,
                                   quick_gelu=api != "CONCH", generator=generator)
            for _ in range(layers))
        self.ln_final = nn.LayerNorm(width, eps=1e-5)
        self.text_projection = nn.Parameter(
            _normal((width, output_dim), width ** -0.5, generator))

    @property
    def max_num_tokens(self) -> int:
        # CONCH's last slot holds <cls>
        return self.context_length - 1 if self.api == "CONCH" else self.context_length

    def _cls_mask(self, pseudo_tokens: torch.Tensor, L: int) -> torch.Tensor:
        """Additive [K, 1, L, L] mask in which only the appended <cls> row
        excludes pad keys.  Key j is valid iff token j-1 is a real token
        (open_clip's build_cls_mask pads a force-valid first column), so the
        <cls> slot itself takes the last pad's validity."""
        K = pseudo_tokens.shape[0]
        valid = pseudo_tokens != self.pad_id
        cls_row = torch.cat([torch.ones(K, 1, dtype=torch.bool, device=valid.device),
                             valid], dim=1)
        mask = torch.zeros(K, L, L, device=valid.device)
        mask[:, L - 1, :] = torch.where(cls_row, 0.0, NEG_INF)
        return mask[:, None]

    def embed_tokens(self, token_ids: torch.Tensor) -> torch.Tensor:
        """Token ids [K, L] -> their embeddings [K, L, D]."""
        return self.token_embedding[token_ids.to(self.token_embedding.device)]

    def forward(self, prompts_embedding: Optional[torch.Tensor] = None,
                prompts_pseudo_tokens: Optional[torch.Tensor] = None,
                prompts_text: Optional[torch.Tensor] = None,
                return_tokens: bool = False):
        """Embeddings [K, L, D] with pseudo tokens [K, L], or token ids
        (CONCH [K, 128]; CLIP and HF [K, L] with their pseudo tokens, which
        CLIP can derive) -> pooled text features [K, output_dim].  L is at
        most `max_num_tokens`.  With `return_tokens`, (pooled, tokens [K, L,
        D]): the per-token outputs CoCa's caption decoder reads, CONCH's
        before ln_final and without the <cls> slot, CLIP's and HF's after
        ln_final."""
        device = self.token_embedding.device
        if prompts_text is not None:
            if self.api == "CONCH":
                if prompts_text.shape[1] != self.max_num_tokens + 1:
                    raise ValueError(f"expected {self.max_num_tokens + 1} token ids per text")
                prompts_text = prompts_text[:, :-1]  # room for <cls>
            if prompts_pseudo_tokens is None:
                # the HF api raises here, as vlsa_tpu's does: it needs the eos id
                prompts_pseudo_tokens = torch.as_tensor(generate_pseudo_tokens(
                    prompts_text.cpu().numpy(), self.api, self.pad_id), device=device)
            x = self.embed_tokens(prompts_text)
        else:
            if prompts_embedding is None or prompts_pseudo_tokens is None:
                raise ValueError("pass prompts_text, or prompts_embedding with "
                                 "prompts_pseudo_tokens")
            x = prompts_embedding
        pseudo = prompts_pseudo_tokens.to(device)
        K, L, _ = x.shape
        # trimmed prompts (L < max_num_tokens) are exact: with causal
        # attention the positions past the last real token cannot reach the
        # <eot> or <cls> readout; CONCH's cls token keeps its full-context
        # positional row
        if L > self.max_num_tokens:
            raise ValueError(f"at most {self.max_num_tokens} prompt tokens, got {L}")
        x = x + self.positional_embedding[:L]
        if self.api == "CONCH":
            cls_vec = self.cls_emb + self.positional_embedding[self.context_length - 1]
            x = torch.cat([x, cls_vec.expand(K, 1, self.width)], dim=1)
            L += 1
            attn_mask = causal_mask(L, device)[None, None] + self._cls_mask(pseudo, L)
        elif self.api == "HF":
            pad_mask = torch.where(pseudo > 0, 0.0, NEG_INF)  # [K, L] over the keys
            attn_mask = causal_mask(L, device)[None, None] + pad_mask[:, None, None, :]
        else:
            attn_mask = causal_mask(L, device)
        for blk in self.resblocks:
            x = blk(x, attn_mask)
        if self.api == "CONCH":
            tokens = x[:, :-1]
            pooled = self.ln_final(x[:, -1])
        else:
            x = tokens = self.ln_final(x)
            pooled = x[torch.arange(K, device=device), torch.argmax(pseudo, dim=-1)]
        pooled = pooled @ self.text_projection
        return (pooled, tokens) if return_tokens else pooled


# the published towers (vlsa_tpu/models/text_encoder.py::make_text_tower)
TOWER_CONFIGS = {
    "CONCH": dict(width=768, heads=12, layers=12, context_length=128, vocab_size=32007,
                  output_dim=512),
    "CLIP": dict(width=512, heads=8, layers=12, context_length=77, vocab_size=49408,
                 output_dim=512),
    "HF": dict(width=512, heads=8, layers=12, context_length=77, vocab_size=49408,
               output_dim=512),
}


def make_text_tower(api: str = "CONCH", generator: Optional[torch.Generator] = None,
                    **overrides) -> TextTower:
    """The published tower of `api`, with `overrides` applied."""
    if api not in TOWER_CONFIGS:
        raise ValueError(f"Got an invalid api ({api}).")
    return TextTower(api=api, generator=generator, **dict(TOWER_CONFIGS[api], **overrides))
