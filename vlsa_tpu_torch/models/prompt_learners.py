"""Ordinal survival prompt learners (CoOp plain/rank) and the PromptAdapter
(counterpart of vlsa_tpu/models/prompt_learners.py).

Host-built constants (sentence templates, pseudo tokens, interpolation
weights, frozen prompt features) are non-persistent buffers: the state dict
holds only the trainable parameters, as the JAX parameter tree does.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from .layers import Adapter, TorchLinear


def _param(init: Optional[np.ndarray], shape, std: float,
           generator: Optional[torch.Generator]) -> nn.Parameter:
    if init is not None:
        t = torch.as_tensor(np.asarray(init, np.float32)).clone()
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"initial value of shape {tuple(t.shape)}, expected {shape}")
        return nn.Parameter(t)
    return nn.Parameter(torch.empty(shape).normal_(0.0, std, generator=generator))


class PlainPromptLearner(nn.Module):
    """Learnable context and per-rank embeddings spliced into a pad/sot/eot
    sentence template."""

    def __init__(self, num_ranks: int, num_context_tokens: int,
                 num_tokens_per_rank: Sequence[int], sentence_template: np.ndarray,
                 pseudo_sentence_tokens: np.ndarray, rank_tokens_position: str = "tail",
                 rank_specific_context: bool = False, embedding_dim: int = 768,
                 context_init: Optional[np.ndarray] = None,
                 rank_init: Optional[np.ndarray] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if rank_tokens_position not in ("tail", "front", "middle"):
            raise ValueError(rank_tokens_position)
        self.num_ranks = num_ranks
        self.num_context_tokens = num_context_tokens
        self.num_tokens_per_rank = tuple(num_tokens_per_rank)
        self.rank_tokens_position = rank_tokens_position
        self.register_buffer("sentence_template",
                             torch.as_tensor(np.asarray(sentence_template, np.float32)),
                             persistent=False)
        self.register_buffer("pseudo_sentence_tokens",
                             torch.as_tensor(np.asarray(pseudo_sentence_tokens)),
                             persistent=False)
        ctx_shape = ((num_ranks, num_context_tokens, embedding_dim) if rank_specific_context
                     else (num_context_tokens, embedding_dim))
        self.context_embeds = _param(context_init, ctx_shape, 0.02, generator)
        self.rank_embeds = _param(rank_init, self._rank_shape(embedding_dim), 0.02, generator)

    def _rank_shape(self, dim):
        return (self.num_ranks, max(self.num_tokens_per_rank), dim)

    def _rank_rows(self) -> torch.Tensor:
        return self.rank_embeds

    def _splice(self, context: torch.Tensor, ranks: torch.Tensor) -> torch.Tensor:
        rows = []
        for i in range(self.num_ranks):
            ntr = self.num_tokens_per_rank[min(i, len(self.num_tokens_per_rank) - 1)]
            ctx, rnk = context[i], ranks[i, :ntr]
            if self.rank_tokens_position == "tail":
                body = torch.cat([ctx, rnk])
            elif self.rank_tokens_position == "front":
                body = torch.cat([rnk, ctx])
            else:
                half = self.num_context_tokens // 2
                body = torch.cat([ctx[:half], rnk, ctx[half:]])
            tpl = self.sentence_template[i]
            rows.append(torch.cat([tpl[:1], body, tpl[1 + body.shape[0]:]]))
        return torch.stack(rows)

    def forward(self) -> torch.Tensor:
        ctx = self.context_embeds
        if ctx.dim() == 2:
            ctx = ctx.expand(self.num_ranks, *ctx.shape)
        return self._splice(ctx, self._rank_rows())


class RankPromptLearner(PlainPromptLearner):
    """Ordinal bias: K base rank embeddings interpolated to num_ranks bins."""

    def __init__(self, *args, num_base_ranks: int = 4,
                 interpolation_weights: Optional[np.ndarray] = None, **kwargs):
        self.num_base_ranks = num_base_ranks
        super().__init__(*args, **kwargs)
        self.register_buffer("interpolation_weights",
                             torch.as_tensor(np.asarray(interpolation_weights, np.float32)),
                             persistent=False)

    def _rank_shape(self, dim):
        return (self.num_base_ranks, max(self.num_tokens_per_rank), dim)

    def _rank_rows(self) -> torch.Tensor:
        w = self.interpolation_weights  # [R, base]
        return torch.sum(w[..., None, None] * self.rank_embeds[None], dim=1)


def create_interpolation_weights(num_base_ranks: int, num_ranks: int,
                                 interpolation_type: str = "linear") -> np.ndarray:
    fns = {
        "linear": lambda w, n: 1.0 - w / (n - 1),
        "inv_prop": lambda w, _n, eps=1e-5: 1.0 / (w + eps),
        "normal": lambda w, _n: np.exp(-w * w),
    }
    if interpolation_type not in fns:
        raise ValueError(f"invalid interpolation_type: {interpolation_type}")
    w = np.repeat(np.arange(num_ranks, dtype=np.float32)[:, None], num_base_ranks, axis=1)
    if num_base_ranks == 1:
        base = np.linspace(0, num_ranks - 1, 3, dtype=np.float32)[1:2]
    else:
        base = np.linspace(0, num_ranks - 1, num_base_ranks, dtype=np.float32)
    w = np.abs(w - base[None])
    w = fns[interpolation_type](w, num_ranks)
    return w / w.sum(axis=-1, keepdims=True)


class PromptAdapter(nn.Module):
    """Frozen text features with a default, FC, Adapter or TaskRes head."""

    def __init__(self, prompt_features: np.ndarray, method: str = "default",
                 num_prompts: int = 4, neg_prompt_features: Optional[np.ndarray] = None,
                 dim_reduction: int = 4, keep_ratio: float = 0.8, res_ratio: float = 0.5,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if method not in ("default", "FC", "Adapter", "TaskRes"):
            raise ValueError(method)
        self.method = method
        self.keep_ratio = keep_ratio
        self.res_ratio = res_ratio
        pf = torch.as_tensor(np.asarray(prompt_features, np.float32))
        self.register_buffer("prompt_features", pf, persistent=False)
        self.has_neg = neg_prompt_features is not None
        if self.has_neg:
            self.register_buffer(
                "neg_prompt_features",
                torch.as_tensor(np.asarray(neg_prompt_features, np.float32)),
                persistent=False)
        dim = pf.shape[-1]
        if method == "Adapter":
            self.adapter = Adapter(dim, dim_reduction, generator=generator)
        elif method == "TaskRes":
            self.residual_features = _param(None, (num_prompts, dim), 1.0, generator)
            if self.has_neg:
                self.neg_residual_features = _param(None, (1, dim), 1.0, generator)
        elif method == "FC":
            self.fc = TorchLinear(dim, dim, bias=False, generator=generator)
            self.fc_dropout = nn.Dropout(0.25)

    def forward(self) -> torch.Tensor:
        pf = self.prompt_features
        if self.method == "Adapter":
            return (1 - self.keep_ratio) * self.adapter(pf) + self.keep_ratio * pf
        if self.method == "TaskRes":
            text = self.res_ratio * self.residual_features + pf
            if self.has_neg:
                neg = self.res_ratio * self.neg_residual_features + self.neg_prompt_features
                text = torch.cat([text, neg])
            return text
        if self.method == "FC":
            x = torch.cat([pf, self.neg_prompt_features]) if self.has_neg else pf
            return self.fc_dropout(self.fc(x))  # dropout acts in train mode only
        return pf
