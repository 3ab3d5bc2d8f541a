"""VLFAN, the language-guided MIL aggregator (counterpart of the VLFAN part
of vlsa_tpu/models/mil.py).

P text-derived (or learned) queries cross-attend the patch bag,
    A = softmax_N(coattn_scale * norm(Q) @ norm(X)^T);  out = A @ X,
then query pooling and a linear visual adapter.  The attention and PV sum
run through `ops.coattn.coattn_pool`: the Hopper kernel for CUDA tensors.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..ops.coattn import coattn_pool, dequantize_feats
from ..ops.masked import l2_normalize
from .layers import FeatProjecter, TorchLinear

QUERY_POOLINGS = ("mean", "max", "weight")


class VLFAN(nn.Module):
    def __init__(self, dim_in: int = 1024, use_feat_proj: bool = True,
                 query: str = "Parameter", num_query: int = 10,
                 gated_query: bool = False, query_pooling: str = "mean",
                 pred_head: str = "default",
                 coattn_logit_scale_init: float = math.log(100.0),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if query_pooling not in QUERY_POOLINGS:
            raise NotImplementedError(
                f"query_pooling={query_pooling!r}: this port has {QUERY_POOLINGS}")
        self.dim_in = dim_in
        self.use_feat_proj = use_feat_proj
        self.query = query
        self.num_query = num_query
        self.gated_query = gated_query
        self.query_pooling = query_pooling
        self.pred_head = pred_head
        # fixed (non-trainable) co-attention scale
        self.coattn_logit_scale = float(math.exp(coattn_logit_scale_init))
        if use_feat_proj:
            self.feat_proj = FeatProjecter(dim_in, dim_in, generator=generator)
        if query == "Parameter":
            n_q = num_query + 1 if gated_query else num_query
            self.Q = nn.Parameter(torch.empty(n_q, dim_in).normal_(generator=generator))
        if query_pooling == "weight":
            self.query_pool_weight = nn.Parameter(
                torch.empty(1, num_query).normal_(generator=generator))
        if pred_head != "Identity":
            self.visual_adapter = TorchLinear(dim_in, dim_in, generator=generator)

    def get_query(self, query: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.query == "Parameter":
            return self.Q
        if query is None:
            raise ValueError("Text query must be provided for query='Text'.")
        return query

    def effective_query(self, query: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Normalised queries; a gate query is folded into each row (gating
        is linear in the normalised queries), so the kernel sees one [P, C]."""
        qn = l2_normalize(self.get_query(query), dim=-1)
        if self.gated_query:
            qn = qn[:-1] - qn[-1:]
        return qn

    def query_div_loss(self, query: Optional[torch.Tensor] = None,
                       last_div: bool = True) -> torch.Tensor:
        """Prompt-diversity regulariser."""
        nq = l2_normalize(self.get_query(query), dim=-1)
        P = nq.shape[0]
        if P == self.num_query + 1 and last_div:
            return torch.mean(torch.abs(nq[-1:] @ nq[:-1].T))
        off = ~torch.eye(P, dtype=torch.bool, device=nq.device)
        return torch.sum(torch.abs(nq @ nq.T) * off) / max(int(off.sum()), 1)

    def forward_query_pooling(self, out: torch.Tensor) -> torch.Tensor:
        """[B, P, C] -> [B, C]."""
        if self.query_pooling == "mean":
            return out.mean(dim=1)
        if self.query_pooling == "max":
            return out.amax(dim=1)
        w = torch.softmax(self.query_pool_weight, dim=-1)
        return torch.einsum("qp,bpc->bc", w, out)

    def forward(self, X: torch.Tensor, mask: Optional[torch.Tensor] = None,
                query: Optional[torch.Tensor] = None,
                x_scale: Optional[torch.Tensor] = None,
                x_inv: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.use_feat_proj:
            # the sidecars describe the stored features; the projecter
            # changes them, so int8 is dequantized to bf16 and they go
            if X.dtype == torch.int8:
                X = dequantize_feats(X, x_scale).to(torch.bfloat16)
            x_scale = x_inv = None
            in_dtype = X.dtype
            X = self.feat_proj(X.float())
            if in_dtype == torch.bfloat16:
                X = X.to(torch.bfloat16)
        out = coattn_pool(self.effective_query(query), X, mask, self.coattn_logit_scale,
                          x_scale=x_scale, x_inv=x_inv)
        pooled = self.forward_query_pooling(out)
        return self.visual_adapter(pooled) if self.pred_head != "Identity" else pooled
