"""MIL aggregators (counterpart of the VLFAN and DeepMIL parts of
vlsa_tpu/models/mil.py).

VLFAN, the language-guided aggregator of VLSA: P text-derived (or learned)
queries cross-attend the patch bag,
    A = softmax_N(coattn_scale * norm(Q) @ norm(X)^T);  out = A @ X,
then query pooling and a linear visual adapter.  The attention and PV sum
run through `ops.coattn.coattn_pool`: the Hopper kernels for CUDA tensors.
With the feature projecter (`use_feat_proj`) the pooled features need a
gradient, so the pooling's backward there is the dX kernel.

DeepMIL, the vision-only bag classifier of the SA baseline: attention
(ABMIL, through `ops.abmil.abmil_pool` and its Hopper kernels), mean or max
pooling, then a linear head or an Adapter.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..ops.coattn import coattn_pool, dequantize_feats
from ..ops.masked import l2_normalize, masked_max, masked_mean
from .layers import Adapter, AttentionPooling, FeatProjecter, TorchLinear

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


DEEPMIL_POOLINGS = ("mean", "max", "attention")


class DeepMIL(nn.Module):
    """ABMIL-family bag classifier: X [B, N, D], mask [B, N] -> logits
    [B, num_cls] (with the Adapter head, [B, D], as in vlsa_tpu).

    int8 features are dequantized to bf16 unless the pooling is attention
    on the raw features, which the int8 kernels take as they are; with a
    feature projecter, bf16 storage keeps the projected activations bf16.
    The `gated_attention` pooling (its Dropout needs random bits) is not
    ported yet (ROADMAP)."""
    accepts_x_scale = True
    uses_vl = False

    def __init__(self, dim_in: int = 1024, dim_hid: int = 256, num_cls: int = 2,
                 use_feat_proj: bool = True, drop_rate: float = 0.25,
                 pooling: str = "attention", pred_head: str = "default",
                 dim_reduction: int = 4, keep_ratio: float = 0.8,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if pooling not in DEEPMIL_POOLINGS:
            raise NotImplementedError(
                f"DeepMIL pooling={pooling!r}: this port has {DEEPMIL_POOLINGS} "
                f"(gated_attention is queued in ROADMAP)")
        if pred_head not in ("default", "Adapter"):
            raise ValueError(f"pred_head must be default or Adapter, got {pred_head!r}")
        del drop_rate  # the Dropout of gated_attention, not ported yet
        self.dim_in = dim_in
        self.use_feat_proj = use_feat_proj
        self.pooling = pooling
        self.pred_head = pred_head
        self.keep_ratio = keep_ratio
        if use_feat_proj:
            self.feat_proj = FeatProjecter(dim_in, dim_in, generator=generator)
        if pooling == "attention":
            self.sigma = AttentionPooling(dim_in, dim_hid, generator=generator)
        if pred_head == "Adapter":
            self.visual_adapter = Adapter(dim_in, dim_reduction, generator=generator)
        else:
            self.g = TorchLinear(dim_in, num_cls, generator=generator)

    def forward(self, X: torch.Tensor, mask: Optional[torch.Tensor] = None,
                x_scale: Optional[torch.Tensor] = None,
                x_inv: Optional[torch.Tensor] = None) -> torch.Tensor:
        del x_inv  # unnormalised pooling: the 1/||x|| sidecar is unused
        if X.dtype == torch.int8 and (self.use_feat_proj or self.pooling != "attention"):
            X = dequantize_feats(X, x_scale).to(torch.bfloat16)
            x_scale = None
        if self.use_feat_proj:
            in_dtype = X.dtype
            X = self.feat_proj(X.float())
            if in_dtype == torch.bfloat16:
                X = X.to(torch.bfloat16)
        if self.pooling == "mean":
            out_feat = masked_mean(X, mask, dim=1).float()
        elif self.pooling == "max":
            out_feat = masked_max(X, mask, dim=1).float()
        else:
            out_feat = self.sigma(X, mask, x_scale=x_scale)
        if self.pred_head == "Adapter":
            adapted = self.visual_adapter(out_feat)
            return self.keep_ratio * out_feat + (1 - self.keep_ratio) * adapted
        return self.g(out_feat)


def MaxMIL(**kws) -> DeepMIL:
    kws.pop("pooling", None)
    return DeepMIL(pooling="max", **kws)


def MeanMIL(**kws) -> DeepMIL:
    kws.pop("pooling", None)
    return DeepMIL(pooling="mean", **kws)
