"""MIL aggregators (counterpart of the VLFAN and DeepMIL parts of
vlsa_tpu/models/mil.py).

VLFAN, the language-guided aggregator of VLSA: P text-derived (or learned)
queries cross-attend the patch bag,
    A = softmax_N(coattn_scale * norm(Q) @ norm(X)^T);  out = A @ X,
then query pooling and a linear visual adapter.  The attention and PV sum
run through `ops.coattn.coattn_pool`: the Hopper kernels for CUDA tensors.
With the feature projecter (`use_feat_proj`) the pooled features need a
gradient, so the pooling's backward there is the dX kernel.

With `ret_with_attn` VLFAN also returns the prior-by-patch attention
[B, P, N] of the interpretation path (`coattn_attention_reference`, plain
ops, as vlsa_tpu computes it outside its kernel).  Its query poolings:
mean, max, weight, and the `attention` and `gated_attention` poolings of
the P rows, on their explicit paths (plain ops; vlsa_tpu's fused ABMIL
path needs N >= 256, so its attention pooling of the P < 256 query rows
adds b2).

DeepMIL, the vision-only bag classifier of the SA baseline: attention
(ABMIL, through `ops.abmil.abmil_pool` and its Hopper kernels; with
`ret_with_attn`, the explicit path and its raw attention), gated attention
(plain ops), mean or max pooling, then a linear head or an Adapter.

DSMIL, the dual-stream aggregator: an instance classifier, the critical
instance of each class by masked argmax, attention of every patch to it
through a shared `q` layer, and a conv over the class-pooled values (an
einsum).  Plain ops: vlsa_tpu has no kernel here.

Dropout (gated attention, DSMIL's `v` input) runs only with `train=True`,
its masks from `layers.SeededDropout`, seeded with the module's
`dropout_seed`.

FeatMIL and `logit_pooling`, the zero-shot (MI-Zero) path: FeatMIL has no
parameters and returns the per-patch features (or their masked mean or
max); VLSA scores every patch against the text prototypes and pools the
per-patch logits by `logit_pooling`.  No kernel runs there, by vlsa_tpu's
own design (plain XLA ops, vlsa_tpu/models/mil.py:35-65).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..ops.coattn import coattn_attention_reference, coattn_pool, dequantize_feats
from ..ops.masked import (compute_float, l2_normalize, masked_max, masked_mean, masked_softmax,
                          masked_topk_mean)
from .layers import (Adapter, AttentionPooling, FeatProjecter, GatedAttentionPooling,
                     SeededDropout, TorchLinear)

QUERY_POOLINGS = ("mean", "max", "weight", "attention", "gated_attention")


def logit_pooling(logits: torch.Tensor, method: str,
                  mask: Optional[torch.Tensor] = None):
    """MI-Zero aggregation of per-patch logits [N, C] or [B, N, C]:
    `logit_max`, `logit_top<k>` (the mean of the top k) or `logit_mean`,
    over the valid patches; returns (argmax class, pooled logits [.., C])."""
    if method[:9] in ("logit_max", "logit_top"):
        topk = 1 if method == "logit_max" else int(method.split("top")[-1])
        pooled = masked_topk_mean(logits, mask, topk)
    elif method == "logit_mean":
        pooled = masked_mean(logits, mask, dim=-2)
    else:
        raise NotImplementedError(f"The pooling ({method}) is not implemented.")
    return torch.argmax(pooled, dim=-1), pooled


class FeatMIL(nn.Module):
    """The zero-shot aggregator: no parameters; `mean` or `max` pooling
    gives [B, D], anything else (`identity`) the per-patch features
    [B, N, D], whose logits VLSA pools by `logit_pooling`."""

    def __init__(self, pooling: str = "mean"):
        super().__init__()
        self.pooling = pooling

    def forward(self, X: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.pooling == "mean":
            return masked_mean(X, mask, dim=1)
        if self.pooling == "max":
            return masked_max(X, mask, dim=1)
        return X


class VLFAN(nn.Module):
    def __init__(self, dim_in: int = 1024, dim_hid: int = 256, use_feat_proj: bool = True,
                 drop_rate: float = 0.25, query: str = "Parameter", num_query: int = 10,
                 gated_query: bool = False, query_pooling: str = "mean",
                 pred_head: str = "default",
                 coattn_logit_scale_init: float = math.log(100.0),
                 generator: Optional[torch.Generator] = None, dropout_seed: int = 0):
        super().__init__()
        if query_pooling not in QUERY_POOLINGS:
            raise ValueError(f"query_pooling must be one of {QUERY_POOLINGS}, "
                             f"got {query_pooling!r}")
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
        if query_pooling == "attention":
            self.query_pool = AttentionPooling(dim_in, dim_hid, generator=generator)
        elif query_pooling == "gated_attention":
            self.query_pool = GatedAttentionPooling(dim_in, dim_hid, dropout=drop_rate,
                                                    seed=dropout_seed, generator=generator)
        elif query_pooling == "weight":
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

    def forward_query_pooling(self, out: torch.Tensor, train: bool = False):
        """[B, P, C] -> ([B, C], the attention pooling's [B, P] or None): the
        raw attention a_raw (b2 included) for `attention`, its softmax for
        `gated_attention`, as vlsa_tpu returns them."""
        if self.query_pooling == "mean":
            return out.mean(dim=1), None
        if self.query_pooling == "max":
            return out.amax(dim=1), None
        if self.query_pooling == "weight":
            w = torch.softmax(self.query_pool_weight, dim=-1)
            return torch.einsum("qp,bpc->bc", w, out), None
        if self.query_pooling == "attention":
            return self.query_pool(out, None, need_attn=True)
        return self.query_pool(out, None, train=train)

    def forward(self, X: torch.Tensor, mask: Optional[torch.Tensor] = None,
                query: Optional[torch.Tensor] = None,
                x_scale: Optional[torch.Tensor] = None,
                x_inv: Optional[torch.Tensor] = None,
                ret_with_attn: bool = False, train: bool = False):
        """Image features [B, D]; with `ret_with_attn`, (features, A) with
        the attention A [B, P, N], or (features, (A, pooled_ext)) when the
        query pooling returns its own attention."""
        if self.use_feat_proj:
            # the sidecars describe the stored features; the projecter
            # changes them, so int8 is dequantized to bf16 and they go
            if X.dtype == torch.int8:
                X = dequantize_feats(X, x_scale).to(torch.bfloat16)
            x_scale = x_inv = None
            in_dtype = X.dtype
            X = self.feat_proj(compute_float(X))
            if in_dtype == torch.bfloat16:
                X = X.to(torch.bfloat16)
        q_eff = self.effective_query(query)
        out = coattn_pool(q_eff, X, mask, self.coattn_logit_scale,
                          x_scale=x_scale, x_inv=x_inv)
        pooled, pooled_ext = self.forward_query_pooling(out, train=train)
        feats = self.visual_adapter(pooled) if self.pred_head != "Identity" else pooled
        if not ret_with_attn:
            return feats
        A = coattn_attention_reference(q_eff, X, mask, self.coattn_logit_scale,
                                       x_scale=x_scale)  # [B, P, N]
        return feats, (A if pooled_ext is None else (A, pooled_ext))


DEEPMIL_POOLINGS = ("mean", "max", "attention", "gated_attention")


class DeepMIL(nn.Module):
    """ABMIL-family bag classifier: X [B, N, D], mask [B, N] -> logits
    [B, num_cls] (with the Adapter head, [B, D], as in vlsa_tpu); with
    `ret_with_attn`, (logits, attention [B, N]): the raw attention of the
    ABMIL pooling's explicit path, the softmaxed one of gated attention
    (as vlsa_tpu returns each), None for mean and max.

    int8 features are dequantized to bf16 unless the pooling is attention
    on the raw features, which the int8 kernels take as they are; with a
    feature projecter, bf16 storage keeps the projected activations bf16."""
    accepts_x_scale = True
    uses_vl = False

    def __init__(self, dim_in: int = 1024, dim_hid: int = 256, num_cls: int = 2,
                 use_feat_proj: bool = True, drop_rate: float = 0.25,
                 pooling: str = "attention", pred_head: str = "default",
                 dim_reduction: int = 4, keep_ratio: float = 0.8,
                 generator: Optional[torch.Generator] = None, dropout_seed: int = 0):
        super().__init__()
        if pooling not in DEEPMIL_POOLINGS:
            raise ValueError(f"DeepMIL pooling must be one of {DEEPMIL_POOLINGS}, "
                             f"got {pooling!r}")
        if pred_head not in ("default", "Adapter"):
            raise ValueError(f"pred_head must be default or Adapter, got {pred_head!r}")
        self.dim_in = dim_in
        self.use_feat_proj = use_feat_proj
        self.pooling = pooling
        self.pred_head = pred_head
        self.keep_ratio = keep_ratio
        if use_feat_proj:
            self.feat_proj = FeatProjecter(dim_in, dim_in, generator=generator)
        if pooling == "attention":
            self.sigma = AttentionPooling(dim_in, dim_hid, generator=generator)
        elif pooling == "gated_attention":
            self.sigma = GatedAttentionPooling(dim_in, dim_hid, dropout=drop_rate,
                                               seed=dropout_seed, generator=generator)
        if pred_head == "Adapter":
            self.visual_adapter = Adapter(dim_in, dim_reduction, generator=generator)
        else:
            self.g = TorchLinear(dim_in, num_cls, generator=generator)

    def forward(self, X: torch.Tensor, mask: Optional[torch.Tensor] = None,
                x_scale: Optional[torch.Tensor] = None,
                x_inv: Optional[torch.Tensor] = None,
                ret_with_attn: bool = False, train: bool = False):
        del x_inv  # unnormalised pooling: the 1/||x|| sidecar is unused
        if X.dtype == torch.int8 and (self.use_feat_proj or self.pooling != "attention"):
            X = dequantize_feats(X, x_scale).to(torch.bfloat16)
            x_scale = None
        if self.use_feat_proj:
            in_dtype = X.dtype
            X = self.feat_proj(X.float())
            if in_dtype == torch.bfloat16:
                X = X.to(torch.bfloat16)
        attn = None
        if self.pooling == "mean":
            out_feat = masked_mean(X, mask, dim=1).float()
        elif self.pooling == "max":
            out_feat = masked_max(X, mask, dim=1).float()
        elif self.pooling == "attention" and not ret_with_attn:
            out_feat = self.sigma(X, mask, x_scale=x_scale)
        elif self.pooling == "attention":
            out_feat, attn = self.sigma(X, mask, x_scale=x_scale, need_attn=True)
        else:
            out_feat, attn = self.sigma(X, mask, train=train)
        if self.pred_head == "Adapter":
            adapted = self.visual_adapter(out_feat)
            logits = self.keep_ratio * out_feat + (1 - self.keep_ratio) * adapted
        else:
            logits = self.g(out_feat)
        return (logits, attn) if ret_with_attn else logits


def MaxMIL(**kws) -> DeepMIL:
    kws.pop("pooling", None)
    return DeepMIL(pooling="max", **kws)


def MeanMIL(**kws) -> DeepMIL:
    kws.pop("pooling", None)
    return DeepMIL(pooling="mean", **kws)


class DSMIL(nn.Module):
    """Dual-stream MIL (counterpart of vlsa_tpu/models/mil.py::DSMIL):
    X [B, N, D], mask [B, N] -> logits [B, num_cls], the mean of the bag
    stream's prediction and the instance stream's masked max; with
    `ret_with_attn`, (logits, the attention [B, N] averaged over classes).

    The bag stream attends every patch to each class's critical instance
    (masked argmax of the instance classifier `i_fc`) through the shared
    `q` layer, pools `v` (Dropout on its input, `train=True` only) by that
    attention, and mixes the classes with Conv1d(C, C, kernel=Dv) as an
    einsum over `fcc_kernel` [C, C, Dv].  The parameters keep vlsa_tpu's
    names; `fcc_kernel` ~ U(+-1/C) and `fcc_bias` = 0 as vlsa_tpu
    initialises them.  int8 features are the caller's to dequantize (the
    engine and VLSA do); the products are f32."""
    accepts_x_scale = False
    uses_vl = False

    def __init__(self, dim_in: int = 1024, dim_hid: int = 256, num_cls: int = 2,
                 use_feat_proj: bool = True, drop_rate: float = 0.25,
                 generator: Optional[torch.Generator] = None, dropout_seed: int = 0):
        super().__init__()
        self.dim_hid = dim_hid
        self.use_feat_proj = use_feat_proj
        if use_feat_proj:
            self.feat_proj = FeatProjecter(dim_in, dim_in, generator=generator)
        self.i_fc = TorchLinear(dim_in, num_cls, generator=generator)
        self.q = TorchLinear(dim_in, dim_hid, generator=generator)
        self.v = TorchLinear(dim_in, dim_hid, generator=generator)
        self.dropout = SeededDropout(drop_rate, dropout_seed)
        bound = 1.0 / num_cls
        self.fcc_kernel = nn.Parameter(torch.empty(num_cls, num_cls, dim_hid).uniform_(
            -bound, bound, generator=generator))
        self.fcc_bias = nn.Parameter(torch.zeros(num_cls))

    def forward(self, X: torch.Tensor, mask: Optional[torch.Tensor] = None,
                ret_with_attn: bool = False, train: bool = False):
        X = X.float()
        if self.use_feat_proj:
            X = self.feat_proj(X)
        D = X.shape[-1]
        classes = self.i_fc(X)  # [B, N, C]
        cls_logits = classes if mask is None else torch.where(
            mask[..., None], classes, torch.full((), -1e30, device=X.device))
        crit_idx = torch.argmax(cls_logits, dim=1)  # [B, C]
        m_feats = torch.gather(X, 1, crit_idx[..., None].expand(-1, -1, D))  # [B, C, D]
        q = self.q(X)  # [B, N, Dq]
        v = self.v(self.dropout(X, train))  # [B, N, Dv]
        q_max = self.q(m_feats)  # [B, C, Dq], the shared weights
        A_logits = torch.einsum("bnq,bcq->bnc", q, q_max) / math.sqrt(float(self.dim_hid))
        A = masked_softmax(A_logits, None if mask is None else mask[..., None], dim=1)
        B_mat = torch.einsum("bnc,bnv->bcv", A, v)  # [B, C, Dv]
        bag_pred = torch.einsum("bcv,ocv->bo", B_mat, self.fcc_kernel) + self.fcc_bias
        max_pred = masked_max(classes, mask, dim=1)  # [B, C]
        logits = 0.5 * (bag_pred + max_pred)
        return (logits, A.mean(dim=-1)) if ret_with_attn else logits
