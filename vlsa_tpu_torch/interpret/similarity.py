"""Decoupled text-image similarity of one bag (counterpart of
vlsa_tpu/interpret/similarity.py; ref utils/model_inference.py:81-178).

VLFAN runs with its attention, and the bag-level similarity to each text
prototype is decomposed over the P language priors:

    decoupled[p, k] = sum_n A[p, n] * <adapter(X[n]) / ||img||, text_k>,

the visual adapter applied to the stored features X, as vlsa_tpu does
(not to the projected ones).  The model runs on its own device, in eval
mode under `torch.inference_mode`; X and the mask are moved there.  On the
card the pooled features come from the co-attention kernel (f32 or bf16
X; int8 X with its per-patch `x_scale`) and the attention map from the
plain ops, as in vlsa_tpu.  Every array returned is numpy.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.coattn import dequantize_feats
from ..ops.masked import l2_normalize, masked_softmax
from .shapley import evaluate_prototype_shap_imp


def _device(model) -> torch.device:
    return next(model.parameters()).device


def model_inputs(model, X, mask=None, x_scale=None):
    """(X [1, N, D], mask [1, N] bool, x_scale or None) on the model's
    device; a 2-D X is one bag, a missing mask all patches."""
    device = _device(model)
    X = torch.as_tensor(X).to(device)
    if X.dim() == 2:
        X = X[None]
    mask = (torch.ones(X.shape[:2], dtype=torch.bool, device=device) if mask is None
            else torch.as_tensor(mask).to(device=device, dtype=torch.bool))
    if mask.dim() == 1:
        mask = mask[None]
    if x_scale is not None:
        x_scale = torch.as_tensor(x_scale).to(device=device, dtype=torch.float32)
        if x_scale.dim() == 1:
            x_scale = x_scale[None]
    return X, mask, x_scale


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def calc_text_img_similarity(model, X, mask=None, axis_softmax: str = "V",
                             x_scale: Optional[torch.Tensor] = None) -> dict:
    """One bag X [N, D] (or [1, N, D]) through a VLSA model with a VLFAN
    encoder -> {"attention": the raw queries' softmax over patches ("V") or
    over queries ("L"), [P(+1), N], None without text queries;
    "coattn_score": VLFAN's attention [P, N]; "probs" [1, K];
    "probs_decoupled" [1, K]; "decoupled_similarity" [P, K];
    "decoupled_imp" [P, K]; "shap_importance" [P]; "logit_scale": float}.
    As in vlsa_tpu, "attention" covers every row of X, padding included."""
    if axis_softmax not in ("L", "V"):
        raise ValueError(f"axis_softmax must be L or V, got {axis_softmax!r}")
    model.eval()
    X, mask, x_scale = model_inputs(model, X, mask, x_scale)
    mil = model.mil_encoder
    with torch.inference_mode():
        logit_scale = float(torch.exp(model.logit_scale.float()))
        norm_text = l2_normalize(model.forward_text_only().float(), dim=-1)  # [K, E]
        query = model.get_query()
        image_feature, attn = model.encode_instances(X, mask, x_scale=x_scale,
                                                     ret_with_attn=True)
        A = (attn[0] if isinstance(attn, tuple) else attn)[0]             # [P, N]
        L_img = torch.linalg.norm(image_feature, dim=-1)                  # [1]
        sim = (image_feature / L_img[:, None]) @ norm_text.T              # [1, K]
        probs = torch.softmax(logit_scale * sim, dim=-1)

        x_stored = dequantize_feats(X, x_scale).float()[0]                # [N, D]
        enc_X = mil.visual_adapter(x_stored)                              # [N, D]
        decoupled = A @ ((enc_X / L_img[0]) @ norm_text.T)                # [P, K]
        decoupled_imp = torch.softmax(logit_scale * decoupled, dim=0)
        probs2 = torch.softmax(logit_scale * decoupled.mean(dim=0, keepdim=True), dim=-1)
        shap = evaluate_prototype_shap_imp(decoupled, logit_scale)

        A_qp = None
        if query is not None:  # the raw queries against every patch
            logits = mil.coattn_logit_scale * (l2_normalize(query.float(), dim=-1)
                                               @ l2_normalize(x_stored, dim=-1).T)
            A_qp = torch.softmax(logits, dim=0 if axis_softmax == "L" else 1)
    return {"attention": None if A_qp is None else _numpy(A_qp),
            "coattn_score": _numpy(A), "probs": _numpy(probs),
            "probs_decoupled": _numpy(probs2), "decoupled_similarity": _numpy(decoupled),
            "decoupled_imp": _numpy(decoupled_imp), "shap_importance": shap,
            "logit_scale": logit_scale}


def calc_abmil_text_img_similarity(model, X, mask=None,
                                   x_scale: Optional[torch.Tensor] = None) -> dict:
    """One bag through a VLSA model whose MIL encoder is DeepMIL (or DSMIL)
    -> {"attention": the masked softmax over patches of the encoder's
    attention [1, N] (0 on padding), "probs" [1, K], "similarity" [1, K]
    cosine similarities, "logit_scale": float}.  The ABMIL pooling takes
    its explicit path here: no ABMIL kernel runs."""
    model.eval()
    X, mask, x_scale = model_inputs(model, X, mask, x_scale)
    with torch.inference_mode():
        logit_scale = float(torch.exp(model.logit_scale.float()))
        norm_text = l2_normalize(model.forward_text_only().float(), dim=-1)
        image_feature, raw_attn = model.encode_instances(X, mask, x_scale=x_scale,
                                                         ret_with_attn=True)
        if raw_attn.dim() == 3:  # [B, 1, N]
            raw_attn = raw_attn[:, 0]
        attn = masked_softmax(raw_attn, mask, dim=-1)
        sim = l2_normalize(image_feature.float(), dim=-1) @ norm_text.T
        probs = torch.softmax(logit_scale * sim, dim=-1)
    return {"attention": _numpy(attn), "probs": _numpy(probs), "similarity": _numpy(sim),
            "logit_scale": logit_scale}
