"""Cohort attribution (counterpart of vlsa_tpu/interpret/cohort.py): the
decoupled prior-by-bin similarities and exact Shapley importances of every
patient of a split, batched.

The bags come from the port's `BagBatcher` in f32 (a `.q8npz` store
dequantized on the host, as vlsa_tpu's batcher does), in order, built on
its producer thread (`prefetch=2`).  The model runs on its own device in
eval mode under `torch.inference_mode`, the text prototypes and queries
computed once a pass; on the card each batch's pooled features come from
the f32 co-attention forward kernel, its attention map from the plain ops.
"""
from __future__ import annotations

import csv
from typing import Optional

import numpy as np
import torch

from ..data.pipeline import BagBatcher
from ..ops.masked import l2_normalize
from .shapley import batched_shapley


def batch_decoupled(model, feats, mask, query, norm_text, logit_scale: float):
    """One batch: (decoupled similarities [B, P, K], incidence
    probabilities [B, K]), on the model's device."""
    img, attn = model.encode_instances(feats, mask, query=query, ret_with_attn=True)
    A = attn[0] if isinstance(attn, tuple) else attn                # [B, P, N]
    enc = model.mil_encoder.visual_adapter(feats)                   # [B, N, D]
    L_img = torch.linalg.norm(img, dim=-1)                          # [B]
    dec = torch.einsum("bpn,bnk->bpk", A, (enc / L_img[:, None, None]) @ norm_text.T)
    probs = torch.softmax(logit_scale * (img / L_img[:, None]) @ norm_text.T, dim=-1)
    return dec, probs


def write_cohort_csv(out: dict, save_path: str) -> None:
    """patient_id, shap_prior_<i> (P columns), incidence_<k> (K columns)."""
    shap, probs = out["shap_importance"], out["probs"]
    with open(save_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["patient_id"] + [f"shap_prior_{i}" for i in range(shap.shape[1])]
                   + [f"incidence_{k}" for k in range(probs.shape[1])])
        for uid, s, p in zip(out["uid"], shap, probs):
            w.writerow([uid] + [repr(float(v)) for v in s] + [repr(float(v)) for v in p])


def interpret_cohort(model, dataset, batch_size: int = 16, min_bucket: int = 256,
                     save_path: Optional[str] = None) -> dict:
    """{"uid": the patients in the dataset's order, "decoupled_similarity"
    [B, P, K], "shap_importance" [B, P], "probs" [B, K]} (numpy f32) for
    every patient of `dataset`; with `save_path`, also written there as CSV."""
    device = next(model.parameters()).device
    model.eval()
    batcher = BagBatcher(dataset, batch_size=batch_size, shuffle=False,
                         min_bucket=min_bucket, prefetch=2)
    all_dec, all_shap, all_probs, all_uid = [], [], [], []
    with torch.inference_mode():
        logit_scale = float(torch.exp(model.logit_scale.float()))
        norm_text = l2_normalize(model.forward_text_only().float(), dim=-1)  # [K, E]
        query = model.get_query()
        for batch in batcher:
            feats = batch["feats"].to(device, non_blocking=True)
            mask = batch["mask"].to(device, non_blocking=True)
            dec, probs = batch_decoupled(model, feats, mask, query, norm_text, logit_scale)
            shap = batched_shapley(dec, logit_scale)
            valid = batch["valid"].numpy()
            all_dec.append(dec.float().cpu().numpy()[valid])
            all_shap.append(shap.cpu().numpy()[valid])
            all_probs.append(probs.float().cpu().numpy()[valid])
            all_uid += [dataset.uid[i] for i in batch["idx"].numpy()[valid]]
    out = {"uid": all_uid, "decoupled_similarity": np.concatenate(all_dec),
           "shap_importance": np.concatenate(all_shap), "probs": np.concatenate(all_probs)}
    if save_path:
        write_cohort_csv(out, save_path)
        print(f"[interpret] wrote cohort attribution to {save_path}")
    return out
