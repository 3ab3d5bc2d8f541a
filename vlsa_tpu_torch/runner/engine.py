"""The serving engine: the evaluation half of vlsa_tpu's TrainEngine.

A serving pass computes the text prototypes and the VLFAN queries once
(`text_precompute`), then answers each request -- a list of bags -- with one
padded batch through the model.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..data.quant import Bag, pad_request
from ..models.vlsa import VLSA


def incidence_outputs(logits: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Incidence probabilities softmax(logits) and the survival curve
    1 - cumsum(probs), clipped at 0."""
    probs = torch.softmax(logits, dim=-1)
    survival = torch.clamp(1.0 - torch.cumsum(probs, dim=-1), min=0.0)
    return {"logits": logits, "probs": probs, "survival": survival}


class InferEngine:
    """Answers requests with a fixed VLSA model.

    `feats_dtype` is the storage type of the patch features on the device
    (float32, bfloat16 or int8); `precompute_inv` ships host-computed 1/||x||
    rows with them (default: for int8 only, as the JAX pipeline does)."""

    def __init__(self, model: VLSA, feats_dtype: str = "float32",
                 precompute_inv: Optional[bool] = None):
        self.model = model.eval()
        self.device = model.logit_scale.device
        self.feats_dtype = feats_dtype
        self.precompute_inv = precompute_inv
        self._text = None

    def text_precompute(self):
        """Encode the prompts and the queries once for this pass."""
        with torch.inference_mode():
            self._text = self.model.text_precompute()
        return self._text

    def prepare(self, bags: Sequence[Bag]) -> dict:
        return pad_request(bags, self.feats_dtype, self.precompute_inv, self.device)

    def forward(self, batch: dict) -> Dict[str, torch.Tensor]:
        """Device tensors in, device tensors out (no host synchronisation)."""
        if self._text is None:
            self.text_precompute()
        text_features, query = self._text
        with torch.inference_mode():
            logits, _img, _txt = self.model(
                batch["feats"], batch["mask"], text_features=text_features, query=query,
                x_scale=batch.get("feats_scale"), x_inv=batch.get("feats_inv"))
            return incidence_outputs(logits)

    def predict(self, bags: Sequence[Bag]) -> Dict[str, np.ndarray]:
        """One request: bags as f32 [n_i, D] arrays or QuantizedBags ->
        {"logits", "probs", "survival"}, each [B, K] f32 on the host."""
        out = self.forward(self.prepare(bags))
        return {k: v.float().cpu().numpy() for k, v in out.items()}
