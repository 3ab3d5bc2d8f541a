"""Train and serving steps (counterpart of vlsa_tpu/runner/engine.py).

`TrainEngine` takes one optimizer step on a whole padded batch of bags:
every configured loss on the valid rows, one backward, one update.  The
text path runs in every step, since the prompt learner and the TaskRes
residuals train.

`InferEngine`, the evaluation half, computes the text prototypes and the
VLFAN queries once per pass (`text_precompute`), then answers each request
-- a list of bags -- with one padded batch through the model.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.quant import Bag, pad_request
from ..models.vlsa import VLSA


def make_output_converter(name: Optional[str]) -> Callable:
    """The network's output converter: sigmoid, softmax or identity."""
    if name == "sigmoid":
        return torch.sigmoid
    if name == "softmax":
        return lambda x: torch.softmax(x, dim=-1)
    return lambda x: x


def make_objective(loss_fns: Dict[str, Callable], loss_weights: Dict[str, float],
                   converter: Callable) -> Callable:
    """The weighted sum of the configured losses.  SurvEMD takes the
    converted predictions and the live logit scale, SurvT2I the raw logits
    and the scale, QueryDiv the network's regulariser, the rest the
    converted predictions."""

    def objective(raw_pred, t, e, sample_mask, logit_scale=None, query_div_fn=None):
        converted = converter(raw_pred)
        total = 0.0
        for name, fn in loss_fns.items():
            w = loss_weights.get(name, 1)
            if name == "SurvEMD":
                total = total + w * fn(converted, t, e, logit_scale, sample_mask=sample_mask)
            elif name == "SurvT2I":
                total = total + w * fn(raw_pred, t, e, logit_scale, sample_mask=sample_mask)
            elif name == "QueryDiv":
                total = total + w * query_div_fn()
            else:
                total = total + w * fn(converted, t, e, sample_mask=sample_mask)
        return total

    return objective


class TrainEngine:
    """One optimizer step per padded batch of bags.

    Frozen parameters have requires_grad=False (optim.frozen_mask_from_cfg),
    so no backward runs into them.  With `accum_steps` > 1 the batch is cut
    into that many micro-batches, one forward and backward each; each
    micro-batch's loss and gradient are weighted by its count of valid bags,
    which reproduces the whole batch's loss and gradient for per-bag-mean
    objectives, a ragged tail batch included."""

    def __init__(self, model: VLSA, optimizer: torch.optim.Optimizer, objective: Callable,
                 accum_steps: int = 1):
        self.model = model
        self.optimizer = optimizer
        self.objective = objective
        self.accum_steps = accum_steps
        self.device = model.logit_scale.device

    def loss(self, batch: dict) -> Tuple[torch.Tensor, torch.Tensor]:
        """(loss, raw logits [B, K]) of one batch on the device; the storage
        sidecars (int8 scales, host 1/||x||) go to the co-attention."""
        raw, _img, _txt = self.model(batch["feats"], batch["mask"],
                                     x_scale=batch.get("feats_scale"),
                                     x_inv=batch.get("feats_inv"))
        loss = self.objective(raw, batch["t"], batch["e"], batch["valid"].to(raw.dtype),
                              logit_scale=self.model.get_logit_scale(),
                              query_div_fn=self.model.query_div_loss)
        return loss, raw

    def train_step(self, batch: dict) -> Tuple[torch.Tensor, torch.Tensor]:
        """One update on `batch` (tensors on any device, moved here).
        Returns (loss, raw logits [B, K]), both detached and on the device,
        with no host synchronisation."""
        self.model.train()
        batch = {k: v.to(self.device, non_blocking=True) for k, v in batch.items()}
        self.optimizer.zero_grad(set_to_none=True)
        accum = self.accum_steps
        if accum <= 1:
            loss, raw = self.loss(batch)
            loss.backward()
            loss, raw = loss.detach(), raw.detach()
        else:
            B = batch["feats"].shape[0]
            if B % accum != 0:
                raise ValueError(f"a batch of {B} bags does not split into "
                                 f"{accum} micro-batches")
            mb = B // accum
            w_tot = torch.clamp(batch["valid"].sum().float(), min=1.0)
            loss, raws = 0.0, []
            for i in range(accum):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                w = micro["valid"].sum().float()
                loss_i, raw_i = self.loss(micro)
                (loss_i * (w / w_tot)).backward()
                loss = loss + loss_i.detach() * (w / w_tot)
                raws.append(raw_i.detach())
            raw = torch.cat(raws)
        self.optimizer.step()
        return loss, raw


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
