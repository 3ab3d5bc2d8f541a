"""Train and serving steps (counterpart of vlsa_tpu/runner/engine.py).

Both take any model: the flagship VLSA or the SA baseline's DeepMIL.
`TrainEngine` takes one optimizer step on a whole padded batch of bags:
every configured loss on the valid rows, one backward, one update.  For
VLSA the text path runs in every step, since the prompt learner and the
TaskRes residuals train.

`InferEngine`, the evaluation half, computes VLSA's text prototypes and
VLFAN queries once per pass (`text_precompute`; nothing for a model without
a text branch), then answers each request -- a list of bags -- with one
padded batch through the model.

A training step calls the model with `train=True` (its Dropout on, as
vlsa_tpu's step does); every other call leaves it off.  Two rules of
vlsa_tpu's engine hold for both: the storage sidecars
(`feats_scale`, `feats_inv`) go only to a model that accepts them
(`accepts_x_scale`), any other sees bf16-dequantized features
(`feats_inputs`); and the logit scale and the query-diversity term exist
only for a vision-language model (`uses_vl`).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from torch import nn

from ..data.quant import Bag, pad_request
from ..ops.coattn import dequantize_feats
from ..ops.flags import disable_kernels
from ..optim.extra import hutchinson_hessian_diag


def feats_inputs(model: nn.Module, batch: dict) -> Tuple[torch.Tensor, dict]:
    """(features, keyword arguments) of a model call (vlsa_tpu/runner/
    engine.py::_feats_inputs): a model that accepts the storage sidecars
    gets them (x_scale for int8, x_inv for host 1/||x||); any other model
    gets int8 features dequantized to bf16 and no sidecars."""
    accepts = getattr(model, "accepts_x_scale", False)
    if "feats_scale" in batch and not accepts:
        return dequantize_feats(batch["feats"], batch["feats_scale"]).to(torch.bfloat16), {}
    kws = {}
    if accepts:
        kws = {"x_scale": batch.get("feats_scale"), "x_inv": batch.get("feats_inv")}
    return batch["feats"], kws


def _logits(out) -> torch.Tensor:
    return out[0] if isinstance(out, tuple) else out


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


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
    objectives, a ragged tail batch included.

    `needs_hessian` (adahessian, vlsa_tpu/runner/engine.py:188-216): each
    step also estimates the Hessian diagonal (`optim.extra.
    hutchinson_hessian_diag`, one forward, the gradient with create_graph
    and H z from it, with z Rademacher from the engine's generator on the
    device, seeded by `hessian_seed`, or as `train_step` is given it) and
    hands it to the optimizer's `step(hessian=)`.  The kernels have no
    second derivative, so that whole step runs inside
    `ops.flags.disable_kernels()`: the plain versions, on the card; every
    other call (evaluation, serving) keeps the kernels.  With accum_steps > 1
    it raises, as vlsa_tpu asserts."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 objective: Callable, accum_steps: int = 1, needs_hessian: bool = False,
                 hessian_seed: int = 0):
        if needs_hessian and accum_steps > 1:
            raise ValueError("adahessian with accum_steps > 1 is not supported (nor in "
                             "vlsa_tpu)")
        self.model = model
        self.optimizer = optimizer
        self.objective = objective
        self.accum_steps = accum_steps
        self.needs_hessian = needs_hessian
        self.uses_vl = getattr(model, "uses_vl", False)
        self.device = _device(model)
        self._hessian_gen = None
        if needs_hessian:
            self._hessian_gen = torch.Generator(device=self.device).manual_seed(hessian_seed)

    def loss(self, batch: dict) -> Tuple[torch.Tensor, torch.Tensor]:
        """(loss, raw logits [B, K]) of one batch on the device."""
        feats, kws = feats_inputs(self.model, batch)
        raw = _logits(self.model(feats, batch["mask"], train=True, **kws))
        vl = {}
        if self.uses_vl:
            vl = {"logit_scale": self.model.get_logit_scale(),
                  "query_div_fn": self.model.query_div_loss}
        loss = self.objective(raw, batch["t"], batch["e"], batch["valid"].to(raw.dtype), **vl)
        return loss, raw

    def _trainable(self):
        """(names, parameters) the optimizer updates, in its groups' order."""
        names, params = [], []
        for group in self.optimizer.param_groups:
            names += group["names"]
            params += group["params"]
        return names, params

    def hessian_step(self, batch: dict,
                     hessian_z: Optional[Sequence[torch.Tensor]] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The adahessian update on a batch already on the device: gradients
        and the Hessian diagonal's estimate from one forward on the plain
        versions (z: `hessian_z`, one tensor a trainable parameter in the
        optimizer's order, else drawn), then the optimizer's step."""
        names, params = self._trainable()
        with disable_kernels():
            loss, raw = self.loss(batch)
            grads, diag = hutchinson_hessian_diag(loss, params, names, z=hessian_z,
                                                  generator=self._hessian_gen)
        for p, g in zip(params, grads):
            p.grad = g
        self.optimizer.step(hessian=dict(zip(params, diag)))
        return loss.detach(), raw.detach()

    def train_step(self, batch: dict,
                   hessian_z: Optional[Sequence[torch.Tensor]] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One update on `batch` (tensors on any device, moved here).
        Returns (loss, raw logits [B, K]), both detached and on the device,
        with no host synchronisation.  `hessian_z`: the adahessian step's z
        (see `hessian_step`)."""
        self.model.train()
        batch = {k: v.to(self.device, non_blocking=True) for k, v in batch.items()}
        self.optimizer.zero_grad(set_to_none=True)
        if self.needs_hessian:
            return self.hessian_step(batch, hessian_z)
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
    """Answers requests with a fixed model (VLSA or DeepMIL).

    `feats_dtype` is the storage type of the patch features on the device
    (float32, bfloat16 or int8); `precompute_inv` ships host-computed 1/||x||
    rows with them (default: for int8 only, as the JAX pipeline does)."""

    def __init__(self, model: nn.Module, feats_dtype: str = "float32",
                 precompute_inv: Optional[bool] = None):
        self.model = model.eval()
        self.device = _device(model)
        self.feats_dtype = feats_dtype
        self.precompute_inv = precompute_inv
        self._text = None

    def text_precompute(self):
        """Encode the prompts and the queries once for this pass (a no-op
        for a model without a text branch)."""
        if hasattr(self.model, "text_precompute"):
            with torch.inference_mode():
                self._text = self.model.text_precompute()
        return self._text

    def prepare(self, bags: Sequence[Bag]) -> dict:
        return pad_request(bags, self.feats_dtype, self.precompute_inv, self.device)

    def forward(self, batch: dict) -> Dict[str, torch.Tensor]:
        """Device tensors in, device tensors out (no host synchronisation)."""
        if self._text is None:
            self.text_precompute()
        feats, kws = feats_inputs(self.model, batch)
        if self._text is not None:
            kws["text_features"], kws["query"] = self._text
        with torch.inference_mode():
            return incidence_outputs(_logits(self.model(feats, batch["mask"], **kws)))

    def predict(self, bags: Sequence[Bag]) -> Dict[str, np.ndarray]:
        """One request: bags as f32 [n_i, D] arrays or QuantizedBags ->
        {"logits", "probs", "survival"}, each [B, K] f32 on the host."""
        out = self.forward(self.prepare(bags))
        return {k: v.float().cpu().numpy() for k, v in out.items()}
