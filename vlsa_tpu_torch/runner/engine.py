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

On a mesh of ranks (parallel/sharding.py) a step takes the rank's share of
the global batch (`parallel.multihost.make_global_batch`: its bags, and its
chunk of the patch axis when the pool is sequence parallel).  vlsa_tpu's
objective is the global batch's, and some losses couple bags (SurvPLE,
rank_loss, SurvT2I's contrastive term), so every rank gathers the logits
and labels over its data group and computes the objective on the whole
batch, divided by D; the gather's backward sums the gradient over the
group and keeps the rank's rows, and every trainable gradient is summed
over the data group.  Both the terms reached through the logits and those
that reach a parameter directly (the logit scale, QueryDiv) then count
once.  The gradients of the parameters a rank computes from its slice of a
model group's work (tensor-parallel MLP slices, a projecter before a
sequence-parallel pool) are summed over the model group first.  A batch's cluster ids or
edge lists (`data_mode` cluster or graph: `GRAPH_KEYS`) go to the model as
keyword arguments of those names, in training, evaluation and serving.
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
from ..parallel.collectives import all_gather, gather_rows, sum_tensors_
from ..parallel.multihost import make_global_batch

# the batch entries of cluster and graph bags, passed to the model by name
GRAPH_KEYS = ("cluster_id", "edge_index", "edge_valid")


def model_extras(batch: dict) -> dict:
    return {k: batch[k] for k in GRAPH_KEYS if k in batch}


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
    it raises, as vlsa_tpu asserts.  On a mesh every rank draws the same z
    (one seed, the optimizer's parameter order), and H z is summed as the
    gradients are (`reduce_grads`): the collectives' backwards have
    derivatives of their own (parallel/collectives.py), and the
    sequence-parallel pools take vlsa_tpu's plain shard_fn there.

    `mesh` (parallel.sharding.Mesh of more than one rank): the data-parallel
    objective and gradient sums of the module's docstring; `seq_parallel`
    slices the patch axis of the batches; `model_partial` names the
    parameters whose gradients the model group sums.  With `accum_steps` >
    1 micro-batch k is each rank's k-th share of the batch, its rows
    gathered over the data group: the training batcher lays out a rank's
    batch as its shares of vlsa_tpu's contiguous micro-batches, rows [k mb,
    (k + 1) mb) of the global batch, mb = B / accum_steps
    (runner/train.py::make_batcher), so that a loss that couples the bags
    sees vlsa_tpu's micro-batches."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 objective: Callable, accum_steps: int = 1, needs_hessian: bool = False,
                 hessian_seed: int = 0, mesh=None, seq_parallel: bool = False,
                 model_partial: Sequence[str] = ()):
        if needs_hessian and accum_steps > 1:
            raise ValueError("adahessian with accum_steps > 1 is not supported (nor in "
                             "vlsa_tpu)")
        mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.mesh = mesh
        self.seq_parallel = seq_parallel
        self.n_data = 1 if mesh is None else mesh.n_data
        self._data_group = None if mesh is None else mesh.data_group
        named = dict(model.named_parameters())
        self._model_partial = [named[n] for n in model_partial if named[n].requires_grad]
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

    def labels(self, batch: dict) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(t, e, valid) of the whole batch: gathered over the data group on
        a mesh, in one collective."""
        if self._data_group is None:
            return batch["t"], batch["e"], batch["valid"]
        rows = torch.stack([batch["t"].float(), batch["e"].float(),
                            batch["valid"].float()], 1)
        t, e, v = all_gather(rows, self._data_group).unbind(1)
        return t.to(batch["t"].dtype), e.to(batch["e"].dtype), v > 0.5

    def loss(self, batch: dict) -> Tuple[torch.Tensor, torch.Tensor]:
        """(loss, raw logits [B, K]) of one batch on the device; on a mesh,
        the global batch's (the logits of every data rank's bags)."""
        feats, kws = feats_inputs(self.model, batch)
        raw = _logits(self.model(feats, batch["mask"], train=True, **kws, **model_extras(batch)))
        t, e, valid = self.labels(batch)
        raw = gather_rows(raw, self._data_group)
        vl = {}
        if self.uses_vl:
            vl = {"logit_scale": self.model.get_logit_scale(),
                  "query_div_fn": self.model.query_div_loss}
        loss = self.objective(raw, t, e, valid.to(raw.dtype), **vl)
        return loss, raw

    def reduce_grads(self) -> None:
        """On a mesh: the model-partial gradients summed over the model
        group, then every trainable gradient over the data group."""
        params = self._trainable()[1]
        self._reduce(params, [p.grad for p in params])

    def _reduce(self, params, tensors) -> None:
        """`reduce_grads`'s sums of `tensors`, one a parameter of `params`
        (gradients, or Hessian-vector products), in place."""
        if self.mesh is None:
            return
        partial = {id(p) for p in self._model_partial}
        sum_tensors_([t for p, t in zip(params, tensors) if id(p) in partial],
                     self.mesh.model_group)
        sum_tensors_(tensors, self._data_group)

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
        optimizer's order, else drawn), on a mesh of the rank's objective
        share (the loss / D) and summed as `reduce_grads` sums, then the
        optimizer's step."""
        names, params = self._trainable()
        with disable_kernels():
            loss, raw = self.loss(batch)
            grads, diag = hutchinson_hessian_diag(
                loss / self.n_data, params, names, z=hessian_z, generator=self._hessian_gen,
                reduce=lambda ts: self._reduce(params, ts))
        for p, g in zip(params, grads):
            p.grad = g
        self.optimizer.step(hessian=dict(zip(params, diag)))
        return loss.detach(), raw.detach()

    def train_step(self, batch: dict,
                   hessian_z: Optional[Sequence[torch.Tensor]] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One update on `batch` (tensors on any device, moved here).
        Returns (loss, raw logits [B, K]), both detached and on the device,
        with no host synchronisation; on a mesh, the global batch's loss
        (undivided) and logits.  `hessian_z`: the adahessian step's z (see
        `hessian_step`)."""
        self.model.train()
        batch = make_global_batch(batch, self.mesh, self.device, self.seq_parallel)
        self.optimizer.zero_grad(set_to_none=True)
        if self.needs_hessian:
            return self.hessian_step(batch, hessian_z)
        accum = self.accum_steps
        if accum <= 1:
            loss, raw = self.loss(batch)
            (loss / self.n_data).backward()
            loss, raw = loss.detach(), raw.detach()
        else:
            B = batch["feats"].shape[0]
            if B % accum != 0:
                raise ValueError(f"a batch of {B} bags does not split into "
                                 f"{accum} micro-batches")
            mb = B // accum
            # the weights in f64: an f32 2/3 would round each micro-batch's
            # share (a float64 model then accumulates exactly)
            w_tot = torch.clamp(self.labels(batch)[2].sum().double(), min=1.0)
            loss, raws = 0.0, []
            for i in range(accum):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                w = self.labels(micro)[2].sum().double()
                loss_i, raw_i = self.loss(micro)
                (loss_i * (w / w_tot) / self.n_data).backward()
                loss = loss + (loss_i.detach() * (w / w_tot)).to(loss_i.dtype)
                raws.append(raw_i.detach())
            raw = torch.cat(raws)
            if self.n_data > 1:  # micro-batch-major to data-rank-major (the batches') rows
                raw = raw.reshape(accum, self.n_data, mb, *raw.shape[1:]).transpose(0, 1) \
                    .reshape(raw.shape)
        self.reduce_grads()
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

    def prepare(self, bags: Sequence[Bag], cluster_ids: Optional[Sequence[np.ndarray]] = None,
                edge_lists: Optional[Sequence[np.ndarray]] = None) -> dict:
        """The request's padded batch on the device; with `cluster_ids` (one
        [n_i] array a bag) or `edge_lists` (one [2, E_i] array a bag) also
        the batch entries the batcher builds from cluster and graph bags."""
        batch = pad_request(bags, self.feats_dtype, self.precompute_inv, self.device)
        B, N = batch["mask"].shape
        if cluster_ids is not None:
            cid = np.zeros((B, N), np.int32)
            for j, c in enumerate(cluster_ids):
                cid[j, :len(c)] = c
            batch["cluster_id"] = torch.from_numpy(cid).to(self.device)
        if edge_lists is not None:
            E = max(1, max(e.shape[1] for e in edge_lists))
            ei, ev = np.zeros((B, 2, E), np.int32), np.zeros((B, E), np.bool_)
            for j, e in enumerate(edge_lists):
                ei[j, :, :e.shape[1]], ev[j, :e.shape[1]] = e, True
            batch["edge_index"] = torch.from_numpy(ei).to(self.device)
            batch["edge_valid"] = torch.from_numpy(ev).to(self.device)
        return batch

    def forward(self, batch: dict) -> Dict[str, torch.Tensor]:
        """Device tensors in, device tensors out (no host synchronisation)."""
        if self._text is None:
            self.text_precompute()
        feats, kws = feats_inputs(self.model, batch)
        if self._text is not None:
            kws["text_features"], kws["query"] = self._text
        with torch.inference_mode():
            return incidence_outputs(_logits(self.model(feats, batch["mask"], **kws,
                                                        **model_extras(batch))))

    def predict(self, bags: Sequence[Bag], **aux) -> Dict[str, np.ndarray]:
        """One request: bags as f32 [n_i, D] arrays or QuantizedBags (and
        `prepare`'s cluster_ids or edge_lists) -> {"logits", "probs",
        "survival"}, each [B, K] f32 on the host."""
        out = self.forward(self.prepare(bags, **aux))
        return {k: v.float().cpu().numpy() for k, v in out.items()}
