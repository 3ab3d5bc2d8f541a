"""Train the model of an experiment config for a few steps.

    python -m vlsa_tpu_torch.runner.train --config configs/IFMLE/tcga_blca/cfg_vlsa_conch.yaml \\
        --steps 3 [--fold 0] [--device cuda|cpu]

The counterpart of the training loop of vlsa_tpu/runner/base.py with its
handlers' label, model, loss and freezing rules.  `task: vlsa` trains the
flagship VLSA (the fold's label bins set the rank count; SurvIFMLE +
SurvEMD); `task: sa` the SA baseline's DeepMIL/ABMIL
(configs/IFMLE/<cohort>/cfg_sa_base_conch.yaml: the bins set the head's
width; SurvIFMLE), or another network of the zoo (`deepmil_network`
TransMIL, ILRA; DeepAttnMISL with `data_mode: cluster` and
`path_cluster`, PatchGCN with `data_mode: graph` and `path_graph`),
through `runner.sa`; `task: clf` the same networks on one labelled bag a
slide with the classification losses, through `runner.clf`.  The
training split's bags (the config's `path_patch`, `synthetic://`
included) go through the batcher
`bp_every_batch` at a time, and each step is one update of the config's
losses with its optimizer.  The weights are random, from the config's seed.
Prints one JSON line per step and a summary line with the kernels' launch
counts.  No evaluation, checkpoint or LR schedule runs here: the whole run
lifecycle (epochs, the survival evaluator, checkpoints, ReduceLROnPlateau,
early stopping, prediction CSVs) is `python -m vlsa_tpu_torch.main`, whose
handlers (runner/base.py) build on `Trainer`.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import fetch_kws, load_config, training_config
from ..data.bags import SurvBagDataset, prepare_surv_dataset
from ..data.label_converter import MetaSurvData
from ..data.pipeline import BagBatcher
from ..data.splits import read_file_data_splitting
from ..losses import load_loss
from ..ops import abmil, coattn
from ..optim import create_optimizer, frozen_mask_from_cfg
from ..parallel.multihost import process_shard_info
from ..parallel.sharding import seed_dropout, shard_params
from ..utils.device import resolve_device
from .engine import TrainEngine, make_objective, make_output_converter


def build_surv_meta(cfg: dict, data_split: dict) -> MetaSurvData:
    """VLSA's labels: the label table with discrete bins from the training
    split; the prompt learner's rank count follows the bin count."""
    from . import sa  # imported here: runner.sa's SAHandler builds on this module
    meta = sa.build_surv_meta(cfg, data_split)
    for learner in ("coop", "adapter"):
        key = f"vlsa_pmt_learner_{learner}_num_ranks"
        if key in cfg:
            cfg[key] = meta.num_bins
    return meta


def frozen_paths(cfg: dict) -> List[str]:
    """The config's freeze flags as parameter name prefixes (none for SA
    and CLF)."""
    if cfg["task"] != "vlsa":
        return []
    arch = cfg["arch"].lower()
    paths = []
    if fetch_kws(cfg, prefix=f"{arch}_txt_encoder").get("frozen", True):
        paths.append("prompt_encoder")
    if fetch_kws(cfg, prefix=f"{arch}_img_encoder").get("frozen", False):
        paths.append("mil_encoder")
    if cfg.get(f"{arch}_frozen_logit_scale", False):
        paths.append("logit_scale")
    coop = fetch_kws(cfg, prefix=f"{arch}_pmt_learner_coop")
    if cfg.get(f"{arch}_pmt_learner_name") == "CoOp":
        if coop.get("frozen_context_embeds"):
            paths.append("prompt_learner/context_embeds")
        if coop.get("frozen_rank_embeds"):
            paths.append("prompt_learner/rank_embeds")
    return paths


def load_losses(cfg: dict):
    """({name: loss fn}, {name: weight}) from `loss_type` ("A-B") and the
    `loss_<name>_*` keys."""
    names = cfg["loss_type"].split("-") if isinstance(cfg["loss_type"], str) \
        else list(cfg["loss_type"])
    kws = {"loss_type": names}
    weights = {}
    for name in names:
        kws[name] = fetch_kws(cfg, prefix=f"loss_{name.lower()}")
        weights[name] = cfg.get(f"loss_{name.lower()}_weight", 1)
    return load_loss(cfg["task"], **kws), weights


def make_dataset(cfg: dict, meta: MetaSurvData, patient_ids,
                 train: bool = False) -> SurvBagDataset:
    """The bags of `patient_ids` from the config's `path_patch`; for the
    training split (`train`), the few-shot sample of `num_shot` patients a
    time bin when that is > 0, drawn with `seed_shot` (default 42)."""
    if not train:
        return prepare_surv_dataset(patient_ids, cfg, meta)
    return prepare_surv_dataset(patient_ids, cfg, meta, num_shot=cfg.get("num_shot", -1),
                                seed_shot=cfg.get("seed_shot", 42))


def make_batcher(dataset: SurvBagDataset, cfg: dict, shuffle: bool,
                 pin_memory: bool = False, mesh=None) -> BagBatcher:
    """The config's batcher: `bp_every_batch` bags a batch when training
    (shuffled by the seed and the batcher's own epoch count), an evaluation
    pass's `eval_batch_size` (default `bp_every_batch`) in order; built
    `prefetch` (default 2) batches ahead by a background thread, in
    page-locked memory with `pin_memory` (for a model on the card).  On a
    `mesh` the data rank d loads only its slice of every global batch
    (num_shards D, shard_index d; vlsa_tpu/runner/base.py:253-262); a
    training batcher with `accum_steps` > 1 loads its shares of the global
    batch's micro-batches instead (`micro_batches`), so that the gathered
    micro-batches are vlsa_tpu's contiguous ones."""
    shard_index, num_shards = process_shard_info(mesh)
    batch_size = cfg.get("bp_every_batch", 32)
    micro = 1
    if not shuffle:
        batch_size = cfg.get("eval_batch_size", batch_size)
    elif num_shards > 1:
        micro = cfg.get("accum_steps", 1)
    return BagBatcher(
        dataset, batch_size=batch_size, shuffle=shuffle,
        seed=cfg["seed"], min_bucket=cfg.get("min_bucket", 256),
        max_bucket=cfg.get("max_bucket"), fixed_bucket=cfg.get("fixed_bucket"),
        feats_dtype=cfg.get("feats_dtype", "float32"),
        # DeepMIL's pooling is unnormalised: SA and CLF need no 1/||x|| rows
        precompute_inv=cfg.get("feats_precompute_inv", True) and cfg["task"] == "vlsa",
        overflow=cfg.get("bag_overflow", "error"), prefetch=cfg.get("prefetch", 2),
        pin_memory=pin_memory, num_shards=num_shards, shard_index=shard_index,
        micro_batches=micro)


def mesh_parallelism(cfg: dict, mesh) -> Tuple[bool, bool]:
    """(tensor_parallel, seq_parallel) of the config's `mesh`: both on by
    default where the model axis exists (vlsa_tpu/runner/base.py:195-199)."""
    m = cfg.get("mesh") or {}
    n_model = 1 if mesh is None else mesh.n_model
    tp = bool(m.get("tensor_parallel", n_model > 1))
    sp = bool(m.get("seq_parallel", n_model > 1)) and n_model > 1
    return tp, sp


def route_seq_parallel(model: nn.Module, mesh) -> Tuple[bool, Tuple[str, ...]]:
    """Bind the mesh into the model's pooling, so that it pools the rank's
    chunk of the patch axis (vlsa_tpu/runner/base.py:218-235): VLFAN's
    co-attention (parallel.coattn_sp) or DeepMIL's ABMIL pooling
    (parallel.abmil_sp), the model itself or its `mil_encoder`.  Returns
    (routed, the names of the projecter's parameters before the pool, whose
    gradients the model group sums).  Another model computes the whole bag
    on every rank of its model group."""
    from ..models.mil import VLFAN, DeepMIL

    def routable(m):
        return isinstance(m, VLFAN) or (isinstance(m, DeepMIL) and m.pooling == "attention")

    for prefix, mod in (("", model), ("mil_encoder.", getattr(model, "mil_encoder", None))):
        if routable(mod):
            mod.sp_mesh = mesh
            if isinstance(mod, DeepMIL):
                mod.sigma.sp_mesh = mesh
            partial = tuple(f"{prefix}feat_proj.{n}" for n, _ in mod.feat_proj.named_parameters()
                            ) if mod.use_feat_proj else ()
            return True, partial
    print("[setup] seq_parallel: model has no VLFAN/ABMIL attention pooling; every rank of a "
          "model group computes the whole bag")
    return False, ()


class Trainer:
    """Data, model, losses, optimizer and engine of one training run, built
    from a config whose placeholders and grid lists are resolved
    (`training_config`, or a handler's setup).

    `data_rng` (seeded by the config's seed) draws what a classification
    dataset draws: runner.clf's path switch, masking and label corruption.

    `mesh` (parallel.sharding.Mesh): the batcher loads the rank's slice,
    the pooling is routed sequence parallel and the text tower tensor
    parallel as the config's `mesh` says (`mesh_parallelism`), Dropout is
    reseeded by the data index, and the engine sums the gradients over the
    groups."""

    def __init__(self, cfg: dict, device=None, state_dict: Optional[dict] = None, mesh=None):
        task = cfg["task"]
        if task not in ("vlsa", "sa", "clf"):
            raise NotImplementedError(f"task {task!r}: this port trains vlsa, sa and clf")
        from . import clf, sa  # see build_surv_meta
        self.cfg = cfg
        self.device = resolve_device(device)
        self.data_split = read_file_data_splitting(cfg["data_split_path"])
        self.data_rng = np.random.RandomState(cfg["seed"])
        if task == "clf":
            self.meta = None
            self.dataset = clf.make_clf_dataset(cfg, self.data_split["train"], "train",
                                                self.data_rng)
        else:
            self.meta = (sa.load_meta(cfg, self.data_split) if task == "sa"
                         else build_surv_meta(cfg, self.data_split))
            self.dataset = make_dataset(cfg, self.meta, self.data_split["train"], train=True)
        self.mesh = mesh
        self.batcher = make_batcher(self.dataset, cfg, shuffle=True,
                                    pin_memory=self.device.type == "cuda", mesh=self.mesh)
        if task in ("sa", "clf"):
            self.model = sa.build_model(cfg, device=self.device, state_dict=state_dict)
        else:
            from . import vlsa  # runner.vlsa's handler builds on this module too
            self.model = vlsa.build_model(cfg, device=self.device, state_dict=state_dict)
        self.model.train()
        self.seq_parallel, model_partial = False, ()
        if self.mesh is not None:
            tp, sp = mesh_parallelism(cfg, self.mesh)
            if sp:
                self.seq_parallel, model_partial = route_seq_parallel(self.model, self.mesh)
            fixed = cfg.get("fixed_bucket")
            if self.seq_parallel and fixed is not None and fixed % self.mesh.n_model:
                raise ValueError(f"fixed_bucket {fixed} does not split over "
                                 f"model={self.mesh.n_model}")
            model_partial += shard_params(self.model, self.mesh, tp)
            seed_dropout(self.model, self.mesh)
        self.frozen = frozen_mask_from_cfg(self.model, frozen_paths(cfg))
        self.loss_fns, self.loss_weights = load_losses(cfg)
        if task == "clf":  # on the raw logits
            objective = clf.make_clf_objective(self.loss_fns, self.loss_weights)
        else:
            objective = make_objective(self.loss_fns, self.loss_weights,
                                       make_output_converter(cfg.get("net_output_converter")))
        # a model with every parameter frozen (zero-shot) has nothing to
        # optimize: no optimizer and no training engine
        self.optimizer = self.engine = None
        if any(p.requires_grad for p in self.model.parameters()):
            self.optimizer = create_optimizer(cfg["opt_name"], cfg["opt_lr"],
                                              cfg.get("opt_weight_decay", 0.0), self.model)
            self.engine = TrainEngine(
                self.model, self.optimizer, objective, accum_steps=cfg.get("accum_steps", 1),
                needs_hessian=cfg["opt_name"].lower() == "adahessian",
                hessian_seed=cfg.get("seed") or 0, mesh=self.mesh,
                seq_parallel=self.seq_parallel, model_partial=model_partial)

    def batches(self) -> Iterator[dict]:
        """Training batches, epoch after epoch."""
        while True:
            yield from self.batcher


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--fold", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = training_config(load_config(args.config), args.fold)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device)
    build_s = time.perf_counter() - t0
    if trainer.engine is None:
        raise ValueError("every parameter of the model is frozen: there is nothing to train")
    coattn.reset_launches()
    abmil.reset_launches()
    batches = trainer.batches()
    records = []
    for step in range(args.steps):
        t = time.perf_counter()
        batch = next(batches)
        t_mid = time.perf_counter()
        loss, _raw = trainer.engine.train_step(batch)
        loss = float(loss)  # waits for the step's work on the device
        rec = {"step": step, "loss": loss, "bags": int(batch["valid"].sum()),
               "bucket": int(batch["mask"].shape[1]),
               "prep_ms": 1e3 * (t_mid - t), "step_ms": 1e3 * (time.perf_counter() - t_mid)}
        if not np.isfinite(loss):
            raise RuntimeError(f"step {step}: the loss is not finite")
        records.append(rec)
        print(json.dumps(rec), flush=True)
    summary = {"device": str(device), "fold": args.fold, "feats_dtype": trainer.batcher.feats_dtype,
               "num_bins": trainer.meta.num_bins if trainer.meta is not None else None,
               "train_bags": len(trainer.dataset),
               "build_s": build_s, "steps": args.steps,
               "median_step_ms": float(np.median([r["step_ms"] for r in records])),
               "coattn_launches": dict(coattn.LAUNCHES),
               "coattn_bwd_launches": dict(coattn.LAUNCHES_BWD),
               "coattn_bwd_dx_launches": dict(coattn.LAUNCHES_DX),
               "abmil_launches": dict(abmil.LAUNCHES),
               "abmil_bwd_launches": dict(abmil.LAUNCHES_BWD)}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
