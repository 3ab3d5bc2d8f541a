"""The run lifecycle (counterpart of vlsa_tpu/runner/base.py): config
placeholders, data, model, losses, optimizer, LR schedule, evaluator; the
epoch loop with an evaluation pass of every split each epoch, early
stopping, checkpoints and `auto_resume`; the final evaluation with the
metric files and prediction CSVs.

The run's files go under `save_path` (`test_save_path` in test mode), named
as vlsa_tpu names them: `<run>_model-{last,best}.ckpt` (runner/ckpt.py),
`<run>_metrics-{last,best}.txt`, `print_config.txt`, `config.yaml`,
`metrics.jsonl` and, with `save_prediction`,
`<task>_<run>_{last,best}_pred_<split>.csv`.  A training step is
`TrainEngine.train_step` on one batch of `bp_every_batch` bags; an
evaluation pass runs the model in eval mode under `torch.inference_mode()`
with VLSA's text prototypes and queries computed once from the current
weights, and puts the model back in train mode after it.

Few-shot runs (`num_shot > 0`) train on the training split's few-shot
sample (data/bags.py::FewShotSurvBagDataset) and evaluate it as the train
split.  Zero-shot runs (`num_shot: 0`) train nothing: they evaluate the
test split once, `run_name` "zero-shot", and write
`zero-shot_metrics-best.txt` and `<task>_zero-shot_last_pred_test.csv`
(vlsa_tpu's names) and no checkpoint.  A model with every parameter
frozen gets no optimizer.  Not ported: wandb (vlsa_tpu leaves it off
unless VLSA_TPU_DISABLE_WANDB=0; the card's machine has no wandb).
Checkpoints are written in torch's format whatever `ckpt_backend` says;
vlsa_tpu's msgpack files and orbax directories are read wherever vlsa_tpu
reads them (runner/ckpt.py).  Resuming from one of them puts its optax
state into the torch optimizer (optim/optax_state.py): the moments, the
step counts and the learning rate, which then goes on as vlsa_tpu's does
(a fresh ReduceLROnPlateau that writes the rate only when it reduces it).
`auto_resume` looks for the file vlsa_tpu looks for, so it does not find
an orbax run's `.orbax` directory, as vlsa_tpu does not.

Multi-process runs (vlsa_tpu/runner/base.py:184-262, :398-451): with a
`mesh` ({data: D, model: M, tensor_parallel, seq_parallel, dcn}) the
process is one rank of a D x M grid (parallel/sharding.py), joined through
`distributed` ('auto' or a dict, parallel/multihost.py) or by
`python -m vlsa_tpu_torch.main`, which starts the ranks of a mesh with no
`distributed` itself.  Each data rank trains and evaluates its slice of
every batch; the pooling is routed sequence parallel and the text tower
tensor parallel (runner/train.py::Trainer); the predictions of every pass
are gathered over the data group, so every rank computes the same metrics
and ReduceLROnPlateau and early stopping agree.  Only global rank 0 writes
the run's files, and only it reads a checkpoint: it sends what it read to
every rank (`_read_checkpoint`), so the ranks resume at one epoch and
evaluate one set of weights, whether or not they share its save path or
its host, and none meets a file rank 0 is still writing.  Every rank
returns (and `main` prints) the metrics.
"""
from __future__ import annotations

import functools
import os
import os.path as osp
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..config import (DATASET_CFG, fill_placeholder, print_config, print_metrics,
                      rename_keys, save_config)
from ..config_schema import validate_config
from ..data.io import load_init_text, save_prediction_surv
from ..data.pipeline import release_pinned_batches
from ..optim import EarlyStopping, ReduceLROnPlateau
from ..optim.optax_state import load_optax_state
from ..parallel.collectives import broadcast_object
from ..parallel.multihost import (collect_global, host_allgather, make_global_batch,
                                  maybe_initialize_distributed, rank_device)
from ..parallel.sharding import make_mesh
from ..utils.device import resolve_device
from ..utils.observability import JsonlLogger, configure_debug, maybe_profile
from ..utils.seed import seed_everything
from .ckpt import add_prefix_to_filename, load_checkpoint, merge_state, save_checkpoint
from .engine import GRAPH_KEYS, _logits, feats_inputs, make_output_converter, model_extras
from .train import Trainer, make_batcher, make_dataset, mesh_parallelism

# the batch entries an evaluation pass sends to the model
_MODEL_INPUTS = ("feats", "feats_scale", "feats_inv", "mask") + GRAPH_KEYS


def setup_mesh(cfg: dict, device=None):
    """The run's rank grid (None without a `mesh` or `distributed`): joins
    the process group of `distributed` first, before any device is
    touched, then builds the D x M grid of the config's `mesh` (the world's
    ranks along `data` without one) and prints vlsa_tpu's `[setup] mesh:`
    line.  None also for a grid of one rank."""
    joined = maybe_initialize_distributed(cfg, device)
    m = cfg.get("mesh")
    if not m and not joined:
        return None
    m = m or {}
    mesh = make_mesh(n_data=m.get("data"), n_model=m.get("model", 1), dcn_data=m.get("dcn"))
    tp, sp = mesh_parallelism(cfg, mesh)
    print(f"[setup] mesh: data={mesh.n_data} model={mesh.n_model} "
          f"(tensor_parallel={tp}, seq_parallel={sp})")
    return mesh if mesh.size > 1 else None


def _fill_paths(cfg: dict) -> None:
    """The `{0}` (dataset name), `{1}` (disk location), `{2}` (split seed) and
    `{3}` (query count) placeholders of a training run's config."""
    dataset_name = cfg["dataset_name"]
    cfg["save_path"] = fill_placeholder(cfg["save_path"], dataset_name[5:], ind="{0}")
    for key in ("path_patch", "path_coord", "path_cluster", "path_graph",
                "path_table", "data_split_path", "vlsa_img_encoder_query_text_load_idx"):
        if key in cfg:
            cfg[key] = fill_placeholder(cfg[key], dataset_name, ind="{0}")
    for key in ("path_patch", "path_cluster", "path_graph", "path_coord"):
        if key in cfg and dataset_name in DATASET_CFG:
            cfg[key] = fill_placeholder(
                cfg[key], DATASET_CFG[dataset_name]["disk_location"], ind="{1}")
    cfg["data_split_path"] = fill_placeholder(
        cfg["data_split_path"], cfg["data_split_seed"], ind="{2}")
    key = "vlsa_img_encoder_num_query"
    if key in cfg:
        if cfg[key] is None:
            init_texts = load_init_text(cfg["vlsa_img_encoder_query_text_load_path"],
                                        key=cfg["vlsa_img_encoder_query_text_load_idx"])
            cfg[key] = len(init_texts)
            print(f"[info] null `{key}` filled with {cfg[key]}.")
        elif dataset_name in DATASET_CFG:
            cfg[key] = int(fill_placeholder(
                cfg[key], DATASET_CFG[dataset_name]["num_query"], ind="{3}"))


def _releases_pinned_batches(run):
    """A run's entry point that, on the card, returns the page-locked blocks
    of its batches to the system at its end (they serve every epoch of the
    run; data/pipeline.py::release_pinned_batches)."""
    @functools.wraps(run)
    def wrapped(self, *args, **kws):
        try:
            return run(self, *args, **kws)
        finally:
            if self.device.type == "cuda":
                release_pinned_batches()
    return wrapped


class BaseHandler:
    """The lifecycle; VLSAHandler and SAHandler specialise the hooks.

    `device`: CUDA unless "cpu" is given (raises without a card).
    `state_dict`: initial weights in place of the seeded ones (for example a
    vlsa_tpu parameter tree through utils.weights.state_dict_from_jax).  On
    a mesh the device is the rank's (its card, or the CPU when asked for)."""

    def __init__(self, cfg: dict, device=None, state_dict: Optional[dict] = None):
        validate_config(cfg, cfg.get("task", ""), strict=cfg.get("strict_config", False))
        self.mesh = setup_mesh(cfg, device)
        self.is_main = self.mesh is None or self.mesh.rank == 0  # writes the run's files
        self.device = rank_device(resolve_device(device))
        seed_everything(cfg["seed"])
        configure_debug(cfg)

        print(f"[setup] dataset name: {cfg['dataset_name']}.")
        if not cfg.get("test", False):
            _fill_paths(cfg)
            base = cfg["save_path"]
        else:
            if "{}" in str(cfg.get("test_load_path", "")):
                cfg["test_load_path"] = cfg["test_load_path"].format(cfg["data_split_seed"])
            base = cfg["test_save_path"]
        if self.is_main:
            os.makedirs(base, exist_ok=True)
        load_base = cfg.get("test_load_path", base) if cfg.get("test", False) else base
        self.last_ckpt_path = osp.join(load_base, "model-last.ckpt")
        self.best_ckpt_path = osp.join(load_base, "model-best.ckpt")
        self.last_metrics_path = osp.join(base, "metrics-last.txt")
        self.best_metrics_path = osp.join(base, "metrics-best.txt")
        self.config_path = osp.join(base, "print_config.txt")
        self.config_yaml = osp.join(base, "config.yaml")
        self.jsonl = JsonlLogger(osp.join(base, "metrics.jsonl") if self.is_main else None)
        print(f"[setup] path to save: {base}")

        # data, model, losses, optimizer and engine: runner.train's wiring
        self.trainer = Trainer(cfg, self.device, state_dict=state_dict, mesh=self.mesh)
        self.data_split, self.data_meta = self.trainer.data_split, self.trainer.meta
        self.model, self.optimizer = self.trainer.model, self.trainer.optimizer
        self.engine = self.trainer.engine
        self.loss, self.loss_weight = self.trainer.loss_fns, self.trainer.loss_weights
        self.add_network_loss(cfg)
        self.lr_value = cfg["opt_lr"]
        self.steplr = self.func_load_lrs(cfg)
        self.output_converter = make_output_converter(cfg.get("net_output_converter"))
        self.evaluator, self.metrics_list, self.ret_metrics = self.func_load_evaluator(
            cfg, meta_data=self.data_meta)

        self._check_arguments(cfg)
        self.uid: Dict[str, list] = {}
        # seconds of each epoch (wall; waiting for batches, `prep_s`; the
        # producer building them, `build_s`) and of each evaluation pass
        self.timings: Dict[str, list] = {"epochs": [], "eval": []}
        self.cfg = cfg
        if self.is_main:
            print_config(cfg, print_to_path=self.config_path)
            save_config(cfg, self.config_yaml)

    # ------------------------------------------------------------------ hooks
    def _check_arguments(self, cfg):
        pass

    def add_network_loss(self, cfg):
        pass

    def func_load_evaluator(self, cfg, meta_data=None):
        raise NotImplementedError

    def eval_kws(self) -> dict:
        """Extra arguments of the evaluator's `compute`."""
        return {}

    def prepare_dataset(self, patient_ids, set_name: str):
        """The dataset of split `set_name` (the training split's is the
        trainer's)."""
        return make_dataset(self.cfg, self.data_meta, patient_ids, train=set_name == "train")

    def _finalize_cltor(self, cltor: dict) -> dict:
        """A pass's collected arrays as the evaluator takes them."""
        return cltor

    def func_load_lrs(self, cfg):
        if not cfg.get("lrs"):
            print("[setup] learning rate scheduler is disabled.")
            return None
        return ReduceLROnPlateau(cfg["opt_lr"], factor=cfg.get("lrs_factor", 0.5),
                                 patience=cfg.get("lrs_patience", 10),
                                 optimizer=self.optimizer)

    def get_logit_scale_value(self) -> float:
        assert hasattr(self.model, "logit_scale"), (
            "logit-scale-aware losses/evaluators need a model with a `logit_scale` "
            "parameter (VL models have one)")
        return float(torch.exp(self.model.logit_scale.detach()).cpu())

    # ------------------------------------------------------------------ exec
    @_releases_pinned_batches
    def exec(self):
        cfg = self.cfg
        print(f"[exec] with task = {cfg['task']}, arch = {cfg['arch']}.")
        train_set = self.trainer.dataset
        self.uid["train"] = train_set.uid
        test_set = self.prepare_dataset(self.data_split["test"], "test")
        self.uid["test"] = test_set.uid
        val_set = None
        if "validation" in self.data_split:
            val_set = self.prepare_dataset(self.data_split["validation"], "validation")
            self.uid["validation"] = val_set.uid

        run_name = "train"
        zero_shot = False
        if cfg.get("force_to_skip_training"):
            print("[exec] warning: your training is skipped...")
        elif cfg.get("num_shot", -1) == 0:
            zero_shot = True
            run_name = "zero-shot"
            print("[exec] warning: at zero-shot mode, your training is skipped...")
        else:
            val_loaders = {"validation": val_set, "test": test_set}
            if cfg.get("eval_training_loader_per_epoch"):
                val_loaders["eval-train"] = train_set
                self.uid["eval-train"] = train_set.uid
            self._run_training(cfg["epochs"], "train", val_loaders=val_loaders,
                               val_name="validation", save_ckpt=True,
                               early_stop=bool(cfg.get("es")), run_name=run_name)
        if zero_shot:
            return self._eval_all({"test": test_set}, ckpt_type="zero-shot",
                                  run_name=run_name)
        evals = {"train": train_set, "validation": val_set, "test": test_set}
        return self._eval_all(evals, ckpt_type=cfg.get("ckpt_for_eval", "last"),
                              run_name=run_name)

    @_releases_pinned_batches
    def exec_test(self):
        """Evaluate the split `test_path` with the checkpoint of `test_load_path`."""
        cfg = self.cfg
        # as vlsa_tpu: the split named "train" is the few-shot sample in a few-shot run
        test_set = self.prepare_dataset(self.data_split[cfg["test_path"]], cfg["test_path"])
        self.uid["exec-test"] = test_set.uid
        return self._eval_all({"exec-test": test_set},
                              ckpt_type=cfg.get("ckpt_for_eval", "last"), test_mode=True)

    # ------------------------------------------------------------------ train
    def _run_training(self, epochs, name_loader, val_loaders=None, val_name=None,
                      save_ckpt=True, early_stop=False, run_name="train"):
        cfg = self.cfg
        if self.engine is None:
            raise ValueError("every parameter of the model is frozen: there is nothing to "
                             "train (num_shot: 0 evaluates zero-shot)")
        es = EarlyStopping(warmup=cfg.get("es_warmup", 0),
                           patience=cfg.get("es_patience", 20),
                           start_epoch=cfg.get("es_start_epoch", 0),
                           verbose=cfg.get("es_verbose", False)) if early_stop else None
        self.es = es
        # a new batcher, as vlsa_tpu makes one: its shuffle is keyed by its own
        # epoch count, so a resumed run's first epoch takes epoch 1's order
        train_batcher = make_batcher(self.trainer.dataset, cfg, shuffle=True,
                                     pin_memory=self.device.type == "cuda", mesh=self.mesh)
        n_train = len(train_batcher.dataset)
        last_epoch = -1
        start_epoch = 0
        if cfg.get("auto_resume"):
            # restart from the run's last checkpoint (model, Adam's moments, epoch)
            resumed = self.resume_model("last", run_name, missing_ok=True)
            if resumed is not None:
                start_epoch = resumed
                print(f"[train] auto-resume: continuing from epoch {start_epoch}")
        for epoch in range(start_epoch, epochs):
            last_epoch = epoch + 1
            t0 = time.time()
            with maybe_profile(cfg.get("profile_dir") if epoch == 1 else None):
                train_cltor, prep_s = self._train_each_epoch(train_batcher)
            build_s = train_batcher.build_s
            dt = time.time() - t0
            sps = n_train / max(dt, 1e-9)
            print(f"[train] epoch {epoch+1}/{epochs}: {sps:.2f} slides/sec")
            self.jsonl.log({"event": "epoch", "epoch": epoch + 1,
                            "slides_per_sec": sps, "wall_sec": dt})
            self.timings["epochs"].append({"epoch": epoch + 1, "wall_s": dt, "prep_s": prep_s,
                                           "build_s": build_s, "slides_per_sec": sps})
            for k_c, v_c in train_cltor.items():
                self._eval_and_print(v_c, name=f"{name_loader}/{k_c}", at_epoch=epoch + 1)

            monitor = None
            for k, ds in (val_loaders or {}).items():
                if ds is None:
                    continue
                cltor = self.test_model(ds, k)
                for k_c, v_c in cltor.items():
                    met_main, met_loss = self._eval_and_print(
                        v_c, name=f"{k}/{k_c}", at_epoch=epoch + 1)
                    if k == val_name and k_c == "pred":
                        monitor = 0
                        monitor += met_loss if "loss" in cfg.get("monitor_metrics", "loss") else 0
                        monitor += -met_main if "main" in cfg.get("monitor_metrics", "") else 0
            if self.steplr is not None and monitor is not None:
                self.lr_value = self.steplr.step(monitor)
            if es is not None and monitor is not None:
                es(epoch, monitor)
                if es.save_ckpt():
                    self._save_model(epoch + 1, "best", run_name)
                if es.stop():
                    break
            if cfg.get("auto_resume") and save_ckpt:
                # a last checkpoint each epoch, so a restart loses at most one
                self._save_model(epoch + 1, "last", run_name)
        if save_ckpt:
            self._save_model(last_epoch, "last", run_name)
            print(f"[train] {run_name} last model saved at epoch {last_epoch}")

    def _train_each_epoch(self, train_batcher):
        """One pass over the training split: (collected predictions, seconds
        the loop waited for a batch).  The batcher's producer builds batches
        while the steps run, so the wait is the part of building that the
        steps do not hide (`train_batcher.build_s` is all of it)."""
        all_raw, all_gt, all_idx = [], [], []
        prep_s = 0.0
        batches = iter(train_batcher)
        while True:
            t = time.perf_counter()
            batch = next(batches, None)
            prep_s += time.perf_counter() - t
            if batch is None:
                break
            _loss, raw = self.engine.train_step(batch)
            self._collect(batch, raw.float().cpu().numpy(), all_raw, all_gt, all_idx)
        return {"pred": self._cltor(all_raw, all_gt, all_idx, "train")}, prep_s

    def _collect(self, batch, raw, all_raw, all_gt, all_idx) -> None:
        """A batch's valid rows.  On a mesh `raw` holds the global batch's
        rows (`collect_global`) and the labels are gathered over the data
        group too, in one collective (t, e, idx and valid as f64 columns:
        exact for f32 times and int32 indices)."""
        labels = np.stack([batch["t"].numpy(), batch["e"].numpy(), batch["idx"].numpy(),
                           batch["valid"].numpy()], 1).astype(np.float64)
        if self.mesh is not None:
            labels = host_allgather(labels, self.mesh)
        valid = labels[:, 3] > 0.5
        all_raw.append(raw[valid])
        all_gt.append(labels[valid, :2].astype(batch["t"].numpy().dtype))
        all_idx.append(labels[valid, 2].astype(batch["idx"].numpy().dtype))

    def _cltor(self, all_raw, all_gt, all_idx, loader_name) -> dict:
        """The pass's collected arrays; the output converter runs once on all
        of them."""
        all_raw = np.concatenate(all_raw)
        all_pred = self.output_converter(torch.from_numpy(all_raw)).numpy()
        uids = [self.uid[loader_name][i] for i in np.concatenate(all_idx)]
        return self._finalize_cltor({"y": np.concatenate(all_gt), "raw_y_hat": all_raw,
                                     "y_hat": all_pred, "uid": uids, "name": loader_name})

    def test_model(self, dataset, loader_name, ckpt_path=None):
        """An evaluation pass over `dataset` (after loading `ckpt_path`)."""
        if ckpt_path is not None:
            merge_state(self.model, self._read_checkpoint(ckpt_path)["model"])
        t0 = time.perf_counter()
        model, mesh = self.model, self.mesh
        batcher = make_batcher(dataset, self.cfg, shuffle=False,
                               pin_memory=self.device.type == "cuda", mesh=mesh)
        all_raw, all_gt, all_idx = [], [], []
        model.eval()
        try:
            with torch.inference_mode():
                text = {}
                if self.cfg.get("eval_precompute_text", True) \
                        and hasattr(model, "text_precompute"):
                    # fixed weights for the pass: the prompts and queries once
                    text_features, query = model.text_precompute()
                    text = {"text_features": text_features, "query": query}
                for batch in batcher:
                    inputs = make_global_batch(
                        {k: v for k, v in batch.items() if k in _MODEL_INPUTS}, mesh,
                        self.device, self.trainer.seq_parallel)
                    feats, kws = feats_inputs(model, inputs)
                    raw = _logits(model(feats, inputs["mask"], **kws, **text,
                                        **model_extras(inputs)))
                    self._collect(batch, collect_global(raw, mesh), all_raw, all_gt, all_idx)
        finally:
            model.train()
        self.timings["eval"].append({"split": loader_name, "bags": len(dataset),
                                     "seconds": time.perf_counter() - t0})
        return {"pred": self._cltor(all_raw, all_gt, all_idx, loader_name)}

    # ------------------------------------------------------------------ eval
    def _eval_all(self, evals_loader, ckpt_type="best", run_name="train", test_mode=False):
        cfg = self.cfg
        save_pred_path = cfg["test_save_path"] if test_mode else cfg["save_path"]
        ckpt_run_name = "train" if test_mode else run_name
        group = cfg.get("test_mode_name", "test_mode") if test_mode else run_name
        if ckpt_type == "best":
            ckpt_path = add_prefix_to_filename(self.best_ckpt_path, ckpt_run_name)
            print_path = add_prefix_to_filename(self.best_metrics_path, group)
            name_group, csv_name = f"bestckpt/{group}", f"{cfg['task']}_{group}_best"
        elif ckpt_type == "last":
            ckpt_path = add_prefix_to_filename(self.last_ckpt_path, ckpt_run_name)
            print_path = add_prefix_to_filename(self.last_metrics_path, group)
            name_group, csv_name = f"lastckpt/{group}", f"{cfg['task']}_{group}_last"
        elif ckpt_type == "zero-shot":
            ckpt_path = None
            print_path = add_prefix_to_filename(self.best_metrics_path, group)
            name_group, csv_name = f"lastckpt/{group}", f"{cfg['task']}_{group}_last"
        else:
            raise KeyError(f"Expected best or last for `ckpt_for_eval`, got {ckpt_type}.")
        # rank 0's file, or the weights in memory where it has none
        ckpt = self._read_checkpoint(ckpt_path, missing_ok=True)
        if ckpt is not None:
            merge_state(self.model, ckpt["model"])

        metrics = {}
        for k, ds in evals_loader.items():
            if ds is None:
                continue
            cltor = self.test_model(ds, k)
            metrics[k] = []
            for k_c, v_c in cltor.items():
                met_main, met_loss = self._eval_and_print(
                    v_c, name=f"{name_group}/{k}/{k_c}", at_epoch=ckpt_type)
                metrics[k].append((f"{k_c}_{self.ret_metrics[0]}", met_main))
                metrics[k].append((f"{k_c}_{self.ret_metrics[1]}", met_loss))
            if cfg.get("save_prediction") and self.is_main:
                full = osp.join(save_pred_path, f"{csv_name}_pred_{k}.csv")
                self.save_prediction_results(cltor["pred"], full, type_pred=cfg.get("evaluator"))
        print_metrics(metrics, print_to_path=print_path if self.is_main else None)
        return metrics

    def save_prediction_results(self, data_cltor, path_to_save, **kws):
        save_prediction_surv(data_cltor["uid"], data_cltor["y"], data_cltor["y_hat"],
                             path_to_save, **kws)

    def _eval_and_print(self, cltor, name="", at_epoch=None):
        results = self.evaluator.compute(cltor, self.metrics_list, **self.eval_kws())
        results = rename_keys(results, name, sep="/")
        print(f"[{name}] At epoch {at_epoch}:",
              " ".join(f"{k}={v:.6f}," for k, v in results.items()))
        self.jsonl.log({"event": "eval", "at": str(at_epoch), **results})
        return [results[name + "/" + k] for k in self.ret_metrics]

    # ------------------------------------------------------------------ ckpt
    def _read_checkpoint(self, path, missing_ok: bool = False) -> Optional[dict]:
        """The checkpoint at `path` as global rank 0 reads it, on every rank
        of a grid (None where `missing_ok` and rank 0 has no such file).
        The other ranks read no file; rank 0's failure to read one is
        raised on every rank."""
        ckpt = None
        if self.is_main and path is not None and (not missing_ok or osp.exists(path)):
            try:
                ckpt = load_checkpoint(path)
            except Exception as exc:  # sent on, so that no rank waits for this one
                ckpt = exc
        ckpt = broadcast_object(ckpt, self.mesh is not None)
        if isinstance(ckpt, Exception):
            raise ckpt
        return ckpt

    def _save_model(self, epoch, ckpt_type, run_name):
        """Rank 0 writes the checkpoint; no other rank reads it
        (`_read_checkpoint`), so none waits for it."""
        if not self.is_main:
            return
        path = self.best_ckpt_path if ckpt_type == "best" else self.last_ckpt_path
        save_checkpoint(add_prefix_to_filename(path, run_name), epoch, self.model,
                        module_filter=self.cfg.get("model_saver_module_filter"),
                        optimizer=(self.optimizer if self.cfg.get("save_optimizer", True)
                                   else None))

    def resume_model(self, ckpt_type: str = "best", run_name: str = "train",
                     missing_ok: bool = False) -> Optional[int]:
        """The model (strict=False: filtered-out modules keep their values)
        and, when saved, the optimizer's state (the port's, or vlsa_tpu's
        optax state) from a run checkpoint (rank 0's, on every rank of a
        grid); returns its epoch (None where `missing_ok` and there is no
        such file)."""
        if ckpt_type == "last":
            path = add_prefix_to_filename(self.last_ckpt_path, run_name)
        elif ckpt_type == "best":
            path = add_prefix_to_filename(self.best_ckpt_path, run_name)
        else:
            raise KeyError(f"Expected best or last for `ckpt_type`, got {ckpt_type}.")
        ckpt = self._read_checkpoint(path, missing_ok)
        if ckpt is None:
            return None
        if self.optimizer is not None:
            # first, so that a state that does not fit raises before the model changes
            if "optax_state" in ckpt:
                load_optax_state(self.optimizer, self.cfg["opt_name"], ckpt["optax_state"])
            elif "optimizer" in ckpt:
                self.optimizer.load_state_dict(ckpt["optimizer"])
        merge_state(self.model, ckpt["model"])
        print(f"[model] resume the network from {ckpt_type}_{run_name} "
              f"at epoch {ckpt['epoch']}...")
        return ckpt["epoch"]
