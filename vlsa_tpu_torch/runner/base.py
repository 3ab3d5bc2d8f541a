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
unless VLSA_TPU_DISABLE_WANDB=0; the card's machine has no wandb), `mesh`
and `distributed` (ROADMAP.md §A.17), and vlsa_tpu's checkpoint formats
(`ckpt_backend`, §A.6); each raises.
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
from ..utils.device import resolve_device
from ..utils.observability import JsonlLogger, configure_debug, maybe_profile
from ..utils.seed import seed_everything
from .ckpt import add_prefix_to_filename, load_checkpoint, merge_state, save_checkpoint
from .engine import GRAPH_KEYS, _logits, feats_inputs, make_output_converter, model_extras
from .train import Trainer, make_batcher, make_dataset

# the batch entries an evaluation pass sends to the model
_MODEL_INPUTS = ("feats", "feats_scale", "feats_inv", "mask") + GRAPH_KEYS


def _refuse_unported(cfg: dict) -> None:
    for key in ("mesh", "distributed"):
        if cfg.get(key):
            raise NotImplementedError(f"`{key}`: multi-device runs are not ported yet "
                                      f"(ROADMAP.md §A.17)")
    if cfg.get("ckpt_backend", "msgpack") != "msgpack":
        raise NotImplementedError(f"ckpt_backend {cfg['ckpt_backend']!r}: this port "
                                  f"writes torch checkpoints only (ROADMAP.md §A.6)")


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
    vlsa_tpu parameter tree through utils.weights.state_dict_from_jax)."""

    def __init__(self, cfg: dict, device=None, state_dict: Optional[dict] = None):
        validate_config(cfg, cfg.get("task", ""), strict=cfg.get("strict_config", False))
        _refuse_unported(cfg)
        self.device = resolve_device(device)
        seed_everything(cfg["seed"])
        configure_debug(cfg)

        print(f"[setup] dataset name: {cfg['dataset_name']}.")
        if not cfg.get("test", False):
            _fill_paths(cfg)
            os.makedirs(cfg["save_path"], exist_ok=True)
            base = cfg["save_path"]
        else:
            if "{}" in str(cfg.get("test_load_path", "")):
                cfg["test_load_path"] = cfg["test_load_path"].format(cfg["data_split_seed"])
            os.makedirs(cfg["test_save_path"], exist_ok=True)
            base = cfg["test_save_path"]
        load_base = cfg.get("test_load_path", base) if cfg.get("test", False) else base
        self.last_ckpt_path = osp.join(load_base, "model-last.ckpt")
        self.best_ckpt_path = osp.join(load_base, "model-best.ckpt")
        self.last_metrics_path = osp.join(base, "metrics-last.txt")
        self.best_metrics_path = osp.join(base, "metrics-best.txt")
        self.config_path = osp.join(base, "print_config.txt")
        self.config_yaml = osp.join(base, "config.yaml")
        self.jsonl = JsonlLogger(osp.join(base, "metrics.jsonl"))
        print(f"[setup] path to save: {base}")

        # data, model, losses, optimizer and engine: runner.train's wiring
        self.trainer = Trainer(cfg, self.device, state_dict=state_dict)
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
        test_set = make_dataset(cfg, self.data_meta, self.data_split["test"])
        self.uid["test"] = test_set.uid
        val_set = None
        if "validation" in self.data_split:
            val_set = make_dataset(cfg, self.data_meta, self.data_split["validation"])
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
        pids = self.data_split[cfg["test_path"]]
        # as vlsa_tpu: the split named "train" is the few-shot sample in a few-shot run
        test_set = make_dataset(cfg, self.data_meta, pids, train=cfg["test_path"] == "train")
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
                                     pin_memory=self.device.type == "cuda")
        n_train = len(train_batcher.dataset)
        last_epoch = -1
        start_epoch = 0
        if cfg.get("auto_resume"):
            # restart from the run's last checkpoint (model, Adam's moments, epoch)
            if osp.exists(add_prefix_to_filename(self.last_ckpt_path, run_name)):
                start_epoch = self.resume_model("last", run_name)
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
            self._collect(batch, raw, all_raw, all_gt, all_idx)
        return {"pred": self._cltor(all_raw, all_gt, all_idx, "train")}, prep_s

    @staticmethod
    def _collect(batch, raw, all_raw, all_gt, all_idx) -> None:
        valid = batch["valid"].numpy()
        all_raw.append(raw.float().cpu().numpy()[valid])
        all_gt.append(np.stack([batch["t"].numpy()[valid], batch["e"].numpy()[valid]], 1))
        all_idx.append(batch["idx"].numpy()[valid])

    def _cltor(self, all_raw, all_gt, all_idx, loader_name) -> dict:
        """The pass's collected arrays; the output converter runs once on all
        of them."""
        all_raw = np.concatenate(all_raw)
        all_pred = self.output_converter(torch.from_numpy(all_raw)).numpy()
        uids = [self.uid[loader_name][i] for i in np.concatenate(all_idx)]
        return {"y": np.concatenate(all_gt), "raw_y_hat": all_raw, "y_hat": all_pred,
                "uid": uids, "name": loader_name}

    def test_model(self, dataset, loader_name, ckpt_path=None):
        """An evaluation pass over `dataset` (after loading `ckpt_path`)."""
        if ckpt_path is not None:
            merge_state(self.model, load_checkpoint(ckpt_path)["model"])
        t0 = time.perf_counter()
        model = self.model
        batcher = make_batcher(dataset, self.cfg, shuffle=False,
                               pin_memory=self.device.type == "cuda")
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
                    inputs = {k: v.to(self.device, non_blocking=True)
                              for k, v in batch.items() if k in _MODEL_INPUTS}
                    feats, kws = feats_inputs(model, inputs)
                    raw = _logits(model(feats, inputs["mask"], **kws, **text,
                                        **model_extras(inputs)))
                    self._collect(batch, raw, all_raw, all_gt, all_idx)
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
        if ckpt_path is not None and not osp.exists(ckpt_path):
            ckpt_path = None

        metrics = {}
        for k, ds in evals_loader.items():
            if ds is None:
                continue
            cltor = self.test_model(ds, k, ckpt_path=ckpt_path)
            ckpt_path = None  # load once
            metrics[k] = []
            for k_c, v_c in cltor.items():
                met_main, met_loss = self._eval_and_print(
                    v_c, name=f"{name_group}/{k}/{k_c}", at_epoch=ckpt_type)
                metrics[k].append((f"{k_c}_{self.ret_metrics[0]}", met_main))
                metrics[k].append((f"{k_c}_{self.ret_metrics[1]}", met_loss))
            if cfg.get("save_prediction"):
                full = osp.join(save_pred_path, f"{csv_name}_pred_{k}.csv")
                self.save_prediction_results(cltor["pred"], full, type_pred=cfg.get("evaluator"))
        print_metrics(metrics, print_to_path=print_path)
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
    def _save_model(self, epoch, ckpt_type, run_name):
        path = self.best_ckpt_path if ckpt_type == "best" else self.last_ckpt_path
        save_checkpoint(add_prefix_to_filename(path, run_name), epoch, self.model,
                        module_filter=self.cfg.get("model_saver_module_filter"),
                        optimizer=(self.optimizer if self.cfg.get("save_optimizer", True)
                                   else None))

    def resume_model(self, ckpt_type: str = "best", run_name: str = "train") -> int:
        """The model (strict=False: filtered-out modules keep their values)
        and, when saved, the optimizer's state from a run checkpoint; returns
        its epoch."""
        if ckpt_type == "last":
            path = add_prefix_to_filename(self.last_ckpt_path, run_name)
        elif ckpt_type == "best":
            path = add_prefix_to_filename(self.best_ckpt_path, run_name)
        else:
            raise KeyError(f"Expected best or last for `ckpt_type`, got {ckpt_type}.")
        ckpt = load_checkpoint(path)
        merge_state(self.model, ckpt["model"])
        if "optimizer" in ckpt and self.optimizer is not None:
            self.optimizer.load_state_dict(ckpt["optimizer"])
        print(f"[model] resume the network from {ckpt_type}_{run_name} "
              f"at epoch {ckpt['epoch']}...")
        return ckpt["epoch"]
