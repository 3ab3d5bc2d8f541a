"""The CLF handler: slide-level classification (counterpart of
vlsa_tpu/runner/clf.py), `python -m vlsa_tpu_torch.main --handler CLF`.

A `task: clf` config trains a network of the DeepMIL arch (`arch:
DeepMIL`, `deepmil_network` ABMIL and the rest of the zoo, `net_dims`
ending in the class count) on one bag a slide, labelled by the `label`
column of `path_table` (`patient_id`, `pathology_id`, `label`), with the
classification losses (`loss_type` BCE, CE, LabelSmoothingCrossEntropy,
...) and the Binary or Multi-class evaluator.  Predictions are written
by `data.io.save_prediction_clf`.

vlsa_tpu draws the robustness experiments' randomness from numpy's global
generator: the slide-level feature path switch (`random_patch_path`,
training split), instance masking (`ratio_mask`, test mode) and label
corruption.  Here it comes from an explicit `np.random.RandomState`,
which the handler seeds with the config's seed: the same draws, in the same
order, as vlsa_tpu's after its `np.random.seed(seed)`.
"""
from __future__ import annotations

import csv
import os.path as osp
from typing import List, Optional

import numpy as np

from ..data.bags import read_patch_data, sampling_data
from ..data.io import SYNTHETIC_PREFIX, save_prediction_clf, synthetic_bag
from ..eval import load_evaluator
from .base import BaseHandler

# the alternate feature directories of the path switch (vlsa_tpu's default)
PATCH_PATH_CHOICES = ["feat-x20-RN50-B-color_norm-vflip", "feat-x20-RN50-B-color_hed_light"]


def random_mask_instance(bag: np.ndarray, mask_ratio: float, rng: np.random.RandomState,
                         scale: int = 1, mask_way: str = "mask_zero") -> np.ndarray:
    """Keep a random share 1 - `mask_ratio` (at least one) of the bag's
    `scale` x `scale` squares of instances, drawn from `rng`: `discard`
    drops the others, `mask_zero` zeroes them.  A ratio outside (0, 1]
    returns the bag."""
    if mask_ratio <= 0 or mask_ratio > 1:
        return bag
    N = bag.shape[0]
    n_square = scale * scale
    if N % n_square != 0:
        raise ValueError("bag must consist of square instances.")
    N_scaled = N // n_square
    n_keep = max(1, int(N_scaled * (1 - mask_ratio)))
    idxs_keep = np.sort(rng.permutation(N_scaled)[:n_keep])
    idxs_keep = (idxs_keep.reshape(-1, 1) * n_square
                 + np.arange(n_square).reshape(1, -1)).reshape(-1)
    if mask_way == "discard":
        return bag[idxs_keep]
    if mask_way == "mask_zero":
        new_bag = np.zeros_like(bag)
        new_bag[idxs_keep] = bag[idxs_keep]
        return new_bag
    raise NotImplementedError(f"mask_way={mask_way}")


def read_label_table(table_path: str, patient_ids) -> List[tuple]:
    """(pathology_id, label) of every row whose patient is in
    `patient_ids`, in the table's order."""
    keep = set(patient_ids)
    with open(table_path, newline="") as f:
        rows = list(csv.DictReader(f))
    for c in ("patient_id", "pathology_id", "label"):
        if rows and c not in rows[0]:
            raise ValueError(f"{table_path} has no column {c!r}")
    return [(r["pathology_id"], int(r["label"])) for r in rows if r["patient_id"] in keep]


class ClfBagDataset:
    """One bag a slide with its class label: an item is (feats [N, D] f32,
    label [class, 0] f32).  `aug_path_choices`: with probability 1/2 a
    slide is read from one of two alternate directories, whose names
    replace the second-to-last segment of the feature path;
    `ratio_mask`: instance masking (`random_mask_instance`); both drawn
    from `rng`.  The native loader reads a `.npy` store's bags
    (`bag_paths`) when neither is set."""

    def __init__(self, patient_ids: List[str], patch_path: str, table_path: str,
                 rng: np.random.RandomState, read_format: str = "pt", ratio_mask=None,
                 aug_path_choices=None, ratio_sampling=None):
        if ratio_sampling is not None:
            print(f"[dataset] patient-level sampling with ratio_sampling = {ratio_sampling}")
            patient_ids, left = sampling_data(list(patient_ids), ratio_sampling)
            print(f"[dataset] sampled {len(patient_ids)} patients, left {len(left)}")
        rows = read_label_table(table_path, patient_ids)
        self.sids = [sid for sid, _ in rows]
        self.sid2label = dict(rows)
        self.uid = self.sids
        self.read_path = patch_path
        self.read_format = read_format
        self.ratio_mask = ratio_mask
        self.aug_path_choices = aug_path_choices
        self.rng = rng
        self.new_sid2label = None
        self.flag_use_corrupted_label = False

    def corrupt_labels(self, corrupt_prob: float):
        """Replace each label with probability `corrupt_prob` by a class drawn
        uniformly (it may draw the same one)."""
        labels = np.array([self.sid2label[s] for s in self.sids])
        mask = self.rng.rand(len(labels)) <= corrupt_prob
        labels[mask] = self.rng.choice(labels.max() + 1, mask.sum())
        cnt = 0
        self.new_sid2label = {}
        for i, sid in enumerate(self.sids):
            if labels[i] != self.sid2label[sid]:
                cnt += 1
            self.new_sid2label[sid] = int(labels[i])
        self.flag_use_corrupted_label = True
        print(f"[dataset] {cnt / len(labels) * 100:.2f}% corrupted labels "
              f"with corrupt_prob = {corrupt_prob}")

    def resume_labels(self):
        if self.flag_use_corrupted_label:
            self.flag_use_corrupted_label = False
            print("[dataset] the corrupted labels have been resumed.")

    def __len__(self):
        return len(self.sids)

    def _path(self, read_path: str, sid: str) -> str:
        return osp.join(read_path, sid + "." + self.read_format)

    def bag_paths(self, index: int) -> Optional[List[str]]:
        """The slide's `.npy` file for the native loader; None for other
        stores, synthetic bags, or when an item draws (path switch,
        masking)."""
        if (self.read_format != "npy" or self.aug_path_choices or self.ratio_mask
                or str(self.read_path).startswith(SYNTHETIC_PREFIX)):
            return None
        return [self._path(self.read_path, self.sids[index])]

    def bag_label(self, index: int) -> np.ndarray:
        sid = self.sids[index]
        lab = (self.new_sid2label[sid] if self.flag_use_corrupted_label
               else self.sid2label[sid])
        return np.asarray([float(lab), 0.0], np.float32)

    def __getitem__(self, index: int) -> tuple:
        sid = self.sids[index]
        read_path = self.read_path
        if self.aug_path_choices:
            prob = self.rng.rand()
            if prob > 0.5:
                parts = str(read_path).split("/")
                parts[-2] = self.aug_path_choices[0 if prob <= 0.75 else 1]
                read_path = "/".join(parts)
        if str(read_path).startswith(SYNTHETIC_PREFIX):
            feats = synthetic_bag(sid, read_path)
        else:
            feats = read_patch_data(self._path(read_path, sid)).astype(np.float32)
        if self.ratio_mask:
            feats = random_mask_instance(feats, self.ratio_mask, self.rng)
        return feats, self.bag_label(index)


def make_clf_dataset(cfg: dict, patient_ids, set_name: str,
                     rng: np.random.RandomState) -> ClfBagDataset:
    """The slides of `patient_ids`: instance masking (`ratio_mask`) in test
    mode, the feature path switch (`random_patch_path`,
    `patch_path_choices`) on the training split."""
    ratio_mask = cfg.get("ratio_mask") if cfg.get("test") else None
    aug = None
    if set_name == "train" and cfg.get("random_patch_path"):
        aug = cfg.get("patch_path_choices", PATCH_PATH_CHOICES)
    return ClfBagDataset(patient_ids, cfg["path_patch"], cfg["path_table"], rng,
                         read_format=cfg["feat_format"], ratio_mask=ratio_mask,
                         aug_path_choices=aug)


def make_clf_objective(loss_fns: dict, loss_weights: dict):
    """The weighted sum of each classification loss on the raw logits,
    averaged over the batch's valid rows (a loss per element, BCE's, is
    first averaged over the classes)."""

    def objective(raw, t, e, sample_mask, logit_scale=None, query_div_fn=None):
        total = 0.0
        denom = sample_mask.sum().clamp(min=1.0)
        for name, fn in loss_fns.items():
            per = fn(raw, t.long(), ret_mean=False)
            if per.ndim > 1:
                per = per.mean(dim=-1)
            total = total + loss_weights.get(name, 1) * (per * sample_mask).sum() / denom
        return total

    return objective


class CLFHandler(BaseHandler):
    """A classification run: DeepMIL with the Binary or Multi-class
    evaluator; the collected labels are the class column."""

    def __init__(self, cfg, device=None, state_dict=None):
        if cfg["task"] != "clf":
            raise ValueError(f"Expected task = `clf` but got {cfg['task']}.")
        super().__init__(cfg, device=device, state_dict=state_dict)

    def func_load_evaluator(self, cfg, meta_data=None):
        if cfg["evaluator"] not in ("Binary", "Multi-class"):
            raise ValueError(f"evaluator {cfg['evaluator']!r}: CLF takes Binary or Multi-class")
        evaluator = load_evaluator("clf", cfg["evaluator"])
        if cfg["evaluator"] == "Binary":
            metrics_list = ["auc", "loss", "acc", "acc@mid", "acc_best",
                            "recall", "precision", "f1_score", "ece", "mce"]
        else:
            metrics_list = ["auc", "loss", "acc", "macro_f1_score", "micro_f1_score"]
        return evaluator, metrics_list, ["auc", "loss"]

    def prepare_dataset(self, patient_ids, set_name):
        return make_clf_dataset(self.cfg, patient_ids, set_name, self.trainer.data_rng)

    def _finalize_cltor(self, cltor: dict) -> dict:
        cltor = dict(cltor)
        cltor["y"] = np.asarray(cltor["y"])[:, 0]
        return cltor

    def save_prediction_results(self, data_cltor, path_to_save, **kws):
        y_hat = np.asarray(data_cltor["y_hat"])
        save_prediction_clf(data_cltor["uid"], np.asarray(data_cltor["y"]), y_hat,
                            path_to_save, binary=y_hat.shape[-1] == 2)

