"""Patient-level bag datasets (counterpart of vlsa_tpu/data/bags.py, `patch`
mode): each item concatenates the patch features of every slide of a
patient into one [N, D] bag, with its label (y_t, e).  Stores are read as
vlsa_tpu/data/io.py:81-99 reads them; a `.q8npz` store's bags are
QuantizedBags, which int8 batches take as stored.  `bag_paths` gives the
batcher's native loader the files of a `.npy` or `.q8npz` bag.  The
few-shot wrapper draws `num_shot` patients per Kaplan-Meier de-censored
time bin."""
from __future__ import annotations

import os.path as osp
from typing import List, Optional, Tuple, Union

import numpy as np

from .io import SYNTHETIC_PREFIX, synthetic_bag
from .label_converter import MetaSurvData, calculate_uncensored_time_bins
from .quant import QuantizedBag, read_quantized_feats

NATIVE_FORMATS = ("npy", "q8npz")  # the stores native/bagloader.cpp reads


def read_patch_data(path: str, key: str = "features") -> np.ndarray:
    """One slide's patch features [N, D] from a store: `.pt` (a tensor or
    {key: tensor}), `.npy`, `.q8npz` (int8 `q` and per-patch `scale`,
    dequantized to f32 as q * scale) or `.h5` (dataset `key`; h5py is
    imported only here)."""
    ext = osp.splitext(path)[1]
    if ext == ".pt":
        import torch
        data = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(data, dict):
            data = data[key]
        return data.numpy()
    if ext == ".npy":
        return np.load(path)
    if ext == ".q8npz":
        return read_quantized_feats(path).dequantize()
    if ext == ".h5":
        try:
            import h5py
        except ImportError as exc:
            raise ImportError(f"reading {path} needs the 'h5py' package") from exc
        with h5py.File(path, "r") as hf:
            return np.asarray(hf[key][:])
    raise ValueError(f"unsupported patch store {path}: this port reads .pt, .npy, .q8npz, .h5")


class SurvBagDataset:
    def __init__(self, patient_ids: List[str], patch_path: str, meta_data: MetaSurvData,
                 read_format: str = "pt"):
        self.read_path = patch_path
        self.read_format = read_format
        self.pids, self.pid2sids, self.pid2label = meta_data.collect_info_by_pids(patient_ids)
        self.meta_data = meta_data
        self.uid = self.pids

    def __len__(self):
        return len(self.pids)

    def _synthetic(self) -> bool:
        return str(self.read_path).startswith(SYNTHETIC_PREFIX)

    def _path(self, sid: str) -> str:
        return osp.join(self.read_path, sid + "." + self.read_format)

    def _load_feats(self, sids) -> Union[np.ndarray, QuantizedBag]:
        feats = []
        for sid in sids:
            if self._synthetic():
                feats.append(synthetic_bag(sid, self.read_path))
                continue
            full_path = self._path(sid)
            if not osp.exists(full_path):
                print(f"[SurvBagDataset] warning: not found slide {sid}.")
                continue
            if self.read_format == "q8npz":
                feats.append(read_quantized_feats(full_path))
            else:
                feats.append(read_patch_data(full_path).astype(np.float32))
        if feats and isinstance(feats[0], QuantizedBag):
            return QuantizedBag.concatenate(feats)
        return np.concatenate(feats, axis=0)

    def _slide_len(self, sid: str) -> int:
        """Patches of one slide (0 for a missing file), read from the
        store's header where the native loader can."""
        if self._synthetic():
            return synthetic_bag(sid, self.read_path).shape[0]
        full_path = self._path(sid)
        if not osp.exists(full_path):
            return 0
        if self.read_format in NATIVE_FORMATS:
            from . import native_loader
            if native_loader.native_available():
                read_info = (native_loader.read_q8_info if self.read_format == "q8npz"
                             else native_loader.read_npy_info)
                return read_info(full_path)[0]
        return self._load_feats([sid]).shape[0]

    def bag_paths(self, index: int) -> Optional[List[str]]:
        """The slide files of bag `index` in order, for the native loader;
        None for synthetic bags and for stores other than .npy and .q8npz."""
        if self._synthetic() or self.read_format not in NATIVE_FORMATS:
            return None
        return [self._path(sid) for sid in self.pid2sids[self.pids[index]]]

    def bag_label(self, index: int) -> np.ndarray:
        return np.asarray(self.pid2label[self.pids[index]], dtype=np.float32)

    def __getitem__(self, index: int) -> Tuple[Union[np.ndarray, QuantizedBag], np.ndarray]:
        """(feats [N, D] f32, or a QuantizedBag from a .q8npz store;
        label [y_t, e] f32)."""
        return self._load_feats(self.pid2sids[self.pids[index]]), self.bag_label(index)


class FewShotSurvBagDataset:
    """`num_shot` patients of each time bin of a dataset (vlsa_tpu/data/
    bags.py::FewShotSurvBagDataset): the bins of the patients' KM-de-censored
    times, `num_shot` drawn without replacement from each bin (all of a
    smaller one) by numpy's default_rng(seed), drawn again until the sample
    holds at least one event and one censored patient; in dataset order."""

    def __init__(self, dataset: SurvBagDataset, num_shot: int, seed: int = 0):
        self._dataset = dataset
        self.num_shot = num_shot
        self.seed = seed
        self.meta_data = dataset.meta_data
        self.uncensored_time_bins = calculate_uncensored_time_bins(dataset.uid, self.meta_data)
        event_labels = [dataset.pid2label[u][1] for u in dataset.uid]
        self.few_shot_idx = self.get_few_shot_samples(self.uncensored_time_bins, event_labels,
                                                      seed=seed)
        self.uid = [dataset.uid[i] for i in self.few_shot_idx]
        self.pid2label = dataset.pid2label

    def get_few_shot_samples(self, discrete_time_labels, event_labels, seed=0) -> List[int]:
        discrete_time_labels = np.asarray(discrete_time_labels)
        event_labels = np.asarray(event_labels)
        rng = np.random.default_rng(seed)
        is_valid = False
        few_shot_idx: List[int] = []
        while not is_valid:
            few_shot_idx = []
            for t in range(self.meta_data.num_bins):
                idx_of_t = np.where(discrete_time_labels == t)[0]
                if self.num_shot <= 0:
                    few_shot_idx += idx_of_t.tolist()
                else:
                    num_sample = min(self.num_shot, len(idx_of_t))
                    few_shot_idx += rng.choice(idx_of_t, num_sample, replace=False).tolist()
            cnt_event = event_labels[few_shot_idx].sum()
            is_valid = 1 <= cnt_event < len(few_shot_idx)
        return sorted(few_shot_idx)

    def __len__(self):
        return len(self.few_shot_idx)

    def __getitem__(self, index: int):
        return self._dataset[self.few_shot_idx[index]]

    def bag_paths(self, index: int) -> Optional[List[str]]:
        return self._dataset.bag_paths(self.few_shot_idx[index])

    def bag_label(self, index: int) -> np.ndarray:
        return self._dataset.bag_label(self.few_shot_idx[index])


def sampling_data(data, num):
    """A random subset of `data` (numpy's global generator): `num` a float in
    (0, 1) is a fraction, an int a count.  Returns (sampled, left)."""
    total = len(data)
    if isinstance(num, float):
        if not 0.0 < num < 1.0:
            raise ValueError(f"a sampling fraction lies in (0, 1), got {num}")
        num = int(total * num)
    if num >= total:
        raise ValueError(f"cannot sample {num} of {total} patients")
    idxs = np.random.permutation(total)
    return [data[i] for i in idxs[:num]], [data[i] for i in idxs[num:]]


def prepare_surv_dataset(patient_ids: List[str], cfg: dict, meta_data: MetaSurvData,
                         num_shot: int = -1, seed_shot: int = 42,
                         ratio_sampling=None):
    """The bags of `patient_ids` from the config's `path_patch` and
    `feat_format` (vlsa_tpu/data/bags.py::prepare_surv_dataset): first a
    random subset when `ratio_sampling` is given, then, for `num_shot` > 0,
    the few-shot sample drawn with `seed_shot`."""
    if ratio_sampling is not None:
        print(f"[dataset] patient-level sampling with ratio_sampling = {ratio_sampling}")
        patient_ids, pid_left = sampling_data(patient_ids, ratio_sampling)
        print(f"[dataset] sampled {len(patient_ids)} patients, left {len(pid_left)} patients")
    dataset = SurvBagDataset(patient_ids, cfg["path_patch"], meta_data,
                             read_format=cfg.get("feat_format", "pt"))
    if num_shot is not None and num_shot > 0:
        dataset = FewShotSurvBagDataset(dataset, num_shot, seed_shot)
    return dataset
