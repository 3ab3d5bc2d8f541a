"""Patient-level bag dataset (counterpart of vlsa_tpu/data/bags.py, `patch`
mode): each item concatenates the patch features of every slide of a
patient into one [N, D] bag, with its label (y_t, e).  Stores are read as
vlsa_tpu/data/io.py:81-99 reads them.  The few-shot wrapper is not ported
yet."""
from __future__ import annotations

import os.path as osp
from typing import List, Tuple

import numpy as np

from .io import SYNTHETIC_PREFIX, synthetic_bag
from .label_converter import MetaSurvData


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
        with np.load(path) as z:
            return z["q"].astype(np.float32) * z["scale"][..., None]
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

    def _load_feats(self, sids) -> np.ndarray:
        feats = []
        for sid in sids:
            if str(self.read_path).startswith(SYNTHETIC_PREFIX):
                feats.append(synthetic_bag(sid, self.read_path))
                continue
            full_path = osp.join(self.read_path, sid + "." + self.read_format)
            if not osp.exists(full_path):
                print(f"[SurvBagDataset] warning: not found slide {sid}.")
                continue
            feats.append(read_patch_data(full_path).astype(np.float32))
        return np.concatenate(feats, axis=0)

    def __getitem__(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        """(feats [N, D] f32, label [y_t, e] f32)."""
        pid = self.pids[index]
        return (self._load_feats(self.pid2sids[pid]),
                np.asarray(self.pid2label[pid], dtype=np.float32))
