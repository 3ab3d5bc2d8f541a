"""Batching of bags into padded, masked tensors (counterpart of the batcher
of vlsa_tpu/data/pipeline.py).

A batch of bags is padded to a shared bucket length (a power of two, or one
fixed length) and stored in the configured feature type.  Each bag is padded
straight into an array of that type: at 32 bags x 131,072 patches x 512 a
bf16 batch takes 4.3 GB of host memory where an f32 one would take 8.6 GB;
the values are those of padding in f32 and casting the batch (bf16 rounds
each value, int8 quantizes each patch row on its own).  Batches are made on
the calling thread; the JAX package's background prefetch thread is not
ported yet.
"""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from .quant import FEATS_DTYPES, feats_inv_norms, quantize_feats_int8


def bucket_length(n: int, min_bucket: int = 256, max_bucket: Optional[int] = None) -> int:
    """Next power-of-two bucket >= n (bounded below and above)."""
    b = min_bucket
    while b < n:
        b *= 2
    if max_bucket is not None:
        b = min(b, max_bucket)
    return b


class BagOverflowError(ValueError):
    """A bag holds more patches than the padding bucket allows."""


class BagBatcher:
    """Batches of a SurvBagDataset as dicts of CPU tensors:
      feats [B, N, D] (float32, bfloat16 or int8), mask [B, N] bool,
      t [B] f32, e [B] f32, idx [B] int32 (dataset indices, -1 for padding),
      valid [B] bool (False for the padded rows of a tail batch),
    plus, for int8, feats_scale [B, N] f32 and (with `precompute_inv`)
    feats_inv [B, N] f32 = 1/||x_int||.

    Bags longer than the bucket follow `overflow`: 'error' (the reference
    uses every patch), 'warn' or 'truncate' (keep the first patches)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False, seed: int = 0,
                 min_bucket: int = 256, max_bucket: Optional[int] = None,
                 fixed_bucket: Optional[int] = None,
                 feats_dtype: str = "float32", overflow: str = "error",
                 precompute_inv: bool = True):
        if feats_dtype not in FEATS_DTYPES:
            raise ValueError(f"feats_dtype must be one of {FEATS_DTYPES}, got {feats_dtype}")
        if overflow not in ("error", "warn", "truncate"):
            raise ValueError(f"invalid overflow policy {overflow!r}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.min_bucket = min_bucket
        self.max_bucket = max_bucket
        self.fixed_bucket = fixed_bucket
        self.feats_dtype = feats_dtype
        self.overflow = overflow
        self.precompute_inv = precompute_inv
        self.truncated_bags = 0
        self.truncated_patches = 0
        self._epoch = 0

    def __len__(self):
        return -(-len(self.dataset) // self.batch_size)

    def _order(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            return np.random.default_rng(self.seed + self._epoch).permutation(n)
        return np.arange(n)

    def _count_overflow(self, n: int, target_n: int) -> None:
        if n <= target_n:
            return
        if self.overflow == "error":
            raise BagOverflowError(
                f"bag of {n} patches exceeds the {target_n}-patch bucket; the "
                f"reference uses every patch. Raise `fixed_bucket`/`max_bucket`, "
                f"or set bag_overflow: 'warn'/'truncate' to cap bags.")
        if self.overflow == "warn":
            print(f"[BagBatcher] WARNING: bag of {n} patches truncated to "
                  f"{target_n} ({n - target_n} patches dropped)")
        self.truncated_bags += 1
        self.truncated_patches += n - target_n

    def make_batch(self, indices) -> dict:
        items = [self.dataset[int(i)] for i in indices]
        max_n = max(f.shape[0] for f, _ in items)
        target_n = (self.fixed_bucket if self.fixed_bucket is not None
                    else bucket_length(max_n, self.min_bucket, self.max_bucket))
        B, D = self.batch_size, items[0][0].shape[1]
        int8 = self.feats_dtype == "int8"
        if self.feats_dtype == "bfloat16":
            feats = torch.zeros(B, target_n, D, dtype=torch.bfloat16)
        else:
            feats = torch.zeros(B, target_n, D, dtype=torch.int8 if int8 else torch.float32)
        mask = torch.zeros(B, target_n, dtype=torch.bool)
        batch = {"feats": feats, "mask": mask,
                 "t": torch.zeros(B), "e": torch.zeros(B),
                 "idx": torch.full((B,), -1, dtype=torch.int32),
                 "valid": torch.zeros(B, dtype=torch.bool)}
        if int8:
            batch["feats_scale"] = torch.zeros(B, target_n)
            if self.precompute_inv:
                batch["feats_inv"] = torch.zeros(B, target_n)
        for j, (f, label) in enumerate(items):
            self._count_overflow(f.shape[0], target_n)
            n = min(f.shape[0], target_n)
            f = f[:n]
            if int8:
                q, scale = quantize_feats_int8(f)
                feats[j, :n] = torch.from_numpy(q)
                batch["feats_scale"][j, :n] = torch.from_numpy(scale)
                if self.precompute_inv:
                    batch["feats_inv"][j, :n] = torch.from_numpy(feats_inv_norms(q))
            else:
                feats[j, :n] = torch.from_numpy(f)  # bf16: rounded on the copy
            mask[j, :n] = True
            batch["t"][j], batch["e"][j] = float(label[0]), float(label[1])
            batch["idx"][j] = int(indices[j])
            batch["valid"][j] = True
        return batch

    def batch_indices(self) -> Iterator[np.ndarray]:
        order = self._order()
        for start in range(0, len(order), self.batch_size):
            yield order[start:start + self.batch_size]

    def __iter__(self) -> Iterator[dict]:
        self._epoch += 1
        for chunk in self.batch_indices():
            yield self.make_batch(chunk)
