"""Batching of bags into padded, masked tensors (counterpart of the batcher
of vlsa_tpu/data/pipeline.py), built ahead by a background thread.

A batch of bags is padded to a shared bucket length (a power of two, or one
fixed length) and stored in the configured feature type.  A batch is built
one of two ways, each counted in `BATCHES`:

- native: a dataset with `bag_paths` over `.npy` (f32, f16) or `.q8npz`
  stores goes through native/bagloader.cpp (data/native_loader.py), whose
  threads write the bags straight into the batch's tensors.  A `.q8npz`
  batch in int8 storage takes q, scale and 1/||q|| as stored; `.npy` bags
  arrive in f32, and bf16 is one torch cast of that f32 batch on the host,
  int8 a per-row quantization of it.
- numpy: every other source (synthetic bags, `.pt` and `.h5` stores, a
  `.q8npz` store in f32 or bf16 storage, which is dequantized, or no native
  library): each bag is padded straight into an array of the storage type,
  which at 32 bags x 131,072 patches x 512 takes 4.3 GB of host memory in
  bf16 where f32 would take 8.6 GB; the values are those of padding in f32
  and casting the batch (bf16 rounds each value, int8 quantizes each patch
  row on its own).  `.q8npz` bags enter int8 batches as stored, as above.

With `prefetch` > 0 (the configs' default 2) a producer thread builds up to
`prefetch` batches ahead of the consumer; an exception there is raised in
the consumer, and a consumer that stops early stops the producer.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Iterator, List, Optional

import numpy as np
import torch

from . import native_loader
from .quant import FEATS_DTYPES, QuantizedBag, feats_inv_norms, quantize_feats_int8

_TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}

# batches built by each path since the last reset_batch_counts()
BATCHES = {"native": 0, "numpy": 0}
_BATCHES_LOCK = threading.Lock()


def reset_batch_counts() -> None:
    with _BATCHES_LOCK:
        for k in BATCHES:
            BATCHES[k] = 0


def _count_batch(path: str) -> None:
    with _BATCHES_LOCK:
        BATCHES[path] += 1


def release_pinned_batches() -> None:
    """Return to the system the page-locked blocks that torch's host
    allocator keeps for reuse after the batches built in them are freed (it
    keeps them, one list a power-of-two size class, for the process's life).
    A run on the card calls it at its end: within the run the blocks serve
    every epoch's batches again."""
    if not torch.cuda.is_available():
        return
    empty = (getattr(getattr(torch, "accelerator", None), "empty_host_cache", None)
             or getattr(torch._C, "_host_emptyCache", None))
    if empty is not None:
        empty()


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
    uses every patch), 'warn' or 'truncate' (keep the first patches).
    `pin_memory` puts the feature, mask and sidecar tensors in page-locked
    memory (a run on the card sets it, and releases the blocks at its end:
    `release_pinned_batches`). After each pass, `build_s` holds the
    seconds spent building its batches and `producer` the thread that built
    them (None without prefetch)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False, seed: int = 0,
                 min_bucket: int = 256, max_bucket: Optional[int] = None,
                 fixed_bucket: Optional[int] = None,
                 feats_dtype: str = "float32", overflow: str = "error",
                 precompute_inv: bool = True, prefetch: int = 2, pin_memory: bool = False):
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
        self.prefetch = prefetch
        self.pin_memory = pin_memory
        self.truncated_bags = 0
        self.truncated_patches = 0
        self.build_s = 0.0
        self.producer: Optional[threading.Thread] = None
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

    def _target_n(self, max_n: int) -> int:
        return (self.fixed_bucket if self.fixed_bucket is not None
                else bucket_length(max_n, self.min_bucket, self.max_bucket))

    def _alloc(self, shape, dtype=torch.float32) -> torch.Tensor:
        """An uninitialised host tensor for a batch entry, in page-locked
        memory with `pin_memory` (whose copy to the card runs at the bus's
        rate and does not hold up the host)."""
        return torch.empty(shape, dtype=dtype, pin_memory=self.pin_memory)

    def _label_entries(self, indices, labels) -> dict:
        """The batch's t, e, idx and valid, padded to `batch_size` rows."""
        B = self.batch_size
        batch = {"t": torch.zeros(B), "e": torch.zeros(B),
                 "idx": torch.full((B,), -1, dtype=torch.int32),
                 "valid": torch.zeros(B, dtype=torch.bool)}
        for j, (i, label) in enumerate(zip(indices, labels)):
            batch["t"][j], batch["e"][j] = float(label[0]), float(label[1])
            batch["idx"][j] = int(i)
            batch["valid"][j] = True
        return batch

    def make_batch(self, indices) -> dict:
        """The batch of dataset rows `indices` (at most `batch_size`)."""
        batch = self._native_batch(indices)
        if batch is None:
            batch = self._numpy_batch(indices)
            _count_batch("numpy")
        else:
            _count_batch("native")
        return batch

    def _numpy_batch(self, indices) -> dict:
        items = [self.dataset[int(i)] for i in indices]
        int8 = self.feats_dtype == "int8"
        quantized = isinstance(items[0][0], QuantizedBag)
        if quantized and not int8:  # another storage wants the f32 values
            items = [(f.dequantize(), label) for f, label in items]
            quantized = False
        target_n = self._target_n(max(f.shape[0] for f, _ in items))
        B, D = self.batch_size, items[0][0].shape[1]
        batch = self._label_entries(indices, [label for _f, label in items])
        feats = batch["feats"] = self._alloc((B, target_n, D),
                                             _TORCH_DTYPE[self.feats_dtype]).zero_()
        mask = batch["mask"] = self._alloc((B, target_n), torch.bool).zero_()
        if int8:
            batch["feats_scale"] = self._alloc((B, target_n)).zero_()
            if self.precompute_inv:
                batch["feats_inv"] = self._alloc((B, target_n)).zero_()
        for j, (f, _label) in enumerate(items):
            self._count_overflow(f.shape[0], target_n)
            n = min(f.shape[0], target_n)
            if quantized:  # as stored: no quantization or norm pass
                q, scale, inv = f.q[:n], f.scale[:n], f.inv[:n]
            elif int8:
                q, scale = quantize_feats_int8(f[:n])
                inv = feats_inv_norms(q) if self.precompute_inv else None
            else:
                feats[j, :n] = torch.from_numpy(f[:n])  # bf16: rounded on the copy
            if int8:
                feats[j, :n] = torch.from_numpy(q)
                batch["feats_scale"][j, :n] = torch.from_numpy(scale)
                if self.precompute_inv:
                    batch["feats_inv"][j, :n] = torch.from_numpy(inv)
            mask[j, :n] = True
        return batch

    def _native_batch(self, indices) -> Optional[dict]:
        """The batch through native/bagloader.cpp, or None where that path
        does not apply (see the module's docstring) or fails (printed)."""
        paths_of = getattr(self.dataset, "bag_paths", None)
        if paths_of is None:
            return None
        groups: List[List[str]] = [paths_of(int(i)) for i in indices]
        # a bag without files goes to the numpy path, which reports it
        if any(not g for g in groups):
            return None
        q8 = groups[0][0].endswith(".q8npz")
        if q8 and self.feats_dtype != "int8":
            return None
        if not native_loader.native_available():
            return None
        try:
            read_info = native_loader.read_q8_info if q8 else native_loader.read_npy_info
            shapes = [[read_info(p) for p in g] for g in groups]
            sizes = [sum(rows for rows, _cols in s) for s in shapes]
            target_n = self._target_n(max(sizes))
            for n in sizes:
                self._count_overflow(n, target_n)
            nb, B, D = len(groups), self.batch_size, shapes[0][0][1]
            batch = self._label_entries(indices, [self.dataset.bag_label(int(i))
                                                  for i in indices])
            mask = self._alloc((B, target_n), torch.bool)
            if q8:
                feats = self._alloc((B, target_n, D), torch.int8)
                scale, inv = self._alloc((B, target_n)), self._alloc((B, target_n))
                native_loader.assemble_q8_batch(groups, feats[:nb], scale[:nb], inv[:nb],
                                                mask[:nb])
                sidecars = {"feats_scale": scale, "feats_inv": inv}
            elif self.feats_dtype == "float32":
                feats = self._alloc((B, target_n, D))
                native_loader.assemble_batch(groups, feats[:nb], mask[:nb])
                sidecars = {}
            else:
                # bf16 or int8 from f32 bags: a chunk of bags at a time (one
                # a C++ thread) through an f32 staging buffer, then cast
                int8 = self.feats_dtype == "int8"
                feats = self._alloc((B, target_n, D), _TORCH_DTYPE[self.feats_dtype])
                sidecars = {"feats_scale": self._alloc((B, target_n))} if int8 else {}
                if int8 and self.precompute_inv:
                    sidecars["feats_inv"] = self._alloc((B, target_n))
                step = native_loader.N_THREADS
                staging = torch.empty(min(nb, step), target_n, D)
                for j in range(0, nb, step):
                    k = min(step, nb - j)
                    native_loader.assemble_batch(groups[j:j + k], staging[:k], mask[j:j + k])
                    if int8:  # per patch row, as the numpy path
                        q, sc = quantize_feats_int8(staging[:k].numpy())
                        feats[j:j + k] = torch.from_numpy(q)
                        sidecars["feats_scale"][j:j + k] = torch.from_numpy(sc)
                        if "feats_inv" in sidecars:
                            sidecars["feats_inv"][j:j + k] = torch.from_numpy(feats_inv_norms(q))
                    else:
                        feats[j:j + k] = staging[:k]  # one round-to-nearest-even cast
            for t in (feats, mask, *sidecars.values()):
                t[nb:].zero_()  # a tail batch's padded rows
            if not self.precompute_inv:
                sidecars.pop("feats_inv", None)
            batch.update(sidecars)
            batch["feats"], batch["mask"] = feats, mask
            return batch
        except OSError as exc:
            print(f"[BagBatcher] native path failed ({exc}); using numpy")
            return None

    def batch_indices(self) -> Iterator[np.ndarray]:
        order = self._order()
        for start in range(0, len(order), self.batch_size):
            yield order[start:start + self.batch_size]

    def _timed_batch(self, chunk) -> dict:
        t = time.perf_counter()
        batch = self.make_batch(chunk)
        self.build_s += time.perf_counter() - t
        return batch

    def __iter__(self) -> Iterator[dict]:
        self._epoch += 1
        self.build_s = 0.0
        chunks = list(self.batch_indices())
        if self.prefetch <= 0:
            self.producer = None
            for chunk in chunks:
                yield self._timed_batch(chunk)
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        done = object()
        errors: list = []

        def put(item) -> None:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return
                except queue.Full:
                    pass

        def produce() -> None:
            try:
                for chunk in chunks:
                    if stop.is_set():
                        return
                    put(self._timed_batch(chunk))
            except BaseException as exc:  # raised again in the consumer
                errors.append(exc)
            finally:
                put(done)

        producer = self.producer = threading.Thread(target=produce, name="BagBatcher-prefetch",
                                                    daemon=True)
        producer.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                yield item
            producer.join()
            if errors:
                raise errors[0]
        finally:
            # a consumer that stops early: the producer ends after the batch
            # it is building (joined here, so that it adds nothing to a later
            # pass's build_s or batch counts), and the batches it queued are freed
            stop.set()
            producer.join()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
