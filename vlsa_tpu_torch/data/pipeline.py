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

In `cluster` data mode a batch also carries each bag's cluster ids, in
`graph` mode its patch graph's edges (see `BagBatcher`); both take the
numpy path, as in vlsa_tpu.

A batch's feature, mask, sidecar, cluster and edge entries are views into
one flat host buffer.  Page-locked batches (`pin_memory`, a run on the card)
take theirs from cudaHostAlloc: the exact bytes, unlike torch's host
allocator, which rounds each block up to a power of two and keeps it.  A
pass (one iteration) builds its batches in a ring of at most `prefetch` + 2
buffers (one being built, `prefetch` queued, and the one the consumer
holds, whose copy to the card may still be in flight), taken from
`PINNED_POOL`, which keeps them for the run's next pass.  A buffer is made
only when no given-back one is free, so a pass whose producer is the
slower side makes few.  The consumer gives a batch back when it asks for
the next one: its buffer is written again only after the CUDA event
recorded then (after the copies it issued) has completed, so a batch's
entries are the consumer's until it asks for the next batch, and it copies
what it keeps longer.  A new buffer is sized to the pass's largest batch
where every batch takes the native path (the bags' lengths are in the
files' headers, read at the pass's start), else to the largest batch so
far; a buffer too small for a batch is replaced, the old one given back to
the system.  So a run's page-locked bytes are at most (`prefetch` + 2) x
its largest batch's, whatever the number of bucket shapes.  `make_batch`
called on its own builds the batch in a buffer of its own, freed with the
batch.
"""
from __future__ import annotations

import ctypes
import functools
import glob
import os
import queue
import threading
import time
import weakref
from typing import Iterator, List, Optional, Sequence, Tuple

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


_ALIGN = 256  # bytes: the offset of each entry in a buffer


def _cuda_check(err, what: str) -> None:
    code = int(getattr(err, "value", err))
    if code != 0:
        raise RuntimeError(f"{what} failed with CUDA error {code}")


@functools.lru_cache(maxsize=None)
def _cudart():
    """The CUDA runtime that torch loaded (its cudaHostAlloc and
    cudaFreeHost, which torch does not expose)."""
    names = [f"libcudart.so.{torch.version.cuda.split('.')[0]}"] + sorted(glob.glob(
        os.path.join(os.path.dirname(torch.__file__), "..", "nvidia", "cuda_runtime", "lib",
                     "libcudart.so*")))
    for name in names:
        try:
            rt = ctypes.CDLL(name)
        except OSError:
            continue
        rt.cudaHostAlloc.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_size_t,
                                     ctypes.c_uint]
        rt.cudaFreeHost.argtypes = [ctypes.c_void_p]
        return rt
    raise RuntimeError(f"no CUDA runtime library found (tried {names})")


def _host_buffer(nbytes: int, page_locked: bool) -> torch.Tensor:
    """`nbytes` of host memory as a uint8 tensor: from cudaHostAlloc, the
    exact bytes page-locked, freed (cudaFreeHost) once no tensor refers to
    it; pageable without `page_locked`."""
    if not page_locked:
        return torch.empty(nbytes, dtype=torch.uint8)
    rt = _cudart()
    torch.cuda.init()
    ptr = ctypes.c_void_p()
    _cuda_check(rt.cudaHostAlloc(ctypes.byref(ptr), max(nbytes, 1), 0), "cudaHostAlloc")
    memory = (ctypes.c_uint8 * max(nbytes, 1)).from_address(ptr.value)
    weakref.finalize(memory, rt.cudaFreeHost, ptr.value)
    return torch.frombuffer(memory, dtype=torch.uint8)  # keeps `memory` alive


def _entry_bytes(shape, dtype) -> int:
    n = dtype.itemsize
    for d in shape:
        n *= int(d)
    return n


def layout_bytes(specs: Sequence[Tuple[str, tuple, torch.dtype]]) -> int:
    """The bytes a batch of these entries ((name, shape, dtype) each) takes
    in a buffer."""
    return sum(-(-_entry_bytes(shape, dtype) // _ALIGN) * _ALIGN for _n, shape, dtype in specs)


def _views(buf: torch.Tensor, specs) -> "PooledBatch":
    out, off = PooledBatch(), 0
    for name, shape, dtype in specs:
        n = _entry_bytes(shape, dtype)
        out[name] = buf[off:off + n].view(dtype).view(shape)
        off += -(-n // _ALIGN) * _ALIGN
    out.buffer, out.views = buf, [name for name, _s, _d in specs]
    return out


class PooledBatch(dict):
    """A batch whose entries `views` are views of one host buffer
    (`buffer`)."""
    buffer: Optional[torch.Tensor] = None
    views: Sequence[str] = ()


class _Stopped(Exception):
    """The pass a ring serves has ended."""


class _Ring:
    """One pass's hold on a BatchPool: at most `size` buffers.  `take` reuses
    a buffer given back (waiting for one at the cap) or takes one from the
    pool; a buffer is written again only after the CUDA event recorded when
    its batch was given back has completed."""

    def __init__(self, pool: "BatchPool", size: int, planned: int = 0):
        self.pool, self.size, self.planned = pool, max(1, size), planned
        self.held: List[torch.Tensor] = []
        self.returned: "queue.SimpleQueue" = queue.SimpleQueue()
        self.stopped = False

    def _next(self):
        try:
            return self.returned.get_nowait()
        except queue.Empty:
            pass
        if len(self.held) < self.size:
            buf, event = self.pool.pop()
            if buf is not None:
                self.held.append(buf)
            return buf, event
        while True:
            try:
                return self.returned.get(timeout=0.05)
            except queue.Empty:
                if self.stopped:
                    raise _Stopped() from None

    def take(self, nbytes: int) -> torch.Tensor:
        buf, event = self._next()
        if event is not None:
            event.synchronize()
        if buf is not None and buf.numel() >= nbytes:
            return buf
        old = 0
        if buf is not None:  # too small: its memory goes back before the new one is made
            old = buf.numel()
            self.held = [b for b in self.held if b is not buf]
            del buf
        buf = self.pool.fit(old, nbytes, self.planned)
        self.held.append(buf)
        return buf

    def give_back(self, batch) -> None:
        """The consumer is done with `batch` (it asked for the next one): its
        buffer may be written again once the copies issued so far on the
        current stream have completed, and the views leave the batch (a
        consumer that reads them later fails instead of reading another
        batch)."""
        buf, batch.buffer = getattr(batch, "buffer", None), None
        for name in getattr(batch, "views", ()):
            batch.pop(name, None)
        if buf is not None:
            self.returned.put((buf, _copies_done(self.pool.page_locked)))

    def close(self) -> None:
        """The pass is over: every buffer goes back to the pool, behind an
        event after the copies issued so far."""
        self.pool.push(self.held, _copies_done(self.pool.page_locked))
        self.held = []


def _copies_done(page_locked: bool):
    """An event after the copies issued so far on the current stream (None
    for pageable buffers: no copy reads them asynchronously)."""
    if not page_locked:
        return None
    event = torch.cuda.Event()
    event.record()
    return event


class BatchPool:
    """The host buffers that batches are built in (see the module's
    docstring), kept between the passes of a run.  `ring(size)` gives a
    pass its hold of at most `size` buffers.

    `nbytes` is the bytes of the pool's buffers now, `peak_bytes` their most
    since `reset_peak`, `largest` the largest batch's bytes since then (a
    planned pass's largest counted when its first buffer is made),
    `buffers_made` and `buffers_s` the buffers allocated and the seconds
    that took (page-locking included)."""

    def __init__(self, page_locked: bool = True):
        self.page_locked = page_locked
        self.lock = threading.Lock()
        self.free: List[tuple] = []  # (buffer, event) between passes
        self.nbytes = self.peak_bytes = self.largest = self.buffers_made = 0
        self.buffers_s = 0.0

    def ring(self, size: int, planned: int = 0) -> _Ring:
        return _Ring(self, size, planned)

    def pop(self) -> tuple:
        """A free buffer and its event (the largest), or (None, None)."""
        with self.lock:
            if not self.free:
                return None, None
            i = max(range(len(self.free)), key=lambda j: self.free[j][0].numel())
            return self.free.pop(i)

    def push(self, bufs, event) -> None:
        with self.lock:
            self.free.extend((b, event) for b in bufs)

    def fit(self, old: int, nbytes: int, planned: int = 0) -> torch.Tensor:
        """A new buffer for a batch of `nbytes`, in place of one of `old`
        bytes (0 for none) that was too small: sized to the pass's largest
        batch where it is `planned`, else to the largest batch so far."""
        with self.lock:
            self.largest = max(self.largest, nbytes, planned)
            cap = max(nbytes, planned) if planned else self.largest
            self.nbytes += cap - old
            self.peak_bytes = max(self.peak_bytes, self.nbytes)
        t = time.perf_counter()
        buf = _host_buffer(cap, self.page_locked)
        with self.lock:
            self.buffers_made += 1
            self.buffers_s += time.perf_counter() - t
        return buf

    def reset_peak(self) -> None:
        """Start the statistics anew (`largest` too)."""
        with self.lock:
            self.peak_bytes = self.nbytes
            self.buffers_made, self.buffers_s, self.largest = 0, 0.0, 0

    def release(self) -> None:
        """Give the free buffers' memory back to the system (the end of a
        run)."""
        with self.lock:
            free, self.free = self.free, []
            self.nbytes -= sum(b.numel() for b, _e in free)
        for _b, event in free:
            if event is not None:
                event.synchronize()
        del free


PINNED_POOL = BatchPool(page_locked=True)


def release_pinned_batches() -> None:
    """Return to the system the page-locked memory that batches are built
    in (the free buffers of `PINNED_POOL`), and the blocks torch's host
    allocator keeps after the tensors made in them are freed (other host
    staging, such as data/extract.py's).  A run on the card calls it at its
    end: within the run the buffers serve every pass's batches again."""
    if not torch.cuda.is_available():
        return
    PINNED_POOL.release()
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
    feats_inv [B, N] f32 = 1/||x_int||; from a dataset in `cluster` mode
    cluster_id [B, N] int32 (zero-padded), in `graph` mode edge_index
    [B, 2, E] int32 and edge_valid [B, E] bool, E the batch's most edges
    (at least 1), as vlsa_tpu/data/pipeline.py builds them.

    Bags longer than the bucket follow `overflow`: 'error' (the reference
    uses every patch), 'warn' or 'truncate' (keep the first patches).
    `pin_memory` puts the feature, mask, sidecar, cluster and edge tensors
    in page-locked memory: an iteration builds them in buffers of
    `PINNED_POOL` (the module's docstring; `pool` another BatchPool), valid
    until the consumer asks for the next batch.  A run on the card sets it,
    and releases the memory at its end (`release_pinned_batches`).  After each pass, `build_s` holds the
    seconds spent building its batches and `producer` the thread that built
    them (None without prefetch)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False, seed: int = 0,
                 min_bucket: int = 256, max_bucket: Optional[int] = None,
                 fixed_bucket: Optional[int] = None,
                 feats_dtype: str = "float32", overflow: str = "error",
                 precompute_inv: bool = True, prefetch: int = 2, pin_memory: bool = False,
                 pool: Optional[BatchPool] = None):
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
        self.pool = pool if pool is not None else (PINNED_POOL if pin_memory else None)
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

    def _entries(self, specs, ring: Optional[_Ring]) -> "PooledBatch":
        """Uninitialised host tensors for the batch entries `specs` ((name,
        shape, dtype) each): views into one buffer, taken from `ring` in a
        pass, else a buffer of the batch's own, page-locked with
        `pin_memory` (whose copy to the card runs at the bus's rate and does
        not hold up the host)."""
        nbytes = layout_bytes(specs)
        buf = ring.take(nbytes) if ring is not None else _host_buffer(nbytes, self.pin_memory)
        return _views(buf, specs)

    def _feats_specs(self, B: int, N: int, D: int, q8: bool = False) -> list:
        """feats, mask and the int8 sidecars of a batch of B bags of N x D."""
        specs = [("feats", (B, N, D), _TORCH_DTYPE[self.feats_dtype]),
                 ("mask", (B, N), torch.bool)]
        if q8 or self.feats_dtype == "int8":
            specs.append(("feats_scale", (B, N), torch.float32))
            if q8 or self.precompute_inv:
                specs.append(("feats_inv", (B, N), torch.float32))
        return specs

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

    def make_batch(self, indices, ring: Optional[_Ring] = None) -> dict:
        """The batch of dataset rows `indices` (at most `batch_size`), built
        in a buffer of `ring` when given."""
        batch = self._native_batch(indices, ring)
        if batch is None:
            batch = self._numpy_batch(indices, ring)
            _count_batch("numpy")
        else:
            _count_batch("native")
        return batch

    def _numpy_batch(self, indices, ring: Optional[_Ring] = None) -> dict:
        items = [self.dataset[int(i)] for i in indices]
        aux = [it[2] if len(it) > 2 else None for it in items]
        items = [(it[0], it[1]) for it in items]
        mode = getattr(self.dataset, "mode", "patch")
        int8 = self.feats_dtype == "int8"
        quantized = isinstance(items[0][0], QuantizedBag)
        if quantized and not int8:  # another storage wants the f32 values
            items = [(f.dequantize(), label) for f, label in items]
            quantized = False
        target_n = self._target_n(max(f.shape[0] for f, _ in items))
        B, D = self.batch_size, items[0][0].shape[1]
        specs = self._feats_specs(B, target_n, D)
        if mode == "cluster":
            specs.append(("cluster_id", (B, target_n), torch.int32))
        elif mode == "graph":
            max_e = max(1, max(a.shape[1] for a in aux))
            specs += [("edge_index", (B, 2, max_e), torch.int32),
                      ("edge_valid", (B, max_e), torch.bool)]
        batch = self._entries(specs, ring)
        for t in batch.values():
            t.zero_()
        batch.update(self._label_entries(indices, [label for _f, label in items]))
        feats, mask = batch["feats"], batch["mask"]
        for j, a in enumerate(aux):
            if mode == "cluster":
                cid = np.asarray(a, np.int32)
                n = min(len(cid), target_n)
                batch["cluster_id"][j, :n] = torch.from_numpy(cid[:n])
            elif mode == "graph":
                e_j = a.shape[1]
                batch["edge_index"][j, :, :e_j] = torch.from_numpy(a.astype(np.int32))
                batch["edge_valid"][j, :e_j] = True
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

    def _native_groups(self, indices):
        """(each bag's slide files, whether they are .q8npz) where the native
        path applies to the rows `indices`, else None."""
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
        return groups, q8

    @staticmethod
    def _native_sizes(groups, q8: bool):
        """Each bag's patches and the feature width, from the files' headers."""
        read_info = native_loader.read_q8_info if q8 else native_loader.read_npy_info
        shapes = [[read_info(p) for p in g] for g in groups]
        return [sum(rows for rows, _cols in s) for s in shapes], shapes[0][0][1]

    def _planned_bytes(self, chunks) -> int:
        """The bytes of the pass's largest batch, where every batch takes the
        native path (its bags' lengths are in the files' headers), else 0."""
        most = 0
        try:
            for chunk in chunks:
                native = self._native_groups(chunk)
                if native is None:
                    return 0
                sizes, D = self._native_sizes(*native)
                specs = self._feats_specs(self.batch_size, self._target_n(max(sizes)), D,
                                          q8=native[1])
                most = max(most, layout_bytes(specs))
        except OSError:
            return 0  # the batch itself reports it
        return most

    def _native_batch(self, indices, ring: Optional[_Ring] = None) -> Optional[dict]:
        """The batch through native/bagloader.cpp, or None where that path
        does not apply (see the module's docstring) or fails (printed)."""
        native = self._native_groups(indices)
        if native is None:
            return None
        groups, q8 = native
        batch = None
        try:
            sizes, D = self._native_sizes(groups, q8)
            target_n = self._target_n(max(sizes))
            for n in sizes:
                self._count_overflow(n, target_n)
            nb, B = len(groups), self.batch_size
            batch = self._entries(self._feats_specs(B, target_n, D, q8=q8), ring)
            feats, mask = batch["feats"], batch["mask"]
            sidecars = {k: batch[k] for k in ("feats_scale", "feats_inv") if k in batch}
            if q8:
                native_loader.assemble_q8_batch(groups, feats[:nb], sidecars["feats_scale"][:nb],
                                                sidecars["feats_inv"][:nb], mask[:nb])
            elif self.feats_dtype == "float32":
                native_loader.assemble_batch(groups, feats[:nb], mask[:nb])
            else:
                # bf16 or int8 from f32 bags: a chunk of bags at a time (one
                # a C++ thread) through an f32 staging buffer, then cast
                int8 = self.feats_dtype == "int8"
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
            for t in batch.values():
                t[nb:].zero_()  # a tail batch's padded rows
            if not self.precompute_inv:
                batch.pop("feats_inv", None)
            batch.update(self._label_entries(indices, [self.dataset.bag_label(int(i))
                                                       for i in indices]))
            return batch
        except OSError as exc:
            print(f"[BagBatcher] native path failed ({exc}); using numpy")
            if ring is not None and batch is not None:
                ring.give_back(batch)
            return None

    def batch_indices(self) -> Iterator[np.ndarray]:
        order = self._order()
        for start in range(0, len(order), self.batch_size):
            yield order[start:start + self.batch_size]

    def _timed_batch(self, chunk, ring: Optional[_Ring]) -> dict:
        t = time.perf_counter()
        batch = self.make_batch(chunk, ring)
        self.build_s += time.perf_counter() - t
        return batch

    def __iter__(self) -> Iterator[dict]:
        self._epoch += 1
        self.build_s = 0.0
        chunks = list(self.batch_indices())
        ring = (self.pool.ring(max(self.prefetch, 0) + 2, self._planned_bytes(chunks))
                if self.pool is not None else None)
        if self.prefetch <= 0:
            self.producer = None
            try:
                for chunk in chunks:
                    batch = self._timed_batch(chunk, ring)
                    yield batch
                    if ring is not None:
                        ring.give_back(batch)
                    del batch
            finally:
                if ring is not None:
                    ring.close()
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
                    put(self._timed_batch(chunk, ring))
            except _Stopped:
                pass
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
                if ring is not None:
                    ring.give_back(item)
                del item
            producer.join()
            if errors:
                raise errors[0]
        finally:
            # a consumer that stops early: the producer ends after the batch
            # it is building (joined here, so that it adds nothing to a later
            # pass's build_s or batch counts), and the batches it queued are freed
            stop.set()
            if ring is not None:
                ring.stopped = True
            producer.join()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            if ring is not None:
                ring.close()
