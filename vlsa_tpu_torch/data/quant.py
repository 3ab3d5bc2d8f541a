"""Feature storage types and request padding (counterpart of the storage
half of vlsa_tpu/data/pipeline.py)."""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

FEATS_DTYPES = ("float32", "bfloat16", "int8")


class QuantizedBag(NamedTuple):
    """An int8 bag (vlsa_tpu/data/io.py::QuantizedFeats): q [n, D] int8,
    scale [n] f32 (dequant), inv [n] f32 (1/||q||, 0 for a zero row).  A
    `.q8npz` store holds one per slide; the batcher assembles them into int8
    batches as stored, with no host quantization or norm pass."""
    q: np.ndarray
    scale: np.ndarray
    inv: np.ndarray

    @property
    def shape(self):
        return self.q.shape

    def dequantize(self) -> np.ndarray:
        """The f32 features q * scale."""
        return self.q.astype(np.float32) * self.scale[..., None]

    @staticmethod
    def concatenate(parts: Sequence["QuantizedBag"]) -> "QuantizedBag":
        """The slides of one patient as one bag, in order."""
        return QuantizedBag(*(np.concatenate([getattr(p, k) for p in parts], axis=0)
                              for k in QuantizedBag._fields))


def read_quantized_feats(path: str) -> QuantizedBag:
    """One slide of a `.q8npz` store, its 1/||q|| taken from the store."""
    with np.load(path) as z:
        return QuantizedBag(z["q"], z["scale"], z["inv"])


def quantize_feats_int8(feats: np.ndarray):
    """Per-patch symmetric int8 quantization of [.., N, D] features.
    Returns (q int8, scale f32 [.., N]) with feats ~= q * scale; zero rows
    get scale 0."""
    absmax = np.abs(feats).max(axis=-1)
    scale = (absmax / 127.0).astype(np.float32)
    safe = np.where(scale > 0, scale, 1.0)
    q = np.clip(np.rint(feats / safe[..., None]), -127, 127).astype(np.int8)
    return q, scale


def feats_inv_norms(q: np.ndarray) -> np.ndarray:
    """Per-patch 1/l2norm of stored features [.., N, D] -> f32 [.., N]
    (0 for all-zero rows)."""
    qf = q.astype(np.float32)
    sq = np.einsum("...nd,...nd->...n", qf, qf)
    with np.errstate(divide="ignore"):
        inv = np.where(sq > 0, 1.0 / np.sqrt(sq), 0.0)
    return inv.astype(np.float32)


def quantize_bag(feats: np.ndarray) -> QuantizedBag:
    q, scale = quantize_feats_int8(feats)
    return QuantizedBag(q, scale, feats_inv_norms(q))


Bag = Union[np.ndarray, QuantizedBag]


def pad_request(bags: Sequence[Bag], feats_dtype: str = "float32",
                precompute_inv: Optional[bool] = None,
                device: Union[str, torch.device] = "cpu") -> dict:
    """Pad a request's bags to its longest bag and move them to `device`.

    Returns {"feats" [B, N, D], "mask" [B, N] bool} plus, for int8,
    "feats_scale" [B, N] and, when `precompute_inv` (default: int8 only),
    "feats_inv" [B, N].  f32 bags are stored as `feats_dtype`: bf16 by
    rounding on the host, int8 by quantizing on the host; QuantizedBags are
    taken as they are and need `feats_dtype="int8"`."""
    if feats_dtype not in FEATS_DTYPES:
        raise ValueError(f"feats_dtype must be one of {FEATS_DTYPES}, got {feats_dtype}")
    if not bags:
        raise ValueError("a request holds at least one bag")
    if precompute_inv is None:
        precompute_inv = feats_dtype == "int8"
    quantized = isinstance(bags[0], QuantizedBag)
    if any(isinstance(b, QuantizedBag) != quantized for b in bags):
        raise ValueError("a request holds either f32 bags or QuantizedBags, not both")
    if quantized and feats_dtype != "int8":
        raise ValueError("int8 bags are served with feats_dtype='int8'")
    B = len(bags)
    lengths = [b.q.shape[0] if quantized else b.shape[0] for b in bags]
    D = bags[0].q.shape[1] if quantized else bags[0].shape[1]
    N = max(lengths)
    mask = np.zeros((B, N), np.bool_)
    for j, n in enumerate(lengths):
        mask[j, :n] = True
    out = {"mask": mask}
    if quantized:
        q = np.zeros((B, N, D), np.int8)
        scale = np.zeros((B, N), np.float32)
        inv = np.zeros((B, N), np.float32)
        for j, b in enumerate(bags):
            n = lengths[j]
            q[j, :n], scale[j, :n], inv[j, :n] = b.q, b.scale, b.inv
        out.update(feats=q, feats_scale=scale)
        if precompute_inv:
            out["feats_inv"] = inv
    else:
        feats = np.zeros((B, N, D), np.float32)
        for j, b in enumerate(bags):
            feats[j, :lengths[j]] = b
        if feats_dtype == "int8":
            q, scale = quantize_feats_int8(feats)
            out.update(feats=q, feats_scale=scale)
        elif feats_dtype == "bfloat16":
            out["feats"] = torch.from_numpy(feats).to(torch.bfloat16)
        else:
            out["feats"] = feats
        if precompute_inv:  # 1/||x|| of the values as stored
            stored = out["feats"]
            if isinstance(stored, torch.Tensor):
                stored = stored.float().numpy()
            out["feats_inv"] = feats_inv_norms(stored)
    return {k: torch.as_tensor(v).to(device) for k, v in out.items()}
