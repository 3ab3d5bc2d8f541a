"""The weight bridge: a vlsa_tpu VLSA or DeepMIL parameter tree -> this
package's state dict (the inverse of vlsa_tpu/utils/torch_import.py).

The tree is given as nested dicts of numpy arrays (`jax.tree.map(np.asarray,
params)`), so nothing here imports JAX.  Names map as follows:

    resblock_<i>             -> resblocks.<i>
    <LayerNorm>/scale        -> <LayerNorm>.weight
    <Dense>/kernel [in, out] -> <Linear>.weight [out, in]
    anything else            -> the same path joined by "."

so a DeepMIL tree's `sigma/fc1_kernel` [D, hid] (the ABMIL pooling keeps
the tree's names and layouts) becomes `sigma.fc1_kernel`, `g/kernel`
`g.weight`, `feat_proj/norm/scale` `feat_proj.norm.weight`.

Every leaf maps to exactly one tensor; a duplicate raises.  Loading the
result with `strict=True` then proves that no tensor was left out.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch


def _flatten(tree, path=()):
    if isinstance(tree, Mapping) or hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _flatten(v, path + (str(k),))
    else:
        yield path, np.asarray(tree)


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.name == "bfloat16":  # numpy's bf16 extension type
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))  # a writable, contiguous copy


def _torch_name(path: Tuple[str, ...], arr: np.ndarray):
    parts = [("resblocks." + p.split("_", 1)[1]) if p.startswith("resblock_") else p
             for p in path]
    if parts[-1] == "scale":
        parts[-1] = "weight"
    elif parts[-1] == "kernel":
        parts[-1] = "weight"
        arr = arr.T
    return ".".join(parts), arr


def state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Map every leaf of a vlsa_tpu VLSA parameter tree to a port tensor."""
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _flatten(params):
        name, arr = _torch_name(path, arr)
        if name in out:
            raise ValueError(f"two leaves map to {name}")
        out[name] = _to_tensor(arr)
    return out
