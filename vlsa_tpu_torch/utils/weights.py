"""The weight bridge: a vlsa_tpu VLSA or DeepMIL parameter tree -> this
package's state dict (the inverse of vlsa_tpu/utils/torch_import.py), and
back (`jax_tree_from_state_dict`).

The tree is given as nested dicts of numpy arrays (`jax.tree.map(np.asarray,
params)`), so nothing here imports JAX.  Names map as follows:

    resblock_<i>             -> resblocks.<i>
    <LayerNorm>/scale        -> <LayerNorm>.weight
    <Dense>/kernel [in, out] -> <Linear>.weight [out, in]
    anything else            -> the same path joined by "."

so a DeepMIL tree's `sigma/fc1_kernel` [D, hid] (the ABMIL pooling keeps
the tree's names and layouts) becomes `sigma.fc1_kernel`, `g/kernel`
`g.weight`, `feat_proj/norm/scale` `feat_proj.norm.weight`.

Trees of the Adapter and frozen-CoOp paths (no `prompt_encoder`; a
`prompt_adapter/...` subtree, or neither learner) map the same way.

Every leaf maps to exactly one tensor; a duplicate raises.  Loading the
result with `strict=True` then proves that no tensor was left out.  No leaf
of either tree is itself named "weight", so the way back is unique: a 1-D
`.weight` was a LayerNorm's `scale`, a 2-D one a Dense `kernel`.
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


def _jax_path(name: str, arr: np.ndarray):
    parts = []
    for p in name.split("."):
        if parts and parts[-1] == "resblocks":
            parts[-1] = f"resblock_{p}"
        else:
            parts.append(p)
    if parts[-1] == "weight":
        if arr.ndim == 1:
            parts[-1] = "scale"
        elif arr.ndim == 2:
            parts[-1] = "kernel"
            arr = arr.T
        else:
            raise ValueError(f"{name}: a {arr.ndim}-D weight has no vlsa_tpu counterpart")
    return parts, arr


def jax_tree_from_state_dict(state_dict: Mapping) -> dict:
    """The inverse of `state_dict_from_jax`: nested dicts of numpy arrays
    under vlsa_tpu's names (bf16 tensors become f32 arrays)."""
    tree: dict = {}
    for name, tensor in state_dict.items():
        arr = tensor.detach().cpu()
        arr = (arr.float() if arr.dtype == torch.bfloat16 else arr).numpy()
        parts, arr = _jax_path(name, arr)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        if parts[-1] in node:
            raise ValueError(f"two tensors map to {'/'.join(parts)}")
        node[parts[-1]] = np.array(arr)
    return tree
