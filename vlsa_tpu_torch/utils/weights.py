"""The weight bridge: a vlsa_tpu VLSA or DeepMIL parameter tree -> this
package's state dict (the inverse of vlsa_tpu/utils/torch_import.py), and
back (`jax_tree_from_state_dict`).

The tree is given as nested dicts of numpy arrays (`jax.tree.map(np.asarray,
params)`), so nothing here imports JAX.  Names map as follows:

    resblock_<i>             -> resblocks.<i>
    <LayerNorm>/scale        -> <LayerNorm>.weight
    <Dense>/kernel [in, out] -> <Linear>.weight [out, in]
    anything else            -> the same path joined by "."

and the MIL zoo's depthwise convolution kernels (PPEG's `proj`, `proj1`,
`proj2` and Nyström's `res_conv_kernel`) go from vlsa_tpu's HWIO
(kh, kw, 1, C) to torch's [C, 1, kh, kw] under the same names; ILRA's
`in_proj` [3d, d], `latent`, `pool_seeds`, TransMIL's `cls_token` and
GENConv's scalar `t` keep their names and shapes, and BatchedPatchGCN's
`gcn` scope is a submodule of that name.  So a DeepMIL tree's
`sigma/fc1_kernel` [D, hid] (the ABMIL pooling keeps
the tree's names and layouts) becomes `sigma.fc1_kernel`, `g/kernel`
`g.weight`, `feat_proj/norm/scale` `feat_proj.norm.weight`; the gated
pooling's `sigma/fc1/kernel` `sigma.fc1.weight`; VLFAN's attention query
pooling `query_pool/fc1_kernel` `query_pool.fc1_kernel`; DSMIL's
`fcc_kernel` [C, C, Dv] and `fcc_bias` keep their names.

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


# the MIL zoo's convolution kernels, HWIO in vlsa_tpu and OIHW here
_CONV_KERNELS = ("proj", "proj1", "proj2", "res_conv_kernel")


def _torch_name(path: Tuple[str, ...], arr: np.ndarray):
    parts = [("resblocks." + p.split("_", 1)[1]) if p.startswith("resblock_") else p
             for p in path]
    if parts[-1] in _CONV_KERNELS and arr.ndim == 4:
        arr = arr.transpose(3, 2, 0, 1)
    elif parts[-1] == "scale":
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
    if parts[-1] in _CONV_KERNELS and arr.ndim == 4:
        arr = arr.transpose(2, 3, 1, 0)
    elif parts[-1] == "weight":
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
