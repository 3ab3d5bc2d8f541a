"""Checkpoints of a run (counterpart of vlsa_tpu/runner/ckpt.py): best and
last snapshots, `model_saver_module_filter`, and strict=False loading.

The port writes the payload the original PyTorch VLSA saves, `torch.save`
of {"epoch", "model": the model's state dict, "optimizer": the optimizer's
state dict}.  The module filter drops every entry whose top-level module
name contains it, as vlsa_tpu filters its parameter tree's top-level keys:
with the flagship's `prompt_encoder` the frozen CONCH text tower is not
saved, and a nested module whose name happens to contain the filter is.

`load_checkpoint` reads that payload and both of vlsa_tpu's, as vlsa_tpu's
`load_checkpoint` chooses: an orbax directory at `path + ".orbax"` (or a
`path` that ends in ".orbax"; `runner/orbax.py` reads it without orbax),
else a file told apart by content: a torch zip file, or flax's msgpack
(`flax.serialization.msgpack_serialize` of {"epoch", "model": the parameter
tree[, "optimizer": optax's state]}).  Either of vlsa_tpu's trees comes
back through `from_vlsa_tpu`: the parameter tree as this package's state
dict (`utils.weights.state_dict_from_jax`) and optax's state as
"optax_state", which `resume_model` puts into the torch optimizer
(`optim/optax_state.py`).  So `test_model`, `resume_model`, `auto_resume`
and `interpret.load_vlsa_from_run` take a run directory vlsa_tpu trained,
with either backend.  The port writes torch files only, whatever
`ckpt_backend` says.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..utils.weights import state_dict_from_jax
from .orbax import orbax_dir, read_orbax_checkpoint

# flax's msgpack extension type of an array: packb((shape, dtype name,
# C-order bytes)); vlsa_tpu saves every leaf as an array
_EXT_NDARRAY = 1
_CHUNKED = "__msgpack_chunked_array__"


def top_module(key: str) -> str:
    return key.split(".", 1)[0]


def filter_state(state: dict, module_filter: Optional[str]) -> dict:
    """`state` without the entries of top-level modules whose name contains
    `module_filter`."""
    if module_filter is None:
        return dict(state)
    return {k: v for k, v in state.items() if module_filter not in top_module(k)}


def save_checkpoint(path: str, epoch: int, model: nn.Module,
                    module_filter: Optional[str] = None,
                    optimizer: Optional[torch.optim.Optimizer] = None) -> None:
    payload = {"epoch": epoch,
               "model": {k: v.detach().cpu() for k, v in
                         filter_state(model.state_dict(), module_filter).items()}}
    if optimizer is not None:
        payload["optimizer"] = optimizer.state_dict()
    torch.save(payload, path)


def _is_msgpack_map(head: bytes) -> bool:
    """A msgpack map of at least one entry (fixmap, map16, map32).  A torch
    zip file starts with "PK", an older torch file (a pickle) with 0x80, an
    empty fixmap."""
    return bool(head) and (0x81 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF))


def _flax_leaf(code: int, data: bytes):
    """An array of flax's msgpack layout: numpy, or for bfloat16 (which numpy
    has no type for without ml_dtypes) its bits viewed as torch.bfloat16."""
    import msgpack

    if code != _EXT_NDARRAY:
        raise ValueError(f"a flax checkpoint leaf of msgpack extension type {code}")
    shape, dtype, buf = msgpack.unpackb(data, raw=True)
    if dtype == b"bfloat16":
        bits = torch.from_numpy(np.frombuffer(buf, np.int16).copy())
        return bits.view(torch.bfloat16).reshape(tuple(shape))
    return np.frombuffer(buf, np.dtype(dtype.decode())).reshape(shape).copy()


def _unchunk(tree):
    """flax splits an array over 2**30 bytes into {"__msgpack_chunked_array__",
    "shape", "chunks"}, tuples as {"0": ..., "1": ...}; join them back."""
    if not isinstance(tree, dict):
        return tree
    if tree.get(_CHUNKED):
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        joined = (torch.cat(chunks) if isinstance(chunks[0], torch.Tensor)
                  else np.concatenate(chunks))
        return joined.reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def from_vlsa_tpu(tree: dict) -> dict:
    """A checkpoint tree vlsa_tpu saved -> {"epoch", "model": this
    package's state dict[, "optax_state": the optimizer's tree as read]}."""
    out = {"epoch": tree["epoch"], "model": state_dict_from_jax(tree["model"])}
    if "optimizer" in tree:
        out["optax_state"] = tree["optimizer"]
    return out


def read_flax_checkpoint(path: str) -> dict:
    """The tree of a msgpack checkpoint vlsa_tpu wrote."""
    import msgpack

    with open(path, "rb") as f:
        return _unchunk(msgpack.unpackb(f.read(), ext_hook=_flax_leaf, raw=False))


def load_checkpoint(path: str) -> dict:
    """The port's torch checkpoint, or vlsa_tpu's orbax or msgpack one (see
    the module's docstring)."""
    directory = orbax_dir(path)
    if directory is not None:
        return from_vlsa_tpu(read_orbax_checkpoint(directory))
    with open(path, "rb") as f:
        head = f.read(1)
    if _is_msgpack_map(head):
        return from_vlsa_tpu(read_flax_checkpoint(path))
    return torch.load(path, map_location="cpu", weights_only=True)


def merge_state(model: nn.Module, loaded: dict) -> None:
    """strict=False loading: the loaded entries replace the model's, the
    filtered-out modules keep their current values; an entry the model does
    not have raises."""
    unknown = sorted(set(loaded) - set(model.state_dict()))
    if unknown:
        raise KeyError(f"the checkpoint holds entries the model lacks: {unknown[:5]}")
    model.load_state_dict(loaded, strict=False)


def add_prefix_to_filename(path: str, prefix: str = "") -> str:
    dir_name, file_name = os.path.split(path)
    return os.path.join(dir_name, prefix + "_" + file_name)
