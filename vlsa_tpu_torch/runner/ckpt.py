"""Checkpoints of a run (counterpart of vlsa_tpu/runner/ckpt.py): best and
last snapshots, `model_saver_module_filter`, and strict=False loading.

The payload is the one the original PyTorch VLSA saves, `torch.save` of
{"epoch", "model": the model's state dict, "optimizer": the optimizer's
state dict}, read back with `torch.load(..., weights_only=True)`.  The
module filter drops every entry whose top-level module name contains it, as
vlsa_tpu filters its parameter tree's top-level keys: with the flagship's
`prompt_encoder` the frozen CONCH text tower is not saved, and a nested
module whose name happens to contain the filter is.  vlsa_tpu's formats
(flax msgpack, `ckpt_backend: orbax`) are neither read nor written here.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
from torch import nn


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


def load_checkpoint(path: str) -> dict:
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
