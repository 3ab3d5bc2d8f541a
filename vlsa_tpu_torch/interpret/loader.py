"""Reload a trained VLSA run for interpretation (counterpart of
vlsa_tpu/interpret/loader.py; ref utils/model_inference.py:11-21).

The model is rebuilt by `runner.vlsa.build_model` from the `config.yaml`
the handler saved in the run directory, then its checkpoint
`<run_name>_model-<ckpt_type>.ckpt` is laid over it with strict=False
(`runner.ckpt.merge_state`): the frozen text tower, filtered out of the
checkpoint, keeps its rebuilt weights, as in vlsa_tpu.  The checkpoint is
the port's torch file or vlsa_tpu's, msgpack or an orbax directory beside
that name (`runner.ckpt.load_checkpoint`, as vlsa_tpu/interpret/loader.py:34
reads it).
"""
from __future__ import annotations

import os.path as osp

from ..config import load_config
from ..runner.ckpt import load_checkpoint, merge_state


def get_model_cfg(path_run_log: str) -> dict:
    """The config the handler saved beside its checkpoints."""
    full = osp.join(path_run_log, "config.yaml")
    if not osp.exists(full):
        raise RuntimeError(f"[Model CFG] Model configuration is not found in {path_run_log}.")
    print("[Model CFG] loaded config from", full)
    return load_config(full)


def load_vlsa_from_run(run_path: str, ckpt_type: str = "last", run_name: str = "train",
                       return_cfg: bool = False, device=None):
    """The run's VLSA model in eval mode on `device` (CUDA unless "cpu" is
    asked for), and its config with `return_cfg`."""
    from ..runner.vlsa import build_model

    cfg = get_model_cfg(run_path)
    model = build_model(cfg, device=device)
    ckpt = load_checkpoint(osp.join(run_path, f"{run_name}_model-{ckpt_type}.ckpt"))
    merge_state(model, ckpt["model"])
    model.eval()
    return (model, cfg) if return_cfg else model
