"""Serve synthetic requests with the model of an experiment config.

    python -m vlsa_tpu_torch.runner.serve --config configs/IFMLE/tcga_blca/cfg_vlsa_conch.yaml \
        --n_requests 4 [--bags_per_request 8] [--device cuda|cpu]

`task: vlsa` serves the config's VLSA: the flagship, or a zero-shot
config (configs/IFMLE/<cohort>/cfg_zero_shot_conch.yaml with one
`vlsa_img_encoder_pooling`); `task: sa` the SA baseline's DeepMIL/ABMIL
(configs/IFMLE/<cohort>/cfg_sa_base_conch.yaml) or another network of the
zoo (its requests in `data_mode: cluster` carry synthetic cluster ids, in
`graph` 8-neighbour grid graphs), whose head gets the bin
count of fold 0's label table, as the SA handler would give it.  The
weights are random, from the config's seed, but for the text tower of
`path_clip_model` (a released checkpoint) and a `pretrained` CoOp
learner's checkpoint, which are loaded when the config names them.
Each request holds `bags_per_request` bags from the config's
`path_patch: synthetic://...`, stored as its `feats_dtype`.  Prints one JSON
line per request and a summary line.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..config import load_config, serving_config, training_config
from ..data.io import SYNTHETIC_PREFIX, grid_edge_index, synthetic_bag, synthetic_cluster_ids
from ..data.splits import read_file_data_splitting
from ..ops import abmil, coattn
from ..utils.device import resolve_device
from . import sa, vlsa
from .engine import InferEngine


def sa_serving_config(cfg: dict) -> dict:
    """An SA config ready to serve: fold 0's split resolved and `net_dims`
    corrected to the bin count of its label table."""
    cfg = training_config(cfg, fold=0)
    sa.load_meta(cfg, read_file_data_splitting(cfg["data_split_path"]))
    return cfg


def make_engine(cfg: dict, device=None) -> InferEngine:
    """The config's model and storage type behind an InferEngine."""
    if cfg.get("net_output_converter", "softmax") != "softmax":
        raise NotImplementedError("this port serves incidence models (softmax output)")
    feats_dtype = cfg.get("feats_dtype", "float32")
    if cfg.get("task") == "sa":
        # DeepMIL's pooling is unnormalised: no 1/||x|| rows
        return InferEngine(sa.build_model(cfg, device=device), feats_dtype=feats_dtype,
                           precompute_inv=False)
    model = vlsa.build_model(cfg, device=device)
    precompute_inv = feats_dtype == "int8" and cfg.get("feats_precompute_inv", True)
    return InferEngine(model, feats_dtype=feats_dtype, precompute_inv=precompute_inv)


def request_bags(path_patch: str, request: int, n_bags: int):
    return [synthetic_bag(f"request{request}_bag{j}", path_patch) for j in range(n_bags)]


def request_aux(cfg: dict, request: int, bags) -> dict:
    """A request's cluster ids (`data_mode: cluster`, `deepmil_num_clusters`
    of them) or patch graphs (`data_mode: graph`, 8-neighbour grids), made
    from the bags' names: `InferEngine.predict`'s keyword arguments."""
    mode = cfg.get("data_mode", "patch")
    if mode == "cluster":
        k = cfg.get("deepmil_num_clusters", 8)
        return {"cluster_ids": [synthetic_cluster_ids(f"request{request}_bag{j}", b.shape[0], k)
                                for j, b in enumerate(bags)]}
    if mode == "graph":
        return {"edge_lists": [grid_edge_index(b.shape[0]) for b in bags]}
    return {}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--n_requests", type=int, default=4)
    ap.add_argument("--bags_per_request", type=int, default=8)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    raw = load_config(args.config)
    cfg = sa_serving_config(raw) if raw.get("task") == "sa" else serving_config(raw)
    path_patch = cfg["path_patch"]
    if not str(path_patch).startswith(SYNTHETIC_PREFIX):
        raise ValueError("the serving CLI answers synthetic:// requests only")
    t0 = time.perf_counter()
    engine = make_engine(cfg, device)
    engine.text_precompute()
    if device.type == "cuda":
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    coattn.reset_launches()
    abmil.reset_launches()
    times = []
    for r in range(args.n_requests):
        bags = request_bags(path_patch, r, args.bags_per_request)
        t = time.perf_counter()
        out = engine.predict(bags, **request_aux(cfg, r, bags))
        times.append(time.perf_counter() - t)
        if not (np.isfinite(out["probs"]).all()
                and np.allclose(out["probs"].sum(-1), 1.0, atol=1e-5)):
            raise RuntimeError(f"request {r}: probabilities are not a distribution")
        print(json.dumps({"request": r, "bags": len(bags),
                          "max_patches": max(b.shape[0] for b in bags),
                          "ms": 1e3 * times[-1],
                          "risk": out["survival"].sum(-1).round(4).tolist()}))
    summary = {"device": str(device), "feats_dtype": engine.feats_dtype,
               "build_s": build_s, "requests": args.n_requests,
               "median_request_ms": 1e3 * float(np.median(times)),
               "coattn_launches": dict(coattn.LAUNCHES),
               "abmil_launches": dict(abmil.LAUNCHES)}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
