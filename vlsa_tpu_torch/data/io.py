"""Host-side IO: prompt assets, synthetic bags and prediction CSVs
(counterpart of the parts of vlsa_tpu/data/io.py that serving, training and
evaluation read)."""
from __future__ import annotations

import csv
import hashlib
import json
import os

import numpy as np

ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "assets")
SYNTHETIC_PREFIX = "synthetic://"
_REFERENCE_ASSETS = "vlsa_tpu/assets/"


def resolve_asset(path: str) -> str:
    """Configs name the bundled prompt files by their path in the JAX package
    (`vlsa_tpu/assets/tools/...`); this package reads its own copies."""
    norm = str(path).replace(os.sep, "/")
    if norm.startswith(_REFERENCE_ASSETS):
        return os.path.join(ASSET_DIR, norm[len(_REFERENCE_ASSETS):])
    return path


def _synthetic_params(path: str) -> dict:
    params = {"N": 1024, "D": 512, "seed": 0, "jitter": 1}
    for part in path[len(SYNTHETIC_PREFIX):].split(","):
        if part:
            k, v = part.split("=")
            params[k] = int(v)
    return params


def synthetic_bag(uid: str, path: str) -> np.ndarray:
    """Deterministic random bag [n, D] f32 keyed by (uid, path spec):
    `synthetic://N=<n>,D=<d>[,seed=<s>][,jitter=0|1]`; with jitter the bag
    length is n scaled by U(0.5, 1.5)."""
    p = _synthetic_params(path)
    h = int(hashlib.sha1(uid.encode()).hexdigest()[:8], 16)
    rng = np.random.default_rng(p["seed"] * 1000003 + h)
    n = p["N"]
    if p.get("jitter", 1):
        n = max(8, int(n * rng.uniform(0.5, 1.5)))
    return rng.normal(size=(n, p["D"])).astype(np.float32)


def synthetic_cluster_ids(uid: str, n: int, num_clusters: int, seed: int = 0) -> np.ndarray:
    """Deterministic cluster ids [n] int64 in [0, num_clusters), keyed by
    (uid, seed): a bag's `cluster` mode file for synthetic cohorts."""
    h = int(hashlib.sha1(uid.encode()).hexdigest()[:8], 16)
    return np.random.default_rng(seed * 1000003 + h).integers(0, num_clusters, size=n)


def grid_edge_index(n: int) -> np.ndarray:
    """The 8-neighbour adjacency of n patches laid row by row on a grid
    ceil(sqrt(n)) wide, both directions of each edge: [2, E] int64, about
    8n edges (a slide's patch graph for synthetic cohorts)."""
    w = max(1, int(np.ceil(np.sqrt(n))))
    idx = np.arange(n)
    r, c = idx // w, idx % w
    src, dst = [], []
    for dr, dc in ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1)):
        rr, cc = r + dr, c + dc
        nb = rr * w + cc
        ok = (rr >= 0) & (cc >= 0) & (cc < w) & (nb < n)
        src.append(idx[ok])
        dst.append(nb[ok])
    return np.stack([np.concatenate(src), np.concatenate(dst)]).astype(np.int64)


def load_init_prompt(prompt_path, context_idx=0, rank_idx=0, replace=False):
    """Context template and per-class rank names from a prompt JSON."""
    if prompt_path is None:
        return None, None
    with open(resolve_asset(prompt_path), "r") as f:
        prompts = json.load(f)
    context = prompts["context_templates"][context_idx]
    names = []
    for k in prompts["class_names"].keys():
        name = prompts["class_names"][k][rank_idx]
        names.append(context.replace("CLASSNAME", name) if replace else name)
    return context, names


def load_init_text(path, key=None):
    with open(resolve_asset(path), "r") as f:
        texts = json.load(f)
    return texts if key is None else texts[str(key)]


def _csv_cell(v) -> str:
    """A value as pandas' `to_csv` writes it: numpy's shortest repr of the
    value in its own type ('0.9' for float32 0.9), nan as an empty cell."""
    if isinstance(v, np.floating) and np.isnan(v):
        return ""
    return str(v)


def save_prediction_surv(patient_id, y_true, y_pred, save_path, **kws):
    """Survival prediction CSV (vlsa_tpu/data/io.py::save_prediction_surv,
    written with `csv`, byte for byte as its pandas writes it): columns
    patient_id, t, e, risk = sum of the survival curve, surf_1..surf_K; a
    [B, 1] prediction writes patient_id, t, e, pred.  The curve is
    1 - cumsum(y_pred) for incidence predictions (`type_pred` naming IF or
    "incidence"), else cumprod(1 - y_pred)."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    assert len(patient_id) == len(y_true) == len(y_pred)
    if y_pred.ndim == 2 and y_pred.shape[1] == 1:
        header = ["patient_id", "t", "e", "pred"]
        cols = [y_true[:, 0], y_true[:, 1], np.squeeze(y_pred, 1)]
    else:
        bins = y_pred.shape[1]
        type_pred = str(kws.get("type_pred"))
        if "IF" in type_pred or type_pred == "incidence":
            survival = 1.0 - np.cumsum(y_pred, axis=1)
        else:
            survival = np.cumprod(1.0 - y_pred, axis=1)
        risk = np.sum(survival, axis=1, keepdims=True)
        arr = np.concatenate((y_true[:, [0]], y_true[:, [1]], risk, survival), axis=1)
        header = ["patient_id", "t", "e", "risk"] + [f"surf_{i + 1}" for i in range(bins)]
        cols = list(arr.T)
    with open(save_path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(header)
        for i, pid in enumerate(patient_id):
            writer.writerow([pid] + [_csv_cell(c[i]) for c in cols])
