"""Host-side IO: prompt assets and synthetic bags (counterpart of the parts
of vlsa_tpu/data/io.py that serving reads)."""
from __future__ import annotations

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
