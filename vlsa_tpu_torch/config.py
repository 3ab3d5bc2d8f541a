"""Flat experiment configs (counterpart of vlsa_tpu/config.py): loading,
`{0}`-`{3}` placeholders, prefix namespacing, grid expansion with
save-path abbreviations, and the printed config and metric tables.  YAML is
imported only where a file is read or written."""
from __future__ import annotations

import contextlib
import sys
from typing import Any, Dict, List

import numpy as np

from .data.io import load_init_text

# per-cohort disk location (`{1}`) and number of language priors (`{3}`)
DATASET_CFG: Dict[str, Dict[str, Any]] = {
    "tcga_brca":   {"disk_location": "NAS02", "num_query": 10},
    "tcga_blca":   {"disk_location": "NAS01", "num_query": 12},
    "tcga_gbmlgg": {"disk_location": "NAS01", "num_query": 7},
    "tcga_luad":   {"disk_location": "NAS01", "num_query": 8},
    "tcga_ucec":   {"disk_location": "NAS01", "num_query": 10},
}

FLAGSHIP_NUM_RANKS = 12  # the flagship's rank bins (12 ranks from 4 base ranks)
# keys that decide the served model; the training grid's other lists
# (folds, shot counts) do not matter to serving
_SERVING_KEYS = ("vlsa_", "deepmil_", "net_dims", "feats_", "arch", "dataset_name",
                 "path_patch", "seed", "net_output_converter")


def load_config(path: str) -> dict:
    import yaml
    with open(path, "r") as f:
        return yaml.safe_load(f)


def fill_placeholder(target, fill, ind="{}"):
    """Replace the placeholder `ind` of `target` by `fill`, keeping an int or
    float target's type."""
    _target = str(target)
    if ind not in _target:
        return target
    new_target = _target.replace(ind, str(fill))
    if isinstance(target, int):
        return int(new_target)
    if isinstance(target, float):
        return float(new_target)
    return new_target


def fetch_kws(d: dict, prefix: str = "") -> dict:
    """Harvest `<prefix>_<key>` entries into a sub-dict."""
    if prefix == "":
        return d
    ret = {}
    for k in d:
        if k.startswith(prefix):
            new_key = k.split(prefix)[1]
            if len(new_key) < 2:
                continue
            ret[new_key[1:]] = d[k]
    return ret


def parse_str_dims(s, sep: str = "-", dtype=int) -> list:
    """'512-256-4' -> [512, 256, 4]."""
    if not isinstance(s, str):
        return [s]
    return [dtype(x) for x in s.split(sep)]


def serving_config(cfg: dict) -> dict:
    """A config ready to build a model from: one-element lists (grid keys)
    become their value, `{0}` takes the dataset name, a null query count
    takes the number of prior sentences, and a null rank count (set from
    the cohort's label bins when training) takes the flagship's 12."""
    out = {}
    for k, v in cfg.items():
        if isinstance(v, list):
            if len(v) == 1:
                v = v[0]
            elif k.startswith(_SERVING_KEYS):
                raise ValueError(f"{k} lists {len(v)} values; serve one configuration")
        out[k] = v
    name = out.get("dataset_name", "")
    for key in ("path_patch", "path_table", "data_split_path",
                "vlsa_img_encoder_query_text_load_idx"):
        if isinstance(out.get(key), str):
            out[key] = out[key].replace("{0}", name)
    if out.get("vlsa_img_encoder_query") == "Text" \
            and out.get("vlsa_img_encoder_num_query") is None:
        out["vlsa_img_encoder_num_query"] = len(load_init_text(
            out["vlsa_img_encoder_query_text_load_path"],
            key=out["vlsa_img_encoder_query_text_load_idx"]))
    key = "vlsa_pmt_learner_coop_num_ranks"
    if key in out and out[key] is None:
        out[key] = FLAGSHIP_NUM_RANKS
    return out


def training_config(cfg: dict, fold: int = 0) -> dict:
    """`serving_config` for one fold of the cross-validation grid: the
    fold is taken from the listed `data_split_seed` values and fills `{2}`
    of `data_split_path`.  The rank count is set from the label bins once
    they are known."""
    seeds = cfg.get("data_split_seed", fold)
    if fold not in (seeds if isinstance(seeds, list) else [seeds]):
        raise ValueError(f"fold {fold} is not among data_split_seed {seeds}")
    out = serving_config(dict(cfg, data_split_seed=fold))
    out["data_split_path"] = str(out["data_split_path"]).replace("{2}", str(fold))
    return out


def args_grid(kwargs: dict) -> List[dict]:
    """The cartesian grid of the list-valued keys, each a config with scalars
    only, in vlsa_tpu's order (np.meshgrid(...).T over the listed keys; the
    values stay the config's own Python objects)."""
    listed = {k: v for k, v in kwargs.items() if isinstance(v, list)}
    fixed = {k: v for k, v in kwargs.items() if not isinstance(v, list)}
    if not listed:
        return [dict(kwargs)]
    index = np.array(np.meshgrid(*(np.arange(len(v)) for v in listed.values())))
    out = []
    for row in index.T.reshape(-1, len(listed)):
        cfg = dict(fixed)
        cfg.update({k: v[int(i)] for (k, v), i in zip(listed.items(), row)})
        out.append(cfg)
    return out


# abbreviations of grid keys in the save-path suffixes of a multi-run
ABBR_MAPS = {
    "vlsa_img_encoder_name": "mil",
    "vlsa_img_encoder_query": "que",
    "vlsa_img_encoder_query_pooling": "qpool",
    "vlsa_img_encoder_query_text_method": "tex",
    "vlsa_img_encoder_query_text_load_idx": "qkey",
    "vlsa_img_encoder_gated_query": "gatq",
    "vlsa_img_encoder_query_text_res_ratio": "resr",
    "vlsa_img_encoder_pred_head": "head",
    "vlsa_pmt_learner_coop_method": "coop",
    "vlsa_pmt_learner_adapter_method": "adap",
    "data_split_seed": "fold",
    "num_shot": "shot",
    "seed_shot": "fssd",
    "vlsa_img_encoder_pooling": "pool",
    "dataset_name": "data",
}

# grid keys never appended to save_path
_IGNORE_IN_SAVE_PATH = {
    "num_shot": lambda x: x < 0,
    "dataset_name": lambda x: True,
}


def convert_to_abbr(key):
    return ABBR_MAPS.get(key, key)


def ignore_in_save_path(key, value) -> bool:
    fn = _IGNORE_IN_SAVE_PATH.get(key)
    return bool(fn(value)) if fn is not None else False


def _output(path):
    """A file to write at `path`, or stdout (left open) when it is None."""
    return open(path, "w") if path is not None else contextlib.nullcontext(sys.stdout)


def print_config(config: dict, print_to_path=None):
    """The config sorted by key, to stdout or a file."""
    with _output(print_to_path) as f:
        print("**************** MODEL CONFIGURATION ****************", file=f)
        for key in sorted(config.keys()):
            keystr = "{}".format(key) + (" " * (24 - len(key)))
            print("{} -->   {}".format(keystr, config[key]), file=f)
        print("**************** MODEL CONFIGURATION ****************", file=f)


def save_config(config: dict, path_to_save: str):
    import yaml
    with open(path_to_save, "w") as f:
        yaml.dump(config, f)


def print_metrics(metrics: dict, print_to_path=None):
    """The final metric table {split: [(name, value), ...]}."""
    with _output(print_to_path) as f:
        print("**************** MODEL METRICS ****************", file=f)
        for key in sorted(metrics.keys()):
            for name, value in metrics[key]:
                cur_key = key + "/" + name
                keystr = "{}".format(cur_key) + (" " * (20 - len(cur_key)))
                valstr = "{}".format(value)
                if isinstance(value, list):
                    valstr = "{}, avg/std = {:.5f}/{:.5f}".format(valstr, np.mean(value),
                                                                  np.std(value))
                print("{} -->   {}".format(keystr, valstr), file=f)
        print("**************** MODEL METRICS ****************", file=f)


def rename_keys(d: dict, prefix_name: str, sep: str = "/") -> dict:
    return {prefix_name + sep + k: v for k, v in d.items()}
