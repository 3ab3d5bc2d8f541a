"""Flat experiment configs (counterpart of the loading half of
vlsa_tpu/config.py).  YAML is imported only where a file is read."""
from __future__ import annotations

from .data.io import load_init_text

FLAGSHIP_NUM_RANKS = 12  # the flagship's rank bins (12 ranks from 4 base ranks)
# keys that decide the served model; the training grid's other lists
# (folds, shot counts) do not matter to serving
_SERVING_KEYS = ("vlsa_", "deepmil_", "net_dims", "feats_", "arch", "dataset_name",
                 "path_patch", "seed", "net_output_converter")


def load_config(path: str) -> dict:
    import yaml
    with open(path, "r") as f:
        return yaml.safe_load(f)


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
