"""Config validation: required keys and type checks over the flat-YAML
surface (counterpart of vlsa_tpu/config_schema.py, the same rules), so that
a typo in a prefixed key name shows before a run starts.  Problems are
printed, and raise when `strict_config` is set.  The `jax_*` keys of
vlsa_tpu's configs are accepted and ignored by this package.
"""
from __future__ import annotations

REQUIRED_COMMON = {
    "task", "seed", "save_path", "dataset_name", "path_patch", "path_table",
    "data_mode", "feat_format", "data_split_path", "data_split_seed",
    "arch", "loss_type", "evaluator", "opt_name", "opt_lr", "epochs",
    "bp_every_batch",
}

REQUIRED_BY_TASK = {
    "sa": {"time_format", "net_dims", "net_output_converter"},
    "vlsa": {"time_format", "vlsa_api", "vlsa_img_encoder_name",
             "vlsa_pmt_learner_name", "net_output_converter"},
    "clf": {"net_dims", "net_output_converter"},
}

_TYPES = {
    "seed": int,
    "epochs": int,
    "bp_every_batch": int,
    "opt_lr": float,
    "opt_weight_decay": float,
    "batch_size": int,
}

KNOWN_PREFIXES = ("vlsa_", "deepmil_", "loss_", "opt_", "es_", "lrs_", "path_",
                  "test_", "wandb_", "net_", "data_", "time_", "num_", "seed_",
                  "eval_", "ckpt_", "model_", "monitor_", "save_", "feat_",
                  "min_", "max_", "fixed_", "feats_", "accum_", "mesh", "bag_",
                  "distributed", "jax_platforms", "jax_num_", "auto_",
                  "profile_", "debug_", "jax_", "prefetch", "_test_")


def validate_config(cfg: dict, task: str, strict: bool = False) -> list:
    """Returns a list of problems; raises when strict and problems exist."""
    problems = []
    required = REQUIRED_COMMON | REQUIRED_BY_TASK.get(task, set())
    for key in sorted(required):
        if key not in cfg:
            problems.append(f"missing required key: {key}")
    for key, typ in _TYPES.items():
        if key in cfg and cfg[key] is not None and not isinstance(cfg[key], (typ, list)):
            if typ is float and isinstance(cfg[key], int):
                continue
            problems.append(f"key {key} should be {typ.__name__}, got "
                            f"{type(cfg[key]).__name__}")
    if cfg.get("feats_dtype") not in (None, "float32", "bfloat16", "int8"):
        problems.append(f"feats_dtype must be float32|bfloat16|int8, got "
                        f"{cfg['feats_dtype']!r}")
    if problems:
        msg = "[config] validation problems:\n  " + "\n  ".join(problems)
        if strict:
            raise ValueError(msg)
        print(msg)
    return problems
