"""The experiment command line (counterpart of main.py):

    python -m vlsa_tpu_torch.main --config <yaml> --handler {SA,VLSA,CLF} \\
        [--multi_run] [--sleep N] [--device cuda|cpu]

Trains and evaluates one run of a config, or with `--multi_run` every run
of the grid of its list-valued keys, each with its save path suffixed by
the abbreviated grid values (`-fold_0`, ...), as main.py names them.  A
config with `test: True` evaluates `test_load_path`'s checkpoint instead, and
one with `num_shot: 0` (configs/IFMLE/<cohort>/cfg_zero_shot_conch.yaml)
evaluates zero-shot, over its grid of poolings and folds with `--multi_run`.
`--handler CLF` runs a `task: clf` config (slide classification,
runner/clf.py).  Runs on CUDA unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import time

from .config import args_grid, convert_to_abbr, ignore_in_save_path, load_config, print_config
from .runner.clf import CLFHandler
from .runner.sa import SAHandler
from .runner.vlsa import VLSAHandler
from .utils.device import resolve_device

HANDLERS = {"SA": SAHandler, "VLSA": VLSAHandler, "CLF": CLFHandler}


def get_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", "-f", required=True, type=str,
                        help="Path to the config file.")
    parser.add_argument("--handler", "-d", type=str, choices=["SA", "VLSA", "CLF"],
                        default="VLSA", help="Model handler.")
    parser.add_argument("--multi_run", action="store_true",
                        help="If execute multi-experiments in this run.")
    parser.add_argument("--sleep", type=int, default=0,
                        help="Seconds to sleep between runs (multi_run mode).")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    return vars(parser.parse_args(argv))


def run(handler, config, device=None):
    model = handler(config, device=device)
    metrics = model.exec_test() if config.get("test") else model.exec()
    print("[INFO] Metrics:", metrics)
    return metrics


def multi_run_main(handler, config, sleep=0, device=None):
    hyperparams = [k for k, v in config.items() if isinstance(v, list)]
    results = []
    for cur_cfg in args_grid(config):
        print("\n")
        for k in hyperparams:
            if ignore_in_save_path(k, cur_cfg[k]):
                print(f"[info] `{k}` is ignored and will not be added to `save_path`.")
                continue
            abbr_key = convert_to_abbr(k)
            abbr_value = convert_to_abbr(cur_cfg[k])
            cur_cfg["save_path"] += f"-{abbr_key}_{abbr_value}"
            if cur_cfg.get("test"):
                cur_cfg["test_save_path"] += f"-{abbr_key}_{abbr_value}"
        results.append(run(handler, cur_cfg, device))
        time.sleep(sleep)
    return results


def main(argv=None):
    cli = get_args(argv)
    device = resolve_device(cli["device"])
    config = load_config(cli["config"])
    print_config(config)
    handler = HANDLERS[cli["handler"]]
    if cli["multi_run"]:
        return multi_run_main(handler, config, sleep=cli["sleep"], device=device)
    return run(handler, config, device)


if __name__ == "__main__":
    main()
