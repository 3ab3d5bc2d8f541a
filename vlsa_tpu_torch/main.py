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

Multi-process runs (main.py:60-73): with `distributed` ('auto', a
launcher's environment, or {coordinator_address, num_processes,
process_id[, local_device_ids]}) this process is one rank and joins its
group before any device is touched; a `mesh` ({data: D, model: M}) with no
`distributed` is vlsa_tpu's one process over D x M devices, so this command
starts D x M local ranks itself (spawned, joined through a file
rendezvous) and returns rank 0's metrics.  Every rank prints its final metrics;
only rank 0 writes the run's files.
"""
from __future__ import annotations

import argparse
import ast
import os
import pickle
import re
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from .config import args_grid, convert_to_abbr, ignore_in_save_path, load_config, print_config
from .runner.clf import CLFHandler
from .runner.sa import SAHandler
from .runner.vlsa import VLSAHandler
from .parallel.multihost import init_local_rank, local_rendezvous, maybe_initialize_distributed
from .parallel.sharding import mesh_shape
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


def read_metrics(text: str) -> list:
    """Every `[INFO] Metrics:` line of a run's output (`run` prints one a
    rank), as {split: {metric: value}}."""
    found = []
    for line in text.splitlines():
        hit = re.search(r"\[INFO\] Metrics: (.*)$", line)  # another rank's text may precede it
        if hit:
            body = re.sub(r"np\.float\d+\(([^)]*)\)", r"\1", hit.group(1))
            found.append({split: dict(v) for split, v in ast.literal_eval(body.strip()).items()})
    return found


def run(handler, config, device=None):
    model = handler(config, device=device)
    metrics = model.exec_test() if config.get("test") else model.exec()
    line = f"[INFO] Metrics: {metrics}\n"
    if dist.is_initialized():
        # the ranks of a grid share one stream: the whole line in one write
        sys.stdout.flush()
        os.write(sys.stdout.fileno(), line.encode())
    else:
        print(line, end="", flush=True)
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


def _run_cli(cli: dict, config: dict, device):
    print_config(config)
    handler = HANDLERS[cli["handler"]]
    if cli["multi_run"]:
        return multi_run_main(handler, config, sleep=cli["sleep"], device=device)
    return run(handler, config, device)


def local_ranks(config: dict, device) -> int:
    """The ranks this command starts itself: D x M of a `mesh` with no
    `distributed` (`data` left out: the cards there are, or 1 on the CPU;
    parallel/sharding.py::mesh_shape)."""
    if config.get("distributed") or not config.get("mesh") or dist.is_initialized():
        return 1
    cards = torch.cuda.device_count() if device.type == "cuda" else 1
    n_data, n_model = mesh_shape(config["mesh"], cards)
    return n_data * n_model


def _rank_main(rank: int, world: int, rendezvous: str, cli: dict, config: dict, device,
               results: str):
    init_local_rank(rank, world, rendezvous, device)
    try:
        out = _run_cli(cli, config, device)
        if rank == 0:
            with open(results, "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn_local_ranks(n: int, cli: dict, config: dict, device):
    """Start `n` ranks of this run on this host and wait for them; rank 0's
    metrics."""
    import torch.multiprocessing as mp
    print(f"[setup] starting {n} local ranks for mesh {config['mesh']}", flush=True)
    with tempfile.TemporaryDirectory(prefix="vlsa_ranks_") as tmp:
        results = os.path.join(tmp, "rank0_metrics.pkl")  # rank 0 writes it, this reads it
        mp.start_processes(_rank_main, args=(n, local_rendezvous(tmp), cli, config, device,
                                             results), nprocs=n, join=True, start_method="spawn")
        with open(results, "rb") as f:
            return pickle.load(f)


def main(argv=None):
    cli = get_args(argv)
    device = resolve_device(cli["device"])
    config = load_config(cli["config"])
    n = local_ranks(config, device)
    if n > 1:
        return spawn_local_ranks(n, cli, config, device)
    maybe_initialize_distributed(config, device)
    return _run_cli(cli, config, device)


if __name__ == "__main__":
    main()
