"""Alternated A/B runs of the training data path on one CUDA card.

Two comparisons, each in turns (off, on, on, off) within one process, so
that a drift of the card or the host falls on both sides:

- page-locked against pageable batches: the flagship in bf16 and SA in
  f32 trained from a `.npy` store of fold 0 (the store of chip_smoke.py's
  phase 3h), `STORE_EPOCHS` epochs a run, the batches of one side built by
  the same batcher in pageable memory;
- the prefetch thread: the flagship from synthetic bags (chip_smoke.py's
  phase 3g), `LIFECYCLE_EPOCHS` epochs a run, with `prefetch: 0` and 2.

The pageable side builds each batch in tensors of its own, outside the
page-locked batch pool.  `--lane pinned` runs only the page-locked store
runs, once: the lane to compare two checkouts with, a process each, in
turns (parent, change, change, parent), this script copied into each.

Every run starts with no page-locked block kept (a run releases them at its
end) and goes through chip_smoke.py's checks of its path.  Each run's
epochs (wall, the loop's wait for batches, the producer's build), its
evaluation passes and its host memory (resident peak and rise; torch's
page-locked pool: peak bytes, blocks made, seconds making them) are
printed beside the card's name and power limit, one `RESULT` line a run.

    python3 host_ab.py [--out record.json] [--lane all|pinned]
"""
import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

import chip_smoke as cs

STORE_EPOCHS = 3
LIFECYCLE_EPOCHS = 2
TURNS = (False, True, True, False)


def card_name() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout else \
        "nvidia-smi unavailable"


def summary(run: dict) -> dict:
    return {"epochs": run["epochs"], "eval_passes": run["eval_passes"],
            "exec_s": run["exec_s"], "host_memory": run["host_memory"]}


def result_line(what: str, run: dict) -> str:
    epochs = "; ".join(f"epoch {e['epoch']} {e['wall_s']:.2f} s (wait {e['prep_s']:.2f}, build "
                       f"{e['build_s']:.2f})" for e in run["epochs"])
    evals = [round(p["seconds"], 2) for p in run["eval_passes"]]
    return (f"RESULT {what}: {epochs}; exec {run['exec_s']:.2f} s; eval passes {evals} s; "
            f"{cs.describe_host_memory(run['host_memory'])}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the record here (JSON)")
    ap.add_argument("--lane", choices=("all", "pinned"), default="all",
                    help="pinned: the page-locked store runs only, once")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        cs.log("FAIL: no CUDA device is available")
        return 1
    from vlsa_tpu_torch.data import pipeline
    from vlsa_tpu_torch.ops import _build
    from vlsa_tpu_torch.ops import abmil as ab
    from vlsa_tpu_torch.ops import coattn as co

    card = card_name()
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.build("coattn_fwd", "coattn_bwd_dq", "abmil_fwd", "abmil_bwd")
    cs.log(f"kernels built in {time.perf_counter() - t0:.1f} s")
    device = torch.device("cuda")
    record = {"card": card, "torch": torch.__version__, "store_epochs": STORE_EPOCHS,
              "lifecycle_epochs": LIFECYCLE_EPOCHS, "pin": [], "prefetch": []}
    # (the pinned lane leaves the batcher as it is: it also runs in checkouts
    # whose batcher predates the pool)
    pinned_entries = getattr(pipeline.BagBatcher, "_entries", None)

    def pageable_entries(self, specs, ring):
        return {name: torch.empty(shape, dtype=dtype) for name, shape, dtype in specs}
    specs = {s[0]: s for s in cs.STORE_RUNS}
    _meta, _split, sids = cs.fold0_slides()
    tmp = tempfile.mkdtemp(prefix="host_ab_")
    try:
        stores = cs.write_stores(tmp, sids, convert=False)  # the runs read the .npy store
        for turn, pin in enumerate((True,) if args.lane == "pinned" else TURNS):
            if args.lane == "all":
                pipeline.BagBatcher._entries = pinned_entries if pin else pageable_entries
            for key in ("vlsa_bf16_npy", "sa_f32_npy"):
                name, *rest = specs[key]
                run = cs.store_run(torch, ab, co, device, card, stores, tmp, f"{name}_t{turn}",
                                   *rest, epochs=STORE_EPOCHS)
                print(result_line(f"{key} pin={pin} turn={turn}", run), flush=True)
                record["pin"].append({"key": key, "pin": pin, "turn": turn, **summary(run)})
    finally:
        if args.lane == "all":
            pipeline.BagBatcher._entries = pinned_entries
        shutil.rmtree(tmp, ignore_errors=True)
    for turn, prefetch in enumerate(2 if on else 0 for on in TURNS if args.lane == "all"):
        run = cs.phase_lifecycle(torch, ab, co, device, "vlsa", card, epochs=LIFECYCLE_EPOCHS,
                                 prefetch=prefetch)
        pipeline.release_pinned_batches()  # the plain test pass's blocks
        print(result_line(f"synthetic flagship prefetch={prefetch} turn={turn}", run),
              flush=True)
        record["prefetch"].append({"prefetch": prefetch, "turn": turn, **summary(run)})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1, default=str)
    print(json.dumps({"ok": True, "card": card}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except cs.SmokeFailure as exc:
        cs.log(f"FAIL: {exc}")
        sys.exit(1)
