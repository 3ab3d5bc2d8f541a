"""The ABMIL kernels of two checkouts of the repository, in turns on one card.

    python3 abmil_ab.py --other <root of another checkout> [--nvcc]

Runs `chip_smoke.time_abmil` of each checkout (its kernels built from its
own sources) at D=512, hid=256 for every storage, at B=8, N=10240 and at
the training shape B=32, N=16384, one process a turn, in the order other,
this, this, other, so that both are timed on the same card within one
call.  Prints the card's name and power limit, then one JSON line a turn:
{"tree", "ms": {"<kernel>[<storage>] B=<B>": ms}}.  With `--nvcc`, first
each checkout's nvcc seconds for csrc/abmil_fwd.cu and csrc/abmil_bwd.cu,
compiled anew into a temporary directory, the two sources at once, one
JSON line a checkout.  Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
SHAPES = ((8, 10240), (32, 16384))
SOURCES = ("abmil_fwd", "abmil_bwd")

_TURN = """
import json, torch, chip_smoke as cs
from vlsa_tpu_torch.ops import abmil as ab
out = {}
for B, N in %r:
    for s in ("f32", "bf16", "int8"):
        for name, rec in cs.time_abmil(torch, ab, s, B, N).items():
            out[name + "[" + s + "] B=" + str(B)] = rec["ms"]
print("RESULT " + json.dumps(out), flush=True)
"""


def turn(root: str) -> dict:
    """One process's times in the checkout at `root`."""
    proc = subprocess.run([sys.executable, "-c", _TURN % (SHAPES,)], cwd=root,
                          capture_output=True, text=True)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"the turn in {root} failed:\n{proc.stdout[-3000:]}"
                           f"{proc.stderr[-3000:]}")
    return json.loads(lines[-1][len("RESULT "):])


def nvcc_seconds(root: str) -> dict:
    """Each of SOURCES' nvcc seconds in the checkout at `root`, all started
    together, with the flags vlsa_tpu_torch/ops/_build.py builds them with."""
    from vlsa_tpu_torch.ops import _build
    csrc = os.path.join(root, "vlsa_tpu_torch", "ops", "csrc")

    def one(name):
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                                   os.path.join(tmp, "lib.so"), os.path.join(csrc, f"{name}.cu")],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu in {root}:\n{proc.stdout}")
            return time.perf_counter() - t0

    with ThreadPoolExecutor(len(SOURCES)) as pool:
        return dict(zip(SOURCES, pool.map(one, SOURCES)))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="root of the checkout to compare with")
    ap.add_argument("--nvcc", action="store_true", help="each checkout's nvcc seconds first")
    args = ap.parse_args(argv)
    other = os.path.abspath(args.other)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    if args.nvcc:
        for tree, root in (("other", other), ("this", ROOT)):
            print(json.dumps({"tree": tree, "root": root, "nvcc_seconds": nvcc_seconds(root)}),
                  flush=True)
    for tree in ("other", "this", "this", "other"):
        root = other if tree == "other" else ROOT
        print(json.dumps({"tree": tree, "root": root, "ms": turn(root)}), flush=True)


if __name__ == "__main__":
    main()
