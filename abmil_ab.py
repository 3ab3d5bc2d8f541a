"""The ABMIL or co-attention kernels of two checkouts of the repository, in
turns on one card.

    python3 abmil_ab.py --other <root of another checkout> [--kernels abmil|coattn] [--nvcc]

Times each checkout's kernels (built from its own sources), one process a
turn, in the order other, this, this, other, twice, so that both are timed
on the same card within one call:

- `--kernels abmil` (the default): `chip_smoke.time_abmil` at D=512,
  hid=256 for every storage, at B=8, N=10240 and at the training shape
  B=32, N=16384, and at the general instances' widths (1024, 256), (768,
  128) and (1536, 512) at B=8, N=10240;
- `--kernels coattn`: the forward, dQ and dX kernels at chip_smoke.py
  phase 4's and 4d's shapes -- every forward variant at B=8 and B=64 and
  three at C=1024 (N=10240), every dQ variant at B=8, bf16 and int8_inv dQ
  at B=32, N=16384, f32 and bf16 dX at B=8, bf16 dX at B=32, N=16384 --
  with the shipped flagship's P=12 queries, each time
  `chip_smoke.median_ms` (CUDA events, median of 25, L2 flushed) of the
  kernel alone on `chip_smoke.make_inputs`' inputs.

Prints the card's name and power limit, then one JSON line a turn: {"tree",
"root", "ms": {"<kernel>[<variant>] B=<B>...": ms}}, and last {"ratio":
{...}}: each time's median over this checkout's turns divided by its median
over the other's.  With `--nvcc`, first each checkout's nvcc seconds for the
kernels' sources (csrc/abmil_{fwd,bwd}.cu, or csrc/coattn_{fwd,bwd_dq,
bwd_dx}.cu), compiled anew into a temporary directory, all at once, one
JSON line a checkout.  Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
SHAPES = ((8, 10240), (32, 16384))
SOURCES = {"abmil": ("abmil_fwd", "abmil_bwd"),
           "coattn": ("coattn_fwd", "coattn_bwd_dq", "coattn_bwd_dx")}

_ABMIL_TURN = """
import json, torch, chip_smoke as cs
from vlsa_tpu_torch.ops import abmil as ab
out = {}
for B, N in %r:
    for s in ("f32", "bf16", "int8"):
        for name, rec in cs.time_abmil(torch, ab, s, B, N).items():
            out[name + "[" + s + "] B=" + str(B)] = rec["ms"]
for D, H in %r:
    for s in ("f32", "bf16", "int8"):
        for name, rec in cs.time_abmil(torch, ab, s, 8, 10240, D=D, H=H).items():
            out[name + "[" + s + "] D=" + str(D) + " hid=" + str(H)] = rec["ms"]
        torch.cuda.empty_cache()
print("RESULT " + json.dumps(out), flush=True)
"""

_COATTN_TURN = """
import json, torch, chip_smoke as cs
from vlsa_tpu_torch.ops import coattn as co
P, S = 12, cs.SCALE
V = ("f32", "f32_inv", "bf16", "bf16_inv", "int8", "int8_inv")
cases = ([("fwd", v, 8, 10240, 512) for v in V] + [("fwd", v, 64, 10240, 512) for v in V]
         + [("fwd", v, 8, 10240, 1024) for v in ("f32", "bf16", "int8_inv")]
         + [("dq", v, 8, 10240, 512) for v in V]
         + [("dq", v, 32, 16384, 512) for v in ("bf16", "int8_inv")]
         + [("dx", v, 8, 10240, 512) for v in ("f32", "bf16")] + [("dx", "bf16", 32, 16384, 512)])
out = {}
for kind, v, B, N, C in cases:
    q, x, mask, xs, xi = cs.make_inputs(torch, B, N, C, P, v, seed=1, keep_masked=kind == "dx")
    if kind == "fwd":
        fn = lambda: co.coattn_fwd(q, x, mask, S, xs, xi)
    else:
        o, m, l = co.coattn_fwd(q, x, mask, S, xs, xi)
        g = cs.make_cotangent(torch, B, P, C)
        if kind == "dq":
            fn = lambda: co.coattn_bwd_dq(q, x, mask, S, g, o, m, l, xs, xi)
        else:
            fn = lambda: co.coattn_bwd_dx(q, x, mask, S, g, o, m, l)
    out[f"{kind}[{v}] B={B} C={C}"] = cs.median_ms(torch, fn)
    del q, x, mask, xs, xi, fn
    torch.cuda.empty_cache()
print("RESULT " + json.dumps(out), flush=True)
"""
# the general instances' first widths (1024-, 768- and 1536-d features), timed at B=8,
# N=10240
GENERAL_WIDTHS = ((1024, 256), (768, 128), (1536, 512))
TURNS = {"abmil": _ABMIL_TURN % (SHAPES, GENERAL_WIDTHS), "coattn": _COATTN_TURN}


def turn(root: str, code: str) -> dict:
    """One process's times in the checkout at `root`: `code` run there, its
    last line `RESULT <json>`."""
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"the turn in {root} failed:\n{proc.stdout[-3000:]}"
                           f"{proc.stderr[-3000:]}")
    return json.loads(lines[-1][len("RESULT "):])


def nvcc_seconds(root: str, sources) -> dict:
    """Each of `sources`' nvcc seconds in the checkout at `root`, all
    started together, with the flags vlsa_tpu_torch/ops/_build.py builds
    them with."""
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

    with ThreadPoolExecutor(len(sources)) as pool:
        return dict(zip(sources, pool.map(one, sources)))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="root of the checkout to compare with")
    ap.add_argument("--kernels", choices=sorted(TURNS), default="abmil",
                    help="the kernels to time")
    ap.add_argument("--nvcc", action="store_true", help="each checkout's nvcc seconds first")
    args = ap.parse_args(argv)
    other = os.path.abspath(args.other)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    if args.nvcc:
        for tree, root in (("other", other), ("this", ROOT)):
            print(json.dumps({"tree": tree, "root": root,
                              "nvcc_seconds": nvcc_seconds(root, SOURCES[args.kernels])}),
                  flush=True)
    runs = {"other": [], "this": []}
    for tree in ("other", "this", "this", "other") * 2:
        root = other if tree == "other" else ROOT
        runs[tree].append(turn(root, TURNS[args.kernels]))
        print(json.dumps({"tree": tree, "root": root, "ms": runs[tree][-1]}), flush=True)
    print(json.dumps({"ratio": {k: statistics.median(r[k] for r in runs["this"])
                                / statistics.median(r[k] for r in runs["other"])
                                for k in runs["this"][0]}}), flush=True)


if __name__ == "__main__":
    main()
