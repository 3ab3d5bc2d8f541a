"""The bf16 streamed flash kernel against variants of it, to split its time.

    python -m vlsa_tpu_torch.ops.flash_variants [--L 785,1025] [--B 64 --H 12]
        [--variants base,stages4]

Builds `csrc/flash_attn_fwd.cu` as it is ("base") and, as text edits of it,
one variant each:

  - stages4: a ring of 4 stages (3 blocks an SM by shared memory, not 4);
  - lead1: the copies one step ahead, not two;
  - and some that compute something else, to split the time by part:
    no_exp1 and no_exp2 (sweep 1's or sweep 2's exponentials left out:
    2^x = x) and no_pv (no P V product: O = 0).

For each, in one process on the same inputs (q, k, v ~ N(0, 1) in bf16, [B,
H, L, 64]): the streamed path against the plain version (max|a-b| /
max|b|), ptxas's registers, stack and spills of the streamed kernel, and its
time at each L (CUDA events, median of 25, the L2 flushed before each), the
variants timed in turns (a, b, ..., b, a).  One JSON line per variant and
length.  Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from .abmil_variants import median_ms

_SRC = "flash_attn_fwd.cu"
_EXP1 = "        for (int j = 0; j < kStrTileK / 8; ++j) {\n#pragma unroll\n" \
        "            for (int c = 0; c < 2; ++c) {\n" \
        "                ps[2 * (j & 1) + c] += exp2_approx(fmaf(s[4 * j + 2 * h + c], scale_log2, -mu));"
_EXP2 = "        p[i] = pack_bf16(exp2_approx(fmaf(s[2 * i], scale_log2, -m)) * inv,\n" \
        "                         exp2_approx(fmaf(s[2 * i + 1], scale_log2, -m)) * inv);"
_PV = "        issue_pv(p, kstage(n + j) + kStrKV, o);\n"
# name -> [(text of csrc/flash_attn_fwd.cu, its replacement)]; each text must occur once
VARIANTS = {
    "base": [],
    "stages4": [("constexpr int kStrStages = 3;", "constexpr int kStrStages = 4;")],
    "lead1": [("constexpr int kStrLead = kStrStages - 1;",
               "constexpr int kStrLead = kStrStages - 2;")],
    "no_exp1": [(_EXP1, _EXP1.replace("exp2_approx(fmaf(s[4 * j + 2 * h + c], scale_log2, -mu))",
                                      "fmaf(s[4 * j + 2 * h + c], scale_log2, -mu)"))],
    "no_exp2": [(_EXP2, "        p[i] = pack_bf16(fmaf(s[2 * i], scale_log2, -m) * inv,\n"
                        "                         fmaf(s[2 * i + 1], scale_log2, -m) * inv);")],
    "no_pv": [(_PV, "        sm90::wgmma_commit();\n")],
}


def build_variant(name: str):
    """The variant in a csrc/ copy under build/variants/flash_<name>/,
    compiled: (its ctypes.CDLL, ptxas's line of the streamed kernel)."""
    from . import _build
    src = _build.BUILD_DIR / "variants" / f"flash_{name}"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_build.CSRC_DIR, src)
    text = (src / _SRC).read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: its edit matches {text.count(old)} times")
        text = text.replace(old, new)
    (src / _SRC).write_text(text)
    so = src / "libflash_attn_fwd.so"
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(src / _SRC)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for variant {name}:\n{proc.stdout}")
    ptxas = [r for r in _build.ptxas_report(proc.stdout) if "streamed" in r["function"]]
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.flash_attn_fwd.argtypes = [P] * 4 + [I, I, ctypes.c_float, I, I, I, I, P]
    lib.flash_attn_fwd.restype = I
    return lib, ptxas


def compare(lengths=(785, 1025), B: int = 64, H: int = 12, names=tuple(VARIANTS),
            seed: int = 1) -> list:
    from . import flash_attn as fa
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(build_variant, names)))
    recs = []
    for L in lengths:
        g = torch.Generator(device="cuda").manual_seed(seed)
        q, k, v = (torch.randn(B, H, L, 64, generator=g, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        out = torch.empty(B, H, L, 64, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def run(lib):
            err = lib.flash_attn_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                     B * H, L, 64 ** -0.5, 1, fa._PATH["streamed"], 0,
                                     torch.cuda.current_device(), stream)
            if err != 0:
                raise RuntimeError(f"flash variant at L={L}: cudaError {err}")

        ref = fa.flash_self_attention_reference(q[:1], k[:1], v[:1])
        by_name = {}
        for turn, name in enumerate(list(names) + list(names)[::-1]):
            lib, ptxas = built[name]
            rec = by_name.setdefault(name, {"variant": name, "B": B, "H": H, "L": L,
                                            "ptxas": ptxas, "ms": []})
            if turn < len(names):
                run(lib)
                torch.cuda.synchronize()
                rec["rel_err"] = float((out[:1] - ref).abs().max() / ref.abs().max())
            rec["ms"].append(median_ms(lambda: run(lib)))
        recs += list(by_name.values())
        del q, k, v, out, ref
        torch.cuda.empty_cache()
    return recs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--L", default="785,1025", help="comma-separated lengths")
    ap.add_argument("--B", type=int, default=64)
    ap.add_argument("--H", type=int, default=12)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args(argv)
    names = tuple(args.variants.split(","))
    for rec in compare(tuple(int(x) for x in args.L.split(",")), args.B, args.H, names):
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
