"""The ABMIL kernels against the design alternatives they were chosen over.

    python -m vlsa_tpu_torch.ops.abmil_variants [--B 8 --N 10240] [--variants base,cvt]
    python -m vlsa_tpu_torch.ops.abmil_variants --storage bf16 [--variants base,fast_tanh]
    python -m vlsa_tpu_torch.ops.abmil_variants --general [--B 8 --N 10240]

Builds `csrc/abmil_fwd.cu` and `csrc/abmil_bwd.cu` as they are ("base") and,
as text edits of those sources, one alternative each.  f32 (the forward and
both backwards):

  - cvt: the TF32 split by `cvt.rna.tf32.f32` for hi and for lo (the kernels
    round hi with an integer add and mask, and pass lo's f32 bits, which the
    tensor cores read as TF32 by dropping 13 bits);
  - one_chain: each product accumulated in one chain of mma.sync, without the
    fresh accumulator a 32-deep slice starts and the CUDA cores' add of it;
  - chains: a tile's three products (lo.hi, hi.lo, hi.hi) back to back,
    where the kernels run three waves of the warp's 16 tiles;
  - volatile: the mma.sync statements `asm volatile`.

bf16 and int8 (`--storage`; the forward, abmil_fwd_partial<T>):

  - fast_tanh: tanh as 1 - 2 / (e^2x + 1) with the fast exponential and
    division, where the kernel takes the library's tanhf;
  - sync_wgmma: int8 waits for each slice's products (2 stages), where the
    kernel keeps one slice of them in flight (3 stages);
  - and some that compute something else, to split the time by part:
    no_tanh (h = h_pre), no_wgmma (no tensor-core product: h = 0), no_pv
    (no PV sum: out = 0), no_w1 and no_x (W1's or x's k-blocks not
    copied), no_sync (no barrier a slice: a race).

`--general`: every storage's resident instances at D=512, hid=256 against
the general instances, which take every other width (`compare_general`).

For each, in one process on the same inputs (B bags of N patches, D=512,
hid=256, 10% of patches masked, the last bag empty): each kernel against
its plain version (max|a-b| / max|b|, the worst over each call's outputs),
ptxas's registers and spills of the kernels that differ, and each call's
time (CUDA events, median of 25, the L2 flushed before each), the variants
timed in turns (a, b, ..., b, a).  One JSON line per variant.  Needs a CUDA
card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

_COMMON = "abmil_common.cuh"
_TF32 = "coattn_common.cuh"  # split_tf32 and mma_tf32
_SPLIT = ("    hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;\n"
          "    lo = __float_as_uint(v - __uint_as_float(hi));")
_SPLIT_CVT = ('    asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(hi) : "f"(v));\n'
              '    asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(lo) : "f"(v - __uint_as_float(hi)));')
_SLICE = ("    float part[kMT][NT][4];\n"
          "    zero_acc(part);\n"
          "#pragma unroll\n"
          "    for (int kk = 0; kk < 32; kk += 8) kstep_3xtf32<A_KMAJOR, B_KMAJOR, NT>(part, a, lda, b, ldb, kk);\n"
          "#pragma unroll\n"
          "    for (int mt = 0; mt < kMT; ++mt)\n"
          "#pragma unroll\n"
          "        for (int nt = 0; nt < NT; ++nt)\n"
          "#pragma unroll\n"
          "            for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[mt][nt][i];")
_ONE_CHAIN = ("#pragma unroll\n"
              "    for (int kk = 0; kk < 32; kk += 8) kstep_3xtf32<A_KMAJOR, B_KMAJOR, NT>(acc, a, lda, b, ldb, kk);")


def _wave(a: str, b: str) -> str:
    return ("#pragma unroll\n"
            "    for (int nt = 0; nt < NT; ++nt)\n"
            "#pragma unroll\n"
            f"        for (int mt = 0; mt < kMT; ++mt) mma_tf32(acc[mt][nt], {a}[mt], {b}[nt]);")


_WAVES = "\n".join(_wave(a, b) for a, b in (("al", "bh"), ("ah", "bl"), ("ah", "bh")))
_CHAINS = ("#pragma unroll\n"
           "    for (int nt = 0; nt < NT; ++nt)\n"
           "#pragma unroll\n"
           "        for (int mt = 0; mt < kMT; ++mt) {\n"
           "            mma_tf32(acc[mt][nt], al[mt], bh[nt]);\n"
           "            mma_tf32(acc[mt][nt], ah[mt], bl[nt]);\n"
           "            mma_tf32(acc[mt][nt], ah[mt], bh[nt]);\n"
           "        }")
_FWD = "abmil_fwd.cu"
_TANH = "    return tanhf(v);"
_PV = "            for (int r = 0; r < kMQ; ++r) {\n                const float p = p_s[r];"
_WGMMA = "                wgmma_op(acc, desc_sw128(xa + 32 * ks), desc_sw128(wb + 32 * ks));\n"
_W1_COPY = "        cp_async16(st + sw128(j, c), src + (size_t)j * kRow + kb * kKB + 16 * c, true);\n"
_SYNC = "            __syncthreads();\n            const int q = s + L::LEAD;"
_X_COPY = ("        cp_async16(dst + sw128(r, c), ok ? src + (size_t)(t0 + r) * kRow + kb * kKB + 16 * c : src,\n"
           "                   ok);\n")
# name -> [(file in csrc/, text, its replacement)]; each text must occur once
VARIANTS = {
    "base": [],
    "cvt": [(_TF32, _SPLIT, _SPLIT_CVT)],
    "one_chain": [(_COMMON, _SLICE, _ONE_CHAIN)],
    "chains": [(_COMMON, _WAVES, _CHAINS)],
    "volatile": [(_TF32, 'asm("mma.sync', 'asm volatile("mma.sync')],
}
# the bf16 and int8 forward's alternatives
FWD_VARIANTS = {
    "base": [],
    "fast_tanh": [(_FWD, _TANH, "    return 1.f - __fdividef(2.f, __expf(2.f * v) + 1.f);")],
    "sync_wgmma": [(_FWD, "static constexpr int DEPTH = I8 ? 1 : 0;",
                    "static constexpr int DEPTH = 0;")],
    "no_tanh": [(_FWD, _TANH, "    return v;")],
    "no_wgmma": [(_FWD, _WGMMA, "                (void)ks;\n")],
    "no_pv": [(_FWD, _PV, _PV.replace("r < kMQ", "r < 0"))],
    "no_w1": [(_FWD, _W1_COPY, "        (void)src;\n")],
    "no_x": [(_FWD, _X_COPY, "        (void)ok;\n")],
    "no_sync": [(_FWD, _SYNC, "            const int q = s + L::LEAD;")],
}
# every width on the general instances, D=512, hid=256 too (the kernels'
# special_widths and, in `compare_general`, `abmil.route` send it there)
GENERAL_VARIANTS = {
    "base": [],
    "general": [(_COMMON, "    return D == kD && hid == kHid && !(storage == kBF16 && precise);",
                 "    return false;")],
}
LIBS = ("abmil_fwd", "abmil_bwd")


def build_variant(name: str, table: dict = VARIANTS, libs_built=LIBS, key: str = "_f32"):
    """The variant of `table` in a csrc/ copy under build/variants/<name>/,
    compiled: ({library: ctypes.CDLL}, [ptxas lines of its kernels whose
    names hold `key`])."""
    from . import _build
    from .abmil import _ARGTYPES, _SMEM_ARGTYPES
    src = _build.BUILD_DIR / "variants" / name
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_build.CSRC_DIR, src)
    for file, old, new in table[name]:
        text = (src / file).read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: its edit of {file} matches {text.count(old)} times")
        (src / file).write_text(text.replace(old, new))
    libs, ptxas = {}, []
    for lib in libs_built:
        so = src / f"lib{lib}.so"
        proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so),
                               str(src / f"{lib}.cu")], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}, {lib}.cu:\n{proc.stdout}")
        ptxas += [r for r in _build.ptxas_report(proc.stdout) if key in r["function"]]
        cdll = ctypes.CDLL(str(so))
        entry, smem = getattr(cdll, lib), getattr(cdll, f"{lib}_smem_bytes")
        entry.argtypes, entry.restype = _ARGTYPES[lib], ctypes.c_int
        smem.argtypes, smem.restype = _SMEM_ARGTYPES[lib], ctypes.c_size_t
        libs[lib] = cdll
    return libs, ptxas


def median_ms(fn, runs: int = 25, warmup: int = 3) -> float:
    """Median of `runs` calls of fn, CUDA events, a 256 MiB write flushing
    the L2 before each."""
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        flush.zero_()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return sorted(times)[runs // 2]


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _inputs(B: int, N: int, seed: int, D: int = 512, H: int = 256):
    """x [B, N, D] f32 (10% of patches masked and zero, the last bag
    empty), the mask, w1 [H, D], b1, w2 and an output cotangent, on the
    card; the variants edit the D=512, hid=256 instances, the default."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    mask = torch.rand(B, N, generator=g, device="cuda") > 0.1
    mask[-1] = False
    x = (torch.randn(B, N, D, generator=g, device="cuda") * mask[..., None]).contiguous()
    w1 = (torch.rand(H, D, generator=g, device="cuda") * 2 - 1) * D ** -0.5
    b1 = (torch.rand(H, generator=g, device="cuda") * 2 - 1) * D ** -0.5
    w2 = 0.25 * torch.randn(H, generator=g, device="cuda")
    gout = torch.randn(B, D, generator=g, device="cuda")
    return x, mask, w1, b1, w2, gout


def compare(B: int = 8, N: int = 10240, names=tuple(VARIANTS), seed: int = 1) -> list:
    from . import abmil as ab
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(build_variant, names)))
    x, mask, w1, b1, w2, gout = _inputs(B, N, seed)
    ref, m, l = ab.abmil_fwd_reference(x, mask, w1, b1, w2)
    want = {dx: ab.abmil_bwd_reference(x, mask, w1, b1, w2, gout, ref, m, l, need_dx=dx)
            for dx in (False, True)}
    shipped, recs = ab._library, {}
    try:
        for turn, name in enumerate(list(names) + list(names)[::-1]):
            libs, ptxas = built[name]
            ab._library = libs.__getitem__
            out, m_k, l_k = ab.abmil_fwd(x, mask, w1, b1, w2)
            rec = recs.setdefault(name, {"variant": name, "B": B, "N": N, "ptxas": ptxas,
                                         "fwd_ms": [], "bwd_ms": [], "bwd_dx_ms": []})
            if turn < len(names):
                rec["fwd_rel_err"] = _rel(out, ref)
                for dx, key in ((False, "bwd_rel_err"), (True, "bwd_dx_rel_err")):
                    got = ab.abmil_bwd(x, mask, w1, b1, w2, gout, out, m_k, l_k, need_dx=dx)
                    rec[key] = max(_rel(a, b) for a, b in zip(got, want[dx]) if b is not None)
            rec["fwd_ms"].append(median_ms(lambda: ab.abmil_fwd(x, mask, w1, b1, w2)))
            for dx, key in ((False, "bwd_ms"), (True, "bwd_dx_ms")):
                rec[key].append(median_ms(lambda: ab.abmil_bwd(x, mask, w1, b1, w2, gout, out,
                                                               m_k, l_k, need_dx=dx)))
    finally:
        ab._library = shipped
    return list(recs.values())


def compare_fwd(storage: str, B: int = 8, N: int = 10240, names=tuple(FWD_VARIANTS),
                seed: int = 1) -> list:
    """The bf16 or int8 forward's variants: error against the plain version
    (int8 also against abmil_fwd_rounded, the model of its W1 split), ptxas
    of abmil_fwd_partial, time in turns."""
    from . import abmil as ab
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(
            lambda n: build_variant(n, FWD_VARIANTS, ("abmil_fwd",), "abmil_fwd_partialI"), names)))
    x, mask, w1, b1, w2, _g = _inputs(B, N, seed)
    xs = None
    if storage == "int8":
        amax = x.abs().amax(-1) / 127.0
        x = torch.round(x / torch.where(amax > 0, amax, 1.0)[..., None]).to(torch.int8)
        xs = amax.contiguous()
    else:
        x = x.to(torch.bfloat16)
    x = x.contiguous()
    fwd = ((lambda: ab.abmil_q8_fwd(x, xs, mask, w1, b1, w2)) if xs is not None
           else (lambda: ab.abmil_fwd(x, mask, w1, b1, w2)))
    ref = ab.abmil_fwd_reference(x, mask, w1, b1, w2, x_scale=xs)[0]
    rounded = ab.abmil_fwd_rounded(x, mask, w1, b1, w2, x_scale=xs)[0]
    shipped, recs = ab._library, {}
    try:
        for turn, name in enumerate(list(names) + list(names)[::-1]):
            libs, ptxas = built[name]
            ab._library = libs.__getitem__
            rec = recs.setdefault(name, {"variant": name, "storage": storage, "B": B, "N": N,
                                         "ptxas": ptxas, "fwd_ms": []})
            if turn < len(names):
                out = fwd()[0]
                rec["fwd_rel_err"] = _rel(out, ref)
                rec["fwd_rounded_rel_err"] = _rel(out, rounded)
            rec["fwd_ms"].append(median_ms(fwd))
    finally:
        ab._library = shipped
    return list(recs.values())


def _general_route(dtype, D, hid, precise=None) -> str:
    from . import abmil as ab
    return "precise" if ab._precise_for(dtype, precise) else "general"


def compare_general(B: int = 8, N: int = 10240, seed: int = 1) -> list:
    """The resident instances ("base") against the general ones ("general")
    at D=512, hid=256 for every storage: the forward, the weights-only
    backward and (f32, bf16) the backward with dX, each against its plain
    version, then timed in turns (base, general, general, base)."""
    from . import abmil as ab
    with ThreadPoolExecutor(2) as pool:
        built = dict(zip(GENERAL_VARIANTS, pool.map(
            lambda n: build_variant(n, GENERAL_VARIANTS, LIBS, "abmil_"), GENERAL_VARIANTS)))
    x32, mask, w1, b1, w2, gout = _inputs(B, N, seed)
    shipped, shipped_route, recs = ab._library, ab.route, []
    try:
        for storage in ("f32", "bf16", "int8"):
            x, xs = x32, None
            if storage == "int8":
                amax = x32.abs().amax(-1) / 127.0
                x = torch.round(x32 / torch.where(amax > 0, amax, 1.0)[..., None]).to(torch.int8)
                xs = amax.contiguous()
            elif storage == "bf16":
                x = x32.to(torch.bfloat16)
            x = x.contiguous()
            if xs is None:
                fwd = lambda: ab.abmil_fwd(x, mask, w1, b1, w2)  # noqa: E731
                bwd = lambda o, dx: ab.abmil_bwd(x, mask, w1, b1, w2, gout, *o, need_dx=dx)  # noqa: E731
            else:
                fwd = lambda: ab.abmil_q8_fwd(x, xs, mask, w1, b1, w2)  # noqa: E731
                bwd = lambda o, dx: (None,) + tuple(ab.abmil_q8_bwd(x, xs, mask, w1, b1, w2,  # noqa: E731
                                                                    gout, *o))
            ref = ab.abmil_fwd_reference(x, mask, w1, b1, w2, x_scale=xs)
            dxs = (False,) if storage == "int8" else (False, True)
            want = {dx: ab.abmil_bwd_reference(x, mask, w1, b1, w2, gout, *ref, x_scale=xs,
                                               need_dx=dx) for dx in dxs}
            rec = {"storage": storage, "B": B, "N": N, "D": 512, "hid": 256}
            for turn, name in enumerate(("base", "general", "general", "base")):
                ab._library = built[name][0].__getitem__
                ab.route = shipped_route if name == "base" else _general_route
                ab.fwd_plan.cache_clear()
                ab.bwd_plan.cache_clear()
                before = dict(ab.LAUNCHES_ROUTE)
                out = fwd()
                torch.cuda.synchronize()
                r = rec.setdefault(name, {"fwd_ms": [], "bwd_ms": [], "bwd_dx_ms": []})
                r["route"] = next(k for k in before if ab.LAUNCHES_ROUTE[k] != before[k])
                if turn < 2:
                    r["fwd_rel_err"] = max(_rel(a, b) for a, b in zip(out, ref))
                    for dx in dxs:
                        got = bwd(out, dx)
                        r["bwd_dx_rel_err" if dx else "bwd_rel_err"] = max(
                            _rel(a.float(), b.float()) for a, b in zip(got, want[dx])
                            if b is not None)
                r["fwd_ms"].append(median_ms(fwd))
                for dx in dxs:
                    r["bwd_dx_ms" if dx else "bwd_ms"].append(median_ms(lambda: bwd(out, dx)))
            recs.append(rec)
    finally:
        ab._library, ab.route = shipped, shipped_route
        ab.fwd_plan.cache_clear()
        ab.bwd_plan.cache_clear()
    return recs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--B", type=int, default=8)
    ap.add_argument("--N", type=int, default=10240)
    ap.add_argument("--storage", choices=("f32", "bf16", "int8"), default="f32")
    ap.add_argument("--variants", default=None,
                    help="comma-separated names (default: all of the storage's)")
    ap.add_argument("--general", action="store_true",
                    help="the resident instances against the general ones, every storage")
    args = ap.parse_args(argv)
    if args.general:
        recs = compare_general(args.B, args.N)
    elif args.storage == "f32":
        names = tuple((args.variants or ",".join(VARIANTS)).split(","))
        recs = compare(args.B, args.N, names)
    else:
        names = tuple((args.variants or ",".join(FWD_VARIANTS)).split(","))
        recs = compare_fwd(args.storage, args.B, args.N, names)
    for rec in recs:
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
