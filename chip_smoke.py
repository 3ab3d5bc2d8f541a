#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (vlsa_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--out record.json]

Run from the root of the repository.  Phases, in order; any failure exits
non-zero and prints no result:

  1. device: CUDA is required; prints the card's name and power limit;
  2. kernel: builds csrc/coattn_fwd.cu with nvcc and holds each storage
     variant of the co-attention kernel against the port's plain version on
     the card (B=8, N=10240, C=512, P=12, scale 30, 10% of patches masked,
     one empty bag), in f32; tolerances f32 1e-4, bf16 and int8 1e-3;
  3. serving: builds the flagship VLSA at the full CONCH width from a seed
     and answers requests of 8 synthetic bags (N~8192 jittered) in every
     storage variant -- 3 in bf16 and 3 in int8 with host 1/||x|| among
     them -- counting the kernel's launches, and holds the incidence
     probabilities against the same requests with the plain co-attention;
  4. times: CUDA events, median of 25 runs with the L2 cache flushed
     before each, for the kernel, its plain version and one
     scaled_dot_product_attention call (a yardstick the port never calls),
     beside the least time the card could take (bound_ms).

The last two lines are the kernels' JSON record and
{"ok": true, "device": {"platform": "gpu", "kind": <name>, "count": <n>}}.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SHAPE = dict(B=8, N=10240, C=512, P=12)
SCALE = 30.0
TOL = {"f32": 1e-4, "bf16": 1e-3, "int8": 1e-3}
VARIANTS = ("f32", "f32_inv", "bf16", "bf16_inv", "int8", "int8_inv")
# the TPU kernel each variant replaces (vlsa_tpu/ops/coattn.py)
REPLACES = {
    "f32": "vlsa_tpu/ops/coattn.py:316 _coattn_fwd_kernel",
    "bf16": "vlsa_tpu/ops/coattn.py:316 _coattn_fwd_kernel",
    "f32_inv": "vlsa_tpu/ops/coattn.py:336 _coattn_fwd_kernel_i",
    "bf16_inv": "vlsa_tpu/ops/coattn.py:336 _coattn_fwd_kernel_i",
    "int8": "vlsa_tpu/ops/coattn.py:322 _coattn_fwd_kernel_q8",
    "int8_inv": "vlsa_tpu/ops/coattn.py:328 _coattn_fwd_kernel_q8i",
}
SOURCE = "vlsa_tpu_torch/ops/csrc/coattn_fwd.cu"
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and operations/s by
# operand type (f32 outside the tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"f32": 67e12, "bf16": 989e12, "int8": 1979e12}
# the flagship served configuration: configs/IFMLE/tcga_blca/cfg_vlsa_conch.yaml
# with its grid lists resolved and the flagship's 12 ranks and 12 queries
FLAGSHIP_CFG = {
    "arch": "VLSA", "seed": 42, "dataset_name": "tcga_blca",
    "path_patch": "synthetic://N=8192,D=512,seed=7", "net_output_converter": "softmax",
    "vlsa_api": "CONCH", "vlsa_frozen_logit_scale": False,
    "vlsa_img_encoder_name": "VLFAN", "vlsa_img_encoder_dim_in": 512,
    "vlsa_img_encoder_dim_hid": 256, "vlsa_img_encoder_use_feat_proj": False,
    "vlsa_img_encoder_drop_rate": 0.25, "vlsa_img_encoder_pred_head": "default",
    "vlsa_img_encoder_query": "Text", "vlsa_img_encoder_num_query": 12,
    "vlsa_img_encoder_query_pooling": "mean", "vlsa_img_encoder_gated_query": False,
    "vlsa_img_encoder_query_text_method": "TaskRes",
    "vlsa_img_encoder_query_text_res_ratio": 0.5,
    "vlsa_img_encoder_query_text_dim_reduction": 4,
    "vlsa_img_encoder_query_text_keep_ratio": 0.8,
    "vlsa_img_encoder_query_text_load_path":
        "vlsa_tpu/assets/tools/survival_text_prototypes.json",
    "vlsa_img_encoder_query_text_load_idx": "tcga_blca_0",
    "vlsa_txt_encoder_name": "mahmoodlab/conch", "vlsa_txt_encoder_frozen": True,
    "vlsa_txt_encoder_dtype": "bfloat16",
    "vlsa_pmt_learner_name": "CoOp", "vlsa_pmt_learner_pretrained": False,
    "vlsa_pmt_learner_coop_method": "rank", "vlsa_pmt_learner_coop_num_ranks": 12,
    "vlsa_pmt_learner_coop_num_base_ranks": 4,
    "vlsa_pmt_learner_coop_num_tokens_per_rank": 4,
    "vlsa_pmt_learner_coop_num_context_tokens": 8,
    "vlsa_pmt_learner_coop_rank_tokens_position": "tail",
    "vlsa_pmt_learner_coop_init_prompt_path": "vlsa_tpu/assets/tools/survival_prompts.json",
    "vlsa_pmt_learner_coop_init_prompt_rank_idx": 0,
    "vlsa_pmt_learner_coop_init_prompt_context_idx": 0,
    "vlsa_pmt_learner_coop_rank_specific_context": False,
}
# the served requests: (feats_dtype, host 1/||x||, number of requests)
SERVED = (("bfloat16", False, 3), ("int8", True, 3), ("float32", False, 1),
          ("float32", True, 1), ("bfloat16", True, 1), ("int8", False, 1))
BAGS_PER_REQUEST = 8


class SmokeFailure(Exception):
    pass


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def storage_of(variant: str) -> str:
    return variant.split("_")[0]


# ---------------------------------------------------------------- phase 2

def make_inputs(torch, B, N, C, P, variant, seed=0, device="cuda"):
    """Random queries and bags on the card: 10% of patches masked and the
    last bag empty; int8 is quantized per patch, and `_inv` variants carry
    1/||x|| of the stored rows."""
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(P, C, generator=g, device=device)
    q = q / q.norm(dim=-1, keepdim=True)
    x = torch.randn(B, N, C, generator=g, device=device)
    mask = torch.rand(B, N, generator=g, device=device) > 0.1
    mask[-1] = False
    x = x * mask[..., None]
    x_scale = x_inv = None
    storage = storage_of(variant)
    if storage == "int8":
        amax = x.abs().amax(-1) / 127.0
        x = torch.clamp(torch.round(x / torch.where(amax > 0, amax, 1.0)[..., None]),
                        -127, 127).to(torch.int8)
        x_scale = amax.contiguous()
    elif storage == "bf16":
        x = x.to(torch.bfloat16)
    if variant.endswith("_inv"):
        sq = (x.float() ** 2).sum(-1)
        x_inv = torch.where(sq > 0, sq.rsqrt(), torch.zeros_like(sq)).contiguous()
    return q, x.contiguous(), mask.contiguous(), x_scale, x_inv


def phase_kernel(torch, co):
    from vlsa_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.build("coattn_fwd")
    log(f"built coattn_fwd in {time.perf_counter() - t0:.1f} s")
    for line in _build.BUILD_LOGS.get("coattn_fwd", "").splitlines():
        if "registers" in line or "spill stores" in line:
            log("  ptxas: " + line.strip())
    errs = {}
    for v in VARIANTS:
        q, x, mask, xs, xi = make_inputs(torch, **SHAPE, variant=v)
        out, m, l = co.coattn_fwd(q, x, mask, SCALE, xs, xi)
        torch.cuda.synchronize()
        ref = co.coattn_pool_reference(q, x, mask, SCALE, xs)
        diff = (out - ref).abs().max().item()
        rel = diff / max(ref.abs().max().item(), 1e-30)
        empty = out[-1].abs().max().item()
        log(f"kernel {v:9s} max|k-p| {diff:.3e}  rel {rel:.3e}  (tol {TOL[storage_of(v)]:g})"
            f"  empty bag {empty:g}  finite m,l {bool(torch.isfinite(m).all())}")
        check(bool(torch.isfinite(out).all()), f"{v}: non-finite kernel output")
        check(rel <= TOL[storage_of(v)], f"{v}: kernel deviates {rel:.3e} from its plain version")
        check(empty == 0.0, f"{v}: the empty bag pooled to {empty}")
        errs[v] = {"max_abs_err": diff, "rel_err": rel}
        del q, x, mask, xs, xi, out, ref
    return errs


# ---------------------------------------------------------------- phase 3

@contextlib.contextmanager
def plain_coattention():
    """Route VLFAN's pooling through the plain version, also on the card."""
    from vlsa_tpu_torch.models import mil
    from vlsa_tpu_torch.ops.coattn import coattn_pool_reference
    kernel_pool = mil.coattn_pool
    mil.coattn_pool = (lambda q, x, mask, scale, x_scale=None, x_inv=None:
                       coattn_pool_reference(q, x, mask, scale, x_scale=x_scale))
    try:
        yield
    finally:
        mil.coattn_pool = kernel_pool


def phase_serving(torch, co, device):
    import numpy as np
    from vlsa_tpu_torch.config import serving_config
    from vlsa_tpu_torch.models.vlsa_build import build_vlsa_from_config
    from vlsa_tpu_torch.runner.engine import InferEngine
    from vlsa_tpu_torch.runner.serve import request_bags

    cfg = serving_config(FLAGSHIP_CFG)
    t0 = time.perf_counter()
    model, _tok = build_vlsa_from_config(cfg, device=device)
    build_s = time.perf_counter() - t0
    tower = model.prompt_encoder
    log(f"flagship built in {build_s:.1f} s: tower width {tower.width}, "
        f"{len(tower.resblocks)} layers, {sum(p.numel() for p in model.parameters())} "
        f"parameters, text trim {model.text_trim_len}")
    engines = {}
    requests = []
    r = 0
    for feats_dtype, inv, count in SERVED:
        key = (feats_dtype, inv)
        engines[key] = InferEngine(model, feats_dtype=feats_dtype, precompute_inv=inv)
        for _ in range(count):
            requests.append((key, request_bags(cfg["path_patch"], r, BAGS_PER_REQUEST)))
            r += 1
    t0 = time.perf_counter()
    for e in engines.values():
        e.text_precompute()
    torch.cuda.synchronize()
    text_ms = 1e3 * (time.perf_counter() - t0) / len(engines)

    # ---- the main path: every launch counter from 0 ----
    # a request's time = host prep (padding, bf16 rounding or int8
    # quantization, copy to the card) + the model on the card
    co.reset_launches()
    batches, outputs, prep_ms, forward_ms = [], [], [], []
    for key, bags in requests:
        t = time.perf_counter()
        batch = engines[key].prepare(bags)
        torch.cuda.synchronize()
        t_mid = time.perf_counter()
        out = engines[key].forward(batch)
        torch.cuda.synchronize()
        prep_ms.append(1e3 * (t_mid - t))
        forward_ms.append(1e3 * (time.perf_counter() - t_mid))
        batches.append((key, batch))
        outputs.append(out)
    launches = dict(co.LAUNCHES)
    log(f"main path: {len(batches)} requests, kernel launches {launches}")

    expected = {v: 0 for v in VARIANTS}
    for (feats_dtype, inv), _b in batches:
        expected[co.variant_name(
            {"float32": torch.float32, "bfloat16": torch.bfloat16,
             "int8": torch.int8}[feats_dtype], inv)] += 1
    check(launches == expected, f"launch counts {launches}, expected {expected}")
    check(all(n > 0 for n in launches.values()), "a kernel variant was never launched")

    worst = 0.0
    by_mode = {}
    with plain_coattention():
        for (key, batch), out, p_ms, f_ms in zip(batches, outputs, prep_ms, forward_ms):
            probs = out["probs"]
            check(tuple(probs.shape) == (BAGS_PER_REQUEST, 12), f"probs shape {probs.shape}")
            check(bool(torch.isfinite(out["logits"]).all()), "non-finite logits")
            sums = probs.sum(-1)
            check(float((sums - 1).abs().max()) <= 1e-5, "probabilities do not sum to 1")
            plain = engines[key].forward(batch)["probs"]
            dev = float((probs - plain).abs().max())
            worst = max(worst, dev)
            check(dev <= 1e-3, f"{key}: kernel and plain probabilities differ by {dev:.3e}")
            mode = f"{key[0]}{'_inv' if key[1] else ''}"
            rec = by_mode.setdefault(mode, {"requests": 0, "prep": [], "forward": [],
                                            "max_prob_dev": 0.0})
            rec["requests"] += 1
            rec["prep"].append(p_ms)
            rec["forward"].append(f_ms)
            by_mode[mode]["max_prob_dev"] = max(by_mode[mode]["max_prob_dev"], dev)
    check(sum(co.LAUNCHES.values()) == sum(launches.values()),
          "the plain run launched the kernel")
    for mode, rec in by_mode.items():
        rec["median_prep_ms"] = float(np.median(rec.pop("prep")))
        rec["median_forward_ms"] = float(np.median(rec.pop("forward")))
        log(f"served {mode:13s} {rec['requests']} requests of {BAGS_PER_REQUEST} bags: median "
            f"host prep {rec['median_prep_ms']:.1f} ms + model {rec['median_forward_ms']:.2f} ms,"
            f" max |p_kernel - p_plain| {rec['max_prob_dev']:.2e}")
    max_n = max(int(b["mask"].shape[1]) for _k, b in batches)
    return {"build_s": build_s, "text_precompute_ms": text_ms, "launches": launches,
            "max_prob_dev": worst, "by_mode": by_mode, "max_patches": max_n}


# ---------------------------------------------------------------- phase 4

def median_ms(torch, fn, runs=25, warmup=3):
    """Median over `runs` launches of fn, each timed with CUDA events after
    the L2 cache was flushed by a 256 MiB write."""
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    times.sort()
    return times[len(times) // 2]


def bound(B, N, C, P, variant):
    """Least time for the work on an H100: max(bytes moved / HBM rate,
    operations / peak rate of the operand type).  Bytes: x, mask, the
    sidecar rows and q read once; out, m and l written once.  Operations:
    the logit dot and the PV product, 2*P*C each per element, plus the row
    norm (2*C per element) where the kernel computes it."""
    storage = storage_of(variant)
    item = {"f32": 4, "bf16": 2, "int8": 1}[storage]
    rows = (1 if storage == "int8" else 0) + (1 if variant.endswith("_inv") else 0)
    nbytes = B * N * C * item + B * N + 4 * B * N * rows + 4 * P * C + 4 * B * P * (C + 2)
    ops = B * N * C * (4 * P + (0 if variant.endswith("_inv") else 2))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[storage]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_variant(torch, co, variant, B, N, C, P):
    import torch.nn.functional as F
    q, x, mask, xs, xi = make_inputs(torch, B, N, C, P, variant, seed=1)
    k_ms = median_ms(torch, lambda: co.coattn_fwd(q, x, mask, SCALE, xs, xi))
    p_ms = median_ms(torch, lambda: co.coattn_pool_reference(q, x, mask, SCALE, xs))
    # yardstick: one fused attention call on pre-normalised keys (values in
    # f32 for f32 storage, else bf16: the library takes no int8)
    xf = co.dequantize_feats(x, xs).float()
    lib_dtype = torch.float32 if storage_of(variant) == "f32" else torch.bfloat16
    kn = torch.nn.functional.normalize(xf, dim=-1).to(lib_dtype)[:, None]
    vv = xf.to(lib_dtype)[:, None]
    qq = q.to(lib_dtype)[None, None].expand(B, 1, P, C)
    am = mask[:, None, None, :]
    del xf
    lib_ms = median_ms(torch, lambda: F.scaled_dot_product_attention(
        qq, kn, vv, attn_mask=am, scale=SCALE))
    b_ms, b_by = bound(B, N, C, P, variant)
    return {"B": B, "N": N, "C": C, "P": P, "ms": k_ms, "plain_ms": p_ms,
            "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by}


def phase_times(torch, co):
    at_b8 = {}
    for v in VARIANTS:
        at_b8[v] = time_variant(torch, co, v, **SHAPE)
        torch.cuda.empty_cache()
    at_b64 = {}
    for v in ("bf16", "int8_inv"):
        at_b64[v] = time_variant(torch, co, v, **dict(SHAPE, B=64))
        torch.cuda.empty_cache()
    for shape, recs in (("B=8", at_b8), ("B=64", at_b64)):
        for v, t in recs.items():
            log(f"time {shape:4s} {v:9s} kernel {t['ms']:.4f} ms  plain {t['plain_ms']:.4f} ms"
                f"  sdpa {t['library_ms']:.4f} ms  bound {t['bound_ms']:.4f} ms"
                f" ({t['bound_by']})  kernel/bound {t['ms'] / t['bound_ms']:.1f}x")
    return at_b8, at_b64


# ---------------------------------------------------------------- main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the full record here (JSON)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        log("FAIL: no CUDA device is available")
        return 1
    sys.path.insert(0, ROOT)
    try:
        from vlsa_tpu_torch.ops import coattn as co
    except ImportError as exc:
        log(f"FAIL: the port is not beside this script ({exc})")
        return 1

    t_start = time.perf_counter()
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout else \
        "nvidia-smi unavailable"
    print(card, flush=True)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    try:
        errs = phase_kernel(torch, co)
        serving = phase_serving(torch, co, device)
        at_b8, at_b64 = phase_times(torch, co)
    except SmokeFailure as exc:
        log(f"FAIL: {exc}")
        return 1

    kernels = []
    for v in VARIANTS:
        t = at_b8[v]
        kernels.append({
            "name": f"coattn_fwd[{v}]", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[v], "launches": serving["launches"][v],
            "max_abs_err": errs[v]["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    record = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
              "shape": SHAPE, "kernel_errors": errs, "serving": serving,
              "times_b8": at_b8, "times_b64": at_b64, "kernels": kernels,
              "seconds": time.perf_counter() - t_start}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    log(f"all phases passed in {record['seconds']:.0f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
