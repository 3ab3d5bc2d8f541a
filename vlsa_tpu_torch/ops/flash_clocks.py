"""Where a bf16 flash kernel spends its time, by phase.

    python -m vlsa_tpu_torch.ops.flash_clocks [--B 64 --H 12 --L 1025]
        [--path streamed|resident]

Builds `csrc/flash_attn_fwd.cu` a second time with -DFLASH_CLOCKS (the
shipped library has no clock reads), runs the kernel of the given path once
at the given shape and prints, for each phase of a step (streamed: a key
tile; resident: a query stripe), the SM clocks summed over warps (clock64
between the phase marks of the kernel) and its share, as one JSON line.
The clock reads cost time of their own, and a phase also holds the time a
warp waits for the SM's shared pipes, so the shares, not the kernel's time,
are the reading.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json

import torch

PHASES = {
    "streamed": ("s1_wait_tile", "s1_qk", "s1_stats", "s2_wait_tile", "s2_qk", "s2_form_p",
                 "s2_pv", "store"),
    "resident": ("kv_load", "q_stage", "qk", "max_exchange", "exp_sum", "sum_exchange",
                 "v_wait", "pv", "o_reduce"),
}
N_PHASES = 9  # the kernel's kPhases
FLAGS = ("-DFLASH_CLOCKS",)


def phase_clocks(B: int = 64, H: int = 12, L: int = 1025, path: str = "streamed",
                 seed: int = 0) -> dict:
    from . import _build
    from . import flash_attn as fa
    _path, chunks, _smem = (fa.resident_plan if path == "resident" else fa.flash_plan)(L)
    if path == "resident" and chunks == 0:
        raise ValueError(f"L={L} exceeds the resident capacity {fa.RESIDENT_CAPACITY}")
    lib = _build.load("flash_attn_fwd", FLAGS)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.flash_attn_fwd.argtypes = [P] * 4 + [I, I, ctypes.c_float, I, I, I, I, P]
    lib.flash_phase_clocks.argtypes = [P]
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(B, H, L, 64, generator=g, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    out = torch.empty(B, H, L, 64, device="cuda")
    clocks = (ctypes.c_ulonglong * N_PHASES)()
    for _ in range(2):  # the first call warms up; the second is read
        lib.flash_phase_clocks(clocks)
        err = lib.flash_attn_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B * H,
                                 L, 64 ** -0.5, 1, fa._PATH[path], chunks,
                                 torch.cuda.current_device(),
                                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"instrumented flash kernel: cudaError {err}")
        torch.cuda.synchronize()
    lib.flash_phase_clocks(clocks)
    names = PHASES[path]
    total = sum(clocks[:len(names)])
    rel = float(((out - fa.flash_self_attention_reference(q, k, v)).abs().max()
                 / out.abs().max()).item())
    return {"B": B, "H": H, "L": L, "path": path, "chunks": chunks, "rel_err": rel,
            "clocks": dict(zip(names, clocks)),
            "share": {p: c / total for p, c in zip(names, clocks)}}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--B", type=int, default=64)
    ap.add_argument("--H", type=int, default=12)
    ap.add_argument("--L", type=int, default=1025)
    ap.add_argument("--path", choices=tuple(PHASES), default="streamed")
    args = ap.parse_args(argv)
    print(json.dumps(phase_clocks(args.B, args.H, args.L, args.path)), flush=True)


if __name__ == "__main__":
    main()
