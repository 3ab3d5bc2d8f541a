"""Feature-store conversion (the feature half of vlsa_tpu/data/convert.py):
every `.pt`, `.h5` or `.npy` slide of a directory into the stores the
native loader reads.

    python -m vlsa_tpu_torch.data.convert --src <dir> --dst <dir> [--f16] [--dtype f32|f16|int8]

f32 (the default) and f16 write `<sid>.npy`; int8 writes `<sid>.q8npz`, the
per-patch symmetric quantization {q int8 [N, D], scale f32 [N], inv f32 [N] =
1/||q||}, computed once here so that training reads int8 batches with no
host quantization or norm pass (`feat_format: q8npz`, `feats_dtype: int8`).
Converting graphs (`--graphs` in vlsa_tpu) is not ported yet (ROADMAP.md
§A.12).
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
from typing import Optional

import numpy as np

from .bags import read_patch_data
from .quant import feats_inv_norms, quantize_feats_int8

SOURCE_FORMATS = (".pt", ".h5", ".npy")


def convert_dir(src: str, dst: str, f16: bool = False, verbose: bool = True,
                dtype: Optional[str] = None) -> int:
    """Convert each slide file of `src` (sorted by name) into `dst`; returns
    the count.  `dtype`: None or 'f32' (.npy f32), 'f16' (.npy f16, also with
    `f16`), 'int8' (.q8npz)."""
    if dtype not in (None, "f32", "f16", "int8"):
        raise ValueError(f"dtype must be f32, f16 or int8, got {dtype!r}")
    os.makedirs(dst, exist_ok=True)
    n = 0
    for fname in sorted(os.listdir(src)):
        stem, ext = osp.splitext(fname)
        if ext not in SOURCE_FORMATS:
            continue
        arr = read_patch_data(osp.join(src, fname))
        if dtype == "int8":
            q, scale = quantize_feats_int8(arr.astype(np.float32))
            # through a file object: np.savez would add ".npz" to the name
            with open(osp.join(dst, stem + ".q8npz"), "wb") as f:
                np.savez(f, q=q, scale=scale, inv=feats_inv_norms(q))
        else:
            np.save(osp.join(dst, stem + ".npy"),
                    arr.astype(np.float16 if (f16 or dtype == "f16") else np.float32))
        n += 1
        if verbose and n % 100 == 0:
            print(f"[convert] {n} files...")
    if verbose:
        print(f"[convert] wrote {n} feature files to {dst}")
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True)
    ap.add_argument("--dst", required=True)
    ap.add_argument("--f16", action="store_true", help="store as float16")
    ap.add_argument("--dtype", choices=["f32", "f16", "int8"], default=None,
                    help="int8 = pre-quantized .q8npz store with per-patch "
                         "scale + 1/l2norm sidecars")
    args = ap.parse_args(argv)
    return convert_dir(args.src, args.dst, f16=args.f16, dtype=args.dtype)


if __name__ == "__main__":
    main()
