"""Store conversion (counterpart of vlsa_tpu/data/convert.py): every `.pt`,
`.h5` or `.npy` slide of a directory into the stores the native loader
reads, or (`--graphs`) every torch_geometric `.pt` slide graph into the
`.npz` edge lists of `data_mode: graph`.

    python -m vlsa_tpu_torch.data.convert --src <dir> --dst <dir> [--f16] [--dtype f32|f16|int8]
    python -m vlsa_tpu_torch.data.convert --graphs --src <graph .pt dir> --dst <npz dir>

f32 (the default) and f16 write `<sid>.npy`; int8 writes `<sid>.q8npz`, the
per-patch symmetric quantization {q int8 [N, D], scale f32 [N], inv f32 [N] =
1/||q||}, computed once here so that training reads int8 batches with no
host quantization or norm pass (`feat_format: q8npz`, `feats_dtype: int8`).

A graph `.pt` is a pickled torch_geometric `Data` (the reference's PatchGCN
inputs); it is read without torch_geometric through stub classes, in both
its layouts (tg1: attributes on the object; tg2: behind `_store`), and
written as `<sid>.npz` {edge_index [2, E] int64, edge_latent when the file
has one}.  DeepAttnMISL's cluster files (`<pid>.npy`) need no conversion.
"""
from __future__ import annotations

import argparse
import functools
import importlib.machinery
import os
import os.path as osp
import sys
import types
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from .bags import read_patch_data
from .quant import feats_inv_norms, quantize_feats_int8

SOURCE_FORMATS = (".pt", ".h5", ".npy")


def _convert_file(src: str, dst: str, fname: str, dtype: str) -> None:
    stem = osp.splitext(fname)[0]
    arr = read_patch_data(osp.join(src, fname))
    if dtype == "int8":
        q, scale = quantize_feats_int8(arr.astype(np.float32))
        # through a file object: np.savez would add ".npz" to the name
        with open(osp.join(dst, stem + ".q8npz"), "wb") as f:
            np.savez(f, q=q, scale=scale, inv=feats_inv_norms(q))
    else:
        np.save(osp.join(dst, stem + ".npy"),
                arr.astype(np.float16 if dtype == "f16" else np.float32))


def convert_dir(src: str, dst: str, f16: bool = False, verbose: bool = True,
                dtype: Optional[str] = None) -> int:
    """Convert each slide file of `src` (sorted by name) into `dst`; returns
    the count.  `dtype`: None or 'f32' (.npy f32), 'f16' (.npy f16, also with
    `f16`), 'int8' (.q8npz).  The slides are converted by up to 8 threads
    at once (numpy's reads, casts and writes run outside the interpreter
    lock)."""
    if dtype not in (None, "f32", "f16", "int8"):
        raise ValueError(f"dtype must be f32, f16 or int8, got {dtype!r}")
    dtype = "f16" if f16 else (dtype or "f32")
    os.makedirs(dst, exist_ok=True)
    names = [f for f in sorted(os.listdir(src)) if osp.splitext(f)[1] in SOURCE_FORMATS]
    convert = functools.partial(_convert_file, src, dst, dtype=dtype)
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        for n, _ in enumerate(pool.map(convert, names), 1):
            if verbose and n % 100 == 0:
                print(f"[convert] {n} files...")
    if verbose:
        print(f"[convert] wrote {len(names)} feature files to {dst}")
    return len(names)


class _Plain:
    """An unpickling target: the default object reduce restores __dict__."""


def install_tg_unpickle_stubs() -> None:
    """Stub modules and classes under torch_geometric's names, so torch.load
    unpickles its `Data` objects without the package (an installed
    torch_geometric is left as it is; stubs already there are kept)."""
    existing = sys.modules.get("torch_geometric")
    if existing is not None and getattr(existing, "__file__", None):
        return

    def module(name):
        mod = sys.modules.get(name)
        if mod is None:
            mod = types.ModuleType(name)
            mod.__spec__ = importlib.machinery.ModuleSpec(name, None)
            sys.modules[name] = mod
        return mod

    tg = module("torch_geometric")
    data_pkg = module("torch_geometric.data")
    data_mod = module("torch_geometric.data.data")
    storage_mod = module("torch_geometric.data.storage")
    for mod, names in ((data_mod, ("Data", "Batch", "DataEdgeAttr", "DataTensorAttr")),
                       (storage_mod, ("GlobalStorage", "NodeStorage", "EdgeStorage",
                                      "BaseStorage"))):
        for name in names:
            if not hasattr(mod, name):
                setattr(mod, name, type(name, (_Plain,), {"__module__": mod.__name__}))
    for name in ("Data", "Batch", "DataEdgeAttr", "DataTensorAttr"):
        if not hasattr(data_pkg, name):
            setattr(data_pkg, name, getattr(data_mod, name))
    tg.data = data_pkg
    data_pkg.data, data_pkg.storage = data_mod, storage_mod


def extract_graph_arrays(obj) -> dict:
    """{edge_index, edge_latent if present} as int64 arrays from an
    unpickled graph (tg1 or tg2 layout)."""
    attrs = dict(getattr(obj, "__dict__", {}))
    store = attrs.pop("_store", None)
    if store is not None:
        attrs.update(getattr(store, "_mapping", getattr(store, "__dict__", {})))
    out = {}
    for key in ("edge_index", "edge_latent"):
        value = attrs.get(key)
        if value is not None:
            value = value.detach().cpu().numpy() if hasattr(value, "detach") else value
            out[key] = np.asarray(value).astype(np.int64)
    if "edge_index" not in out:
        raise ValueError(f"no edge_index in the graph object (keys: {sorted(attrs)})")
    return out


def convert_graph_dir(src: str, dst: str, verbose: bool = True) -> int:
    """Every `.pt` graph of `src` (sorted by name) as `<stem>.npz` in `dst`;
    returns the count."""
    import torch
    install_tg_unpickle_stubs()
    os.makedirs(dst, exist_ok=True)
    n = 0
    for fname in sorted(os.listdir(src)):
        stem, ext = osp.splitext(fname)
        if ext != ".pt":
            continue
        obj = torch.load(osp.join(src, fname), map_location="cpu", weights_only=False)
        np.savez(osp.join(dst, stem + ".npz"), **extract_graph_arrays(obj))
        n += 1
        if verbose and n % 100 == 0:
            print(f"[convert] {n} graphs...")
    if verbose:
        print(f"[convert] wrote {n} .npz graphs to {dst}")
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True)
    ap.add_argument("--dst", required=True)
    ap.add_argument("--graphs", action="store_true",
                    help="convert torch_geometric .pt slide graphs to .npz edge lists")
    ap.add_argument("--f16", action="store_true", help="store as float16")
    ap.add_argument("--dtype", choices=["f32", "f16", "int8"], default=None,
                    help="int8 = pre-quantized .q8npz store with per-patch "
                         "scale + 1/l2norm sidecars")
    args = ap.parse_args(argv)
    if args.graphs:
        return convert_graph_dir(args.src, args.dst)
    return convert_dir(args.src, args.dst, f16=args.f16, dtype=args.dtype)


if __name__ == "__main__":
    main()
