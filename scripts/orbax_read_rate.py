"""The port's orbax reader at a real size, on the host's CPU (no card).

    python scripts/orbax_read_rate.py [--out rate.json]

Needs `zstandard` and `tensorstore`, which write its inputs; what it times
is the port alone (`vlsa_tpu_torch.utils.zstd.decompress` and
`vlsa_tpu_torch.runner.orbax.read_orbax_checkpoint`), so it runs where
those two are installed, not on a machine that only runs the port.

  * `frames`: one zstd frame of weight-like f32 values (normal, 0.02) at
    level 1, the level of orbax's zarr arrays, for each of FRAME_MB, and
    the decoder's MB/s (decoded bytes over seconds) on each;
  * `store`: the f32 weights of one transformer block of width 768 (a
    CONCH or CLIP text tower's; 7.1 M values, 28.3 MB) as zarr v2 arrays on
    an OCDBT store, laid out as orbax lays a checkpoint out (see
    tests/test_torch_orbax.py), read by `read_orbax_checkpoint`: seconds in
    all, in the zstd decoder and in the CRC-32C checks, and MB/s.

Prints one JSON object and writes it to --out if given.
"""
import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FRAME_MB = (1, 4, 16)
WIDTH = 768
BLOCK = {"attn.in_proj_weight": (3 * WIDTH, WIDTH), "attn.in_proj_bias": (3 * WIDTH,),
         "attn.out_proj.weight": (WIDTH, WIDTH), "attn.out_proj.bias": (WIDTH,),
         "ln_1.weight": (WIDTH,), "ln_1.bias": (WIDTH,), "ln_2.weight": (WIDTH,),
         "ln_2.bias": (WIDTH,), "mlp.c_fc.weight": (4 * WIDTH, WIDTH),
         "mlp.c_fc.bias": (4 * WIDTH,), "mlp.c_proj.weight": (WIDTH, 4 * WIDTH),
         "mlp.c_proj.bias": (WIDTH,)}


def weights(rng, shape) -> np.ndarray:
    return (rng.standard_normal(shape) * 0.02).astype(np.float32)


def frame_rates(rng) -> list:
    import zstandard
    from vlsa_tpu_torch.utils.zstd import decompress
    out = []
    for mb in FRAME_MB:
        raw = weights(rng, (mb * 2 ** 18,)).tobytes()
        frame = zstandard.ZstdCompressor(level=1).compress(raw)
        t = time.perf_counter()
        got = decompress(frame)
        s = time.perf_counter() - t
        assert got == raw
        out.append({"mb": mb, "bytes": len(raw), "frame_bytes": len(frame), "seconds": s,
                    "mb_s": len(raw) / s / 1e6})
    return out


def write_store(root: str, arrays: dict) -> None:
    """`arrays` as orbax writes a tree {"model": arrays}: one zarr v2 array a
    leaf (one chunk, zstd level 1) on an OCDBT store, and `_METADATA`."""
    import tensorstore as ts
    meta = {"tree_metadata": {}, "use_ocdbt": True, "use_zarr3": False}
    for name, arr in arrays.items():
        spec = {"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{root}/",
                                              "path": f"model.{name}/"},
                "metadata": {"shape": list(arr.shape), "chunks": list(arr.shape),
                             "dtype": arr.dtype.str, "compressor": {"id": "zstd", "level": 1},
                             "dimension_separator": "."},
                "create": True, "delete_existing": True}
        ts.open(spec).result().write(arr).result()
        key = ("model", name)
        meta["tree_metadata"][str(key)] = {
            "key_metadata": [{"key": k, "key_type": 2} for k in key],
            "value_metadata": {"value_type": "np.ndarray", "skip_deserialize": False}}
    with open(os.path.join(root, "_METADATA"), "w") as f:
        json.dump(meta, f)


def store_rate(rng) -> dict:
    from vlsa_tpu_torch.runner import orbax
    arrays = {name: weights(rng, shape) for name, shape in BLOCK.items()}
    spent = {"decompress": 0.0, "crc32c": 0.0}

    def timed(fn, key):
        def run(*a):
            t = time.perf_counter()
            try:
                return fn(*a)
            finally:
                spent[key] += time.perf_counter() - t
        return run

    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "block.ckpt.orbax")
        write_store(root, arrays)
        on_disk = sum(os.path.getsize(os.path.join(d, f))
                      for d, _s, fs in os.walk(root) for f in fs)
        plain = orbax.decompress, orbax.crc32c
        orbax.decompress, orbax.crc32c = timed(plain[0], "decompress"), timed(plain[1], "crc32c")
        try:
            t = time.perf_counter()
            got = orbax.read_orbax_checkpoint(root)
            seconds = time.perf_counter() - t
        finally:
            orbax.decompress, orbax.crc32c = plain
    assert all(np.array_equal(got["model"][k], v) for k, v in arrays.items())
    n = sum(a.nbytes for a in arrays.values())
    return {"leaves": len(arrays), "bytes": n, "bytes_on_disk": on_disk, "seconds": seconds,
            "zstd_seconds": spent["decompress"], "crc32c_seconds": spent["crc32c"],
            "mb_s": n / seconds / 1e6}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    rng = np.random.default_rng(args.seed)
    result = {"frames": frame_rates(rng), "store": store_rate(rng)}
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
