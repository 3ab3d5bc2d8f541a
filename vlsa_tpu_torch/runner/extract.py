"""Extract patch features from WSI tiles with a vision tower on the card.

    python -m vlsa_tpu_torch.runner.extract --source /data/tiles --out /data/feats \\
        --ckpt /weights/conch/pytorch_model.bin --format q8npz
    python -m vlsa_tpu_torch.runner.extract --synthetic 2 --synthetic_tiles 130 --out /tmp/feats
    python -m vlsa_tpu_torch.runner.extract --model clip_vit --synthetic 1 --out /tmp/clip
    python -m vlsa_tpu_torch.runner.extract --trunk_quant --synthetic 1 --out /tmp/w8a8

The counterpart of scripts/extract_features.py for the arguments this port
supports.  Sources are CLAM-style .h5 tile files, .npy u8 stacks or
directories of images; the stores (.npy or .q8npz, plus coords .h5) are what
`python -m vlsa_tpu_torch.runner.train` reads with `feat_format: npy|q8npz`.
`--synthetic N` makes N slides of `--synthetic_tiles` random u8 tiles of
`--image_size` pixels in a temporary directory.  `--model` is `conch`
(CONCH's visual model; `--trunk_quant` makes its trunk's linears w8a8) or
`clip_vit` (OpenAI CLIP's ViT-B/16 image embedding).  Without `--ckpt` the
weights are random, from `--seed`.  `--num_devices N` puts a replica on
each of the first N cards and splits every batch over them in order
(`FeatureExtractor(num_devices=N)`).  Prints the stats of
`extract_to_store` as one JSON line, with the model, `trunk_quant` and the
flash kernel's launches.  `--device cpu` runs it on the CPU (use a small --image_size and
--batch there).
"""
from __future__ import annotations

import argparse
import json
import os.path as osp
import tempfile

import numpy as np

from ..data.extract import FeatureExtractor, extract_to_store
from ..ops import flash_attn


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--source", default=None,
                   help="slide tile source: dir of .h5/.npy/image-dirs, or one such source")
    p.add_argument("--out", required=True, help="output feature-store dir")
    p.add_argument("--model", default="conch", choices=["conch", "clip_vit"])
    p.add_argument("--ckpt", default=None,
                   help="torch checkpoint (CONCH pytorch_model.bin or a CLIP state dict, visual.* "
                        "tensors); random weights if omitted")
    p.add_argument("--format", default="npy", choices=["npy", "q8npz"])
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--image_size", type=int, default=448)
    p.add_argument("--trunk_quant", action="store_true",
                   help="w8a8 int8 trunk linears (CONCH only)")
    p.add_argument("--num_devices", type=int, default=None,
                   help="cards to split each batch over (a replica on each)")
    p.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument("--device_preprocess", default="auto", choices=["auto", "0", "1"],
                   help="PIL-exact resize on the card (auto: on for CUDA)")
    p.add_argument("--resume", action="store_true",
                   help="skip slides whose feature store already exists")
    p.add_argument("--no_prefetch", action="store_true",
                   help="read tiles without the one-slide background read-ahead")
    p.add_argument("--coord_dir", default=None, help="where coords .h5 go (default: --out)")
    p.add_argument("--synthetic", type=int, default=0,
                   help="extract N synthetic slides instead of reading --source")
    p.add_argument("--synthetic_tiles", type=int, default=64, help="tiles per synthetic slide")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def make_synthetic_slides(root: str, n_slides: int, n_tiles: int, image_size: int,
                          seed: int = 0) -> None:
    rng = np.random.default_rng(seed)
    for i in range(n_slides):
        tiles = rng.integers(0, 256, size=(n_tiles, image_size, image_size, 3), dtype=np.uint8)
        np.save(osp.join(root, f"synthetic_{i}.npy"), tiles)


def main(argv=None) -> dict:
    args = get_args(argv)
    if not args.synthetic and args.source is None:
        raise SystemExit("either --source or --synthetic is required")
    extractor = FeatureExtractor(
        model_name=args.model, checkpoint=args.ckpt, image_size=args.image_size,
        batch_size=args.batch, compute_dtype=args.dtype, seed=args.seed,
        trunk_quant=args.trunk_quant, num_devices=args.num_devices, device=args.device,
        device_preprocess=(args.device_preprocess if args.device_preprocess == "auto"
                           else args.device_preprocess == "1"))
    with tempfile.TemporaryDirectory(prefix="vlsa_tiles_") as tmp:
        source = args.source
        if args.synthetic:
            make_synthetic_slides(tmp, args.synthetic, args.synthetic_tiles, args.image_size,
                                  args.seed)
            source = tmp
        flash_attn.reset_launches()
        stats = extract_to_store(source, args.out, extractor, fmt=args.format,
                                 coord_dir=args.coord_dir, resume=args.resume,
                                 prefetch=not args.no_prefetch)
    stats.update(model=args.model, trunk_quant=args.trunk_quant, format=args.format, image_size=args.image_size,
                 feat_dim=extractor.feat_dim, device=str(extractor.device),
                 weights="imported" if args.ckpt else "random-init",
                 flash_launches=dict(flash_attn.LAUNCHES),
                 flash_path_launches=dict(flash_attn.LAUNCHES_PATH))
    print(json.dumps(stats), flush=True)
    return stats


if __name__ == "__main__":
    main()
