"""Patch -> feature extraction on the card (counterpart of
vlsa_tpu/data/extract.py): WSI tiles through the CONCH visual model to the
512-d per-patch feature stores that training and serving read.

  * preprocessing is the PIL-exact transform stack, on the card
    (`transforms_device.py`: u8 tiles copied, resized by int32 taps) or on
    the host (`transforms.py`, numpy);
  * the tower is `ConchVisualModel.forward_no_head` (CONCH's MIL feature
    convention: 512-d, LayerNormed, unprojected) at a fixed batch, the
    ragged tail zero-padded; its trunk attention runs the hand-written
    flash kernel (`ops/flash_attn.py`);
  * a slide's batches are queued on the card back to back and its features
    read back once, so the host prepares batch i+1 while the card runs
    batch i (CUDA's own asynchrony; JAX gets the same from async dispatch);
  * stores are `.npy` (f32) or `.q8npz` (int8 per-patch, `data/quant.py`),
    written atomically, plus an optional CLAM-style coords `.h5` per slide.

Tile sources per slide: a CLAM-style `.h5` (`imgs` [N, H, W, 3] u8 +
`coords` [N, 2]), a `.npy` u8 stack, or a directory of image files with
optional `<x>_<y>` coordinates in the file name.  PIL and h5py are imported
only when such a source (or a coords file) is read or written.
"""
from __future__ import annotations

import os
import os.path as osp
import re
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models.precision import cast_vision_tower_weights
from ..models.vision_tower import ConchVisualModel, as_dtype, load_conch_visual_state
from ..utils.device import disable_tf32, resolve_device
from ..utils.torch_import import load_torch_state_dict
from .quant import feats_inv_norms, quantize_feats_int8
from .transforms import OPENAI_DATASET_MEAN, OPENAI_DATASET_STD, preprocess_batch
from .transforms_device import build_device_preprocess

_IMG_EXTS = (".png", ".jpg", ".jpeg", ".tif", ".tiff", ".bmp")
_TODO = "not ported yet (ROADMAP.md §A.14)"


def _lazy_import(name: str, what: str):
    try:
        return __import__(name)
    except ImportError as exc:
        raise ImportError(f"{what} needs the '{name}' package, which is not installed") from exc


# ---------------------------------------------------------------------------
# Tile sources
# ---------------------------------------------------------------------------


def list_tile_sources(path: str) -> List[Tuple[str, str]]:
    """(slide_id, source_path) under `path`: one slide source (.h5/.npy/dir
    of images), or a directory of such sources, one per slide."""
    if osp.isfile(path):
        return [(osp.splitext(osp.basename(path))[0], path)]
    entries = sorted(os.listdir(path))
    if any(e.lower().endswith(_IMG_EXTS) for e in entries):  # one slide as a dir of tiles
        return [(osp.basename(osp.normpath(path)), path)]
    out = []
    for e in entries:
        full = osp.join(path, e)
        if e.lower().endswith((".h5", ".hdf5", ".npy")):
            out.append((osp.splitext(e)[0], full))
        elif osp.isdir(full):
            out.append((e, full))
    return out


_COORD_RE = re.compile(r"(\d+)[_x,-](\d+)\D*$")


def read_tiles(source: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """One slide's tiles -> (u8 [N, H, W, 3], coords [N, 2] or None)."""
    if source.lower().endswith((".h5", ".hdf5")):
        h5py = _lazy_import("h5py", f"reading {source}")
        with h5py.File(source, "r") as hf:
            key = "imgs" if "imgs" in hf else "tiles"
            tiles = np.asarray(hf[key][:])
            coords = np.asarray(hf["coords"][:]) if "coords" in hf else None
        return _as_u8_rgb(tiles), coords
    if source.lower().endswith(".npy"):
        return _as_u8_rgb(np.load(source)), None
    files = sorted(f for f in os.listdir(source) if f.lower().endswith(_IMG_EXTS))
    if not files:
        raise FileNotFoundError(f"no tiles under {source}")
    # PIL releases the GIL while it decodes, so a thread pool scales with cores
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        tiles = list(pool.map(lambda f: _read_image(osp.join(source, f)), files))
    coords = [_COORD_RE.search(osp.splitext(f)[0]) for f in files]
    coords = (np.asarray([(int(m.group(1)), int(m.group(2))) for m in coords], np.int64)
              if all(coords) else None)
    arr = np.stack(tiles) if len({t.shape for t in tiles}) == 1 else tiles
    return arr, coords


def _read_image(path: str) -> np.ndarray:
    Image = _lazy_import("PIL.Image", f"reading {path}").Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _as_u8_rgb(arr: np.ndarray) -> np.ndarray:
    arr = np.asarray(arr)
    if arr.ndim == 3:  # [H, W, 3] single tile
        arr = arr[None]
    if arr.ndim != 4 or arr.shape[-1] != 3:
        raise ValueError(f"bad tile stack {arr.shape}: expected [N, H, W, 3]")
    return arr if arr.dtype == np.uint8 else arr.astype(np.uint8)


# ---------------------------------------------------------------------------
# The extractor
# ---------------------------------------------------------------------------


class FeatureExtractor:
    """CONCH `forward_no_head` at a fixed batch over u8 tiles.

    `checkpoint`: a CONCH torch checkpoint (its `visual.*` tensors, through
    `load_conch_visual_state`); without one, seeded random weights.  bf16
    compute pre-casts the trunk's matmul weights once (bit-identical).
    `device_preprocess`: 'auto' (on when the extractor runs on CUDA), True or
    False; tiles of mixed shapes are preprocessed on the host.  `device`:
    CUDA unless 'cpu' is asked for.
    """

    def __init__(self, model_name: str = "conch", checkpoint: Optional[str] = None,
                 image_size: int = 448, batch_size: int = 64,
                 compute_dtype: str = "bfloat16", residual_dtype: Optional[str] = None,
                 num_devices: Optional[int] = None, device_preprocess="auto", seed: int = 0,
                 trunk_quant: bool = False, model_overrides: Optional[dict] = None,
                 device=None):
        if model_name != "conch":
            raise NotImplementedError(f"extractor model '{model_name}': {_TODO}")
        if num_devices is not None and num_devices > 1:
            raise NotImplementedError(f"multi-device extraction: {_TODO}")
        if trunk_quant:
            raise NotImplementedError(f"the w8a8 trunk (trunk_quant): {_TODO}")
        self.device = resolve_device(device)
        disable_tf32()
        self.image_size = int(image_size)
        self.batch_size = int(batch_size)
        overrides = dict(model_overrides or {})
        if residual_dtype is not None:
            overrides.setdefault("trunk_residual_dtype", residual_dtype)
        model = ConchVisualModel(image_size=self.image_size, compute_dtype=compute_dtype,
                                 generator=torch.Generator().manual_seed(seed), **overrides)
        if checkpoint is not None:
            model.load_state_dict(load_conch_visual_state(
                load_torch_state_dict(checkpoint), layers=model.trunk.layers,
                image_size=self.image_size, patch_size=model.trunk.patch_size), strict=True)
        if as_dtype(compute_dtype) == torch.bfloat16:
            cast_vision_tower_weights(model)
        self.model = model.to(self.device).eval()
        self.feat_dim = model.embed_dim_contrast
        if device_preprocess == "auto":
            device_preprocess = self.device.type == "cuda"
        self._device_preprocess = bool(device_preprocess)
        self._u8_pipelines = {}  # (H, W) -> u8 batch -> features

    def preprocess(self, tiles) -> np.ndarray:
        """u8 tiles -> f32 [N, 3, S, S] on the host (PIL-exact)."""
        return preprocess_batch(tiles, self.image_size, OPENAI_DATASET_MEAN, OPENAI_DATASET_STD)

    def _run_batched(self, fn, x: np.ndarray) -> np.ndarray:
        """`fn` over `x` in `batch_size` chunks, the ragged tail zero-padded
        and sliced off.  The slide is staged once in pinned host memory (on
        CUDA) and every chunk's copy and forward are queued without waiting;
        the features are read back once, at the end."""
        N, B = x.shape[0], self.batch_size
        if N == 0:
            return np.zeros((0, self.feat_dim), np.float32)
        n_pad = -(-N // B) * B
        host = torch.empty((n_pad,) + x.shape[1:], dtype=torch.from_numpy(x[:1]).dtype,
                           pin_memory=self.device.type == "cuda")
        host[:N] = torch.from_numpy(np.ascontiguousarray(x))
        host[N:] = 0
        outs = []
        with torch.inference_mode():
            for i in range(0, n_pad, B):
                outs.append(fn(host[i:i + B].to(self.device, non_blocking=True)))
            return torch.cat(outs)[:N].float().cpu().numpy()

    def extract_preprocessed(self, x: np.ndarray) -> np.ndarray:
        """f32 [N, 3, S, S] -> f32 [N, feat_dim]."""
        return self._run_batched(self.model.forward_no_head, x)

    def _u8_pipeline(self, in_hw):
        if in_hw not in self._u8_pipelines:
            pre = build_device_preprocess(tuple(in_hw), self.image_size)
            fwd = self.model.forward_no_head
            self._u8_pipelines[in_hw] = lambda u8: fwd(pre(u8))
        return self._u8_pipelines[in_hw]

    def extract(self, tiles) -> np.ndarray:
        """u8 tiles ([N, H, W, 3] or a list of [H, W, 3]) -> f32 [N, feat_dim]."""
        if len(tiles) == 0:
            return np.zeros((0, self.feat_dim), np.float32)
        if self._device_preprocess:
            arr = tiles
            if isinstance(tiles, list):
                arr = np.stack(tiles) if len({t.shape for t in tiles}) == 1 else None
            if arr is not None and arr.ndim == 4 and arr.shape[-1] == 3 \
                    and arr.dtype == np.uint8:
                return self._run_batched(self._u8_pipeline(arr.shape[1:3]), arr)
        return self.extract_preprocessed(self.preprocess(tiles))


# ---------------------------------------------------------------------------
# Store writers and the extraction loop
# ---------------------------------------------------------------------------


def _write_atomic(path: str, write) -> None:
    """`write(file)` into a temporary file renamed to `path`: a store exists
    only once fully written, which `resume` relies on."""
    tmp = path + ".tmp"
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if osp.exists(tmp):
            os.remove(tmp)


def write_feature_store(out_dir: str, sid: str, feats: np.ndarray, fmt: str = "npy",
                        coords: Optional[np.ndarray] = None,
                        coord_dir: Optional[str] = None) -> str:
    """Write one slide's features as `<sid>.npy` (f32) or `<sid>.q8npz`
    (int8 `q`, per-patch `scale`, `inv` = 1/||q||), plus its coords as a
    CLAM-style `<sid>.h5` when given.  Atomic."""
    if fmt not in ("npy", "q8npz"):
        raise ValueError(f"unknown feature store format '{fmt}'")
    os.makedirs(out_dir, exist_ok=True)
    path = osp.join(out_dir, f"{sid}.{fmt}")
    feats = np.asarray(feats, np.float32)

    def write(tmp):
        with open(tmp, "wb") as f:
            if fmt == "npy":
                np.save(f, feats)
            else:
                q, scale = quantize_feats_int8(feats)
                np.savez(f, q=q, scale=scale, inv=feats_inv_norms(q))
    _write_atomic(path, write)
    if coords is not None:
        h5py = _lazy_import("h5py", "writing coords")
        cdir = coord_dir or out_dir
        os.makedirs(cdir, exist_ok=True)

        def write_coords(tmp):
            with h5py.File(tmp, "w") as hf:
                hf.create_dataset("coords", data=np.asarray(coords))
        _write_atomic(osp.join(cdir, sid + ".h5"), write_coords)
    return path


def extract_to_store(source_path: str, out_dir: str, extractor: FeatureExtractor,
                     fmt: str = "npy", coord_dir: Optional[str] = None, verbose: bool = True,
                     resume: bool = False, prefetch: bool = True) -> dict:
    """Extract every slide under `source_path` into `out_dir`.

    `resume` skips slides whose store exists (an interrupted cohort job
    restarts where it stopped); `prefetch` reads the next slide's tiles on a
    background thread while the card encodes the current one.  A slide with
    no tiles gets no store (it would surface as an empty training bag).

    Returns {'slides', 'tiles', 'skipped', 'empty', 'tiles_per_sec'}."""
    sources = list_tile_sources(source_path)
    if not sources:
        raise FileNotFoundError(f"no tile sources under {source_path}")
    n_skipped = 0
    if resume:
        remaining = []
        for sid, src in sources:
            if osp.exists(osp.join(out_dir, f"{sid}.{fmt}")):
                n_skipped += 1
                if verbose:
                    print(f"[extract] {sid}: store exists, skipped (resume)")
            else:
                remaining.append((sid, src))
        sources = remaining

    n_tiles = n_empty = 0
    t0 = time.perf_counter()

    def process(sid, tiles, coords) -> int:
        if len(tiles) == 0:
            print(f"[extract] WARNING: {sid} has 0 tiles, no store written")
            return 0
        feats = extractor.extract(tiles)
        write_feature_store(out_dir, sid, feats, fmt, coords, coord_dir)
        if verbose:
            print(f"[extract] {sid}: {len(tiles)} tiles -> {osp.join(out_dir, sid)}.{fmt}")
        return len(tiles)

    if prefetch and len(sources) > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=1) as pool:
            pending = pool.submit(read_tiles, sources[0][1])
            for i, (sid, _src) in enumerate(sources):
                tiles, coords = pending.result()
                if i + 1 < len(sources):
                    pending = pool.submit(read_tiles, sources[i + 1][1])
                n = process(sid, tiles, coords)
                n_tiles += n
                n_empty += n == 0
    else:
        for sid, src in sources:
            n = process(sid, *read_tiles(src))
            n_tiles += n
            n_empty += n == 0
    dt = time.perf_counter() - t0
    return {"slides": len(sources), "tiles": n_tiles, "skipped": n_skipped, "empty": n_empty,
            "tiles_per_sec": n_tiles / dt if dt > 0 else float("inf")}
