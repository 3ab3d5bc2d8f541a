"""Image preprocessing for the patch->feature extraction pipeline (a numpy
copy of vlsa_tpu/data/transforms.py; the port imports nothing of vlsa_tpu).

Replicates the reference's torchvision transform stacks *bit-exactly* on
uint8 RGB tiles, in pure numpy (no PIL/torchvision dependency at runtime):

  * CONCH:  Resize(448, BICUBIC) -> CenterCrop(448) -> RGB -> ToTensor ->
            Normalize(OPENAI mean/std)
            (ref model/conch/transform.py:11-39; the factory overrides the
            IMAGENET defaults with the OpenAI constants at
            ref model/conch/factory.py:71-72,104-110)
  * CLIP:   Resize(n_px, BICUBIC) -> CenterCrop(n_px) -> RGB -> ToTensor ->
            Normalize(OPENAI mean/std)   (ref model/clip/clip.py:79-86)

torchvision applies these to PIL images, so the resize semantics are PIL's
`Image.resize(..., BICUBIC)`: a separable two-pass (horizontal then
vertical) convolution with the Keys cubic filter (a = -0.5, support 2),
antialiased when downsampling (filter support scaled by the ratio), run in
8-bit fixed point with PRECISION_BITS = 22 and a uint8 intermediate between
the passes.  `resize_bicubic_u8` reproduces that integer pipeline exactly
(equal to vlsa_tpu's, which its tests hold against PIL byte for byte,
tests/test_torch_transforms.py), so features extracted here
match a reference extraction to the tower's own numeric tolerance.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

# ref model/conch/constants.py:1-8
OPENAI_DATASET_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_DATASET_STD = (0.26862954, 0.26130258, 0.27577711)
IMAGENET_DATASET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_DATASET_STD = (0.229, 0.224, 0.225)

_PRECISION_BITS = 32 - 8 - 2  # PIL Resample.c 8bpc fixed-point precision
_BICUBIC_SUPPORT = 2.0


def _bicubic_filter(x: np.ndarray) -> np.ndarray:
    """Keys cubic kernel with a = -0.5 (PIL's BICUBIC)."""
    a = -0.5
    x = np.abs(x)
    return np.where(
        x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
        np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * a, 0.0))


def _resample_matrix_u8(in_size: int, out_size: int) -> np.ndarray:
    """Dense int64 [out_size, in_size] fixed-point resampling matrix,
    mirroring PIL's precompute_coeffs + normalize_coeffs_8bpc."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = _BICUBIC_SUPPORT * filterscale
    centers = (np.arange(out_size) + 0.5) * scale
    # C-style truncation toward zero, then clamp (PIL Resample.c)
    xmin = np.trunc(centers - support + 0.5).astype(np.int64)
    xmin = np.maximum(xmin, 0)
    xmax = np.trunc(centers + support + 0.5).astype(np.int64)
    xmax = np.minimum(xmax, in_size)
    M = np.zeros((out_size, in_size), np.float64)
    inv_fs = 1.0 / filterscale
    for xx in range(out_size):
        idx = np.arange(xmin[xx], xmax[xx])
        w = _bicubic_filter((idx - centers[xx] + 0.5) * inv_fs)
        s = w.sum()
        if s != 0.0:
            w = w / s
        M[xx, idx] = w
    # round-half-away-from-zero into the fixed-point grid
    k = M * (1 << _PRECISION_BITS)
    return np.trunc(k + np.sign(k) * 0.5).astype(np.int64)


def _resample_taps_u8(in_size: int, out_size: int):
    """Per-output-pixel tap form of `_resample_matrix_u8`:
    `(xmin int64 [out], coeffs int64 [out, ksize])` with zero-padded rows,
    so `M[o, xmin[o] + k] == coeffs[o, k]` for every in-range tap.

    The device preprocessing path (`transforms_device.py`) needs this form:
    TPU lowers int32 dot-products through float passes that are NOT exact
    at PIL's 2^30 accumulator range, while elementwise int32 multiply-adds
    over the <= ksize taps are exact on every backend."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = _BICUBIC_SUPPORT * filterscale
    centers = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(centers - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(centers + support + 0.5).astype(np.int64),
                      in_size)
    M = _resample_matrix_u8(in_size, out_size)
    ksize = int(np.max(xmax - xmin))
    coeffs = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        n = int(xmax[xx] - xmin[xx])
        coeffs[xx, :n] = M[xx, xmin[xx]:xmax[xx]]
    return xmin, coeffs


def _clip8(acc: np.ndarray) -> np.ndarray:
    """PIL clip8: (acc >> PRECISION_BITS) clamped to [0, 255]."""
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bicubic_u8(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """PIL-exact BICUBIC resize of a uint8 [H, W, C] image to (out_h, out_w).

    Horizontal pass first, uint8 intermediate, then vertical — the same
    order, fixed-point precision, and rounding as PIL's 8bpc resample, so
    the output equals `np.array(PIL.Image.resize((out_w, out_h), BICUBIC))`
    exactly (tests/test_extract.py)."""
    assert img.dtype == np.uint8 and img.ndim == 3
    h, w, _ = img.shape
    out_h, out_w = out_hw
    half = 1 << (_PRECISION_BITS - 1)
    if out_w != w:
        M = _resample_matrix_u8(w, out_w)                     # [out_w, w]
        acc = np.einsum("hwc,ow->hoc", img.astype(np.int64), M) + half
        img = _clip8(acc)
    if out_h != h:
        M = _resample_matrix_u8(h, out_h)                     # [out_h, h]
        acc = np.einsum("hwc,oh->owc", img.astype(np.int64), M) + half
        img = _clip8(acc)
    return img


def resize_shortest_edge(img: np.ndarray, size: int) -> np.ndarray:
    """torchvision `Resize(int)` semantics on PIL images: resize the
    shortest edge to `size` preserving aspect (int-truncated long edge);
    a no-op when the shortest edge already matches
    (torchvision F.resize PIL path)."""
    h, w = img.shape[:2]
    short, long = (w, h) if w <= h else (h, w)
    if short == size:
        return img
    new_short, new_long = size, int(size * long / short)
    new_w, new_h = (new_short, new_long) if w <= h else (new_long, new_short)
    return resize_bicubic_u8(img, (new_h, new_w))


def center_crop(img: np.ndarray, size: int) -> np.ndarray:
    """torchvision CenterCrop: round-half-up offsets; zero-pads images
    smaller than the crop."""
    h, w = img.shape[:2]
    if h < size or w < size:
        pad_h, pad_w = max(size - h, 0), max(size - w, 0)
        img = np.pad(img, ((pad_h // 2, pad_h - pad_h // 2),
                           (pad_w // 2, pad_w - pad_w // 2), (0, 0)))
        h, w = img.shape[:2]
    top = int(round((h - size) / 2.0))
    left = int(round((w - size) / 2.0))
    return img[top:top + size, left:left + size]


def normalize_to_nchw(img: np.ndarray, mean: Sequence[float],
                      std: Sequence[float]) -> np.ndarray:
    """ToTensor (/255, HWC->CHW) + Normalize, float32."""
    x = img.astype(np.float32) / 255.0
    x = (x - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
    return np.ascontiguousarray(x.transpose(2, 0, 1))


def preprocess_tile(img: np.ndarray, image_size: int,
                    mean: Sequence[float] = OPENAI_DATASET_MEAN,
                    std: Sequence[float] = OPENAI_DATASET_STD) -> np.ndarray:
    """Full reference transform on one uint8 [H, W, 3] tile -> f32
    [3, image_size, image_size] (NCHW, the towers' input layout)."""
    img = resize_shortest_edge(img, image_size)
    img = center_crop(img, image_size)
    return normalize_to_nchw(img, mean, std)


def preprocess_batch(tiles: Sequence[np.ndarray], image_size: int,
                     mean: Sequence[float] = OPENAI_DATASET_MEAN,
                     std: Sequence[float] = OPENAI_DATASET_STD) -> np.ndarray:
    """Preprocess a list of uint8 tiles -> f32 [B, 3, S, S].

    Same-shaped tiles (the common case: a tiler emits fixed-size patches)
    take one vectorised path instead of a per-tile loop."""
    tiles = list(tiles)
    if not tiles:
        return np.zeros((0, 3, image_size, image_size), np.float32)
    shapes = {t.shape for t in tiles}
    if len(shapes) == 1 and tiles[0].shape[:2] == (image_size, image_size):
        # resize is a no-op (shortest edge == target) and crop is identity
        x = np.stack(tiles).astype(np.float32) / 255.0
        x = (x - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
        return np.ascontiguousarray(x.transpose(0, 3, 1, 2))
    return np.stack([preprocess_tile(t, image_size, mean, std) for t in tiles])


def conch_preprocess(tiles, image_size: int = 448) -> np.ndarray:
    """CONCH stack (ref model/conch/factory.py:104-110 with the OpenAI
    constants set at factory.py:71-72)."""
    return preprocess_batch(tiles, image_size,
                            OPENAI_DATASET_MEAN, OPENAI_DATASET_STD)


def clip_preprocess(tiles, image_size: int = 224) -> np.ndarray:
    """OpenAI-CLIP stack (ref model/clip/clip.py:79-86)."""
    return preprocess_batch(tiles, image_size,
                            OPENAI_DATASET_MEAN, OPENAI_DATASET_STD)
