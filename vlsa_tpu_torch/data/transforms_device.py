"""Image preprocessing on the card for feature extraction (counterpart of
vlsa_tpu/data/transforms_device.py).

The host stack (`transforms.py`) reproduces PIL's fixed-point bicubic resize
in numpy; on a weak host that resize, not the tower, limits extraction.
PIL's separable resize touches only `ksize` (~6) input pixels per output
pixel, so the whole stack runs on the tensor's device as per-tap gathers and
int32 multiply-adds:

  u8 [B, H, W, 3]  --ksize index_selects + int32 MAC (horizontal, clip8)-->
                   --ksize index_selects + int32 MAC (vertical,   clip8)-->
                   --static center-crop slice-->
                   --(x/255 - mean)/std, HWC->CHW-->  f32 [B, 3, S, S]

The integer stages (resize and crop) are BYTE-EXACT against the host stack:
PIL's 8bpc pipeline accumulates in int32 (|acc| <= 255 * 2^22 * ~1.2 <
2^31, so every partial sum is exact in any order), rounds with an
arithmetic right shift (torch's `>>` on int32 is arithmetic), and keeps a
uint8 intermediate between the passes.  No integer matmul: the JAX package
found its TPU lowering inexact above 2^24, and elementwise int32 ops are
exact on every device.  The final f32 normalize is the same IEEE divides and
subtract as numpy's; the JAX contract holds it within 1e-6 absolute (one
ulp of each chained rounding), and it is exact on the CPU and on an H100.
Copying u8 tiles instead of f32 tensors also moves 4x fewer bytes to the
card.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .transforms import (_PRECISION_BITS, OPENAI_DATASET_MEAN, OPENAI_DATASET_STD,
                         _resample_taps_u8)


def _resize_plan(in_hw: Tuple[int, int], size: int) -> Tuple[int, int]:
    """torchvision Resize(int) shortest-edge target for an [H, W] input."""
    h, w = in_hw
    short, long = (w, h) if w <= h else (h, w)
    if short == size:
        return h, w
    new_short, new_long = size, int(size * long / short)
    return (new_long, new_short) if w <= h else (new_short, new_long)


class _TapPass:
    """One separable resize pass along `dim` of a u8 [B, H, W, 3] tensor:
    the taps whose coefficients are not all zero, as (input index [out],
    int32 coefficient [out]) pairs, moved to a device at first use."""

    def __init__(self, dim: int, in_size: int, out_size: int):
        xmin, coeffs = _resample_taps_u8(in_size, out_size)
        self.dim = dim
        self.taps = []
        for k in range(coeffs.shape[1]):
            ck = coeffs[:, k].astype(np.int32)
            if np.any(ck):  # padded taps have coeff 0 everywhere
                self.taps.append((np.minimum(xmin + k, in_size - 1).astype(np.int64), ck))
        self._on = {}

    def _device_taps(self, device):
        if device not in self._on:
            shape = [1, 1, 1, 1]
            shape[self.dim] = -1
            self._on[device] = [(torch.from_numpy(idx).to(device),
                                 torch.from_numpy(ck).to(device).view(shape))
                                for idx, ck in self.taps]
        return self._on[device]

    def __call__(self, y: torch.Tensor) -> torch.Tensor:
        acc = torch.full((), 1 << (_PRECISION_BITS - 1), dtype=torch.int32, device=y.device)
        for idx, ck in self._device_taps(y.device):
            acc = acc + y.index_select(self.dim, idx).to(torch.int32) * ck
        return torch.clamp(acc >> _PRECISION_BITS, 0, 255).to(torch.uint8)


def build_device_preprocess(in_hw: Tuple[int, int], image_size: int,
                            mean: Sequence[float] = OPENAI_DATASET_MEAN,
                            std: Sequence[float] = OPENAI_DATASET_STD,
                            normalize: bool = True):
    """`fn(u8 [B, H, W, 3]) -> f32 [B, 3, S, S]` for one input shape (the
    tiler's fixed patch size), on the device of its argument.

    `normalize=False` returns the cropped u8 [B, S, S, 3] instead (the
    byte-exact stage).  The crop offsets are static: a shortest-edge resize
    leaves both edges >= image_size, so the host path's zero-pad branch
    cannot trigger."""
    h, w = in_hw
    new_h, new_w = _resize_plan(in_hw, image_size)
    pass_w = _TapPass(2, w, new_w) if new_w != w else None
    pass_h = _TapPass(1, h, new_h) if new_h != h else None
    top = int(round((new_h - image_size) / 2.0))
    left = int(round((new_w - image_size) / 2.0))
    # 255, mean and std as tensors on the input's device: torch divides a
    # CUDA tensor by a Python number as a product with its reciprocal, one
    # ulp off numpy's quotient, which the mean subtraction then magnifies
    consts = {}

    def constants(device):
        if device not in consts:
            consts[device] = [torch.tensor(c, dtype=torch.float32, device=device)
                              for c in (255.0, mean, std)]
        return consts[device]

    def fn(x: torch.Tensor) -> torch.Tensor:
        if x.dtype != torch.uint8 or tuple(x.shape[1:]) != (h, w, 3):
            raise ValueError(f"expected u8 [B, {h}, {w}, 3], got {x.dtype} {tuple(x.shape)}")
        y = x
        if pass_w is not None:  # horizontal pass first, u8 intermediate (PIL order)
            y = pass_w(y)
        if pass_h is not None:
            y = pass_h(y)
        y = y[:, top:top + image_size, left:left + image_size, :]
        if not normalize:
            return y
        c255, mean_c, std_c = constants(y.device)
        xf = (y.float() / c255 - mean_c) / std_c
        return xf.permute(0, 3, 1, 2).contiguous()

    return fn
