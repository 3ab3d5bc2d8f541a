"""Parameter precision (counterpart of vlsa_tpu/models/precision.py)."""
from __future__ import annotations

import torch

from .text_encoder import TextTower


def cast_frozen_tower_weights(tower: TextTower, dtype=torch.bfloat16) -> TextTower:
    """Store a frozen tower's 2-D resblock matmul weights in `dtype`, in
    place.  The tower rounds these operands to its compute dtype at every
    matmul anyway, so storing them rounded once gives identical results with
    half the weight bytes.  Embeddings, LayerNorm parameters and biases keep
    f32."""
    for blk in tower.resblocks:
        for p in blk.parameters():
            if p.dim() == 2 and p.dtype == torch.float32:
                p.data = p.data.to(dtype)
    return tower
