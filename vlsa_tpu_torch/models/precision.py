"""Parameter precision (counterpart of vlsa_tpu/models/precision.py)."""
from __future__ import annotations

import torch

from .text_encoder import TextTower
from .vision_tower import ConchVisualModel


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


def cast_vision_tower_weights(model: ConchVisualModel, dtype=torch.bfloat16) -> ConchVisualModel:
    """Store a frozen CONCH visual model's trunk matmul weights in `dtype`,
    in place: the patch embedding and each block's 2-D `*_weight`
    (qkv/proj/fc1/fc2), exactly the tensors the trunk rounds to its compute
    type at every product, so the result is bit-identical.  The poolers
    compute in f32 and keep f32; LayerNorm parameters, embeddings and biases
    stay f32."""
    trunk = model.trunk
    trunk.patch_embed_weight.data = trunk.patch_embed_weight.data.to(dtype)
    for blk in trunk.blocks():
        for name, p in blk.named_parameters():
            if name.endswith("_weight") and p.dim() == 2 and p.dtype == torch.float32:
                p.data = p.data.to(dtype)
    return model
