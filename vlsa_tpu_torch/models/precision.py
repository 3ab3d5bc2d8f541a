"""Parameter precision (counterpart of vlsa_tpu/models/precision.py)."""
from __future__ import annotations

from typing import Dict, Mapping, Tuple, Union

import torch

from .text_encoder import TextTower
from .vision_tower import CLIPViT, ConchVisualModel


def cast_frozen_tower_weights(tower: TextTower, dtype=torch.bfloat16) -> TextTower:
    """Store a frozen tower's 2-D resblock matmul weights in `dtype`, in
    place.  The tower rounds these operands to its compute dtype at every
    matmul anyway, so storing them rounded once gives identical results with
    half the weight bytes.  Embeddings, LayerNorm parameters and biases keep
    f32."""
    for blk in tower.resblocks:
        _cast_2d(blk, dtype)
    return tower


def _cast_2d(block: torch.nn.Module, dtype) -> None:
    for p in block.parameters():
        if p.dim() == 2 and p.dtype == torch.float32:
            p.data = p.data.to(dtype)


def cast_vision_tower_weights(model: Union[ConchVisualModel, CLIPViT],
                              dtype=torch.bfloat16) -> Union[ConchVisualModel, CLIPViT]:
    """Store a frozen vision tower's matmul weights in `dtype`, in place:
    exactly the tensors it rounds to its compute type at every product, so
    the result is bit-identical.

      * ConchVisualModel: the trunk's patch embedding and each block's 2-D
        f32 weights (qkv/proj/fc1/fc2; a w8a8 block's int8 buffers and f32
        scales are left alone).  The poolers compute in f32 and keep f32.
      * CLIPViT: each resblock's 2-D f32 weights (the text tower's rule);
        the stem convolution runs in f32 and keeps f32.

    LayerNorm parameters, embeddings and biases stay f32."""
    if isinstance(model, CLIPViT):
        blocks = model.resblocks
    else:
        trunk = model.trunk
        trunk.patch_embed_weight.data = trunk.patch_embed_weight.data.to(dtype)
        blocks = trunk.blocks()
    for blk in blocks:
        _cast_2d(blk, dtype)
    return model


# ---------------------------------------------------------------------------
# int8 weights of the frozen extraction trunk (the w8a8 option)
# ---------------------------------------------------------------------------

_TRUNK_LINEARS = ("qkv_weight", "proj_weight", "fc1_weight", "fc2_weight")


def quantize_rows(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization of a [out, in] weight: (q int8,
    scale f32 [out]) with w ~= q * scale, scale = max(max|row|, 1e-30) / 127
    (127, not 128: a symmetric grid), ties rounded to even.  Bit-equal to
    vlsa_tpu's `quantize_rows` on the same f32 input."""
    w = w.float()
    amax = w.abs().amax(dim=1)
    s = amax.clamp_min(1e-30) / amax.new_full((), 127.0)  # a true quotient on CUDA too
    return torch.round(w / s[:, None]).to(torch.int8), s


def quantize_vision_tower_weights(state_dict: Mapping[str, torch.Tensor]
                                  ) -> Dict[str, torch.Tensor]:
    """A float `ConchVisualModel` state dict -> the w8a8 trunk's: each
    `trunk.block_<i>.<linear>_weight` (qkv/proj/fc1/fc2, ~85% of the trunk's
    operations) becomes int8, with `<linear>_weight_scale` f32 beside it --
    what `ConchVisualModel(trunk_quantized=True)` loads.  Everything else is
    kept.  Quantize the f32 weights, before any bf16 cast, so the int8 grid is
    fit to the unrounded values."""
    if not any(k.startswith("trunk.") for k in state_dict):
        raise ValueError("quantize_vision_tower_weights expects a ConchVisualModel state dict "
                         "(no 'trunk.' entries)")
    out = {}
    for k, v in state_dict.items():
        parts = k.split(".")
        if len(parts) == 3 and parts[0] == "trunk" and parts[1].startswith("block_") \
                and parts[2] in _TRUNK_LINEARS:
            out[k], out[k + "_scale"] = quantize_rows(v)
        else:
            out[k] = v
    return out
