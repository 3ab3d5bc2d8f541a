"""Model registry (counterpart of the DeepMIL half of
vlsa_tpu/models/registry.py): `load_model("DeepMIL", dims, network=...)`,
for the ABMIL family and DSMIL (models/mil.py) and the rest of the zoo
(models/mil_ext.py: TransMIL, ILRA, DeepAttnMISL on cluster bags,
PatchGCN on graph bags).

The weights are torch's default initialisation drawn from a seeded
`torch.Generator` on the CPU, so one seed gives the same model on every
device; `state_dict` (for example one bridged from a vlsa_tpu tree by
utils.weights) replaces them and must match exactly.  VLSA is built by
`vlsa_build.build_vlsa_from_config`.
"""
from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from ..utils.device import disable_tf32, resolve_device
from .mil import DSMIL, DeepMIL, MaxMIL, MeanMIL
from .mil_ext import ILRA, BatchedPatchGCN, DeepAttnMISL, TransMIL

# the DeepMIL options the registry passes on (vlsa_tpu/models/registry.py:39-41)
_OPTIONS = ("use_feat_proj", "drop_rate", "pred_head", "dim_reduction", "keep_ratio")


def load_model(arch: str, dims: List[int], seed: int = 0, device=None,
               state_dict: Optional[dict] = None, **kws) -> nn.Module:
    """The DeepMIL network `kws["network"]` (ABMIL with attention or gated
    attention pooling, MaxMIL, MeanMIL, DSMIL, TransMIL, ILRA with
    `num_layers`, `num_heads`, `topk` and `ln`, DeepAttnMISL with
    `num_clusters` and `dropout`, PatchGCN with `num_layers` and `dropout`,
    vlsa_tpu's keys and defaults) with dims [dim_in, dim_hid, num_cls], on
    `device` (CUDA unless "cpu" is asked for); `seed` also seeds its
    Dropout."""
    if arch != "DeepMIL":
        raise NotImplementedError(f"arch {arch!r}: the registry builds DeepMIL; VLSA is "
                                  f"built by models.vlsa_build")
    if "network" not in kws:
        raise ValueError("Please specify a network for a DeepMIL arch.")
    network = kws["network"]
    options = {k: v for k, v in kws.items() if k in _OPTIONS}
    common = dict(dim_in=dims[0], dim_hid=dims[1], num_cls=dims[2], dropout_seed=seed)
    device = resolve_device(device)
    disable_tf32()
    generator = torch.Generator().manual_seed(seed)
    if network == "ABMIL":
        pooling = kws.get("pooling", "attention")
        if pooling not in ("attention", "gated_attention"):
            raise ValueError(f"ABMIL pooling must be attention or gated_attention, got {pooling!r}")
        model = DeepMIL(pooling=pooling, generator=generator, **common, **options)
    elif network == "MaxMIL":
        model = MaxMIL(generator=generator, **common, **options)
    elif network == "MeanMIL":
        model = MeanMIL(generator=generator, **common, **options)
    elif network == "DSMIL":
        model = DSMIL(generator=generator, **common,
                      **{k: v for k, v in options.items() if k in ("use_feat_proj", "drop_rate")})
    elif network == "TransMIL":
        model = TransMIL(generator=generator, **common)
    elif network == "ILRA":
        model = ILRA(generator=generator, num_layers=kws.get("num_layers", 2),
                     num_heads=kws.get("num_heads", 8), topk=kws.get("topk", 1),
                     ln=kws.get("ln", False), **common)
    elif network == "DeepAttnMISL":
        model = DeepAttnMISL(generator=generator, num_clusters=kws.get("num_clusters", 8),
                             dropout=kws.get("dropout", 0.25), **common)
    elif network == "PatchGCN":
        model = BatchedPatchGCN(generator=generator, num_layers=kws.get("num_layers", 3),
                                dropout=kws.get("dropout", 0.25), **common)
    else:
        raise NotImplementedError(f"unknown DeepMIL network {network}")
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    return model.to(device)
