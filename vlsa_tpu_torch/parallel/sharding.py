"""The rank grid of a multi-process run (counterpart of
vlsa_tpu/parallel/sharding.py).

A device of vlsa_tpu's mesh is a rank here: one process driving one device.
`mesh: {data: D, model: M}` is a D x M grid of ranks numbered data-major,
rank = d * M + m, as vlsa_tpu's `make_mesh` reshapes its devices to
(n_data, n_model).  Each rank belongs to two process groups:

  * its data group, the D ranks with its m: bags (patients) split over it,
    and gradients and evaluation outputs are summed or gathered over it;
  * its model group, the M ranks with its d: the patch axis of a bag
    (sequence parallel, parallel/coattn_sp.py and abmil_sp.py) and the text
    tower's MLP hidden dimension (tensor parallel, models/text_encoder.py)
    split over it.

Every batch entry splits by bags over `data`; those named in `PATCH_SPLIT`
also split by patches over `model` under sequence parallelism (vlsa_tpu's
`batch_pspec`).  The text-tower parameters named in `TP_SLICED` split over
`model` (vlsa_tpu's `param_shardings`), and `shard_params` binds the
tensor-parallel handle into those blocks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn


@dataclass
class Mesh:
    """This rank's place in the D x M grid and its two groups (None for a
    group of one rank)."""
    n_data: int
    n_model: int
    rank: int = 0
    data_group: Optional[object] = None
    model_group: Optional[object] = None

    @property
    def size(self) -> int:
        return self.n_data * self.n_model

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model


# the batch entries whose patch axis (dim 1) splits over `model` with
# sequence parallelism; edge lists index the whole patch axis and stay whole
PATCH_SPLIT = ("feats", "feats_scale", "feats_inv", "mask", "cluster_id")
# a text-tower block's parameters each model rank slices: c_fc's rows and
# bias, c_proj's columns
TP_SLICED = ("c_fc_weight", "c_fc_bias", "c_proj_weight")


def _world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def mesh_shape(m: Optional[dict], world: int) -> Tuple[int, int]:
    """(D, M) of a `mesh` setting ({data, model, dcn}) over `world` ranks:
    `data` left out takes what the world holds (world // M, at least 1);
    `dcn` > 1 multiplies a given `data` (vlsa_tpu's flat fallback).  The
    one rule for how many ranks a grid needs."""
    m = m or {}
    n_model = int(m.get("model", 1))
    n_data, dcn = m.get("data"), m.get("dcn")
    if n_data is None:
        return max(world // n_model, 1), n_model
    return int(n_data) * (int(dcn) if dcn and dcn > 1 else 1), n_model


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              dcn_data: Optional[int] = None) -> Mesh:
    """The data x model grid of the world's ranks, and this rank's groups.

    `dcn_data` > 1 lays the outer data factor across hosts in vlsa_tpu.
    Ranks are numbered host by host, so the data-major grid already keeps
    each model group on fewer hosts than the data groups span; on one host
    it is the flat grid with data = dcn_data x n_data, as vlsa_tpu's
    fallback.  The world must hold exactly D x M ranks."""
    world, rank = _world()
    if dcn_data and dcn_data > 1:
        print(f"[mesh] hybrid DCN mesh unavailable (ranks are numbered host by host); "
              f"using a flat mesh with data={dcn_data}x{n_data or 'auto'}")
    n_data, n_model = mesh_shape({"data": n_data, "model": n_model, "dcn": dcn_data}, world)
    if n_data * n_model != world:
        raise ValueError(
            f"mesh data={n_data} x model={n_model} needs {n_data * n_model} ranks but the "
            f"world has {world}: one process drives one device; `python -m "
            f"vlsa_tpu_torch.main` starts the ranks of a `mesh` with no `distributed` itself, "
            f"and a `distributed` run needs num_processes = {n_data * n_model}")
    mesh = Mesh(n_data, n_model, rank)
    if world == 1:
        return mesh
    # every rank creates every group, in one order
    if n_model > 1:
        for d in range(n_data):
            g = dist.new_group([d * n_model + m for m in range(n_model)])
            if d == mesh.data_index:
                mesh.model_group = g
    if n_data > 1:
        for m in range(n_model):
            g = dist.new_group([d * n_model + m for d in range(n_data)])
            if m == mesh.model_index:
                mesh.data_group = g
    return mesh


def patch_slice(batch: dict, mesh: Mesh) -> dict:
    """The rank's contiguous chunk (the m-th of M) of the entries
    `PATCH_SPLIT` names; the other entries as they are."""
    M, m = mesh.n_model, mesh.model_index
    out = dict(batch)
    for k in PATCH_SPLIT:
        if k not in batch:
            continue
        N = batch[k].shape[1]
        if N % M:
            raise ValueError(f"a bucket of {N} patches does not split over model={M}: "
                             f"set `fixed_bucket` to a multiple of {M}")
        n = N // M
        out[k] = batch[k][:, m * n:(m + 1) * n]
    return out


def _blocks(model: nn.Module):
    from ..models.text_encoder import ResidualAttentionBlock
    return [(name, mod) for name, mod in model.named_modules()
            if isinstance(mod, ResidualAttentionBlock)]


def shard_params(model: nn.Module, mesh: Mesh, tensor_parallel: bool = True) -> Tuple[str, ...]:
    """Bind the model group into every text-tower block (tensor parallel:
    each rank computes its slice of the MLP's hidden units); returns the
    names of the sliced parameters, whose gradients the model group sums.
    The parameters stay whole on every rank."""
    if not tensor_parallel or mesh.n_model == 1:
        return ()
    from ..models.text_encoder import TensorParallel
    for prefix, blk in _blocks(model):
        hidden = blk.c_fc_weight.shape[0]
        if hidden % mesh.n_model:
            raise ValueError(f"{prefix}: an MLP of {hidden} hidden units does not split over "
                             f"model={mesh.n_model}")
        blk.tp = TensorParallel(mesh.model_group, mesh.model_index, mesh.n_model)
    return tuple(f"{prefix}.{name}" if prefix else name for prefix, _blk in _blocks(model)
                 for name in TP_SLICED)


def seed_dropout(model: nn.Module, mesh: Mesh) -> None:
    """Reseed every `SeededDropout` by (its seed, the rank's data index):
    the ranks of one model group draw the same masks, the data ranks
    others (data index 0 keeps the single-process seed)."""
    from ..models.layers import SeededDropout
    for mod in model.modules():
        if isinstance(mod, SeededDropout) and mesh.data_index:
            mod.seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=torch.Generator()
                                         .manual_seed(mod.seed * 1_000_003 + mesh.data_index)))
            mod._generators.clear()
