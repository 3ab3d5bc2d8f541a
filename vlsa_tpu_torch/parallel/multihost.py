"""Bring-up and per-rank batches of a multi-process run (counterpart of
vlsa_tpu/parallel/multihost.py).

`maybe_initialize_distributed` joins the process group from the config's
`distributed` key before any device is touched:

  * 'auto': the launcher's environment (RANK, WORLD_SIZE, LOCAL_RANK,
    LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT, as torchrun sets them; the
    last two local ones are required where MASTER_ADDR is not this host);
  * {coordinator_address, num_processes, process_id[, local_device_ids]}:
    over a TCP store at <coordinator_address>, through which every rank
    posts its host, its device type and the card it asks for; the process
    drives the first of `local_device_ids` (vlsa_tpu's "2 processes x 2
    local devices" is 4 processes here, one a device).

`init_local_rank` joins a group of ranks this host started itself
(`python -m vlsa_tpu_torch.main` with a `mesh` and no `distributed`),
through a file (`local_rendezvous`: no port to race another process for).  The
world must hold D x M ranks (sharding.py::mesh_shape).  The backend
follows from the layout (`rank_layout`), read before the group is made,
never guessed and never chosen by catching a failure: NCCL where every rank
drives a card no other rank on its host drives, gloo otherwise.  A rank's
device is cuda:(local_device_ids[0] or local_rank % device_count), or the
CPU when the caller asks for it (`rank_device`).

Each data rank loads only its contiguous slice of every global batch
(`BagBatcher(num_shards=D, shard_index=d)`; `process_shard_info`);
`make_global_batch` puts it on the rank's device with its model rank's
chunk of the patch axis under sequence parallelism; `collect_global` and
`host_allgather` gather evaluation outputs over the data group, so every
rank holds the whole pass.
"""
from __future__ import annotations

import json
import os
import random
import socket
from datetime import timedelta
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .collectives import all_gather
from .sharding import Mesh, mesh_shape, patch_slice

_LOOPBACK = ("localhost", "127.0.0.1", "::1", "0.0.0.0")
# this process's card (rank_layout)
_LOCAL = {"device_index": 0}
TIMEOUT = timedelta(minutes=30)


def rank_layout(places) -> Tuple[str, list, list]:
    """The backend, and each rank's local rank and card, from every rank's
    place in global rank order: (host, device type, cards on its host, the
    card it asks for or None).  A rank's local rank is its index among the
    ranks of its host; its card the one it asks for, else local rank %
    cards.  NCCL where every rank is on CUDA and no two ranks of a host
    drive one card, gloo otherwise.  Every rank computes this from the same
    places, so all of them choose the same backend."""
    seen, local, cards = {}, [], []
    for host, _dev, n, asked in places:
        local.append(seen.get(host, 0))
        seen[host] = local[-1] + 1
        cards.append(asked if asked is not None else local[-1] % max(n, 1))
    own = len({(p[0], c) for p, c in zip(places, cards)}) == len(places)
    cuda = all(dev == "cuda" and c < n for (_h, dev, n, _a), c in zip(places, cards))
    return ("nccl" if own and cuda else "gloo"), local, cards


def _place(device, asked: Optional[int] = None, host: Optional[str] = None) -> tuple:
    dev = torch.device("cuda" if device is None else device).type
    return (host or socket.gethostname(), dev,
            torch.cuda.device_count() if dev == "cuda" else 0, asked)


def _init(places, rank: int, **init) -> None:
    backend, _local, cards = rank_layout(places)
    _LOCAL.update(device_index=cards[rank])
    if backend == "nccl":
        torch.cuda.set_device(cards[rank])
    dist.init_process_group(backend, world_size=len(places), rank=rank, timeout=TIMEOUT, **init)


def _check_world(cfg: dict, world: int) -> None:
    n_data, n_model = mesh_shape(cfg.get("mesh"), world)
    if n_data * n_model != world:
        m = cfg["mesh"]
        raise ValueError(f"mesh data={m.get('data')} x model={m.get('model', 1)} needs "
                         f"{n_data * n_model} ranks but `distributed` starts {world} processes")


def maybe_initialize_distributed(cfg: dict, device=None) -> bool:
    """Join the process group of the config's `distributed` (no-op without
    one, or when this process has joined already); True when the process is
    in a group.  The world size must equal the `mesh`'s D x M (ValueError
    naming both, before any rank waits for another)."""
    spec = cfg.get("distributed")
    if dist.is_initialized():
        return True
    if not spec:
        return False
    if spec == "auto":
        env = os.environ
        world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
        if env.get("MASTER_ADDR", "localhost") not in _LOOPBACK \
                and not ("LOCAL_RANK" in env and "LOCAL_WORLD_SIZE" in env):
            raise ValueError("distributed: auto across hosts needs LOCAL_RANK and "
                             "LOCAL_WORLD_SIZE (torchrun sets them): without them this "
                             "process cannot tell which card is its own")
        _check_world(cfg, world)
        # a launcher numbers the ranks host by host, LOCAL_WORLD_SIZE to a host
        on_host = int(env.get("LOCAL_WORLD_SIZE", world))
        places = [_place(device, host=str(r // on_host)) for r in range(world)]
        _init(places, rank, init_method="env://")
    elif isinstance(spec, dict):
        world, rank = int(spec["num_processes"]), int(spec["process_id"])
        _check_world(cfg, world)
        ids = spec.get("local_device_ids")
        ids = [ids] if isinstance(ids, int) else ids
        host, port = str(spec["coordinator_address"]).rsplit(":", 1)
        store = dist.TCPStore(host, int(port), world, is_master=rank == 0, timeout=TIMEOUT)
        # every rank posts its place and reads every other's: the layout, not a guess
        store.set(f"place/{rank}", json.dumps(_place(device, ids[0] if ids else None)))
        places = [tuple(json.loads(store.get(f"place/{r}"))) for r in range(world)]
        _init(places, rank, store=dist.PrefixStore("group", store))
    else:
        raise ValueError(f"distributed must be 'auto' or a dict of coordinator_address, "
                         f"num_processes and process_id, got {spec!r}")
    print(f"[setup] torch.distributed: process {rank} / {world} "
          f"({dist.get_backend()}), device {rank_device(device)}")
    return True


def init_local_rank(rank: int, world: int, rendezvous: str, device=None) -> None:
    """Join the group of `world` ranks this host started, through
    `rendezvous` (`local_rendezvous`)."""
    _init([_place(device)] * world, rank, init_method=rendezvous)


def coordinator_port() -> Tuple[int, socket.socket]:
    """(port, socket): a free port on this host below Linux's ephemeral range
    (32768 up by default), for a `distributed` dict's coordinator_address, no
    other process being handed it by a bind to port 0 or a connect while the
    ranks start, and a socket bound to it (SO_REUSEADDR, not listening) that
    the caller closes once the ranks have ended: until then no other caller
    of this function takes the port, while rank 0's store (which sets
    SO_REUSEADDR too) can still bind it.  Drawn from the OS's randomness,
    not `random`'s global generator, which `seed_everything` seeds: every
    process seeded alike would draw the same port."""
    for port in random.SystemRandom().sample(range(20000, 32000), 200):
        with socket.socket() as s:  # without SO_REUSEADDR: fails where any socket holds it
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        s = socket.socket()
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            s.bind(("127.0.0.1", port))
        except OSError:
            s.close()
            continue
        return port, s
    raise RuntimeError("no free port below the ephemeral range")


def local_rendezvous(directory: str) -> str:
    """A file rendezvous in `directory` for ranks of one host: no port to
    pick, so none to race another process for."""
    return "file://" + os.path.join(os.path.abspath(directory), "rendezvous")


def rank_device(device=None) -> torch.device:
    """This rank's device: the CPU when asked for, else its card."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or not dist.is_initialized():
        return device
    return torch.device("cuda", _LOCAL["device_index"])


def process_shard_info(mesh: Optional[Mesh]) -> Tuple[int, int]:
    """(shard_index, num_shards) of the rank's data loading: its data index
    and D."""
    if mesh is None:
        return 0, 1
    return mesh.data_index, mesh.n_data


def collect_global(x: torch.Tensor, mesh: Optional[Mesh]) -> np.ndarray:
    """A rank's rows of an output gathered over its data group, in data
    order, as a host float array (the model group holds them already)."""
    group = None if mesh is None else mesh.data_group
    return all_gather(x.detach(), group).float().cpu().numpy()


def host_allgather(x, mesh: Optional[Mesh]) -> np.ndarray:
    """The rows of a host array of every data rank, in data order."""
    x = np.asarray(x)
    group = None if mesh is None else mesh.data_group
    if x.dtype == np.bool_:  # gathered as bytes
        return all_gather(torch.from_numpy(x.astype(np.uint8)), group).numpy().astype(bool)
    return all_gather(torch.from_numpy(np.ascontiguousarray(x)), group).numpy()


def make_global_batch(local_batch: dict, mesh: Optional[Mesh], device,
                      seq_parallel: bool = False) -> dict:
    """The rank's slice of a batch on `device`: its bags (the batcher
    loaded only those) and, with `seq_parallel`, its model rank's chunk of
    the patch axis (parallel/sharding.py::PATCH_SPLIT)."""
    if mesh is not None and seq_parallel and mesh.n_model > 1:
        local_batch = patch_slice(local_batch, mesh)
    return {k: v.to(device, non_blocking=True).contiguous() for k, v in local_batch.items()}
