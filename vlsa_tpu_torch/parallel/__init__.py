"""Multi-process runs (counterpart of vlsa_tpu/parallel): a D x M grid of
ranks, one process a device, with data, sequence and tensor parallelism
(sharding.py), bring-up and per-rank batches (multihost.py), the
collectives and their backend (collectives.py), and the sequence-parallel
pools on the co-attention and ABMIL kernels (coattn_sp.py, abmil_sp.py)."""
from .abmil_sp import abmil_pool_sp  # noqa: F401
from .coattn_sp import coattn_pool_sp  # noqa: F401
from .multihost import (  # noqa: F401
    collect_global,
    host_allgather,
    make_global_batch,
    maybe_initialize_distributed,
    process_shard_info,
)
from .sharding import PATCH_SPLIT, TP_SLICED, Mesh, make_mesh, shard_params  # noqa: F401
