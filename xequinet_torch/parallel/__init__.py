"""Multi-process runs: the process group, data parallelism, and one large
system split over processes (halo decomposition and edge partition).
The names are the JAX package's ``parallel/__init__.py``."""

from .data_parallel import (
    device_put_sharded_batch,
    make_dp_eval_step,
    make_dp_train_step,
    replicate,
    stack_device_batches,
)
from .edge_partition import make_edge_parallel_forward, shard_batch
from .halo import (HaloCalculator, halo_partition, make_halo_dp_train_step, make_halo_forward,
                   make_halo_train_step, stack_halo_systems)
from .mesh import DP_AXIS, GP_AXIS, make_mesh

__all__ = [
    "make_mesh", "DP_AXIS", "GP_AXIS",
    "make_dp_train_step", "make_dp_eval_step", "replicate",
    "stack_device_batches", "device_put_sharded_batch",
    "make_edge_parallel_forward", "shard_batch",
    "halo_partition", "make_halo_forward", "make_halo_train_step",
    "make_halo_dp_train_step", "stack_halo_systems",
    "HaloCalculator",
]
