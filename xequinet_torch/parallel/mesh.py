"""The process group and its dp and gp groups.

Port of ``xequinet_tpu/parallel/mesh.py``.  The JAX package spans devices
with a mesh inside one SPMD program, with named axes ``dp`` (data
parallel) and ``gp`` (one system split over shards, ``parallel/halo``);
the port runs one process per card, as torchrun launches it, and a mesh
axis becomes a process group (:func:`make_groups`).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist


def maybe_init_distributed(device) -> bool:
    """Join the process group that torchrun's environment describes
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``): NCCL with
    one card per rank (``LOCAL_RANK``) for a CUDA ``device``, gloo on the
    CPU.  A group that already exists (the caller's own) is left as it is,
    and without that environment nothing is started.  Returns True when
    the group has more than one process."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if not all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")):
        return False
    device = torch.device(device)
    backend = "gloo"
    if device.type == "cuda":
        backend = "nccl"
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend, init_method="env://", rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return dist.get_world_size() > 1


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


DP_AXIS = "dp"
GP_AXIS = "gp"


def make_groups(dp: int, gp: int) -> Tuple[Optional[object], Optional[object]]:
    """(gp group, dp group) of this process for a ``dp x gp`` layout of the
    world, rank = d * gp + g (the JAX ``make_mesh(dp * gp, ("dp", "gp"),
    shape=(dp, gp))``, run/train.py:148-151): the gp group holds the
    ``gp`` shards of one system, the dp group the ``dp`` replicas of one
    shard.  Every rank creates every group, in the same order, as
    ``new_group`` requires.  Without a process group: (None, None); a
    group of the whole world is ``dist.group.WORLD``; dp 1 gives no dp
    group."""
    if not dist.is_initialized():
        if dp * gp != 1:
            raise ValueError(f"dp {dp} x gp {gp} needs a process group of {dp * gp}")
        return None, None
    world = dist.get_world_size()
    if dp * gp != world:
        raise ValueError(f"dp {dp} x gp {gp} != the process group's {world} processes")
    if dp == 1:
        return dist.group.WORLD, None
    gp_groups = [dist.new_group(list(range(d * gp, (d + 1) * gp))) for d in range(dp)]
    dp_groups = [dist.new_group(list(range(g, world, gp))) for g in range(gp)]
    r = dist.get_rank()
    return gp_groups[r // gp], dp_groups[r % gp]


def make_mesh(n_devices: Optional[int] = None, axis_names=(DP_AXIS,), shape=None) -> dict:
    """{axis name: this process's group along it}: the JAX ``make_mesh``
    over the process group, one process per device, for the axes
    ``("dp",)``, ``("gp",)`` or ``("dp", "gp")`` (``shape`` (dp, gp))."""
    n = n_devices or world_size()
    if n != world_size():
        raise ValueError(f"make_mesh: {n} devices requested, {world_size()} processes")
    names = tuple(axis_names)
    if len(names) == 1:
        return {names[0]: dist.group.WORLD if dist.is_initialized() else None}
    if names != (DP_AXIS, GP_AXIS):
        raise ValueError(f"make_mesh: axes {names}; use ('dp',), ('gp',) or ('dp', 'gp')")
    dp, gp = shape if shape is not None else (n, 1)
    gp_group, dp_group = make_groups(int(dp), int(gp))
    return {DP_AXIS: dp_group, GP_AXIS: gp_group}
