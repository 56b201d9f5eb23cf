"""The process group.

Port of ``xequinet_tpu/parallel/mesh.py:27`` (``maybe_init_distributed``).
The JAX package spans devices with a mesh inside one SPMD program; the
port runs one process per card, as torchrun launches it, with the
gradients all-reduced between the processes (``parallel/data_parallel``).
Halo decomposition (the JAX mesh's ``gp`` axis) is a later slice.
"""

from __future__ import annotations

import os

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
