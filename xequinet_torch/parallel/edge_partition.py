"""Edge partition: one graph's edges split over several processes, its
nodes replicated.

Port of ``xequinet_tpu/parallel/edge_partition.py``.  The JAX package
jits the ordinary forward with the edge arrays sharded over the ``gp``
mesh axis and lets XLA insert the all-reduces; the port runs one process
per share in a ``torch.distributed`` group, each holding every node and a
contiguous share of the edges (:func:`shard_batch`), and all-reduces
every edge-to-node sum (``ops/scatter.edge_parallel``).

Forces and the virial come by autograd through those all-reduces.  Every
rank seeds the replicated energy's cotangent, so the sum of the ranks'
position (and strain) gradients is R times the true one: the forward
all-reduces them and divides by R.

It runs the plain message route, as the JAX tests do: the kernel routes'
slot layout is a per-block order of the whole edge list, not of a share,
so a model on the mega or v2 route is refused; for a system too large for
one card use the halo decomposition (``parallel/halo.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .. import keys
from ..models.properties import make_forward
from ..ops.scatter import all_reduce_sum, edge_parallel, group_size_rank

DataDict = Dict[str, torch.Tensor]

EDGE_KEYS = {keys.EDGE_INDEX, keys.EDGE_MASK, keys.CELL_OFFSETS}


def pad_edges_for_shards(batch: Dict[str, np.ndarray], n_shards: int
                         ) -> Dict[str, np.ndarray]:
    """The edge axis padded to a multiple of ``n_shards`` (JAX
    ``pad_edges_for_shards``); the contiguous split keeps each share's
    centers sorted."""
    e = batch[keys.EDGE_MASK].shape[0]
    target = ((e + n_shards - 1) // n_shards) * n_shards
    if target == e:
        return batch
    out = dict(batch)
    n_nodes = batch[keys.POSITIONS].shape[0]
    ei = np.full((2, target), n_nodes - 1, dtype=batch[keys.EDGE_INDEX].dtype)
    ei[:, :e] = batch[keys.EDGE_INDEX]
    out[keys.EDGE_INDEX] = ei
    em = np.zeros(target, dtype=bool)
    em[:e] = batch[keys.EDGE_MASK]
    out[keys.EDGE_MASK] = em
    if keys.CELL_OFFSETS in batch:
        co = np.zeros((target, 3), dtype=batch[keys.CELL_OFFSETS].dtype)
        co[:e] = batch[keys.CELL_OFFSETS]
        out[keys.CELL_OFFSETS] = co
    return out


def shard_batch(batch: Dict[str, np.ndarray], n_shards: int, rank: int
                ) -> Dict[str, np.ndarray]:
    """Rank ``rank``'s share of a padded host batch: every node and graph
    array whole, a contiguous ``1 / n_shards`` of the edge arrays (the
    JAX ``shard_batch``'s placement, one process's part of it)."""
    batch = pad_edges_for_shards(batch, n_shards)
    per = batch[keys.EDGE_MASK].shape[0] // n_shards
    sl = slice(rank * per, (rank + 1) * per)
    out = {}
    for k, v in batch.items():
        if k == keys.EDGE_INDEX:
            out[k] = v[:, sl]
        elif k in EDGE_KEYS:
            out[k] = v[sl]
        else:
            out[k] = v
    return out


def make_edge_parallel_forward(
    apply_fn: Callable[[DataDict], DataDict],
    group=None,
    extra_properties: Optional[List[str]] = None,
):
    """``forward(data, compute_forces=True, compute_virial=False)`` of this
    rank's share ``data`` (:func:`shard_batch`, on the device), every rank
    of ``group`` calling it in lockstep: the outputs are replicated, the
    forces and virial the exact ones of the whole graph."""
    for m in getattr(apply_fn, "modules", lambda: [])():
        if getattr(m, "use_mega", False) or getattr(m, "use_v2", False):
            raise ValueError(
                "edge partition runs the plain message route: the kernels' slot layout "
                "orders the whole edge list by destination block, not a share of it; for "
                "a system too large for one card use the halo decomposition "
                "(parallel/halo.py, HaloCalculator / run_halo_train)")
    base_forward = make_forward(apply_fn, extra_properties)
    size, _ = group_size_rank(group)

    def forward(data: DataDict, compute_forces: bool = True,
                compute_virial: bool = False) -> DataDict:
        with edge_parallel(group):
            out = base_forward(data, compute_forces, compute_virial)
        for k in (keys.FORCES, keys.VIRIAL):
            if k in out:
                out[k] = all_reduce_sum(out[k], group) / size
        return out

    return forward
