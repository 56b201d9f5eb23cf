"""Datapoint transforms: the neighbour build.

Port of ``xequinet_tpu/data/transforms.py:24-47``.  Transforms act on
host-side numpy Datapoints before collation.
"""

from __future__ import annotations

import numpy as np

from .. import keys
from ..ops.radius_graph import radius_graph_np, radius_graph_pbc_np
from .datapoint import Datapoint


class NeighborTransform:
    """Build edge_index (+ cell_offsets under PBC) for a datapoint."""

    def __init__(self, cutoff: float) -> None:
        self.cutoff = cutoff

    def __call__(self, data: Datapoint) -> Datapoint:
        if data.edge_index is not None and any(
            k in keys.EDGE_LEVEL_PROPERTIES for k in data.extras
        ):
            # edge-level labels are bound to the stored edge set
            return data
        if data.num_atoms == 1 and not data.has_cell:
            raise ValueError("Isolated atom without PBC has no neighbors")
        if data.has_cell:
            ei, offs = radius_graph_pbc_np(data.pos, data.cell, data.pbc, self.cutoff)
        else:
            ei, offs = radius_graph_np(data.pos, self.cutoff)
        data.edge_index = ei.astype(np.int64)
        data.cell_offsets = offs.astype(np.int64) if data.has_cell else None
        return data
