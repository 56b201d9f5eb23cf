"""Datapoint transforms: the neighbour build, unit conversion and their
pipeline.

Port of ``xequinet_tpu/data/transforms.py:24-86, 159-193``.  Transforms act
on host-side numpy Datapoints before collation.  ``DeltaTransform``
(delta learning on xTB baselines) and ``SVDFrameTransform`` (the non-PBC
Ewald frame) come with the slices that port those models (ROADMAP item
9) and raise until then.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np

from .. import keys
from ..ops.radius_graph import radius_graph_np, radius_graph_pbc_np
from ..utils.qc import get_default_units, unit_conversion
from .datapoint import Datapoint

Transform = Callable[[Datapoint], Datapoint]


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


# label fields (name -> unit kind) for unit conversion
_PROPERTY_FIELDS = {
    "energy": keys.TOTAL_ENERGY,
    "base_energy": keys.TOTAL_ENERGY,
    "forces": keys.FORCES,
    "base_forces": keys.FORCES,
    "virial": keys.VIRIAL,
    "atomic_charges": keys.ATOMIC_CHARGES,
    "base_charges": keys.ATOMIC_CHARGES,
    "dipole": keys.DIPOLE,
    "base_dipole": keys.DIPOLE,
    "polar": keys.POLARIZABILITY,
}


class UnitTransform:
    """Convert dataset units to the model's default units."""

    def __init__(self, data_units: Dict[str, str]) -> None:
        default = get_default_units()
        self.factors: Dict[str, float] = {}
        for prop, unit in (data_units or {}).items():
            if prop in default:
                self.factors[prop] = unit_conversion(unit, default[prop])

    def __call__(self, data: Datapoint) -> Datapoint:
        pos_f = self.factors.get(keys.POSITIONS, 1.0)
        if pos_f != 1.0:
            data.pos = data.pos * pos_f
            if data.cell is not None:
                data.cell = data.cell * pos_f
        for name, prop in _PROPERTY_FIELDS.items():
            f = self.factors.get(prop, 1.0)
            val = getattr(data, name)
            if f != 1.0 and val is not None:
                setattr(data, name, val * f)
        return data


class DeltaTransform:
    def __init__(self, *args, **kwargs) -> None:
        raise NotImplementedError(
            "delta learning (base_targets) is not ported yet: it comes with "
            "the xTB delta slice (ROADMAP item 9)"
        )


class SVDFrameTransform:
    def __init__(self, *args, **kwargs) -> None:
        raise NotImplementedError(
            "the SVD frame transform is not ported yet: it comes with the "
            "non-PBC Ewald model (ROADMAP item 9)"
        )


class SequentialTransform:
    """Compose transforms left to right."""

    def __init__(self, transforms: Iterable[Transform]) -> None:
        self.transforms = list(transforms)

    def __call__(self, data: Datapoint) -> Datapoint:
        return functools.reduce(lambda d, t: t(d), self.transforms, data)


def build_transform_pipeline(
    data_units: Optional[Dict[str, str]] = None,
    base_targets: Optional[Sequence[str]] = None,
    svd_frame: bool = False,
    vector_targets: Sequence[str] = (),
    atomic_vector_targets: Sequence[str] = (),
    cutoff: Optional[float] = None,
) -> SequentialTransform:
    """units -> delta -> SVD frame -> neighbours, the JAX package's order."""
    steps: List[Transform] = []
    if data_units:
        steps.append(UnitTransform(data_units))
    if base_targets:
        steps.append(DeltaTransform(base_targets))
    if svd_frame:
        steps.append(SVDFrameTransform(vector_targets=vector_targets,
                                       atomic_vector_targets=atomic_vector_targets))
    if cutoff is not None:
        steps.append(NeighborTransform(cutoff))
    return SequentialTransform(steps)
