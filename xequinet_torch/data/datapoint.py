"""Typed, shape-checked datapoint container (host-side, numpy).

Copy of ``xequinet_tpu/data/datapoint.py``.  The padded static-shape
collation lives in data/batching.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np


@dataclass
class Datapoint:
    """One molecular / periodic structure with optional labels.

    Shapes:
      atomic_numbers [N] int; pos [N,3]; pbc [3] bool; cell [3,3];
      edge_index [2,E]; cell_offsets [E,3]; charge/spin scalars int;
      energy scalar; forces [N,3]; virial [3,3]; atomic_charges [N];
      dipole [3]; polar [3,3]; extras: anything else.
    """

    atomic_numbers: np.ndarray
    pos: np.ndarray
    pbc: Optional[np.ndarray] = None
    cell: Optional[np.ndarray] = None
    edge_index: Optional[np.ndarray] = None
    cell_offsets: Optional[np.ndarray] = None
    charge: Optional[int] = None
    spin: Optional[int] = None  # = multiplicity - 1 = 2S
    energy: Optional[float] = None
    forces: Optional[np.ndarray] = None
    base_energy: Optional[float] = None
    base_forces: Optional[np.ndarray] = None
    virial: Optional[np.ndarray] = None
    atomic_charges: Optional[np.ndarray] = None
    base_charges: Optional[np.ndarray] = None
    dipole: Optional[np.ndarray] = None
    base_dipole: Optional[np.ndarray] = None
    polar: Optional[np.ndarray] = None
    extras: Dict[str, np.ndarray] = field(default_factory=dict)

    def __post_init__(self) -> None:
        self.atomic_numbers = np.asarray(self.atomic_numbers, dtype=np.int32)
        n = self.atomic_numbers.shape[0]
        self.pos = np.asarray(self.pos, dtype=np.float64).reshape(n, 3)
        if self.pbc is not None:
            self.pbc = np.asarray(self.pbc, dtype=bool).reshape(3)
        if self.cell is not None:
            self.cell = np.asarray(self.cell, dtype=np.float64).reshape(3, 3)
            if self.pbc is None:
                self.pbc = np.ones(3, dtype=bool)
        if self.edge_index is not None:
            self.edge_index = np.asarray(self.edge_index, dtype=np.int64).reshape(2, -1)
            assert self.edge_index.max(initial=-1) < n, "edge index out of range"
        if self.cell_offsets is not None:
            self.cell_offsets = np.asarray(self.cell_offsets, dtype=np.int64).reshape(
                -1, 3
            )
        if self.forces is not None:
            self.forces = np.asarray(self.forces, dtype=np.float64).reshape(n, 3)
        if self.base_forces is not None:
            self.base_forces = np.asarray(self.base_forces, dtype=np.float64).reshape(
                n, 3
            )
        if self.virial is not None:
            self.virial = np.asarray(self.virial, dtype=np.float64).reshape(3, 3)
        if self.atomic_charges is not None:
            self.atomic_charges = np.asarray(
                self.atomic_charges, dtype=np.float64
            ).reshape(n)
        if self.base_charges is not None:
            self.base_charges = np.asarray(
                self.base_charges, dtype=np.float64
            ).reshape(n)
        if self.dipole is not None:
            self.dipole = np.asarray(self.dipole, dtype=np.float64).reshape(3)
        if self.base_dipole is not None:
            self.base_dipole = np.asarray(self.base_dipole, dtype=np.float64).reshape(3)
        if self.polar is not None:
            self.polar = np.asarray(self.polar, dtype=np.float64).reshape(3, 3)

    @property
    def num_atoms(self) -> int:
        return int(self.atomic_numbers.shape[0])

    @property
    def num_edges(self) -> int:
        return 0 if self.edge_index is None else int(self.edge_index.shape[1])

    @property
    def has_cell(self) -> bool:
        return self.cell is not None and self.pbc is not None and bool(self.pbc.any())
