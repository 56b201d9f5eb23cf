"""Output heads: energy, scalar, atomic charges, dipole, polarizability,
spatial extent and (from models/xe3net.py) the Cartesian tensor.

Port of ``xequinet_tpu/models/output.py:38-322``.  Every graph reduction
is a segment sum over the real atoms (NODE_MASK).
"""

from __future__ import annotations

import inspect
import math
from typing import Dict, Optional

import torch
from torch import nn

from .. import keys
from ..ops.irreps import Irreps
from ..ops.scatter import segment_sum
from ..utils.qc import ATOM_MASS
from .basic import ScalarMLP
from .o3layer import Gate, O3Linear
from .xe3net import CartTensorOut

DataDict = Dict[str, torch.Tensor]


def _graphs(data: DataDict):
    """(batch index, graph count, node mask) of a batch."""
    return data[keys.BATCH].long(), data[keys.GRAPH_MASK].shape[0], data[keys.NODE_MASK]


class ScalarOut(nn.Module):
    """A scalar property per atom, summed or averaged per graph
    (``reduce_op`` "sum" / "mean"; None keeps it per atom)."""

    def __init__(self, node_dim: int = 128, hidden_dim: int = 64, activation: str = "silu",
                 node_shift: float = 0.0, node_scale: float = 1.0,
                 reduce_op: Optional[str] = "sum", output_field: str = keys.SCALAR_OUTPUT):
        super().__init__()
        if reduce_op not in (None, "sum", "mean"):
            raise NotImplementedError(reduce_op)
        self.reduce_op = reduce_op
        self.output_field = output_field
        self.ScalarMLP_0 = ScalarMLP(node_dim, hidden_dim, 1, activation=activation,
                                     final_bias_init=node_shift,
                                     final_weight_scale=node_scale)

    def forward(self, data: DataDict) -> DataDict:
        res = self.ScalarMLP_0(data[keys.NODE_INVARIANT])[..., 0]
        if self.reduce_op is not None:
            batch, n_graphs, mask = _graphs(data)
            total = segment_sum(res, batch, n_graphs, mask)
            if self.reduce_op == "mean":
                cnt = segment_sum(torch.ones_like(res), batch, n_graphs, mask)
                total = total / torch.clamp(cnt, min=1.0)
            res = total
        data[self.output_field] = res
        return data


class EnergyOut(nn.Module):
    """Energy head with node shift/scale folded into the final linear init;
    accumulates atomic energies across heads."""

    def __init__(self, node_dim: int = 128, hidden_dim: int = 64,
                 activation: str = "silu", node_shift: float = 0.0,
                 node_scale: float = 1.0):
        super().__init__()
        self.ScalarMLP_0 = ScalarMLP(
            node_dim, hidden_dim, 1, activation=activation,
            final_bias_init=node_shift, final_weight_scale=node_scale,
        )

    def forward(self, data: DataDict) -> DataDict:
        atom_eng = self.ScalarMLP_0(data[keys.NODE_INVARIANT])[..., 0]
        atom_eng = torch.where(data[keys.NODE_MASK], atom_eng, torch.zeros_like(atom_eng))
        if keys.ATOMIC_ENERGIES in data:
            atom_eng = data[keys.ATOMIC_ENERGIES] + atom_eng
        n_graphs = data[keys.GRAPH_MASK].shape[0]
        data[keys.ATOMIC_ENERGIES] = atom_eng
        data[keys.TOTAL_ENERGY] = segment_sum(atom_eng, data[keys.BATCH], n_graphs)
        return data


class AtomicChargesOut(nn.Module):
    """Atomic charges; with ``conservation`` each graph's excess over its
    TOTAL_CHARGE (0 without the key) is spread evenly over its atoms."""

    def __init__(self, node_dim: int = 128, hidden_dim: int = 64, activation: str = "silu",
                 conservation: bool = True):
        super().__init__()
        self.conservation = conservation
        self.ScalarMLP_0 = ScalarMLP(node_dim, hidden_dim, 1, activation=activation)

    def forward(self, data: DataDict) -> DataDict:
        batch, n_graphs, mask = _graphs(data)
        q = self.ScalarMLP_0(data[keys.NODE_INVARIANT])[..., 0]
        q = torch.where(mask, q, torch.zeros_like(q))
        if self.conservation:
            raw_total = segment_sum(q, batch, n_graphs)
            num_atoms = segment_sum(torch.ones_like(q), batch, n_graphs, mask)
            if keys.TOTAL_CHARGE in data:
                total_charge = data[keys.TOTAL_CHARGE].to(q.dtype)
            else:
                total_charge = torch.zeros_like(raw_total)
            delta = (total_charge - raw_total) / torch.clamp(num_atoms, min=1.0)
            delta = delta.index_select(0, batch)
            q = q + torch.where(mask, delta, torch.zeros_like(delta))
        data[keys.ATOMIC_CHARGES] = q
        return data


class DipoleOut(nn.Module):
    """Equivariant dipole: O3Linear -> Gate -> O3Linear to 1x1o, taken
    from the irrep basis [y, z, x] to [x, y, z], times a scalar MLP, summed
    per graph; ``magnitude`` adds its norm."""

    def __init__(self, node_dim: int = 128, node_irreps="128x0e+64x1o+32x2e",
                 hidden_dim: int = 64, hidden_irreps="32x1o", activation: str = "silu",
                 magnitude: bool = False):
        super().__init__()
        self.magnitude = magnitude
        self.O3Linear_0 = O3Linear(node_irreps, hidden_irreps)
        self.Gate_0 = Gate(hidden_irreps, activation=activation)
        self.O3Linear_1 = O3Linear(hidden_irreps, "1x1o")
        self.ScalarMLP_0 = ScalarMLP(node_dim, hidden_dim, 1, activation=activation)

    def forward(self, data: DataDict) -> DataDict:
        batch, n_graphs, mask = _graphs(data)
        h = self.Gate_0(self.O3Linear_0(data[keys.NODE_EQUIVARIANT]))
        equi_out = self.O3Linear_1(h)[:, [2, 0, 1]]  # [y, z, x] -> [x, y, z]
        scalar_out = self.ScalarMLP_0(data[keys.NODE_INVARIANT])
        dipole = segment_sum(equi_out * scalar_out, batch, n_graphs, mask)
        data[keys.DIPOLE] = dipole
        if self.magnitude:
            data[keys.DIPOLE_MAGNITUDE] = torch.linalg.norm(dipole, dim=-1)
        return data


class PolarOut(nn.Module):
    """Polarizability: 0e + 2e per atom, each gated by a scalar, summed per
    graph and assembled into a symmetric 3x3 (with the JAX package's
    ``d_norm`` isotropic term); ``isotropic`` adds trace / 3."""

    def __init__(self, node_dim: int = 128, node_irreps="128x0e+64x1o+32x2e",
                 hidden_dim: int = 64, hidden_irreps="64x0e+16x2e", activation: str = "silu",
                 isotropic: bool = False):
        super().__init__()
        self.isotropic = isotropic
        self.O3Linear_0 = O3Linear(node_irreps, hidden_irreps, biases=True)
        self.Gate_0 = Gate(hidden_irreps, activation=activation)
        self.O3Linear_1 = O3Linear(hidden_irreps, "1x0e+1x2e", biases=True)
        self.ScalarMLP_0 = ScalarMLP(node_dim, hidden_dim, 2, activation=activation)

    def forward(self, data: DataDict) -> DataDict:
        batch, n_graphs, mask = _graphs(data)
        h = self.Gate_0(self.O3Linear_0(data[keys.NODE_EQUIVARIANT]))
        equi_out = self.O3Linear_1(h)  # [N, 6]
        scalar_out = self.ScalarMLP_0(data[keys.NODE_INVARIANT])  # [N, 2]
        gated = torch.cat([equi_out[:, :1] * scalar_out[:, :1],
                           equi_out[:, 1:] * scalar_out[:, 1:2]], dim=-1)
        polar_out = segment_sum(gated, batch, n_graphs, mask)  # [G, 6]
        zero_order = polar_out[:, 0]
        second = polar_out[:, 1:6]
        d_norm = torch.linalg.norm(second, dim=-1)
        dxy, dyz, dz2, dzx, dx2_y2 = second.unbind(dim=-1)
        s3 = 1.0 / math.sqrt(3.0)
        xx = s3 * (d_norm - dz2) + dx2_y2
        yy = s3 * (d_norm - dz2) - dx2_y2
        zz = s3 * (d_norm + 2 * dz2)
        second_out = torch.stack([torch.stack([xx, dxy, dzx], dim=-1),
                                  torch.stack([dxy, yy, dyz], dim=-1),
                                  torch.stack([dzx, dyz, zz], dim=-1)], dim=-2)
        eye = torch.eye(3, dtype=polar_out.dtype, device=polar_out.device)
        polarizability = eye[None] * zero_order[:, None, None] + second_out
        data[keys.POLARIZABILITY] = polarizability
        if self.isotropic:
            data[keys.ISO_POLARIZABILITY] = torch.diagonal(
                polarizability, dim1=-2, dim2=-1).sum(-1) / 3.0
        return data


class SpatialOut(nn.Module):
    """Mass-weighted electronic spatial extent <r^2> per graph, [G, 1]
    (positions relative to each graph's centre of mass, not written
    back)."""

    def __init__(self, node_dim: int = 128, hidden_dim: int = 64, activation: str = "silu"):
        super().__init__()
        self.ScalarMLP_0 = ScalarMLP(node_dim, hidden_dim, 1, activation=activation)
        self.register_buffer("atom_mass", torch.tensor(ATOM_MASS, dtype=torch.float32),
                             persistent=False)

    def forward(self, data: DataDict) -> DataDict:
        batch, n_graphs, mask = _graphs(data)
        pos = data[keys.POSITIONS]
        masses = self.atom_mass.to(pos.dtype)[data[keys.ATOMIC_NUMBERS].long()][:, None]
        m_pos = segment_sum(masses * pos, batch, n_graphs, mask)
        m_tot = segment_sum(masses, batch, n_graphs, mask)
        centroids = m_pos / torch.clamp(m_tot, min=1e-9)
        rel = pos - centroids.index_select(0, batch)
        scalar_out = self.ScalarMLP_0(data[keys.NODE_INVARIANT])
        spatial = (rel * rel).sum(dim=-1, keepdim=True)
        data[keys.SPATIAL_EXTENT] = segment_sum(scalar_out * spatial, batch, n_graphs, mask)
        return data


_HEADS = {
    "scalar": ScalarOut,
    "energy": EnergyOut,
    "charges": AtomicChargesOut,
    "atomic_charges": AtomicChargesOut,
    "dipole": DipoleOut,
    "polar": PolarOut,
    "spatial": SpatialOut,
    "cartesian": CartTensorOut,
}

OUTPUT_EXTRA_PROPERTIES = {
    "scalar": [keys.SCALAR_OUTPUT],
    "energy": [keys.TOTAL_ENERGY, keys.ATOMIC_ENERGIES],
    "charges": [keys.ATOMIC_CHARGES],
    "atomic_charges": [keys.ATOMIC_CHARGES],
    "dipole": [keys.DIPOLE],
    "polar": [keys.POLARIZABILITY],
    "spatial": [keys.SPATIAL_EXTENT],
    "cartesian": [keys.CARTESIAN_TENSOR],
}


def resolve_output(mode: str, **kwargs) -> nn.Module:
    """Head factory: the head's own arguments are taken from the
    model_kwargs (every ``*irreps*`` one as Irreps), the rest ignored."""
    if mode not in _HEADS:
        raise NotImplementedError(f"Unsupported output head {mode!r}")
    cls = _HEADS[mode]
    fields = set(inspect.signature(cls.__init__).parameters) - {"self"}
    return cls(**{k: Irreps(v) if "irreps" in k else v
                  for k, v in kwargs.items() if k in fields})
