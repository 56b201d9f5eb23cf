"""SO3krates: Euclidean attention message passing.

Port of ``xequinet_tpu/models/so3krates.py:32-188`` (``EquiFilter``,
``EuclideanAttention`` and its alias ``EculideanAttention``,
``InteractionBlock``).  The equivariant state is the flat irreps layout
of XPaiNN (``max_l`` 3 by default: ``32x0e+32x1o+32x2e+32x3o``).  Messages
are summed with ``ops.scatter.segment_sum``, plain ``index_add`` on every
device: the JAX package runs no Pallas kernel here either.  flax names:
the attention block's ``Dense_0``-``Dense_5`` are q_inv, k_inv, v_inv,
q_sph, k_sph, v_sph, and ``EquiFilter_0`` holds its own four; in an MLP
the outer Dense is created (and numbered) before the inner one.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from .. import keys
from ..ops.irreps import Irreps
from ..ops.o3ops import equivariant_dot, scalar_gate
from ..ops.scatter import segment_sum
from .basic import Dense, LayerNorm, resolve_activation
from .o3layer import EquivariantLayerNorm

DataDict = Dict[str, torch.Tensor]


class EquiFilter(nn.Module):
    """Per-edge filter: MLP(invariants of x_j - x_i) + MLP(rbf)."""

    def __init__(self, node_dim: int, node_irreps, num_basis: int, activation: str = "silu"):
        super().__init__()
        self.irreps = Irreps(node_irreps)
        self.act = resolve_activation(activation)
        ni = self.irreps.num_irreps
        self.Dense_0 = Dense(node_dim, node_dim)
        self.Dense_1 = Dense(ni, node_dim)
        self.Dense_2 = Dense(node_dim, node_dim)
        self.Dense_3 = Dense(num_basis, node_dim)

    def forward(self, x_equi, rbf, center_idx, neighbor_idx):
        x_ij = x_equi.index_select(0, neighbor_idx) - x_equi.index_select(0, center_idx)
        inv = equivariant_dot(x_ij, x_ij, self.irreps)
        w_l = self.Dense_0(self.act(self.Dense_1(inv)))
        w_r = self.Dense_2(self.act(self.Dense_3(rbf)))
        return w_l + w_r


class EuclideanAttention(nn.Module):
    """Multi-head per-edge attention with an invariant branch and an
    equivariant branch whose per-l attention gates the harmonics."""

    def __init__(self, node_irreps, node_dim: int = 120, num_heads: int = 4,
                 num_basis: int = 20, activation: str = "silu", layer_norm: bool = True):
        super().__init__()
        self.irreps = Irreps(node_irreps)
        l_max = self.irreps.lmax
        if node_dim % num_heads or node_dim % (l_max + 1):
            raise ValueError(f"node_dim {node_dim} must divide by num_heads {num_heads} "
                             f"and by l_max + 1 = {l_max + 1}")
        self.node_dim, self.num_heads, self.l_max = node_dim, num_heads, l_max
        ni = self.irreps.num_irreps
        self.scale_scalar = 1.0 / math.sqrt(node_dim)
        self.scale_equi = 1.0 / math.sqrt(ni)
        self.register_buffer("repeats", torch.tensor([mi.mul for mi in self.irreps]),
                             persistent=False)
        self.layer_norm = layer_norm
        if layer_norm:
            self.LayerNorm_0 = LayerNorm(node_dim)
            self.EquivariantLayerNorm_0 = EquivariantLayerNorm(self.irreps)
        for i in range(5):  # q_inv, k_inv, v_inv, q_sph, k_sph
            setattr(self, f"Dense_{i}", Dense(node_dim, node_dim, bias=False))
        self.Dense_5 = Dense(node_dim, ni, bias=False)  # v_sph
        self.EquiFilter_0 = EquiFilter(node_dim, self.irreps, num_basis, activation)

    def forward(self, data: DataDict) -> DataDict:
        d, h, l1 = self.node_dim, self.num_heads, self.l_max + 1
        node_scalar = data[keys.NODE_INVARIANT]
        node_equi = data[keys.NODE_EQUIVARIANT]
        if self.layer_norm:
            node_scalar = self.LayerNorm_0(node_scalar)
            node_equi = self.EquivariantLayerNorm_0(node_equi)
        fcut = data[keys.ENVELOPE_FUNCTION]
        center_idx = data[keys.EDGE_INDEX][keys.CENTER_IDX].long()
        neighbor_idx = data[keys.EDGE_INDEX][keys.NEIGHBOR_IDX].long()
        n_nodes, n_edges = node_scalar.shape[0], center_idx.shape[0]
        q_inv, k_inv, v_inv, q_sph, k_sph, v_sph = (
            getattr(self, f"Dense_{i}")(node_scalar) for i in range(6))
        w_ij = self.EquiFilter_0(node_equi, data[keys.RADIAL_BASIS_FUNCTION], center_idx,
                                 neighbor_idx) * fcut
        src = lambda t: t.index_select(0, neighbor_idx)

        query = (q_inv.index_select(0, center_idx) * w_ij).reshape(n_edges, h, d // h)
        attn = (query * src(k_inv).reshape(n_edges, h, d // h)).sum(-1, keepdim=True)
        msg_scalar = (attn * self.scale_scalar * src(v_inv).reshape(n_edges, h, d // h)
                      ).reshape(n_edges, d)

        query = (q_sph.index_select(0, center_idx) * w_ij).reshape(n_edges, l1, d // l1)
        attn = (query * src(k_sph).reshape(n_edges, l1, d // l1)).sum(-1) * self.scale_equi
        # each l's attention over that l's channels
        attn = torch.repeat_interleave(attn, self.repeats, dim=1,
                                       output_size=self.irreps.num_irreps)
        msg_equi = scalar_gate(data[keys.SPHERICAL_HARMONICS], attn * src(v_sph),
                               self.irreps) * fcut[..., :1]

        edge_mask = data[keys.EDGE_MASK]
        data[keys.NODE_INVARIANT] = data[keys.NODE_INVARIANT] + segment_sum(
            msg_scalar, center_idx, n_nodes, edge_mask, scope="edges")
        data[keys.NODE_EQUIVARIANT] = data[keys.NODE_EQUIVARIANT] + segment_sum(
            msg_equi, center_idx, n_nodes, edge_mask, scope="edges")
        return data


# the reference's spelling, kept for configs that name it
EculideanAttention = EuclideanAttention


class InteractionBlock(nn.Module):
    """Local mixing of the scalar and equivariant channels."""

    def __init__(self, node_irreps, node_dim: int = 128, activation: str = "silu",
                 layer_norm: bool = True):
        super().__init__()
        self.irreps = Irreps(node_irreps)
        self.node_dim = node_dim
        self.act = resolve_activation(activation)
        self.layer_norm = layer_norm
        if layer_norm:
            self.LayerNorm_0 = LayerNorm(node_dim)
            self.EquivariantLayerNorm_0 = EquivariantLayerNorm(self.irreps)
        concat_dim = node_dim + self.irreps.num_irreps
        self.Dense_0 = Dense(concat_dim, concat_dim)
        self.Dense_1 = Dense(concat_dim, concat_dim)

    def forward(self, data: DataDict) -> DataDict:
        node_scalar = data[keys.NODE_INVARIANT]
        node_equi = data[keys.NODE_EQUIVARIANT]
        if self.layer_norm:
            node_scalar = self.LayerNorm_0(node_scalar)
            node_equi = self.EquivariantLayerNorm_0(node_equi)
        cat = torch.cat([node_scalar, equivariant_dot(node_equi, node_equi, self.irreps)],
                        dim=-1)
        mix = self.Dense_0(self.act(self.Dense_1(cat)))
        d_equi = scalar_gate(node_equi, mix[..., self.node_dim :], self.irreps)
        data[keys.NODE_INVARIANT] = data[keys.NODE_INVARIANT] + mix[..., : self.node_dim]
        data[keys.NODE_EQUIVARIANT] = data[keys.NODE_EQUIVARIANT] + d_equi
        return data
