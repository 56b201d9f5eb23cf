"""PaiNN: vector-feature (l = 1) message passing without CG algebra.

Port of ``xequinet_tpu/models/painn.py:24-145``.  The equivariant state
is a plain [N, 3, D] vector field (not a flat irreps layout), the edge
"harmonics" are the unit edge vectors in (x, y, z), and ``Dense`` acts
on the last axis.  Messages are summed with ``ops.scatter.segment_sum``,
plain ``index_add`` on every device: the JAX package runs no Pallas
kernel here either.  flax names: ``Dense_<i>`` in creation order (an
outer Dense is created before the inner one it is applied to).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from .. import keys
from ..ops.scatter import segment_sum
from .basic import AtomEmbedding, Dense, resolve_activation
from .rbf import resolve_cutoff, resolve_rbf

DataDict = Dict[str, torch.Tensor]


class PainnEmbedding(nn.Module):
    """Atom embedding, radial basis and cutoff, unit edge vectors and a
    zero [N, 3, D] vector state."""

    def __init__(self, node_dim: int = 128, num_basis: int = 20,
                 embed_basis: str = "one-hot", aux_basis: str = "aux56",
                 rbf_kernel: str = "bessel", cutoff: float = 5.0,
                 cutoff_fn: str = "cosine"):
        super().__init__()
        embed_table = None
        if embed_basis != "one-hot":
            from ..utils.qc import get_embedding_table

            embed_table = get_embedding_table(embed_basis, aux_basis)
        self.node_dim = node_dim
        self.AtomEmbedding_0 = AtomEmbedding(node_dim, embed_table)
        rbf = resolve_rbf(rbf_kernel, num_basis, cutoff)
        self.rbf_name = f"{type(rbf).__name__}_0"
        self.add_module(self.rbf_name, rbf)
        self.cutoff_fn = resolve_cutoff(cutoff_fn, cutoff)

    def forward(self, data: DataDict) -> DataDict:
        node_invariant = self.AtomEmbedding_0(data[keys.ATOMIC_NUMBERS])
        data[keys.NODE_INVARIANT] = node_invariant
        distances = data[keys.EDGE_LENGTH][..., None]
        data[keys.RADIAL_BASIS_FUNCTION] = getattr(self, self.rbf_name)(distances)
        data[keys.ENVELOPE_FUNCTION] = self.cutoff_fn(distances)
        unit = data[keys.EDGE_VECTOR] / torch.clamp(distances, min=1e-9)
        data[keys.SPHERICAL_HARMONICS] = torch.where(
            data[keys.EDGE_MASK][:, None], unit, torch.zeros_like(unit))
        data[keys.NODE_EQUIVARIANT] = torch.zeros(
            (node_invariant.shape[0], 3, self.node_dim), dtype=node_invariant.dtype,
            device=node_invariant.device)
        return data


class PainnMessage(nn.Module):
    """Message block: filtered scalar messages and gated vector messages
    summed onto the centres."""

    def __init__(self, node_dim: int = 128, num_basis: int = 20, activation: str = "silu"):
        super().__init__()
        self.node_dim = node_dim
        self.act = resolve_activation(activation)
        self.Dense_0 = Dense(node_dim, node_dim)
        self.Dense_1 = Dense(node_dim, 3 * node_dim)
        self.Dense_2 = Dense(num_basis, 3 * node_dim)

    def forward(self, data: DataDict) -> DataDict:
        d = self.node_dim
        node_scalar = data[keys.NODE_INVARIANT]
        node_equi = data[keys.NODE_EQUIVARIANT]  # [N, 3, D]
        center_idx = data[keys.EDGE_INDEX][keys.CENTER_IDX].long()
        neighbor_idx = data[keys.EDGE_INDEX][keys.NEIGHBOR_IDX].long()
        edge_mask = data[keys.EDGE_MASK]
        n_nodes = node_scalar.shape[0]

        scalar_out = self.Dense_1(self.act(self.Dense_0(node_scalar)))
        filter_weight = self.Dense_2(data[keys.RADIAL_BASIS_FUNCTION]) * \
            data[keys.ENVELOPE_FUNCTION]
        filter_out = scalar_out.index_select(0, neighbor_idx) * filter_weight
        message_scalar = filter_out[..., :d]
        gate_edge_vector = filter_out[..., d : 2 * d]
        gate_state_vector = filter_out[..., 2 * d :]
        message_vector = node_equi.index_select(0, neighbor_idx) * gate_state_vector[:, None, :] \
            + gate_edge_vector[:, None, :] * data[keys.SPHERICAL_HARMONICS][:, :, None]
        data[keys.NODE_INVARIANT] = node_scalar + segment_sum(
            message_scalar, center_idx, n_nodes, edge_mask, scope="edges")
        data[keys.NODE_EQUIVARIANT] = node_equi + segment_sum(
            message_vector, center_idx, n_nodes, edge_mask, scope="edges")
        return data


class PainnUpdate(nn.Module):
    """Update block: U and V vector projections, an MLP of the scalars and
    |V|, and the gated updates.  |V| is ``norm(V + 1e-12)`` as in the JAX
    package: the offset on every component keeps the gradient of the norm
    finite where V is zero (padding rows)."""

    def __init__(self, node_dim: int = 128, activation: str = "silu"):
        super().__init__()
        self.node_dim = node_dim
        self.act = resolve_activation(activation)
        self.Dense_0 = Dense(node_dim, node_dim, bias=False)
        self.Dense_1 = Dense(node_dim, node_dim, bias=False)
        self.Dense_2 = Dense(node_dim, 3 * node_dim)
        self.Dense_3 = Dense(2 * node_dim, node_dim)

    def forward(self, data: DataDict) -> DataDict:
        d = self.node_dim
        node_scalar = data[keys.NODE_INVARIANT]
        node_equi = data[keys.NODE_EQUIVARIANT]
        u_vec = self.Dense_0(node_equi)
        v_vec = self.Dense_1(node_equi)
        v_norm = torch.linalg.norm(v_vec + 1e-12, dim=1)
        mlp_in = torch.cat([node_scalar, v_norm], dim=-1)
        mlp_out = self.Dense_2(self.act(self.Dense_3(mlp_in)))
        a_ss, a_vv, a_sv = mlp_out[..., :d], mlp_out[..., d : 2 * d], mlp_out[..., 2 * d :]
        inner = torch.sum(u_vec * v_vec, dim=1)
        data[keys.NODE_INVARIANT] = node_scalar + a_sv * inner + a_ss
        data[keys.NODE_EQUIVARIANT] = node_equi + a_vv[:, None, :] * u_vec
        return data
