"""Ewald message passing: long-range interactions at O(N K).

Port of ``xequinet_tpu/models/ewald.py:27-200``.  The k-grids are host
numpy constants (copies of the JAX package's host code).

``EwaldBlock`` computes the same function as the JAX block, which
builds [N, K, D] intermediates (K = 171 k-points at ``num_k_points``
(3, 3, 3)): its structure factors are, per graph, ``cos(kr)^T @ h`` and
``sin(kr)^T @ h`` over the graph's atoms, and its message back to an
atom is ``cos(kr) @ F_re + sin(kr) @ F_im`` with the graph's filtered
factors F.  Here both are batched products over the real atoms
(NODE_MASK) laid out per graph ([G, M, K] with M the largest graph), so
the memory is [G, M, K + D] instead of [N, K, D].  Rows outside NODE_MASK
get no message: in the JAX block theirs is never read either (every head
and every structure factor masks them).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .. import keys
from ..ops.scatter import reduce_graphs
from .basic import Dense, LayerNorm, ResidualLayer, resolve_activation

DataDict = Dict[str, torch.Tensor]

# the real atoms' per-graph layout, built by the initial block and read by
# every EwaldBlock of the batch (not a user-facing key)
EWALD_ROWS = "k_ewald_rows"


def get_k_index_product_set(num_k_x: int, num_k_y: int, num_k_z: int) -> np.ndarray:
    """Half-box of integer k-lattice indices around the origin."""
    kx = np.arange(-num_k_x, num_k_x + 1)
    ky = np.arange(-num_k_y, num_k_y + 1)
    kz = np.arange(-num_k_z, num_k_z + 1)
    prod = np.stack(np.meshgrid(kx, ky, kz, indexing="ij"), axis=-1).reshape(-1, 3)
    return prod[prod.shape[0] // 2 + 1:].astype(np.float64)


def _gaussian_rbf(d: np.ndarray, num_basis: int, cutoff: float) -> np.ndarray:
    mean = np.linspace(0.0, cutoff, num_basis)[None, :]
    std = 1.0 + 1e-5
    coeff = 1.0 / (std * math.sqrt(2 * math.pi))
    return coeff * np.exp(-0.5 * ((d - mean) / std) ** 2)


def _poly_envelope(d: np.ndarray, cutoff: float, p: int = 5) -> np.ndarray:
    x = d / cutoff
    val = (1.0 - 0.5 * (p + 1) * (p + 2) * x**p + p * (p + 2) * x ** (p + 1)
           - 0.5 * p * (p + 1) * x ** (p + 2))
    return np.where(d < cutoff, val, 0.0)


def get_k_voxel_grid(k_cutoff: float, delta_k: float, num_k_basis: int,
                     k_offset: Optional[float] = None) -> Tuple[np.ndarray, np.ndarray]:
    """The k-voxel grid inside the cutoff sphere, and the Gaussian RBF x
    polynomial envelope of |k| on it."""
    num_k = int(k_cutoff / delta_k)
    idx = get_k_index_product_set(num_k, num_k, num_k)
    k_grid = idx * delta_k
    k_grid = k_grid[np.square(k_grid).sum(-1) < k_cutoff**2]
    if k_offset is None:
        k_offset = 0.1 if num_k_basis <= 48 else 0.25
    d = np.linalg.norm(k_grid, axis=-1, keepdims=True)
    rbf = _gaussian_rbf(d, num_k_basis, k_cutoff + k_offset)
    env = _poly_envelope(d, k_cutoff + k_offset)
    return k_grid, rbf * env


def ewald_rows(data: DataDict):
    """(row index [R], flat slot [R] in a [G * M] per-graph layout, M) of
    the real atoms: each graph's atoms in row order."""
    batch = data[keys.BATCH].long()
    n_graphs = data[keys.GRAPH_MASK].shape[0]
    rows = torch.nonzero(data[keys.NODE_MASK]).reshape(-1)
    graph = batch.index_select(0, rows)
    counts = torch.bincount(graph, minlength=n_graphs)
    starts = torch.cumsum(counts, 0) - counts
    order = torch.argsort(graph, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(rows.numel(), device=rows.device) - starts.index_select(
        0, graph.index_select(0, order))
    m = max(int(counts.max()), 1) if rows.numel() else 1
    return rows, graph * m + rank, m


class EwaldInitialPBC(nn.Module):
    """The k-grid of each graph's reciprocal cell, K_DOT_R, unit sinc
    damping, and the learned ``down_projection`` [K, P] (a raw parameter,
    xavier-uniform at init).  Padding graphs take the identity cell before
    the inverse, so that no NaN reaches a gradient."""

    def __init__(self, num_k_points=(3, 3, 3), projection_dim: int = 8):
        super().__init__()
        k_index = get_k_index_product_set(*num_k_points)
        self.register_buffer("k_index", torch.tensor(k_index, dtype=torch.float32),
                             persistent=False)
        self.down_projection = nn.Parameter(torch.zeros(k_index.shape[0], projection_dim))

    def _init(self, gen: torch.Generator) -> None:
        n_k, p = self.down_projection.shape
        a = math.sqrt(6.0 / (n_k + p))
        with torch.no_grad():
            self.down_projection.copy_((torch.rand((n_k, p), generator=gen) * 2 - 1) * a)

    def forward(self, data: DataDict) -> DataDict:
        cell = data[keys.CELL]
        eye = torch.eye(3, dtype=cell.dtype, device=cell.device)
        cell = torch.where(data[keys.GRAPH_MASK][:, None, None], cell, eye)
        k_cell = 2 * math.pi * torch.linalg.inv(cell)  # [G, 3, 3]
        k_grid = torch.einsum("ki,gij->gkj", self.k_index.to(cell.dtype), k_cell)
        pos = data[keys.POSITIONS]
        k_per_atom = k_grid.index_select(0, data[keys.BATCH].long())  # [N, K, 3]
        data[keys.K_DOT_R] = torch.einsum("aki,ai->ak", k_per_atom, pos)
        data[keys.SINC_DAMPING] = torch.ones((pos.shape[0], 1), dtype=pos.dtype,
                                             device=pos.device)
        data[keys.DOWN_PROJECTION] = self.down_projection
        data[EWALD_ROWS] = ewald_rows(data)
        return data


class EwaldInitialNonPBC(nn.Module):
    """The fixed k-voxel grid, K_DOT_R, the sinc damping of each atom and
    ``Dense_0`` (no bias) of the constant k-RBF table as the down
    projection.  Needs structures in their SVD frame
    (data.transforms.SVDFrameTransform)."""

    def __init__(self, k_cutoff: float = 0.4, delta_k: float = 0.2, num_k_basis: int = 20,
                 k_offset: Optional[float] = None, projection_dim: int = 8,
                 eps: float = 1e-5):
        super().__init__()
        k_grid, k_rbf = get_k_voxel_grid(k_cutoff, delta_k, num_k_basis, k_offset)
        self.delta_k = delta_k
        self.eps = eps
        self.register_buffer("k_grid", torch.tensor(k_grid, dtype=torch.float32),
                             persistent=False)
        self.register_buffer("k_rbf", torch.tensor(k_rbf, dtype=torch.float32),
                             persistent=False)
        self.Dense_0 = Dense(num_k_basis, projection_dim, bias=False)

    def forward(self, data: DataDict) -> DataDict:
        pos = data[keys.POSITIONS]
        data[keys.K_DOT_R] = pos @ self.k_grid.to(pos.dtype).t()
        data[keys.SINC_DAMPING] = torch.prod(
            torch.sinc(0.5 * self.delta_k * pos + self.eps), dim=-1, keepdim=True)
        data[keys.DOWN_PROJECTION] = self.Dense_0(self.k_rbf)
        data[EWALD_ROWS] = ewald_rows(data)
        return data


class EwaldBlock(nn.Module):
    """Structure factors -> learned k-filter -> back to the atoms ->
    residual update of the node scalars.  Flax names: ``ResidualLayer_0``,
    ``LayerNorm_0``, ``Dense_0`` (the up projection [P -> D], initialised
    at 1e-2 of the usual scale: variance 1e-4 / fan-in), ``Dense_1``,
    ``ResidualLayer_1..num_residuals``."""

    def __init__(self, node_dim: int = 128, projection_dim: int = 8,
                 activation: str = "silu", layer_norm: bool = True,
                 num_residuals: int = 3):
        super().__init__()
        self.act = resolve_activation(activation)
        self.num_residuals = num_residuals
        self.ResidualLayer_0 = ResidualLayer(node_dim, n_layers=2, activation=activation)
        self.LayerNorm_0 = LayerNorm(node_dim) if layer_norm else None
        self.Dense_0 = Dense(projection_dim, node_dim, bias=False, weight_scale=1e-2)
        self.Dense_1 = Dense(node_dim, node_dim, bias=False)
        for i in range(1, num_residuals + 1):
            setattr(self, f"ResidualLayer_{i}",
                    ResidualLayer(node_dim, n_layers=2, activation=activation))

    def forward(self, data: DataDict) -> DataDict:
        node_scalar = data[keys.NODE_INVARIANT]
        rows, slot, m = data[EWALD_ROWS]
        n_graphs = data[keys.GRAPH_MASK].shape[0]
        node_res = self.ResidualLayer_0(node_scalar)
        if self.LayerNorm_0 is not None:
            node_res = self.LayerNorm_0(node_res)

        k_dot_r = data[keys.K_DOT_R].index_select(0, rows)  # [R, K]
        sinc = data[keys.SINC_DAMPING].index_select(0, rows)
        dim = node_res.shape[1]

        def per_graph(x):  # [R, C] -> [G, M, C], zero where no atom
            out = x.new_zeros((n_graphs * m, x.shape[1]))
            return out.index_copy(0, slot, x).reshape(n_graphs, m, x.shape[1])

        real = per_graph(torch.cos(k_dot_r) * sinc)  # [G, M, K]
        imag = per_graph(torch.sin(k_dot_r) * sinc)
        res = per_graph(node_res.index_select(0, rows))  # [G, M, D]
        # the structure factors are sums over the graph's real atoms: under
        # halo decomposition each shard (one graph of window rows) sums its
        # owned rows and the all-reduce over the group makes them whole
        # (ewald.py:169-179); halo rows add nothing and get no message, and
        # no output reads them
        sf_real = reduce_graphs(real.transpose(1, 2) @ res)  # [G, K, D]
        sf_imag = reduce_graphs(imag.transpose(1, 2) @ res)
        kfilter = self.Dense_0(data[keys.DOWN_PROJECTION])[None]  # [1, K, D]
        msg = real @ (kfilter * sf_real) + imag @ (kfilter * sf_imag)  # [G, M, D]
        msg = msg.reshape(n_graphs * m, dim).index_select(0, slot)
        ewald_msg = node_scalar.new_zeros((node_scalar.shape[0], dim)).index_copy(0, rows, msg)

        h = self.act(self.Dense_1(ewald_msg))
        for i in range(1, self.num_residuals + 1):
            h = getattr(self, f"ResidualLayer_{i}")(h)
        data[keys.NODE_INVARIANT] = node_scalar + h
        return data
