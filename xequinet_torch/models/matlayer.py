"""QHNet-style blocks for quantum-chemistry matrices: SelfLayer (onsite
block features), PairLayer (offsite block features) and Expansion
(block features -> matrix blocks through Wigner-3j).

Port of ``xequinet_tpu/models/matlayer.py``.  flax names, per class in
creation order: SelfLayer's ``Gate_0`` / ``O3Linear_0`` (left),
``Gate_1`` / ``O3Linear_1`` (right), ``TensorProductModule_0``,
``Gate_2``, ``O3Linear_2``; PairLayer's ``Dense_0`` / ``Dense_1`` (the
weight MLP of the edge scalars, outer before inner), ``Dense_2`` /
``Dense_3`` (that of the radial basis), ``O3Linear_0``, ``Gate_0``,
``Gate_1``, ``O3Linear_1``; Expansion's ``Dense_0`` / ``Dense_1`` (weights)
and ``Dense_2`` / ``Dense_3`` (biases).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops.irreps import Irreps
from ..ops.o3ops import equivariant_dot
from ..ops.tensor_product import TensorProduct, get_feasible_tp
from ..ops.wigner import wigner_3j
from .basic import Dense, resolve_activation
from .o3layer import Gate, O3Linear, TensorProductModule


class SelfLayer(nn.Module):
    """Onsite block features: a weighted ``uuu`` product of two gated
    linear projections of the node features, gated and projected, added to
    the previous layer's."""

    def __init__(self, irreps_in, irreps_hidden, activation: str = "silu"):
        super().__init__()
        irreps_in, irreps_hidden = Irreps(irreps_in), Irreps(irreps_hidden)
        tp_out, instructions = get_feasible_tp(irreps_in, irreps_in, irreps_hidden, "uuu")
        for i in range(2):
            setattr(self, f"Gate_{i}", Gate(irreps_in, activation=activation, refine=True))
            setattr(self, f"O3Linear_{i}", O3Linear(irreps_in, irreps_in, biases=True))
        self.TensorProductModule_0 = TensorProductModule(
            TensorProduct(irreps_in, irreps_in, tp_out, instructions))
        self.Gate_2 = Gate(tp_out, activation=activation, refine=True)
        self.O3Linear_2 = O3Linear(tp_out, irreps_hidden)

    def forward(self, x: torch.Tensor, fii_in: Optional[torch.Tensor] = None) -> torch.Tensor:
        xl = self.O3Linear_0(self.Gate_0(x))
        xr = self.O3Linear_1(self.Gate_1(x))
        fii = self.O3Linear_2(self.Gate_2(self.TensorProductModule_0(xl, xr)))
        return fii if fii_in is None else fii + fii_in


class PairLayer(nn.Module):
    """Offsite block features: a ``uuu`` product of the two ends' gated
    features, weighted per edge by MLP(edge scalars) x MLP(radial basis)."""

    def __init__(self, irreps_in, irreps_hidden, edge_attr_dim: int = 20,
                 activation: str = "silu"):
        super().__init__()
        irreps_in, irreps_hidden = Irreps(irreps_in), Irreps(irreps_hidden)
        self.irreps_in = irreps_in
        self.act = resolve_activation(activation)
        self.num_scalar = irreps_in[0].mul
        tp_out, instructions = get_feasible_tp(irreps_in, irreps_in, irreps_hidden, "uuu")
        self.tp = TensorProduct(irreps_in, irreps_in, tp_out, instructions)
        s0_dim = self.num_scalar + irreps_in.num_irreps
        self.Dense_0 = Dense(128, self.tp.weight_numel)
        self.Dense_1 = Dense(s0_dim, 128)
        self.Dense_2 = Dense(128, self.tp.weight_numel)
        self.Dense_3 = Dense(edge_attr_dim, 128)
        self.O3Linear_0 = O3Linear(irreps_in, irreps_in, biases=True)
        self.Gate_0 = Gate(irreps_in, activation=activation, refine=True)
        self.Gate_1 = Gate(tp_out, activation=activation, refine=True)
        self.O3Linear_1 = O3Linear(tp_out, irreps_hidden)

    def forward(self, x: torch.Tensor, edge_attr: torch.Tensor, edge_index: torch.Tensor,
                fij_in: Optional[torch.Tensor] = None) -> torch.Tensor:
        ns = self.num_scalar
        i_idx, j_idx = edge_index[0].long(), edge_index[1].long()
        xi, xj = x.index_select(0, i_idx), x.index_select(0, j_idx)
        s0 = torch.cat([xi[:, :ns], xj[:, :ns],
                        equivariant_dot(xi, xj, self.irreps_in)[:, ns:]], dim=-1)
        w_scalar = self.Dense_0(self.act(self.Dense_1(s0)))
        w_rbf = self.Dense_2(self.act(self.Dense_3(edge_attr)))
        x_prime = self.Gate_0(self.O3Linear_0(x))
        fij = self.tp.apply(x_prime.index_select(0, i_idx), x_prime.index_select(0, j_idx),
                            w_scalar * w_rbf)
        fij = self.O3Linear_1(self.Gate_1(fij))
        return fij if fij_in is None else fij + fij_in


class Expansion(nn.Module):
    """Block features -> (irreps_out x irreps_out) matrix blocks: each path
    (block irrep, row irrep, column irrep) allowed by the selection rule
    mixes the channels with per-sample weights (and, for the first block
    irrep, per-sample biases) from MLPs of ``node_embed``, couples them
    through Wigner-3j and divides by the block irrep's channels; blocks no
    path reaches are zero."""

    def __init__(self, irreps_block, irreps_out, node_dim: int, activation: str = "silu"):
        super().__init__()
        self.irreps_block, self.irreps_out = Irreps(irreps_block), Irreps(irreps_out)
        self.act = resolve_activation(activation)
        self.instructions = [
            (i, j, k, (mul_in, mul1, mul2))
            for i, (mul_in, ir_in) in enumerate(self.irreps_block)
            for j, (mul1, ir1) in enumerate(self.irreps_out)
            for k, (mul2, ir2) in enumerate(self.irreps_out)
            if ir_in in list(ir1 * ir2)]
        for path, (i, j, k, _) in enumerate(self.instructions):
            w3j = wigner_3j(self.irreps_out[j].ir.l, self.irreps_out[k].ir.l,
                            self.irreps_block[i].ir.l)
            self.register_buffer(f"w3j_{path}", torch.as_tensor(w3j, dtype=torch.float32),
                                 persistent=False)
        num_weight = sum(int(np.prod(s)) for *_, s in self.instructions)
        num_bias = sum(int(np.prod(s[1:])) for i, _, _, s in self.instructions if i == 0)
        self.Dense_0 = Dense(64, num_weight)
        self.Dense_1 = Dense(node_dim, 64)
        self.Dense_2 = Dense(64, num_bias)
        self.Dense_3 = Dense(node_dim, 64)

    def forward(self, x_in: torch.Tensor, node_embed: torch.Tensor) -> torch.Tensor:
        weight = self.Dense_0(self.act(self.Dense_1(node_embed)))
        bias = self.Dense_2(self.act(self.Dense_3(node_embed)))
        n = x_in.shape[0]
        sl = self.irreps_block.slices()
        x_blocks = [x_in[:, s].reshape(n, mi.mul, mi.ir.dim)
                    for s, mi in zip(sl, self.irreps_block)]
        outputs = {}
        w_off = b_off = 0
        for path, (i, j, k, shape) in enumerate(self.instructions):
            mul_in = self.irreps_block[i].mul
            mul1, ir1 = self.irreps_out[j]
            mul2, ir2 = self.irreps_out[k]
            nw = int(np.prod(shape))
            w = weight[:, w_off : w_off + nw].reshape(n, *shape)
            w_off += nw
            res = torch.einsum("bwuv,bwk->buvk", w, x_blocks[i])
            if i == 0:
                nb = mul1 * mul2
                res = res + bias[:, b_off : b_off + nb].reshape(n, mul1, mul2)[..., None]
                b_off += nb
            w3j = getattr(self, f"w3j_{path}").to(x_in.dtype)
            res = torch.einsum("ijk,buvk->buivj", w3j, res) / mul_in
            res = res.reshape(n, mul1 * ir1.dim, mul2 * ir2.dim)
            outputs[(j, k)] = outputs[(j, k)] + res if (j, k) in outputs else res
        rows = []
        for j, (mul1, ir1) in enumerate(self.irreps_out):
            blocks = [outputs.get((j, k)) for k in range(len(self.irreps_out))]
            blocks = [b if b is not None else x_in.new_zeros(n, mul1 * ir1.dim, mul2 * ir2.dim)
                      for b, (mul2, ir2) in zip(blocks, self.irreps_out)]
            rows.append(torch.cat(blocks, dim=-1))
        return torch.cat(rows, dim=-2)
