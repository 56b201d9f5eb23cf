"""Higher-order tensor machinery: SelfMixTP, Sph2Cart and the Cartesian
tensor head CartTensorOut.

Port of ``xequinet_tpu/models/xe3net.py``.  flax names: ``SelfMixTP_0``
(with ``O3Linear_0`` / ``O3Linear_1``, ``TensorProductModule_0`` and
``EquivariantLayerNorm_0``), ``ScalarMLP_0`` (the per-node weights of the
``uuw`` product) and ``O3Linear_0`` where the product's irreps differ from
the target's; ``Sph2Cart`` holds no parameters.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from .. import keys
from ..ops.cartesian import reduced_tensor_basis
from ..ops.irreps import Irrep, Irreps
from ..ops.scatter import segment_sum
from ..ops.tensor_product import TensorProduct, get_feasible_tp
from .basic import ScalarMLP
from .o3layer import EquivariantLayerNorm, O3Linear, TensorProductModule

DataDict = Dict[str, torch.Tensor]


def selfmix_irreps(irreps_in, hidden_channel: int):
    """(hidden irreps, mixed output irreps, instructions) of SelfMixTP:
    every l of the input at ``hidden_channel`` channels, mixed by a ``uuu``
    self product into 0e, both parities of 2 .. 2 lmax - 1, and 2 lmax e."""
    irreps_in = Irreps(irreps_in)
    lmax = irreps_in.lmax
    irreps_hid = Irreps([(hidden_channel, mi.ir) for mi in irreps_in])
    mix = [(hidden_channel, Irrep(0, 1))]
    for l in range(2, 2 * lmax):
        mix.append((hidden_channel, Irrep(l, -1)))
        mix.append((hidden_channel, Irrep(l, 1)))
    mix.append((hidden_channel, Irrep(2 * lmax, 1)))
    irreps_out, instructions = get_feasible_tp(irreps_hid, irreps_hid, Irreps(mix), "uuu")
    return irreps_hid, irreps_out, instructions


class SelfMixTP(nn.Module):
    """Node features expanded to higher l (both parities) by a weighted
    ``uuu`` product of two linear projections of themselves."""

    def __init__(self, irreps_in, hidden_channel: int = 32, layer_norm: bool = True):
        super().__init__()
        irreps_in = Irreps(irreps_in)
        irreps_hid, self.irreps_out, instructions = selfmix_irreps(irreps_in, hidden_channel)
        self.O3Linear_0 = O3Linear(irreps_in, irreps_hid)
        self.O3Linear_1 = O3Linear(irreps_in, irreps_hid)
        self.TensorProductModule_0 = TensorProductModule(
            TensorProduct(irreps_hid, irreps_hid, self.irreps_out, instructions))
        self.EquivariantLayerNorm_0 = (EquivariantLayerNorm(self.irreps_out)
                                       if layer_norm else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_mix = self.TensorProductModule_0(self.O3Linear_0(x), self.O3Linear_1(x))
        if self.EquivariantLayerNorm_0 is not None:
            x_mix = self.EquivariantLayerNorm_0(x_mix)
        return x_mix


class Sph2Cart(nn.Module):
    """Spherical -> Cartesian change of basis (axes in the irrep basis)."""

    def __init__(self, formula: str):
        super().__init__()
        _, q = reduced_tensor_basis(formula)
        self.register_buffer("Q", torch.as_tensor(q, dtype=torch.float32), persistent=False)
        self.rank = len(formula.split("=")[0].replace("-", ""))

    def forward(self, x_sph: torch.Tensor) -> torch.Tensor:
        cart = x_sph @ self.Q.to(x_sph.dtype)
        return cart.reshape(x_sph.shape[:-1] + (3,) * self.rank)


class CartTensorOut(nn.Module):
    """Rank-``order`` Cartesian tensor head: SelfMixTP, a ``uuw`` product
    weighted per node by a scalar MLP, the change of basis, a per-graph sum
    or mean over the real atoms (``reduce_op`` None keeps it per atom), and
    the [y, z, x] -> [x, y, z] roll on every Cartesian axis; with
    ``isotropic``, trace / 3."""

    def __init__(self, node_dim: int = 128, node_irreps="128x0e+64x1o+32x2e",
                 hidden_dim: int = 64, hidden_channels: int = 32, order: int = 2,
                 symmetry: str = "ij", activation: str = "silu",
                 reduce_op: Optional[str] = "sum", layer_norm: bool = True,
                 isotropic: bool = False, output_field: str = keys.CARTESIAN_TENSOR):
        super().__init__()
        if order != 2 and isotropic:
            raise ValueError("Isotropic output is only supported for order 2.")
        if reduce_op not in (None, "sum", "mean"):
            raise NotImplementedError(reduce_op)
        self.reduce_op, self.isotropic, self.output_field = reduce_op, isotropic, output_field
        self.SelfMixTP_0 = SelfMixTP(node_irreps, hidden_channels, layer_norm)
        mixed = self.SelfMixTP_0.irreps_out
        rtp_irreps, _ = reduced_tensor_basis(symmetry)
        sph_irreps, instructions = get_feasible_tp(mixed, mixed, rtp_irreps, "uuw")
        self.tp = TensorProduct(mixed, mixed, sph_irreps, instructions)
        self.ScalarMLP_0 = ScalarMLP(node_dim, hidden_dim, self.tp.weight_numel,
                                     activation=activation)
        self.O3Linear_0 = O3Linear(sph_irreps, rtp_irreps) if sph_irreps != rtp_irreps \
            else None
        self.sph2cart = Sph2Cart(symmetry)

    def forward(self, data: DataDict) -> DataDict:
        tp_in = self.SelfMixTP_0(data[keys.NODE_EQUIVARIANT])
        out = self.tp.apply(tp_in, tp_in, self.ScalarMLP_0(data[keys.NODE_INVARIANT]))
        if self.O3Linear_0 is not None:
            out = self.O3Linear_0(out)
        cart = self.sph2cart(out)
        if self.reduce_op is not None:
            batch, mask = data[keys.BATCH].long(), data[keys.NODE_MASK]
            n_graphs = data[keys.GRAPH_MASK].shape[0]
            flat = cart.reshape(cart.shape[0], -1)
            red = segment_sum(flat, batch, n_graphs, mask)
            if self.reduce_op == "mean":
                cnt = segment_sum(torch.ones_like(flat[:, 0]), batch, n_graphs, mask)
                red = red / torch.clamp(cnt, min=1.0)[:, None]
            cart = red.reshape((n_graphs,) + cart.shape[1:])
        if self.isotropic:
            cart = torch.diagonal(cart, dim1=-2, dim2=-1).sum(-1) / 3.0
        else:
            axes = tuple(range(1, cart.dim()))
            cart = cart.roll((1,) * len(axes), dims=axes)
        data[self.output_field] = cart
        return data
