"""Equivariant layers with parameters: O3Linear, Gate,
EquivariantLayerNorm and the weighted TensorProductModule.

Port of ``xequinet_tpu/models/o3layer.py:23-160``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops.irreps import Irreps
from ..ops.o3ops import equivariant_layer_norm, invariant, scalar_gate
from ..ops.tensor_product import TensorProduct
from .basic import Dense, _normal_, resolve_activation


def bf16_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b on bf16-rounded inputs with an f32 result (XLA's
    ``preferred_element_type=float32``): the products of bf16 values are
    exact in f32, so an f32 product of the rounded values is the same."""
    return a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()


class O3Linear(nn.Module):
    """Equivariant linear layer mixing multiplicities within each (l, p)
    (e3nn ``o3.Linear``): per-path weights ``w{out}_{in}`` [mul_in, mul_out]
    scaled by 1/sqrt(fan_in), biases ``b{out}`` on even scalar outputs.
    The forward assembles one block-diagonal [dim_in, dim_out] matrix."""

    def __init__(self, irreps_in, irreps_out, biases: bool = False,
                 compute_dtype: Optional[str] = None):
        super().__init__()
        self.irreps_in = Irreps(irreps_in)
        self.irreps_out = Irreps(irreps_out)
        self.biases = biases
        self.compute_dtype = compute_dtype
        self._paths = []
        self._bias_names = []
        for i_out, (mul_out, ir_out) in enumerate(self.irreps_out):
            paths = [(i_in, mi) for i_in, mi in enumerate(self.irreps_in)
                     if mi.ir == ir_out]
            fan_in = sum(mi.mul for _, mi in paths)
            norm = 1.0 / np.sqrt(max(fan_in, 1))
            for i_in, mi in paths:
                name = f"w{i_out}_{i_in}"
                self.register_parameter(name, nn.Parameter(torch.zeros(mi.mul, mul_out)))
                self._paths.append((name, i_in, i_out, float(norm)))
            if biases and ir_out.l == 0 and ir_out.p == 1:
                name = f"b{i_out}"
                self.register_parameter(name, nn.Parameter(torch.zeros(mul_out)))
                self._bias_names.append((name, i_out))

    def _init(self, gen: torch.Generator) -> None:
        for name, _, _, _ in self._paths:
            _normal_(getattr(self, name), gen, 1.0)
        with torch.no_grad():
            for name, _ in self._bias_names:
                getattr(self, name).zero_()

    def block(self):
        """(w_block [dim_in, dim_out] f32, b_lane [dim_out] or None)."""
        sl_in, sl_out = self.irreps_in.slices(), self.irreps_out.slices()
        ref = next(self.parameters())
        w_block = torch.zeros(self.irreps_in.dim, self.irreps_out.dim,
                              dtype=torch.float32, device=ref.device)
        for name, i_in, i_out, norm in self._paths:
            w = getattr(self, name)
            mul_in, mul_out = w.shape
            dim = self.irreps_out[i_out].ir.dim
            eye_m = torch.eye(dim, dtype=torch.float32, device=w.device)
            blk = (w[:, None, :, None] * eye_m[None, :, None, :]).reshape(
                mul_in * dim, mul_out * dim
            )
            w_block[sl_in[i_in], sl_out[i_out]] += blk * norm
        b_lane = None
        for name, i_out in self._bias_names:
            if b_lane is None:
                b_lane = torch.zeros(self.irreps_out.dim, dtype=torch.float32,
                                     device=ref.device)
            b_lane[sl_out[i_out]] = getattr(self, name)
        return w_block, b_lane

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w_block, b_lane = self.block()
        if self.compute_dtype is not None:
            y = bf16_product(x, w_block)
        else:
            y = x @ w_block
        if b_lane is not None:
            y = y + b_lane
        return y


class Gate(nn.Module):
    """Each irrep scaled by act(|x_u|)/|x_u| (the activation divided by
    x), or with ``refine`` by Dense -> act -> Dense of the invariants
    (flax ``Dense_0`` / ``Dense_1``, zero biases at init)."""

    def __init__(self, irreps, activation: str = "silu", refine: bool = False):
        super().__init__()
        self.irreps = Irreps(irreps).simplify()
        self.act = resolve_activation(activation, devide_x=True)
        self.refine = refine
        if refine:
            ni = self.irreps.num_irreps
            self.Dense_0 = Dense(ni, ni)
            self.Dense_1 = Dense(ni, ni)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_inv = invariant(x, self.irreps)
        if self.refine:
            gates = self.Dense_1(self.act(self.Dense_0(x_inv)))
        else:
            gates = self.act(x_inv)
        return scalar_gate(x, gates, self.irreps)


class EquivariantLayerNorm(nn.Module):
    """Equivariant LayerNorm: ``weight`` [num_irreps], ``bias``
    [num_scalars]."""

    def __init__(self, irreps, eps: float = 1e-5):
        super().__init__()
        self.irreps = Irreps(irreps)
        self.eps = eps
        num_scalar = sum(mul for mul, ir in self.irreps if ir.l == 0 and ir.p == 1)
        self.weight = nn.Parameter(torch.ones(self.irreps.num_irreps))
        self.bias = nn.Parameter(torch.zeros(max(num_scalar, 1)))

    def _init(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return equivariant_layer_norm(x, self.irreps, self.weight, self.bias, self.eps)


class TensorProductModule(nn.Module):
    """A tensor product with its own shared weights: the flat parameter
    ``weight`` [weight_numel], N(0, 1) at init (e3nn ``o3.TensorProduct``
    with ``internal_weights=True``)."""

    def __init__(self, tp: TensorProduct):
        super().__init__()
        self.tp = tp
        self.weight = nn.Parameter(torch.zeros(tp.weight_numel)) if tp.weight_numel else None

    def _init(self, gen: torch.Generator) -> None:
        if self.weight is not None:
            _normal_(self.weight, gen, 1.0)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        return self.tp.apply(x1, x2, self.weight)
