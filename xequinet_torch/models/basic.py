"""Shared building blocks: activations, dense layers, MLPs, embeddings.

Port of ``xequinet_tpu/models/basic.py:18-110``.  ``Dense`` and
``LayerNorm`` reproduce flax's ``nn.Dense`` / ``nn.LayerNorm`` numerics
(including flax's bf16 rounding points when ``compute_dtype`` is bf16),
so one parameter tree gives the same outputs in both packages.  Every
module with parameters has ``_init(generator)``; models/model.py walks
them with one seeded ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def resolve_activation(activation: str, devide_x: bool = False) -> Callable:
    """Activation factory; ``devide_x=True`` returns f(x)/x for gates."""
    activation = activation.lower()
    activation_div_x = {"silu": "sigmoid", "relu": "identity", "leakyrelu": "identity"}
    if devide_x and activation in activation_div_x:
        activation = activation_div_x[activation]
    table = {
        "relu": F.relu,
        "leakyrelu": lambda x: F.leaky_relu(x, negative_slope=0.01),
        "softplus": F.softplus,
        "sigmoid": torch.sigmoid,
        "silu": F.silu,
        "tanh": torch.tanh,
        "identity": lambda x: x,
    }
    if activation not in table:
        raise NotImplementedError(f"Unsupported activation function {activation}")
    return table[activation]


def _normal_(t: torch.Tensor, gen: torch.Generator, std: float) -> None:
    with torch.no_grad():
        t.copy_(torch.randn(t.shape, generator=gen, dtype=t.dtype) * std)


class Dense(nn.Linear):
    """flax ``nn.Dense``: weight [out, in] (flax kernel transposed).

    With ``compute_dtype="bfloat16"`` inputs and parameters are cast to
    bf16, the product is rounded to bf16 and the bias added in bf16, as
    flax does with ``dtype=bfloat16``.
    """

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: str = "float32", weight_scale: float = 1.0,
                 bias_init: float = 0.0):
        super().__init__(in_features, out_features, bias=bias)
        self.cdtype = getattr(torch, compute_dtype)
        self.weight_scale = weight_scale
        self.bias_init = bias_init

    def _init(self, gen: torch.Generator) -> None:
        _normal_(self.weight, gen, self.weight_scale / math.sqrt(self.in_features))
        if self.bias is not None:
            with torch.no_grad():
                self.bias.fill_(self.bias_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.cdtype == torch.float32:
            return F.linear(x.float(), self.weight, self.bias)
        cd = self.cdtype
        y = x.to(cd) @ self.weight.t().to(cd)
        if self.bias is not None:
            y = y + self.bias.to(cd)
        return y


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` (fast variance E[x^2] - E[x]^2); ``weight``
    is flax's ``scale``."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def _init(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=-1, keepdim=True)
        mean2 = (x * x).mean(dim=-1, keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        mul = self.weight * torch.rsqrt(var + self.eps)
        return (x - mean) * mul + self.bias


class ScalarMLP(nn.Module):
    """Dense -> act -> Dense; flax names ``Dense_0`` / ``Dense_1``."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 activation: str = "silu", final_bias_init: float = 0.0,
                 final_weight_scale: float = 1.0, use_bias: bool = True):
        super().__init__()
        self.act = resolve_activation(activation)
        self.Dense_0 = Dense(in_dim, hidden_dim, bias=use_bias)
        self.Dense_1 = Dense(hidden_dim, out_dim, bias=use_bias,
                             weight_scale=final_weight_scale,
                             bias_init=final_bias_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(self.act(self.Dense_0(x)))


class ResidualLayer(nn.Module):
    """``n_layers`` bias-free Dense layers, each followed by the
    activation, added to the input and scaled by 1/sqrt(2); flax names
    ``Dense_0`` ... ``Dense_{n_layers - 1}``."""

    def __init__(self, node_dim: int, n_layers: int = 2, activation: str = "silu"):
        super().__init__()
        self.act = resolve_activation(activation)
        self.n_layers = n_layers
        for i in range(n_layers):
            setattr(self, f"Dense_{i}", Dense(node_dim, node_dim, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(self.n_layers):
            h = self.act(getattr(self, f"Dense_{i}")(h))
        return (x + h) * (1.0 / math.sqrt(2.0))


class AtomEmbedding(nn.Module):
    """Atomic-number embedding: a trainable table over 100 elements whose
    row 0 (the padding element) reads as zero whatever the stored value,
    or, with ``embed_table`` ([n_elements + 1, n_aux], e.g. the xTB-basis
    projections of utils/qc.get_embedding_table), that fixed table
    followed by ``Dense_0`` (zero bias at init), as flax names it."""

    def __init__(self, node_dim: int, embed_table: Optional[object] = None):
        super().__init__()
        if embed_table is None:
            self.embedding = nn.Parameter(torch.zeros(100, node_dim))
            self.Dense_0 = None
        else:
            table = torch.as_tensor(np.asarray(embed_table, dtype=np.float32))
            self.register_buffer("fixed", table, persistent=False)
            self.Dense_0 = Dense(table.shape[1], node_dim)

    def _init(self, gen: torch.Generator) -> None:
        if self.Dense_0 is None:
            _normal_(self.embedding, gen, 1.0)

    def forward(self, atomic_numbers: torch.Tensor) -> torch.Tensor:
        if self.Dense_0 is not None:
            return self.Dense_0(self.fixed[atomic_numbers.long()])
        table = self.embedding.clone()
        table[0] = 0.0
        return table[atomic_numbers.long()]
