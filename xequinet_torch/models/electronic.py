"""Charge and spin conditioning: graph-attention embeddings.

Port of ``xequinet_tpu/models/electronic.py:25-112``.  A block returns
the data unchanged when its key (TOTAL_CHARGE / TOTAL_SPIN) is absent
from the batch, as the JAX blocks do; unlike flax, which creates the
parameters only when the init batch carries the key, the port's blocks
always hold them.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from .. import keys
from ..ops.scatter import segment_sum
from .basic import Dense, ResidualLayer

DataDict = Dict[str, torch.Tensor]


class _Conditioning(nn.Module):
    """Per-graph features -> softplus attention over the graph's atoms ->
    residual added to the node scalars.  Flax names: ``Dense_0`` (query),
    ``Dense_1`` (key), ``Dense_2`` (value), ``ResidualLayer_0``.  The
    attention is normalised by its per-graph sum over the real atoms
    (NODE_MASK); the per-row numerator stays unmasked."""

    key: str = ""
    n_features: int = 0

    def __init__(self, node_dim: int = 128, activation: str = "silu"):
        super().__init__()
        self.node_dim = node_dim
        self.Dense_0 = Dense(node_dim, node_dim)
        self.Dense_1 = Dense(self.n_features, node_dim, bias=False)
        self.Dense_2 = Dense(self.n_features, node_dim, bias=False)
        self.ResidualLayer_0 = ResidualLayer(node_dim, n_layers=2, activation=activation)

    def features(self, value: torch.Tensor):
        """(key features, value features) [G, n_features] of the graphs'
        charge or spin."""
        raise NotImplementedError

    def forward(self, data: DataDict) -> DataDict:
        if self.key not in data:
            return data
        batch = data[keys.BATCH].long()
        node_scalar = data[keys.NODE_INVARIANT]
        key_f, value_f = self.features(data[self.key].to(node_scalar.dtype))
        query = self.Dense_0(node_scalar)
        key = self.Dense_1(key_f).index_select(0, batch)
        value = self.Dense_2(value_f).index_select(0, batch)
        dot = (query * key).sum(dim=-1, keepdim=True)
        attn = F.softplus(dot / math.sqrt(self.node_dim))
        n_graphs = data[keys.GRAPH_MASK].shape[0]
        # under halo decomposition the normaliser is the all-reduce of the
        # shards' owned-row sums (scope="graphs"); the per-row numerator
        # stays unmasked, so halo rows carry their owners' embedding
        attn_sum = segment_sum(attn, batch, n_graphs, data[keys.NODE_MASK],
                               scope="graphs").index_select(0, batch)
        embed = self.ResidualLayer_0((attn * value) / torch.clamp(attn_sum, min=1e-9))
        data[keys.NODE_INVARIANT] = node_scalar + embed
        return data


class ChargeEmbedding(_Conditioning):
    """Keyed on the net charge q as (q+, q-) = relu(q, -q): key features
    (q+, q-) / max(., 1), value features (q+, q-)."""

    key = keys.TOTAL_CHARGE
    n_features = 2

    def features(self, charge):
        pm = F.relu(torch.stack([charge, -charge], dim=-1))
        return pm / torch.clamp(pm, min=1.0), pm


class SpinEmbedding(_Conditioning):
    """Keyed on the spin s (= 2S): key feature s / max(s, 1), value s."""

    key = keys.TOTAL_SPIN
    n_features = 1

    def features(self, spin):
        spin = spin[:, None]
        return spin / torch.clamp(spin, min=1.0), spin
