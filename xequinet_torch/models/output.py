"""Output heads.

Port of ``xequinet_tpu/models/output.py:77-104`` (``EnergyOut``) and of
its head factory (output.py:287-322) for the energy head; the other heads
come with a later slice.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from .. import keys
from ..ops.scatter import segment_sum
from .basic import ScalarMLP


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

    def forward(self, data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        atom_eng = self.ScalarMLP_0(data[keys.NODE_INVARIANT])[..., 0]
        atom_eng = torch.where(data[keys.NODE_MASK], atom_eng, torch.zeros_like(atom_eng))
        if keys.ATOMIC_ENERGIES in data:
            atom_eng = data[keys.ATOMIC_ENERGIES] + atom_eng
        n_graphs = data[keys.GRAPH_MASK].shape[0]
        data[keys.ATOMIC_ENERGIES] = atom_eng
        data[keys.TOTAL_ENERGY] = segment_sum(atom_eng, data[keys.BATCH], n_graphs)
        return data


_HEADS = {"energy": (EnergyOut, ("node_dim", "hidden_dim", "activation",
                                  "node_shift", "node_scale"))}

OUTPUT_EXTRA_PROPERTIES = {"energy": [keys.TOTAL_ENERGY, keys.ATOMIC_ENERGIES]}


def resolve_output(mode: str, **kwargs) -> nn.Module:
    """Head factory; unknown model_kwargs keys are ignored."""
    if mode not in _HEADS:
        raise NotImplementedError(f"output head {mode!r} is not ported yet")
    cls, fields = _HEADS[mode]
    return cls(**{k: v for k, v in kwargs.items() if k in fields})
