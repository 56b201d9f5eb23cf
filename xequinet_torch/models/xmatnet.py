"""XMatNet: quantum-chemistry matrix prediction on the XPaiNN backbone.

Port of ``xequinet_tpu/models/xmatnet.py``.  The backbone is XPaiNN
without heads, on whichever message route the model kwargs name (on the
card's mega route its blocks run the message kernels); ``MatOut`` then
emits the onsite [D, D] block of every atom (``SelfLayer`` +
``Expansion``, symmetrised) and the offsite block of every edge
(``PairLayer`` + ``Expansion``), D being the dimension of the target AO
basis (``utils/mat_toolkit.MatToolkit.get_basis_irreps``).  Padding rows
and edges give zero blocks.  flax names: ``O3Linear_0``,
``SelfLayer_<i>`` / ``PairLayer_<i>`` per matrix layer, ``Expansion_0``
(onsite) and ``Expansion_1`` (offsite).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from .. import keys
from ..ops.irreps import Irreps
from .matlayer import Expansion, PairLayer, SelfLayer
from .o3layer import O3Linear

DataDict = Dict[str, torch.Tensor]


class MatOut(nn.Module):
    """Node and edge features -> AO-basis matrix blocks, refined by
    ``n_mat_layers`` residual Self / Pair layers."""

    def __init__(self, node_irreps, hidden_irreps, basis_irreps, node_dim: int,
                 num_basis: int = 20, n_mat_layers: int = 2, activation: str = "silu"):
        super().__init__()
        hidden = Irreps(hidden_irreps)
        if len({mi.mul for mi in hidden}) != 1:
            raise ValueError(f"hidden_irreps must have uniform multiplicities for the uuu "
                             f"matrix tensor products, got {hidden}")
        self.n_mat_layers = n_mat_layers
        self.O3Linear_0 = O3Linear(node_irreps, hidden, biases=True)
        for i in range(n_mat_layers):
            setattr(self, f"SelfLayer_{i}", SelfLayer(hidden, hidden, activation))
            setattr(self, f"PairLayer_{i}", PairLayer(hidden, hidden, num_basis, activation))
        self.Expansion_0 = Expansion(hidden, basis_irreps, node_dim, activation)
        self.Expansion_1 = Expansion(hidden, basis_irreps, node_dim, activation)

    def forward(self, data: DataDict) -> DataDict:
        x = self.O3Linear_0(data[keys.NODE_EQUIVARIANT])
        embed = data[keys.NODE_INVARIANT]
        rbf = data[keys.RADIAL_BASIS_FUNCTION] * data[keys.ENVELOPE_FUNCTION]
        edge_index = data[keys.EDGE_INDEX]
        fii = fij = None
        for i in range(self.n_mat_layers):
            fii = getattr(self, f"SelfLayer_{i}")(x, fii)
            fij = getattr(self, f"PairLayer_{i}")(x, rbf, edge_index, fij)
        diag = self.Expansion_0(fii, embed)
        diag = 0.5 * (diag + diag.transpose(-1, -2))
        pair_embed = 0.5 * (embed.index_select(0, edge_index[keys.CENTER_IDX].long())
                            + embed.index_select(0, edge_index[keys.NEIGHBOR_IDX].long()))
        offdiag = self.Expansion_1(fij, pair_embed)
        data[keys.NODE_MAT_BLOCKS] = torch.where(data[keys.NODE_MASK][:, None, None], diag,
                                                 torch.zeros_like(diag))
        data[keys.EDGE_MAT_BLOCKS] = torch.where(data[keys.EDGE_MASK][:, None, None], offdiag,
                                                 torch.zeros_like(offdiag))
        return data


def build_xmatnet(**kwargs: Any):
    """XPaiNN backbone (no heads) + MatOut.  Needs ``target_basis`` (an
    ``{element: [l, ...]}`` shell dict, or a basis name PySCF resolves) and
    ``elements`` (the symbols the model covers), which fix the block size.
    Returns (module, extra properties, cutoff)."""
    from ..utils.mat_toolkit import MatToolkit
    from .model import BlockStack, build_xpainn

    if kwargs.get("target_basis") is None or kwargs.get("elements") is None:
        raise ValueError("xmatnet needs target_basis ({element: [l, ...]} or a PySCF basis "
                         "name) and elements=[symbols]")
    basis_irreps = MatToolkit(kwargs["target_basis"], kwargs["elements"]).get_basis_irreps()
    backbone, _, cutoff = build_xpainn(**{**kwargs, "output_modes": []})
    head = MatOut(
        node_irreps=kwargs.get("node_irreps", "128x0e+64x1o+32x2e"),
        hidden_irreps=kwargs.get("hidden_irreps", "32x0e+32x1o+32x2e"),
        basis_irreps=basis_irreps, node_dim=int(kwargs.get("node_dim", 128)),
        num_basis=int(kwargs.get("num_basis", 20)),
        n_mat_layers=int(kwargs.get("n_mat_layers", 2)),
        activation=str(kwargs.get("activation", "silu")))
    return BlockStack(list(backbone.blocks) + [head]), \
        [keys.NODE_MAT_BLOCKS, keys.EDGE_MAT_BLOCKS], cutoff
