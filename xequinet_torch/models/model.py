"""Model assembly: XPaiNN as an ordered block stack.

Port of ``xequinet_tpu/models/model.py:27-144, 321-340``.  A model is a
``BlockStack`` whose ``blocks`` thread the data dict in order; the full
forward with forces / virial is ``models.properties.make_forward``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple, Union

import torch
from torch import nn

from ..ops.irreps import Irreps
from .output import OUTPUT_EXTRA_PROPERTIES, resolve_output
from .xpainn import XEmbedding, XPainnMessage, XPainnUpdate

DataDict = Dict[str, torch.Tensor]


class BlockStack(nn.Module):
    """Threads the data dict through ``blocks`` (flax ``blocks_<i>``)."""

    def __init__(self, blocks: Sequence[nn.Module]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)

    def forward(self, data: DataDict) -> DataDict:
        for block in self.blocks:
            data = block(data)
        return data


def _as_list(modes: Union[None, str, Sequence[str]]) -> List[str]:
    if modes is None:
        return ["energy"]
    if isinstance(modes, str):
        return [modes]
    return list(modes)


def build_xpainn(**kwargs: Any) -> Tuple[BlockStack, List[str], float]:
    """XEmbedding -> N x (Message, Update) -> output heads, from the JAX
    package's model_kwargs.  Returns (module, extra_properties, cutoff).
    ``remat`` only changes memory in the JAX package and is ignored here;
    charge / spin embeddings come with a later slice."""
    node_dim = kwargs.get("node_dim", 128)
    node_irreps = Irreps(kwargs.get("node_irreps", "128x0e + 64x1o + 32x2e"))
    num_basis = kwargs.get("num_basis", 20)
    cutoff = kwargs.get("cutoff", 5.0)
    activation = kwargs.get("activation", "silu")
    layer_norm = kwargs.get("layer_norm", True)
    if kwargs.get("charge_embed", False) or kwargs.get("spin_embed", False):
        raise NotImplementedError("charge / spin embeddings are not ported yet")
    use_pallas = kwargs.get("use_pallas_scatter", False)
    pallas_layout = tuple(kwargs.get("pallas_layout", (256, 1024, 32, 8)))
    compute_dtype = kwargs.get("compute_dtype", "float32")
    update_compute_dtype = kwargs.get("update_compute_dtype", "float32")
    blocks: List[nn.Module] = [
        XEmbedding(
            node_dim=node_dim, node_irreps=node_irreps,
            embed_basis=kwargs.get("embed_basis", "gfn2-xtb"),
            aux_basis=kwargs.get("aux_basis", "aux56"),
            num_basis=num_basis, rbf_kernel=kwargs.get("rbf_kernel", "bessel"),
            cutoff=cutoff, cutoff_fn=kwargs.get("cutoff_fn", "cosine"),
            pack_edge_features=use_pallas in ("mega", "mega-xb"),
        )
    ]
    for _ in range(kwargs.get("action_blocks", 3)):
        blocks.append(XPainnMessage(
            node_dim=node_dim, node_irreps=node_irreps, num_basis=num_basis,
            activation=activation, layer_norm=layer_norm,
            compute_dtype=compute_dtype, use_pallas=use_pallas,
            pallas_layout=pallas_layout,
        ))
        blocks.append(XPainnUpdate(
            node_dim=node_dim, node_irreps=node_irreps, activation=activation,
            layer_norm=layer_norm, compute_dtype=update_compute_dtype,
        ))
    extra: List[str] = []
    for mode in _as_list(kwargs.get("output_modes", ["energy"])):
        head_kwargs = dict(kwargs)
        head_kwargs.setdefault("node_dim", node_dim)
        blocks.append(resolve_output(mode, **head_kwargs))
        extra.extend(OUTPUT_EXTRA_PROPERTIES[mode])
    return BlockStack(blocks), extra, cutoff


MODEL_BUILDERS = {"xpainn": build_xpainn}


def resolve_model(model_name: str, **kwargs: Any):
    name = model_name.lower()
    if name not in MODEL_BUILDERS:
        raise NotImplementedError(f"model {model_name} is not ported yet")
    return MODEL_BUILDERS[name](**kwargs)


def init_params(module: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random weights: every submodule with ``_init`` draws from
    one ``torch.Generator`` in module order.  (The JAX package's
    ``jax.random`` draws differ; tests share weights through
    ``convert.params_from_flax`` instead.)"""
    gen = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if hasattr(m, "_init"):
            m._init(gen)
    return module
