"""Model assembly: every model family of the JAX package (XPaiNN,
XPaiNN-Ewald, PaiNN, SO3krates, XMatNet) as ordered block stacks.

Port of ``xequinet_tpu/models/model.py``.  A model is a ``BlockStack``
whose ``blocks`` thread the data dict in order; the full forward with
forces / virial is ``models.properties.make_forward``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple, Union

import torch
from torch import nn

from ..ops.irreps import Irreps
from .electronic import ChargeEmbedding, SpinEmbedding
from .ewald import EwaldBlock, EwaldInitialNonPBC, EwaldInitialPBC
from .output import OUTPUT_EXTRA_PROPERTIES, resolve_output
from .painn import PainnEmbedding, PainnMessage, PainnUpdate
from .remat import rematerialize, remat
from .so3krates import EuclideanAttention, InteractionBlock
from .xmatnet import build_xmatnet
from .xpainn import XEmbedding, XPainnMessage, XPainnUpdate

DataDict = Dict[str, torch.Tensor]


class BlockStack(nn.Module):
    """Threads the data dict through ``blocks`` (flax ``blocks_<i>``)."""

    def __init__(self, blocks: Sequence[nn.Module]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)

    def forward(self, data: DataDict) -> DataDict:
        for block in self.blocks:
            policy = getattr(block, "remat_policy", None)
            data = block(data) if policy is None else rematerialize(block, data, policy)
        return data


def _as_list(modes: Union[None, str, Sequence[str]]) -> List[str]:
    if modes is None:
        return ["energy"]
    if isinstance(modes, str):
        return [modes]
    return list(modes)


def _heads(modes, kwargs: Dict[str, Any], node_dim: int, node_irreps) -> Tuple[list, list]:
    """The output heads of ``modes`` and the properties they add."""
    head_kwargs = dict(kwargs)
    head_kwargs.setdefault("node_dim", node_dim)
    head_kwargs.setdefault("node_irreps", node_irreps)
    blocks, extra = [], []
    for mode in _as_list(modes):
        blocks.append(resolve_output(mode, **head_kwargs))
        extra.extend(OUTPUT_EXTRA_PROPERTIES[mode])
    return blocks, extra


def build_xpainn(**kwargs: Any) -> Tuple[BlockStack, List[str], float]:
    """XEmbedding -> [Charge / SpinEmbedding] -> N x (Message, Update) ->
    output heads, from the JAX package's model_kwargs.  Returns (module,
    extra_properties, cutoff).  ``remat`` recomputes each message and
    update block's activations in the backward (``models/remat.py``);
    ``remat_policy`` "save_edge_agg" keeps each message block's aggregate,
    any other value recomputes everything (JAX model.py:68-85)."""
    node_dim = kwargs.get("node_dim", 128)
    node_irreps = Irreps(kwargs.get("node_irreps", "128x0e + 64x1o + 32x2e"))
    num_basis = kwargs.get("num_basis", 20)
    cutoff = kwargs.get("cutoff", 5.0)
    activation = kwargs.get("activation", "silu")
    layer_norm = kwargs.get("layer_norm", True)
    use_pallas = kwargs.get("use_pallas_scatter", False)
    pallas_layout = tuple(kwargs.get("pallas_layout", (256, 1024, 32, 8)))
    compute_dtype = kwargs.get("compute_dtype", "float32")
    update_compute_dtype = kwargs.get("update_compute_dtype", "float32")
    policy = kwargs.get("remat_policy", "full") if kwargs.get("remat", False) else None
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
    if kwargs.get("charge_embed", False):
        blocks.append(ChargeEmbedding(node_dim=node_dim, activation=activation))
    if kwargs.get("spin_embed", False):
        blocks.append(SpinEmbedding(node_dim=node_dim, activation=activation))
    for _ in range(kwargs.get("action_blocks", 3)):
        action = [
            XPainnMessage(
                node_dim=node_dim, node_irreps=node_irreps, num_basis=num_basis,
                activation=activation, layer_norm=layer_norm,
                compute_dtype=compute_dtype, use_pallas=use_pallas,
                pallas_layout=pallas_layout,
            ),
            XPainnUpdate(
                node_dim=node_dim, node_irreps=node_irreps, activation=activation,
                layer_norm=layer_norm, compute_dtype=update_compute_dtype,
            ),
        ]
        blocks.extend(action if policy is None else [remat(b, policy) for b in action])
    heads, extra = _heads(kwargs.get("output_modes", ["energy"]), kwargs, node_dim,
                          node_irreps)
    return BlockStack(blocks + heads), extra, cutoff


def build_xpainn_ewald(**kwargs: Any) -> Tuple[BlockStack, List[str], float]:
    """XPaiNN with its heads, then the Ewald initial block (periodic:
    ``use_pbc``, the reciprocal cell's k-grid; free: the k-voxel grid),
    ``ewald_blocks`` EwaldBlocks and the ``ewald_output_mode`` heads, whose
    energy adds to the XPaiNN heads' atomic energies."""
    stack, extra, cutoff = build_xpainn(**kwargs)
    blocks = list(stack.blocks)
    node_dim = kwargs.get("node_dim", 128)
    projection_dim = kwargs.get("projection_dim", 8)
    if kwargs.get("use_pbc", True):
        blocks.append(EwaldInitialPBC(num_k_points=tuple(kwargs.get("num_k_points", [3, 3, 3])),
                                      projection_dim=projection_dim))
    else:
        blocks.append(EwaldInitialNonPBC(
            k_cutoff=kwargs.get("k_cutoff", 0.4), delta_k=kwargs.get("delta_k", 0.2),
            num_k_basis=kwargs.get("num_k_basis", 20), k_offset=kwargs.get("k_offset", None),
            projection_dim=projection_dim))
    for _ in range(kwargs.get("ewald_blocks", 1)):
        blocks.append(EwaldBlock(node_dim=node_dim, projection_dim=projection_dim,
                                 activation=kwargs.get("activation", "silu"),
                                 layer_norm=kwargs.get("layer_norm", True)))
    heads, ewald_extra = _heads(kwargs.get("ewald_output_mode", ["energy"]), kwargs, node_dim,
                                kwargs.get("node_irreps", "128x0e + 64x1o + 32x2e"))
    return BlockStack(blocks + heads), extra + ewald_extra, cutoff


def build_painn(**kwargs: Any) -> Tuple[BlockStack, List[str], float]:
    """PaiNN: PainnEmbedding -> N x (PainnMessage, PainnUpdate) -> heads."""
    node_dim = kwargs.get("node_dim", 128)
    num_basis = kwargs.get("num_basis", 20)
    cutoff = kwargs.get("cutoff", 5.0)
    activation = kwargs.get("activation", "silu")
    blocks: List[nn.Module] = [PainnEmbedding(
        node_dim=node_dim, num_basis=num_basis,
        embed_basis=kwargs.get("embed_basis", "gfn2-xtb"),
        aux_basis=kwargs.get("aux_basis", "aux56"),
        rbf_kernel=kwargs.get("rbf_kernel", "bessel"), cutoff=cutoff,
        cutoff_fn=kwargs.get("cutoff_fn", "cosine"))]
    for _ in range(kwargs.get("action_blocks", 3)):
        blocks.append(PainnMessage(node_dim=node_dim, num_basis=num_basis,
                                   activation=activation))
        blocks.append(PainnUpdate(node_dim=node_dim, activation=activation))
    heads, extra = _heads(kwargs.get("output_modes", ["energy"]), kwargs, node_dim,
                          kwargs.get("node_irreps", "128x0e + 64x1o + 32x2e"))
    return BlockStack(blocks + heads), extra, cutoff


def build_so3krates(**kwargs: Any) -> Tuple[BlockStack, List[str], float]:
    """SO3krates: XEmbedding with ``node_channel`` channels of every l up to
    ``max_l`` -> [Charge / SpinEmbedding] -> N x (EuclideanAttention,
    InteractionBlock) -> heads."""
    node_dim = kwargs.get("node_dim", 120)
    node_channel = kwargs.get("node_channel", 32)
    node_irreps = Irreps([(node_channel, (l, (-1) ** l))
                          for l in range(kwargs.get("max_l", 3) + 1)])
    num_basis = kwargs.get("num_basis", 20)
    cutoff = kwargs.get("cutoff", 5.0)
    activation = kwargs.get("activation", "silu")
    layer_norm = kwargs.get("layer_norm", False)
    blocks: List[nn.Module] = [XEmbedding(
        node_dim=node_dim, node_irreps=node_irreps,
        embed_basis=kwargs.get("embed_basis", "gfn2-xtb"),
        aux_basis=kwargs.get("aux_basis", "aux56"), num_basis=num_basis,
        rbf_kernel=kwargs.get("rbf_kernel", "bessel"), cutoff=cutoff,
        cutoff_fn=kwargs.get("cutoff_fn", "cosine"))]
    if kwargs.get("charge_embed", False):
        blocks.append(ChargeEmbedding(node_dim=node_dim, activation=activation))
    if kwargs.get("spin_embed", False):
        blocks.append(SpinEmbedding(node_dim=node_dim, activation=activation))
    for _ in range(kwargs.get("action_blocks", 3)):
        blocks.append(EuclideanAttention(
            node_irreps=node_irreps, node_dim=node_dim,
            num_heads=kwargs.get("num_heads", 4), num_basis=num_basis,
            activation=activation, layer_norm=layer_norm))
        blocks.append(InteractionBlock(node_irreps=node_irreps, node_dim=node_dim,
                                       activation=activation, layer_norm=layer_norm))
    heads, extra = _heads(kwargs.get("output_modes", ["energy"]),
                          dict(kwargs, node_irreps=node_irreps), node_dim, node_irreps)
    return BlockStack(blocks + heads), extra, cutoff


MODEL_BUILDERS = {
    "xpainn": build_xpainn,
    "xpainn-ewald": build_xpainn_ewald,
    "painn": build_painn,
    "so3krates": build_so3krates,
    "xmatnet": build_xmatnet,
}


def resolve_model(model_name: str, **kwargs: Any):
    name = model_name.lower()
    if name not in MODEL_BUILDERS:
        raise NotImplementedError(f"Unsupported model {model_name}")
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
