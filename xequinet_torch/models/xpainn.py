"""XPaiNN blocks: embedding, message, update.

Port of ``xequinet_tpu/models/xpainn.py:31-422``.  Each block maps the
blackboard dict -> dict.  Submodules keep flax's automatic names
(``Dense_0``, ``LayerNorm_0``, ...) so that ``convert.params_from_flax``
maps a JAX parameter tree onto them one to one.

``XPainnMessage`` has two routes: the plain route (``use_pallas=False``,
xpainn.py:169-262) and the mega route (``"mega"``, xpainn.py:264-352)
through ``ops.fused_message``, whose forward and first-order backward are
CUDA kernels on the card.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from .. import keys
from ..ops.fused_message import F_PACK, build_slot_plan, fused_message, pack_edge_features
from ..ops.irreps import Irreps
from ..ops.o3ops import equivariant_dot, invariant, scalar_gate
from ..ops.scatter import segment_sum
from ..ops.slot_layout import window_size
from ..ops.spherical import spherical_harmonics
from .basic import AtomEmbedding, Dense, LayerNorm, resolve_activation
from .o3layer import EquivariantLayerNorm, O3Linear, bf16_product
from .rbf import resolve_cutoff, resolve_rbf

DataDict = Dict[str, torch.Tensor]

# per-batch CSR slot plan of the message kernels, built by the first
# message block and reused by the others (not a user-facing key)
SLOT_PLAN = "k_slot_plan"


def _pad128(n: int) -> int:
    return ((n + 127) // 128) * 128


class XEmbedding(nn.Module):
    """Node embedding + edge basis: NODE_INVARIANT, RADIAL_BASIS_FUNCTION,
    ENVELOPE_FUNCTION, SPHERICAL_HARMONICS ([x,y,z] -> [y,z,x]), zero
    NODE_EQUIVARIANT and, for the mega route, the packed K_EDGE_FEAT."""

    def __init__(self, node_dim: int = 128, node_irreps="128x0e+64x1o+32x2e",
                 embed_basis: str = "gfn2-xtb", aux_basis: str = "aux56",
                 num_basis: int = 20, rbf_kernel: str = "bessel",
                 cutoff: float = 5.0, cutoff_fn: str = "cosine",
                 pack_edge_features: bool = False):
        super().__init__()
        if embed_basis != "one-hot":
            raise NotImplementedError(
                f"embed_basis {embed_basis!r} needs the element tables of "
                "utils/qc.py, not ported yet; use 'one-hot'"
            )
        self.irreps = Irreps(node_irreps)
        self.AtomEmbedding_0 = AtomEmbedding(node_dim)
        self.SphericalBesselj0_0 = resolve_rbf(rbf_kernel, num_basis, cutoff)
        self.cutoff_fn = resolve_cutoff(cutoff_fn, cutoff)
        self.pack = pack_edge_features

    def forward(self, data: DataDict) -> DataDict:
        node_invariant = self.AtomEmbedding_0(data[keys.ATOMIC_NUMBERS])
        data[keys.NODE_INVARIANT] = node_invariant
        distances = data[keys.EDGE_LENGTH][..., None]
        rbf = self.SphericalBesselj0_0(distances)
        fcut = self.cutoff_fn(distances)
        data[keys.RADIAL_BASIS_FUNCTION] = rbf
        data[keys.ENVELOPE_FUNCTION] = fcut
        vec_irrep = data[keys.EDGE_VECTOR].roll(-1, dims=-1)  # [y, z, x]
        mega = self.pack and keys.K_SRC2 in data
        if not mega:
            data[keys.SPHERICAL_HARMONICS] = spherical_harmonics(
                self.irreps, vec_irrep, normalize=True
            )
        data[keys.NODE_EQUIVARIANT] = torch.zeros(
            (node_invariant.shape[0], self.irreps.dim),
            dtype=node_invariant.dtype, device=node_invariant.device,
        )
        if self.pack:
            data[keys.K_EDGE_FEAT] = pack_edge_features(rbf, fcut, vec_irrep, self.irreps)
        return data


class XPainnMessage(nn.Module):
    """Message block.  ``compute_dtype="bfloat16"`` runs the per-edge
    pipeline in bf16 (parameters, LayerNorm and the residual stay f32).

    ``use_pallas``: False (plain route) or "mega" (fused message kernels;
    needs a batch collated with the kernel layout).  "mega-xb" (mega
    forward, plain backward) serves as "mega": the backward kernel
    computes the same VJP.  The v2 route (True / "v2") is ROADMAP queue 2
    item 4 and raises."""

    def __init__(self, node_dim: int = 128, node_irreps="128x0e+64x1o+32x2e",
                 num_basis: int = 20, activation: str = "silu",
                 layer_norm: bool = True, compute_dtype: str = "float32",
                 use_pallas=False, pallas_layout=(256, 1024, 32, 8)):
        super().__init__()
        if use_pallas is True or use_pallas == "v2":
            raise NotImplementedError(
                "the v2 scatter-kernel route (use_pallas_scatter=True) is not "
                "ported yet (ROADMAP queue 2 item 4); use False or 'mega'"
            )
        if use_pallas not in (False, None, "mega", "mega-xb"):
            raise ValueError(f"unknown use_pallas {use_pallas!r}")
        self.irreps = Irreps(node_irreps)
        self.node_dim = node_dim
        self.num_basis = num_basis
        self.cdtype = getattr(torch, compute_dtype)
        self.use_mega = use_pallas in ("mega", "mega-xb")
        self.pallas_layout = tuple(pallas_layout)
        self.act = resolve_activation(activation)
        self.layer_norm = layer_norm
        ni = self.irreps.num_irreps
        hidden = node_dim + 2 * ni
        self.hidden_dim = hidden
        if layer_norm:
            self.LayerNorm_0 = LayerNorm(node_dim)
            self.EquivariantLayerNorm_0 = EquivariantLayerNorm(self.irreps)
        self.Dense_0 = Dense(node_dim, node_dim, compute_dtype=compute_dtype)
        self.Dense_1 = Dense(node_dim, hidden, compute_dtype=compute_dtype)
        self.Dense_2 = Dense(num_basis, hidden, compute_dtype=compute_dtype)

    def forward(self, data: DataDict) -> DataDict:
        if keys.GHOST_MAP in data:
            raise NotImplementedError("periodic ghost rows are not ported yet")
        node_scalar = data[keys.NODE_INVARIANT]
        node_equi = data[keys.NODE_EQUIVARIANT]
        if self.layer_norm:
            node_scalar = self.LayerNorm_0(node_scalar)
            node_equi = self.EquivariantLayerNorm_0(node_equi)
        cd = self.cdtype
        h = self.act(self.Dense_0(node_scalar))
        scalar_out = self.Dense_1(h)
        node_equi = node_equi.to(cd)
        center_idx = data[keys.EDGE_INDEX][keys.CENTER_IDX]
        neighbor_idx = data[keys.EDGE_INDEX][keys.NEIGHBOR_IDX]
        n_nodes = node_scalar.shape[0]

        if self.use_mega and keys.K_SRC2 in data and keys.K_EDGE_FEAT in data:
            agg = self._mega_path(data, scalar_out, node_equi, center_idx,
                                  neighbor_idx, n_nodes)
        elif self.use_mega and node_scalar.device.type != "cpu":
            raise ValueError(
                "the mega message route needs a batch collated with the kernel "
                "slot layout on the card (the plain route does not stand in for "
                "the kernels there); collate with kernel_layout=..."
            )
        else:
            agg = self._plain_path(data, scalar_out, node_equi, center_idx,
                                   neighbor_idx, n_nodes)
        agg = agg.to(data[keys.NODE_INVARIANT].dtype)
        data[keys.NODE_INVARIANT] = data[keys.NODE_INVARIANT] + agg[..., : self.node_dim]
        data[keys.NODE_EQUIVARIANT] = data[keys.NODE_EQUIVARIANT] + agg[..., self.node_dim :]
        return data

    def _plain_path(self, data, scalar_out, node_equi, center_idx, neighbor_idx,
                    n_nodes):
        """xpainn.py:169-262 without the v2 kernel."""
        ni = self.irreps.num_irreps
        cd = self.cdtype
        rsh = data[keys.SPHERICAL_HARMONICS].to(cd)
        filter_weight = self.Dense_2(data[keys.RADIAL_BASIS_FUNCTION]) * \
            data[keys.ENVELOPE_FUNCTION].to(cd)
        src_cat = torch.cat([scalar_out, node_equi], dim=-1)
        gathered = src_cat[neighbor_idx.long()]
        filter_out = gathered[..., : self.hidden_dim] * filter_weight
        neighbor_equi = gathered[..., self.hidden_dim :]
        message_equi = scalar_gate(neighbor_equi, filter_out[..., :ni], self.irreps) + \
            scalar_gate(rsh, filter_out[..., ni : 2 * ni], self.irreps)
        message_cat = torch.cat([filter_out[..., 2 * ni :], message_equi], dim=-1)
        return segment_sum(message_cat, center_idx, n_nodes, data[keys.EDGE_MASK])

    def _mega_path(self, data, scalar_out, node_equi, center_idx, neighbor_idx,
                   n_nodes):
        """xpainn.py:264-352.  ``wf_aug`` is probed out of the filter Dense
        with ``[eye; 0]`` in the compute dtype, as the JAX module does: in
        bf16 its rows are bf16(bf16(W + b) - b), not W."""
        hidden, dim, nb = self.hidden_dim, self.irreps.dim, self.num_basis
        hp, dp, sdp = _pad128(hidden), _pad128(dim), _pad128(self.node_dim)
        dev = scalar_out.device
        cd = self.cdtype
        probe_in = torch.cat([torch.eye(nb, device=dev), torch.zeros(1, nb, device=dev)]).to(cd)
        probe = self.Dense_2(probe_in)
        bias = probe[-1]
        wf_aug = torch.cat([probe[:-1] - bias[None, :], bias[None, :]])
        wf_aug = nn.functional.pad(
            wf_aug.float(), (0, hp - hidden, 0, F_PACK - wf_aug.shape[0])
        )
        x_cat = torch.cat([
            nn.functional.pad(scalar_out.float(), (0, hp - hidden)),
            nn.functional.pad(node_equi.float(), (0, dp - dim)),
        ], dim=-1)
        bn, chunk, pad_nodes, max_chunks = self.pallas_layout
        window = window_size(bn, pad_nodes)
        slot_meta = (
            data[keys.K_SRC2], data[keys.K_DST2], neighbor_idx, center_idx,
            data[keys.K_CHUNK_BASE], data[keys.K_NCHUNKS], data[keys.K_WSTARTS],
        )
        if x_cat.is_cuda:
            if SLOT_PLAN not in data:
                data[SLOT_PLAN] = build_slot_plan(slot_meta, n_nodes, n_nodes, bn, chunk)
            slot_meta = slot_meta + (data[SLOT_PLAN],)
        mm = "bfloat16" if cd == torch.bfloat16 else "float32"
        agg_full = fused_message(
            x_cat, data[keys.K_EDGE_FEAT], wf_aug, slot_meta, data[keys.EDGE_MASK],
            str(self.irreps), nb, self.node_dim, n_nodes, bn, chunk, window,
            max_chunks, mm, True,
        )
        return torch.cat(
            [agg_full[:, : self.node_dim], agg_full[:, sdp : sdp + dim]], dim=-1
        )


class XPainnUpdate(nn.Module):
    """Update block; U and V share one [N, dim] @ [dim, 2 dim] product."""

    def __init__(self, node_dim: int = 128, node_irreps="128x0e+64x1o+32x2e",
                 activation: str = "silu", layer_norm: bool = True,
                 compute_dtype: str = "float32"):
        super().__init__()
        self.irreps = Irreps(node_irreps)
        self.node_dim = node_dim
        self.cdtype = getattr(torch, compute_dtype)
        self.act = resolve_activation(activation)
        self.layer_norm = layer_norm
        ni = self.irreps.num_irreps
        mix = compute_dtype if self.cdtype != torch.float32 else None
        if layer_norm:
            self.LayerNorm_0 = LayerNorm(node_dim)
            self.EquivariantLayerNorm_0 = EquivariantLayerNorm(self.irreps)
        self.O3Linear_0 = O3Linear(self.irreps, self.irreps, biases=True, compute_dtype=mix)
        self.O3Linear_1 = O3Linear(self.irreps, self.irreps, biases=True, compute_dtype=mix)
        self.Dense_0 = Dense(node_dim + ni, node_dim, compute_dtype=compute_dtype)
        self.Dense_1 = Dense(node_dim, 2 * node_dim + ni, compute_dtype=compute_dtype)
        self.Dense_2 = Dense(ni, node_dim, bias=False)

    def forward(self, data: DataDict) -> DataDict:
        ni, dim = self.irreps.num_irreps, self.irreps.dim
        node_scalar = data[keys.NODE_INVARIANT]
        node_equi = data[keys.NODE_EQUIVARIANT]
        if self.layer_norm:
            node_scalar = self.LayerNorm_0(node_scalar)
            node_equi = self.EquivariantLayerNorm_0(node_equi)
        w_u, b_u = self.O3Linear_0.block()
        w_v, b_v = self.O3Linear_1.block()
        w_uv = torch.cat([w_u, w_v], dim=-1)
        if self.cdtype != torch.float32:
            uv = bf16_product(node_equi, w_uv)
        else:
            uv = node_equi @ w_uv
        u_equi = uv[..., :dim] + (0.0 if b_u is None else b_u)
        v_equi = uv[..., dim:] + (0.0 if b_v is None else b_v)
        v_scalar = invariant(v_equi, self.irreps)
        mlp_in = torch.cat([node_scalar, v_scalar], dim=-1).to(self.cdtype)
        mlp_out = self.Dense_1(self.act(self.Dense_0(mlp_in))).float()
        a_vv = mlp_out[..., :ni]
        a_sv = mlp_out[..., ni : ni + self.node_dim]
        a_ss = mlp_out[..., ni + self.node_dim :]
        d_equi = scalar_gate(u_equi, a_vv, self.irreps)
        inner = self.Dense_2(equivariant_dot(u_equi, v_equi, self.irreps))
        data[keys.NODE_INVARIANT] = data[keys.NODE_INVARIANT] + a_sv * inner + a_ss
        data[keys.NODE_EQUIVARIANT] = data[keys.NODE_EQUIVARIANT] + d_equi
        return data
