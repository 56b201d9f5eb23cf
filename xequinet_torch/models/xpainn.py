"""XPaiNN blocks: embedding, message, update.

Port of ``xequinet_tpu/models/xpainn.py:31-422``.  Each block maps the
blackboard dict -> dict.  Submodules keep flax's automatic names
(``Dense_0``, ``LayerNorm_0``, ...) so that ``convert.params_from_flax``
maps a JAX parameter tree onto them one to one.

``XPainnMessage`` has three routes: the plain route (``use_pallas=False``,
xpainn.py:169-262); the v2 route (``True`` / ``"v2"``, xpainn.py:172-230),
whose equivariant-state aggregate goes through
``ops.gather_scatter_v2`` (a CUDA kernel on the card); and the mega route
(``"mega"``, xpainn.py:264-352) through ``ops.fused_message``, whose
forward, first-order and second-order backward are CUDA kernels on the
card.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from .. import keys
from ..ops.fused_message import F_PACK, build_slot_plan, fused_message, pack_edge_features
from ..ops.gather_scatter_v2 import fused_gather_scale_scatter
from ..ops.irreps import Irreps
from ..ops.o3ops import equivariant_dot, invariant, scalar_gate
from ..ops.scatter import _HALO_SPEC, halo_refresh, segment_sum
from ..ops.slot_layout import window_size
from ..ops.spherical import spherical_harmonics
from .basic import AtomEmbedding, Dense, LayerNorm, resolve_activation
from .o3layer import EquivariantLayerNorm, O3Linear, bf16_product
from .rbf import resolve_cutoff, resolve_rbf
from .remat import edge_agg

DataDict = Dict[str, torch.Tensor]

# per-batch CSR slot plan of the message kernels, built by the first
# message block and reused by the others (not a user-facing key)
SLOT_PLAN = "k_slot_plan"


def _pad128(n: int) -> int:
    return ((n + 127) // 128) * 128


class XEmbedding(nn.Module):
    """Node embedding (trainable one-hot table, or the fixed per-element
    table of ``embed_basis`` / ``aux_basis`` followed by a Dense) + edge
    basis: NODE_INVARIANT, RADIAL_BASIS_FUNCTION,
    ENVELOPE_FUNCTION, SPHERICAL_HARMONICS ([x,y,z] -> [y,z,x]), zero
    NODE_EQUIVARIANT and, for the mega route, the packed K_EDGE_FEAT."""

    def __init__(self, node_dim: int = 128, node_irreps="128x0e+64x1o+32x2e",
                 embed_basis: str = "gfn2-xtb", aux_basis: str = "aux56",
                 num_basis: int = 20, rbf_kernel: str = "bessel",
                 cutoff: float = 5.0, cutoff_fn: str = "cosine",
                 pack_edge_features: bool = False):
        super().__init__()
        embed_table = None
        if embed_basis != "one-hot":
            from ..utils.qc import get_embedding_table

            embed_table = get_embedding_table(embed_basis, aux_basis)
        self.irreps = Irreps(node_irreps)
        self.AtomEmbedding_0 = AtomEmbedding(node_dim, embed_table)
        rbf = resolve_rbf(rbf_kernel, num_basis, cutoff)
        self.rbf_name = f"{type(rbf).__name__}_0"  # flax's name of the basis
        self.add_module(self.rbf_name, rbf)
        self.cutoff_fn = resolve_cutoff(cutoff_fn, cutoff)
        self.pack = pack_edge_features

    def forward(self, data: DataDict) -> DataDict:
        node_invariant = self.AtomEmbedding_0(data[keys.ATOMIC_NUMBERS])
        data[keys.NODE_INVARIANT] = node_invariant
        distances = data[keys.EDGE_LENGTH][..., None]
        rbf = getattr(self, self.rbf_name)(distances)
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

    ``use_pallas``: False (plain route), True / "v2" (the equivariant-state
    gather and scatter through the v2 kernel) or "mega" (fused message
    kernels); the kernel routes need a batch collated with the kernel
    layout.  "mega-xb" (mega forward, plain backward) serves as "mega":
    the backward kernel computes the same VJP."""

    def __init__(self, node_dim: int = 128, node_irreps="128x0e+64x1o+32x2e",
                 num_basis: int = 20, activation: str = "silu",
                 layer_norm: bool = True, compute_dtype: str = "float32",
                 use_pallas=False, pallas_layout=(256, 1024, 32, 8)):
        super().__init__()
        if use_pallas not in (False, None, True, "v2", "mega", "mega-xb"):
            raise ValueError(f"unknown use_pallas {use_pallas!r}")
        self.irreps = Irreps(node_irreps)
        self.node_dim = node_dim
        self.num_basis = num_basis
        self.cdtype = getattr(torch, compute_dtype)
        self.use_v2 = use_pallas is True or use_pallas == "v2"
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
            # periodic ghost rows: refreshed from the owning atom's state
            # before any source gather (the update blocks leave them
            # stale).  The map is the identity on real rows, and the
            # gather's backward carries the ghosts' gradients to the owners.
            gm = data[keys.GHOST_MAP].long()
            data[keys.NODE_INVARIANT] = data[keys.NODE_INVARIANT].index_select(0, gm)
            data[keys.NODE_EQUIVARIANT] = data[keys.NODE_EQUIVARIANT].index_select(0, gm)
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
        elif self.use_v2 and keys.K_SRC2 in data:
            agg = self._v2_path(data, scalar_out, node_equi, center_idx,
                                neighbor_idx, n_nodes)
        elif (self.use_mega or self.use_v2) and node_scalar.device.type != "cpu":
            route = "mega" if self.use_mega else "v2"
            raise ValueError(
                f"the {route} message route needs a batch collated with the kernel "
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
        # named for the remat policy "save_edge_agg" (xpainn.py:248-250)
        return edge_agg(segment_sum(message_cat, center_idx, n_nodes, data[keys.EDGE_MASK],
                                    scope="edges"))

    def _slot_plan(self, data, slot_meta, n_nodes):
        """The batch's CSR slot plan, built by the first kernel-route block
        on the card and reused by the others."""
        if SLOT_PLAN not in data:
            bn, chunk = self.pallas_layout[:2]
            data[SLOT_PLAN] = build_slot_plan(slot_meta, n_nodes, n_nodes, bn, chunk)
        return data[SLOT_PLAN]

    def _v2_path(self, data, scalar_out, node_equi, center_idx, neighbor_idx, n_nodes):
        """xpainn.py:172-230 with the kernel: only the scalars are gathered
        here; the equivariant-state message sum_e x_eq[src] * g1exp goes
        through the v2 op in f32 (the JAX module casts both operands to f32
        there, xpainn.py:214, :227, also in bf16 mode), and its aggregate is
        added to the segment sum of the scalar and harmonic messages.  The
        feature axis is not padded to 128 (a TPU tiling constraint)."""
        if _HALO_SPEC.get() is not None:
            raise ValueError(
                "the v2 kernel route is not halo-aware (as in the JAX package, "
                "parallel/halo.py:955-958): under halo decomposition use the mega route "
                "or the plain route")
        ni = self.irreps.num_irreps
        cd = self.cdtype
        edge_mask = data[keys.EDGE_MASK]
        rsh = data[keys.SPHERICAL_HARMONICS].to(cd)
        filter_weight = self.Dense_2(data[keys.RADIAL_BASIS_FUNCTION]) * \
            data[keys.ENVELOPE_FUNCTION].to(cd)
        filter_out = scalar_out.index_select(0, neighbor_idx.long()) * filter_weight
        gate_state = filter_out[..., :ni]
        g1exp = scalar_gate(torch.ones((gate_state.shape[0], self.irreps.dim),
                                       dtype=gate_state.dtype, device=gate_state.device),
                            gate_state, self.irreps)
        g1exp = torch.where(edge_mask[:, None], g1exp,
                            torch.zeros((), dtype=g1exp.dtype, device=g1exp.device))
        bn, chunk, pad_nodes, max_chunks = self.pallas_layout
        slot_meta = (data[keys.K_SRC2], data[keys.K_DST2], center_idx,
                     data[keys.K_CHUNK_BASE], data[keys.K_NCHUNKS], data[keys.K_WSTARTS])
        if node_equi.is_cuda:
            plan = self._slot_plan(data, slot_meta[:2] + (neighbor_idx,) + slot_meta[2:],
                                   n_nodes)
            slot_meta = slot_meta + (plan,)
        equi_state_agg = fused_gather_scale_scatter(
            node_equi.float(), g1exp.float(), neighbor_idx, slot_meta, n_nodes, bn, chunk,
            window_size(bn, pad_nodes), max_chunks,
        )
        message_equi = scalar_gate(rsh, filter_out[..., ni : 2 * ni], self.irreps)
        message_cat = torch.cat([filter_out[..., 2 * ni :], message_equi], dim=-1)
        agg = edge_agg(segment_sum(message_cat, center_idx, n_nodes, edge_mask))
        agg = agg.to(data[keys.NODE_INVARIANT].dtype)
        return torch.cat([agg[..., : self.node_dim],
                          agg[..., self.node_dim :] + equi_state_agg.to(agg.dtype)], dim=-1)

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
            slot_meta = slot_meta + (self._slot_plan(data, slot_meta, n_nodes),)
        mm = "bfloat16" if cd == torch.bfloat16 else "float32"
        agg_full = fused_message(
            x_cat, data[keys.K_EDGE_FEAT], wf_aug, slot_meta, data[keys.EDGE_MASK],
            str(self.irreps), nb, self.node_dim, n_nodes, bn, chunk, window,
            max_chunks, mm, True,
        )
        agg = torch.cat([agg_full[:, : self.node_dim], agg_full[:, sdp : sdp + dim]], dim=-1)
        # under halo decomposition the kernels' edges all end on owned rows,
        # so the window's halo rows come out zero: refresh them from the
        # neighbouring ranks, outside FusedMessage, so that the halo
        # cotangents go back through the exchange and the kernels' backward
        # stays as it is (xpainn.py:333-343)
        spec = _HALO_SPEC.get()
        return edge_agg(agg if spec is None else halo_refresh(agg, spec))


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
