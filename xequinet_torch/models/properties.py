"""Edge-data preprocessing and autodiff properties (forces / virial).

Port of ``xequinet_tpu/models/properties.py:25-166``.  The model forward
is a function of (positions, strain); forces and virial are minus the
gradients of the masked total energy, taken with ``torch.autograd.grad``,
including the strain trick (a symmetrized per-graph strain applied to
positions and cell).  Padding edges give exactly zero vectors and
lengths, with NaN-safe gradients through the double-where guard.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from .. import keys

DataDict = Dict[str, torch.Tensor]


def compute_edge_data(data: DataDict, strain: Optional[torch.Tensor] = None) -> DataDict:
    """Edge vectors / lengths (+ the strain) from positions."""
    data = dict(data)
    if keys.GHOST_MAP in data:
        raise NotImplementedError("periodic ghost rows are not ported yet")
    pos = data[keys.POSITIONS]
    center_idx = data[keys.EDGE_INDEX][keys.CENTER_IDX].long()
    neighbor_idx = data[keys.EDGE_INDEX][keys.NEIGHBOR_IDX].long()
    edge_mask = data[keys.EDGE_MASK]
    batch = data[keys.BATCH].long()
    has_cell = keys.CELL in data
    cell = data.get(keys.CELL)

    if strain is not None:
        symm_strain = 0.5 * (strain + strain.transpose(-1, -2))  # [G,3,3]
        pos = pos + torch.einsum("ni,nij->nj", pos, symm_strain.index_select(0, batch))
        if has_cell:
            cell = cell + torch.einsum("gij,gjk->gik", cell, symm_strain)
        data[keys.STRAIN] = strain
    data[keys.POSITIONS] = pos
    if has_cell:
        data[keys.CELL] = cell

    # index_select, not pos[idx]: the backward of advanced indexing sorts
    # the edge indices (12.8 ms per forward+forces at the flagship batch
    # on an H100, PERF.md); index_select's backward is an index_add
    vectors = pos.index_select(0, center_idx) - pos.index_select(0, neighbor_idx)
    if has_cell:
        cell_offsets = data[keys.CELL_OFFSETS].to(pos.dtype)
        cell_per_edge = cell.index_select(0, batch.index_select(0, neighbor_idx))
        vectors = vectors - torch.einsum("ni,nij->nj", cell_offsets, cell_per_edge)

    mask = edge_mask[:, None]
    vectors = torch.where(mask, vectors, torch.zeros_like(vectors))
    safe_vec = torch.where(mask, vectors, torch.ones_like(vectors))
    dist = torch.linalg.norm(safe_vec, dim=-1)
    dist = torch.where(edge_mask, dist, torch.zeros_like(dist))

    if keys.EDGE_CUTOFF in data:
        rc = data[keys.EDGE_CUTOFF].reshape(()).to(dist.dtype)
        data[keys.EDGE_MASK] = edge_mask & (dist <= rc)

    data[keys.EDGE_VECTOR] = vectors
    data[keys.EDGE_LENGTH] = dist
    return data


def make_forward(
    apply_fn: Callable[[DataDict], DataDict],
    extra_properties: Optional[List[str]] = None,
    create_graph: bool = False,
):
    """``forward(data, compute_forces, compute_virial) -> out``.

    ``apply_fn`` runs the blocks (embedding through heads) and writes
    TOTAL_ENERGY.  With ``create_graph=False`` (inference) the gradients
    are first order only and the outputs come back detached."""

    def forward(data: DataDict, compute_forces: bool = True,
                compute_virial: bool = False) -> DataDict:
        pos = data[keys.POSITIONS]
        if not (compute_forces or compute_virial):
            out = apply_fn(compute_edge_data(dict(data), None))
        else:
            n_graphs = data[keys.GRAPH_MASK].shape[0]
            with torch.enable_grad():
                pos_in = pos if (create_graph and pos.requires_grad) else \
                    pos.detach().requires_grad_(True)
                strain = None
                if compute_virial:
                    strain = torch.zeros((n_graphs, 3, 3), dtype=pos.dtype,
                                         device=pos.device, requires_grad=True)
                d = dict(data)
                d[keys.POSITIONS] = pos_in
                out = apply_fn(compute_edge_data(d, strain))
                energy = out[keys.TOTAL_ENERGY]
                total = torch.where(data[keys.GRAPH_MASK], energy,
                                    torch.zeros_like(energy)).sum()
                wrt = ([pos_in] if compute_forces else []) + \
                    ([strain] if compute_virial else [])
                grads = torch.autograd.grad(total, wrt, create_graph=create_graph)
            if compute_forces:
                out[keys.FORCES] = -grads[0]
            if compute_virial:
                out[keys.VIRIAL] = -grads[-1]
        if not create_graph:
            out = {k: (v.detach() if torch.is_tensor(v) else v) for k, v in out.items()}
        return out

    return forward
