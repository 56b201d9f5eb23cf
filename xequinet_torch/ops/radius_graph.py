"""Cutoff radius graphs, with and without PBC.

Port of ``xequinet_tpu/ops/radius_graph.py``: the host searches (numpy;
the O(N) C++ cell lists of ``ops/native.py`` when ``g++`` builds them,
O(N^2) numpy otherwise) and the fixed-capacity device searches of the
free Calculator (``radius_graph_fixed``) and of the ``gmx`` export
(``radius_graph_pbc_fixed``), plain torch on the caller's device.  Convention: edge (center i, neighbor j) for every
ordered pair with 0 < |r_i - r_j - offset @ cell| < cutoff, so
vectors = pos[center] - pos[neighbor] - offsets @ cell.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def radius_graph_np(
    pos: np.ndarray, cutoff: float, use_native: bool = True
) -> Tuple[np.ndarray, np.ndarray]:
    """Non-PBC neighbour search on the host: C++ cell lists when the
    native library builds, O(N^2) numpy otherwise.  Returns (edge_index
    [2, E], cell_offsets [E, 3] zeros), edges sorted center-major."""
    pos = np.asarray(pos, dtype=np.float64)
    if use_native:
        from .native import radius_graph_native

        res = radius_graph_native(pos, cutoff)
        if res is not None:
            return res
    diff = pos[:, None, :] - pos[None, :, :]
    dist2 = np.einsum("ijk,ijk->ij", diff, diff)
    n = pos.shape[0]
    mask = (dist2 < cutoff * cutoff) & ~np.eye(n, dtype=bool)
    center, neighbor = np.nonzero(mask)
    edge_index = np.stack([center, neighbor]).astype(np.int64)
    return edge_index, np.zeros((edge_index.shape[1], 3), dtype=np.float64)


def _num_repeats(cell: np.ndarray, pbc: np.ndarray, cutoff: float) -> np.ndarray:
    """Cell replications per lattice direction: cutoff / plane distance."""
    vol = np.abs(np.linalg.det(cell))
    reps = np.zeros(3, dtype=np.int64)
    for k in range(3):
        i, j = (k + 1) % 3, (k + 2) % 3
        plane_d = vol / np.linalg.norm(np.cross(cell[i], cell[j]))
        reps[k] = int(np.ceil(cutoff / plane_d)) if pbc[k] else 0
    return reps


def wrap_positions(
    pos: np.ndarray, cell: np.ndarray, pbc: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """(wrapped, integer shifts) with pos = wrapped + shifts @ cell."""
    frac = pos @ np.linalg.inv(cell)
    shifts = np.floor(frac)
    shifts[:, ~pbc.astype(bool)] = 0.0
    wrapped = (frac - shifts) @ cell
    return wrapped, shifts.astype(np.int64)


def radius_graph_pbc_np(
    pos: np.ndarray, cell: np.ndarray, pbc: np.ndarray, cutoff: float,
    use_native: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """PBC neighbour search for one graph.  Returns (edge_index [2, E],
    cell_offsets [E, 3] ints) for the original (unwrapped) positions,
    center-major."""
    pos = np.asarray(pos, dtype=np.float64)
    cell = np.asarray(cell, dtype=np.float64).reshape(3, 3)
    pbc = np.asarray(pbc).reshape(3).astype(bool)
    if not pbc.any():
        return radius_graph_np(pos, cutoff, use_native)

    wrapped, wrap_shifts = wrap_positions(pos, cell, pbc)
    reps = _num_repeats(cell, pbc, cutoff)
    if use_native:
        from .native import radius_graph_pbc_native

        res = radius_graph_pbc_native(wrapped, cell, reps, cutoff)
        if res is not None:
            ei, cell_offsets = res
            center, neighbor = ei[0], ei[1]
            cell_offsets = cell_offsets + wrap_shifts[center] - wrap_shifts[neighbor]
            order = np.argsort(center, kind="stable")
            return np.stack([center[order], neighbor[order]]), cell_offsets[order]
    ranges = [np.arange(-r, r + 1) for r in reps]
    offsets = np.stack(np.meshgrid(*ranges, indexing="ij"), axis=-1).reshape(-1, 3)
    img_pos = wrapped[None, :, :] + (offsets @ cell)[:, None, :]
    edges_c, edges_n, edges_o = [], [], []
    c2 = cutoff * cutoff
    for a, off in enumerate(offsets):
        d = wrapped[:, None, :] - img_pos[a][None, :, :]
        mask = np.einsum("ijk,ijk->ij", d, d) < c2
        if (off == 0).all():
            np.fill_diagonal(mask, False)
        ci, ni = np.nonzero(mask)
        if ci.size:
            edges_c.append(ci)
            edges_n.append(ni)
            edges_o.append(np.broadcast_to(off, (ci.size, 3)))
    if not edges_c:
        return np.zeros((2, 0), dtype=np.int64), np.zeros((0, 3), dtype=np.int64)
    center = np.concatenate(edges_c)
    neighbor = np.concatenate(edges_n)
    # offsets apply to the original positions:
    # O' = O + wrap_shift_c - wrap_shift_n
    cell_offsets = (
        np.concatenate(edges_o).astype(np.int64)
        + wrap_shifts[center] - wrap_shifts[neighbor]
    )
    return np.stack([center, neighbor]), cell_offsets


def radius_graph_fixed(
    pos: torch.Tensor,
    cutoff: float,
    max_edges: int,
    node_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Non-PBC neighbour search on the device with a fixed edge capacity.

    Returns (edge_index [2, min(max_edges, N^2)] int32, edge_mask,
    n_edges_found []); overflow shows as n_edges_found > max_edges.
    O(N^2) masked distance matrix, for molecular sizes.  Real edges come
    in flat (center-major) order; padding edges point at the last node
    slot, so center indices stay sorted."""
    n = pos.shape[0]
    diff = pos[:, None, :] - pos[None, :, :]
    dist2 = (diff * diff).sum(-1)
    valid = (dist2 < cutoff * cutoff) & ~torch.eye(n, dtype=torch.bool, device=pos.device)
    if node_mask is not None:
        valid = valid & node_mask[:, None] & node_mask[None, :]
    flat = valid.reshape(-1)
    n_found = flat.sum(dtype=torch.int32)
    # stable sort of the negated mask puts the valid pairs first, in order
    order = torch.argsort((~flat).to(torch.int32), stable=True)[:max_edges]
    center = order // n
    neighbor = order % n
    edge_mask = flat.index_select(0, order)
    last = torch.full_like(center, n - 1)
    center = torch.where(edge_mask, center, last)
    neighbor = torch.where(edge_mask, neighbor, last)
    return torch.stack([center, neighbor]).to(torch.int32), edge_mask, n_found


def radius_graph_pbc_fixed(
    pos: torch.Tensor,
    cell: torch.Tensor,
    pbc: torch.Tensor,
    cutoff: float,
    max_edges: int,
    max_reps: int = 1,
    node_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Periodic neighbour search on the device with static capacities, the
    in-graph list of the ``gmx`` export (port of
    ``xequinet_tpu/ops/radius_graph.py:199``).

    The image grid is static, every offset in [-max_reps, max_reps]^3; an
    image is active where its offset is within the replication the cell
    needs (ceil(cutoff / plane distance) per periodic axis, 0 elsewhere).
    Images past the grid are not generated, so both overflows are
    returned: ``n_edges_found > max_edges`` and ``needed_reps > max_reps``.
    No data-dependent shape: the [N, N, n_img] mask is compacted by a
    stable sort of its negation.  Returns (edge_index [2, E] int32,
    edge_mask [E], cell_offsets [E, 3] in pos's dtype, n_edges_found [],
    needed_reps [3] int32) with E = min(max_edges, N^2 n_img), center-major;
    padding edges point at node N - 1."""
    n = pos.shape[0]
    vol = torch.linalg.det(cell).abs()
    crosses = torch.stack([torch.linalg.cross(cell[1], cell[2]),
                           torch.linalg.cross(cell[2], cell[0]),
                           torch.linalg.cross(cell[0], cell[1])])
    plane_d = vol / torch.linalg.vector_norm(crosses, dim=-1)
    needed = torch.where(pbc, torch.ceil(cutoff / plane_d).to(torch.int32),
                         torch.zeros(3, dtype=torch.int32, device=pos.device))

    r = np.arange(-max_reps, max_reps + 1)
    offsets = np.stack(np.meshgrid(r, r, r, indexing="ij"), axis=-1).reshape(-1, 3)
    n_img = offsets.shape[0]
    offsets_t = torch.as_tensor(offsets, dtype=torch.int32, device=pos.device)
    img_active = (offsets_t.abs() <= needed[None, :]).all(dim=-1)

    shift_vecs = offsets_t.to(pos.dtype) @ cell  # [n_img, 3]
    d = pos[:, None, None, :] - pos[None, :, None, :] - shift_vecs[None, None, :, :]
    dist2 = (d * d).sum(-1)
    valid = (dist2 < cutoff * cutoff) & (dist2 > 1e-8) & img_active[None, None, :]
    if node_mask is not None:
        valid = valid & node_mask[:, None, None] & node_mask[None, :, None]
    flat = valid.reshape(-1)
    n_found = flat.sum(dtype=torch.int32)
    order = torch.argsort((~flat).to(torch.int32), stable=True)[:max_edges]
    center = order // (n * n_img)
    rem = order % (n * n_img)
    neighbor = rem // n_img
    img = rem % n_img
    edge_mask = flat.index_select(0, order)
    last = torch.full_like(center, n - 1)
    center = torch.where(edge_mask, center, last)
    neighbor = torch.where(edge_mask, neighbor, last)
    cell_offsets = torch.where(edge_mask[:, None], offsets_t.index_select(0, img),
                               torch.zeros_like(offsets_t[:1])).to(pos.dtype)
    return (torch.stack([center, neighbor]).to(torch.int32), edge_mask, cell_offsets,
            n_found, needed)
