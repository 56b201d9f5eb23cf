"""Host-side (numpy) cutoff radius graphs, with and without PBC.

Port of the numpy branch of ``xequinet_tpu/ops/radius_graph.py:33-157``
(the native C++ cell-list builder is a later item).  Convention: edge
(center i, neighbor j) for every ordered pair with
0 < |r_i - r_j - offset @ cell| < cutoff, so
vectors = pos[center] - pos[neighbor] - offsets @ cell.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def radius_graph_np(pos: np.ndarray, cutoff: float) -> Tuple[np.ndarray, np.ndarray]:
    """O(N^2) non-PBC neighbour search.  Returns (edge_index [2, E],
    cell_offsets [E, 3] zeros), edges sorted center-major."""
    pos = np.asarray(pos, dtype=np.float64)
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
    pos: np.ndarray, cell: np.ndarray, pbc: np.ndarray, cutoff: float
) -> Tuple[np.ndarray, np.ndarray]:
    """PBC neighbour search for one graph.  Returns (edge_index [2, E],
    cell_offsets [E, 3] ints) for the original (unwrapped) positions."""
    pos = np.asarray(pos, dtype=np.float64)
    cell = np.asarray(cell, dtype=np.float64).reshape(3, 3)
    pbc = np.asarray(pbc).reshape(3).astype(bool)
    if not pbc.any():
        return radius_graph_np(pos, cutoff)

    wrapped, wrap_shifts = wrap_positions(pos, cell, pbc)
    reps = _num_repeats(cell, pbc, cutoff)
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
