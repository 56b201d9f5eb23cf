"""Spatial ordering, index-reach estimation and periodic ghost layouts.

Copy of ``xequinet_tpu/ops/spatial_sort.py`` (numpy, host only).  The
fused message kernels' slot layout (``data/batching._apply_kernel_layout``)
needs every edge's source within a bounded window of its destination's
index.  After sorting atoms along a spatial direction that holds for a
free system; for a PERIODIC one a wrapped edge connects opposite ends of
the sorted order, and ``ghost_layout_pbc`` restores the band with ghost
images: atoms within a cutoff slab of a periodic boundary are duplicated
at their shifted image coordinate along the sort axis, the extended node
list is sorted by *effective* fractional coordinate, and wrapped edges
are remapped to the ghost rows.  Ghosts carry (``ghost_map`` -> owning
real row, ``ghost_shift`` -> integer lattice offset); the model derives
their positions and states (models/properties.compute_edge_data,
models/xpainn.XPainnMessage), so forces and the strain-trick virial on
real atoms stay exact.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def sort_axis_free(positions: np.ndarray) -> int:
    """Longest bounding-box Cartesian axis of a free (non-PBC) system."""
    return int(np.argmax(positions.max(0) - positions.min(0)))


def spatial_sort_free(positions: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(perm, rank): stable sort along the longest bounding-box axis.
    ``perm`` maps sorted slot -> original index; ``rank`` the inverse."""
    axis = sort_axis_free(positions)
    perm = np.argsort(positions[:, axis], kind="stable")
    rank = np.empty(len(perm), dtype=np.int64)
    rank[perm] = np.arange(len(perm))
    return perm, rank


def index_reach(dst_rank: np.ndarray, src_rank: np.ndarray) -> int:
    """Max |sorted-index distance| over the edge set (0 when empty)."""
    if len(dst_rank) == 0:
        return 0
    return int(np.abs(np.asarray(dst_rank) - np.asarray(src_rank)).max())


def sort_axis_pbc(
    cell: np.ndarray, pbc: np.ndarray, positions: np.ndarray = None
) -> int:
    """The cell axis with the largest spatial extent — slab population
    along it is smallest, minimizing index reach.

    Periodic axes score their perpendicular height.  Aperiodic axes
    score the ACTUAL extent of ``positions`` projected on the height
    direction (a quasi-1D periodic chain in a wide aperiodic box must
    sort along the chain, not the box, or the reach is O(N)); when
    positions are not given they score the cell height with a mild
    preference (no wrap edges along an aperiodic sort axis)."""
    cell = np.asarray(cell, dtype=float)
    inv_t = np.linalg.inv(cell).T  # rows = reciprocal vectors (no 2pi)
    heights = 1.0 / np.linalg.norm(inv_t, axis=1)  # perpendicular heights
    pbc = np.asarray(pbc, dtype=bool)
    if not (~pbc).any():
        return int(np.argmax(heights))
    if positions is None:
        score = np.where(pbc, heights, heights * 1.5)
    else:
        pos = np.asarray(positions, dtype=float)
        # extent along each height direction (unit reciprocal vectors)
        units = inv_t * heights[:, None]
        proj = pos @ units.T  # [n, 3]
        extent = proj.max(0) - proj.min(0) if len(pos) else heights
        # aperiodic: true occupied extent; ties toward aperiodic (no
        # wrap edges) by a small factor
        score = np.where(pbc, heights, np.maximum(extent, 1e-9) * 1.1)
    return int(np.argmax(score))


def ghost_layout_pbc(
    positions: np.ndarray,
    cell: np.ndarray,
    pbc: np.ndarray,
    edge_index: np.ndarray,  # [2, E] (dst, src) into the real atoms
    cell_offsets: np.ndarray,  # [E, 3] integer image offsets of src
) -> Dict[str, np.ndarray]:
    """Plan a ghost-extended sorted node layout for a periodic system.

    Returns a dict with:
      ``axis``        sort axis (lattice direction index)
      ``perm``        [n] original real index per sorted-real slot
      ``real_rank``   [n] extended slot of each original real atom
      ``n_ghosts``    number of ghost rows
      ``ext_real``    [n_ext] owning real index per extended sorted slot
      ``ext_shift``   [n_ext, 3] integer lattice shift per extended slot
      ``is_ghost``    [n_ext] bool
      ``dst_ext``     [E] destination rows (always real slots)
      ``src_ext``     [E] source rows (real or ghost slots)
      ``res_offsets`` [E, 3] residual image offsets (sort-axis component
                      moved into the ghost shift)
      ``reach``       max |dst_ext - src_ext|

    The extended order is by effective fractional coordinate along the
    sort axis, so the reach is bounded by the population of a
    cutoff-thick slab — the same contract as the free-system sort.
    """
    pos = np.asarray(positions, dtype=float)
    cell = np.asarray(cell, dtype=float)
    ei = np.asarray(edge_index)
    offs = np.asarray(cell_offsets)
    n = len(pos)
    axis = sort_axis_pbc(cell, pbc)

    frac = pos @ np.linalg.inv(cell)  # rows: pos = frac @ cell
    fa = frac[:, axis]

    o_a = np.round(offs[:, axis]).astype(np.int64)
    # ghost inventory: unique (src, o_a != 0) pairs
    wrapped = o_a != 0
    if wrapped.any():
        pairs = np.stack([ei[1][wrapped], o_a[wrapped]], axis=1)
        ghosts = np.unique(pairs, axis=0)  # [n_g, 2] sorted rows
    else:
        ghosts = np.zeros((0, 2), dtype=np.int64)
    n_g = len(ghosts)

    ext_real = np.concatenate([np.arange(n, dtype=np.int64), ghosts[:, 0]])
    ext_shift_a = np.concatenate([np.zeros(n, dtype=np.int64), ghosts[:, 1]])
    eff = fa[ext_real] + ext_shift_a  # effective frac coord along axis

    order = np.argsort(eff, kind="stable")  # ext slot -> inventory row
    inv_order = np.empty(n + n_g, dtype=np.int64)
    inv_order[order] = np.arange(n + n_g)

    ext_real_sorted = ext_real[order]
    ext_shift_sorted = np.zeros((n + n_g, 3), dtype=np.int64)
    ext_shift_sorted[:, axis] = ext_shift_a[order]
    is_ghost = np.zeros(n + n_g, dtype=bool)
    is_ghost[inv_order[n:]] = True

    # rank of each real atom among the sorted extension
    rank_real = inv_order[:n]
    perm_real = np.argsort(rank_real, kind="stable")  # sorted-real slots

    dst_ext = rank_real[ei[0]]
    # map each edge's (src, o_a) to its extended slot
    src_ext = rank_real[ei[1]].copy()
    if n_g:
        # inventory rows n..n+n_g-1 hold the ghosts in `ghosts` order
        ghost_rank = inv_order[n:]
        # lookup (src, o_a) -> ghost inventory row: encode both keys with
        # a collision-free stride on the (small, bounded) offset range
        o_min = int(ghosts[:, 1].min())
        o_span = int(ghosts[:, 1].max()) - o_min + 1
        enc_table = ghosts[:, 0] * o_span + (ghosts[:, 1] - o_min)
        t_order = np.argsort(enc_table)
        enc_edges = ei[1][wrapped] * o_span + (o_a[wrapped] - o_min)
        loc = np.searchsorted(enc_table[t_order], enc_edges)
        assert (enc_table[t_order][loc] == enc_edges).all()
        src_ext[wrapped] = ghost_rank[t_order[loc]]

    res_offsets = offs.astype(np.float64).copy()
    res_offsets[:, axis] -= o_a

    return {
        "axis": axis,
        "perm": perm_real,
        "real_rank": rank_real,
        "n_ghosts": n_g,
        "ext_real": ext_real_sorted,
        "ext_shift": ext_shift_sorted,
        "is_ghost": is_ghost,
        "dst_ext": dst_ext,
        "src_ext": src_ext,
        "res_offsets": res_offsets,
        "reach": index_reach(dst_ext, src_ext),
    }
