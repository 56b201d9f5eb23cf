"""Padded static-shape batch collation.

Port of ``xequinet_tpu/data/batching.py:23-393`` (numpy, kept bit for bit
identical so one batch feeds both packages).

A batch has fixed capacities (n_nodes, n_edges, n_graphs).  Real graphs
are concatenated; padding nodes/edges are assigned to the last (dummy)
graph slot with NODE_MASK / EDGE_MASK / GRAPH_MASK marking validity.
Capacities are chosen from power-of-two-ish buckets so a few shapes
serve batches of varying molecule sizes.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import keys
from .datapoint import Datapoint


def bucket_capacity(n: int, margin: float = 1.0, minimum: int = 8) -> int:
    """Round up to the next bucket: {8, 16, 24, 32, 48, 64, 96, 128, ...}
    (powers of two and midpoints — bounds padding waste by ~25%)."""
    n = max(int(math.ceil(n * margin)), minimum)
    p = 1 << (n - 1).bit_length()  # next power of two
    half = p // 2 + p // 4
    if n <= half and p >= 8:
        return half
    return p


def collate(
    datapoints: Sequence[Datapoint],
    n_nodes: Optional[int] = None,
    n_edges: Optional[int] = None,
    n_graphs: Optional[int] = None,
    dtype: np.dtype = np.float32,
    kernel_layout: Optional[Dict[str, int]] = None,
) -> Dict[str, np.ndarray]:
    """Collate datapoints into one padded batch dict (host-side numpy).

    Capacities default to bucketed sizes; n_graphs always includes one
    dummy slot for padding nodes.  Label keys are included when present on
    every datapoint.
    """
    total_nodes = sum(d.num_atoms for d in datapoints)
    total_edges = sum(d.num_edges for d in datapoints)
    if n_nodes is None:
        n_nodes = bucket_capacity(total_nodes)
    if n_edges is None:
        n_edges = bucket_capacity(max(total_edges, 1))
    if n_graphs is None:
        n_graphs = len(datapoints) + 1
    if total_nodes > n_nodes or total_edges > n_edges or len(datapoints) >= n_graphs:
        raise ValueError(
            f"batch overflow: nodes {total_nodes}/{n_nodes}, edges "
            f"{total_edges}/{n_edges}, graphs {len(datapoints)}/{n_graphs - 1}"
        )

    G = n_graphs
    dummy_graph = G - 1

    atomic_numbers = np.zeros(n_nodes, dtype=np.int32)
    pos = np.zeros((n_nodes, 3), dtype=dtype)
    batch = np.full(n_nodes, dummy_graph, dtype=np.int32)
    node_mask = np.zeros(n_nodes, dtype=bool)
    # padding edges point at the last node slot so edge center indices stay
    # sorted (real edges are emitted center-major by the graph builders),
    # which the slot layout relies on
    edge_index = np.full((2, n_edges), n_nodes - 1, dtype=np.int32)
    cell_offsets = np.zeros((n_edges, 3), dtype=dtype)
    edge_mask = np.zeros(n_edges, dtype=bool)
    graph_mask = np.zeros(G, dtype=bool)
    num_atoms = np.zeros(G, dtype=np.int32)
    ptr = np.zeros(G + 1, dtype=np.int32)

    any_cell = any(d.has_cell for d in datapoints)
    # identity placeholder everywhere (incl. dummy slots): downstream code
    # may invert the cell, and no offsets ever reference padding graphs
    cell = (
        np.broadcast_to(np.eye(3, dtype=dtype), (G, 3, 3)).copy()
        if any_cell
        else None
    )
    pbc = np.zeros((G, 3), dtype=bool) if any_cell else None

    has = {
        "charge": all(d.charge is not None for d in datapoints),
        "spin": all(d.spin is not None for d in datapoints),
        "energy": all(d.energy is not None for d in datapoints),
        "forces": all(d.forces is not None for d in datapoints),
        "virial": all(d.virial is not None for d in datapoints),
        "atomic_charges": all(d.atomic_charges is not None for d in datapoints),
        "dipole": all(d.dipole is not None for d in datapoints),
        "polar": all(d.polar is not None for d in datapoints),
    }
    charge = np.zeros(G, dtype=np.int32)
    spin = np.zeros(G, dtype=np.int32)
    energy = np.zeros(G, dtype=dtype)
    forces = np.zeros((n_nodes, 3), dtype=dtype)
    virial = np.zeros((G, 3, 3), dtype=dtype)
    atomic_charges = np.zeros(n_nodes, dtype=dtype)
    dipole = np.zeros((G, 3), dtype=dtype)
    polar = np.zeros((G, 3, 3), dtype=dtype)

    # extras present on EVERY datapoint ride along, padded by their
    # leading dimension: num_atoms -> node arrays, num_edges -> edge
    # arrays (re-ordered with the center sort), else per graph.  Carries
    # e.g. the xmatnet matrix-block labels through XDB datasets.
    extra_keys = (
        set.intersection(*(set(d.extras) for d in datapoints))
        if datapoints
        else set()
    )
    extras_out: Dict[str, np.ndarray] = {}
    extras_kind: Dict[str, str] = {}
    for k in sorted(extra_keys):
        a0 = np.asarray(datapoints[0].extras[k])
        # axis from the key registry first (leading dims are ambiguous:
        # diatomics have num_atoms == num_edges); shape heuristics only
        # for unregistered keys, validated over EVERY datapoint
        if k in keys.NODE_LEVEL_PROPERTIES:
            kind = "node"
        elif k in keys.EDGE_LEVEL_PROPERTIES:
            kind = "edge"
        else:
            per_node = all(
                np.asarray(d.extras[k]).shape[:1] == (d.num_atoms,)
                for d in datapoints
            )
            per_edge = all(
                np.asarray(d.extras[k]).shape[:1] == (d.num_edges,)
                for d in datapoints
            )
            if per_node and per_edge:
                raise ValueError(
                    f"extras[{k!r}]: per-node vs per-edge is ambiguous for "
                    f"these structures; register the key in "
                    f"keys.NODE_LEVEL_PROPERTIES / EDGE_LEVEL_PROPERTIES"
                )
            kind = "node" if per_node else ("edge" if per_edge else "graph")
        extras_kind[k] = kind
        if kind == "node":
            extras_out[k] = np.zeros((n_nodes,) + a0.shape[1:], dtype=a0.dtype)
        elif kind == "edge":
            extras_out[k] = np.zeros((n_edges,) + a0.shape[1:], dtype=a0.dtype)
        else:
            extras_out[k] = np.zeros((G,) + a0.shape, dtype=a0.dtype)

    node_off = 0
    edge_off = 0
    for g, d in enumerate(datapoints):
        n, e = d.num_atoms, d.num_edges
        sl = slice(node_off, node_off + n)
        atomic_numbers[sl] = d.atomic_numbers
        pos[sl] = d.pos
        batch[sl] = g
        node_mask[sl] = True
        if e:
            esl = slice(edge_off, edge_off + e)
            ei = d.edge_index
            order = np.argsort(ei[0], kind="stable")
            edge_index[:, esl] = ei[:, order] + node_off
            if d.cell_offsets is not None:
                cell_offsets[esl] = d.cell_offsets[order]
            edge_mask[esl] = True
        graph_mask[g] = True
        num_atoms[g] = n
        ptr[g + 1] = ptr[g] + n
        if any_cell:
            if d.cell is not None:
                cell[g] = d.cell
                pbc[g] = d.pbc
            else:
                cell[g] = np.eye(3)  # inert placeholder, no offsets reference it
        if has["charge"]:
            charge[g] = d.charge
        if has["spin"]:
            spin[g] = d.spin
        if has["energy"]:
            energy[g] = d.energy
        if has["forces"]:
            forces[sl] = d.forces
        if has["virial"]:
            virial[g] = d.virial
        if has["atomic_charges"]:
            atomic_charges[sl] = d.atomic_charges
        if has["dipole"]:
            dipole[g] = d.dipole
        if has["polar"]:
            polar[g] = d.polar
        for k in extra_keys:
            a = np.asarray(d.extras[k])
            if extras_kind[k] == "node":
                extras_out[k][sl] = a
            elif extras_kind[k] == "edge":
                if e:
                    extras_out[k][esl] = a[order]
            else:
                extras_out[k][g] = a
        node_off += n
        edge_off += e
    ptr[len(datapoints) + 1 :] = ptr[len(datapoints)]

    out: Dict[str, np.ndarray] = {
        keys.ATOMIC_NUMBERS: atomic_numbers,
        keys.POSITIONS: pos,
        keys.BATCH: batch,
        keys.NODE_MASK: node_mask,
        keys.EDGE_INDEX: edge_index,
        keys.EDGE_MASK: edge_mask,
        keys.GRAPH_MASK: graph_mask,
        keys.NUM_ATOMS: num_atoms,
        keys.BATCH_PTR: ptr,
    }
    if any_cell:
        out[keys.CELL] = cell
        out[keys.PBC] = pbc
        out[keys.CELL_OFFSETS] = cell_offsets
    for k, v in extras_out.items():
        out[k] = v
    if has["charge"]:
        out[keys.TOTAL_CHARGE] = charge
    if has["spin"]:
        out[keys.TOTAL_SPIN] = spin
    if has["energy"]:
        out[keys.TOTAL_ENERGY] = energy
    if has["forces"]:
        out[keys.FORCES] = forces
    if has["virial"]:
        out[keys.VIRIAL] = virial
    if has["atomic_charges"]:
        out[keys.ATOMIC_CHARGES] = atomic_charges
    if has["dipole"]:
        out[keys.DIPOLE] = dipole
    if has["polar"]:
        out[keys.POLARIZABILITY] = polar
    # after the labels, so that its node re-pad covers the node-level ones
    # (the JAX package applies it before them, and its forces label then
    # keeps the un-padded row count when the layout re-pads the nodes)
    if kernel_layout is not None:
        out = _apply_kernel_layout(out, kernel_layout)
    return out


def kernel_layout_from_model_kwargs(
    model_kwargs: Dict,
) -> Optional[Dict[str, int]]:
    """Loader-side slot layout matching a model's kernel settings
    (``use_pallas_scatter`` / ``pallas_layout``, the JAX package's
    config names), or None when the model uses no kernel route.

    Unlike the JAX package's (which emits it for the mega modes only, so
    its entry points run a v2 model on the XLA path), the layout also comes for
    the v2 route (True / "v2"): on the card the port's v2 model runs its
    kernel or raises.  The numbers are the same either way."""
    mode = model_kwargs.get("use_pallas_scatter")
    if not (mode is True or mode in ("v2", "mega", "mega-xb")):
        return None
    bn, chunk, pad_nodes, max_chunks = model_kwargs.get(
        "pallas_layout", (256, 1024, 32, 8)
    )
    return {
        "block_nodes": bn, "chunk": chunk,
        "pad_nodes": pad_nodes, "max_chunks": max_chunks,
    }


def kernel_slot_cap(n_nodes_cap: int, n_edges_cap: int, layout: Dict[str, int]) -> int:
    """Fixed flat-slot capacity for ``_apply_kernel_layout`` given the
    loader's node/edge capacities: worst case every block pads its edge
    run to a chunk boundary (and empty blocks still occupy one chunk),
    so slots <= edges rounded up + one chunk per destination block."""
    bn, chunk = layout["block_nodes"], layout["chunk"]
    pad_nodes = layout["pad_nodes"]
    window = bn + 2 * ((pad_nodes + 7) // 8) * 8
    n_nodes = max(
        ((n_nodes_cap + bn - 1) // bn) * bn,
        ((window + bn - 1) // bn) * bn,
    )
    n_blocks = n_nodes // bn
    return ((n_edges_cap + chunk - 1) // chunk) * chunk + n_blocks * chunk


def fit_kernel_layout(layout: Dict[str, int], largest_molecule: int, n_nodes_cap: int,
                      n_edges_cap: int) -> Dict[str, int]:
    """The model's slot layout fitted to one batch: ``block_nodes`` and
    ``chunk`` (the only numbers the port's kernels and slot plan read) as
    the model has them, ``pad_nodes`` raised to the batch's largest
    molecule rounded up to 8 so that every source lies in its block's
    window, no ``max_chunks`` cap (it sizes the TPU grid only), and
    ``slot_cap`` recomputed for the fitted window by :func:`kernel_slot_cap`.
    Such a batch serves through the kernels where the model's own layout
    would refuse it."""
    fitted = {
        "block_nodes": layout["block_nodes"], "chunk": layout["chunk"],
        "pad_nodes": max(layout["pad_nodes"], (largest_molecule + 7) // 8 * 8),
        "max_chunks": 0,
    }
    fitted["slot_cap"] = kernel_slot_cap(n_nodes_cap, n_edges_cap, fitted)
    return fitted


def _apply_kernel_layout(
    batch: Dict[str, np.ndarray], layout: Dict[str, int]
) -> Dict[str, np.ndarray]:
    """Re-lay the edge axis into the block-aligned slot order consumed by
    the fused message kernels (ops/slot_layout): per destination-block
    edge runs padded to multiples of ``chunk``, node capacity a multiple
    of ``block_nodes``.  Emits K_* metadata keys; the slot order remains
    center-sorted (padding slots carry the next block's first node) so
    the plain path and its invariants keep working on the same batch.

    layout: {"block_nodes": BN, "chunk": C, "pad_nodes": P,
             "max_chunks": cap, "slot_cap": S} — must match the model's
    kernel settings.  ``slot_cap`` (optional) pads the flat slot arrays
    to a fixed length so every batch of one node capacity has one shape.
    Use ``kernel_slot_cap`` to derive it from the loader capacities.
    """
    from ..ops.slot_layout import prepare_v2

    bn = layout["block_nodes"]
    chunk = layout["chunk"]
    pad_nodes = layout["pad_nodes"]
    cap_chunks = layout.get("max_chunks", 0)

    n0 = batch[keys.POSITIONS].shape[0]
    window = bn + 2 * ((pad_nodes + 7) // 8) * 8
    n_nodes = max(((n0 + bn - 1) // bn) * bn, ((window + bn - 1) // bn) * bn)
    if n_nodes != n0:
        batch = dict(batch)
        node_keys = [keys.ATOMIC_NUMBERS, keys.POSITIONS, keys.NODE_MASK] + [
            # every registered node-level label rides the re-pad too
            k for k in batch
            if k in keys.NODE_LEVEL_PROPERTIES
        ]
        for k in node_keys:
            if k in batch:
                a = batch[k]
                pad = np.zeros((n_nodes - n0,) + a.shape[1:], a.dtype)
                batch[k] = np.concatenate([a, pad])
        bpad = np.full(
            n_nodes - n0, batch[keys.GRAPH_MASK].shape[0] - 1, np.int32
        )
        batch[keys.BATCH] = np.concatenate([batch[keys.BATCH], bpad])
        if keys.GHOST_MAP in batch:
            # padding rows are their own (inert) ghost owner
            batch[keys.GHOST_MAP] = np.concatenate([
                batch[keys.GHOST_MAP],
                np.arange(n0, n_nodes, dtype=batch[keys.GHOST_MAP].dtype),
            ])
            batch[keys.GHOST_SHIFT] = np.concatenate([
                batch[keys.GHOST_SHIFT],
                np.zeros((n_nodes - n0, 3), batch[keys.GHOST_SHIFT].dtype),
            ])

    em = batch[keys.EDGE_MASK]
    real = np.nonzero(em)[0]
    src = batch[keys.EDGE_INDEX][1, real]
    dst = batch[keys.EDGE_INDEX][0, real]
    src2, dst2, sel, cb, nc, ws, window, mx = prepare_v2(
        src, dst, n_nodes, bn, chunk, pad_nodes
    )
    if cap_chunks and mx > cap_chunks:
        raise ValueError(
            f"kernel layout overflow: a block needs {mx} chunks > cap "
            f"{cap_chunks}; lower the batch density or raise max_chunks"
        )
    slot_cap = layout.get("slot_cap", 0)
    if slot_cap:
        if len(sel) > slot_cap:
            raise ValueError(
                f"kernel slot overflow: {len(sel)} slots > slot_cap "
                f"{slot_cap}; raise max_edges or slot_cap"
            )
        pad = slot_cap - len(sel)
        if pad:
            # tail slots belong to no block's chunk range (chunk_base +
            # n_chunks never reaches them) — pad as inert masked slots
            src2 = np.concatenate([src2, np.zeros(pad, src2.dtype)])
            dst2 = np.concatenate(
                [dst2, np.full(pad, bn, dst2.dtype)]
            )
            sel = np.concatenate([sel, np.full(pad, -1, sel.dtype)])
    total = len(sel)
    valid = sel >= 0
    safe = np.clip(sel, 0, None)

    out = dict(batch)
    # padding slots carry the owning block's boundary node: keeps centers
    # sorted
    slot_chunk = np.arange(total) // chunk
    block_id = np.searchsorted(cb, slot_chunk, side="right") - 1
    pad_center = np.minimum((block_id + 1) * bn, n_nodes - 1)
    ei = np.stack([
        np.where(valid, dst[safe], pad_center),
        np.where(valid, src[safe], pad_center),
    ]).astype(np.int32)
    out[keys.EDGE_INDEX] = ei
    out[keys.EDGE_MASK] = valid
    # every per-edge array follows the slot re-layout (offsets + any
    # registered edge-level labels, e.g. xmatnet EDGE_MAT_BLOCKS)
    edge_keys = [keys.CELL_OFFSETS] + [
        k for k in batch if k in keys.EDGE_LEVEL_PROPERTIES
    ]
    for k in edge_keys:
        if k not in batch:
            continue
        a = batch[k][real]
        shaped_valid = valid.reshape(valid.shape + (1,) * (a.ndim - 1))
        out[k] = np.where(shaped_valid, a[safe], 0).astype(batch[k].dtype)
    out[keys.K_SRC2] = src2
    out[keys.K_DST2] = dst2
    out[keys.K_CHUNK_BASE] = cb
    out[keys.K_NCHUNKS] = nc
    out[keys.K_WSTARTS] = ws
    return out
