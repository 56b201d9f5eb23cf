"""Halo decomposition: one large system split over several processes.

Port of ``xequinet_tpu/parallel/halo.py``.  Nodes are sharded
contiguously in spatial order; each rank owns ``n_local`` rows plus a
window of ``halo`` rows on either side, and holds the edges whose center
it owns, so every edge-to-node sum is local to one rank.  Per message
block the only communication is two exchanges of [halo, D] rows with the
neighbouring ranks (``ops/scatter.halo_refresh``).

The JAX package runs every shard inside one SPMD program (``shard_map``
over the ``gp`` mesh axis); the port runs one process per shard in a
``torch.distributed`` group, each passing its own slice ``stacked[rank]``
(:func:`local_batch`) to the device functions.  The host functions return
the same stacked ``[S, ...]`` arrays as the JAX ones, bit for bit.  On
the mega route each rank's window runs the fused message kernels
(:func:`apply_halo_kernel_layout`); the v2 kernel is not halo-aware and
is refused, as in the JAX package.

Gradients: an all-reduce's backward is an all-reduce, and the exchange's
backward the exchange the other way.  ``make_halo_forward``
differentiates the shard-local energy, so its forces need no rescaling;
a loss replicated over the ranks gives each rank R times its share, so
the train steps take the mean of the ranks' gradients (halo.py:621-628).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import keys
from ..models.properties import compute_edge_data
from ..ops.scatter import (HaloSpec, RingExchange, all_gather_rows, all_reduce_sum,
                           group_size_rank, halo_parallel, make_halo_spec)

Tensor = torch.Tensor
DataDict = Dict[str, Tensor]


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------------
# Host part (numpy; equal to the JAX functions bit for bit)
# ---------------------------------------------------------------------------
def halo_partition(
    z: np.ndarray,
    pos: np.ndarray,
    edge_index: np.ndarray,
    n_shards: int,
    halo: int,
    cell_offsets: Optional[np.ndarray] = None,
    balance_edges: bool = False,
    edge_cap: Optional[int] = None,
    periodic: bool = False,
) -> Tuple[Dict[str, np.ndarray], Dict[str, int]]:
    """Partition one spatially sorted system (edges center-sorted) into
    per-shard window subgraphs (JAX ``halo_partition``, halo.py:48-196).

    Returns (stacked, geom): every array of ``stacked`` has a leading
    shard axis, ``geom = {"n_local", "halo", "window", "periodic"}``.
    ``balance_edges`` chooses shard boundaries that equalise the edge
    counts (masked padding rows fill each shard to ``n_local``);
    ``edge_cap`` pins the per-shard edge capacity; ``periodic`` treats the
    sorted order as a ring of period ``n_shards * n_local`` (callers pass
    unwrapped neighbour rows for wrap edges)."""
    n = len(z)
    dst, src = edge_index[0], edge_index[1]

    if balance_edges and n:
        per_node = np.bincount(dst, minlength=n)
        cum = np.cumsum(per_node)
        targets = np.arange(1, n_shards) * (cum[-1] / n_shards)
        cuts = np.searchsorted(cum, targets) + 1
        bounds = np.concatenate([[0], np.clip(cuts, 0, n), [n]])
        bounds = np.maximum.accumulate(bounds)
        lens = np.diff(bounds)
        nl = _ceil_to(max(int(lens.max()), 1), 8)
        new_index = np.full(n, -1, dtype=np.int64)
        for d in range(n_shards):
            new_index[bounds[d]:bounds[d + 1]] = d * nl + np.arange(lens[d])
        cap = n_shards * nl
        zp = np.zeros(cap, dtype=z.dtype)
        pp = np.zeros((cap, 3), dtype=pos.dtype)
        real = np.zeros(cap, dtype=bool)
        zp[new_index] = z
        pp[new_index] = pos
        real[new_index] = True
        dst = new_index[dst]
        src = new_index[src]
    else:
        nl = _ceil_to((n + n_shards - 1) // n_shards, 8)
        cap = n_shards * nl
        zp = np.zeros(cap, dtype=z.dtype)
        zp[:n] = z
        pp = np.zeros((cap, 3), dtype=pos.dtype)
        pp[:n] = pos
        real = np.arange(cap) < n

    h = _ceil_to(halo, 8)
    if h > nl:
        raise ValueError(
            f"halo {h} exceeds n_local {nl}: the boundary exchange fills halo rows from "
            f"the ADJACENT shard only (parallel/halo.py:_exchange_window), so a halo wider "
            f"than a shard silently truncates — use fewer shards or a smaller halo")
    w = nl + 2 * h
    owner = dst // nl
    counts = np.bincount(owner, minlength=n_shards)
    reach = np.abs(src - dst).max() if len(src) else 0
    if reach > h + nl - 1:
        raise ValueError(
            f"edge reaches {reach} rows from its center; halo {h} (+local {nl}) too small "
            f"— sort nodes spatially or raise halo")
    el = max(_ceil_to(int(counts.max()) if n else 1, 128), 128)
    if edge_cap is not None:
        if el > edge_cap:
            raise ValueError(f"per-shard edges {el} exceed edge_cap {edge_cap}")
        el = edge_cap

    ei = np.zeros((n_shards, 2, el), dtype=np.int32)
    em = np.zeros((n_shards, el), dtype=bool)
    co = (np.zeros((n_shards, el, 3), dtype=cell_offsets.dtype)
          if cell_offsets is not None else None)
    zw = np.zeros((n_shards, w), dtype=z.dtype)
    nm = np.zeros((n_shards, w), dtype=bool)
    pl = np.zeros((n_shards, nl, 3), dtype=pos.dtype)
    starts = np.searchsorted(owner, np.arange(n_shards))
    ends = np.searchsorted(owner, np.arange(n_shards), side="right")
    for d in range(n_shards):
        base = d * nl - h  # global row of window row 0
        s, e = int(starts[d]), int(ends[d])
        k = e - s
        dl = dst[s:e] - base
        sl = src[s:e] - base
        if k and (sl.min() < 0 or sl.max() >= w):
            raise ValueError(f"shard {d}: neighbor outside window; raise halo (>{h})")
        ei[d, 0, :k] = dl
        ei[d, 1, :k] = sl
        em[d, :k] = True
        if co is not None:
            co[d, :k] = cell_offsets[s:e]
        if periodic:
            zw[d] = zp[(base + np.arange(w)) % cap]
        else:
            lo, hi = max(base, 0), min(base + w, cap)
            zw[d, lo - base:hi - base] = zp[lo:hi]
        nm[d, h:h + nl] = real[d * nl:(d + 1) * nl]
        pl[d] = pp[d * nl:(d + 1) * nl]

    batch = {
        keys.ATOMIC_NUMBERS: zw,
        keys.POSITIONS: pl,
        keys.EDGE_INDEX: ei,
        keys.EDGE_MASK: em,
        keys.NODE_MASK: nm,
        keys.BATCH: np.zeros((n_shards, w), dtype=np.int32),
        keys.GRAPH_MASK: np.ones((n_shards, 1), dtype=bool),
    }
    if co is not None:
        batch[keys.CELL_OFFSETS] = co
    return batch, {"n_local": nl, "halo": h, "window": w, "periodic": periodic}


def apply_halo_kernel_layout(
    stacked: Dict[str, np.ndarray],
    geom: Dict[str, int],
    layout: Dict[str, int],
    min_slot_cap: Optional[int] = None,
    min_max_chunks: Optional[int] = None,
    slot_cap: Optional[int] = None,
    max_chunks: Optional[int] = None,
    margin: float = 1.0,
) -> Tuple[Dict[str, np.ndarray], int, int]:
    """Every shard's edge axis in the block-aligned slot order of the fused
    message kernels (JAX ``apply_halo_kernel_layout``, halo.py:199-334), via
    the port's ``ops/slot_layout.prepare_v2``: ``pad_nodes`` is the halo
    width, all shards share one (n_blocks, max_chunks, slot_cap).
    ``min_*`` floors keep a running geometry monotone, explicit
    ``slot_cap`` / ``max_chunks`` pin it (raise on overflow).  Padding
    slots carry the owning block's boundary node, so centers stay sorted
    for the plain route on the same batch.

    Returns ``(stacked2, slot_cap_used, max_chunks_used)``; the model takes
    ``pallas_layout = (block_nodes, chunk, halo, max_chunks_used)``."""
    from ..ops.slot_layout import prepare_v2

    bn = int(layout["block_nodes"])
    chunk = int(layout["chunk"])
    h = int(geom["halo"])
    w = int(geom["window"])
    kwin = bn + 2 * ((h + 7) // 8) * 8
    if w < kwin:
        raise ValueError(
            f"halo window {w} rows < kernel window {kwin} (block_nodes {bn} + 2*halo {h}): "
            f"use block_nodes <= n_local ({geom['n_local']})")
    n_shards = stacked[keys.EDGE_MASK].shape[0]
    n_blocks = (w + bn - 1) // bn
    per = []
    mx_meas, cap_meas = 1, chunk
    for d in range(n_shards):
        real = np.nonzero(stacked[keys.EDGE_MASK][d])[0]
        dst = stacked[keys.EDGE_INDEX][d, 0, real]
        src = stacked[keys.EDGE_INDEX][d, 1, real]
        src2, dst2, sel, cb, nc, ws, _win, mx = prepare_v2(src, dst, w, bn, chunk, h)
        per.append((src2, dst2, sel, cb, nc, ws, real))
        mx_meas = max(mx_meas, int(mx))
        cap_meas = max(cap_meas, len(sel))
    # margin gives a moving system head-room; a measured need that fits
    # an existing floor reuses it unchanged (monotone, no re-inflation)
    if min_max_chunks is not None and mx_meas <= int(min_max_chunks):
        mx_need = int(min_max_chunks)
    else:
        mx_need = max(int(np.ceil(mx_meas * margin)), int(min_max_chunks or 0))
    if min_slot_cap is not None and cap_meas <= int(min_slot_cap):
        cap_need = int(min_slot_cap)
    else:
        cap_need = max(_ceil_to(int(np.ceil(cap_meas * margin)), chunk),
                       int(min_slot_cap or 0))
    if max_chunks is None:
        max_chunks = mx_need
    elif mx_meas > max_chunks:
        raise ValueError(f"halo kernel layout: a shard block needs {mx_meas} chunks > "
                         f"max_chunks {max_chunks}")
    if slot_cap is None:
        slot_cap = cap_need
    elif cap_meas > slot_cap:
        raise ValueError(f"halo kernel layout: {cap_meas} slots > slot_cap {slot_cap}")

    ei2 = np.full((n_shards, 2, slot_cap), w - 1, dtype=np.int32)
    em2 = np.zeros((n_shards, slot_cap), dtype=bool)
    src2s = np.zeros((n_shards, slot_cap), dtype=np.int32)
    dst2s = np.full((n_shards, slot_cap), bn, dtype=np.int32)
    cbs = np.zeros((n_shards, n_blocks), dtype=np.int32)
    ncs = np.zeros((n_shards, n_blocks), dtype=np.int32)
    wss = np.zeros((n_shards, n_blocks), dtype=np.int32)
    co = stacked.get(keys.CELL_OFFSETS)
    co2 = np.zeros((n_shards, slot_cap, 3), dtype=co.dtype) if co is not None else None
    for d, (src2, dst2, sel, cb, nc, ws, real) in enumerate(per):
        t = len(sel)
        src2s[d, :t] = src2
        dst2s[d, :t] = dst2
        cbs[d], ncs[d], wss[d] = cb, nc, ws
        valid = sel >= 0
        safe = np.clip(sel, 0, None)
        slot_chunk = np.arange(t) // chunk
        block_id = np.searchsorted(cb, slot_chunk, side="right") - 1
        pad_center = np.minimum((block_id + 1) * bn, w - 1)
        dst_r = stacked[keys.EDGE_INDEX][d, 0, real]
        src_r = stacked[keys.EDGE_INDEX][d, 1, real]
        ei2[d, 0, :t] = np.where(valid, dst_r[safe], pad_center)
        ei2[d, 1, :t] = np.where(valid, src_r[safe], pad_center)
        em2[d, :t] = valid
        if co2 is not None:
            co2[d, :t] = np.where(valid[:, None], co[d][real][safe], 0)
    out = dict(stacked)
    out[keys.EDGE_INDEX] = ei2
    out[keys.EDGE_MASK] = em2
    if co2 is not None:
        out[keys.CELL_OFFSETS] = co2
    out[keys.K_SRC2] = src2s
    out[keys.K_DST2] = dst2s
    out[keys.K_CHUNK_BASE] = cbs
    out[keys.K_NCHUNKS] = ncs
    out[keys.K_WSTARTS] = wss
    return out, int(slot_cap), int(max_chunks)


def prepare_halo_system(
    atomic_numbers: np.ndarray,
    positions: np.ndarray,
    cutoff: float,
    n_shards: int,
    cell=None,
    pbc=None,
    halo: Optional[int] = None,
    edge_cap: Optional[int] = None,
    margin: float = 1.3,
    nl_exact: Optional[int] = None,
    min_halo: Optional[int] = None,
    min_edge_cap: Optional[int] = None,
) -> Tuple[Dict[str, np.ndarray], Dict[str, int], np.ndarray, Optional[np.ndarray], int, int]:
    """One large (free or periodic) system as a fixed-capacity halo
    partition (JAX ``prepare_halo_system``, halo.py:783-885): spatial sort
    along the widest direction, neighbour list, sort-axis images unwrapped
    onto the ring, center-sorted edges, :func:`halo_partition`.

    Returns ``(stacked, geom, perm, wrap_shift, halo_used, edge_cap_used)``:
    ``perm`` maps input order to sorted order, ``wrap_shift`` is the
    sort-axis lattice vector (None for free systems).  Explicit ``halo`` /
    ``edge_cap`` / ``nl_exact`` force one geometry across systems; None
    sizes from this system with ``margin`` head-room, with ``min_*`` floors
    that keep a running geometry monotone."""
    from ..ops.radius_graph import radius_graph_np, radius_graph_pbc_np
    from ..ops.spatial_sort import index_reach, sort_axis_pbc

    z = np.asarray(atomic_numbers)
    pos = np.asarray(positions, dtype=np.float64)
    n = len(z)
    has_cell = cell is not None and pbc is not None and np.any(pbc)
    if nl_exact is None:
        nl_exact = _ceil_to((n + n_shards - 1) // n_shards, 8)

    res_offs = None
    wrap_shift = None
    if has_cell:
        cell = np.asarray(cell, dtype=float)
        axis_i = sort_axis_pbc(cell, pbc, pos)
        frac = pos @ np.linalg.inv(cell)
        perm = np.argsort(frac[:, axis_i], kind="stable")
        z_s, pos_s = z[perm], pos[perm]
        ei, offs = radius_graph_pbc_np(pos_s, cell, pbc, cutoff)
        order = np.argsort(ei[0], kind="stable")
        ei, offs = ei[:, order], offs[order]
        # sort-axis images become unwrapped ring rows (period = the padded
        # global row count); the other axes stay offsets
        o_a = np.round(offs[:, axis_i]).astype(np.int64)
        period = n_shards * nl_exact
        ei = np.stack([ei[0], ei[1] + o_a * period])
        res_offs = offs.astype(np.float32)
        res_offs[:, axis_i] -= o_a
        wrap_shift = cell[axis_i]
    else:
        axis_i = int(np.argmax(pos.max(0) - pos.min(0)))
        perm = np.argsort(pos[:, axis_i], kind="stable")
        z_s, pos_s = z[perm], pos[perm]
        ei, _ = radius_graph_np(pos_s, cutoff)
        order = np.argsort(ei[0], kind="stable")
        ei = ei[:, order]

    reach = index_reach(ei[0], ei[1])
    if halo is None:
        halo = _ceil_to(max(int(reach * margin), 8), 8)
        if min_halo is not None and reach < min_halo:
            halo = min_halo
    elif reach >= halo:
        raise ValueError(f"halo={halo} rows < measured index reach {reach}; widen halo (or "
                         f"let it auto-size)")
    if edge_cap is None:
        need = max(_ceil_to(int(np.bincount(ei[0] // nl_exact, minlength=n_shards).max())
                            if ei.shape[1] else 1, 128), 128)
        edge_cap = _ceil_to(int(need * margin), 128)
        if min_edge_cap is not None:
            edge_cap = max(edge_cap, min_edge_cap)
    stacked, geom = halo_partition(z_s, pos_s, ei, n_shards, halo, cell_offsets=res_offs,
                                   edge_cap=edge_cap, periodic=has_cell)
    if has_cell:
        stacked[keys.CELL] = np.broadcast_to(cell.astype(np.float32),
                                             (n_shards, 1, 3, 3)).copy()
    return stacked, geom, perm, wrap_shift, halo, edge_cap


def scatter_labels_to_shards(stacked: Dict[str, np.ndarray], geom: Dict[str, int],
                             values_sorted: np.ndarray) -> np.ndarray:
    """Per-atom labels (in sorted order) in the owned-row layout of a halo
    partition, [n_shards, n_local, ...] with zeros on padding rows: the
    inverse of how :class:`HaloCalculator` reads forces back."""
    nl, h = geom["n_local"], geom["halo"]
    n_shards = stacked[keys.NODE_MASK].shape[0]
    nm = stacked[keys.NODE_MASK][:, h:h + nl].reshape(-1)
    out = np.zeros((n_shards * nl,) + values_sorted.shape[1:],
                   dtype=np.asarray(values_sorted).dtype)
    out[nm] = values_sorted
    return out.reshape((n_shards, nl) + values_sorted.shape[1:])


def stack_halo_systems(batches: List[Dict[str, np.ndarray]], geoms: List[Dict[str, int]]
                       ) -> Tuple[Dict[str, np.ndarray], Dict[str, int]]:
    """Per-system halo partitions of one geometry stacked along a leading
    dp axis: ([dp, n_shards, ...] batch, geom with "dp")."""
    g0 = {k: geoms[0][k] for k in ("n_local", "halo", "window")}
    for g in geoms[1:]:
        if {k: g[k] for k in g0} != g0:
            raise ValueError(f"halo geometries differ across systems: {g0} vs {g}")
    kset = set(batches[0])
    for b in batches[1:]:
        if set(b) != kset or any(b[k].shape != batches[0][k].shape for k in kset):
            raise ValueError("stack_halo_systems: per-system shapes differ; pass edge_cap "
                             "(and equal-sized systems) to halo_partition")
    out = {k: np.stack([b[k] for b in batches]) for k in kset}
    geom = dict(geoms[0])
    geom["dp"] = len(batches)
    return out, geom


def comm_bytes_per_block(geom: Dict[str, int], feat_dim: int, n_nodes: int,
                         itemsize: int = 4) -> Dict[str, int]:
    """Analytic per-aggregation communication: the halo exchange against
    the all-reduce of an edge partition."""
    return {
        "halo_exchange": 2 * geom["halo"] * feat_dim * itemsize,
        "gspmd_allreduce": n_nodes * feat_dim * itemsize,
    }


def local_batch(stacked: Dict[str, np.ndarray], index, device) -> DataDict:
    """One shard's slice ``stacked[index]`` (``index`` a rank, or a (dp, gp)
    pair) as tensors on ``device``: floats in f32, integers and masks as
    they are."""
    out = {}
    for k, v in stacked.items():
        a = np.asarray(v[index])
        t = torch.as_tensor(np.ascontiguousarray(a))
        if t.is_floating_point():
            t = t.float()
        out[k] = t.to(device)
    return out


# ---------------------------------------------------------------------------
# Device part: one rank's shard
# ---------------------------------------------------------------------------
def _exchange_window(pos_local: Tensor, spec: HaloSpec,
                     wrap_shift: Optional[Tensor] = None) -> Tensor:
    """[nl, 3] owned positions -> the [h + nl + h, 3] window (JAX
    ``_exchange_window``, halo.py:337-373).  ``wrap_shift`` (the lattice
    vector along the sort axis) closes the ring: rank 0's left halo comes
    from the last rank translated by -wrap_shift, the last rank's right
    halo from rank 0 by +wrap_shift, inside the graph, so that the forces
    see it."""
    nl, h = spec.n_local, spec.halo
    periodic = wrap_shift is not None
    if h == 0:
        return pos_local
    if spec.size == 1 and not periodic:
        pad = pos_local.new_zeros((h, 3))
        return torch.cat([pad, pos_local, pad], dim=0)
    left, right = RingExchange.apply(pos_local[nl - h:].contiguous(),
                                     pos_local[:h].contiguous(), spec)
    if periodic:
        if spec.rank == 0:
            left = left - wrap_shift
        if spec.rank == spec.size - 1:
            right = right + wrap_shift
    return torch.cat([left, pos_local, right], dim=0)


def _wrap_tensor(wrap_shift, like: Tensor) -> Tensor:
    ws = np.zeros(3) if wrap_shift is None else np.asarray(wrap_shift, dtype=np.float64)
    return torch.as_tensor(ws, dtype=like.dtype, device=like.device)


def _local_energy(apply_fn, spec: HaloSpec, pos_local: Tensor, static: DataDict,
                  wshift: Tensor) -> Tensor:
    """The shard's masked energy: the position window, the edge data, the
    model under the halo context."""
    win = _exchange_window(pos_local, spec, wshift if spec.periodic else None)
    d = dict(static)
    d[keys.POSITIONS] = win
    d = compute_edge_data(d, None)
    with halo_parallel(spec.group, spec.n_local, spec.halo, spec.periodic):
        out = apply_fn(d)
    return out[keys.TOTAL_ENERGY].sum()  # halo rows are masked out


def _spec(group, geom) -> HaloSpec:
    return make_halo_spec(group, geom["n_local"], geom["halo"],
                          bool(geom.get("periodic", False)))


def make_halo_forward(apply_fn: Callable[[DataDict], DataDict], group, geom: Dict[str, int]):
    """``forward(local, compute_forces=True, wrap_shift=None) -> (energy,
    forces)`` for this rank's shard ``local`` (:func:`local_batch`), every
    rank of ``group`` calling it in lockstep (JAX ``make_halo_forward``,
    halo.py:376-465).  Positions enter as the owned rows and are windowed
    in the graph, so the forces come back exact per owned row ([n_local,
    3], -grad of the shard-local energy; the exchanges' backward carries
    the halo rows' share to their owners).  The energy is the all-reduce
    of the shards' masked sums.  ``wrap_shift``: the sort-axis lattice
    vector of a periodic system, per call."""
    spec = _spec(group, geom)

    def forward(local: DataDict, compute_forces: bool = True, wrap_shift=None):
        pos = local[keys.POSITIONS]
        static = {k: v for k, v in local.items() if k != keys.POSITIONS}
        ws = _wrap_tensor(wrap_shift, pos)
        if not compute_forces:
            with torch.no_grad():
                e_local = _local_energy(apply_fn, spec, pos, static, ws)
                return all_reduce_sum(e_local, spec.group), None
        with torch.enable_grad():
            p = pos.detach().requires_grad_(True)
            e_local = _local_energy(apply_fn, spec, p, static, ws)
            g, = torch.autograd.grad(e_local, p)
        return all_reduce_sum(e_local.detach(), spec.group), -g

    return forward


def _make_halo_local_loss(apply_fn, spec: HaloSpec, energy_weight: float,
                          forces_weight: float):
    """The shard's share of one system's loss (JAX
    ``_make_halo_local_loss``, halo.py:468-506): the squared energy error
    plus the mean squared force error over owned real atoms, with the
    sums all-reduced over the halo group.  The forces are a first
    gradient taken with ``create_graph``, so the loss's gradient goes
    through the exchanges twice."""

    def local_loss(pos_local, static, e_label, f_label, wshift, create_graph=True):
        with torch.enable_grad():
            p = pos_local.detach().requires_grad_(True)
            e_local = _local_energy(apply_fn, spec, p, static, wshift)
            g_pos, = torch.autograd.grad(e_local, p, create_graph=create_graph)
        forces = -g_pos
        energy = all_reduce_sum(e_local, spec.group)
        mask = static[keys.NODE_MASK][spec.halo:spec.halo + spec.n_local]
        n_real = all_reduce_sum(mask.sum().to(forces.dtype), spec.group)
        sq = torch.where(mask[:, None], (forces - f_label) ** 2, torch.zeros_like(forces))
        loss_f = all_reduce_sum(sq.sum(), spec.group) / (3.0 * n_real)
        loss_e = (energy - e_label) ** 2
        return energy_weight * loss_e + forces_weight * loss_f

    return local_loss


def _as_tensor(x, like: Tensor) -> Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=like.device)


def make_halo_loss_fn(module: torch.nn.Module, group, geom: Dict[str, int],
                      energy_weight: float = 1.0, forces_weight: float = 10.0):
    """``loss(local, e_label, f_label_local, wrap_shift=None) -> float``:
    the train step's loss without its gradient (JAX ``make_halo_loss_fn``)."""
    local_loss = _make_halo_local_loss(module, _spec(group, geom), energy_weight,
                                       forces_weight)

    def loss(local, e_label, f_label_local, wrap_shift=None):
        pos = local[keys.POSITIONS]
        static = {k: v for k, v in local.items() if k != keys.POSITIONS}
        out = local_loss(pos, static, _as_tensor(e_label, pos), _as_tensor(f_label_local, pos),
                         _wrap_tensor(wrap_shift, pos), create_graph=False)
        return float(out.detach())

    return loss


def _mean_over(tensors: List[Tensor], group) -> None:
    """Each tensor becomes its mean over ``group``, in place: one all-reduce
    of the flattened tensors (the JAX ``pmean``)."""
    size, _ = group_size_rank(group)
    if size == 1:
        return
    import torch.distributed as dist

    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat.div_(size)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def make_halo_train_step(module: torch.nn.Module, group, geom: Dict[str, int],
                         optimizer: torch.optim.Optimizer, energy_weight: float = 1.0,
                         forces_weight: float = 10.0, dp_group=None):
    """``step(local, e_label, f_label_local, wrap_shift=None) -> loss``: one
    optimizer step on one halo-decomposed system (JAX
    ``make_halo_train_step``, halo.py:572-654), the module's parameters
    updated in place on every rank.  Each rank differentiates the
    replicated loss through its own contributions; every rank seeds the
    loss's cotangent, so each rank's gradient is ``size`` times its share
    and the mean over the group is the exact gradient.  ``dp_group``: the
    replicas of a dp x gp layout, each on its own system; the loss and the
    gradients are then also averaged over it (:func:`make_halo_dp_train_step`)."""
    local_loss = _make_halo_local_loss(module, _spec(group, geom), energy_weight,
                                       forces_weight)
    params = [p for p in module.parameters() if p.requires_grad]

    def step(local, e_label, f_label_local, wrap_shift=None):
        pos = local[keys.POSITIONS]
        static = {k: v for k, v in local.items() if k != keys.POSITIONS}
        loss = local_loss(pos, static, _as_tensor(e_label, pos), _as_tensor(f_label_local, pos),
                          _wrap_tensor(wrap_shift, pos))
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        _mean_over(grads, group)
        loss = loss.detach().reshape(1)
        if dp_group is not None:
            _mean_over(grads + [loss], dp_group)
        for p, g in zip(params, grads):
            p.grad = g
        optimizer.step()
        for p in params:
            p.grad = None
        return loss[0]

    return step


def make_halo_dp_train_step(module: torch.nn.Module, gp_group, dp_group, geom: Dict[str, int],
                            optimizer: torch.optim.Optimizer, energy_weight: float = 1.0,
                            forces_weight: float = 10.0):
    """dp x gp training (JAX ``make_halo_dp_train_step``, halo.py:689-780):
    each dp replica on its own large system, halo-decomposed over its gp
    group; the loss is the dp mean of the systems' losses, and the update
    the one a single device computing every system would apply.  Each
    rank passes its own (replica, shard) slice."""
    return make_halo_train_step(module, gp_group, geom, optimizer, energy_weight,
                                forces_weight, dp_group=dp_group)


# ---------------------------------------------------------------------------
# The calculator
# ---------------------------------------------------------------------------
class HaloCalculator:
    """One system too large for one card, over the ranks of a process group
    (JAX ``HaloCalculator``, halo.py:906-1123): a drop-in for
    ``interface.calculator.Calculator`` in run_md's ForceField for
    ``calculate(z, pos[, cell, pbc, charge, spin])``.

    Every rank calls ``calculate`` with the same (replicated) state.  Per
    call each rank sorts the atoms, builds the neighbour list and the
    partition on the host (the same numpy on every rank), runs its own
    shard, and the ranks' owned forces are all-gathered and unsorted to
    input order, so every rank returns the whole result.  A moving system
    keeps one geometry (``min_*`` floors), so the model and its slot
    layout are built once.  Periodic systems sort along the widest cell
    direction and close the exchange ring with the lattice shift.  Ewald
    models and the charge / spin embeddings decompose through their
    all-reduced sums.  No virial (the single-card Calculator has it).

    ``pallas="mega"`` runs each shard's message blocks through the fused
    message kernels on the card (:func:`apply_halo_kernel_layout`); None
    the plain route.  ``group``: the process group of the shards (None:
    the default group, or one process); ``n_shards`` must be its size.
    ``device``: None = the card (raises without one)."""

    def __init__(self, ckpt_file: str, n_shards: Optional[int] = None,
                 halo: Optional[int] = None, use_ema: bool = True, margin: float = 1.3,
                 pallas: Optional[str] = None, pallas_layout: Tuple[int, int] = (256, 1024),
                 group=None, device=None) -> None:
        from ..run.inference import load_model_from_checkpoint, resolve_device
        from ..utils.qc import get_default_units

        if pallas not in (None, False, "mega", "mega-xb"):
            raise ValueError(f"pallas={pallas!r}: use None (the plain message route) or "
                             f"'mega'/'mega-xb' (the v2 kernel is not halo-aware)")
        self.device = resolve_device(device)
        module, extra, cutoff, _, mc = load_model_from_checkpoint(ckpt_file, use_ema)
        self._loaded = module
        self.extra = extra
        self.cutoff = float(cutoff)
        self._mc = mc
        self.units = get_default_units()
        self.group = group
        size, self.rank = group_size_rank(group)
        self.n_shards = int(n_shards or size)
        if self.n_shards != size:
            raise ValueError(f"n_shards={self.n_shards} but the process group has {size} "
                             f"process(es): launch one process per shard")
        self._halo = halo
        self._edge_cap: Optional[int] = None
        self._margin = margin
        self._pallas = pallas or None
        self._k_bn, self._k_chunk = int(pallas_layout[0]), int(pallas_layout[1])
        self._slot_cap: Optional[int] = None
        self._mxc: Optional[int] = None
        self._fwd_cache: Dict = {}
        self.last_virial = None

    def _shard_module(self, geom, max_chunks) -> torch.nn.Module:
        """The model each shard applies: the checkpoint's weights on the
        plain route, or on the mega route with the layout of this halo
        geometry (the parameter tree is the same on every route)."""
        from ..models.model import resolve_model

        kw = dict(self._mc["model_kwargs"])
        if self._pallas is None:
            kw["use_pallas_scatter"] = False
        else:
            kw["use_pallas_scatter"] = self._pallas
            kw["pallas_layout"] = (min(self._k_bn, geom["n_local"]), self._k_chunk,
                                   geom["halo"], max_chunks)
        module, _, _ = resolve_model(self._mc["model_name"], **kw)
        module.load_state_dict(self._loaded.state_dict())
        return module.to(self.device).eval().requires_grad_(False)

    def prepare(self, atomic_numbers, positions, cell=None, pbc=None, charge=None, spin=None):
        """The host half of one call: (stacked, geom, perm, wrap_shift), the
        geometry's floors updated."""
        z = np.asarray(atomic_numbers)
        pos = np.asarray(positions, dtype=np.float64)
        stacked, geom, perm, wrap_shift, self._halo, self._edge_cap = prepare_halo_system(
            z, pos, self.cutoff, self.n_shards, cell=cell, pbc=pbc, margin=self._margin,
            min_halo=self._halo, min_edge_cap=self._edge_cap)
        if charge is not None:
            stacked[keys.TOTAL_CHARGE] = np.full((self.n_shards, 1), charge, np.int32)
        if spin is not None:
            stacked[keys.TOTAL_SPIN] = np.full((self.n_shards, 1), spin, np.int32)
        if self._pallas is not None:
            stacked, self._slot_cap, self._mxc = apply_halo_kernel_layout(
                stacked, geom,
                {"block_nodes": min(self._k_bn, geom["n_local"]), "chunk": self._k_chunk},
                min_slot_cap=self._slot_cap, min_max_chunks=self._mxc, margin=self._margin)
        return stacked, geom, perm, wrap_shift

    def forward_for(self, geom, has_cell, charge, spin):
        """The cached shard forward of this geometry's signature."""
        sig = (geom["n_local"], geom["halo"], self._edge_cap, has_cell, charge is not None,
               spin is not None, self._slot_cap, self._mxc)
        if sig not in self._fwd_cache:
            module = self._shard_module(geom, self._mxc)
            self._fwd_cache[sig] = make_halo_forward(module, self.group, geom)
        return self._fwd_cache[sig]

    def run(self, stacked, geom, wrap_shift, has_cell, charge=None, spin=None):
        """The device half of one call: this rank's shard through the cached
        forward -> (energy, owned forces [n_local, 3]), on the device."""
        forward = self.forward_for(geom, has_cell, charge, spin)
        return forward(local_batch(stacked, self.rank, self.device), compute_forces=True,
                       wrap_shift=wrap_shift)

    def gather(self, f_local, stacked, geom, perm) -> np.ndarray:
        """Every rank's owned forces, unsorted to input order."""
        f = all_gather_rows(f_local, self.group).cpu().numpy()
        nl, h = geom["n_local"], geom["halo"]
        nm = stacked[keys.NODE_MASK][:, h:h + nl].reshape(-1)
        f_sorted = f.reshape(-1, 3)[nm]
        forces = np.empty_like(f_sorted)
        forces[perm] = f_sorted
        return forces

    def calculate(self, atomic_numbers, positions, cell=None, pbc=None, charge=None,
                  spin=None) -> Dict[str, np.ndarray]:
        has_cell = cell is not None and pbc is not None and np.any(pbc)
        stacked, geom, perm, wrap_shift = self.prepare(atomic_numbers, positions, cell, pbc,
                                                       charge, spin)
        e, f_local = self.run(stacked, geom, wrap_shift, has_cell, charge, spin)
        return {keys.TOTAL_ENERGY: float(e),
                keys.FORCES: self.gather(f_local, stacked, geom, perm)}
