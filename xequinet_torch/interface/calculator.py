"""Single-structure calculator: the forward of the MD entry point.

Port of ``xequinet_tpu/interface/calculator.py:29-842`` on an explicit
device (the card unless ``device="cpu"``).  One structure per call:
energy, forces and (``compute_virial``) the virial in model units, in the
caller's atom order.

Routes, chosen by the JAX Calculator's own rules:

* plain: free systems get their neighbour list on the device every call
  (``ops/radius_graph.radius_graph_fixed`` at a fixed edge capacity, grown
  on overflow, or an error when ``max_edges`` was pinned); periodic ones
  on the host (C++ cell lists) from the cell of each call, so barostats
  that move the cell stay correct.
* mega (``pallas="mega"``): the host sorts atoms along the longest axis
  (free) or lays out periodic ghost images (``ops/spatial_sort``), fits
  the fused message kernels' slot layout and runs the model with
  ``use_pallas_scatter="mega"``: on the card ``csrc/message_fwd.cu`` and
  ``csrc/message_bwd.cu`` run three times each per call.  Systems below
  1024 atoms or 4096 edges of capacity, denser than the edge capacity, or
  whose window would cover the whole system take the plain route, as in
  the JAX package; any error of the kernel route itself propagates.
  ``last_route`` says which route the latest call took.

A Verlet skin (``skin > 0``) builds the lists at cutoff + skin and reuses
them until an atom moves skin/2: between rebuilds a call uploads only
positions (the static edge and slot arrays and the slot plan stay on the
device) and ``EDGE_CUTOFF`` masks the pairs beyond the model cutoff.  When
the drift passes ``skin_prefetch`` of that limit a worker thread rebuilds
from the current positions while the old list keeps serving, and a later
call swaps the finished build in (``n_rebuilds``, ``n_async_swaps``).

``hessian`` gives the analytic [3n, 3n] Hessian on the plain route
(second derivatives by autograd at a neighbour list held fixed), and
:class:`XequiCalculator` is the ASE adapter (ASE imported lazily).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import keys
from ..data.batching import _apply_kernel_layout, bucket_capacity, kernel_slot_cap
from ..models.model import resolve_model
from ..models.properties import compute_edge_data, make_forward
from ..models.xpainn import SLOT_PLAN
from ..ops.fused_message import build_slot_plan
from ..ops.radius_graph import radius_graph_fixed, radius_graph_np, radius_graph_pbc_np
from ..ops.spatial_sort import ghost_layout_pbc, index_reach, spatial_sort_free
from ..run.inference import load_model_from_checkpoint, resolve_device
from ..utils.precision import set_matmul_precision
from ..utils.qc import get_default_units, unit_conversion

# rows of the Hessian per batched backward pass (``Calculator.hessian``)
HESSIAN_ROWS = 256


def _padded(rows: np.ndarray, cap: int) -> np.ndarray:
    """``rows`` as f32 in the first rows of ``cap`` zero rows."""
    out = np.zeros((cap,) + np.shape(rows)[1:], dtype=np.float32)
    out[: len(rows)] = rows
    return out


def _padded_edges(ei: np.ndarray, e_cap: int) -> Tuple[np.ndarray, np.ndarray]:
    """A host edge list [2, ne] as edge_index [2, e_cap] and its mask."""
    edge_index = np.zeros((2, e_cap), dtype=np.int32)
    edge_index[:, : ei.shape[1]] = ei
    return edge_index, np.arange(e_cap) < ei.shape[1]


class Calculator:
    """Per-structure evaluator with the neighbour list rebuilt every call
    (or reused within a Verlet skin).  On overflow of the default edge
    capacity the capacity grows; a pinned ``max_edges`` raises instead.
    Neighbours are never silently dropped.

    ``compile_cache`` is the JAX package's persistent XLA cache switch;
    it is accepted and has no effect here (the CUDA kernels are built once
    into ``xequinet_torch/_build``).  ``matmul_precision``: see
    ``utils/precision.py``."""

    def __init__(
        self,
        ckpt_file: str,
        max_atoms: Optional[int] = None,
        max_edges: Optional[int] = None,
        use_ema: bool = True,
        compute_virial: bool = False,
        pallas: Optional[str] = None,
        compile_cache: object = True,
        matmul_precision: Optional[str] = None,
        skin: float = 0.0,
        device=None,
    ) -> None:
        self.device = resolve_device(device)
        set_matmul_precision(matmul_precision)
        module, extra, cutoff, _, mc = load_model_from_checkpoint(ckpt_file, use_ema)
        self._loaded = module  # the checkpoint's weights, on the host
        self.module: Optional[torch.nn.Module] = None  # plain route, on the device
        self.apply_forward = None
        self.extra = extra
        self.cutoff = float(cutoff)
        self.compute_virial = compute_virial
        self.max_atoms = max_atoms
        self.max_edges = max_edges
        self.units = get_default_units()
        self._pallas = pallas
        self._mc = mc
        self._mega: Optional[Dict] = None  # {layout, apply, geom}
        self.last_route: Optional[str] = None  # "mega" or "plain"
        self.skin = float(skin)
        self._skin_state: Optional[Dict] = None
        self.n_rebuilds = 0
        self.skin_prefetch = 0.55
        self._skin_pending = None  # (future, tag, n_rebuilds at schedule)
        self._skin_executor = None
        self.n_async_swaps = 0

    # ------------------------------------------------------------------
    def _capacities(self, n_atoms: int) -> Tuple[int, int]:
        n_cap = self.max_atoms or bucket_capacity(n_atoms)
        e_cap = self.max_edges or bucket_capacity(max(n_atoms * 40, 64))
        return n_cap, e_cap

    def _edge_capacity(self, ne: int, e_cap: int) -> int:
        """The edge capacity that holds ``ne`` edges: ``e_cap`` where they
        fit, else a larger bucket (e.g. NPT compression); a pinned
        ``max_edges`` raises, as truncation would mean silently wrong
        forces."""
        if ne <= e_cap:
            return e_cap
        if self.max_edges:
            raise ValueError(f"edge overflow {ne} > {e_cap}; raise max_edges")
        return bucket_capacity(ne)

    def _build_module(self, **over) -> torch.nn.Module:
        """The checkpoint's model with ``over`` in its kwargs, carrying the
        loaded weights, on the device (the parameter tree is the same on
        every route)."""
        kw = dict(self._mc["model_kwargs"], **over)
        module, _, _ = resolve_model(self._mc["model_name"], **kw)
        module.load_state_dict(self._loaded.state_dict())
        return module.to(self.device).eval().requires_grad_(False)

    def _ensure_params(self) -> torch.nn.Module:
        """The plain-route model on the device, moved there once.  A
        checkpoint trained on a kernel route serves here as the plain
        model: the JAX Calculator runs its non-mega calls on the XLA path."""
        if self.module is None:
            self.module = self._build_module(use_pallas_scatter=False)
            self.apply_forward = make_forward(self.module, self.extra)
        return self.module

    def _make_batch(self, n_cap, e_cap, atomic_numbers, charge, spin, cell):
        n = len(atomic_numbers)
        z = np.zeros(n_cap, dtype=np.int32)
        z[:n] = atomic_numbers
        batch = {
            keys.ATOMIC_NUMBERS: z,
            keys.BATCH: np.where(np.arange(n_cap) < n, 0, 1).astype(np.int32),
            keys.NODE_MASK: np.arange(n_cap) < n,
            keys.GRAPH_MASK: np.array([True, False]),
            keys.NUM_ATOMS: np.array([n, 0], dtype=np.int32),
            keys.BATCH_PTR: np.array([0, n, n], dtype=np.int32),
        }
        if charge is not None:
            batch[keys.TOTAL_CHARGE] = np.array([charge, 0], dtype=np.int32)
        if spin is not None:
            batch[keys.TOTAL_SPIN] = np.array([spin, 0], dtype=np.int32)
        if cell is not None:
            batch[keys.CELL] = np.stack([cell, np.eye(3)]).astype(np.float32)
        return batch

    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    def _result(self, out, rows) -> Dict[str, np.ndarray]:
        """Host outputs of one call: per-atom rows ``rows`` (a slice or the
        unsorting index) in the caller's order."""
        out = {k: v.detach().cpu().numpy() for k, v in out.items()
               if k in keys.OUTPUT_PROPERTIES}
        result = {keys.TOTAL_ENERGY: float(out[keys.TOTAL_ENERGY][0]),
                  keys.FORCES: out[keys.FORCES][rows]}
        if self.compute_virial and keys.VIRIAL in out:
            result[keys.VIRIAL] = out[keys.VIRIAL][0]
        for k in (keys.ATOMIC_CHARGES, keys.ATOMIC_ENERGIES):
            if k in out:
                result[k] = out[k][rows]
        return result

    # ------------------------------------------------------------------
    def _eval_free(self, pos, static_batch, n_cap, e_cap):
        """Free system: the device neighbour search and the forward.  Also
        returns the search's n_edges_found, so that an overflow of the
        capacity is seen (the device's f32 search can find more edges than
        the host probe that sized it, at the cutoff boundary)."""
        edge_index, edge_mask, n_found = radius_graph_fixed(
            pos, self.cutoff, e_cap, static_batch[keys.NODE_MASK])
        data = dict(static_batch)
        data[keys.POSITIONS] = pos
        data[keys.EDGE_INDEX] = edge_index
        data[keys.EDGE_MASK] = edge_mask
        return self.apply_forward(data, True, self.compute_virial), n_found

    def _eval_pbc(self, pos, edge_index, edge_mask, cell_offsets, static_batch):
        data = dict(static_batch)
        data[keys.POSITIONS] = pos
        data[keys.EDGE_INDEX] = edge_index
        data[keys.EDGE_MASK] = edge_mask
        data[keys.CELL_OFFSETS] = cell_offsets
        return self.apply_forward(data, True, self.compute_virial)

    # ------------------------------------------------------------------
    # the mega route
    # ------------------------------------------------------------------
    def _mega_apply_forward(self, layout_t):
        """The model on the mega route for one slot layout (bn, chunk,
        pad_nodes, 0), with the same weights as the plain route."""
        if self._mega is None or self._mega.get("layout") != layout_t:
            module = self._build_module(use_pallas_scatter="mega", pallas_layout=layout_t)
            self._mega = {"layout": layout_t, "apply": make_forward(module, self.extra)}
        return self._mega["apply"]

    def _mega_host_build(self, atomic_numbers, positions, ei, n, n_cap, e_cap,
                         charge, spin, cell=None, pbc=None, offs=None):
        """The host half of the mega route: spatial sort or ghost plan and
        the slot layout -> (batch, meta), or None when the system does not
        fit the kernels' banded contract (the plain route takes it).
        numpy only, so the skin's worker thread can run it.

        Free: atoms sorted along the longest bounding-box axis.  Periodic:
        wrapped edges remapped to ghost images (ghost positions and states
        are derived in the model).  ``pad_nodes`` is the sorted reach with
        a 25% margin, kept from call to call unless a geometry needs more.
        The JAX package's ``max_chunks`` cap sizes its TPU grid only: the
        port's slot plan reads block_nodes and chunk, so the layout carries
        no cap (0)."""
        if n_cap < 1024 or e_cap < 4096 or n < 2:
            return None
        ne = ei.shape[1]
        if ne > e_cap:
            return None  # denser than the edge capacity: plain route
        prev = self._mega.get("geom") if self._mega else None
        has_cell = cell is not None

        if has_cell:
            plan = ghost_layout_pbc(positions, cell, pbc, ei, offs)
            n_ext = n + plan["n_ghosts"]
            ext_cap = bucket_capacity(n_ext)
            if prev and prev.get("ext_cap", 0) >= ext_cap:
                ext_cap = prev["ext_cap"]  # keep shapes stable step to step
            if n_ext > ext_cap:
                return None
            real_rank = plan["real_rank"]
            ext_real = plan["ext_real"]
            is_ghost = plan["is_ghost"]
            dst, src = plan["dst_ext"], plan["src_ext"]
            reach = plan["reach"]
            node_cap = ext_cap
        else:
            perm, rank = spatial_sort_free(positions)
            real_rank = rank
            ext_real = perm
            is_ghost = np.zeros(n, dtype=bool)
            dst, src = rank[ei[0]], rank[ei[1]]
            reach = index_reach(dst, src)
            node_cap = n_cap
            n_ext = n

        bn = 512 if node_cap >= 2048 else 256
        chunk = 1024  # the JAX package's MD layout
        pad = ((int(reach * 1.25) + 15) // 8) * 8
        if prev and prev["bn"] == bn and prev["pad"] >= pad:
            pad = prev["pad"]
        window = bn + 2 * pad
        n_padded = max(((node_cap + bn - 1) // bn) * bn, ((window + bn - 1) // bn) * bn)
        if window >= n_padded:
            return None  # windows would cover everything: plain route

        order = np.argsort(dst, kind="stable")
        edge_index = np.zeros((2, e_cap), dtype=np.int32)
        edge_index[0, :ne] = dst[order]
        edge_index[1, :ne] = src[order]
        edge_index[:, ne:] = node_cap - 1
        edge_mask = np.arange(e_cap) < ne

        slot = np.arange(node_cap)
        node_is_real_atom = slot < n_ext
        node_is_real_atom[:n_ext] = ~is_ghost
        z_s = np.zeros(node_cap, dtype=np.int32)
        z_s[:n_ext] = atomic_numbers[ext_real]
        pos_s = np.zeros((node_cap, 3), dtype=np.float32)
        pos_s[:n_ext] = positions[ext_real]
        batch = {
            keys.ATOMIC_NUMBERS: z_s,
            keys.POSITIONS: pos_s,
            keys.BATCH: np.where(node_is_real_atom, 0, 1).astype(np.int32),
            keys.NODE_MASK: node_is_real_atom,
            keys.GRAPH_MASK: np.array([True, False]),
            keys.NUM_ATOMS: np.array([n, 0], dtype=np.int32),
            keys.BATCH_PTR: np.array([0, n, n], dtype=np.int32),
            keys.EDGE_INDEX: edge_index,
            keys.EDGE_MASK: edge_mask,
        }
        if has_cell:
            gm = slot.astype(np.int32)
            gm[:n_ext] = real_rank[ext_real].astype(np.int32)
            gshift = np.zeros((node_cap, 3), dtype=np.float32)
            gshift[:n_ext] = plan["ext_shift"]
            batch[keys.GHOST_MAP] = gm
            batch[keys.GHOST_SHIFT] = gshift
            batch[keys.CELL] = np.stack([cell, np.eye(3)]).astype(np.float32)
            cell_offsets = np.zeros((e_cap, 3), dtype=np.float32)
            cell_offsets[:ne] = plan["res_offsets"][order]
            batch[keys.CELL_OFFSETS] = cell_offsets
        if charge is not None:
            batch[keys.TOTAL_CHARGE] = np.array([charge, 0], dtype=np.int32)
        if spin is not None:
            batch[keys.TOTAL_SPIN] = np.array([spin, 0], dtype=np.int32)

        layout = {"block_nodes": bn, "chunk": chunk, "pad_nodes": pad, "max_chunks": 0}
        layout["slot_cap"] = kernel_slot_cap(node_cap, e_cap, layout)
        try:
            batch = _apply_kernel_layout(batch, layout)
        except ValueError:
            return None  # a source outside its window: plain route
        if self.skin > 0.0:
            # edges built at cutoff+skin, masked to the model cutoff on the
            # device (compute_edge_data), so the list can be reused
            batch[keys.EDGE_CUTOFF] = np.array([self.cutoff], dtype=np.float32)
        layout_t = (bn, chunk, pad, 0)
        meta = {
            "n": n, "n_ext": n_ext, "ext_real": ext_real, "real_rank": real_rank,
            "has_cell": has_cell, "bn": bn, "chunk": chunk, "pad": pad,
            "mx": int(batch[keys.K_NCHUNKS].max()), "layout_t": layout_t,
            "node_cap": node_cap, "e_cap": e_cap, "charge": charge, "spin": spin,
            "cell": None if cell is None else np.array(cell, dtype=float),
            "pbc": None if pbc is None else np.array(pbc),
            "pos_build": np.array(positions, dtype=np.float64),
            "rows": batch[keys.POSITIONS].shape[0],
            "key": ("mega", layout_t, node_cap, e_cap, has_cell,
                    charge is not None, spin is not None),
        }
        return batch, meta

    def _mega_upload(self, batch, meta) -> Dict:
        """The static arrays of one build on the device (everything but the
        positions) and, on the card, the slot plan the message kernels
        walk (``ops/fused_message.build_slot_plan``), built here once per
        neighbour list instead of once per call."""
        dev = {k: self._dev(v) for k, v in batch.items() if k != keys.POSITIONS}
        if self.device.type == "cuda":
            ei = dev[keys.EDGE_INDEX]
            slot_meta = (dev[keys.K_SRC2], dev[keys.K_DST2], ei[keys.NEIGHBOR_IDX],
                         ei[keys.CENTER_IDX], dev[keys.K_CHUNK_BASE], dev[keys.K_NCHUNKS],
                         dev[keys.K_WSTARTS])
            rows = meta["rows"]
            dev[SLOT_PLAN] = build_slot_plan(slot_meta, rows, rows, meta["bn"], meta["chunk"])
        return dev

    def _mega_eval(self, batch, meta):
        """The device half of the mega route: the model for the layout,
        upload, run, skin-state capture, outputs in the caller's order."""
        apply_mega = self._mega_apply_forward(meta["layout_t"])
        self._mega["geom"] = {"bn": meta["bn"], "pad": meta["pad"],
                              "ext_cap": meta["node_cap"] if meta["has_cell"] else 0}
        dev_static = meta.get("dev_static") or self._mega_upload(batch, meta)
        data = dict(dev_static)
        data[keys.POSITIONS] = self._dev(batch[keys.POSITIONS])
        out = apply_mega(data, True, self.compute_virial)
        if self.skin > 0.0:
            self.n_rebuilds += 1
            self._skin_state = {
                "kind": "mega", "key": meta["key"], "n": meta["n"], "rows": meta["rows"],
                "n_ext": meta["n_ext"], "ext_real": meta["ext_real"],
                "real_rank": meta["real_rank"], "pos_build": meta["pos_build"],
                "cell": meta["cell"], "pbc": meta["pbc"], "charge": meta["charge"],
                "spin": meta["spin"], "dev_static": dev_static,
            }
        self.last_route = "mega"
        # original atom j sits at extended row real_rank[j]
        return self._result(out, meta["real_rank"])

    def _calculate_mega(self, atomic_numbers, positions, ei, n, n_cap, e_cap,
                        charge, spin, cell=None, pbc=None, offs=None):
        """One call on the mega route, or None when the system does not
        fit its contract (:meth:`_mega_host_build`)."""
        built = self._mega_host_build(atomic_numbers, positions, ei, n, n_cap, e_cap,
                                      charge, spin, cell=cell, pbc=pbc, offs=offs)
        if built is None:
            return None
        return self._mega_eval(*built)

    # ------------------------------------------------------------------
    # Verlet skin
    # ------------------------------------------------------------------
    def _skin_schedule_rebuild(self, atomic_numbers, positions, cell, pbc, charge, spin,
                               kind) -> None:
        """Start a rebuild from the current positions in a worker thread
        (host lists and layout, then the upload of the static arrays)."""
        if self._skin_pending is not None or self.skin <= 0.0:
            return
        from concurrent.futures import ThreadPoolExecutor

        if self._skin_executor is None:
            self._skin_executor = ThreadPoolExecutor(max_workers=1,
                                                     thread_name_prefix="xeq-skin")
        z = np.array(atomic_numbers)
        pos = np.array(positions, dtype=np.float64)
        cellc = None if cell is None else np.array(cell, dtype=float)
        pbcc = None if pbc is None else np.array(pbc)
        n = len(z)
        n_cap, e_cap = self._capacities(n)
        r_build = self.cutoff + self.skin

        def job():
            if kind == "mega":
                if cellc is not None:
                    ei, offs = radius_graph_pbc_np(pos, cellc, pbcc, r_build)
                else:
                    ei, _ = radius_graph_np(pos, r_build)
                    offs = None
                built = self._mega_host_build(z, pos, ei, n, n_cap, e_cap, charge, spin,
                                              cell=cellc, pbc=pbcc, offs=offs)
                if built is not None:
                    batch, meta = built
                    meta["dev_static"] = self._mega_upload(batch, meta)
                return ("mega", built)
            ei, offs = radius_graph_pbc_np(pos, cellc, pbcc, r_build)
            if ei.shape[1] > e_cap:
                return None  # capacity overflow: the synchronous path regrows
            edge_index, edge_mask = _padded_edges(ei, e_cap)
            return ("pbc", {
                "ei_dev": self._dev(edge_index), "em_dev": self._dev(edge_mask),
                "co_dev": self._dev(_padded(offs, e_cap)), "n_cap": n_cap, "e_cap": e_cap,
                "pos_build": pos, "n": n,
            })

        tag = (n, None if cellc is None else cellc.tobytes(), charge, spin)
        self._skin_pending = (self._skin_executor.submit(job), tag, self.n_rebuilds)

    def _skin_try_install(self, n, cell, charge, spin) -> None:
        """Swap in a finished background rebuild if it is still for the
        current system and no synchronous rebuild superseded it.  An error
        in the worker propagates."""
        pend = self._skin_pending
        if pend is None:
            return
        fut, tag, gen = pend
        if not fut.done():
            return
        self._skin_pending = None
        res = fut.result()
        if res is None or gen != self.n_rebuilds:
            return
        cur_tag = (n, None if cell is None else np.asarray(cell, float).tobytes(), charge, spin)
        if tag != cur_tag:
            return
        st = self._skin_state
        kind, payload = res
        if kind == "mega":
            if payload is None or st is None or st.get("kind") != "mega":
                return
            _, meta = payload
            if meta["key"] != st["key"]:
                return  # the geometry outgrew the layout: a synchronous rebuild
            self._skin_state = dict(st, **{k: meta[k] for k in (
                "n", "rows", "n_ext", "ext_real", "real_rank", "pos_build", "dev_static")})
        else:
            if st is None or st.get("kind") != "pbc":
                return
            key = ("pbc", payload["n_cap"], payload["e_cap"], charge is not None,
                   spin is not None, True)
            if key != st["key"]:
                return
            self._skin_state = dict(st, **{k: payload[k] for k in (
                "n", "pos_build", "ei_dev", "em_dev", "co_dev")})
        self.n_rebuilds += 1
        self.n_async_swaps += 1

    def _skin_fast(self, atomic_numbers, positions, cell, charge, spin):
        """Reuse the last neighbour build if no atom moved skin/2: only the
        positions are uploaded.  None when a rebuild is needed (drift, a
        cell change, another system)."""
        n = len(atomic_numbers)
        self._skin_try_install(n, cell, charge, spin)
        st = self._skin_state
        if st is None or st["n"] != n or st["charge"] != charge or st["spin"] != spin:
            return None
        if (st["cell"] is None) != (cell is None):
            return None
        if st["cell"] is not None and not np.array_equal(st["cell"],
                                                         np.asarray(cell, dtype=float)):
            return None  # a barostat moved the cell: rebuild
        disp2 = ((np.asarray(positions, dtype=np.float64) - st["pos_build"]) ** 2
                 ).sum(axis=1).max()
        if disp2 >= (0.5 * self.skin) ** 2:
            return None
        if disp2 >= (self.skin_prefetch * 0.5 * self.skin) ** 2:
            # approaching the limit: rebuild in the background from the
            # current positions while this (still valid) list serves
            self._skin_schedule_rebuild(atomic_numbers, positions, st.get("cell"),
                                        st.get("pbc"), charge, spin, st["kind"])
        if st["kind"] == "mega":
            pos_s = np.zeros((st["rows"], 3), dtype=np.float32)
            pos_s[: st["n_ext"]] = positions[st["ext_real"]]
            data = dict(st["dev_static"])
            data[keys.POSITIONS] = self._dev(pos_s)
            out = self._mega["apply"](data, True, self.compute_virial)
            self.last_route = "mega"
            return self._result(out, st["real_rank"])
        out = self._eval_pbc(self._dev(_padded(positions, st["n_cap"])), st["ei_dev"], st["em_dev"], st["co_dev"],
                             st["sb_dev"])
        self.last_route = "plain"
        return self._result(out, slice(0, n))

    def close(self) -> None:
        """Stop the skin's worker thread (after its pending rebuild)."""
        if self._skin_executor is not None:
            self._skin_executor.shutdown(wait=True)
            self._skin_executor = None
            self._skin_pending = None

    # ------------------------------------------------------------------
    def calculate(
        self,
        atomic_numbers: np.ndarray,
        positions: np.ndarray,
        cell: Optional[np.ndarray] = None,
        pbc: Optional[np.ndarray] = None,
        charge: Optional[int] = None,
        spin: Optional[int] = None,
    ) -> Dict[str, np.ndarray]:
        """Energy / forces (/ virial) of one structure, in model units."""
        n = len(atomic_numbers)
        n_cap, e_cap = self._capacities(n)
        has_cell = cell is not None and pbc is not None and np.any(pbc)

        if self.skin > 0.0 and self._skin_state is not None:
            res = self._skin_fast(np.asarray(atomic_numbers), np.asarray(positions),
                                  cell if has_cell else None, charge, spin)
            if res is not None:
                return res

        static_batch = self._make_batch(n_cap, e_cap, atomic_numbers, charge, spin,
                                        cell if has_cell else None)
        pos_pad = _padded(positions, n_cap)
        r_build = self.cutoff + self.skin

        if has_cell:
            ei, offs = radius_graph_pbc_np(positions, cell, pbc, r_build)
            if self._pallas == "mega":
                res = self._calculate_mega(
                    np.asarray(atomic_numbers), np.asarray(positions), ei, n, n_cap, e_cap,
                    charge, spin, cell=np.asarray(cell, dtype=float), pbc=np.asarray(pbc),
                    offs=offs)
                if res is not None:
                    return res
            e_cap = self._edge_capacity(ei.shape[1], e_cap)
            edge_index, edge_mask = _padded_edges(ei, e_cap)
            if self.skin > 0.0:
                static_batch[keys.EDGE_CUTOFF] = np.array([self.cutoff], dtype=np.float32)
            self._ensure_params()
            ei_dev, em_dev = self._dev(edge_index), self._dev(edge_mask)
            co_dev = self._dev(_padded(offs, e_cap))
            sb_dev = {k: self._dev(v) for k, v in static_batch.items()}
            out = self._eval_pbc(self._dev(pos_pad), ei_dev, em_dev, co_dev, sb_dev)
            if self.skin > 0.0:
                self.n_rebuilds += 1
                self._skin_state = {
                    "kind": "pbc",
                    "key": ("pbc", n_cap, e_cap, charge is not None, spin is not None, True),
                    "n": n, "n_cap": n_cap,
                    "pos_build": np.array(positions, dtype=np.float64),
                    "cell": np.array(cell, dtype=float), "pbc": np.array(pbc),
                    "charge": charge, "spin": spin, "ei_dev": ei_dev, "em_dev": em_dev,
                    "co_dev": co_dev, "sb_dev": sb_dev,
                }
        else:
            # the host list probes the edge count (and feeds the mega route);
            # the plain route searches again on the device
            ei, _ = radius_graph_np(
                positions, r_build if (self._pallas == "mega" and self.skin > 0.0)
                else self.cutoff)
            if self._pallas == "mega":
                res = self._calculate_mega(np.asarray(atomic_numbers), np.asarray(positions),
                                           ei, n, n_cap, e_cap, charge, spin)
                if res is not None:
                    return res
            e_cap = self._edge_capacity(ei.shape[1], e_cap)
            self._ensure_params()
            sb_dev = {k: self._dev(v) for k, v in static_batch.items()}
            pos_dev = self._dev(pos_pad)
            while True:
                out, n_found = self._eval_free(pos_dev, sb_dev, n_cap, e_cap)
                # the device search may find more edges than the capacity
                grown = self._edge_capacity(int(n_found), e_cap)
                if grown == e_cap:
                    break
                e_cap = grown
        self.last_route = "plain"
        return self._result(out, slice(0, n))

    # ------------------------------------------------------------------
    def hessian(
        self,
        atomic_numbers: np.ndarray,
        positions: np.ndarray,
        cell: Optional[np.ndarray] = None,
        pbc: Optional[np.ndarray] = None,
        charge: Optional[int] = None,
        spin: Optional[int] = None,
    ) -> np.ndarray:
        """Analytic Hessian of the total energy, [3n, 3n] in model units,
        symmetrised (the JAX Calculator's contract, its ``jax.hessian``).

        The neighbour list is built on the host at the given geometry and
        held fixed through both derivatives, free and periodic (at a fixed
        topology the edge set is locally constant, and the cutoff
        envelopes are smooth at the boundary).  It runs the plain-route
        model that :meth:`_ensure_params` builds, as the JAX Hessian runs
        its non-mega forward: the message kernels' backward has no second
        derivative in position space to offer here.

        The forces come from one ``autograd.grad`` with
        ``create_graph=True``; the rows are vector-Jacobian products of the
        real atoms' 3n force components only, batched with
        ``is_grads_batched=True`` (``vmap`` over the backward graph: every
        op of the plain route has a batching rule), ``HESSIAN_ROWS`` rows at
        a time with the graph retained between passes, which bounds the
        memory of the batched backward for large systems.  f32 matmuls run
        without TF32 unless the Calculator's ``matmul_precision`` asks for
        it."""
        n = len(atomic_numbers)
        n_cap, e_cap = self._capacities(n)
        has_cell = cell is not None and pbc is not None and np.any(pbc)
        if has_cell:
            ei, offs = radius_graph_pbc_np(positions, cell, pbc, self.cutoff)
        else:
            ei, offs = radius_graph_np(positions, self.cutoff)
        e_cap = self._edge_capacity(ei.shape[1], e_cap)
        batch = self._make_batch(n_cap, e_cap, atomic_numbers, charge, spin,
                                 cell if has_cell else None)
        batch[keys.EDGE_INDEX], batch[keys.EDGE_MASK] = _padded_edges(ei, e_cap)
        if has_cell:
            batch[keys.CELL_OFFSETS] = _padded(offs, e_cap)
        module = self._ensure_params()
        data = {k: self._dev(v) for k, v in batch.items()}
        pos = self._dev(_padded(positions, n_cap)).requires_grad_(True)
        rows = []
        with torch.enable_grad():
            data[keys.POSITIONS] = pos
            energy = module(compute_edge_data(data))[keys.TOTAL_ENERGY][0]
            (grad,) = torch.autograd.grad(energy, pos, create_graph=True)
            g = grad[:n].reshape(-1)
            eye = torch.eye(3 * n, dtype=g.dtype, device=g.device)
            for s in range(0, 3 * n, HESSIAN_ROWS):
                (h,) = torch.autograd.grad(g, pos, grad_outputs=eye[s : s + HESSIAN_ROWS],
                                           retain_graph=True, is_grads_batched=True)
                rows.append(h[:, :n].reshape(-1, 3 * n).detach())
        H = torch.cat(rows).cpu().numpy()
        return 0.5 * (H + H.T)


class XequiCalculator:
    """ASE adapter (requires ase): energy, per-atom energies, forces and
    stress in ASE units (eV, Angstrom) from a :class:`Calculator` with the
    virial on.  ``kwargs`` go to the Calculator (``device`` among them)."""

    implemented_properties = ["energy", "energies", "forces", "stress"]

    def __init__(self, ckpt_file: str, **kwargs) -> None:
        from ase.calculators.calculator import Calculator as ASECalcBase

        self._core = Calculator(ckpt_file, compute_virial=True, **kwargs)
        units_map = self._core.units
        self._e_conv = unit_conversion(units_map.get(keys.TOTAL_ENERGY, "eV"), "eV")
        self._l_conv = unit_conversion(units_map.get(keys.POSITIONS, "Angstrom"), "Angstrom")
        self.results: Dict = {}

        class _Adapter(ASECalcBase):
            implemented_properties = self.implemented_properties

            def calculate(inner, atoms=None, properties=("energy",), system_changes=()):
                ASECalcBase.calculate(inner, atoms, properties, system_changes)
                inner.results = self._compute(atoms)

        self._adapter_cls = _Adapter

    def as_ase(self):
        return self._adapter_cls()

    def _compute(self, atoms) -> Dict[str, np.ndarray]:
        info = atoms.info
        periodic = bool(np.any(atoms.pbc))
        res = self._core.calculate(
            atoms.get_atomic_numbers(),
            atoms.get_positions() / self._l_conv,
            cell=np.asarray(atoms.cell) / self._l_conv if periodic else None,
            pbc=np.asarray(atoms.pbc) if periodic else None,
            charge=info.get("charge"),
            spin=(info.get("multiplicity", 1) - 1) if "multiplicity" in info else None,
        )
        e_f = self._e_conv
        out = {"energy": res[keys.TOTAL_ENERGY] * e_f,
               "forces": res[keys.FORCES] * (e_f / self._l_conv)}
        if keys.ATOMIC_ENERGIES in res:
            out["energies"] = res[keys.ATOMIC_ENERGIES] * e_f
        if keys.VIRIAL in res and periodic:
            # stress = -virial / volume, symmetrised, in Voigt order
            # (xx, yy, zz, yz, xz, xy)
            s = -res[keys.VIRIAL] * e_f / atoms.get_volume()
            s = 0.5 * (s + s.T)
            out["stress"] = np.array([s[0, 0], s[1, 1], s[2, 2], s[1, 2], s[0, 2], s[0, 1]])
        return out
