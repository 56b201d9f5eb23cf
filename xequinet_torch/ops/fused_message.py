"""Fused XPaiNN message op: the whole per-edge pipeline of one message
block, as hand-written CUDA kernels for Hopper with plain PyTorch beside
them.

Port of ``xequinet_tpu/ops/pallas_message.py``: ``_kernel`` (:177, via
``_mega_call`` :264-325) becomes ``csrc/message_fwd.cu``, ``_bwd_kernel``
(:331, via ``_mega_bwd_call`` :458-557) becomes ``csrc/message_bwd.cu``
and ``_bwd2_kernel`` (:563, via ``_mega_bwd2_call`` :770-879), the
second order that force training runs, becomes ``csrc/message_bwd2.cu``;
the source notes there say what bounds each on the H100 and what the
design does about it.  Per slot (a padded edge of
the block-aligned layout of ``ops/slot_layout.py``):

    fw        = ef @ Wf_aug                  [Hp]   radial filter
    filter_out= x_cat[src, :Hp] * fw         [Hp]
    msg_v     = x_cat[src, Hp:] * (filter_out @ E1) + (ef @ BY) * (filter_out @ E2)
    msg_s     = filter_out @ MS
    out[dst] += [msg_s | msg_v]              [SDp + Dp]

``edge_feat`` packs ``[rbf*fcut | fcut | Y_unique | 0]`` per slot, so
``ef @ Wf_aug`` is ``(rbf @ W + b) * fcut`` with ``Wf_aug = [W ; b]``.
E1/E2/MS/BY are 0/1 structure matrices; the plain version multiplies by
them, the kernels use them as index maps.

Dispatch: a wrapper runs the plain version only for tensors on the CPU
(the tests); for CUDA tensors it launches its kernel or raises.  The
kernels are built, loaded and counted by ``ops/cuda_build.py`` (its
``LAUNCHES``, ``reset_launch_counts`` and ``build_kernels`` are
importable from here too).
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch

from .cuda_build import BUILD_INFO, LAUNCHES, build_kernels, reset_launch_counts  # noqa: F401
from .cuda_build import launch
from .irreps import Irreps

F_PACK = 128  # packed edge-feature width


def _pad128(n: int) -> int:
    return ((n + 127) // 128) * 128


def _distinct_ls(irreps: Irreps):
    out = []
    for _, ir in irreps:
        if ir.l not in out:
            out.append(ir.l)
    return out


def _y_columns(irreps: Irreps, num_basis: int):
    """({l: first packed edge-feature column of Y_l}, end column): the
    harmonics follow ``[rbf*fcut | fcut]``, one block per distinct l."""
    ycol = {}
    off = num_basis + 1
    for l in _distinct_ls(irreps):
        ycol[l] = off
        off += 2 * l + 1
    if off > F_PACK:
        raise ValueError("packed edge features exceed 128 lanes")
    return ycol, off


@functools.lru_cache(maxsize=None)
def structure_matrices(irreps_str: str, num_basis: int, node_dim: int):
    """(E1, E2, MS, BY, dims) as numpy f32 (pallas_message.py:74-118);
    dims = (H, Hp, D, Dp, SDp, nY) with H = node_dim + 2 * num_irreps."""
    irreps = Irreps(irreps_str)
    ni, d = irreps.num_irreps, irreps.dim
    h = node_dim + 2 * ni
    hp, dp, sdp = _pad128(h), _pad128(d), _pad128(node_dim)
    e1 = np.zeros((hp, dp), dtype=np.float32)
    e2 = np.zeros((hp, dp), dtype=np.float32)
    gate = 0
    lane = 0
    for mul, ir in irreps:
        for _ in range(mul):
            e1[gate, lane : lane + ir.dim] = 1.0
            e2[ni + gate, lane : lane + ir.dim] = 1.0
            gate += 1
            lane += ir.dim
    ms = np.zeros((hp, sdp), dtype=np.float32)
    ms[2 * ni : 2 * ni + node_dim, :node_dim] = np.eye(node_dim)
    ycol, off = _y_columns(irreps, num_basis)
    by = np.zeros((F_PACK, dp), dtype=np.float32)
    lane = 0
    for mul, ir in irreps:
        for _ in range(mul):
            for m in range(ir.dim):
                by[ycol[ir.l] + m, lane + m] = 1.0
            lane += ir.dim
    return e1, e2, ms, by, (h, hp, d, dp, sdp, off - num_basis - 1)


@functools.lru_cache(maxsize=None)
def index_maps(irreps_str: str, num_basis: int):
    """The structure matrices as the kernels read them (int32 numpy):
    lane_gate [D] (E1/E2: irrep of lane j), lane_ycol [D] (BY: packed
    column of lane j's harmonic), gate_lane0 / gate_dim [ni] (lanes of
    irrep u), ylane_ptr [nY+1] / ylane_idx (lanes of each harmonic
    column, ascending)."""
    irreps = Irreps(irreps_str)
    ycol, off = _y_columns(irreps, num_basis)
    lane_gate, lane_ycol, gate_lane0, gate_dim = [], [], [], []
    gate = 0
    lane = 0
    for mul, ir in irreps:
        for _ in range(mul):
            gate_lane0.append(lane)
            gate_dim.append(ir.dim)
            for m in range(ir.dim):
                lane_gate.append(gate)
                lane_ycol.append(ycol[ir.l] + m)
            gate += 1
            lane += ir.dim
    lane_ycol_a = np.asarray(lane_ycol, dtype=np.int32)
    n_y = off - num_basis - 1
    ylane_idx, ylane_ptr = [], [0]
    for y in range(n_y):
        js = np.nonzero(lane_ycol_a == num_basis + 1 + y)[0]
        ylane_idx.extend(js.tolist())
        ylane_ptr.append(len(ylane_idx))
    as32 = lambda a: np.asarray(a, dtype=np.int32)
    return {
        "lane_gate": as32(lane_gate), "lane_ycol": lane_ycol_a,
        "gate_lane0": as32(gate_lane0), "gate_dim": as32(gate_dim),
        "ylane_ptr": as32(ylane_ptr), "ylane_idx": as32(ylane_idx),
    }


_DEVICE_MAPS: Dict[tuple, Dict[str, torch.Tensor]] = {}


def _device_maps(irreps_str: str, num_basis: int, device) -> Dict[str, torch.Tensor]:
    key = (irreps_str, num_basis, str(device))
    if key not in _DEVICE_MAPS:
        _DEVICE_MAPS[key] = {
            k: torch.as_tensor(v, device=device)
            for k, v in index_maps(irreps_str, num_basis).items()
        }
    return _DEVICE_MAPS[key]


def pack_edge_features(
    rbf: torch.Tensor,  # [T, nb]
    fcut: torch.Tensor,  # [T, 1]
    vec_irrep: torch.Tensor,  # [T, 3] (irrep basis, y,z,x)
    irreps: Irreps,
) -> torch.Tensor:
    """[T, 128] packed ``[rbf*fcut | fcut | Y_unique | 0]``
    (pallas_message.py:151-171), shared by all message blocks."""
    from .spherical import spherical_harmonics

    unique = Irreps(
        "+".join(f"1x{l}{'e' if (-1) ** l == 1 else 'o'}" for l in _distinct_ls(Irreps(irreps)))
    )
    y = spherical_harmonics(unique, vec_irrep, normalize=True)
    cols = torch.cat([rbf * fcut, fcut, y.to(rbf.dtype)], dim=-1)
    return torch.nn.functional.pad(cols, (0, F_PACK - cols.shape[1]))


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path, and the yardstick of the kernels)
# ---------------------------------------------------------------------------
def plain_message(
    x_cat, edge_feat, wf_aug, src_g, dst_g, edge_mask,
    irreps_str, num_basis, node_dim, n_out, compute_dtype=torch.float32,
):
    """Port of ``xla_reference`` (pallas_message.py:885-908) over the
    global slot arrays; differentiable.  In bf16 ``compute_dtype`` every
    product takes bf16 inputs and rounds its result to bf16, as XLA does."""
    e1, e2, ms, by, (h, hp, d, dp, sdp, n_y) = structure_matrices(
        irreps_str, num_basis, node_dim
    )
    cd = compute_dtype
    dev = x_cat.device
    mat = lambda a: torch.as_tensor(a, device=dev).to(cd)
    ef = edge_feat.to(cd)
    fw = (ef @ wf_aug.to(cd)).float()
    gathered = x_cat.to(cd)[src_g.long()].float()
    filter_out = (gathered[:, :hp] * fw).to(cd)
    g1x = (filter_out @ mat(e1)).float()
    g2x = (filter_out @ mat(e2)).float()
    rshx = (ef @ mat(by)).float()
    msg_v = gathered[:, hp:] * g1x + rshx * g2x
    msg_s = (filter_out @ mat(ms)).float()
    msg = torch.cat([msg_s, msg_v], dim=-1)
    msg = torch.where(edge_mask[:, None], msg, torch.zeros_like(msg))
    out = torch.zeros((n_out, msg.shape[1]), dtype=msg.dtype, device=dev)
    return out.index_add(0, dst_g.long(), msg)


def plain_message_bwd(
    x_cat, edge_feat, wf_aug, g, src_g, dst_g, edge_mask,
    irreps_str, num_basis, node_dim, n_out, compute_dtype=torch.float32,
    create_graph: bool = False,
):
    """(dx_cat, d_edge_feat, d_wf_aug): the VJP of :func:`plain_message`
    for the cotangent ``g`` (torch.autograd.grad of it)."""
    with torch.enable_grad():
        ins = [
            t if (create_graph and t.requires_grad) else t.detach().requires_grad_()
            for t in (x_cat, edge_feat, wf_aug)
        ]
        out = plain_message(
            *ins, src_g, dst_g, edge_mask, irreps_str, num_basis, node_dim,
            n_out, compute_dtype,
        )
        return torch.autograd.grad(out, ins, g, create_graph=create_graph)


def message_bwd_rows(
    x_cat, edge_feat, wf_aug, g, src_g, dst_g, edge_mask,
    irreps_str, num_basis, node_dim, compute_dtype=torch.float32,
):
    """The first-order VJP per slot, as the bf16 tile pass of
    ``csrc/message_bwd.cu`` (and ``_bwd_kernel``, pallas_message.py:386-448)
    computes it: with fw = ef@W, [gs|gv] = x[src], fo = gs*fw, rsh = ef@BY,
    gms = g[dst] and dfo = (gv*gms_v)@E1' + (rsh*gms_v)@E2' + gms_s@MS',

        rows = [dgs | dgv] = [dfo*fw | (fo@E1)*gms_v]   [T, H + D]
        dfw  = dfo*gs,  drsh = (fo@E2)*gms_v
        d_ef = dfw@W' + drsh@BY'                        [T, 128]
        d_wf = ef'@dfw                                  [128, Hp]

    Returns (rows, dfw [T, H], d_ef, d_wf), zero on slots that add nothing
    (``edge_mask`` False).  ``dx`` is the sum of the rows by source: the
    kernel's second pass (``[dgs | dgv]`` into columns ``[:H]`` and
    ``[Hp:Hp+D]``).  In bf16 ``compute_dtype`` it rounds where the TPU
    kernel rounds (the operands, fo, the gate products, dgs, dgv, dfw and
    drsh); sums are f32."""
    e1, e2, ms, by, (h, hp, d, dp, sdp, n_y) = structure_matrices(
        irreps_str, num_basis, node_dim
    )
    dev = x_cat.device
    rnd = lambda t: t.to(compute_dtype).float()
    mat = lambda a: torch.as_tensor(a, device=dev)
    e1, e2, ms, by = mat(e1), mat(e2), mat(ms), mat(by)
    x, ef, wf, gq = rnd(x_cat), rnd(edge_feat), rnd(wf_aug), rnd(g)
    gm = torch.where(edge_mask[:, None], gq[dst_g.long()], torch.zeros((), device=dev))
    gms_s, gms_v = gm[:, :sdp], gm[:, sdp:]
    xs = x[src_g.long()]
    gs, gv = xs[:, :hp], xs[:, hp:]
    fw, rsh = ef @ wf, ef @ by
    fo = rnd(gs * fw)
    dfo = rnd(gv * gms_v) @ e1.t() + rnd(rsh * gms_v) @ e2.t() + gms_s @ ms.t()
    dfw = rnd(dfo * gs)
    drsh = rnd((fo @ e2) * gms_v)
    rows = torch.cat([rnd(dfo * fw)[:, :h], rnd((fo @ e1) * gms_v)[:, :d]], dim=-1)
    return rows, dfw[:, :h], dfw @ wf.t() + drsh @ by.t(), ef.t() @ dfw


def plain_message_bwd2(
    x_cat, edge_feat, wf_aug, g, cx, cef, cwf, src_g, dst_g, edge_mask,
    irreps_str, num_basis, node_dim, n_out, compute_dtype=torch.float32,
    create_graph: bool = False,
):
    """(d2x_cat, d2_edge_feat, d2_wf_aug, d2g): the VJP of
    :func:`plain_message_bwd` w.r.t. (x_cat, edge_feat, wf_aug, g) for the
    cotangents (cx, cef, cwf) on its outputs, ``None`` meaning zero.  Port
    of ``_fmb_bwd``'s double VJP of the XLA backward
    (pallas_message.py:1032-1047)."""
    cots = (cx, cef, cwf)
    with torch.enable_grad():
        ins = [
            t if (create_graph and t.requires_grad) else t.detach().requires_grad_()
            for t in (x_cat, edge_feat, wf_aug, g)
        ]
        outs = plain_message_bwd(
            *ins, src_g, dst_g, edge_mask, irreps_str, num_basis, node_dim,
            n_out, compute_dtype, create_graph=True,
        )
        used = [(o, c) for o, c in zip(outs, cots) if c is not None]
        grads = [None] * 4
        if used:
            grads = torch.autograd.grad(
                [o for o, _ in used], ins, [c for _, c in used],
                create_graph=create_graph, allow_unused=True,
            )
    return tuple(torch.zeros_like(t) if d is None else d for t, d in zip(ins, grads))


def message_bwd2_closed(
    x_cat, edge_feat, wf_aug, g, cx, cef, cwf, src_g, dst_g, edge_mask,
    irreps_str, num_basis, node_dim, n_out, compute_dtype=torch.float32,
):
    """The same second order in closed form, as ``_bwd2_kernel`` computes it
    (pallas_message.py:591-610): per slot, with fw = ef@W, [gs|gv] = x[src],
    fo = gs*fw, g1|g2 = fo@E1|E2, rsh = ef@BY, gms = g[dst] and
    dfo = (gv*gms_v)@E1' + (rsh*gms_v)@E2' + gms_s@MS',

        R  = cef@W + ef@cwf,  A = cxh*fw + R*gs,
        U  = (cxv*gms_v)@E1' + ((cef@BY)*gms_v)@E2',
        d2g[dst]  += [A@MS | gv*(A@E1) + rsh*(A@E2) + cxv*g1 + g2*(cef@BY)]
        d2x[src]  += [dfo*R + U*fw | gms_v*(A@E1)]
        d2ef       = (dfo*cxh + U*gs)@W' + (gms_v*(A@E2))@BY' + (dfo*gs)@cwf'
        d2wf      += ef'@(dfo*cxh + U*gs) + cef'@(dfo*gs)

    In bf16 ``compute_dtype`` it rounds where the TPU kernel rounds (the
    operands, fo, dfo's and U's products, A, the d2x / d2g rows and the
    two fw cotangents); sums are f32.  ``None`` cotangents are zero.  The
    CUDA kernel follows this form; the tests hold it against
    :func:`plain_message_bwd2`."""
    e1, e2, ms, by, (h, hp, d, dp, sdp, n_y) = structure_matrices(
        irreps_str, num_basis, node_dim
    )
    dev = x_cat.device
    cd = compute_dtype
    rnd = lambda t: t.to(cd).float()
    mat = lambda a: torch.as_tensor(a, device=dev)
    e1, e2, ms, by = mat(e1), mat(e2), mat(ms), mat(by)
    zero_or = lambda t, like: torch.zeros_like(like) if t is None else t
    cx, cef, cwf = zero_or(cx, x_cat), zero_or(cef, edge_feat), zero_or(cwf, wf_aug)
    x, ef, wf, gq = rnd(x_cat), rnd(edge_feat), rnd(wf_aug), rnd(g)
    cx, cef, cwf = rnd(cx), rnd(cef), rnd(cwf)
    src, dst = src_g.long(), dst_g.long()
    valid = edge_mask[:, None]
    gm = torch.where(valid, gq[dst], torch.zeros((), device=dev))
    gms_s, gms_v = gm[:, :sdp], gm[:, sdp:]
    xs, cxs = x[src], cx[src]
    gs, gv, cxh, cxv = xs[:, :hp], xs[:, hp:], cxs[:, :hp], cxs[:, hp:]
    fw, rsh = ef @ wf, ef @ by
    fo = rnd(gs * fw)
    g1, g2 = fo @ e1, fo @ e2
    dfo = rnd(gv * gms_v) @ e1.t() + rnd(rsh * gms_v) @ e2.t() + gms_s @ ms.t()
    cefby = cef @ by
    r_cot = cef @ wf + ef @ cwf
    a_cot = rnd(cxh * fw + r_cot * gs)
    ae1, ae2, ams = a_cot @ e1, a_cot @ e2, a_cot @ ms
    u_cot = rnd(cxv * gms_v) @ e1.t() + rnd(cefby * gms_v) @ e2.t()
    dfw2 = rnd(dfo * cxh + u_cot * gs)
    dfwr = rnd(dfo * gs)
    d2ef = dfw2 @ wf.t() + rnd(gms_v * ae2) @ by.t() + dfwr @ cwf.t()
    d2wf = ef.t() @ dfw2 + cef.t() @ dfwr
    d2x_rows = torch.cat([rnd(dfo * r_cot + u_cot * fw), rnd(gms_v * ae1)], dim=-1)
    d2x = torch.zeros_like(x).index_add(0, src, d2x_rows)
    d2g_rows = torch.cat(
        [rnd(ams), rnd(gv * ae1 + rsh * ae2 + cxv * g1 + g2 * cefby)], dim=-1
    )
    d2g_rows = torch.where(valid, d2g_rows, torch.zeros((), device=dev))
    d2g = torch.zeros((n_out, sdp + dp), device=dev).index_add(0, dst, d2g_rows)
    return d2x, d2ef, d2wf, d2g


def message_bwd2_rows(
    x_cat, edge_feat, wf_aug, g, cx, cef, cwf, src_g, dst_g, edge_mask,
    irreps_str, num_basis, node_dim, compute_dtype=torch.float32,
):
    """The second order per slot, as the bf16 tile pass of
    ``csrc/message_bwd2.cu`` computes it: the index maps (each lane's gate
    and harmonic column) in place of E1 / E2 / MS / BY, with fw = ef@W,
    r = cef@W + ef@cwf, fo = gs*fw, a = cxh*fw + r*gs and the gate sums
    dfo[u] = sum_j gv*gms_v, dfo[ni+u] = sum_j ef[ycol]*gms_v,
    dfo[2ni+c] = gms_s[c], u[u] = sum_j cxv*gms_v, u[ni+u] = sum_j
    cef[ycol]*gms_v (j over the lanes of irrep u):

        rows_x = [dfo*r + u*fw | gms_v*a[gate]]                        [T, H + D]
        rows_g = [a[2ni:] | gv*a[gate] + ef[ycol]*a[ni+gate]
                            + cxv*fo[gate] + fo[ni+gate]*cef[ycol]]     [T, node_dim + D]
        dfw2 = dfo*cxh + u*gs,  dfwr = dfo*gs                          [T, H]
        d2ef = dfw2@W' + dfwr@cwf' + (the lanes' gms_v*a[ni+gate] summed
               into their harmonic columns)                            [T, 128]
        d2wf = ef'@dfw2 + cef'@dfwr                                    [128, Hp]

    Zero on slots that add nothing (``edge_mask`` False); ``None``
    cotangents are zero.  ``d2x`` is the sum of rows_x by source (columns
    ``[:H]`` and ``[Hp:Hp+D]``) and ``d2g`` that of rows_g by destination
    (``[:node_dim]`` and ``[SDp:SDp+D]``): the kernel's row passes.  In
    bf16 ``compute_dtype`` it rounds where the TPU kernel rounds (the
    operands, fo, a, the gate-sum products, the rows, dfw2, dfwr and the
    harmonic terms); sums are f32."""
    _, _, _, _, (h, hp, d, dp, sdp, n_y) = structure_matrices(irreps_str, num_basis, node_dim)
    ni = Irreps(irreps_str).num_irreps
    dev = x_cat.device
    maps = index_maps(irreps_str, num_basis)
    lg = torch.as_tensor(maps["lane_gate"], device=dev).long()
    ly = torch.as_tensor(maps["lane_ycol"], device=dev).long()
    rnd = lambda t: t.to(compute_dtype).float()
    zero_or = lambda t, like: torch.zeros_like(like) if t is None else t
    cx, cef, cwf = zero_or(cx, x_cat), zero_or(cef, edge_feat), zero_or(cwf, wf_aug)
    x, ef, wf, gq, cx, cef, cwf = map(rnd, (x_cat, edge_feat, wf_aug, g, cx, cef, cwf))
    valid = edge_mask[:, None]
    src, dst = src_g.long(), dst_g.long()
    mask = lambda t: torch.where(valid, t, torch.zeros((), device=dev))
    gm = mask(gq[dst])
    gms_s, gms_v = gm[:, :node_dim], gm[:, sdp:sdp + d]
    xs, cxs = x[src], cx[src]
    gs, gv, cxh, cxv = xs[:, :h], xs[:, hp:hp + d], cxs[:, :h], cxs[:, hp:hp + d]
    w, cw = wf[:, :h], cwf[:, :h]
    fw, r = ef @ w, cef @ w + ef @ cw
    fo, a = rnd(gs * fw), rnd(cxh * fw + r * gs)
    ey, cy = ef[:, ly], cef[:, ly]
    lanes = lambda v: torch.zeros(v.shape[0], ni, device=dev).index_add(1, lg, v)
    none = torch.zeros(gm.shape[0], node_dim, device=dev)
    dfo = torch.cat([lanes(rnd(gv * gms_v)), lanes(rnd(ey * gms_v)), gms_s], 1)
    u = torch.cat([lanes(rnd(cxv * gms_v)), lanes(rnd(cy * gms_v)), none], 1)
    dfw2, dfwr = mask(rnd(dfo * cxh + u * gs)), mask(rnd(dfo * gs))
    rows_x = torch.cat([rnd(dfo * r + u * fw), rnd(gms_v * a[:, lg])], 1)
    rows_g = torch.cat([a[:, 2 * ni:], rnd(gv * a[:, lg] + ey * a[:, ni + lg]
                                          + cxv * fo[:, lg] + fo[:, ni + lg] * cy)], 1)
    d2ef = dfw2 @ w.t() + dfwr @ cw.t()
    d2ef = d2ef.index_add(1, ly, rnd(gms_v * a[:, ni + lg]))
    d2wf = torch.zeros_like(wf)
    d2wf[:, :h] = ef.t() @ dfw2 + cef.t() @ dfwr
    return mask(rows_x), mask(rows_g), dfw2, dfwr, mask(d2ef), d2wf


# ---------------------------------------------------------------------------
# Slot plan: the CSR lists by destination and by source the kernels walk
# ---------------------------------------------------------------------------
def slot_rows(src2, dst2, chunk_base, n_chunks, window_starts, n_out: int, n_rows: int,
              block_nodes: int, chunk: int):
    """(src_row, dst_row, valid) per slot, int64 / bool: the global source
    and destination rows the slot layout names, and whether the slot adds
    anything (not padding, dst2 == BN; inside the covered chunk range;
    rows inside the output and the source array)."""
    dev = src2.device
    k = torch.arange(src2.shape[0], device=dev, dtype=torch.int64)
    cb64 = chunk_base.long()
    blk = torch.searchsorted(cb64, k // chunk, right=True) - 1
    blk = blk.clamp(0, cb64.numel() - 1)
    n_cov = chunk * (cb64[-1] + n_chunks.long()[-1])
    src_row = window_starts.long()[blk] + src2.long()
    dst_row = blk * block_nodes + dst2.long()
    valid = (dst2.long() < block_nodes) & (k < n_cov) & (dst_row < n_out) & (src_row < n_rows)
    return src_row, dst_row, valid


def build_slot_plan(slot_meta, n_out: int, n_rows: int, block_nodes: int,
                    chunk: int) -> Dict[str, torch.Tensor]:
    """From (src2, dst2, _, _, chunk_base, n_chunks, window_starts):
    per slot its global source / destination row (-1 destination on
    padding slots, dst2 == BN, and on slots past the covered chunk range),
    stable CSR orderings of the valid slots by destination and by source,
    and per slot its position in each list (``src_pos``, ``dst_pos``; -1 on
    slots that add nothing): the scratch rows of the backward kernels' bf16
    tile passes.  Index glue in plain tensor ops, on the slots' device."""
    src2, dst2, _, _, cb, nc, ws = slot_meta[:7]
    dev = src2.device
    src_row, dst_row, valid = slot_rows(src2, dst2, cb, nc, ws, n_out, n_rows,
                                        block_nodes, chunk)

    def csr(key, n):
        key = torch.where(valid, key, torch.full_like(key, n))
        order = torch.argsort(key, stable=True)
        counts = torch.bincount(key, minlength=n + 1)[:n]
        ptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
        ptr[1:] = torch.cumsum(counts, 0)
        return ptr.int().contiguous(), order.int().contiguous()

    n_valid = valid.sum()

    def positions(slots):  # the valid slots come first in the stable sort
        pos = torch.arange(slots.numel(), device=dev, dtype=torch.int32)
        return torch.full_like(slots, -1).index_copy_(
            0, slots.long(), torch.where(pos < n_valid, pos, -1))

    dst_ptr, dst_slots = csr(dst_row, n_out)
    src_ptr, src_slots = csr(src_row, n_rows)
    return {
        "slot_src": torch.where(valid, src_row, 0).int().contiguous(),
        "slot_dst": torch.where(valid, dst_row, -1).int().contiguous(),
        "dst_ptr": dst_ptr, "dst_slots": dst_slots, "dst_pos": positions(dst_slots),
        "src_ptr": src_ptr, "src_slots": src_slots, "src_pos": positions(src_slots),
    }


def _plan(slot_meta, n_out, n_rows, block_nodes, chunk):
    if len(slot_meta) > 7 and slot_meta[7] is not None:
        return slot_meta[7]
    return build_slot_plan(slot_meta, n_out, n_rows, block_nodes, chunk)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------
def _check_cuda(*tensors):
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError("fused message: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError("fused message: tensors must be contiguous")


def _launch_dims(irreps_str, num_basis, node_dim):
    irreps = Irreps(irreps_str)
    if any(ir.dim > 5 for _, ir in irreps):
        raise ValueError("the message kernels take irreps with l <= 2")
    _, _, _, _, (h, hp, d, dp, sdp, n_y) = structure_matrices(
        irreps_str, num_basis, node_dim
    )
    return irreps.num_irreps, h, hp, d, dp, sdp, num_basis + 1, num_basis + 1 + n_y


def _mm_dtype(mm_dtype) -> torch.dtype:
    return torch.bfloat16 if str(mm_dtype) in ("bfloat16", "torch.bfloat16") else torch.float32


def message_fwd_cuda(
    x_cat, edge_feat, wf_aug, slot_meta,
    irreps_str, num_basis, node_dim, n_out, block_nodes, chunk, mm_dtype,
) -> torch.Tensor:
    """agg [n_out, SDp+Dp] f32 by ``csrc/message_fwd.cu``."""
    if not x_cat.is_cuda:
        raise ValueError("message_fwd_cuda takes CUDA tensors")
    ni, h, hp, d, dp, sdp, kw, kf = _launch_dims(irreps_str, num_basis, node_dim)
    mm = _mm_dtype(mm_dtype)
    if mm == torch.bfloat16 and (kf > 32 or sdp + dp > 1280):
        raise ValueError("the bf16 message forward takes num_basis + 1 + nY <= 32 "
                         "edge-feature columns and SDp + Dp <= 1280 output columns")
    if x_cat.shape[1] != hp + dp or edge_feat.shape[1] != F_PACK or wf_aug.shape != (F_PACK, hp):
        raise ValueError("fused message: operand shapes do not match the irreps")
    xk = x_cat.to(mm).contiguous()
    efk = edge_feat.to(mm).contiguous()
    wfk = wf_aug.to(mm).contiguous()
    plan = _plan(slot_meta, n_out, x_cat.shape[0], block_nodes, chunk)
    maps = _device_maps(irreps_str, num_basis, x_cat.device)
    out = torch.empty((n_out, sdp + dp), dtype=torch.float32, device=x_cat.device)
    _check_cuda(xk, efk, wfk, plan["dst_ptr"], out)
    if any(t.data_ptr() % 16 for t in (xk, efk)):
        raise ValueError("fused message: operands must be 16-byte aligned")
    launch(
        "message_fwd",
        xk.data_ptr(), efk.data_ptr(), wfk.data_ptr(), plan["dst_ptr"].data_ptr(),
        plan["dst_slots"].data_ptr(), plan["slot_src"].data_ptr(),
        plan["slot_dst"].data_ptr(), maps["lane_gate"].data_ptr(),
        maps["lane_ycol"].data_ptr(), out.data_ptr(),
        n_out, ni, node_dim, hp, d, dp, sdp, kw, kf, int(mm == torch.bfloat16),
        torch.cuda.current_stream(x_cat.device).cuda_stream,
    )
    return out


def message_bwd_cuda(
    x_cat, edge_feat, wf_aug, g, slot_meta,
    irreps_str, num_basis, node_dim, n_out, block_nodes, chunk, mm_dtype,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx_cat, d_edge_feat, d_wf_aug), f32, by ``csrc/message_bwd.cu``.
    In bf16 the tile pass writes each valid slot's ``[dgs | dgv]`` row to a
    bf16 scratch of :func:`bwd_scratch_shape` (at the slot's position in
    the list by source), which the dx pass sums by source."""
    if not x_cat.is_cuda:
        raise ValueError("message_bwd_cuda takes CUDA tensors")
    ni, h, hp, d, dp, sdp, kw, kf = _launch_dims(irreps_str, num_basis, node_dim)
    mm = _mm_dtype(mm_dtype)
    bf16 = mm == torch.bfloat16
    if bf16 and (kf > 32 or h > 768):
        raise ValueError("the bf16 message backward takes num_basis + 1 + nY <= 32 "
                         "edge-feature columns and a filter width H <= 768")
    dev = x_cat.device
    n_rows, t_slots = x_cat.shape[0], edge_feat.shape[0]
    xk = x_cat.to(mm).contiguous()
    efk = edge_feat.to(mm).contiguous()
    wfk = wf_aug.to(mm).contiguous()
    gk = g.to(mm).contiguous()
    plan = _plan(slot_meta, n_out, n_rows, block_nodes, chunk)
    maps = _device_maps(irreps_str, num_basis, dev)
    n_part = torch.cuda.get_device_properties(dev).multi_processor_count
    dx = torch.empty((n_rows, hp + dp), dtype=torch.float32, device=dev)
    d_ef = torch.empty((t_slots, F_PACK), dtype=torch.float32, device=dev)
    dwf_part = torch.empty((n_part, kf, h), dtype=torch.float32, device=dev)
    d_wf = torch.empty((F_PACK, hp), dtype=torch.float32, device=dev)
    rows = torch.empty(bwd_scratch_shape(t_slots, h, d) if bf16 else (0,),
                       dtype=torch.bfloat16, device=dev)
    _check_cuda(xk, efk, wfk, gk, plan["src_ptr"], dx, rows)
    if any(t.data_ptr() % 16 for t in (xk, efk, gk)):
        raise ValueError("fused message: operands must be 16-byte aligned")
    launch(
        "message_bwd",
        xk.data_ptr(), efk.data_ptr(), wfk.data_ptr(), gk.data_ptr(),
        plan["src_ptr"].data_ptr(), plan["src_slots"].data_ptr(),
        plan["slot_src"].data_ptr(), plan["slot_dst"].data_ptr(),
        plan["src_pos"].data_ptr(),
        maps["lane_gate"].data_ptr(), maps["lane_ycol"].data_ptr(),
        maps["gate_lane0"].data_ptr(), maps["gate_dim"].data_ptr(),
        maps["ylane_ptr"].data_ptr(), maps["ylane_idx"].data_ptr(), rows.data_ptr(),
        dx.data_ptr(), d_ef.data_ptr(), dwf_part.data_ptr(), d_wf.data_ptr(),
        n_rows, t_slots, n_part, ni, h, hp, d, dp, sdp, kw, kf,
        int(bf16), torch.cuda.current_stream(dev).cuda_stream,
    )
    return dx, d_ef, d_wf


def _round8(n: int) -> int:
    return (n + 7) // 8 * 8


def bwd_scratch_shape(t_slots: int, h: int, d: int) -> Tuple[int, int]:
    """The bf16 backward's scratch: one ``[dgs | dgv]`` row per slot, H and
    D each rounded up to 8 columns (16-byte rows)."""
    return t_slots, _round8(h) + _round8(d)


def bwd2_scratch_shapes(t_slots: int, h: int, node_dim: int,
                        d: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """The bf16 second order's scratch without cwf: one d2x row ``[H | D]``
    and one d2g row ``[node_dim | D]`` per slot, each part rounded up to 8
    columns (16-byte rows)."""
    return bwd_scratch_shape(t_slots, h, d), (t_slots, _round8(node_dim) + _round8(d))


def message_bwd2_cuda(
    x_cat, edge_feat, wf_aug, g, cx, cef, cwf, slot_meta,
    irreps_str, num_basis, node_dim, n_out, block_nodes, chunk, mm_dtype,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(d2x_cat, d2_edge_feat, d2_wf_aug, d2g), f32, by
    ``csrc/message_bwd2.cu``: the VJP of :func:`message_bwd_cuda` for the
    cotangents (cx, cef, cwf).  In bf16 without cwf the tile pass writes
    each valid slot's d2x and d2g rows to the bf16 scratch of
    :func:`bwd2_scratch_shapes` (at its positions in the lists by source
    and by destination), which the row passes sum.

    A ``None`` cx or cef is materialized as zeros; a ``None`` cwf (force
    training: ``wf_aug`` is not on the path to the positions) selects the
    kernel's specialization without the cwf terms.  As for the operands
    (``edge_feat`` columns >= Kf and ``wf_aug`` rows >= Kw are zero), the
    kernel takes the cotangents the model hands it: ``cef`` columns >= Kf
    and ``cwf`` rows >= Kf are zero, because ``pack_edge_features`` and the
    ``wf_aug`` probe pad those entries with constants."""
    if not x_cat.is_cuda:
        raise ValueError("message_bwd2_cuda takes CUDA tensors")
    ni, h, hp, d, dp, sdp, kw, kf = _launch_dims(irreps_str, num_basis, node_dim)
    mm = _mm_dtype(mm_dtype)
    tiles = mm == torch.bfloat16 and cwf is None
    if tiles and (kf > 32 or h > 768):
        raise ValueError("the bf16 message second order takes num_basis + 1 + nY <= 32 "
                         "edge-feature columns and a filter width H <= 768")
    dev = x_cat.device
    n_rows, t_slots = x_cat.shape[0], edge_feat.shape[0]
    if x_cat.shape[1] != hp + dp or edge_feat.shape[1] != F_PACK or wf_aug.shape != (F_PACK, hp):
        raise ValueError("fused message: operand shapes do not match the irreps")
    if g.shape != (n_out, sdp + dp):
        raise ValueError("fused message: g must be [n_out, SDp + Dp]")
    cx = torch.zeros_like(x_cat) if cx is None else cx
    cef = torch.zeros_like(edge_feat) if cef is None else cef
    if cx.shape != x_cat.shape or cef.shape != edge_feat.shape or (
            cwf is not None and cwf.shape != wf_aug.shape):
        raise ValueError("fused message: cotangent shapes do not match the operands")
    cast = lambda t: t.to(mm).contiguous()
    xk, efk, wfk, gk, cxk, cefk = map(cast, (x_cat, edge_feat, wf_aug, g, cx, cef))
    cwfk = None if cwf is None else cast(cwf)
    plan = _plan(slot_meta, n_out, n_rows, block_nodes, chunk)
    maps = _device_maps(irreps_str, num_basis, dev)
    n_part = torch.cuda.get_device_properties(dev).multi_processor_count
    f32 = dict(dtype=torch.float32, device=dev)
    d2x = torch.empty((n_rows, hp + dp), **f32)
    d2ef = torch.empty((t_slots, F_PACK), **f32)
    d2wf_part = torch.empty((n_part, kf, h), **f32)
    d2wf = torch.empty((F_PACK, hp), **f32)
    d2g = torch.empty((n_out, sdp + dp), **f32)
    shape_x, shape_g = bwd2_scratch_shapes(t_slots, h, node_dim, d) if tiles else ((0,), (0,))
    rows_x = torch.empty(shape_x, dtype=torch.bfloat16, device=dev)
    rows_g = torch.empty(shape_g, dtype=torch.bfloat16, device=dev)
    _check_cuda(xk, efk, wfk, gk, cxk, cefk, plan["dst_ptr"], plan["src_ptr"], d2x, rows_x,
                *(() if cwfk is None else (cwfk,)))
    if any(t.data_ptr() % 16 for t in (xk, efk, gk, cxk, cefk)):
        raise ValueError("fused message: operands must be 16-byte aligned")
    launch(
        "message_bwd2",
        xk.data_ptr(), efk.data_ptr(), wfk.data_ptr(), gk.data_ptr(),
        cxk.data_ptr(), cefk.data_ptr(), None if cwfk is None else cwfk.data_ptr(),
        plan["dst_ptr"].data_ptr(), plan["dst_slots"].data_ptr(),
        plan["src_ptr"].data_ptr(), plan["src_slots"].data_ptr(),
        plan["slot_src"].data_ptr(), plan["slot_dst"].data_ptr(),
        plan["src_pos"].data_ptr(), plan["dst_pos"].data_ptr(),
        maps["lane_gate"].data_ptr(), maps["lane_ycol"].data_ptr(),
        maps["gate_lane0"].data_ptr(), maps["gate_dim"].data_ptr(),
        maps["ylane_ptr"].data_ptr(), maps["ylane_idx"].data_ptr(),
        rows_x.data_ptr(), rows_g.data_ptr(),
        d2x.data_ptr(), d2ef.data_ptr(), d2wf_part.data_ptr(), d2wf.data_ptr(),
        d2g.data_ptr(),
        n_out, n_rows, t_slots, n_part, ni, node_dim, h, hp, d, dp, sdp, kw, kf,
        int(mm == torch.bfloat16), int(cwfk is not None),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    return d2x, d2ef, d2wf, d2g


# ---------------------------------------------------------------------------
# Dispatch and autograd
# ---------------------------------------------------------------------------
def message_forward(
    x_cat, edge_feat, wf_aug, slot_meta, edge_mask,
    irreps_str, num_basis, node_dim, n_out, block_nodes, chunk, mm_dtype,
):
    """The op's forward: the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if x_cat.is_cuda:
        return message_fwd_cuda(
            x_cat, edge_feat, wf_aug, slot_meta, irreps_str, num_basis,
            node_dim, n_out, block_nodes, chunk, mm_dtype,
        )
    if x_cat.device.type != "cpu":
        raise NotImplementedError(f"fused message on {x_cat.device}")
    return plain_message(
        x_cat, edge_feat, wf_aug, slot_meta[2], slot_meta[3], edge_mask,
        irreps_str, num_basis, node_dim, n_out, _mm_dtype(mm_dtype),
    )


def message_backward(
    x_cat, edge_feat, wf_aug, g, slot_meta, edge_mask,
    irreps_str, num_basis, node_dim, n_out, block_nodes, chunk, mm_dtype,
):
    """The op's first-order VJP (dx, d_ef, d_wf) in the operands' dtypes:
    the backward kernel for CUDA tensors, the plain VJP for CPU tensors."""
    if x_cat.is_cuda:
        dx, d_ef, d_wf = message_bwd_cuda(
            x_cat, edge_feat, wf_aug, g.contiguous(), slot_meta, irreps_str,
            num_basis, node_dim, n_out, block_nodes, chunk, mm_dtype,
        )
        return dx.to(x_cat.dtype), d_ef.to(edge_feat.dtype), d_wf.to(wf_aug.dtype)
    if x_cat.device.type != "cpu":
        raise NotImplementedError(f"fused message on {x_cat.device}")
    return plain_message_bwd(
        x_cat, edge_feat, wf_aug, g, slot_meta[2], slot_meta[3], edge_mask,
        irreps_str, num_basis, node_dim, n_out, _mm_dtype(mm_dtype),
    )


class FusedMessage(torch.autograd.Function):
    """Shaped like ``fused_message`` (pallas_message.py:914-975):
    arguments (x_cat, edge_feat, wf_aug, slot_meta, edge_mask, irreps_str,
    num_basis, node_dim, n_out, block_nodes, chunk, window, max_chunks,
    mm_dtype, kernel_bwd).  ``slot_meta`` = (src2, dst2, src_global,
    dst_global, chunk_base, n_chunks, window_starts[, slot plan]).

    Backward: the backward kernel on CUDA, the plain VJP on CPU.  Under
    ``create_graph=True`` (force training) the backward is itself the
    differentiable :class:`FusedMessageBwd`, whose backward is the
    second-order kernel."""

    @staticmethod
    def forward(ctx, x_cat, edge_feat, wf_aug, slot_meta, edge_mask,
                irreps_str, num_basis, node_dim, n_out, block_nodes, chunk,
                window, max_chunks, mm_dtype, kernel_bwd):
        ctx.statics = (irreps_str, num_basis, node_dim, n_out, block_nodes,
                       chunk, mm_dtype, kernel_bwd)
        ctx.slot_meta = slot_meta
        ctx.save_for_backward(x_cat, edge_feat, wf_aug, edge_mask)
        return message_forward(
            x_cat, edge_feat, wf_aug, slot_meta, edge_mask, irreps_str,
            num_basis, node_dim, n_out, block_nodes, chunk, mm_dtype,
        )

    @staticmethod
    def backward(ctx, g):
        x_cat, edge_feat, wf_aug, edge_mask = ctx.saved_tensors
        *statics, kernel_bwd = ctx.statics
        if x_cat.is_cuda and not kernel_bwd:
            raise NotImplementedError(
                "the plain backward does not run on the card; use kernel_bwd"
            )
        # a differentiable function of (x_cat, edge_feat, wf_aug, g): under
        # create_graph=True autograd records it, and its backward is the
        # second order
        dx, d_ef, d_wf = FusedMessageBwd.apply(x_cat, edge_feat, wf_aug, g, ctx.slot_meta,
                                               edge_mask, *statics)
        return (dx, d_ef, d_wf) + (None,) * 12


class FusedMessageBwd(torch.autograd.Function):
    """Shaped like ``fused_message_bwd`` (pallas_message.py:978-1050): the
    first-order VJP (dx, d_ef, d_wf) of the op as a differentiable
    function of (x_cat, edge_feat, wf_aug, g).  Forward: the backward
    kernel on CUDA, the plain VJP on CPU.  Backward: the second-order
    kernel (``csrc/message_bwd2.cu``) on CUDA, :func:`plain_message_bwd2`
    on CPU; unused output cotangents arrive as ``None`` and count as zero.
    A third order has no kernel and raises on CUDA."""

    @staticmethod
    def forward(ctx, x_cat, edge_feat, wf_aug, g, slot_meta, edge_mask,
                irreps_str, num_basis, node_dim, n_out, block_nodes, chunk, mm_dtype):
        ctx.set_materialize_grads(False)
        ctx.statics = (irreps_str, num_basis, node_dim, n_out, block_nodes,
                       chunk, mm_dtype)
        ctx.slot_meta = slot_meta
        ctx.save_for_backward(x_cat, edge_feat, wf_aug, g, edge_mask)
        return message_backward(x_cat, edge_feat, wf_aug, g, slot_meta, edge_mask,
                                *ctx.statics)

    @staticmethod
    def backward(ctx, cx, cef, cwf):
        x_cat, edge_feat, wf_aug, g, edge_mask = ctx.saved_tensors
        (irreps_str, num_basis, node_dim, n_out, block_nodes, chunk,
         mm_dtype) = ctx.statics
        sm = ctx.slot_meta
        if x_cat.is_cuda:
            if torch.is_grad_enabled():
                raise NotImplementedError(
                    "third-order gradients through the fused message op have "
                    "no kernel"
                )
            d2 = message_bwd2_cuda(
                x_cat, edge_feat, wf_aug, g, cx, cef, cwf, sm, irreps_str,
                num_basis, node_dim, n_out, block_nodes, chunk, mm_dtype,
            )
            d2 = tuple(t.to(like.dtype) for t, like in zip(d2, (x_cat, edge_feat, wf_aug, g)))
        else:
            d2 = plain_message_bwd2(
                x_cat, edge_feat, wf_aug, g, cx, cef, cwf, sm[2], sm[3], edge_mask,
                irreps_str, num_basis, node_dim, n_out, _mm_dtype(mm_dtype),
                create_graph=torch.is_grad_enabled(),
            )
        return tuple(d2) + (None,) * 9


def fused_message(x_cat, edge_feat, wf_aug, slot_meta, edge_mask,
                  irreps_str, num_basis, node_dim, n_out, block_nodes, chunk,
                  window, max_chunks, mm_dtype, kernel_bwd=True):
    """agg [n_out, SDp+Dp] = the message block's full edge pipeline."""
    return FusedMessage.apply(
        x_cat, edge_feat, wf_aug, slot_meta, edge_mask, irreps_str,
        num_basis, node_dim, n_out, block_nodes, chunk, window, max_chunks,
        mm_dtype, kernel_bwd,
    )
