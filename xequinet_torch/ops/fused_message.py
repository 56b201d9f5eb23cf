"""Fused XPaiNN message op: the whole per-edge pipeline of one message
block, as hand-written CUDA kernels for Hopper with plain PyTorch beside
them.

Port of ``xequinet_tpu/ops/pallas_message.py``: ``_kernel`` (:177, via
``_mega_call`` :264-325) becomes ``csrc/message_fwd.cu``, ``_bwd_kernel``
(:331, via ``_mega_bwd_call`` :458-557) becomes ``csrc/message_bwd.cu``
and ``_bwd2_kernel`` (:563, via ``_mega_bwd2_call`` :770-879), the
second order that force training runs, becomes ``csrc/message_bwd2.cu``;
the source notes there say what bounds each on the H100 and what the
design does about it.  The TPU tool ``tools/bwd_stream_floor.py``'s
``floor_kernel`` (:73), ``_bwd_kernel``'s streams with a near-empty body,
becomes ``csrc/bwd_stream_floor.cu`` (:func:`bwd_stream_floor_cuda`, on no
model path).  Per slot (a padded edge of
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

from ..models import remat
from .cuda_build import BUILD_INFO, LAUNCHES, build_kernels, reset_launch_counts  # noqa: F401
from .cuda_build import launch, probe
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
    column, ascending), seg [n_seg, 4] (runs of irreps of one l: first
    irrep, first lane, irreps, ``l | (first harmonic column - Kw) << 8``;
    the Hopper tile pass of ``message_bwd`` walks them)."""
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
    # runs of consecutive irreps of one l (one harmonic column block):
    # (first irrep, first lane, irreps, l | first harmonic column - Kw << 8)
    seg = []
    u = j = 0
    for mul, ir in irreps:
        if seg and seg[-1][3] & 3 == ir.l:
            seg[-1][2] += mul
        else:
            seg.append([u, j, mul, ir.l | (ycol[ir.l] - num_basis - 1) << 8])
        u += mul
        j += mul * ir.dim
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
        "seg": as32(seg).reshape(-1, 4),
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
    with torch.enable_grad(), remat.local_graph():
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
    with torch.enable_grad(), remat.local_graph():
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


SMEM_MAX = 232448  # shared memory a block may take on the H100
_ru = lambda v, m: (v + m - 1) // m * m


def _tile_layouts(kernel: str, ni: int, node_dim: int, d: int, kw: int,
                  kf: int) -> Tuple[int, int]:
    """Shared memory (bytes) of a kernel's bf16 tile pass in its most
    compact regular layout (wf's live rows read from L2, one stage in the
    backward) and in its lean one (the second order without dfo / u / dfwr
    tiles; the regular one for the others).  The launchers
    (``*_tile_dims`` in ``csrc/``) compute the same sizes and take a
    roomier layout where one fits."""
    h = node_dim + 2 * ni
    hs, ht8, dt8, sd8 = _ru(h, 16), _ru(h, 8), _ru(d, 8), _ru(node_dim, 8)
    w_st, est, kwp = _ru(hs, 64) + 8, _ru(kf, 32) + 8, _ru(kw, 32)
    tabs, tile, red = _ru((dt8 + ni) * 4, 16), 16 * w_st * 2, 4 * 16 * kwp * 4
    x_row, g_row = 16 * (ht8 + dt8 + 8) * 2, 16 * (sd8 + dt8 + 8) * 2
    if kernel == "message_fwd":
        smem = _ru(x_row + 16 * est * 2 + 64, 16)
        return smem, smem
    if kernel == "message_bwd":
        stage = _ru(x_row + g_row + 16 * est * 2 + 64, 16)
        smem = stage + tile + max(16 * (2 * ni + 8) * 4, red) + tabs
        return smem, smem
    if kernel == "message_bwd2":
        stage = _ru(2 * x_row + g_row + 2 * 16 * est * 2 + 128, 16)
        return (stage + 2 * tile + max(2 * 16 * (2 * ni + 8) * 4, red) + tabs,
                stage + tile + red + tabs)
    raise ValueError(f"no tile pass for {kernel}")


def tile_route(kernel: str, mm_dtype, irreps_str: str, num_basis: int, node_dim: int,
               has_cwf: bool = False) -> bool:
    """Whether the kernel runs its bf16 tile pass (tensor cores) at these
    widths, else its walk kernels: the tile passes take bf16 operands (the
    second order without cwf) at every width whose most compact layout fits
    a block's shared memory (the forward: also SDp + Dp <= 1280 output
    columns, four per thread).  The choice is made by shape alone."""
    if _mm_dtype(mm_dtype) != torch.bfloat16 or (kernel == "message_bwd2" and has_cwf):
        return False
    ni, h, hp, d, dp, sdp, kw, kf = _launch_dims(irreps_str, num_basis, node_dim)
    if kernel == "message_fwd" and sdp + dp > 1280:
        return False
    return min(_tile_layouts(kernel, ni, node_dim, d, kw, kf)) <= SMEM_MAX


# the Hopper tile pass of message_bwd (csrc/message_bwd_hopper.cuh): its
# consumer warpgroups, m64 tiles of H, ring stages and irrep segments at
# most
HB_WGS, HB_MT, HB_MAXST, HB_SEGS = 3, 9, 4, 8


def _hopper_layout(ni: int, node_dim: int, d: int, kw: int, kf: int) -> Tuple[int, int, int]:
    """(shared memory, ring stages, stage bytes) of ``message_bwd``'s Hopper
    tile pass, as ``bwd_hopper_dims`` (csrc/message_bwd_hopper.cuh) lays it
    out: per stage 16 staged x rows ``[gs | gv]`` and g rows ``[gms_s |
    gms_v]`` (each + 16 bytes), the 16 x 32 edge-feature columns in wgmma's
    core-matrix layout (1 KB) and the slots' scratch positions; beside the
    stages wf's live rows (32 x 64 per m64 tile of H, the tiles rounded up
    to a multiple of ``HB_WGS``), two 64 x 16 dfw tiles per consumer
    warpgroup, two buffers of the d_ef partials of all but the first
    warpgroup (128 x 8 f32 each), the tile's dfo gate sums (16 x 2 ni f32)
    and dgs rows (16 x H bf16), the barriers, the gate table and the
    segments.  As many stages as fit, at most ``HB_MAXST``."""
    h = node_dim + 2 * ni
    n_mt = _ru(-(-h // 64), HB_WGS)  # wf's m64 tiles, zero past H
    ht8, dt8, sd8 = _ru(h, 8), _ru(d, 8), _ru(node_dim, 8)
    stage = _ru(16 * ((ht8 + dt8) * 2 + 16) + 16 * ((sd8 + dt8) * 2 + 16) + 1024 + 64, 128)
    fixed = (n_mt * 4096 + HB_WGS * 2 * 2048 + 2 * (HB_WGS - 1) * 128 * 8 * 4
             + 16 * (_ru(2 * ni, 16) + 4) * 4 + 16 * (ht8 + 8) * 2 + 2 * HB_MAXST * 8
             + _ru(ni * 4, 16) + HB_SEGS * 16)
    nst = min((SMEM_MAX - fixed) // stage, HB_MAXST)
    return nst * stage + fixed, nst, stage


def hopper_route(mm_dtype, irreps_str: str, num_basis: int, node_dim: int) -> bool:
    """Whether ``message_bwd`` runs its Hopper tile pass (bulk copies by a
    producer warp into a ring of stages, wgmma with H on M, packed bf16x2
    steps; csrc/message_bwd_hopper.cuh) at these widths, else what
    :func:`tile_route` chooses: bf16 operands, Kf <= 32, H <= 576 (the d_wf
    accumulators of its m64 tiles in registers), every run of irreps of one
    l of even multiplicity (the lane pairs of its packed steps), at most
    ``HB_SEGS`` runs, and two stages at least that fit.  The choice is made
    by shape alone."""
    if _mm_dtype(mm_dtype) != torch.bfloat16:
        return False
    ni, h, hp, d, dp, sdp, kw, kf = _launch_dims(irreps_str, num_basis, node_dim)
    seg = index_maps(irreps_str, num_basis)["seg"]
    smem, nst, _ = _hopper_layout(ni, node_dim, d, kw, kf)
    return (kf <= 32 and -(-h // 64) <= HB_MT and nst >= 2 and len(seg) <= HB_SEGS
            and bool((seg[:, 2] % 2 == 0).all()) and d < 4096 and smem <= SMEM_MAX)


# the Hopper tile pass of message_bwd2 (csrc/message_bwd2_hopper.cuh): its
# consumer warpgroups, m64 tiles of H and ring stages at most
HB2_WGS, HB2_MT, HB2_MAXST = 3, 9, 4


@functools.lru_cache(maxsize=None)
def pair_table(irreps_str: str, num_basis: int, node_dim: int) -> Tuple[np.ndarray, int]:
    """(tab, n_pt): the pair rows of ``message_bwd2``'s Hopper tile pass,
    int32 [32 n_pt].  Its m64 tiles of H put each irrep u's state gate u
    and harmonic gate ni + u on one thread's two accumulator rows: entry
    32 i + 8 w + gq of pair tile i (warp w of the tile's warpgroup i % 3,
    row group gq) is ``u | first lane << 10 | l << 22 | (first harmonic
    column - Kw) << 24``, or -1 (a padding row pair).  Each run of irreps
    of one l is cut into groups of 8 consecutive irreps (a warp's row
    groups, one l, so that its lane count and harmonic columns are
    constants; the last group padded), and the groups go to the tiles'
    warps longest first, each to the warp with the least work so far
    (2 + 2l + 1 per group, 3 per warp of a scalar tile), ties to the
    lowest cell; node_dim's columns follow in ``-(-node_dim // 64)`` scalar
    tiles."""
    maps = index_maps(irreps_str, num_basis)
    groups = []
    for u0, j0, mul, lw in maps["seg"].tolist():
        dim = 2 * (lw & 3) + 1
        for g0 in range(0, mul, 8):
            us = range(u0 + g0, u0 + min(g0 + 8, mul))
            ent = [u | (j0 + (u - u0) * dim) << 10 | (lw & 3) << 22 | (lw >> 8) << 24
                   for u in us]
            groups.append((2 + dim, ent + [-1] * (8 - len(ent))))
    n_pt = max(1, -(-len(groups) // 4))
    n_mt = n_pt + -(-node_dim // 64)
    warp_of = lambda c: (c[0] % HB2_WGS) * 4 + c[1]
    load = [0] * (4 * HB2_WGS)
    for i in range(n_pt, n_mt):
        for w in range(4):
            load[(i % HB2_WGS) * 4 + w] += 3
    cells = [(i, w) for i in range(n_pt) for w in range(4)]
    ent_of = {c: [-1] * 8 for c in cells}
    for cost, ent in sorted(groups, key=lambda gr: -gr[0]):
        c = min((c for c in cells if ent_of[c][0] < 0), key=lambda c: (load[warp_of(c)], c))
        load[warp_of(c)] += cost
        ent_of[c] = ent
    tab = np.full(32 * n_pt, -1, dtype=np.int32)
    for (i, w), ent in ent_of.items():
        tab[32 * i + 8 * w:32 * i + 8 * w + 8] = ent
    return tab, n_pt


def _hopper2_layout(ni: int, node_dim: int, d: int, kw: int, kf: int,
                    n_pt: int) -> Tuple[int, int, int]:
    """(shared memory, ring stages, stage bytes) of ``message_bwd2``'s Hopper
    tile pass, as ``bwd2_hopper_dims`` (csrc/message_bwd2_hopper.cuh) lays
    it out: per stage 16 staged x rows ``[gs | gv]``, 16 cx rows and 16 g
    rows ``[gms_s | gms_v]`` (each + 16 bytes), the 16 x 32 columns of ef
    and of cef in wgmma's core-matrix layout (1 KB each), their 9 harmonic
    columns slot-contiguous (288 bytes each) and the slots' two scratch
    positions; beside the stages wf's live rows (32 x 64 per m64 tile of H,
    the tiles rounded up to a multiple of ``HB2_WGS``), one 64 x 16 dfw2
    tile per consumer warpgroup, the 12 consumer warps' harmonic d2ef
    cells (16 x (Kf - Kw) f32 each), the pair table and the barriers.  As
    many stages as fit, at most ``HB2_MAXST``."""
    h = node_dim + 2 * ni
    n_mt = n_pt + -(-node_dim // 64)
    ht8, dt8, sd8 = _ru(h, 8), _ru(d, 8), _ru(node_dim, 8)
    xs, gs = (ht8 + dt8) * 2 + 16, (sd8 + dt8) * 2 + 16
    stage = _ru(16 * (2 * xs + gs) + 2 * 1024 + 2 * 9 * 16 * 2 + 128, 128)
    fixed = (_ru(n_mt, HB2_WGS) * 4096 + HB2_WGS * 2048 + 4 * HB2_WGS * 16 * (kf - kw) * 4
             + _ru(n_pt * 32 * 4, 16) + 2 * HB2_MAXST * 8)
    nst = min((SMEM_MAX - fixed) // stage, HB2_MAXST)
    return nst * stage + fixed, nst, stage


def hopper2_route(mm_dtype, irreps_str: str, num_basis: int, node_dim: int,
                  has_cwf: bool = False) -> bool:
    """Whether ``message_bwd2`` runs its Hopper tile pass (bulk copies by a
    producer warp into a ring of stages, wgmma with H on M, packed single
    products; csrc/message_bwd2_hopper.cuh) at these widths, else what
    :func:`tile_route` chooses: bf16 operands without cwf, Kf <= 32, at
    most ``HB2_MT`` m64 tiles of H in its row order (:func:`pair_table`:
    at most 576 columns, the flagship's 9), every run of irreps of one l of
    even multiplicity, at most 8 runs, and two stages at least that fit.
    The choice is made by shape alone."""
    if _mm_dtype(mm_dtype) != torch.bfloat16 or has_cwf:
        return False
    ni, h, hp, d, dp, sdp, kw, kf = _launch_dims(irreps_str, num_basis, node_dim)
    seg = index_maps(irreps_str, num_basis)["seg"]
    if kf > 32 or h > 64 * HB2_MT or len(seg) > 8 or not bool((seg[:, 2] % 2 == 0).all()):
        return False
    n_pt = pair_table(irreps_str, num_basis, node_dim)[1]
    smem, nst, _ = _hopper2_layout(ni, node_dim, d, kw, kf, n_pt)
    return (n_pt + -(-node_dim // 64) <= HB2_MT and nst >= 2 and ni < 1024 and d < 4096
            and smem <= SMEM_MAX)


# the Hopper tile pass of message_fwd (csrc/message_fwd_hopper.cuh): its
# consumer warpgroups, m64 tiles of H (3 a warpgroup), ring stages, A tiles
# of 64 output columns a warpgroup at most, and destination rows a group
HF_WGS, HF_MT, HF_MAXST, HF_NA, HF_ROWS = 3, 9, 4, 5, 16


@functools.lru_cache(maxsize=None)
def fwd_table(irreps_str: str, num_basis: int, node_dim: int) -> Tuple[np.ndarray, int, int]:
    """(ftab, n_pt, na): the tables of ``message_fwd``'s Hopper tile pass,
    int32.  H's rows are in :func:`pair_table`'s order (pair tile i and
    scalar tile i belong to warpgroup i % 3), so that the thread holding an
    irrep u's gates u and ni + u forms all 2l + 1 of u's message lanes.
    Each warpgroup writes the message rows it forms into its own A tiles
    (64 rows each) of the destination product ``out^T += msg^T @ onehot``:
    its output columns (the vector lanes ``SDp + j`` of its irreps, the
    node_dim columns of its scalar tiles, and the padding columns, which
    stay zero, to the warpgroup with the fewest) in ascending order.
    ``ftab``: the pair entries [32 n_pt]; each entry's A row of its first
    lane [32 n_pt] (-1 on padding entries); each scalar tile's A row of
    its first column [n_mt - n_pt]; per warpgroup the output column of each
    of its ``na * 64`` A rows (-1 past its columns).  ``na``: A tiles a
    warpgroup walks, the most any needs."""
    tab, n_pt = pair_table(irreps_str, num_basis, node_dim)
    _, _, _, d, dp, sdp, _, _ = _launch_dims(irreps_str, num_basis, node_dim)
    n_mt = n_pt + -(-node_dim // 64)
    cols = [[] for _ in range(HF_WGS)]
    for q, e in enumerate(tab.tolist()):
        if e >= 0:  # the entry's lanes: from its first lane, 2l + 1 of them
            j0 = sdp + ((e >> 10) & 4095)
            cols[(q // 32) % HF_WGS] += range(j0, j0 + 2 * ((e >> 22) & 3) + 1)
    for i in range(n_pt, n_mt):
        cols[i % HF_WGS] += range(64 * (i - n_pt), min(64 * (i - n_pt + 1), node_dim))
    for c in list(range(node_dim, sdp)) + list(range(sdp + d, sdp + dp)):
        min(cols, key=len).append(c)
    cols = [sorted(c) for c in cols]
    na = max(-(-len(c) // 64) for c in cols)
    row = {c: r for cs in cols for r, c in enumerate(cs)}
    ftab = np.full(64 * n_pt + n_mt - n_pt + HF_WGS * na * 64, -1, dtype=np.int32)
    ftab[:32 * n_pt] = tab
    for q, e in enumerate(tab.tolist()):
        if e >= 0:
            ftab[32 * n_pt + q] = row[sdp + ((e >> 10) & 4095)]
    for i in range(n_pt, n_mt):
        ftab[64 * n_pt + i - n_pt] = row[64 * (i - n_pt)]
    base = 64 * n_pt + n_mt - n_pt
    for wg, cs in enumerate(cols):
        ftab[base + wg * na * 64:base + wg * na * 64 + len(cs)] = cs
    return ftab, n_pt, na


def _fwd_hopper_layout(ni: int, node_dim: int, d: int, kw: int, kf: int, n_pt: int,
                       na: int) -> Tuple[int, int, int]:
    """(shared memory, ring stages, stage bytes) of ``message_fwd``'s Hopper
    tile pass, as ``fwd_hopper_dims`` (csrc/message_fwd_hopper.cuh) lays it
    out: per stage 16 staged x rows ``[gs | 0 | gv]`` (Hp + D rounded up to
    8 columns, one bulk copy each, + 16 bytes), the 16 x 32 edge-feature
    columns in wgmma's core-matrix layout (1 KB),
    the 9 harmonic columns slot-contiguous (288 bytes), the one-hot
    [16 slots x 16 rows] (512 bytes) and the slots' destinations and the
    tile's flags (128 bytes); beside the stages wf's live rows (9 m64 tiles
    of 32 x 64), each warpgroup's ``na`` A tiles (64 x 16 bf16), the table
    and the barriers.  As many stages as fit, at most ``HF_MAXST``."""
    hp, dt8 = _pad128(node_dim + 2 * ni), _ru(d, 8)
    n_mt = n_pt + -(-node_dim // 64)
    stage = _ru(16 * ((hp + dt8) * 2 + 16) + 1024 + 9 * 16 * 2 + 512 + 128, 128)
    n_tab = 64 * n_pt + n_mt - n_pt + HF_WGS * na * 64
    fixed = HF_MT * 4096 + HF_WGS * na * 2048 + _ru(n_tab * 4, 16) + 2 * HF_MAXST * 8
    nst = min((SMEM_MAX - fixed) // stage, HF_MAXST)
    return nst * stage + fixed, nst, stage


def fwd_hopper_route(mm_dtype, irreps_str: str, num_basis: int, node_dim: int) -> bool:
    """Whether ``message_fwd`` runs its Hopper tile pass (bulk copies by two
    producer warps into a ring of stages, wgmma with H on M, the destination
    sum as a one-hot wgmma; csrc/message_fwd_hopper.cuh) at these widths,
    else what :func:`tile_route` chooses: bf16 operands, Kf <= 32, at most
    ``HF_MT`` m64 tiles of H in :func:`pair_table`'s order, at most
    ``HF_NA`` A tiles a warpgroup (:func:`fwd_table`), two stages at least
    that fit, and the irreps of :func:`hopper2_route` (runs of one l of
    even multiplicity, at most 8), so that the forward and the second order
    take their Hopper passes on the same models.  The choice is made by
    shape alone."""
    if _mm_dtype(mm_dtype) != torch.bfloat16:
        return False
    ni, h, hp, d, dp, sdp, kw, kf = _launch_dims(irreps_str, num_basis, node_dim)
    seg = index_maps(irreps_str, num_basis)["seg"]
    if kf > 32 or h > 64 * HF_MT or len(seg) > 8 or not bool((seg[:, 2] % 2 == 0).all()):
        return False
    _, n_pt, na = fwd_table(irreps_str, num_basis, node_dim)
    smem, nst, _ = _fwd_hopper_layout(ni, node_dim, d, kw, kf, n_pt, na)
    return (n_pt + -(-node_dim // 64) <= HF_MT and na <= HF_NA and nst >= 2 and ni < 1024
            and d < 4096 and smem <= SMEM_MAX)


# the f32 tile passes of message_bwd and message_bwd2
# (csrc/message_f32_tile.cuh) and of message_fwd (csrc/message_fwd_f32.cuh):
# their consumer warps at most, the rows of wf and the edge-feature columns
# a thread keeps, slots a tile and ring stages at most (the backwards'; the
# forward's FF_MAXST)
F32_CW, F32_KW, F32_KF, F32_BT, F32_MAXST = 9, 24, 32, 8, 4
FF_MAXST = 6


@functools.lru_cache(maxsize=None)
def f32_units(irreps_str: str, num_basis: int, node_dim: int) -> Tuple[np.ndarray, int]:
    """(units, n_cw): the f32 tile passes' consumer threads, int32 [32 n_cw,
    4], one row (c0, c1, j0, dim | (first harmonic column - Kw) << 8) a
    thread: an irrep u owns its state gate c0 = u, its harmonic gate c1 =
    ni + u and its lanes j0 .. j0 + 2l; a scalar unit owns c0 = 2 ni + c and
    c1 = 2 ni + c + 1 (-1 past node_dim), j0 = -1 and dim 0.  The irreps of
    one l (ascending l, each ascending u), then the scalar pairs, each kind
    padded to whole warps with rows (-1, -1, -1, its dim | yc << 8), so that
    a warp's lane loops are uniform."""
    irreps = Irreps(irreps_str)
    ni = irreps.num_irreps
    maps = index_maps(irreps_str, num_basis)
    kw = num_basis + 1
    groups = {}
    for u, (j0, dim) in enumerate(zip(maps["gate_lane0"].tolist(), maps["gate_dim"].tolist())):
        yc = int(maps["lane_ycol"][j0]) - kw
        groups.setdefault(dim, []).append((u, ni + u, j0, dim | yc << 8))
    rows = []
    for dim in sorted(groups):
        ent = groups[dim]
        rows += ent + [(-1, -1, -1, ent[0][3])] * (-len(ent) % 32)
    scal = [(2 * ni + c, 2 * ni + c + 1 if c + 1 < node_dim else -1, -1, 0)
            for c in range(0, node_dim, 2)]
    rows += scal + [(-1, -1, -1, 0)] * (-len(scal) % 32)
    return np.asarray(rows, dtype=np.int32).reshape(-1, 4), len(rows) // 32


def _f32_layout(kernel: str, ni: int, node_dim: int, d: int, kw: int,
                kf: int) -> Tuple[int, int, int]:
    """(shared memory, ring stages, stage bytes) of the f32 tile pass of
    ``kernel``: "message_bwd" or "message_bwd2", as ``f32_tile_dims``
    (csrc/message_f32_tile.cuh) lays it out: per stage ``F32_BT`` staged x
    rows ``[gs | gv]`` (H and D rounded up to 8, f32; and as many cx rows in
    the second order), as many g rows ``[gms_s | gms_v]``, the slots' 32
    edge-feature columns (and cef's) and their indices (list entry, source,
    staged x row, position by destination); beside the stages two
    reduction buffers of d_ef's warp sums (``F32_BT`` x ``F32_CW`` x 32 f32)
    and the barriers.  As many stages as fit, at most ``F32_MAXST``.
    "message_fwd", as ``fwd_f32_dims`` (csrc/message_fwd_f32.cuh) lays it
    out: per stage ``F32_BT`` source rows ``[gs | 0 | gv]`` (Hp + D rounded
    up to 8 f32, one bulk copy each), the slots' 32 edge-feature columns and
    their destination rows; beside the stages the barriers and the block's
    row range.  As many stages as fit, at most ``FF_MAXST``."""
    h = node_dim + 2 * ni
    if kernel == "message_fwd":
        stage = _ru(F32_BT * (_pad128(h) + _ru(d, 8)) * 4 + F32_BT * F32_KF * 4 + F32_BT * 4,
                    128)
        fixed = 2 * FF_MAXST * 8 + 16
        nst = min((SMEM_MAX - fixed) // stage, FF_MAXST)
        return nst * stage + fixed, nst, stage
    second = kernel == "message_bwd2"
    xb = F32_BT * (_ru(h, 8) + _ru(d, 8)) * 4
    gb = F32_BT * (_ru(node_dim, 8) + _ru(d, 8)) * 4
    eb = F32_BT * F32_KF * 4
    stage = _ru((2 if second else 1) * (xb + eb) + gb + 4 * F32_BT * 4, 128)
    fixed = 2 * F32_BT * F32_CW * 32 * 4 + 2 * F32_MAXST * 8 + 16
    nst = min((SMEM_MAX - fixed) // stage, F32_MAXST)
    return nst * stage + fixed, nst, stage


def f32_route(kernel: str, mm_dtype, irreps_str: str, num_basis: int, node_dim: int,
              has_cwf: bool = False) -> bool:
    """Whether ``kernel`` ("message_bwd", "message_bwd2" or "message_fwd")
    runs its f32 tile pass (csrc/message_f32_tile.cuh, and for the forward
    csrc/message_fwd_f32.cuh on the same units and ring: producer warps'
    bulk copies into a ring of stages, consumer threads owning an irrep or
    two scalar columns, the products on the FP32 pipes, the list by source
    (the forward: by destination) walked in contiguous block ranges) at
    these widths, else its walk kernels: f32 operands (the second order
    without cwf), Kw <= ``F32_KW``, Kf <= ``F32_KF``, at most ``F32_CW``
    consumer warps of :func:`f32_units` and two stages at least that fit.
    The choice is made by shape alone."""
    if _mm_dtype(mm_dtype) != torch.float32 or (kernel == "message_bwd2" and has_cwf):
        return False
    ni, h, hp, d, dp, sdp, kw, kf = _launch_dims(irreps_str, num_basis, node_dim)
    if kw > F32_KW or kf > F32_KF:
        return False
    smem, nst, _ = _f32_layout(kernel, ni, node_dim, d, kw, kf)
    return (f32_units(irreps_str, num_basis, node_dim)[1] <= F32_CW and nst >= 2
            and smem <= SMEM_MAX)


def walk_chunks(kernel: str, ni: int, h: int, kw: int, kf: int) -> int:
    """Column chunks of the walk kernels' slot pass (``XEQ_WALK_HC`` in
    ``message_common.cuh``): 1 when the whole filter width's d_wf partial,
    wf rows and dfw tiles fit a block's shared memory, else chunks of 128
    columns whose d_ef partials a reduction sums."""
    rows = 16 if kernel == "message_bwd" else 32
    whole = 4 * (16 * ni + rows * h + rows * kf + kf * h + kw * h)
    return 1 if whole <= SMEM_MAX else -(-h // 128)


def _dwf_regs(kernel: str, ni: int, node_dim: int, d: int, kw: int, kf: int) -> bool:
    """Whether a tile pass keeps its d_wf partial in registers (Kf <= 32, H
    <= 768 and not the lean layout), else it writes dfw rows for
    ``xeq_dwf_pass``."""
    h = node_dim + 2 * ni
    lean = _tile_layouts(kernel, ni, node_dim, d, kw, kf)[0] > SMEM_MAX
    return kf <= 32 and _ru(h, 16) <= 16 * 8 * 6 and not lean


_DEVICE_FTABS: Dict[tuple, torch.Tensor] = {}


@functools.lru_cache(maxsize=None)
def _fwd_static(irreps_str: str, num_basis: int, node_dim: int, mm: str):
    """The forward's per-shape choices, once per shape (a call's host time
    is part of the forward's): (widths, dtype, route, n_pt, na); on the f32
    tile pass (route 3) n_pt is its consumer warps and na 0."""
    dims = _launch_dims(irreps_str, num_basis, node_dim)
    dt = _mm_dtype(mm)
    if fwd_hopper_route(dt, irreps_str, num_basis, node_dim):
        return dims, dt, 2, *fwd_table(irreps_str, num_basis, node_dim)[1:]
    if f32_route("message_fwd", dt, irreps_str, num_basis, node_dim):
        return dims, dt, 3, f32_units(irreps_str, num_basis, node_dim)[1], 0
    return dims, dt, int(tile_route("message_fwd", dt, irreps_str, num_basis, node_dim)), 0, 0


def _fwd_setup(x_cat, edge_feat, wf_aug, slot_meta, irreps_str, num_basis, node_dim, n_out,
               block_nodes, chunk, mm_dtype):
    """What a launch of the forward takes, shared by :func:`message_fwd_cuda`,
    :func:`fwd_phase_stamps` and :func:`f32_phase_stamps`: the widths, the
    route (``route``: 3 the f32 tile pass, 2 the Hopper tile pass, 1 the
    mma.sync tile pass, 0 the walk kernel), the operands in the kernel's
    dtype, the slot plan, the index maps, the table the C side reads as
    ``ftab`` (the Hopper pass's table, or the f32 pass's units) and the
    grid (``n_part``: one block per SM, at most one per group of
    ``HF_ROWS`` destination rows on the Hopper pass, one per row on the f32
    pass) and the output."""
    dims, mm, route, n_pt, na = _fwd_static(irreps_str, num_basis, node_dim,
                                            str(_mm_dtype(mm_dtype)))
    ni, h, hp, d, dp, sdp, kw, kf = dims
    if x_cat.shape[1] != hp + dp or edge_feat.shape[1] != F_PACK or wf_aug.shape != (F_PACK, hp):
        raise ValueError("fused message: operand shapes do not match the irreps")
    dev = x_cat.device
    cast = lambda t: t.to(mm).contiguous()
    xk, efk, wfk = map(cast, (x_cat, edge_feat, wf_aug))
    key = (irreps_str, num_basis, node_dim, str(dev))
    if route == 2 and key not in _DEVICE_FTABS:
        _DEVICE_FTABS[key] = torch.as_tensor(fwd_table(irreps_str, num_basis, node_dim)[0],
                                             device=dev)
    ftab = (_DEVICE_FTABS[key] if route == 2 else
            _device_units(irreps_str, num_basis, node_dim, dev) if route == 3 else
            torch.empty((0,), dtype=torch.int32, device=dev))
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    b = dict(
        dims=dims, mm=mm, route=route, xk=xk, efk=efk, wfk=wfk, n_pt=n_pt, na=na, ftab=ftab,
        n_part=max(1, min(n_sm, n_out if route == 3 else -(-n_out // HF_ROWS))),
        plan=_plan(slot_meta, n_out, x_cat.shape[0], block_nodes, chunk),
        maps=_device_maps(irreps_str, num_basis, dev),
        out=torch.empty((n_out, sdp + dp), dtype=torch.float32, device=dev),
    )
    _check_cuda(xk, efk, wfk, b["plan"]["dst_ptr"], b["out"])
    if any(t.data_ptr() % 16 for t in (xk, efk)):
        raise ValueError("fused message: operands must be 16-byte aligned")
    return b


def message_fwd_cuda(
    x_cat, edge_feat, wf_aug, slot_meta,
    irreps_str, num_basis, node_dim, n_out, block_nodes, chunk, mm_dtype,
) -> torch.Tensor:
    """agg [n_out, SDp+Dp] f32 by ``csrc/message_fwd.cu``: f32 operands at
    the widths of :func:`f32_route` take its f32 tile pass
    (``csrc/message_fwd_f32.cuh``: each row summed in registers along the
    list by destination, no scratch), the other f32 widths the walk kernel;
    bf16 at the widths of :func:`fwd_hopper_route` its Hopper tile pass
    (``csrc/message_fwd_hopper.cuh``), elsewhere on :func:`tile_route` the
    mma.sync tile pass, else the walk kernel."""
    if not x_cat.is_cuda:
        raise ValueError("message_fwd_cuda takes CUDA tensors")
    b = _fwd_setup(x_cat, edge_feat, wf_aug, slot_meta, irreps_str, num_basis, node_dim, n_out,
                   block_nodes, chunk, mm_dtype)
    ni, h, hp, d, dp, sdp, kw, kf = b["dims"]
    plan, maps = b["plan"], b["maps"]
    launch(
        "message_fwd",
        b["xk"].data_ptr(), b["efk"].data_ptr(), b["wfk"].data_ptr(), plan["dst_ptr"].data_ptr(),
        plan["dst_slots"].data_ptr(), plan["slot_src"].data_ptr(),
        plan["slot_dst"].data_ptr(), maps["lane_gate"].data_ptr(),
        maps["lane_ycol"].data_ptr(), _ptr(b["ftab"]), b["out"].data_ptr(),
        n_out, ni, node_dim, hp, d, dp, sdp, kw, kf, int(b["mm"] == torch.bfloat16), b["route"],
        b["n_pt"], b["na"], b["n_part"], torch.cuda.current_stream(x_cat.device).cuda_stream,
    )
    return b["out"]


def fwd_phase_stamps(
    x_cat, edge_feat, wf_aug, slot_meta,
    irreps_str, num_basis, node_dim, n_out, block_nodes, chunk, mm_dtype, which: str,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(stamps, agg): clock64() cycles per phase of one launch of a
    ``message_fwd`` bf16 tile pass, and its output, on
    :func:`message_fwd_cuda`'s operands (the phase probe of
    ``xequinet_torch/tools/bwd_compare.py --kernel message_fwd --phases``,
    on no model path; not counted in LAUNCHES): ``which`` "tile_fwd", the
    mma.sync tile pass's flagship instance (int64 [n_groups, 8], thread 0
    of each block, ``PHASES["tile_fwd"]``); "hopper_fwd", the Hopper tile
    pass (int64 [n_part, HF_WGS + 1, 8]: the consumer warpgroups, phases as
    in ``PHASES["hopper_fwd"]``, then the producer warp,
    ``PHASES["producer_fwd"]``).  ``agg`` is the pass's output (the old
    pass's at widths where the wrapper takes the new one).  Takes the
    widths of :func:`fwd_hopper_route`."""
    if which not in ("tile_fwd", "hopper_fwd") or not fwd_hopper_route(
            mm_dtype, irreps_str, num_basis, node_dim):
        raise ValueError("fwd_phase_stamps takes which 'tile_fwd' or 'hopper_fwd' at the widths "
                         "of fwd_hopper_route")
    b = _fwd_setup(x_cat, edge_feat, wf_aug, slot_meta, irreps_str, num_basis, node_dim, n_out,
                   block_nodes, chunk, mm_dtype)
    ni, h, hp, d, dp, sdp, kw, kf = b["dims"]
    plan, maps = b["plan"], b["maps"]
    hopper = which == "hopper_fwd"
    shape = (b["n_part"], HF_WGS + 1, 8) if hopper else (max(1, -(-n_out // 16)), 8)
    stamps = torch.zeros(shape, dtype=torch.int64, device=x_cat.device)
    probe(
        "fwd_phases",
        b["xk"].data_ptr(), b["efk"].data_ptr(), b["wfk"].data_ptr(), plan["dst_ptr"].data_ptr(),
        plan["dst_slots"].data_ptr(), plan["slot_src"].data_ptr(),
        plan["slot_dst"].data_ptr(), maps["lane_gate"].data_ptr(),
        maps["lane_ycol"].data_ptr(), _ptr(b["ftab"]), b["out"].data_ptr(),
        n_out, ni, node_dim, hp, d, dp, sdp, kw, kf, b["n_pt"], b["na"], b["n_part"],
        int(hopper), stamps.data_ptr(), torch.cuda.current_stream(x_cat.device).cuda_stream,
    )
    return stamps, b["out"]


def _bwd_setup(x_cat, edge_feat, wf_aug, g, slot_meta, irreps_str, num_basis, node_dim,
               n_out, block_nodes, chunk, mm_dtype):
    """What a launch of the first-order backward takes, shared by
    :func:`message_bwd_cuda`, :func:`bwd_stream_floor_cuda`,
    :func:`bwd_phase_stamps` and :func:`f32_phase_stamps` so that they
    cannot drift: the widths, the route (``route``: 3 the f32 tile pass, 2
    the Hopper tile pass, 1 the tile pass, 0 the walk kernels), the
    operands in the kernel's
    dtype, the slot plan, the index maps, the outputs (dx, d_ef, d_wf),
    the per-block d_wf partials and the scratch."""
    ni, h, hp, d, dp, sdp, kw, kf = _launch_dims(irreps_str, num_basis, node_dim)
    mm = _mm_dtype(mm_dtype)
    hopper = hopper_route(mm, irreps_str, num_basis, node_dim)
    tiles = hopper or tile_route("message_bwd", mm, irreps_str, num_basis, node_dim)
    on_f32 = f32_route("message_bwd", mm, irreps_str, num_basis, node_dim)
    dev = x_cat.device
    n_rows, t_slots = x_cat.shape[0], edge_feat.shape[0]
    cast = lambda t: t.to(mm).contiguous()
    xk, efk, wfk, gk = map(cast, (x_cat, edge_feat, wf_aug, g))
    n_part = torch.cuda.get_device_properties(dev).multi_processor_count
    f32 = dict(dtype=torch.float32, device=dev)
    n_hc = 1 if tiles or on_f32 else walk_chunks("message_bwd", ni, h, kw, kf)
    maps = _device_maps(irreps_str, num_basis, dev)
    # the table the C side reads as ``seg``: the Hopper pass's irrep
    # segments, or the f32 pass's units
    seg = _device_units(irreps_str, num_basis, node_dim, dev) if on_f32 else maps["seg"]
    b = dict(
        dims=(ni, h, hp, d, dp, sdp, kw, kf), mm=mm, tiles=tiles,
        route=3 if on_f32 else 2 if hopper else int(tiles), n_rows=n_rows,
        t_slots=t_slots, n_part=n_part, n_hc=n_hc, xk=xk, efk=efk, wfk=wfk, gk=gk,
        plan=_plan(slot_meta, n_out, n_rows, block_nodes, chunk), maps=maps, seg=seg,
        n_seg=f32_units(irreps_str, num_basis, node_dim)[1] if on_f32 else seg.shape[0],
        dx=torch.empty((n_rows, hp + dp), **f32),
        d_ef=torch.empty((t_slots, F_PACK), **f32),
        dwf_part=torch.empty((n_part, kf, h), **f32),
        d_wf=torch.empty((F_PACK, hp), **f32),
        rows=torch.empty(bwd_scratch_shape(t_slots, h, d) if tiles else (0,),
                         dtype=torch.bfloat16, device=dev),
        dfw_rows=_dfw_scratch(tiles, "message_bwd", t_slots, ni, node_dim, d, kw, kf, dev),
        def_part=torch.empty((n_hc, t_slots, kf) if n_hc > 1 else (0,), **f32),
    )
    _check_cuda(xk, efk, wfk, gk, b["plan"]["src_ptr"], b["dx"], b["rows"])
    if any(t.data_ptr() % 16 for t in (xk, efk, gk)):
        raise ValueError("fused message: operands must be 16-byte aligned")
    return b


def message_bwd_cuda(
    x_cat, edge_feat, wf_aug, g, slot_meta,
    irreps_str, num_basis, node_dim, n_out, block_nodes, chunk, mm_dtype,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx_cat, d_edge_feat, d_wf_aug), f32, by ``csrc/message_bwd.cu``.
    f32 operands at the widths of :func:`f32_route` take its f32 tile pass
    (``csrc/message_f32_tile.cuh``: dx summed in registers along the list by
    source, no scratch), the other f32 widths the walk kernels.  In bf16, at
    the widths of :func:`hopper_route` its tile pass is the Hopper one
    (``csrc/message_bwd_hopper.cuh``), elsewhere on the tile route
    (:func:`tile_route`) the mma.sync one; either writes each valid
    slot's ``[dgs | dgv]`` row to a bf16 scratch of
    :func:`bwd_scratch_shape` (at the slot's position in the list by
    source), which the dx pass sums by source, and past Kf = 32 or H = 768
    each slot's dfw row to a second scratch that the d_wf pass reads; on
    the walk route the slot pass may run in column chunks
    (:func:`walk_chunks`) whose d_ef partials a reduction sums."""
    if not x_cat.is_cuda:
        raise ValueError("message_bwd_cuda takes CUDA tensors")
    b = _bwd_setup(x_cat, edge_feat, wf_aug, g, slot_meta, irreps_str, num_basis, node_dim,
                   n_out, block_nodes, chunk, mm_dtype)
    ni, h, hp, d, dp, sdp, kw, kf = b["dims"]
    plan, maps = b["plan"], b["maps"]
    launch(
        "message_bwd",
        b["xk"].data_ptr(), b["efk"].data_ptr(), b["wfk"].data_ptr(), b["gk"].data_ptr(),
        plan["src_ptr"].data_ptr(), plan["src_slots"].data_ptr(),
        plan["slot_src"].data_ptr(), plan["slot_dst"].data_ptr(),
        plan["src_pos"].data_ptr(),
        maps["lane_gate"].data_ptr(), maps["lane_ycol"].data_ptr(),
        maps["gate_lane0"].data_ptr(), maps["gate_dim"].data_ptr(),
        maps["ylane_ptr"].data_ptr(), maps["ylane_idx"].data_ptr(), b["seg"].data_ptr(),
        _ptr(b["rows"]), _ptr(b["dfw_rows"]), _ptr(b["def_part"]),
        b["dx"].data_ptr(), b["d_ef"].data_ptr(), b["dwf_part"].data_ptr(),
        b["d_wf"].data_ptr(),
        b["n_rows"], b["t_slots"], b["n_part"], ni, h, hp, d, dp, sdp, kw, kf,
        b["n_seg"], int(b["mm"] == torch.bfloat16), b["route"], b["n_hc"],
        torch.cuda.current_stream(x_cat.device).cuda_stream,
    )
    return b["dx"], b["d_ef"], b["d_wf"]


def _floor_route(irreps_str, num_basis, node_dim, mm_dtype) -> bool:
    """Whether the stream floor takes these widths: those of message_bwd's
    Hopper tile pass (:func:`hopper_route`), whose streams it runs."""
    return hopper_route(mm_dtype, irreps_str, num_basis, node_dim)


def bwd_stream_floor_cuda(
    x_cat, edge_feat, wf_aug, g, slot_meta,
    irreps_str, num_basis, node_dim, n_out, block_nodes, chunk, mm_dtype,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx_cat, d_edge_feat, d_wf_aug), f32, by ``csrc/bwd_stream_floor.cu``:
    :func:`message_bwd_cuda`'s bf16 tile route, with its launch's operands,
    plan, maps, scratch and outputs, staging and storing what its tile pass
    does with a near-empty body, then its dx pass and its d_wf reduction.
    The values are :func:`plain_bwd_stream_floor`'s; the time is the
    backward's stream floor (``xequinet_torch/tools/bwd_stream_floor.py``).
    Takes only the widths of :func:`_floor_route`."""
    if not x_cat.is_cuda:
        raise ValueError("bwd_stream_floor_cuda takes CUDA tensors")
    if not _floor_route(irreps_str, num_basis, node_dim, mm_dtype):
        raise ValueError("bwd_stream_floor_cuda takes the widths of message_bwd's Hopper "
                         "tile pass (hopper_route: bf16, Kf <= 32, H <= 576, irrep runs of "
                         "even multiplicity)")
    b = _bwd_setup(x_cat, edge_feat, wf_aug, g, slot_meta, irreps_str, num_basis, node_dim,
                   n_out, block_nodes, chunk, mm_dtype)
    ni, h, hp, d, dp, sdp, kw, kf = b["dims"]
    plan, maps = b["plan"], b["maps"]
    launch(
        "bwd_stream_floor",
        b["xk"].data_ptr(), b["efk"].data_ptr(), b["wfk"].data_ptr(), b["gk"].data_ptr(),
        plan["src_ptr"].data_ptr(), plan["slot_src"].data_ptr(),
        plan["slot_dst"].data_ptr(), plan["src_pos"].data_ptr(),
        maps["lane_ycol"].data_ptr(), maps["gate_lane0"].data_ptr(),
        maps["gate_dim"].data_ptr(), maps["seg"].data_ptr(), b["rows"].data_ptr(),
        b["dx"].data_ptr(), b["d_ef"].data_ptr(), b["dwf_part"].data_ptr(),
        b["d_wf"].data_ptr(),
        b["n_rows"], b["t_slots"], b["n_part"], ni, h, hp, d, dp, sdp, kw, kf,
        maps["seg"].shape[0], torch.cuda.current_stream(x_cat.device).cuda_stream,
    )
    return b["dx"], b["d_ef"], b["d_wf"]


# the phases of bwd_phase_stamps', bwd2_phase_stamps' and fwd_phase_stamps'
# stamps, in their order (8 per role)
PHASES = {
    "tile": ("prologue", "wait + barrier", "A: dfo gate sums", "B: fw, dfw, dgs, fo",
             "C: dgv, drsh", "D: d_ef, d_wf products", "E: d_ef rows", "epilogue"),
    "hopper": ("prologue, epilogue", "wait", "first fw product",
               "B: dfw, dgs, fo (and the warpgroup's barrier)", "d_wf, d_ef products, next fw",
               "C: dgv, drsh", "barrier of the warpgroups, d_ef rows, release",
               "A: dfo gate sums (and its barrier)"),
    "producer": ("prologue", "wait for a free stage", "slot indices", "copies issued", "-",
                 "-", "-", "epilogue"),
    # message_bwd2's (bwd2_phase_stamps): the mma.sync tile pass by thread 0
    # of each block, the Hopper pass by each consumer warpgroup (its
    # producer's as "producer")
    "tile2": ("prologue, epilogue", "wait + barrier", "A: dfo, u gate sums",
              "B: fw, r, a, fo, dfw2, dfwr, d2x hidden", "C: d2x lanes, d2g, harmonic d2ef",
              "D1: d2ef filter columns", "D2: d2wf products, next copies", "E: d2ef rows"),
    "hopper2": ("prologue, epilogue", "wait for a full stage", "wait for products",
                "elementwise (and the warpgroup's barrier)", "products issued",
                "last products' wait", "consumer barriers, harmonic d2ef",
                "filter d2ef, release"),
    "producer2": ("prologue", "wait for a free stage", "slot indices, d2ef zeros",
                  "rows stored, copies issued", "-", "-", "-", "last rows stored, epilogue"),
    # message_fwd's (fwd_phase_stamps): the mma.sync tile pass by thread 0 of
    # each block, the Hopper pass by each consumer warpgroup and its producer
    "tile_fwd": ("prologue", "slot indices and copy issue", "wait for copies and the barrier",
                 "fw products and fo", "barriers", "destination sums", "row writes",
                 "epilogue"),
    "hopper_fwd": ("prologue, epilogue", "wait for a full stage", "fw products (issue, waits)",
                   "fo and message rows", "warpgroup barrier", "destination products issued",
                   "their wait, release, row writes", "-"),
    "producer_fwd": ("prologue", "wait for a free stage", "slot indices, edge features",
                     "stage written", "copies issued", "-", "-", "epilogue"),
    # the f32 tile passes' (f32_phase_stamps): thread 0 of the consumers and
    # lane 0 of the producer warp
    "f32": ("prologue, epilogue", "wait for a full stage", "operands and gate sums",
            "filter products, d_wf partial", "elementwise terms", "d_ef warp sums",
            "barrier, d_ef rows, release", "row writes"),
    "producer_f32": ("prologue", "wait for a free stage", "slot indices", "copies issued", "-",
                     "-", "-", "epilogue"),
    # the forward's f32 tile pass (f32_phase_stamps("message_fwd", ...)):
    # lane 0 of each consumer warp; its first producer warp's lane 0 as
    # "producer_f32"
    "f32_fwd": ("prologue", "wait for a full stage", "operands", "filter products", "messages",
                "sums and row writes", "release", "-"),
}


def bwd_phase_stamps(
    x_cat, edge_feat, wf_aug, g, slot_meta,
    irreps_str, num_basis, node_dim, n_out, block_nodes, chunk, mm_dtype, which: str,
) -> torch.Tensor:
    """clock64() cycles per phase of one launch of a ``message_bwd`` tile
    pass alone, on :func:`message_bwd_cuda`'s operands (the phase probe of
    ``xequinet_torch/tools/bwd_stream_floor.py``, on no model path; not
    counted in LAUNCHES).  ``which``: "hopper", the Hopper tile pass
    (int64 [n_part, HB_WGS + 1, 8]: the consumer warpgroups and the
    producer warp, phases as in ``PHASES``); "tile", the mma.sync tile pass's
    flagship instance (int64 [n_part, 8]).  Takes the widths of
    :func:`hopper_route`."""
    if which not in ("hopper", "tile") or not hopper_route(mm_dtype, irreps_str, num_basis,
                                                           node_dim):
        raise ValueError("bwd_phase_stamps takes which 'hopper' or 'tile' at the widths of "
                         "hopper_route")
    b = _bwd_setup(x_cat, edge_feat, wf_aug, g, slot_meta, irreps_str, num_basis, node_dim,
                   n_out, block_nodes, chunk, mm_dtype)
    ni, h, hp, d, dp, sdp, kw, kf = b["dims"]
    plan, maps = b["plan"], b["maps"]
    shape = (b["n_part"], HB_WGS + 1, 8) if which == "hopper" else (b["n_part"], 8)
    stamps = torch.zeros(shape, dtype=torch.int64, device=x_cat.device)
    probe(
        "bwd_phases",
        b["xk"].data_ptr(), b["efk"].data_ptr(), b["wfk"].data_ptr(), b["gk"].data_ptr(),
        plan["slot_src"].data_ptr(), plan["slot_dst"].data_ptr(), plan["src_pos"].data_ptr(),
        maps["lane_gate"].data_ptr(), maps["lane_ycol"].data_ptr(),
        maps["gate_lane0"].data_ptr(), maps["gate_dim"].data_ptr(), maps["seg"].data_ptr(),
        b["rows"].data_ptr(), b["d_ef"].data_ptr(), b["dwf_part"].data_ptr(),
        b["t_slots"], b["n_part"], ni, h, hp, d, dp, sdp, kw, kf, maps["seg"].shape[0],
        int(which == "hopper"), stamps.data_ptr(),
        torch.cuda.current_stream(x_cat.device).cuda_stream,
    )
    return stamps


def f32_phase_stamps(kernel: str, *args) -> torch.Tensor:
    """clock64() cycles per phase of one launch of ``kernel``'s f32 tile pass
    ("message_bwd", "message_bwd2" or "message_fwd"), on the arguments of
    its wrapper (:func:`message_bwd_cuda`'s, :func:`message_bwd2_cuda`'s
    without cwf, or :func:`message_fwd_cuda`'s), with the rest of its route
    (the phase probe of ``xequinet_torch/tools/bwd_compare.py --dtype
    float32 --phases``, on no model path; not counted in LAUNCHES): for the
    backwards int64 [n_part, 2, 8], the consumers' thread 0
    (``PHASES["f32"]``) and the producer's lane 0
    (``PHASES["producer_f32"]``); for the forward int64 [n_part, n_cw + 1,
    8], lane 0 of each consumer warp (``PHASES["f32_fwd"]``) and of the
    first producer warp (``PHASES["producer_f32"]``).  Takes the widths of
    :func:`f32_route`."""
    if kernel not in ("message_bwd", "message_bwd2", "message_fwd"):
        raise ValueError("f32_phase_stamps takes message_bwd, message_bwd2 or message_fwd")
    if kernel == "message_fwd":
        return _fwd_f32_phase_stamps(*args)
    second = kernel == "message_bwd2"
    b = _bwd2_setup(*args) if second else _bwd_setup(*args)
    if b["route"] != 3:
        raise ValueError("f32_phase_stamps takes the widths and dtype of f32_route (f32 "
                         "operands, no cwf)")
    ni, h, hp, d, dp, sdp, kw, kf = b["dims"]
    plan, dev = b["plan"], b["xk"].device
    stamps = torch.zeros((b["n_part"], 2, 8), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if second:
        n_out, node_dim = b["d2g"].shape[0], h - 2 * ni
        probe("bwd2_f32_phases", b["xk"].data_ptr(), b["efk"].data_ptr(), b["wfk"].data_ptr(),
              b["gk"].data_ptr(), b["cxk"].data_ptr(), b["cefk"].data_ptr(),
              plan["dst_ptr"].data_ptr(), plan["src_ptr"].data_ptr(),
              plan["src_slots"].data_ptr(), plan["slot_src"].data_ptr(),
              plan["slot_dst"].data_ptr(), plan["dst_pos"].data_ptr(), b["tab"].data_ptr(),
              b["rows_g"].data_ptr(), b["d2x"].data_ptr(), b["d2ef"].data_ptr(),
              b["d2wf_part"].data_ptr(), b["d2wf"].data_ptr(), b["d2g"].data_ptr(),
              n_out, b["n_rows"], b["t_slots"], b["n_part"], ni, node_dim, h, hp, d, dp, sdp,
              kw, kf, b["n_tab"], stamps.data_ptr(), stream)
    else:
        probe("bwd_f32_phases", b["xk"].data_ptr(), b["efk"].data_ptr(), b["wfk"].data_ptr(),
              b["gk"].data_ptr(), plan["src_ptr"].data_ptr(), plan["src_slots"].data_ptr(),
              plan["slot_src"].data_ptr(), plan["slot_dst"].data_ptr(), b["seg"].data_ptr(),
              b["dx"].data_ptr(), b["d_ef"].data_ptr(), b["dwf_part"].data_ptr(),
              b["d_wf"].data_ptr(), b["n_rows"], b["t_slots"], b["n_part"], ni, h, hp, d, dp,
              sdp, kw, kf, b["n_seg"], stamps.data_ptr(), stream)
    return stamps


def _fwd_f32_phase_stamps(x_cat, edge_feat, wf_aug, slot_meta, irreps_str, num_basis, node_dim,
                          n_out, block_nodes, chunk, mm_dtype) -> torch.Tensor:
    b = _fwd_setup(x_cat, edge_feat, wf_aug, slot_meta, irreps_str, num_basis, node_dim, n_out,
                   block_nodes, chunk, mm_dtype)
    if b["route"] != 3:
        raise ValueError("f32_phase_stamps takes the widths and dtype of f32_route (f32 "
                         "operands)")
    ni, h, hp, d, dp, sdp, kw, kf = b["dims"]
    plan, dev = b["plan"], b["xk"].device
    stamps = torch.zeros((b["n_part"], b["n_pt"] + 1, 8), dtype=torch.int64, device=dev)
    probe("fwd_f32_phases", b["xk"].data_ptr(), b["efk"].data_ptr(), b["wfk"].data_ptr(),
          plan["dst_ptr"].data_ptr(), plan["dst_slots"].data_ptr(), plan["slot_src"].data_ptr(),
          plan["slot_dst"].data_ptr(), b["ftab"].data_ptr(), b["out"].data_ptr(), n_out, ni,
          node_dim, hp, d, dp, sdp, kw, kf, b["n_pt"], b["n_part"], stamps.data_ptr(),
          torch.cuda.current_stream(dev).cuda_stream)
    return stamps


def plain_bwd_stream_floor(
    x_cat, edge_feat, wf_aug, g, slot_meta,
    irreps_str, num_basis, node_dim, n_out, block_nodes, chunk, mm_dtype,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """What :func:`bwd_stream_floor_cuda` returns, in plain tensor ops: dx
    and d_wf zero, and each slot's d_ef row the tile pass's staged
    edge-feature columns (Kf rounded up to 32) in the kernel's dtype, as
    f32, on the slots that add something (zero past those columns and on
    the other slots).  Port of ``floor_kernel``'s outputs
    (tools/bwd_stream_floor.py:73-99), which copies all 128 columns on
    every slot of the covered chunks."""
    ni, h, hp, d, dp, sdp, kw, kf = _launch_dims(irreps_str, num_basis, node_dim)
    dev = x_cat.device
    valid = _plan(slot_meta, n_out, x_cat.shape[0], block_nodes, chunk)["slot_dst"] >= 0
    ke = _ru(kf, 32)
    d_ef = torch.zeros((edge_feat.shape[0], F_PACK), dtype=torch.float32, device=dev)
    d_ef[:, :ke] = torch.where(valid[:, None], edge_feat[:, :ke].to(_mm_dtype(mm_dtype)).float(),
                               torch.zeros((), device=dev))
    return (torch.zeros((x_cat.shape[0], hp + dp), dtype=torch.float32, device=dev), d_ef,
            torch.zeros((F_PACK, hp), dtype=torch.float32, device=dev))


def _round8(n: int) -> int:
    return (n + 7) // 8 * 8


def _ptr(t: torch.Tensor):
    """A scratch's pointer, None (NULL) when it was not needed."""
    return t.data_ptr() if t.numel() else None


def _dfw_scratch(tiles: bool, kernel: str, t_slots: int, ni: int, node_dim: int, d: int,
                 kw: int, kf: int, dev) -> torch.Tensor:
    """A tile pass's dfw rows (bf16, one per slot of its 16-slot tiles, H
    rounded up to 16 columns) when its d_wf partial leaves the registers."""
    if not tiles or _dwf_regs(kernel, ni, node_dim, d, kw, kf):
        return torch.empty((0,), dtype=torch.bfloat16, device=dev)
    return torch.empty((_ru(t_slots, 16), _ru(node_dim + 2 * ni, 16)), dtype=torch.bfloat16,
                       device=dev)


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


# each wrapper's launches by pass, by kernel name as torch.profiler shows
# them (the forward launches one, its tile pass or its walk kernel; the d_wf
# passes launch only where the tile pass's d_wf partial leaves the
# registers; "tile pass" is whichever tile pass the route takes, the f32
# one too; the walk kernels' passes at the widths no tile pass takes)
PASSES = {
    "message_fwd": (("tile pass", "message_fwd_(?:tile|hopper|f32)_kernel"),
                    ("walk kernel", "message_fwd_kernel")),
    "message_bwd": (("tile pass", "message_bwd_(?:tile|hopper|f32)_kernel"),
                    ("dx pass", "message_bwd_dx_rows_kernel"),
                    ("d_wf pass", "xeq_dwf_pass_kernel"),
                    ("d_wf reduction", "xeq_dwf_reduce_kernel"),
                    # the walk kernels (the widths no tile pass takes)
                    ("dx walk", "message_bwd_dx_kernel"),
                    ("slot pass", "message_bwd_slot_kernel"),
                    ("d_ef reduction", "xeq_def_reduce_kernel")),
    "message_bwd2": (("tile pass", "message_bwd2_(?:tile|hopper|f32)_kernel"),
                     ("d2x pass", "message_bwd2_d2x_rows_kernel"),
                     ("d2g pass", "message_bwd2_d2g_rows(?:_f32)?_kernel"),
                     ("d2wf pass", "xeq_dwf_pass_kernel"),
                     ("d2wf reduction", "xeq_dwf_reduce_kernel"),
                     # the walk kernels
                     ("d2g walk", "message_bwd2_dg_kernel"),
                     ("d2x walk", "message_bwd2_dx_kernel"),
                     ("slot pass", "message_bwd2_slot_kernel"),
                     ("d2ef reduction", "xeq_def_reduce_kernel")),
    "bwd_stream_floor": (("tile pass", "bwd_stream_floor_tile_kernel"),
                         ("dx pass", "message_bwd_dx_rows_kernel"),
                         ("d_wf reduction", "xeq_dwf_reduce_kernel")),
}


_DEVICE_TABS: Dict[tuple, torch.Tensor] = {}


def _device_pair_table(irreps_str: str, num_basis: int, node_dim: int, device):
    key = (irreps_str, num_basis, node_dim, str(device))
    if key not in _DEVICE_TABS:
        _DEVICE_TABS[key] = torch.as_tensor(pair_table(irreps_str, num_basis, node_dim)[0],
                                            device=device)
    return _DEVICE_TABS[key]


_DEVICE_UNITS: Dict[tuple, torch.Tensor] = {}


def _device_units(irreps_str: str, num_basis: int, node_dim: int, device):
    key = (irreps_str, num_basis, node_dim, str(device))
    if key not in _DEVICE_UNITS:
        _DEVICE_UNITS[key] = torch.as_tensor(f32_units(irreps_str, num_basis, node_dim)[0],
                                             device=device).contiguous()
    return _DEVICE_UNITS[key]


def _bwd2_setup(x_cat, edge_feat, wf_aug, g, cx, cef, cwf, slot_meta, irreps_str, num_basis,
                node_dim, n_out, block_nodes, chunk, mm_dtype):
    """What a launch of the second order takes, shared by
    :func:`message_bwd2_cuda` and :func:`bwd2_phase_stamps`: the widths,
    the route (``route``: 2 the Hopper tile pass, 1 the tile pass, 0 the
    walk kernels), the operands and cotangents in the kernel's dtype
    (``None`` cx or cef as zeros), the slot plan, the index maps, the pair
    table, the outputs (d2x, d2ef, d2wf, d2g), the per-block d2wf partials
    and the scratch."""
    ni, h, hp, d, dp, sdp, kw, kf = _launch_dims(irreps_str, num_basis, node_dim)
    mm = _mm_dtype(mm_dtype)
    has_cwf = cwf is not None
    hopper = hopper2_route(mm, irreps_str, num_basis, node_dim, has_cwf)
    tiles = hopper or tile_route("message_bwd2", mm, irreps_str, num_basis, node_dim, has_cwf)
    on_f32 = f32_route("message_bwd2", mm, irreps_str, num_basis, node_dim, has_cwf)
    dev = x_cat.device
    n_rows, t_slots = x_cat.shape[0], edge_feat.shape[0]
    if x_cat.shape[1] != hp + dp or edge_feat.shape[1] != F_PACK or wf_aug.shape != (F_PACK, hp):
        raise ValueError("fused message: operand shapes do not match the irreps")
    if g.shape != (n_out, sdp + dp):
        raise ValueError("fused message: g must be [n_out, SDp + Dp]")
    cx = torch.zeros_like(x_cat) if cx is None else cx
    cef = torch.zeros_like(edge_feat) if cef is None else cef
    if cx.shape != x_cat.shape or cef.shape != edge_feat.shape or (
            has_cwf and cwf.shape != wf_aug.shape):
        raise ValueError("fused message: cotangent shapes do not match the operands")
    cast = lambda t: t.to(mm).contiguous()
    xk, efk, wfk, gk, cxk, cefk = map(cast, (x_cat, edge_feat, wf_aug, g, cx, cef))
    n_part = torch.cuda.get_device_properties(dev).multi_processor_count
    f32 = dict(dtype=torch.float32, device=dev)
    shape_x, shape_g = bwd2_scratch_shapes(t_slots, h, node_dim, d) if tiles else ((0,), (0,))
    if on_f32:  # the f32 pass sums d2x in registers; its d2g rows are f32
        shape_x, shape_g = (0,), bwd2_scratch_shapes(t_slots, h, node_dim, d)[1]
    n_hc = 1 if tiles or on_f32 else walk_chunks("message_bwd2", ni, h, kw, kf)
    b = dict(
        dims=(ni, h, hp, d, dp, sdp, kw, kf), mm=mm,
        route=3 if on_f32 else 2 if hopper else int(tiles),
        n_rows=n_rows, t_slots=t_slots, n_part=n_part, n_hc=n_hc,
        xk=xk, efk=efk, wfk=wfk, gk=gk, cxk=cxk, cefk=cefk,
        cwfk=cast(cwf) if has_cwf else None,
        plan=_plan(slot_meta, n_out, n_rows, block_nodes, chunk),
        maps=_device_maps(irreps_str, num_basis, dev),
        # the table the C side reads as ``tab``: the Hopper pass's pair rows,
        # or the f32 pass's units
        tab=(_device_pair_table(irreps_str, num_basis, node_dim, dev) if hopper
             else _device_units(irreps_str, num_basis, node_dim, dev) if on_f32
             else torch.empty((0,), dtype=torch.int32, device=dev)),
        n_tab=(pair_table(irreps_str, num_basis, node_dim)[1] if hopper
               else f32_units(irreps_str, num_basis, node_dim)[1] if on_f32 else 0),
        d2x=torch.empty((n_rows, hp + dp), **f32),
        d2ef=torch.empty((t_slots, F_PACK), **f32),
        d2wf_part=torch.empty((n_part, kf, h), **f32),
        d2wf=torch.empty((F_PACK, hp), **f32),
        d2g=torch.empty((n_out, sdp + dp), **f32),
        rows_x=torch.empty(shape_x, dtype=torch.bfloat16, device=dev),
        rows_g=torch.empty(shape_g, dtype=torch.float32 if on_f32 else torch.bfloat16,
                           device=dev),
        dfw2_rows=_dfw_scratch(tiles and not hopper, "message_bwd2", t_slots, ni, node_dim, d,
                               kw, kf, dev),
        dfwr_rows=_dfw_scratch(tiles and not hopper, "message_bwd2", t_slots, ni, node_dim, d,
                               kw, kf, dev),
        def_part=torch.empty((n_hc, t_slots, kf) if n_hc > 1 else (0,), **f32),
    )
    _check_cuda(xk, efk, wfk, gk, cxk, cefk, b["plan"]["dst_ptr"], b["plan"]["src_ptr"],
                b["d2x"], b["rows_g"], *(() if b["cwfk"] is None else (b["cwfk"],)))
    if any(t.data_ptr() % 16 for t in (xk, efk, gk, cxk, cefk)):
        raise ValueError("fused message: operands must be 16-byte aligned")
    return b


def message_bwd2_cuda(
    x_cat, edge_feat, wf_aug, g, cx, cef, cwf, slot_meta,
    irreps_str, num_basis, node_dim, n_out, block_nodes, chunk, mm_dtype,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(d2x_cat, d2_edge_feat, d2_wf_aug, d2g), f32, by
    ``csrc/message_bwd2.cu``: the VJP of :func:`message_bwd_cuda` for the
    cotangents (cx, cef, cwf).  f32 operands without cwf at the widths of
    :func:`f32_route` take its f32 tile pass (``csrc/message_f32_tile.cuh``:
    d2x summed in registers along the list by source, each valid slot's d2g
    row to an f32 scratch of ``bwd2_scratch_shapes(...)[1]`` at its
    position by destination, which a row pass sums).  On the tile route
    (bf16 without cwf) the
    tile pass (at the widths of :func:`hopper2_route` the Hopper one of
    ``csrc/message_bwd2_hopper.cuh``, elsewhere on :func:`tile_route` the
    mma.sync one) writes each valid slot's d2x and d2g rows to the bf16
    scratch of :func:`bwd2_scratch_shapes` (at its positions in the lists
    by source and by destination), which the row passes sum, and the
    mma.sync pass past Kf = 32 or H = 768 its dfw2 and dfwr rows to the
    scratch of the d2wf pass; the walk route runs in column chunks where
    the whole width does not fit (:func:`walk_chunks`).

    A ``None`` cx or cef is materialized as zeros; a ``None`` cwf (force
    training: ``wf_aug`` is not on the path to the positions) selects the
    kernel's specialization without the cwf terms.  As for the operands
    (``edge_feat`` columns >= Kf and ``wf_aug`` rows >= Kw are zero), the
    kernel takes the cotangents the model hands it: ``cef`` columns >= Kf
    and ``cwf`` rows >= Kf are zero, because ``pack_edge_features`` and the
    ``wf_aug`` probe pad those entries with constants."""
    if not x_cat.is_cuda:
        raise ValueError("message_bwd2_cuda takes CUDA tensors")
    b = _bwd2_setup(x_cat, edge_feat, wf_aug, g, cx, cef, cwf, slot_meta, irreps_str,
                    num_basis, node_dim, n_out, block_nodes, chunk, mm_dtype)
    ni, h, hp, d, dp, sdp, kw, kf = b["dims"]
    plan, maps = b["plan"], b["maps"]
    launch(
        "message_bwd2",
        b["xk"].data_ptr(), b["efk"].data_ptr(), b["wfk"].data_ptr(), b["gk"].data_ptr(),
        b["cxk"].data_ptr(), b["cefk"].data_ptr(),
        None if b["cwfk"] is None else b["cwfk"].data_ptr(),
        plan["dst_ptr"].data_ptr(), plan["dst_slots"].data_ptr(),
        plan["src_ptr"].data_ptr(), plan["src_slots"].data_ptr(),
        plan["slot_src"].data_ptr(), plan["slot_dst"].data_ptr(),
        plan["src_pos"].data_ptr(), plan["dst_pos"].data_ptr(),
        maps["lane_gate"].data_ptr(), maps["lane_ycol"].data_ptr(),
        maps["gate_lane0"].data_ptr(), maps["gate_dim"].data_ptr(),
        maps["ylane_ptr"].data_ptr(), maps["ylane_idx"].data_ptr(), _ptr(b["tab"]),
        _ptr(b["rows_x"]), _ptr(b["rows_g"]), _ptr(b["dfw2_rows"]),
        _ptr(b["dfwr_rows"]), _ptr(b["def_part"]), b["d2x"].data_ptr(), b["d2ef"].data_ptr(),
        b["d2wf_part"].data_ptr(), b["d2wf"].data_ptr(), b["d2g"].data_ptr(),
        n_out, b["n_rows"], b["t_slots"], b["n_part"], ni, node_dim, h, hp, d, dp, sdp, kw, kf,
        int(b["mm"] == torch.bfloat16), int(b["cwfk"] is not None), b["route"], b["n_hc"],
        b["n_tab"], torch.cuda.current_stream(x_cat.device).cuda_stream,
    )
    return b["d2x"], b["d2ef"], b["d2wf"], b["d2g"]


def bwd2_phase_stamps(
    x_cat, edge_feat, wf_aug, g, cx, cef, slot_meta,
    irreps_str, num_basis, node_dim, n_out, block_nodes, chunk, mm_dtype, which: str,
) -> torch.Tensor:
    """clock64() cycles per phase of one launch of a ``message_bwd2`` bf16
    tile pass without cwf alone, on :func:`message_bwd2_cuda`'s operands
    (the phase probe of ``xequinet_torch/tools/bwd_compare.py``, on no
    model path; not counted in LAUNCHES): :func:`bwd_phase_stamps`'
    counterpart for the second order.  ``which``: "hopper", the Hopper tile
    pass (int64 [n_part, HB2_WGS + 1, 8]: the consumer warpgroups and the
    producer warp, phases as in ``PHASES["hopper2"]`` and
    ``PHASES["producer2"]``); "tile", the mma.sync tile pass's flagship
    instance (int64 [n_part, 8], ``PHASES["tile2"]``).  Takes the widths
    of :func:`hopper2_route`."""
    if which not in ("hopper", "tile") or not hopper2_route(mm_dtype, irreps_str, num_basis,
                                                            node_dim):
        raise ValueError("bwd2_phase_stamps takes which 'hopper' or 'tile' at the widths of "
                         "hopper2_route")
    b = _bwd2_setup(x_cat, edge_feat, wf_aug, g, cx, cef, None, slot_meta, irreps_str,
                    num_basis, node_dim, n_out, block_nodes, chunk, mm_dtype)
    ni, h, hp, d, dp, sdp, kw, kf = b["dims"]
    plan, maps = b["plan"], b["maps"]
    shape = (b["n_part"], HB2_WGS + 1, 8) if which == "hopper" else (b["n_part"], 8)
    stamps = torch.zeros(shape, dtype=torch.int64, device=x_cat.device)
    probe(
        "bwd2_phases",
        b["xk"].data_ptr(), b["efk"].data_ptr(), b["wfk"].data_ptr(), b["gk"].data_ptr(),
        b["cxk"].data_ptr(), b["cefk"].data_ptr(),
        plan["slot_src"].data_ptr(), plan["slot_dst"].data_ptr(), plan["src_pos"].data_ptr(),
        plan["dst_pos"].data_ptr(), maps["lane_gate"].data_ptr(), maps["lane_ycol"].data_ptr(),
        maps["gate_lane0"].data_ptr(), maps["gate_dim"].data_ptr(), _ptr(b["tab"]),
        b["rows_x"].data_ptr(), b["rows_g"].data_ptr(), b["d2ef"].data_ptr(),
        b["d2wf_part"].data_ptr(),
        b["t_slots"], b["n_part"], ni, node_dim, h, hp, d, dp, sdp, kw, kf, b["n_tab"],
        int(which == "hopper"), stamps.data_ptr(),
        torch.cuda.current_stream(x_cat.device).cuda_stream,
    )
    return stamps


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
        if remat.recomputing():
            # the message block only sums the aggregate into its outputs,
            # and the backward reads the inputs alone: a recompute launches
            # nothing (the JAX program keeps no forward pallas_call there)
            sdp, dp = _pad128(node_dim), _pad128(Irreps(irreps_str).dim)
            return x_cat.new_empty((n_out, sdp + dp), dtype=torch.float32)
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
        if remat.spent_after(5):
            # a rerun of the first-order VJP that needs only these saves
            # (remat's first message block): nothing reads the outputs
            return (torch.empty_like(x_cat), torch.empty_like(edge_feat),
                    torch.empty_like(wf_aug))
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
