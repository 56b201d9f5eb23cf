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
(the tests); for CUDA tensors it launches its kernel or raises.  Each
CUDA wrapper counts its launches in ``LAUNCHES``.  The kernels are built
with ``nvcc`` at first use from ``xequinet_torch/csrc`` into
``xequinet_torch/_build`` and bound with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .irreps import Irreps

F_PACK = 128  # packed edge-feature width

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
_SOURCES = {"message_fwd": "message_fwd.cu", "message_bwd": "message_bwd.cu",
            "message_bwd2": "message_bwd2.cu"}
_HEADERS = ("message_common.cuh",)

# launches of each CUDA kernel wrapper (one per wrapper call that launched)
LAUNCHES: Dict[str, int] = {"message_fwd": 0, "message_bwd": 0, "message_bwd2": 0}
# per source: {"seconds": nvcc wall time, "ptxas": registers / smem report}
BUILD_INFO: Dict[str, Dict[str, object]] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


# ---------------------------------------------------------------------------
# Slot plan: the CSR lists by destination and by source the kernels walk
# ---------------------------------------------------------------------------
def build_slot_plan(slot_meta, n_out: int, n_rows: int, block_nodes: int,
                    chunk: int) -> Dict[str, torch.Tensor]:
    """From (src2, dst2, _, _, chunk_base, n_chunks, window_starts):
    per slot its global source / destination row (-1 destination on
    padding slots, dst2 == BN, and on slots past the covered chunk range),
    and stable CSR orderings of the valid slots by destination and by
    source.  Index glue in plain tensor ops, on the slots' device."""
    src2, dst2, _, _, cb, nc, ws = slot_meta[:7]
    dev = src2.device
    t = src2.shape[0]
    k = torch.arange(t, device=dev, dtype=torch.int64)
    cb64 = cb.long()
    blk = torch.searchsorted(cb64, k // chunk, right=True) - 1
    blk = blk.clamp(0, cb64.numel() - 1)
    n_cov = chunk * (cb64[-1] + nc.long()[-1])
    src_row = ws.long()[blk] + src2.long()
    dst_row = blk * block_nodes + dst2.long()
    valid = (dst2.long() < block_nodes) & (k < n_cov) & (dst_row < n_out) & (src_row < n_rows)

    def csr(key, n):
        key = torch.where(valid, key, torch.full_like(key, n))
        order = torch.argsort(key, stable=True)
        counts = torch.bincount(key, minlength=n + 1)[:n]
        ptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
        ptr[1:] = torch.cumsum(counts, 0)
        return ptr.int().contiguous(), order.int().contiguous()

    dst_ptr, dst_slots = csr(dst_row, n_out)
    src_ptr, src_slots = csr(src_row, n_rows)
    return {
        "slot_src": torch.where(valid, src_row, 0).int().contiguous(),
        "slot_dst": torch.where(valid, dst_row, -1).int().contiguous(),
        "dst_ptr": dst_ptr, "dst_slots": dst_slots,
        "src_ptr": src_ptr, "src_slots": src_slots,
    }


def _plan(slot_meta, n_out, n_rows, block_nodes, chunk):
    if len(slot_meta) > 7 and slot_meta[7] is not None:
        return slot_meta[7]
    return build_slot_plan(slot_meta, n_out, n_rows, block_nodes, chunk)


# ---------------------------------------------------------------------------
# Build and bind
# ---------------------------------------------------------------------------
def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME / nvcc)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _lib_path(name: str) -> Path:
    h = hashlib.sha1()
    for f in (_SOURCES[name],) + _HEADERS:
        h.update((CSRC_DIR / f).read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def build_kernels(names=None) -> Dict[str, Dict[str, object]]:
    """Compile the named sources (all by default) that are not built yet,
    one nvcc per source, all started together; raises on a failed build.
    Returns BUILD_INFO."""
    names = list(_SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            BUILD_INFO.setdefault(name, {"seconds": 0.0, "ptxas": "(cached)"})
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [
            _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-o", str(tmp), str(CSRC_DIR / _SOURCES[name]),
        ]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       time.perf_counter(), tmp, out)
    for name, (p, t0, tmp, out) in procs.items():
        so, se = p.communicate()
        BUILD_INFO[name] = {"seconds": time.perf_counter() - t0, "ptxas": se + so}
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {_SOURCES[name]}:\n{se}{so}")
        os.replace(tmp, out)
    return BUILD_INFO


_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "message_fwd": ("xeq_message_fwd", [_P] * 10 + [_I] * 10 + [_P]),
    "message_bwd": ("xeq_message_bwd", [_P] * 18 + [_I] * 12 + [_P]),
    "message_bwd2": ("xeq_message_bwd2", [_P] * 24 + [_I] * 15 + [_P]),
}


def _fn(name: str):
    if name not in _LIBS:
        build_kernels([name])
        _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
    sym, argtypes = _ARGTYPES[name]
    fn = getattr(_LIBS[name], sym)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


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
    if x_cat.shape[1] != hp + dp or edge_feat.shape[1] != F_PACK or wf_aug.shape != (F_PACK, hp):
        raise ValueError("fused message: operand shapes do not match the irreps")
    xk = x_cat.to(mm).contiguous()
    efk = edge_feat.to(mm).contiguous()
    wfk = wf_aug.to(mm).contiguous()
    plan = _plan(slot_meta, n_out, x_cat.shape[0], block_nodes, chunk)
    maps = _device_maps(irreps_str, num_basis, x_cat.device)
    out = torch.empty((n_out, sdp + dp), dtype=torch.float32, device=x_cat.device)
    _check_cuda(xk, efk, wfk, plan["dst_ptr"], out)
    fn = _fn("message_fwd")
    err = fn(
        xk.data_ptr(), efk.data_ptr(), wfk.data_ptr(), plan["dst_ptr"].data_ptr(),
        plan["dst_slots"].data_ptr(), plan["slot_src"].data_ptr(),
        plan["slot_dst"].data_ptr(), maps["lane_gate"].data_ptr(),
        maps["lane_ycol"].data_ptr(), out.data_ptr(),
        n_out, ni, node_dim, hp, d, dp, sdp, kw, kf, int(mm == torch.bfloat16),
        torch.cuda.current_stream(x_cat.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"message_fwd launch failed: CUDA error {err}")
    LAUNCHES["message_fwd"] += 1
    return out


def message_bwd_cuda(
    x_cat, edge_feat, wf_aug, g, slot_meta,
    irreps_str, num_basis, node_dim, n_out, block_nodes, chunk, mm_dtype,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx_cat, d_edge_feat, d_wf_aug), f32, by ``csrc/message_bwd.cu``."""
    if not x_cat.is_cuda:
        raise ValueError("message_bwd_cuda takes CUDA tensors")
    ni, h, hp, d, dp, sdp, kw, kf = _launch_dims(irreps_str, num_basis, node_dim)
    mm = _mm_dtype(mm_dtype)
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
    _check_cuda(xk, efk, wfk, gk, plan["src_ptr"], dx)
    fn = _fn("message_bwd")
    err = fn(
        xk.data_ptr(), efk.data_ptr(), wfk.data_ptr(), gk.data_ptr(),
        plan["src_ptr"].data_ptr(), plan["src_slots"].data_ptr(),
        plan["slot_src"].data_ptr(), plan["slot_dst"].data_ptr(),
        maps["lane_gate"].data_ptr(), maps["lane_ycol"].data_ptr(),
        maps["gate_lane0"].data_ptr(), maps["gate_dim"].data_ptr(),
        maps["ylane_ptr"].data_ptr(), maps["ylane_idx"].data_ptr(),
        dx.data_ptr(), d_ef.data_ptr(), dwf_part.data_ptr(), d_wf.data_ptr(),
        n_rows, t_slots, n_part, ni, h, hp, d, dp, sdp, kw, kf,
        int(mm == torch.bfloat16), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"message_bwd launch failed: CUDA error {err}")
    LAUNCHES["message_bwd"] += 1
    return dx, d_ef, d_wf


def message_bwd2_cuda(
    x_cat, edge_feat, wf_aug, g, cx, cef, cwf, slot_meta,
    irreps_str, num_basis, node_dim, n_out, block_nodes, chunk, mm_dtype,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(d2x_cat, d2_edge_feat, d2_wf_aug, d2g), f32, by
    ``csrc/message_bwd2.cu``: the VJP of :func:`message_bwd_cuda` for the
    cotangents (cx, cef, cwf).

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
    _check_cuda(xk, efk, wfk, gk, cxk, cefk, plan["dst_ptr"], plan["src_ptr"], d2x,
                *(() if cwfk is None else (cwfk,)))
    fn = _fn("message_bwd2")
    err = fn(
        xk.data_ptr(), efk.data_ptr(), wfk.data_ptr(), gk.data_ptr(),
        cxk.data_ptr(), cefk.data_ptr(), None if cwfk is None else cwfk.data_ptr(),
        plan["dst_ptr"].data_ptr(), plan["dst_slots"].data_ptr(),
        plan["src_ptr"].data_ptr(), plan["src_slots"].data_ptr(),
        plan["slot_src"].data_ptr(), plan["slot_dst"].data_ptr(),
        maps["lane_gate"].data_ptr(), maps["lane_ycol"].data_ptr(),
        maps["gate_lane0"].data_ptr(), maps["gate_dim"].data_ptr(),
        maps["ylane_ptr"].data_ptr(), maps["ylane_idx"].data_ptr(),
        d2x.data_ptr(), d2ef.data_ptr(), d2wf_part.data_ptr(), d2wf.data_ptr(),
        d2g.data_ptr(),
        n_out, n_rows, t_slots, n_part, ni, node_dim, h, hp, d, dp, sdp, kw, kf,
        int(mm == torch.bfloat16), int(cwfk is not None),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"message_bwd2 launch failed: CUDA error {err}")
    LAUNCHES["message_bwd2"] += 1
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
