"""The message forward's choice between its passes on the CPU:
``fwd_hopper_route`` (the Hopper tile pass of csrc/message_fwd_hopper.cuh)
against ``tile_route`` (the mma.sync tile pass of csrc/message_fwd.cu) and
the walk kernel, the Python mirror of the Hopper pass's shared-memory
layout, its table (``fwd_table``: the message rows each warpgroup forms
and sums), a plain-torch emulation of the pass's order of work against
the plain message forward, the profiler names of ``PASSES`` and the phase
probe's refusals.  Nothing here needs a card or JAX; the kernel itself is
held against the plain version in tests/test_torch_gpu.py."""

import re

import numpy as np
import pytest
import torch

from xequinet_torch.ops import fused_message as fm
from xequinet_torch.ops.irreps import Irreps

FLAGSHIP = ("128x0e+64x1o+32x2e", 20, 128)
# the other widths the Hopper pass takes: one pair tile and one scalar tile
# (a warpgroup with padding columns only), pair tiles of l = 0 and l = 1
TAKEN = [FLAGSHIP, ("16x0e+8x1o+4x2e", 8, 16), ("120x0e+24x1o", 8, 16)]
TAKEN_IDS = ("flagship", "small", "two_ls")
# the widths it refuses: H = 640 (node_dim 192: ten m64 tiles), a run of odd
# multiplicity, Kf = 33, Kf = 128, H = 1152
REFUSED = [("128x0e+64x1o+32x2e", 20, 192), ("15x0e+8x1o+4x2e", 8, 16),
           ("128x0e+64x1o+32x2e", 23, 128), ("128x0e+64x1o+32x2e", 118, 128),
           ("256x0e+128x1o+64x2e", 23, 256)]
REFUSED_IDS = ("h640", "odd_run", "kf33", "kf128", "h1152")


def _parts(dims):
    """fwd_table split into its parts: (pair entries, their A rows, the
    scalar tiles' A rows, the output column of each warpgroup's A rows
    [3, na * 64], n_pt, n_mt, na)."""
    ftab, n_pt, na = fm.fwd_table(*dims)
    n_mt = n_pt + -(-dims[2] // 64)
    base = 64 * n_pt + n_mt - n_pt
    return (ftab[:32 * n_pt], ftab[32 * n_pt:64 * n_pt], ftab[64 * n_pt:base],
            ftab[base:].reshape(fm.HF_WGS, na * 64), n_pt, n_mt, na)


def test_flagship_widths_take_the_fwd_hopper_pass():
    """FLAGSHIP_KW's widths (H = 576, Kf = 30) in bf16 take the Hopper pass,
    with four 16-slot stages: 16 x rows of (640 + 480) * 2 + 16 bytes (one
    bulk copy each), 1 KB of edge-feature columns, 288 bytes of harmonic
    columns, the 512-byte one-hot and 128 bytes of destinations and flags
    (38,144 with its rounding), beside wf's 9 m64 tiles, three warpgroups'
    4 A tiles of 2 KB, the table of 7 pair tiles (1,218 ints) and the
    barriers; f32 takes its own tile pass (route 3,
    tests/test_torch_f32_fwd_layout.py)."""
    assert fm.fwd_hopper_route("bfloat16", *FLAGSHIP)
    assert fm._fwd_static(*FLAGSHIP, "bfloat16")[2:] == (2, 7, 4)
    assert not fm.fwd_hopper_route("float32", *FLAGSHIP)
    assert fm._fwd_static(*FLAGSHIP, "float32")[2] == 3
    ni, h, hp, d, dp, sdp, kw, kf = fm._launch_dims(*FLAGSHIP)
    smem, nst, stage = fm._fwd_hopper_layout(ni, FLAGSHIP[2], d, kw, kf, 7, 4)
    assert stage == 38144 == 128 * -(-(16 * 2256 + 1024 + 288 + 512 + 128) // 128)
    assert fm.fwd_table(*FLAGSHIP)[0].size == 64 * 7 + 2 + 3 * 4 * 64 == 1218
    assert nst == 4 and smem == 4 * stage + 9 * 4096 + 3 * 4 * 2048 + 4880 + 64 == 218960
    assert smem <= fm.SMEM_MAX


@pytest.mark.parametrize("dims", REFUSED, ids=REFUSED_IDS)
def test_refused_widths_keep_the_mma_sync_pass(dims):
    """H = 640, an odd run, Kf = 33 / 128 and H = 1152: the mma.sync tile
    pass in bf16 (route 1); in f32 the walk kernel (route 0), but for the
    odd run, which the f32 tile pass takes (route 3, its 4 consumer
    warps)."""
    assert not fm.fwd_hopper_route("bfloat16", *dims)
    assert fm.tile_route("message_fwd", "bfloat16", *dims)
    assert fm._fwd_static(*dims, "bfloat16")[2:] == (1, 0, 0)
    odd_run = dims == REFUSED[1]
    assert fm._fwd_static(*dims, "float32")[2:] == ((3, 4, 0) if odd_run else (0, 0, 0))


@pytest.mark.parametrize("dims", TAKEN, ids=TAKEN_IDS)
def test_fwd_table_covers_every_output_column_once(dims):
    """Each warpgroup's A rows are its output columns ascending, and they
    hold every column of ``[SDp | Dp]`` exactly once over the three; a pair
    entry of tile i (warpgroup i % 3) writes its 2l + 1 lanes into that
    warpgroup's consecutive A rows from its A row; a scalar tile's 64
    node_dim columns go to its warpgroup's consecutive rows; the other
    columns (padding) are rows no step writes."""
    tab, pos, spos, cols, n_pt, n_mt, na = _parts(dims)
    ni, h, hp, d, dp, sdp, kw, kf = fm._launch_dims(*dims)
    live = cols[cols >= 0]
    assert sorted(live.tolist()) == list(range(sdp + dp))
    written = [set() for _ in range(fm.HF_WGS)]
    for q, e in enumerate(tab.tolist()):
        wg = (q // 32) % fm.HF_WGS
        if e < 0:
            assert pos[q] == -1
            continue
        j0, dim = (e >> 10) & 4095, 2 * ((e >> 22) & 3) + 1
        rows = range(pos[q], pos[q] + dim)
        assert [int(cols[wg, r]) for r in rows] == list(range(sdp + j0, sdp + j0 + dim))
        written[wg].update(rows)
    for i in range(n_pt, n_mt):
        wg, c0 = i % fm.HF_WGS, 64 * (i - n_pt)
        rows = range(spos[i - n_pt], spos[i - n_pt] + min(64, dims[2] - c0))
        assert [int(cols[wg, r]) for r in rows] == list(range(c0, c0 + len(rows)))
        written[wg].update(rows)
    for wg in range(fm.HF_WGS):
        c = cols[wg]
        assert (np.diff(c[c >= 0]) > 0).all() and (c[len(c[c >= 0]):] == -1).all()
        pad = {r for r in range(len(c)) if c[r] >= 0 and (dims[2] <= c[r] < sdp or
                                                          c[r] >= sdp + d)}
        assert written[wg] | pad == {r for r in range(len(c)) if c[r] >= 0}
        assert not written[wg] & pad
    assert na == max(-(-int((c >= 0).sum()) // 64) for c in cols) <= fm.HF_NA


def _pair_col(i, rho, tab, n_pt, ni, nd):
    """The column of H on row rho of m64 tile i (csrc/hopper_ptx.cuh
    xeq_pair_col), or -1."""
    if i < n_pt:
        e = int(tab[32 * i + 8 * (rho >> 4) + (rho & 7)])
        return -1 if e < 0 else (e & 1023) + (ni if rho & 8 else 0)
    c = 64 * (i - n_pt) + rho
    return 2 * ni + c if c < nd else -1


def _emulate(x, ef, wf, src, dst, valid, n_out, dims):
    """The Hopper pass's order of work in plain torch (bf16 operands, f32
    products and sums): per group of 16 destination rows, its slots in
    tiles of 16 (a group with none takes one tile of padding); per tile
    fw^T of each m64 tile of H in the pair-row order (rows 16 w + gq and
    16 w + 8 + gq: an entry's gates u and ni + u); fo = rnd(gs fw); the
    message rows of each entry's lanes and of the scalar tiles into the
    warpgroup's A rows; out^T += A @ onehot per warpgroup; the rows written
    at the group's end through each A row's output column."""
    tab, pos, spos, cols, n_pt, n_mt, na = _parts(dims)
    ni, h, hp, d, dp, sdp, kw, kf = fm._launch_dims(*dims)
    rnd = lambda t: t.to(torch.bfloat16).float()
    x, ef, wf = rnd(x), rnd(ef), rnd(wf)
    rows = torch.tensor([[_pair_col(i, r, tab, n_pt, ni, dims[2]) for r in range(64)]
                         for i in range(n_mt)])
    order = np.argsort(np.where(valid, dst, n_out), kind="stable")[:int(valid.sum())]
    out = torch.zeros((n_out, sdp + dp))
    for g0 in range(0, n_out, 16):
        ks = [k for k in order if g0 <= dst[k] < g0 + 16]
        acc = torch.zeros((fm.HF_WGS, na * 64, 16))
        for t0 in range(0, max(len(ks), 1), 16):
            kt = ks[t0:t0 + 16]
            a = torch.zeros((fm.HF_WGS, na * 64, 16))
            onehot = torch.zeros((16, 16))
            xs = torch.zeros((16, hp + dp))
            es = torch.zeros((16, fm.F_PACK))
            for t, k in enumerate(kt):
                onehot[t, dst[k] - g0] = 1.0
                xs[t], es[t] = x[src[k]], ef[k]
            ok = torch.arange(16) < len(kt)
            for i in range(n_mt):
                wg = i % fm.HF_WGS
                wcols = wf[:kw, rows[i].clamp(min=0)] * (rows[i] >= 0)
                fw_t = wcols.t() @ es[:, :kw].t()  # [64 rows, 16 slots]
                fo = rnd(xs[:, rows[i].clamp(min=0)].t() * fw_t)
                for w in range(4):
                    for gq in range(8):
                        if i < n_pt:
                            e = int(tab[32 * i + 8 * w + gq])
                            if e < 0:
                                continue
                            j0, l, y0 = (e >> 10) & 4095, (e >> 22) & 3, (e >> 24) & 15
                            fu, fn = fo[16 * w + gq], fo[16 * w + 8 + gq]
                            for m in range(2 * l + 1):
                                msg = xs[:, hp + j0 + m] * fu + es[:, kw + y0 + m] * fn
                                a[wg, pos[32 * i + 8 * w + gq] + m] = rnd(msg) * ok
                        else:
                            for r in (gq, gq + 8):
                                if 64 * (i - n_pt) + 16 * w + r < dims[2]:
                                    a[wg, spos[i - n_pt] + 16 * w + r] = fo[16 * w + r] * ok
            acc += a @ onehot
        for wg in range(fm.HF_WGS):
            for r, c in enumerate(cols[wg].tolist()):
                if c >= 0:
                    n = min(16, n_out - g0)
                    out[g0:g0 + n, c] = acc[wg, r, :n]
    return out


@pytest.mark.parametrize("dims", TAKEN[1:], ids=TAKEN_IDS[1:])
def test_emulated_order_of_work_equals_the_plain_forward(dims):
    """The emulation of the pass (fw^T in pair order, the messages per
    irrep, one-hot products summed per 16-row group) on seeded operands
    with padding slots, a ragged last tile, a group of 16 rows without a
    slot and a group of more than one tile: the plain message forward in
    bf16 within 2e-2 of its largest magnitude, and exactly zero rows where
    no slot ends."""
    irreps, nb, nd = dims
    ni, h, hp, d, dp, sdp, kw, kf = fm._launch_dims(*dims)
    rng = np.random.default_rng(5)
    n_out, n_slots = 56, 300
    dst = rng.integers(0, 40, n_slots)
    dst[:40] = 1  # row 1 takes more than two tiles
    src = rng.integers(0, n_out, n_slots)
    valid = rng.uniform(size=n_slots) < 0.9
    x = rng.normal(size=(n_out, hp + dp))
    x[:, h:hp] = 0.0
    x[:, hp + d:] = 0.0
    ef = np.zeros((n_slots, fm.F_PACK))
    ef[:, :kf] = rng.normal(size=(n_slots, kf))
    wf = np.zeros((fm.F_PACK, hp))
    wf[:kw, :h] = rng.normal(size=(kw, h))
    tt = lambda v: torch.as_tensor(v, dtype=torch.float32)
    got = _emulate(tt(x), tt(ef), tt(wf), src, dst, valid, n_out, dims)
    want = fm.plain_message(tt(x), tt(ef), tt(wf), torch.as_tensor(src),
                            torch.as_tensor(dst), torch.as_tensor(valid), irreps, nb, nd,
                            n_out, torch.bfloat16)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 2e-2 * scale
    empty = ~np.isin(np.arange(n_out), dst[valid])
    assert empty[40:].all() and float(got[torch.as_tensor(empty)].abs().max()) == 0.0


def test_passes_and_phases_name_the_fwd_passes():
    """torch.profiler's kernel names of the forward's split by pass: the
    Hopper and the mma.sync tile passes under "tile pass", not the probe's
    stamped mma.sync instance nor the walk kernel (a pass of its own, the
    second); eight phases of each stamped pass and of the Hopper pass's
    producer."""
    tag, name = fm.PASSES["message_fwd"][0]
    assert tag == "tile pass" and len(fm.PASSES["message_fwd"]) == 2
    for key in ("void message_fwd_hopper_kernel<false>(__nv_bfloat16 const*)",
                "void message_fwd_tile_kernel<true, false>(__nv_bfloat16 const*)"):
        assert re.search(rf"\b{name}\b", key)
    for key in ("message_fwd_tile_stamped_kernel(__nv_bfloat16 const*)",
                "void message_fwd_kernel<float, false>(float const*)"):
        assert not re.search(rf"\b{name}\b", key)
    assert len(fm.PHASES["tile_fwd"]) == len(fm.PHASES["hopper_fwd"]) == 8
    assert len(fm.PHASES["producer_fwd"]) == 8


def test_fwd_phase_probe_refuses_other_widths():
    args = [None] * 4
    with pytest.raises(ValueError, match="tile_fwd"):
        fm.fwd_phase_stamps(*args, *FLAGSHIP, 16, 16, 16, "bfloat16", which="tile")
    with pytest.raises(ValueError, match="fwd_hopper_route"):
        fm.fwd_phase_stamps(*args, *FLAGSHIP, 16, 16, 16, "float32", which="tile_fwd")
    for dims in REFUSED:
        with pytest.raises(ValueError, match="fwd_hopper_route"):
            fm.fwd_phase_stamps(*args, *dims, 16, 16, 16, "bfloat16", which="hopper_fwd")


def test_irreps_of_the_table_are_the_flagships():
    """The table's entries name each irrep of the flagship once, with its
    first lane and harmonic column (index_maps), and the route takes the
    same irreps as the second order's Hopper pass."""
    tab = fm.fwd_table(*FLAGSHIP)[0][:32 * 7]
    maps = fm.index_maps(*FLAGSHIP[:2])
    us = sorted(int(e) & 1023 for e in tab if e >= 0)
    assert us == list(range(Irreps(FLAGSHIP[0]).num_irreps))
    for e in (int(e) for e in tab if e >= 0):
        u = e & 1023
        assert (e >> 10) & 4095 == maps["gate_lane0"][u]
        assert FLAGSHIP[1] + 1 + ((e >> 24) & 15) == maps["lane_ycol"][maps["gate_lane0"][u]]
    for dims in TAKEN + REFUSED[:2]:
        assert fm.fwd_hopper_route("bfloat16", *dims) == fm.hopper2_route("bfloat16", *dims)
