"""The message forward's f32 tile pass (csrc/message_fwd_f32.cuh) on the
CPU: the route it takes by shape (``fused_message.f32_route("message_fwd",
...)`` through ``_fwd_static``), the Python mirror of its shared-memory
layout (``_f32_layout("message_fwd", ...)``, the C side's
``fwd_f32_dims``), the profiler names of ``PASSES`` and ``PHASES``,
``bwd_compare.py``'s arguments for it, and a plain-torch emulation of the
pass's order of work (the block ranges of the list by destination cut as
the C side cuts them, the units of ``f32_units`` per thread, the sums in
list order, the zero rows) against ``plain_message`` and the JAX package's
``_mega_call`` in interpret mode.  The kernel itself is held against the
plain version on a card in tests/test_torch_gpu.py.

Tolerance: f32 1e-5 of the largest reference magnitude (the sums run in
another order); rows where no slot ends are exactly zero."""

import bisect
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.test_torch_message import _problem as _jax_problem
from xequinet_tpu.ops.pallas_message import _mega_call
from xequinet_torch.ops import fused_message as fm
from xequinet_torch.tools import bwd_compare as bc

FLAGSHIP = ("128x0e+64x1o+32x2e", 20, 128)
# the widths the pass takes beside the flagship's: one to nine consumer
# warps, an odd run of irreps
TAKEN = [("16x0e+8x1o+4x2e", 8, 16), ("120x0e+24x1o", 8, 16), ("15x0e+8x1o+4x2e", 8, 16)]
# the widths it refuses, which keep the walk kernel: Kf = 33, Kf = 128, H =
# 1152 (18 consumer warps), H = 640 (10 consumer warps)
REFUSED = [("128x0e+64x1o+32x2e", 23, 128), ("128x0e+64x1o+32x2e", 118, 128),
           ("256x0e+128x1o+64x2e", 23, 256), ("128x0e+64x1o+32x2e", 20, 192)]
REFUSED_IDS = ("kf33", "kf128", "h1152", "h640")


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def test_flagship_widths_take_the_fwd_f32_pass():
    """FLAGSHIP_KW's widths (H = 576, Kw = 21, Kf = 30) in f32 take the f32
    tile pass (route 3, its 9 consumer warps in place of n_pt), with six
    8-slot stages: 8 source rows of 640 + 480 f32 (one bulk copy each), 8 x
    32 edge-feature columns and 8 destination rows, 36,992 bytes with its
    rounding, beside the barriers and the block's range; bf16 keeps the
    Hopper pass."""
    assert fm.f32_route("message_fwd", "float32", *FLAGSHIP)
    assert fm.f32_route("message_fwd", torch.float32, *FLAGSHIP)
    assert not fm.f32_route("message_fwd", "bfloat16", *FLAGSHIP)
    assert fm._fwd_static(*FLAGSHIP, "float32")[2:] == (3, 9, 0)
    assert fm._fwd_static(*FLAGSHIP, "bfloat16")[2:] == (2, 7, 4)
    assert not fm.tile_route("message_fwd", "float32", *FLAGSHIP)
    ni, h, hp, d, dp, sdp, kw, kf = fm._launch_dims(*FLAGSHIP)
    smem, nst, stage = fm._f32_layout("message_fwd", ni, FLAGSHIP[2], d, kw, kf)
    assert stage == 36992 == 128 * -(-(8 * (640 + 480) * 4 + 8 * 32 * 4 + 8 * 4) // 128)
    assert nst == fm.FF_MAXST == 6
    assert smem == 6 * stage + 2 * 6 * 8 + 16 == 222064 <= fm.SMEM_MAX


@pytest.mark.parametrize("dims", TAKEN, ids=("small", "two_ls", "odd_run"))
def test_other_widths_take_the_fwd_f32_pass(dims):
    """Narrow widths take the pass with the most stages and the consumer
    warps of f32_units (the backwards' units)."""
    ni, h, hp, d, dp, sdp, kw, kf = fm._launch_dims(*dims)
    route, n_cw, na = fm._fwd_static(*dims, "float32")[2:]
    assert (route, na) == (3, 0) and n_cw == fm.f32_units(*dims)[1]
    smem, nst, _ = fm._f32_layout("message_fwd", ni, dims[2], d, kw, kf)
    assert nst == fm.FF_MAXST and smem <= fm.SMEM_MAX
    for kernel in ("message_bwd", "message_bwd2"):
        assert fm.f32_route(kernel, "float32", *dims)


@pytest.mark.parametrize("dims", REFUSED, ids=REFUSED_IDS)
def test_refused_widths_keep_the_fwd_walk_kernel(dims):
    """Kf > 32, H = 1152 and H = 640 keep the walk kernel in f32 (route 0),
    as the backwards' f32 passes refuse them too."""
    assert not fm.f32_route("message_fwd", "float32", *dims)
    assert fm._fwd_static(*dims, "float32")[2:] == (0, 0, 0)
    assert not fm.f32_route("message_bwd", "float32", *dims)


def test_passes_and_phases_name_the_fwd_f32_pass_and_the_walk_kernel():
    """torch.profiler's kernel names of the forward's split by pass: the f32
    pass (and its stamped instance) under "tile pass" beside the Hopper and
    the mma.sync passes, the walk kernel under "walk kernel"; eight phases
    of the f32 pass's consumer warps; the probe refuses other kernels and
    dtypes."""
    def pass_of(name):
        hits = [tag for tag, pat in fm.PASSES["message_fwd"] if re.search(rf"\b{pat}\b", name)]
        assert len(hits) <= 1, hits
        return hits[0] if hits else None
    assert pass_of("void message_fwd_f32_kernel<false>(XeqFF32Args, XeqFF32Dims)") == "tile pass"
    assert pass_of("void message_fwd_f32_kernel<true>(XeqFF32Args, XeqFF32Dims)") == "tile pass"
    assert pass_of("void message_fwd_hopper_kernel<false>(__nv_bfloat16 const*)") == "tile pass"
    assert pass_of("void message_fwd_kernel<float, false>(float const*)") == "walk kernel"
    assert pass_of("message_fwd_tile_stamped_kernel(__nv_bfloat16 const*)") is None
    assert len(fm.PHASES["f32_fwd"]) == 8 and "filter products" in fm.PHASES["f32_fwd"]
    assert bc.PHASE_PASSES["message_fwd"]["f32"] == ("message_fwd_f32_kernel", "f32_fwd",
                                                     "producer_f32")
    with pytest.raises(ValueError, match="message_fwd"):
        fm.f32_phase_stamps("gather_scatter")


def test_bwd_compare_takes_the_forward_in_f32():
    """``bwd_compare.py PARENT --kernel message_fwd --dtype float32 --phases
    f32`` parses; the forward's arguments are the backward's without g."""
    a = bc.build_parser().parse_args(["_archive/parent", "--kernel", "message_fwd", "--dtype",
                                      "float32", "--phases", "f32"])
    assert (a.kernel, a.dtype, a.phases, a.trees) == ("message_fwd", "float32", ["f32"],
                                                      ["_archive/parent"])
    args = tuple(range(12))
    assert bc.kernel_args("message_fwd", args) == (0, 1, 2) + tuple(range(4, 12))


# ---------------------------------------------------------------------------
# the pass's order of work, emulated
# ---------------------------------------------------------------------------
def _ranges(ptr, n_out, n_part):
    """The blocks' row ranges as the C side cuts them (xeq_ff_row_at): block
    b owns [R_b, R_{b+1}), R_b the first row r with ptr[r] + r at or past b
    (P + n_out) // n_part (P the valid slots: a row weighs as one slot),
    R_{n_part} = n_out."""
    cost = [v + r for r, v in enumerate(ptr)]  # slots and rows before each row
    return [bisect.bisect_left(cost, b * cost[n_out] // n_part, 0, n_out)
            for b in range(n_part)] + [n_out]


def _emulate(x, ef, wf, plan, n_out, dims, n_part):
    """The f32 pass's order of work in plain torch f32: (out, writes).
    Block b of ``n_part`` owns the rows [R_b, R_{b+1}) of :func:`_ranges`
    and walks its positions in tiles of F32_BT: each tile's source
    rows [gs | 0 | gv], edge-feature columns and destination rows staged,
    then per slot, in list order, each consumer thread (a unit of
    f32_units) forms fw at its two columns (even and odd filter rows summed
    apart), fo = x fw and its messages, writing its columns of the open row
    when the destination changes and zeros on the rows of the range with no
    slot; the padding columns are written zero by the threads in turn.
    ``writes`` counts the writes of each output element."""
    ni, h, hp, d, dp, sdp, kw, kf = fm._launch_dims(*dims)
    nd = dims[2]
    units, n_cw = fm.f32_units(*dims)
    u = torch.as_tensor(units).long()
    c0, c1, j0, dim, yc = u[:, 0], u[:, 1], u[:, 2], u[:, 3] & 255, u[:, 3] >> 8
    wdim = dim.view(n_cw, 32)[:, :1].expand(n_cw, 32).reshape(-1)
    scalar = wdim == 0
    ldim = torch.where(~scalar & (c0 >= 0), dim, 0)
    m = torch.arange(5)  # an irrep's lanes at most (2l + 1, l <= 2)
    lane_on = m[None, :] < ldim[:, None]  # [threads, 5]
    # each thread's columns of wf's first F32_KW rows (zero past Kw and on
    # padding units)
    f = torch.arange(fm.F32_KW)[:, None]
    w0 = torch.where((c0 >= 0) & (f < kw), wf[:fm.F32_KW, c0.clamp(min=0)], 0.0)
    w1 = torch.where((c1 >= 0) & (f < kw), wf[:fm.F32_KW, c1.clamp(min=0)], 0.0)
    # the output columns a thread writes, with its accumulator's index
    th, ac, col = [], [], []
    for i in range(u.shape[0]):
        if scalar[i]:
            for a_, c in ((0, int(c0[i])), (1, int(c1[i]))):
                if c >= 0:
                    th.append(i), ac.append(a_), col.append(c - 2 * ni)
        else:
            for a_ in range(int(ldim[i])):
                th.append(i), ac.append(a_), col.append(sdp + int(j0[i]) + a_)
    th, ac, col = map(torch.tensor, (th, ac, col))
    pad = torch.tensor(list(range(nd, sdp)) + list(range(sdp + d, sdp + dp)), dtype=torch.long)
    out = torch.full((n_out, sdp + dp), float("nan"))
    writes = torch.zeros((n_out, sdp + dp), dtype=torch.int64)

    def put_row(r, acc):
        out[r, col] = acc[th, ac] if acc is not None else 0.0
        out[r, pad] = 0.0
        writes[r, col] += 1
        writes[r, pad] += 1

    ptr = plan["dst_ptr"].tolist()
    slots, s_src, s_dst = (plan[k].long() for k in ("dst_slots", "slot_src", "slot_dst"))
    bounds = _ranges(ptr, n_out, n_part)
    for b in range(n_part):
        r0, r1 = bounds[b], bounds[b + 1]
        p0, p1 = ptr[r0], ptr[r1]
        cur, nxt = -1, r0
        acc = torch.zeros((u.shape[0], 5))
        for q0 in range(p0, p1, fm.F32_BT):
            ks = slots[q0:min(q0 + fm.F32_BT, p1)]
            xs = x[s_src[ks], :hp + fm._ru(d, 8)]  # the staged rows
            es = ef[ks, :fm.F32_KF]
            dsts = s_dst[ks].tolist()
            for t, dst in enumerate(dsts):
                if dst != cur:
                    if cur >= 0:
                        put_row(cur, acc)
                    for r in range(nxt, dst):
                        put_row(r, None)
                    cur, nxt = dst, dst + 1
                    acc = torch.zeros_like(acc)
                x0 = torch.where(c0 >= 0, xs[t, c0.clamp(min=0)], 0.0)
                x1 = torch.where(c1 >= 0, xs[t, c1.clamp(min=0)], 0.0)
                e = es[t, :fm.F32_KW, None]
                fo0 = x0 * ((e * w0)[0::2].sum(0) + (e * w0)[1::2].sum(0))
                fo1 = x1 * ((e * w1)[0::2].sum(0) + (e * w1)[1::2].sum(0))
                xv = xs[t, (hp + j0[:, None] + m).clamp(0, xs.shape[1] - 1)]
                ey = es[t, (kw + yc[:, None] + m).clamp(max=fm.F32_KF - 1)]
                msg = torch.where(lane_on, xv * fo0[:, None] + ey * fo1[:, None], 0.0)
                msg[scalar, 0], msg[scalar, 1] = fo0[scalar], fo1[scalar]
                acc = acc + msg
        if cur >= 0:
            put_row(cur, acc)
        for r in range(nxt, r1):
            put_row(r, None)
    return out, writes


def test_block_ranges_share_a_trailing_run_of_rows_without_slots():
    """bench.py's flagship batch ends in 4,168 rows without a slot (its rows
    padded to 512-row blocks): cut by slots alone one block took them all.
    With a row weighing as one slot, on rows of 7 slots and such a tail,
    every block's slots and rows stay within one row's of an even share,
    the tail is spread over several blocks, and the ranges tile the rows."""
    n_real, n_out, n_part = 20408, 24576, 132
    ptr = [7 * min(r, n_real) for r in range(n_out + 1)]
    bounds = _ranges(ptr, n_out, n_part)
    assert bounds[0] == 0 and bounds[-1] == n_out and bounds == sorted(bounds)
    share = [ptr[b1] - ptr[b0] + b1 - b0 for b0, b1 in zip(bounds, bounds[1:])]
    even = (ptr[n_out] + n_out) / n_part
    assert max(share) <= even + 8 and min(share) >= even - 8
    assert sum(b >= n_real for b in bounds[:-1]) >= 2


def _operands(rng, dims, n_rows, n_slots):
    ni, h, hp, d, dp, sdp, kw, kf = fm._launch_dims(*dims)
    x = rng.normal(size=(n_rows, hp + dp))
    x[:, h:hp] = 0.0
    x[:, hp + d:] = 0.0
    ef = np.zeros((n_slots, fm.F_PACK))
    ef[:, :kf] = rng.normal(size=(n_slots, kf))
    wf = np.zeros((fm.F_PACK, hp))
    wf[:kw, :h] = rng.normal(size=(kw, h))
    tt = lambda v: torch.as_tensor(v, dtype=torch.float32)
    return tt(x), tt(ef), tt(wf)


def _plan(src, dst, valid, n_out):
    """The CSR list by destination of build_slot_plan, from per-slot rows."""
    key = np.where(valid, dst, n_out)
    order = np.argsort(key, kind="stable")[:int(valid.sum())]
    ptr = np.zeros(n_out + 1, dtype=np.int64)
    ptr[1:] = np.cumsum(np.bincount(key, minlength=n_out + 1)[:n_out])
    it = lambda v: torch.as_tensor(np.asarray(v), dtype=torch.int32)
    return {"dst_ptr": it(ptr), "dst_slots": it(order), "slot_src": it(np.where(valid, src, 0)),
            "slot_dst": it(np.where(valid, dst, -1))}


def _check(got, writes, want, plan, n_out):
    assert bool((writes == 1).all()), "every output element written once"
    scale = max(float(want.abs().max()), 1e-6)
    assert float((got - want).abs().max()) <= 1e-5 * scale
    ptr = plan["dst_ptr"].long()
    empty = ptr[1:] == ptr[:-1]
    if bool(empty.any()):
        assert float(got[empty].abs().max()) == 0.0


@pytest.mark.parametrize("dims", TAKEN[:2] + [("8x0e+4x1o+8x0e", 8, 16)],
                         ids=("small", "two_ls", "split_l0"))
def test_emulated_order_of_work_equals_the_plain_forward(dims):
    """The emulation on seeded operands with padding slots, a destination
    whose run spans five tiles, runs of rows without a slot at the edges of
    the blocks' ranges, a ragged last tile and more blocks than some rows
    need: plain_message in f32 within 1e-5, each element written once, the
    rows without a slot exactly zero; and a call with no valid slot."""
    irreps, nb, nd = dims
    rng = np.random.default_rng(5)
    n_out, n_rows, n_slots = 56, 60, 301
    dst = rng.integers(0, 40, n_slots)
    dst[:40] = 1  # row 1 takes five tiles
    dst[(dst >= 20) & (dst < 26)] = 19  # rows 20-25 without a slot
    src = rng.integers(0, n_rows, n_slots)
    valid = rng.uniform(size=n_slots) < 0.9
    x, ef, wf = _operands(rng, dims, n_rows, n_slots)
    want = fm.plain_message(x, ef, wf, torch.as_tensor(src), torch.as_tensor(dst),
                            torch.as_tensor(valid), irreps, nb, nd, n_out, torch.float32)
    plan = _plan(src, dst, valid, n_out)
    for n_part in (1, 7, 48):
        got, writes = _emulate(x, ef, wf, plan, n_out, dims, n_part)
        _check(got, writes, want, plan, n_out)
    none = _plan(src, dst, np.zeros(n_slots, dtype=bool), n_out)
    got, writes = _emulate(x, ef, wf, none, n_out, dims, 7)
    assert bool((writes == 1).all()) and float(got.abs().max()) == 0.0


def test_emulated_order_of_work_equals_the_jax_mega_kernel():
    """The emulation on the JAX tests' slot layout (tests/test_pallas_mega
    ``_slot_problem``: padding slots, rows without a slot) through the port's
    slot plan, on 132 blocks (more than the rows) and on 5: the JAX
    package's ``_mega_call`` in interpret mode and plain_message within
    1e-5, the rows without a slot exactly zero."""
    p = _jax_problem(np.random.default_rng(0))
    j = lambda k: jnp.asarray(p[k])
    with pltpu.force_tpu_interpret_mode():
        ref = _mega_call(j("x"), j("ef"), j("wf"), j("src2"), j("dst2"), j("cb"), j("nc"),
                         j("ws"), *p["statics"], p["n"], p["bn"], p["chunk"], p["window"],
                         p["mx"], "float32")
    ref = torch.as_tensor(np.array(ref))
    tt = lambda k: torch.as_tensor(np.array(p[k]))
    meta = tuple(tt(k) for k in ("src2", "dst2", "src_g", "dst_g", "cb", "nc", "ws"))
    x, ef, wf = (tt(k).float() for k in ("x", "ef", "wf"))
    plan = fm.build_slot_plan(meta, p["n"], p["n"], p["bn"], p["chunk"])
    assert int(plan["dst_ptr"][-1]) < meta[0].shape[0]  # padding slots
    plain = fm.plain_message(x, ef, wf, meta[2], meta[3], tt("valid"), *p["statics"], p["n"])
    for n_part in (132, 5):
        got, writes = _emulate(x, ef, wf, plan, p["n"], p["statics"], n_part)
        _check(got, writes, ref, plan, p["n"])
        _check(got, writes, plain, plan, p["n"])
