"""The port's fused message op (xequinet_torch.ops.fused_message) against
the JAX package: the plain forward against ``xla_reference``, the plain
backward against ``jax.vjp`` of it, the plain second order (double VJP
and closed form) against the JAX double VJP, all against the JAX mega
kernels in interpret mode (including the asymmetric-dims case), and the
CUDA kernels' algorithm (index maps + CSR slot plan) emulated on the CPU.
The kernels themselves are held against their plain versions on a card by
tests/test_torch_gpu.py.

Tolerances: f32 1e-5 relative to the largest reference magnitude (sums in
another order); bf16 2e-2 (bench.py's band: the two packages round bf16
at different points).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.test_pallas_mega import _slot_problem
from xequinet_tpu.ops.irreps import Irreps as JIrreps
from xequinet_tpu.ops.pallas_message import (
    _mega_bwd2_call,
    _mega_bwd_call,
    _mega_call,
    _structure_matrices,
    xla_reference,
)
from xequinet_tpu.ops.pallas_message import pack_edge_features as jax_pack
from xequinet_torch.ops import fused_message as fm
from xequinet_torch.ops.irreps import Irreps

IRREPS, NB, SD = "16x0e+8x1o+4x2e", 8, 16
IR2, NB2, SD2 = "120x0e+24x1o", 8, 16  # Hp=384 != Dp=256 != SDp=128
# past the first tile passes' widths: Kf = 33 (num_basis 23), Kf = 128
# (num_basis 118, the JAX kernels' maximum), H = 1152 (node_dim 256)
KF33 = (IRREPS, 23, SD)
WIDE = [KF33, (IRREPS, 118, SD), ("256x0e+128x1o+64x2e", 23, 256)]


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _problem(rng, irreps=IRREPS, nb=NB, sd=SD):
    (src2, dst2, src_g, dst_g, cb, nc, ws, window, mx, valid,
     n_pad, total, bn, chunk) = _slot_problem(rng)
    _, _, _, _, (h, hp, d, dp, sdp, n_y) = _structure_matrices(irreps, nb, sd)
    x_cat = rng.normal(size=(n_pad, hp + dp)).astype(np.float32)
    x_cat[:, h:hp] = 0.0
    x_cat[:, hp + d:] = 0.0
    rbf = rng.normal(size=(total, nb)).astype(np.float32)
    fcut = rng.uniform(0.1, 1.0, size=(total, 1)).astype(np.float32)
    vec = rng.normal(size=(total, 3)).astype(np.float32)
    ef = np.asarray(jax_pack(jnp.asarray(rbf), jnp.asarray(fcut), jnp.asarray(vec),
                             JIrreps(irreps)))
    wf = np.zeros((128, hp), dtype=np.float32)
    wf[: nb + 1, :h] = rng.normal(size=(nb + 1, h)).astype(np.float32)
    g = rng.normal(size=(n_pad, sdp + dp)).astype(np.float32)
    return dict(src2=src2, dst2=dst2, src_g=src_g, dst_g=dst_g, cb=cb, nc=nc, ws=ws,
                window=window, mx=mx, valid=valid, n=n_pad, bn=bn, chunk=chunk,
                x=x_cat, ef=ef, wf=wf, g=g, rbf=rbf, fcut=fcut, vec=vec,
                statics=(irreps, nb, sd))


def _t(p):
    t = lambda a: torch.as_tensor(np.array(a))
    meta = tuple(t(p[k]) for k in ("src2", "dst2", "src_g", "dst_g", "cb", "nc", "ws"))
    return t(p["x"]), t(p["ef"]), t(p["wf"]), t(p["g"]), meta, t(p["valid"])


def _close(got, want, rel):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, scale)


def _jax_ref(p, cd):
    j = lambda k: jnp.asarray(p[k])
    fwd = lambda x, e, w: xla_reference(x, e, w, j("src_g"), j("dst_g"), j("valid"),
                                        *p["statics"], p["n"], compute_dtype=cd)
    out, vjp = jax.vjp(fwd, j("x"), j("ef"), j("wf"))
    return out, vjp(j("g"))


def test_pack_edge_features_matches_jax(rng):
    p = _problem(rng)
    t = lambda a: torch.as_tensor(a)
    got = fm.pack_edge_features(t(p["rbf"]), t(p["fcut"]), t(p["vec"]), Irreps(IRREPS))
    _close(got, p["ef"], 1e-5)


def test_structure_matrices_copy():
    for args in ((IRREPS, NB, SD), (IR2, NB2, SD2), ("128x0e+64x1o+32x2e", 20, 128)):
        for a, b in zip(fm.structure_matrices(*args)[:4], _structure_matrices(*args)[:4]):
            np.testing.assert_array_equal(a, b)
        assert fm.structure_matrices(*args)[4] == _structure_matrices(*args)[4]


@pytest.mark.parametrize("cd,rel", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_plain_message_matches_xla_reference(rng, cd, rel):
    p = _problem(rng)
    want, (wdx, wdef, wdwf) = _jax_ref(p, getattr(jnp, cd))
    x, ef, wf, g, meta, valid = _t(p)
    got = fm.plain_message(x, ef, wf, meta[2], meta[3], valid, *p["statics"], p["n"],
                           getattr(torch, cd))
    _close(got, want, rel)
    dx, d_ef, d_wf = fm.plain_message_bwd(x, ef, wf, g, meta[2], meta[3], valid,
                                          *p["statics"], p["n"], getattr(torch, cd))
    _close(dx, wdx, rel)
    _close(d_ef, wdef, rel)
    _close(d_wf, wdwf, rel)


@pytest.mark.parametrize("dims", [(IRREPS, NB, SD), (IR2, NB2, SD2)])
def test_plain_message_matches_jax_mega_kernels(rng, dims):
    """Against the TPU kernels themselves (interpret mode), f32."""
    p = _problem(rng, *dims)
    j = lambda k: jnp.asarray(p[k])
    statics = (*dims, p["n"], p["bn"], p["chunk"], p["window"], p["mx"], "float32")
    with pltpu.force_tpu_interpret_mode():
        want = _mega_call(j("x"), j("ef"), j("wf"), j("src2"), j("dst2"), j("cb"),
                          j("nc"), j("ws"), *statics)
        wdx, wdef, wdwf = _mega_bwd_call(j("x"), j("ef"), j("wf"), j("g"), j("src2"),
                                         j("dst2"), j("cb"), j("nc"), j("ws"), *statics)
    x, ef, wf, g, meta, valid = _t(p)
    got = fm.plain_message(x, ef, wf, meta[2], meta[3], valid, *dims, p["n"])
    _close(got, want, 1e-5)
    dx, d_ef, d_wf = fm.plain_message_bwd(x, ef, wf, g, meta[2], meta[3], valid, *dims,
                                          p["n"])
    _close(dx, wdx, 1e-5)
    _close(d_ef, wdef, 1e-5)
    _close(d_wf, wdwf, 1e-5)


def _emulate_kernels(p, x, ef, wf, g, meta):
    """The CUDA kernels' algorithm in f32 tensor ops: the slot plan's CSR
    lists and the index maps (lane_gate, lane_ycol, gate lanes, harmonic
    lanes) in place of the structure matrices."""
    irreps, nb, sd = p["statics"]
    ir = Irreps(irreps)
    ni = ir.num_irreps
    _, _, _, _, (h, hp, d, dp, sdp, n_y) = fm.structure_matrices(irreps, nb, sd)
    kw = nb + 1
    maps = {k: torch.as_tensor(v).long() for k, v in fm.index_maps(irreps, nb).items()}
    plan = fm.build_slot_plan(meta, p["n"], x.shape[0], p["bn"], p["chunk"])
    ok = plan["slot_dst"] >= 0
    ks = torch.nonzero(ok)[:, 0]
    s, i = plan["slot_src"].long()[ks], plan["slot_dst"].long()[ks]
    e = ef[ks]
    fw = e[:, :kw] @ wf[:kw, :h]
    xs = x[s]
    fo = xs[:, :h] * fw
    lg, ly = maps["lane_gate"], maps["lane_ycol"]
    msg_v = xs[:, hp:hp + d] * fo[:, lg] + e[:, ly] * fo[:, ni + lg]
    msg = torch.zeros(len(ks), sdp + dp)
    msg[:, :sd] = fo[:, 2 * ni:2 * ni + sd]
    msg[:, sdp:sdp + d] = msg_v
    # forward: the dst CSR walk == a sum in plan order
    out = torch.zeros(p["n"], sdp + dp)
    order = plan["dst_slots"].long()[: int(plan["dst_ptr"][-1])]
    pos = torch.full((ok.numel(),), -1, dtype=torch.long)
    pos[ks] = torch.arange(len(ks))
    out.index_add_(0, plan["slot_dst"].long()[order], msg[pos[order]])

    gm = g[i]
    gms_s, gms_v = gm[:, :sdp], gm[:, sdp:sdp + d]
    dfo = torch.zeros(len(ks), h)
    gl0, gd = maps["gate_lane0"], maps["gate_dim"]
    pv, pr = xs[:, hp:hp + d] * gms_v, e[:, ly] * gms_v
    dfo[:, :ni].index_add_(1, lg, pv)
    dfo[:, ni:2 * ni].index_add_(1, lg, pr)
    dfo[:, 2 * ni:] = gms_s[:, :sd]
    assert int(gd.sum()) == d and int(gl0[-1] + gd[-1]) == d
    dx = torch.zeros_like(x)
    contrib = torch.zeros(len(ks), hp + dp)
    contrib[:, :h] = dfo * fw
    contrib[:, hp:hp + d] = fo[:, lg] * gms_v
    src_order = plan["src_slots"].long()[: int(plan["src_ptr"][-1])]
    dx.index_add_(0, plan["slot_src"].long()[src_order], contrib[pos[src_order]])
    dfw = dfo * xs[:, :h]
    drsh = fo[:, ni + lg] * gms_v
    d_ef = torch.zeros(ef.shape)
    d_ef[ks, :kw] = dfw @ wf[:kw, :h].t()
    yp, yi = maps["ylane_ptr"], maps["ylane_idx"]
    for y in range(n_y):
        d_ef[ks, kw + y] = drsh[:, yi[yp[y]:yp[y + 1]]].sum(1)
    d_wf = torch.zeros(wf.shape)
    d_wf[:kw + n_y, :h] = e[:, :kw + n_y].t() @ dfw
    return out, dx, d_ef, d_wf


@pytest.mark.parametrize("dims", [(IRREPS, NB, SD), (IR2, NB2, SD2)])
def test_kernel_algorithm_emulation_matches_plain(rng, dims):
    p = _problem(rng, *dims)
    x, ef, wf, g, meta, valid = _t(p)
    out, dx, d_ef, d_wf = _emulate_kernels(p, x, ef, wf, g, meta)
    _close(out, fm.plain_message(x, ef, wf, meta[2], meta[3], valid, *dims, p["n"]), 1e-5)
    want = fm.plain_message_bwd(x, ef, wf, g, meta[2], meta[3], valid, *dims, p["n"])
    for a, b in zip((dx, d_ef, d_wf), want):
        _close(a, b, 1e-5)


def _sum_rows(rows, idx, n, w1, off2, width):
    """[n, width] from per-slot rows: their sum by ``idx``, the first w1
    columns into [:w1] and the rest into [off2:] (dx from [dgs | dgv] rows
    by source, d2g from d2g rows by destination)."""
    out = torch.zeros(n, width)
    rest = rows.shape[1] - w1
    out[:, :w1] = torch.zeros(n, w1).index_add(0, idx, rows[:, :w1])
    out[:, off2:off2 + rest] = torch.zeros(n, rest).index_add(0, idx, rows[:, w1:])
    return out


@pytest.mark.parametrize("dims", [(IRREPS, NB, SD), (IR2, NB2, SD2), KF33])
def test_message_bwd_rows_match_jax_bwd_kernel(rng, dims):
    """The per-slot rows of the bf16 tile pass, in f32: their sum by
    source is the plain VJP's dx, and their d_ef / d_wf are those of
    ``_bwd_kernel`` (``_mega_bwd_call`` in interpret mode), 1e-5."""
    p = _problem(rng, *dims)
    j = lambda k: jnp.asarray(p[k])
    statics = (*dims, p["n"], p["bn"], p["chunk"], p["window"], p["mx"], "float32")
    with pltpu.force_tpu_interpret_mode():
        wdx, wdef, wdwf = _mega_bwd_call(j("x"), j("ef"), j("wf"), j("g"), j("src2"),
                                         j("dst2"), j("cb"), j("nc"), j("ws"), *statics)
    x, ef, wf, g, meta, valid = _t(p)
    _, _, _, _, (h, hp, d, dp, sdp, n_y) = fm.structure_matrices(*dims)
    rows, dfw, d_ef, d_wf = fm.message_bwd_rows(x, ef, wf, g, meta[2], meta[3], valid, *dims)
    assert rows.shape == (ef.shape[0], h + d) and dfw.shape == (ef.shape[0], h)
    assert float(rows[~valid].abs().max()) == 0.0 and float(d_ef[~valid].abs().max()) == 0.0
    dx = _sum_rows(rows, meta[2].long(), p["n"], h, hp, hp + dp)
    want_dx = fm.plain_message_bwd(x, ef, wf, g, meta[2], meta[3], valid, *dims, p["n"])[0]
    _close(dx, want_dx, 1e-5)
    _close(dx, wdx, 1e-5)
    _close(d_ef, wdef, 1e-5)
    _close(d_wf, wdwf, 1e-5)


def test_message_bwd_rows_bf16_within_band(rng):
    """bf16: the rows at the TPU kernel's rounding points against the plain
    VJP at XLA's, bench.py's 2e-2 band."""
    p = _problem(rng)
    x, ef, wf, g, meta, valid = _t(p)
    _, _, _, _, (h, hp, d, dp, sdp, n_y) = fm.structure_matrices(*p["statics"])
    rows, _, d_ef, d_wf = fm.message_bwd_rows(x, ef, wf, g, meta[2], meta[3], valid,
                                              *p["statics"], torch.bfloat16)
    want = fm.plain_message_bwd(x, ef, wf, g, meta[2], meta[3], valid, *p["statics"], p["n"],
                                torch.bfloat16)
    got = (_sum_rows(rows, meta[2].long(), p["n"], h, hp, hp + dp), d_ef, d_wf)
    for a, b in zip(got, want):
        _close(a, b, 2e-2)


def _check_plan_positions(rng, p, tail, side):
    """The plan's ``<side>_pos`` puts each valid slot at its place in the
    list by ``side`` (-1 elsewhere, tail slots included), so the scratch
    rows of one row are contiguous: segment sums of the scratch along
    ``<side>_ptr`` equal the sum of the rows by ``side``."""
    x, ef, wf, g, meta, valid = _t(p)
    meta = list(meta)
    meta[0] = torch.cat([meta[0], torch.zeros(tail, dtype=meta[0].dtype)])
    meta[1] = torch.cat([meta[1], torch.full((tail,), p["bn"], dtype=meta[1].dtype)])
    plan = fm.build_slot_plan(tuple(meta), p["n"], p["n"], p["bn"], p["chunk"])
    valid = torch.cat([valid, torch.zeros(tail, dtype=torch.bool)])
    pos, slots = plan[f"{side}_pos"].long(), plan[f"{side}_slots"].long()
    n_valid = int(plan[f"{side}_ptr"][-1])
    assert pos.shape == valid.shape and bool((pos[~valid] == -1).all())
    assert torch.equal(slots[pos[valid]], torch.nonzero(valid)[:, 0])
    assert sorted(pos[valid].tolist()) == list(range(n_valid))
    rows = torch.as_tensor(rng.normal(size=(valid.numel(), 7)).astype(np.float32))
    scratch = torch.zeros(n_valid, 7)
    scratch[pos[valid]] = rows[valid]
    ptr = plan[f"{side}_ptr"].long()
    seg = torch.stack([scratch[ptr[r]:ptr[r + 1]].sum(0) for r in range(p["n"])])
    row = plan[f"slot_{side}"].long()
    want = torch.zeros(p["n"], 7).index_add(0, row[valid], rows[valid])
    _close(seg, want, 1e-6)


@pytest.mark.parametrize("tail", [0, 3 * 16 + 5])
def test_slot_plan_scratch_positions(rng, tail):
    """``src_pos``: the scratch rows of the backward's dx pass and of the
    second order's d2x pass."""
    _check_plan_positions(rng, _problem(rng), tail, "src")


@pytest.mark.parametrize("tail", [0, 3 * 16 + 5])
def test_slot_plan_dst_positions(rng, tail):
    """``dst_pos``: the scratch rows of the second order's d2g pass, summed
    by destination."""
    _check_plan_positions(rng, _problem(rng), tail, "dst")


def test_slot_plan_with_slot_cap_tail(rng):
    """Tail slots past the covered chunk range and padding slots are not
    in either CSR list; every valid slot is in both exactly once."""
    p = _problem(rng)
    tail = 3 * p["chunk"]
    meta = list(_t(p)[4])
    meta[0] = torch.cat([meta[0], torch.zeros(tail, dtype=meta[0].dtype)])
    meta[1] = torch.cat([meta[1], torch.full((tail,), p["bn"], dtype=meta[1].dtype)])
    plan = fm.build_slot_plan(tuple(meta), p["n"], p["n"], p["bn"], p["chunk"])
    valid = np.concatenate([p["valid"], np.zeros(tail, bool)])
    assert np.array_equal(plan["slot_dst"].numpy() >= 0, valid)
    for ptr, slots in (("dst_ptr", "dst_slots"), ("src_ptr", "src_slots")):
        n_in = int(plan[ptr][-1])
        assert sorted(plan[slots][:n_in].tolist()) == np.nonzero(valid)[0].tolist()
    assert np.array_equal(plan["slot_dst"].numpy()[valid], p["dst_g"][p["valid"]])
    assert np.array_equal(plan["slot_src"].numpy()[valid], p["src_g"][p["valid"]])


def test_fused_message_autograd_cpu(rng):
    """FusedMessage on CPU tensors: forward, first- and second-order
    gradients equal the plain op's."""
    p = _problem(rng)
    x, ef, wf, g, meta, valid = _t(p)
    statics = (*p["statics"], p["n"], p["bn"], p["chunk"], p["window"], p["mx"], "float32")

    def run(fn):
        xx, ee, ww = (a.clone().requires_grad_() for a in (x, ef, wf))
        out = fn(xx, ee, ww)
        (gx,) = torch.autograd.grad((out * g).sum(), (xx,), create_graph=True)
        (gw,) = torch.autograd.grad((gx ** 2).sum(), (ww,))
        return out, gx, gw

    got = run(lambda a, b, c: fm.fused_message(a, b, c, meta, valid, *statics))
    want = run(lambda a, b, c: fm.plain_message(a, b, c, meta[2], meta[3], valid,
                                                *p["statics"], p["n"]))
    for a, b in zip(got, want):
        _close(a, b.detach(), 1e-5)


def _cotangents(p, rng, live_only=False):
    """Cotangents (cx, cef, cwf) on (dx, d_ef, d_wf).  ``live_only``: zero
    outside the entries the model's autograd can reach (cef columns >= Kf,
    cwf rows >= Kf and columns >= H), the contract of the CUDA kernel."""
    irreps, nb, sd = p["statics"]
    _, _, _, _, (h, hp, d, dp, sdp, n_y) = fm.structure_matrices(irreps, nb, sd)
    kf = nb + 1 + n_y
    cx = rng.normal(size=p["x"].shape).astype(np.float32)
    cef = rng.normal(size=p["ef"].shape).astype(np.float32)
    cwf = rng.normal(size=p["wf"].shape).astype(np.float32)
    if live_only:
        cef[:, kf:] = 0.0
        cwf[kf:] = 0.0
        cwf[:, h:] = 0.0
    return cx, cef, cwf


@pytest.mark.parametrize("dims", [(IRREPS, NB, SD), (IR2, NB2, SD2)])
def test_plain_message_bwd2_matches_jax(rng, dims):
    """The plain second order (double VJP and closed form) against the JAX
    double VJP of the XLA backward and against ``_mega_bwd2_call`` in
    interpret mode, f32, on general cotangents."""
    p = _problem(rng, *dims)
    cots = _cotangents(p, rng)
    j = lambda k: jnp.asarray(p[k])
    n = p["n"]

    def xla_bwd(x, e, w, gg):
        fwd = lambda xx, ee, ww: xla_reference(xx, ee, ww, j("src_g"), j("dst_g"),
                                               j("valid"), *dims, n)
        return jax.vjp(fwd, x, e, w)[1](gg)

    _, vjp2 = jax.vjp(xla_bwd, j("x"), j("ef"), j("wf"), j("g"))
    want = vjp2(tuple(jnp.asarray(c) for c in cots))
    statics = (*dims, n, p["bn"], p["chunk"], p["window"], p["mx"], "float32")
    with pltpu.force_tpu_interpret_mode():
        kern = _mega_bwd2_call(j("x"), j("ef"), j("wf"), j("g"),
                               *(jnp.asarray(c) for c in cots), j("src2"), j("dst2"),
                               j("cb"), j("nc"), j("ws"), *statics)
    x, ef, wf, g, meta, valid = _t(p)
    tc = [torch.as_tensor(c) for c in cots]
    got = fm.plain_message_bwd2(x, ef, wf, g, *tc, meta[2], meta[3], valid, *dims, n)
    closed = fm.message_bwd2_closed(x, ef, wf, g, *tc, meta[2], meta[3], valid, *dims, n)
    for a, b, w, k in zip(got, closed, want, kern):
        _close(a, w, 1e-5)
        _close(b, w, 1e-5)
        _close(a, k, 1e-5)
        _close(b, a, 1e-5)


def test_bwd2_closed_form_bf16_within_band(rng):
    """bf16: the closed form (the TPU kernel's rounding points) against the
    double VJP of the plain version (XLA's rounding points)."""
    p = _problem(rng)
    x, ef, wf, g, meta, valid = _t(p)
    tc = [torch.as_tensor(c) for c in _cotangents(p, rng, live_only=True)]
    args = (x, ef, wf, g, *tc, meta[2], meta[3], valid, *p["statics"], p["n"],
            torch.bfloat16)
    for a, b in zip(fm.message_bwd2_closed(*args), fm.plain_message_bwd2(*args)):
        _close(a, b, 2e-2)


def _emulate_bwd2(p, x, ef, wf, g, cx, cef, cwf, meta):
    """``message_bwd2.cu``'s algorithm in f32 tensor ops: the per-slot rows
    of ``message_bwd2_rows`` (the index maps in place of the structure
    matrices) summed along the slot plan's CSR lists, d2x by source and
    d2g by destination, in plan order at the plan's scratch positions."""
    irreps, nb, sd = p["statics"]
    _, _, _, _, (h, hp, d, dp, sdp, n_y) = fm.structure_matrices(irreps, nb, sd)
    plan = fm.build_slot_plan(meta, p["n"], x.shape[0], p["bn"], p["chunk"])
    ok = plan["slot_dst"] >= 0
    rows_x, rows_g, _, _, d2ef, d2wf = fm.message_bwd2_rows(
        x, ef, wf, g, cx, cef, cwf, meta[2], meta[3], ok, irreps, nb, sd)
    sums = []
    for side, rows, n_cols, w1, off2 in (("src", rows_x, hp + dp, h, hp),
                                         ("dst", rows_g, sdp + dp, sd, sdp)):
        scratch = torch.zeros(int(plan[f"{side}_ptr"][-1]), rows.shape[1])
        scratch[plan[f"{side}_pos"].long()[ok]] = rows[ok]
        ptr = plan[f"{side}_ptr"].long()
        out = torch.zeros(p["n"], n_cols)
        for r in range(p["n"]):
            seg = scratch[ptr[r]:ptr[r + 1]].sum(0)
            out[r, :w1], out[r, off2:off2 + d] = seg[:w1], seg[w1:]
        sums.append(out)
    return sums[0], d2ef, d2wf, sums[1]


@pytest.mark.parametrize("dims", [(IRREPS, NB, SD), (IR2, NB2, SD2)])
@pytest.mark.parametrize("with_cwf", [False, True])
def test_bwd2_kernel_algorithm_emulation_matches_plain(rng, dims, with_cwf):
    p = _problem(rng, *dims)
    x, ef, wf, g, meta, valid = _t(p)
    cx, cef, cwf = (torch.as_tensor(c) for c in _cotangents(p, rng, live_only=True))
    cwf = cwf if with_cwf else None
    got = _emulate_bwd2(p, x, ef, wf, g, cx, cef, cwf, meta)
    want = fm.plain_message_bwd2(x, ef, wf, g, cx, cef, cwf, meta[2], meta[3], valid,
                                 *dims, p["n"])
    for a, b in zip(got, want):
        _close(a, b, 1e-5)


def test_fused_message_grad_of_grad_cpu(rng):
    """Force-training shape on the CPU: the cotangent g itself depends on
    the inputs, and the second-order grads w.r.t. x_cat, edge_feat, wf_aug
    and g through FusedMessage (FusedMessageBwd on the CPU) equal the
    double backward through plain_message."""
    p = _problem(rng)
    x, ef, wf, g, meta, valid = _t(p)
    statics = (*p["statics"], p["n"], p["bn"], p["chunk"], p["window"], p["mx"], "float32")

    def run(fn):
        xx, ee, ww, gg = (a.clone().requires_grad_() for a in (x, ef, wf, g))
        out = fn(xx, ee, ww)
        first = torch.autograd.grad((out * gg).sum(), (xx, ee), create_graph=True)
        loss = sum((t ** 2).sum() for t in first)
        return torch.autograd.grad(loss, (xx, ee, ww, gg))

    got = run(lambda a, b, c: fm.fused_message(a, b, c, meta, valid, *statics))
    want = run(lambda a, b, c: fm.plain_message(a, b, c, meta[2], meta[3], valid,
                                                *p["statics"], p["n"]))
    for a, b in zip(got, want):
        _close(a, b, 1e-5)


def _rows_sums(p, rows_x, rows_g, meta):
    """(d2x, d2g) from per-slot rows (zero on slots that add nothing): the
    sums by source and by destination."""
    irreps, nb, sd = p["statics"]
    _, _, _, _, (h, hp, d, dp, sdp, n_y) = fm.structure_matrices(irreps, nb, sd)
    return (_sum_rows(rows_x, meta[2].long(), p["n"], h, hp, hp + dp),
            _sum_rows(rows_g, meta[3].long(), p["n"], sd, sdp, sdp + dp))


@pytest.mark.parametrize("dims", [(IRREPS, NB, SD), (IR2, NB2, SD2), KF33])
@pytest.mark.parametrize("with_cwf", [False, True])
def test_message_bwd2_rows_match_jax_bwd2_kernel(rng, dims, with_cwf):
    """The per-slot rows of the second order's bf16 tile pass, in f32:
    their sums by source and by destination are the closed form's d2x and
    d2g, and their d2ef / d2wf are those of ``_bwd2_kernel``
    (``_mega_bwd2_call`` in interpret mode), 1e-5; zero on every slot that
    adds nothing."""
    p = _problem(rng, *dims)
    cots = list(_cotangents(p, rng))
    if not with_cwf:
        cots[2] = np.zeros_like(cots[2])
    j = lambda k: jnp.asarray(p[k])
    statics = (*dims, p["n"], p["bn"], p["chunk"], p["window"], p["mx"], "float32")
    with pltpu.force_tpu_interpret_mode():
        kern = _mega_bwd2_call(j("x"), j("ef"), j("wf"), j("g"),
                               *(jnp.asarray(c) for c in cots), j("src2"), j("dst2"),
                               j("cb"), j("nc"), j("ws"), *statics)
    x, ef, wf, g, meta, valid = _t(p)
    cx, cef, cwf = (torch.as_tensor(c) for c in cots)
    cwf = cwf if with_cwf else None
    _, _, _, _, (h, hp, d, dp, sdp, n_y) = fm.structure_matrices(*dims)
    rows_x, rows_g, dfw2, dfwr, d2ef, d2wf = fm.message_bwd2_rows(
        x, ef, wf, g, cx, cef, cwf, meta[2], meta[3], valid, *dims)
    t = ef.shape[0]
    assert rows_x.shape == (t, h + d) and rows_g.shape == (t, dims[2] + d)
    assert dfw2.shape == dfwr.shape == (t, h) and d2wf.shape == wf.shape
    for a in (rows_x, rows_g, dfw2, dfwr, d2ef):
        assert float(a[~valid].abs().max()) == 0.0
    d2x, d2g = _rows_sums(p, rows_x, rows_g, meta)
    closed = fm.message_bwd2_closed(x, ef, wf, g, cx, cef, cwf, meta[2], meta[3], valid,
                                    *dims, p["n"])
    _close(d2x, closed[0], 1e-5)
    _close(d2g, closed[3], 1e-5)
    for a, k in zip((d2x, d2ef, d2wf, d2g), kern):
        _close(a, k, 1e-5)


def test_message_bwd2_rows_bf16_within_band(rng):
    """bf16: the rows at the TPU kernel's rounding points, summed, against
    the double VJP of the plain version at XLA's, bench.py's 2e-2 band."""
    p = _problem(rng)
    x, ef, wf, g, meta, valid = _t(p)
    cx, cef, _ = (torch.as_tensor(c) for c in _cotangents(p, rng, live_only=True))
    rows_x, rows_g, _, _, d2ef, d2wf = fm.message_bwd2_rows(
        x, ef, wf, g, cx, cef, None, meta[2], meta[3], valid, *p["statics"], torch.bfloat16)
    d2x, d2g = _rows_sums(p, rows_x, rows_g, meta)
    want = fm.plain_message_bwd2(x, ef, wf, g, cx, cef, None, meta[2], meta[3], valid,
                                 *p["statics"], p["n"], torch.bfloat16)
    for a, b in zip((d2x, d2ef, d2wf, d2g), want):
        _close(a, b, 2e-2)


@pytest.mark.parametrize("dims", WIDE, ids=("kf33", "kf128", "h1152"))
@pytest.mark.parametrize("cd,rel", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_plain_message_wide_shapes_match_xla_reference(rng, dims, cd, rel):
    """The widths past the first tile passes' limits: the plain forward,
    backward and second order (no cotangent on d_wf, and a random one)
    against ``xla_reference``, its ``jax.vjp`` and the double VJP, on
    seeded inputs in blocks of 8 nodes."""
    p = _problem(rng, *dims)
    _, _, _, _, (h, hp, d, dp, sdp, n_y) = fm.structure_matrices(*dims)
    assert dims[1] + 1 + n_y in (33, 128) or h == 1152
    want, (wdx, wdef, wdwf) = _jax_ref(p, getattr(jnp, cd))
    x, ef, wf, g, meta, valid = _t(p)
    tcd = getattr(torch, cd)
    _close(fm.plain_message(x, ef, wf, meta[2], meta[3], valid, *dims, p["n"], tcd), want, rel)
    got = fm.plain_message_bwd(x, ef, wf, g, meta[2], meta[3], valid, *dims, p["n"], tcd)
    for a, b in zip(got, (wdx, wdef, wdwf)):
        _close(a, b, rel)
    j = lambda k: jnp.asarray(p[k])

    def xla_bwd(xx, e, w, gg):
        fwd = lambda a, b, c: xla_reference(a, b, c, j("src_g"), j("dst_g"), j("valid"), *dims,
                                            p["n"], compute_dtype=getattr(jnp, cd))
        return jax.vjp(fwd, xx, e, w)[1](gg)

    cx, cef, cwf = _cotangents(p, rng, live_only=True)
    _, vjp2 = jax.vjp(xla_bwd, j("x"), j("ef"), j("wf"), j("g"))
    for c3 in (None, cwf):
        want2 = vjp2((jnp.asarray(cx), jnp.asarray(cef),
                      jnp.zeros_like(j("wf")) if c3 is None else jnp.asarray(c3)))
        got2 = fm.plain_message_bwd2(x, ef, wf, g, torch.as_tensor(cx), torch.as_tensor(cef),
                                     None if c3 is None else torch.as_tensor(c3), meta[2],
                                     meta[3], valid, *dims, p["n"], tcd)
        for a, b in zip(got2, want2):
            _close(a, b, rel)


def test_kernel_routes_by_shape():
    """The wrappers' choice, by shape alone, between a kernel's bf16 tile
    pass and its walk kernels, and the walk kernels' column chunks: tile
    passes at the flagship and at the wide widths (the second order at H =
    1152 in its lean layout), walk kernels for f32, for a cotangent on wf,
    and for the bf16 second order at H = 1152 with 128 edge-feature
    columns; one chunk at the flagship widths, chunks of 128 columns past
    them."""
    flag = ("128x0e+64x1o+32x2e", 20, 128)
    kernels = ("message_fwd", "message_bwd", "message_bwd2")
    for dims in [flag, *WIDE, ("128x0e+64x1o+32x2e", 23, 128),
                 ("128x0e+64x1o+32x2e", 118, 128)]:
        assert all(fm.tile_route(k, "bfloat16", *dims) for k in kernels), dims
        assert not any(fm.tile_route(k, "float32", *dims) for k in kernels), dims
        assert not fm.tile_route("message_bwd2", "bfloat16", *dims, has_cwf=True)
    big = ("256x0e+128x1o+64x2e", 118, 256)
    assert [fm.tile_route(k, "bfloat16", *big) for k in kernels] == [True, True, False]
    assert fm._dwf_regs("message_bwd", 224, 128, 480, 21, 30)  # the flagship's
    assert not fm._dwf_regs("message_bwd2", 448, 256, 960, 24, 33)  # lean, H = 1152
    for kernel in kernels[1:]:
        assert fm.walk_chunks(kernel, 224, 576, 21, 30) == 1
        assert fm.walk_chunks(kernel, 224, 576, 119, 128) == 5
        assert fm.walk_chunks(kernel, 448, 1152, 24, 33) == 9
