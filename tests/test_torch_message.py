"""The port's fused message op (xequinet_torch.ops.fused_message) against
the JAX package: the plain forward against ``xla_reference``, the plain
backward against ``jax.vjp`` of it, both against the JAX mega kernels in
interpret mode (including the asymmetric-dims case), and the CUDA
kernels' algorithm (index maps + CSR slot plan) emulated on the CPU.  The
kernels themselves are held against their plain versions on a card by
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
