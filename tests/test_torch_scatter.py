"""The port's gather-scale-scatter ops (xequinet_torch.ops.gather_scatter_v2
and ops.gather_scatter) and the v2 route of XPaiNN against the JAX
package on the CPU: the v2 op against the TPU kernel in interpret mode
(forward in f32 and with a bf16 weight, gradient and grad-of-grad of
``fused_gather_scale_scatter``), the v1 op against its TPU kernel in
interpret mode (forward and gradients, [E, D] and [E, 1] weights), the
index preparation each CUDA kernel walks emulated on the CPU, and the
whole v2-route model (energy, forces, and the parameter gradient of an
energy + force loss).  The kernels themselves are held against their plain
versions on a card by tests/test_torch_gpu.py.

Tolerances: ops in f32 1e-5 relative to the largest reference magnitude
(sums in another order), the v2 grad-of-grad 1e-4 (a gradient of a
gradient through sin), a bf16 weight 2e-2 (bench.py's band: the TPU
kernel rounds x and each product to bf16, the plain version promotes);
whole-model energies and forces 1e-4, and the force loss's parameter
gradient 1e-4 plus twice the port's own change under a one-ulp move of the
positions (tests/test_torch_training.py says why).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.test_pallas_scatter import make_problem
from tests.test_pallas_v2 import molecule_edges
from tests.test_torch_model import _jax_forward, _jax_params, _kw, _molecules, _port
from xequinet_tpu import keys
from xequinet_tpu.models.model import make_apply_forward
from xequinet_tpu.models.model import resolve_model as jax_resolve_model
from xequinet_tpu.ops import pallas_scatter as jv1
from xequinet_tpu.ops import pallas_scatter_v2 as jv2
from xequinet_tpu.training import loss as jloss
from xequinet_torch.convert import load_flax_params, params_from_flax
from xequinet_torch.data.batching import collate, kernel_slot_cap
from xequinet_torch.models.model import resolve_model
from xequinet_torch.models.properties import make_forward
from xequinet_torch.ops import gather_scatter as tv1
from xequinet_torch.ops import gather_scatter_v2 as tv2
from xequinet_torch.run.inference import batch_to_device
from xequinet_torch.training import loss as tloss
from xequinet_torch.training.trainer import loss_and_grads

LAYOUT = {"block_nodes": 8, "chunk": 8, "pad_nodes": 16, "max_chunks": 16}
WEIGHTS = {keys.TOTAL_ENERGY: 1.0, keys.FORCES: 10.0}


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _close(got, want, rel):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, scale)


def _v2_problem(rng, bn, chunk, pad_nodes=16, d=128, n_mols=12, tail=2):
    """A molecule batch in the v2 slot layout plus ``tail`` chunks of
    slot_cap padding; w2 is random on every slot (padding and tail slots
    included: they must add nothing however large their weight)."""
    src, dst, n = molecule_edges(rng, n_mols=n_mols)
    n_pad = max(((n + bn - 1) // bn) * bn, bn + 2 * pad_nodes + 8)
    src2, dst2, sel, cb, nc, ws, window, mx = tv2.prepare_v2(src, dst, n_pad, bn, chunk,
                                                             pad_nodes)
    src2 = np.concatenate([src2, np.zeros(tail * chunk, np.int32)])
    dst2 = np.concatenate([dst2, np.full(tail * chunk, bn, np.int32)])
    total = len(src2)
    return dict(src=src, dst=dst, n=n_pad, src2=src2, dst2=dst2, cb=cb, nc=nc, ws=ws,
                window=window, mx=mx, bn=bn, chunk=chunk, total=total,
                sel=np.concatenate([sel, np.full(tail * chunk, -1)]),
                x=rng.normal(size=(n_pad, d)).astype(np.float32),
                w2=rng.normal(size=(total, d)).astype(np.float32))


def _v2_jax(p, w2):
    j = lambda k: jnp.asarray(p[k])
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jv2.gather_scale_scatter_v2(
            j("x"), w2, j("src2"), j("dst2"), j("cb"), j("nc"), j("ws"), p["n"], p["bn"],
            p["chunk"], p["window"], p["mx"]))


def _v2_args(p):
    t = lambda k: torch.as_tensor(p[k])
    return (t("src2"), t("dst2"), t("cb"), t("nc"), t("ws"), p["n"], p["bn"], p["chunk"],
            p["window"], p["mx"])


@pytest.mark.parametrize("bn,chunk", [(8, 8), (16, 16)])
@pytest.mark.parametrize("wdt,rel", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_v2_forward_matches_jax_kernel(rng, bn, chunk, wdt, rel):
    p = _v2_problem(rng, bn, chunk)
    want = _v2_jax(p, jnp.asarray(p["w2"]).astype(getattr(jnp, wdt)))
    w2 = torch.as_tensor(p["w2"]).to(getattr(torch, wdt))
    got = tv2.gather_scale_scatter_v2(torch.as_tensor(p["x"]), w2, *_v2_args(p))
    assert got.dtype == torch.float32 and got.shape == (p["n"], p["x"].shape[1])
    _close(got, want, rel)
    if wdt == "float32":
        # reference_impl over the raw edges, each with its slot's weight
        sel = p["sel"]
        w_edge = np.zeros((len(p["src"]), p["w2"].shape[1]), np.float32)
        w_edge[sel[sel >= 0]] = p["w2"][sel >= 0]
        t = torch.as_tensor
        _close(got, tv2.reference_impl(t(p["x"]), t(p["src"]), t(p["dst"]), t(w_edge), p["n"]),
               1e-5)


def test_v2_kernel_walk_emulated(rng):
    """The CSR walk of csrc/gather_scatter_v2.cu on the CPU: each output
    row sums x[slot_src[k]] * w2[k] over dst_slots[dst_ptr[row]:
    dst_ptr[row+1]]; padding and tail slots are not in the list."""
    p = _v2_problem(rng, 16, 16)
    want = _v2_jax(p, jnp.asarray(p["w2"]))
    x, w2 = torch.as_tensor(p["x"]), torch.as_tensor(p["w2"])
    a = _v2_args(p)
    plan = tv2.v2_slot_plan(*a[:5], p["n"], p["n"], p["bn"], p["chunk"])
    ptr = plan["dst_ptr"].long()
    assert int(ptr[-1]) == len(p["src"])  # exactly the real slots
    rows = torch.repeat_interleave(torch.arange(p["n"]), ptr[1:] - ptr[:-1])
    k = plan["dst_slots"].long()[: int(ptr[-1])]
    got = torch.zeros_like(x).index_add(0, rows, x[plan["slot_src"].long()[k]] * w2[k])
    _close(got, want, 1e-5)


def test_v2_grad_and_grad_of_grad_match_jax(rng):
    """fused_gather_scale_scatter's gradient (1e-5) and grad-of-grad (the
    force-training pattern, 1e-4) against the JAX wrapper with its kernel
    in interpret mode (test_pallas_v2.py:72-130)."""
    p = _v2_problem(rng, 8, 8, n_mols=6, tail=1)
    sel = p["sel"]
    w2 = np.where((sel >= 0)[:, None], p["w2"], 0.0).astype(np.float32)
    safe = np.clip(sel, 0, None)
    src_g = np.where(sel >= 0, p["src"][safe], 0).astype(np.int32)
    dst_g = np.where(sel >= 0, p["dst"][safe], p["n"] - 1).astype(np.int32)
    jmeta = (jnp.asarray(p["src2"]), jnp.asarray(p["dst2"]), jnp.asarray(dst_g),
             jnp.asarray(p["cb"]), jnp.asarray(p["nc"]), jnp.asarray(p["ws"]))
    statics = (p["n"], p["bn"], p["chunk"], p["window"], p["mx"])

    def f_jax(x, w):
        with pltpu.force_tpu_interpret_mode():
            out = jv2.fused_gather_scale_scatter(x, w, jnp.asarray(src_g), jmeta, *statics)
        return jnp.sum(jnp.sin(out))

    def gg_jax(x, w):
        return jnp.sum(jax.grad(f_jax, argnums=0)(x, w) ** 2)

    xj, wj = jnp.asarray(p["x"]), jnp.asarray(w2)
    want_g = jax.grad(f_jax, argnums=(0, 1))(xj, wj)
    want_gg = jax.grad(gg_jax, argnums=(0, 1))(xj, wj)

    tmeta = tuple(torch.as_tensor(a) for a in (p["src2"], p["dst2"], dst_g, p["cb"], p["nc"],
                                                p["ws"]))
    x = torch.as_tensor(p["x"]).requires_grad_()
    w = torch.as_tensor(w2).requires_grad_()
    out = tv2.fused_gather_scale_scatter(x, w, torch.as_tensor(src_g), tmeta, *statics)
    gx, gw = torch.autograd.grad(torch.sin(out).sum(), (x, w), create_graph=True)
    _close(gx, want_g[0], 1e-5)
    _close(gw, want_g[1], 1e-5)
    ggx, ggw = torch.autograd.grad((gx ** 2).sum(), (x, w))
    _close(ggx, want_gg[0], 1e-4)
    _close(ggw, want_gg[1], 1e-4)


@pytest.mark.parametrize("w_full", [True, False])
def test_v1_forward_and_grads_match_jax_kernel(rng, w_full):
    x, src, dst, w = make_problem(rng, n=64, e=256, d=128)
    if not w_full:
        w = w[:, :1].copy()
    n, bn = x.shape[0], 8
    starts, counts = tv1.prepare_blocks(dst, n, bn, 256)
    js, jc = jv1.prepare_blocks(dst, n, bn, 256)
    np.testing.assert_array_equal(starts, js)
    np.testing.assert_array_equal(counts, jc)
    jidx = (jnp.asarray(src), jnp.asarray(dst))
    jmeta = (jnp.asarray(starts), jnp.asarray(counts))

    def f_jax(xx, ww):
        with pltpu.force_tpu_interpret_mode():
            return jv1.gather_scale_scatter(xx, jidx, ww, jmeta, n, bn)

    xj, wj = jnp.asarray(x), jnp.asarray(w)
    want = f_jax(xj, wj)
    want_g = jax.grad(lambda a, b: jnp.sum(f_jax(a, b) ** 2), argnums=(0, 1))(xj, wj)
    xt = torch.as_tensor(x).requires_grad_()
    wt = torch.as_tensor(w).requires_grad_()
    tidx = (torch.as_tensor(src), torch.as_tensor(dst))
    tmeta = (torch.as_tensor(starts), torch.as_tensor(counts))
    out = tv1.gather_scale_scatter(xt, tidx, wt, tmeta, n, bn)
    _close(out, want, 1e-5)
    gx, gw = torch.autograd.grad((out ** 2).sum(), (xt, wt))
    assert gw.shape == wt.shape
    _close(gx, want_g[0], 1e-5)
    _close(gw, want_g[1], 1e-5)
    # the edge ranges csrc/gather_scatter.cu walks, emulated on the CPU
    lo, hi = tv1.row_edge_ranges(tidx[1], *tmeta, n, bn)
    rows = torch.repeat_interleave(torch.arange(n), (hi - lo).long())
    e = torch.cat([torch.arange(int(a), int(b)) for a, b in zip(lo, hi)])
    assert torch.equal(tidx[1].long()[e], rows)
    emu = torch.zeros(n, x.shape[1]).index_add(
        0, rows, torch.as_tensor(x)[tidx[0].long()[e]] * torch.as_tensor(w)[e])
    _close(emu, want, 1e-5)


def test_v1_block_runs_bound_the_edges(rng):
    """An edge adds only inside its destination block's run, and rows past
    n_out are cut, as the TPU kernel's grid does: with a run cut short the
    plain version and the kernel's edge ranges both drop the edges left
    out."""
    x, src, dst, w = make_problem(rng, n=32, e=128, d=16)
    starts, counts = tv1.prepare_blocks(dst, 32, 8, 128)
    counts = counts.copy()
    counts[1] -= 3  # block 1's last three edges fall outside its run
    t = torch.as_tensor
    got = tv1.gather_scale_scatter_plain(t(x), t(src), t(dst), t(w), t(starts), t(counts),
                                         30, 8)
    keep = np.ones(len(dst), bool)
    keep[starts[1] + counts[1]: starts[1] + counts[1] + 3] = False
    keep &= dst < 30
    want = np.zeros((30, 16), np.float32)
    np.add.at(want, dst[keep], x[src[keep]] * w[keep])
    _close(got, want, 1e-5)
    lo, hi = tv1.row_edge_ranges(t(dst), t(starts), t(counts), 30, 8)
    assert int((hi - lo).sum()) == int(keep.sum())


def _warp_lower_bound(dst, lo, hi, r):
    """One search of ``xeq_row_range`` (csrc/gather_scatter.cu): the first
    index in [lo, hi) with dst >= r (hi if none), 32 probes per round."""
    while hi - lo > 32:
        step = (hi - lo + 31) // 32
        probes = lo + (np.arange(32) + 1) * step - 1
        k = int(((probes < hi) & (dst[np.minimum(probes, len(dst) - 1)] < r)).sum())
        lo = min(lo + k * step, hi)
        hi = min(lo + step, hi)
    idx = lo + np.arange(32)
    return lo + int(((idx < hi) & (dst[np.minimum(idx, len(dst) - 1)] < r)).sum())


@pytest.mark.parametrize("n,n_out,bn,e,cut", [(32, 30, 8, 128, 3), (700, 650, 64, 9000, 40),
                                              (300, 300, 256, 4000, 0)])
def test_v1_kernel_search_gives_row_edge_ranges(rng, n, n_out, bn, e, cut):
    """The v1 kernel's per-row search of the sorted dst inside the block's
    run finds the edges ``row_edge_ranges`` states, with a run cut short,
    rows past n_out, a band of rows with no edge and runs of thousands of
    edges (several probe rounds)."""
    dst = rng.integers(0, n, size=e)
    dst = np.sort(dst[(dst < n // 3) | (dst >= n // 3 + 5)]).astype(np.int32)
    starts, counts = tv1.prepare_blocks(dst, n_out, bn, len(dst))
    counts = counts.copy()
    counts[min(1, len(counts) - 1)] -= cut
    t = torch.as_tensor
    lo, hi = (a.numpy() for a in tv1.row_edge_ranges(t(dst), t(starts), t(counts), n_out, bn))
    for r in range(n_out):
        b = min(r // bn, len(starts) - 1)
        s, end = int(starts[b]), int(starts[b] + counts[b])
        k_lo = _warp_lower_bound(dst, s, end, r)
        k_hi = _warp_lower_bound(dst, s, end, r + 1)
        assert k_hi - k_lo == hi[r] - lo[r]
        if k_hi > k_lo:
            assert (k_lo, k_hi) == (lo[r], hi[r])


def test_prepare_blocks_overflow():
    dst = np.zeros(100, dtype=np.int32)  # all edges into node 0
    with pytest.raises(ValueError, match="edge capacity"):
        tv1.prepare_blocks(dst, 16, 4, 50)


# ---------------------------------------------------------------------------
# the v2 route of XPaiNN
# ---------------------------------------------------------------------------
def _v2_batch(dps, with_tail=True):
    layout = dict(LAYOUT)
    if with_tail:  # a slot_cap tail after the last block's chunk range
        n_e = sum(d.num_edges for d in dps)
        layout["slot_cap"] = kernel_slot_cap(64, n_e, layout)
    return collate(dps, kernel_layout=layout)


def test_model_v2_route_matches_jax(rng):
    """Energy and forces of the v2 route (the port's plain op on the CPU)
    against the JAX v2 route with its kernel in interpret mode, 1e-4; the
    batch's blocks end in padding slots and it has a slot_cap tail."""
    batch = _v2_batch(_molecules(rng))
    assert not batch[keys.EDGE_MASK].all()
    assert int(batch[keys.K_CHUNK_BASE][-1] + batch[keys.K_NCHUNKS][-1]) * LAYOUT["chunk"] \
        < batch[keys.EDGE_MASK].shape[0]
    kw = _kw(True)
    params = _jax_params(_kw(False), batch)
    want = _jax_forward(kw, params, batch, interpret=True)
    got = _port(kw, params)(batch_to_device(batch, "cpu"), True, False)
    n_g = int(batch[keys.GRAPH_MASK].sum())
    _close(got[keys.TOTAL_ENERGY][:n_g], want[keys.TOTAL_ENERGY][:n_g], 1e-4)
    _close(got[keys.FORCES], want[keys.FORCES], 1e-4)


def test_model_v2_route_force_loss_gradient_matches_jax(rng):
    """The parameter gradient of an energy + force loss on the v2 route
    (FusedGatherScaleScatter's backward differentiated a second time)
    against jax.grad of the JAX v2 route, per parameter within 1e-4 of its
    largest element plus twice the port's own change under a one-ulp move
    of the positions."""
    from xequinet_torch.data.datapoint import Datapoint

    dps = []
    for d in _molecules(rng):
        dps.append(Datapoint(d.atomic_numbers, d.pos, edge_index=d.edge_index,
                             energy=float(rng.normal()), forces=rng.normal(size=(d.num_atoms, 3))))
    batch = _v2_batch(dps)
    kw = _kw(True)
    params = _jax_params(_kw(False), batch)
    m, extra, _ = jax_resolve_model("xpainn", **kw)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    lossfn = jloss.WeightedLoss("l2", **WEIGHTS)

    def loss_of(p):
        return lossfn(make_apply_forward(m, extra)(p, jb, True, False), jb)[0]

    with pltpu.force_tpu_interpret_mode():
        jloss_val, jgrads = jax.jit(jax.value_and_grad(loss_of))(params)

    module, textra, _ = resolve_model("xpainn", **kw)
    load_flax_params(module, jax.tree_util.tree_map(np.asarray, params))
    named = list(module.named_parameters())
    tb = batch_to_device(batch, "cpu")

    def grads(scale):
        b = dict(tb)
        b[keys.POSITIONS] = b[keys.POSITIONS] * scale
        loss, _, _, g = loss_and_grads(make_forward(module, textra, create_graph=True),
                                       tloss.WeightedLoss("l2", **WEIGHTS),
                                       [q for _, q in named], b, True, False)
        return float(loss.detach()), {n: gi for (n, _), gi in zip(named, g)}

    loss, got = grads(1.0)
    _, nudged = grads(1.0 + 1e-7)
    assert abs(loss - float(jloss_val)) <= 1e-5 * abs(float(jloss_val))
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, jgrads), module)
    for name, g in got.items():
        scale = max(float(g.abs().max()), 1e-30)
        limit = 1e-4 + 2 * float((nudged[name] - g).abs().max()) / scale
        assert float((g - want[name]).abs().max()) <= limit * scale, name


def test_engine_serves_v2_model_on_its_layout(rng):
    """InferenceEngine collates for a v2 model with the slot layout (the
    JAX engine would not) and, on the CPU, agrees with the plain route on
    the same weights within 1e-4; a batch without the layout runs the
    plain route there."""
    from xequinet_torch.models.model import init_params
    from xequinet_torch.run.inference import InferenceEngine

    dps = _molecules(rng)
    engines = []
    for route in (True, False):
        kw = _kw(route)
        module, extra, cutoff = resolve_model("xpainn", **kw)
        init_params(module, seed=1)
        engines.append(InferenceEngine(module=module, model_kwargs=kw, extra=extra,
                                       cutoff=cutoff, device="cpu"))
    v2, plain = engines
    batch = v2.collate([v2.transform(d) for d in dps])
    assert keys.K_SRC2 in batch
    got, want = v2.predict(dps), plain.predict(dps)
    for a, b in zip(got, want):
        _close(a[keys.TOTAL_ENERGY], b[keys.TOTAL_ENERGY], 1e-4)
        _close(a[keys.FORCES], b[keys.FORCES], 1e-4)
    out = v2.forward_batch(collate([v2.transform(d) for d in dps]))
    _close(out[keys.FORCES][: sum(d.num_atoms for d in dps)],
           np.concatenate([r[keys.FORCES] for r in want]), 1e-4)
