"""The port's CUDA kernels (the fused message kernels and the v2 and v1
gather-scale-scatter) against their plain PyTorch versions, on a card,
and the launches of the mega and v2 routes.  Imports neither JAX nor the
JAX package, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Without a card every test skips (decided inside a fixture).  Tolerances:
f32 1e-5 relative to the largest reference magnitude; bf16 2e-2 (the
kernels keep the TPU kernel's rounding points, the plain version XLA's).
"""

import numpy as np
import pytest
import torch

from xequinet_torch import keys
from xequinet_torch.data.batching import collate
from xequinet_torch.data.datapoint import Datapoint
from xequinet_torch.models.model import init_params, resolve_model
from xequinet_torch.ops import fused_message as fm
from xequinet_torch.ops import gather_scatter as gs1
from xequinet_torch.ops import gather_scatter_v2 as gs2
from xequinet_torch.ops.irreps import Irreps
from xequinet_torch.ops.radius_graph import radius_graph_np
from xequinet_torch.models.properties import make_forward
from xequinet_torch.run.inference import InferenceEngine, batch_to_device
from xequinet_torch.training.loss import ErrorMetric, WeightedLoss
from xequinet_torch.training.lr_schedule import resolve_lr_schedule, resolve_optimizer
from xequinet_torch.training.trainer import make_step_core

CASES = [("16x0e+8x1o+4x2e", 8, 16), ("120x0e+24x1o", 8, 16),
         ("128x0e+64x1o+32x2e", 20, 128)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _problem(device, irreps, nb, sd, seed=0, bn=16, chunk=16, slot_tail=2, n_mols=10,
             odd_tail=0):
    """A molecule batch in the slot layout with a slot_cap tail (``odd_tail``
    more slots make the slot count no multiple of 16) and seeded operands."""
    rng = np.random.default_rng(seed)
    dps = []
    for _ in range(n_mols):
        n = int(rng.integers(4, 12))
        pos = rng.normal(size=(n, 3)) * 1.5
        ei, _ = radius_graph_np(pos, 5.0)
        dps.append(Datapoint(rng.integers(1, 9, n), pos, edge_index=ei))
    layout = {"block_nodes": bn, "chunk": chunk, "pad_nodes": 16, "max_chunks": 64}
    n_edges = sum(d.num_edges for d in dps)
    n_blocks = sum(d.num_atoms for d in dps) // bn + 2  # each block pads its run
    layout["slot_cap"] = ((n_edges + chunk - 1) // chunk + n_blocks + 16) * chunk + odd_tail
    batch = collate(dps, kernel_layout=layout)
    _, _, _, _, (h, hp, d, dp, sdp, n_y) = fm.structure_matrices(irreps, nb, sd)
    n, t = batch[keys.POSITIONS].shape[0], batch[keys.EDGE_MASK].shape[0]
    x = rng.normal(size=(n, hp + dp)).astype(np.float32)
    x[:, h:hp] = 0.0
    x[:, hp + d:] = 0.0
    wf = np.zeros((128, hp), dtype=np.float32)
    wf[: nb + 1, :h] = rng.normal(size=(nb + 1, h))
    tt = lambda a: torch.as_tensor(np.array(a), device=device)
    ef = fm.pack_edge_features(tt(rng.normal(size=(t, nb)).astype(np.float32)),
                               tt(rng.uniform(0.1, 1, (t, 1)).astype(np.float32)),
                               tt(rng.normal(size=(t, 3)).astype(np.float32)),
                               Irreps(irreps)).contiguous()
    g = rng.normal(size=(n, sdp + dp)).astype(np.float32)
    b = {k: tt(v) for k, v in batch.items()}
    ei = b[keys.EDGE_INDEX]
    meta = (b[keys.K_SRC2], b[keys.K_DST2], ei[1], ei[0], b[keys.K_CHUNK_BASE],
            b[keys.K_NCHUNKS], b[keys.K_WSTARTS])
    return dict(x=tt(x), ef=ef, wf=tt(wf), g=tt(g), meta=meta, mask=b[keys.EDGE_MASK],
                n=n, bn=bn, chunk=chunk, statics=(irreps, nb, sd))


def _close(got, want, rel):
    scale = max(float(want.float().abs().max()), 1e-6)
    err = float((got.float() - want.float()).abs().max())
    assert err <= rel * scale, (err, scale)


def _counts(**nonzero):
    """The whole launch-count dict with the given entries, others 0."""
    return {name: nonzero.get(name, 0) for name in fm.LAUNCHES}


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mm,rel", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_cuda_message_kernels_match_plain(cuda_device, case, mm, rel):
    p = _problem(cuda_device, *case)
    cd = getattr(torch, mm)
    m = p["meta"]
    out = fm.message_fwd_cuda(p["x"], p["ef"], p["wf"], m, *p["statics"], p["n"],
                              p["bn"], p["chunk"], mm)
    want = fm.plain_message(p["x"], p["ef"], p["wf"], m[2], m[3], p["mask"],
                            *p["statics"], p["n"], cd)
    torch.cuda.synchronize()
    _close(out, want, rel)
    got = fm.message_bwd_cuda(p["x"], p["ef"], p["wf"], p["g"], m, *p["statics"],
                              p["n"], p["bn"], p["chunk"], mm)
    want = fm.plain_message_bwd(p["x"], p["ef"], p["wf"], p["g"], m[2], m[3], p["mask"],
                                *p["statics"], p["n"], cd)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        _close(a, b, rel)
    # the slot_cap tail gets zero d_ef rows
    assert float(got[1][~p["mask"]].abs().max()) == 0.0


@pytest.mark.gpu
def test_cuda_kernels_repeat_bit_for_bit(cuda_device):
    p = _problem(cuda_device, *CASES[0])
    m = p["meta"]
    run = lambda: (fm.message_fwd_cuda(p["x"], p["ef"], p["wf"], m, *p["statics"], p["n"],
                                       p["bn"], p["chunk"], "bfloat16"),)
    run_b = lambda: fm.message_bwd_cuda(p["x"], p["ef"], p["wf"], p["g"], m, *p["statics"],
                                        p["n"], p["bn"], p["chunk"], "bfloat16")
    for fn in (run, run_b):
        a, b = fn(), fn()
        for x, y in zip(a, b):
            assert torch.equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mm,rel", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_cuda_message_bwd_ragged_tiles(cuda_device, case, mm, rel):
    """The backward on a slot count that is no multiple of the bf16 tile
    (16 slots), with padding slots inside the blocks and a slot_cap tail:
    dx, d_ef and d_wf against the plain VJP, zero d_ef rows on every slot
    that adds nothing."""
    p = _problem(cuda_device, *case, odd_tail=5)
    mask = p["mask"]
    assert mask.shape[0] % 16 == 5 and not bool(mask[-5:].any())
    m = p["meta"]
    got = fm.message_bwd_cuda(p["x"], p["ef"], p["wf"], p["g"], m, *p["statics"], p["n"],
                              p["bn"], p["chunk"], mm)
    want = fm.plain_message_bwd(p["x"], p["ef"], p["wf"], p["g"], m[2], m[3], mask,
                                *p["statics"], p["n"], getattr(torch, mm))
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        _close(a, b, rel)
    assert float(got[1][~mask].abs().max()) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("mm,rel", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_cuda_message_bwd_many_tiles_per_block(cuda_device, mm, rel):
    """Flagship widths on a batch of more slot tiles than the card has SMs,
    so each persistent block walks several tiles through both shared-memory
    stages: against the plain VJP, and the same bits on a second call."""
    p = _problem(cuda_device, *CASES[2], n_mols=240)
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert p["mask"].shape[0] > 3 * 16 * n_sm
    m = p["meta"]
    run = lambda: fm.message_bwd_cuda(p["x"], p["ef"], p["wf"], p["g"], m, *p["statics"],
                                      p["n"], p["bn"], p["chunk"], mm)
    got = run()
    want = fm.plain_message_bwd(p["x"], p["ef"], p["wf"], p["g"], m[2], m[3], p["mask"],
                                *p["statics"], p["n"], getattr(torch, mm))
    torch.cuda.synchronize()
    for a, b, c in zip(got, want, run()):
        _close(a, b, rel)
        assert torch.equal(a, c)
    assert float(got[1][~p["mask"]].abs().max()) == 0.0


@pytest.mark.gpu
def test_cuda_engine_refuses_batch_outside_kernel_layout(cuda_device):
    """A mega model on the card serves through the kernels or raises: a
    40-atom molecule exceeds the window of pad_nodes 8, and a batch
    collated without the slot layout does not take the plain route."""
    kw = dict(node_dim=16, node_irreps="16x0e+8x1o+4x2e", embed_basis="one-hot",
              num_basis=8, action_blocks=1, output_modes=["energy"],
              use_pallas_scatter="mega", pallas_layout=(16, 16, 8, 64))
    module, extra, cutoff = resolve_model("xpainn", **kw)
    init_params(module, seed=0)
    eng = InferenceEngine(module=module, model_kwargs=kw, extra=extra, cutoff=cutoff,
                          device=cuda_device)
    rng = np.random.default_rng(0)
    small = Datapoint(rng.integers(1, 9, 6), rng.normal(size=(6, 3)) * 1.5)
    big = Datapoint(rng.integers(1, 9, 40), rng.normal(size=(40, 3)) * 2.0)
    fm.reset_launch_counts()
    eng.predict([small])
    assert fm.LAUNCHES == _counts(message_fwd=1, message_bwd=1)
    with pytest.raises(ValueError, match="slot layout"):
        eng.predict([small, big])
    with pytest.raises(ValueError, match="mega message route"):
        eng.forward_batch(collate([eng.transform(small), eng.transform(big)]))


def _cotangents(p, seed=1, with_cwf=True):
    """(cx, cef, cwf) on (dx, d_ef, d_wf), zero outside the entries the
    model's autograd reaches (the kernel's contract: cef columns >= Kf,
    cwf rows >= Kf and columns >= H)."""
    irreps, nb, sd = p["statics"]
    _, _, _, _, (h, hp, d, dp, sdp, n_y) = fm.structure_matrices(irreps, nb, sd)
    kf = nb + 1 + n_y
    gen = torch.Generator(device="cpu").manual_seed(seed)
    rand = lambda t: torch.randn(t.shape, generator=gen).to(t.device)
    cx, cef = rand(p["x"]), rand(p["ef"])
    cef[:, kf:] = 0.0
    cwf = None
    if with_cwf:
        cwf = torch.zeros_like(p["wf"])
        cwf[:kf, :h] = rand(p["wf"])[:kf, :h]
    return cx, cef, cwf


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mm,rel", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("with_cwf", [False, True])
def test_cuda_bwd2_kernel_matches_plain(cuda_device, case, mm, rel, with_cwf):
    p = _problem(cuda_device, *case)
    m = p["meta"]
    cots = _cotangents(p, with_cwf=with_cwf)
    got = fm.message_bwd2_cuda(p["x"], p["ef"], p["wf"], p["g"], *cots, m, *p["statics"],
                               p["n"], p["bn"], p["chunk"], mm)
    want = fm.plain_message_bwd2(p["x"], p["ef"], p["wf"], p["g"], *cots, m[2], m[3],
                                 p["mask"], *p["statics"], p["n"], getattr(torch, mm))
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        _close(a, b, rel)
    # padding slots and the slot_cap tail get zero d2ef rows
    assert float(got[1][~p["mask"]].abs().max()) == 0.0


@pytest.mark.gpu
def test_cuda_bwd2_kernel_repeats_bit_for_bit(cuda_device):
    p = _problem(cuda_device, *CASES[0])
    cots = _cotangents(p)
    run = lambda: fm.message_bwd2_cuda(p["x"], p["ef"], p["wf"], p["g"], *cots,
                                       p["meta"], *p["statics"], p["n"], p["bn"],
                                       p["chunk"], "bfloat16")
    for x, y in zip(run(), run()):
        assert torch.equal(x, y)


def _empty_rows(p):
    """The rows of the problem's output with no slot (padding node rows)."""
    m = p["meta"]
    ptr = fm.build_slot_plan(m, p["n"], p["n"], p["bn"], p["chunk"])["dst_ptr"]
    empty = ptr[1:] == ptr[:-1]
    assert bool(empty.any())
    return empty


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mm,rel", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_cuda_message_fwd_ragged_tiles(cuda_device, case, mm, rel):
    """The forward on a slot count that is no multiple of the bf16 tile,
    with padding slots, a slot_cap tail and destination rows with no slot
    (zero rows): against the plain version, and the same bits on a second
    call."""
    p = _problem(cuda_device, *case, odd_tail=5)
    assert p["mask"].shape[0] % 16 == 5
    m = p["meta"]
    run = lambda: fm.message_fwd_cuda(p["x"], p["ef"], p["wf"], m, *p["statics"], p["n"],
                                      p["bn"], p["chunk"], mm)
    out = run()
    want = fm.plain_message(p["x"], p["ef"], p["wf"], m[2], m[3], p["mask"], *p["statics"],
                            p["n"], getattr(torch, mm))
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    _close(out, want, rel)
    assert float(out[_empty_rows(p)].abs().max()) == 0.0
    assert torch.equal(out, run())


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mm,rel", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("with_cwf", [False, True])
def test_cuda_message_bwd2_ragged_tiles(cuda_device, case, mm, rel, with_cwf):
    """The second order on a slot count that is no multiple of the bf16
    tile (16 slots), with padding slots inside the blocks, a slot_cap tail
    and destination rows with no slot: d2x, d2ef, d2wf and d2g against the
    plain double VJP, zero d2ef rows on every slot that adds nothing, zero
    d2g rows where no slot ends."""
    p = _problem(cuda_device, *case, odd_tail=5)
    mask = p["mask"]
    assert mask.shape[0] % 16 == 5 and not bool(mask[-5:].any())
    m = p["meta"]
    cots = _cotangents(p, with_cwf=with_cwf)
    got = fm.message_bwd2_cuda(p["x"], p["ef"], p["wf"], p["g"], *cots, m, *p["statics"],
                               p["n"], p["bn"], p["chunk"], mm)
    want = fm.plain_message_bwd2(p["x"], p["ef"], p["wf"], p["g"], *cots, m[2], m[3], mask,
                                 *p["statics"], p["n"], getattr(torch, mm))
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        _close(a, b, rel)
    assert float(got[1][~mask].abs().max()) == 0.0
    assert float(got[3][_empty_rows(p)].abs().max()) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("mm,rel", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_cuda_message_bwd2_many_tiles_per_block(cuda_device, mm, rel):
    """Flagship widths, no cotangent on d_wf (force training), on a batch
    of more slot tiles than the card has SMs, so each persistent block of
    the bf16 tile pass walks several tiles through its stage: against the
    plain double VJP, and the same bits on a second call."""
    p = _problem(cuda_device, *CASES[2], n_mols=240)
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert p["mask"].shape[0] > 3 * 16 * n_sm
    m = p["meta"]
    cots = _cotangents(p, with_cwf=False)
    run = lambda: fm.message_bwd2_cuda(p["x"], p["ef"], p["wf"], p["g"], *cots, m,
                                       *p["statics"], p["n"], p["bn"], p["chunk"], mm)
    got = run()
    want = fm.plain_message_bwd2(p["x"], p["ef"], p["wf"], p["g"], *cots, m[2], m[3],
                                 p["mask"], *p["statics"], p["n"], getattr(torch, mm))
    torch.cuda.synchronize()
    for a, b, c in zip(got, want, run()):
        _close(a, b, rel)
        assert torch.equal(a, c)
    assert float(got[1][~p["mask"]].abs().max()) == 0.0


@pytest.mark.gpu
def test_cuda_grad_of_grad_runs_bwd2_kernel(cuda_device):
    """Force-training shape on the card: grad-of-grad through
    FusedMessage launches forward, backward and second-order kernels once
    each and equals the double backward through the plain op."""
    p = _problem(cuda_device, *CASES[0])
    m = p["meta"]

    def run(fn):
        xx, ee, ww, gg = (a.clone().requires_grad_() for a in (p["x"], p["ef"], p["wf"],
                                                                p["g"]))
        out = fn(xx, ee, ww)
        first = torch.autograd.grad((out * gg).sum(), (xx, ee), create_graph=True)
        return torch.autograd.grad(sum((t ** 2).sum() for t in first), (xx, ee, ww, gg))

    fm.reset_launch_counts()
    got = run(lambda a, b, c: fm.fused_message(a, b, c, m, p["mask"], *p["statics"],
                                               p["n"], p["bn"], p["chunk"], p["bn"] + 32,
                                               64, "float32"))
    torch.cuda.synchronize()
    assert fm.LAUNCHES == _counts(message_fwd=1, message_bwd=1, message_bwd2=1)
    want = run(lambda a, b, c: fm.plain_message(a, b, c, m[2], m[3], p["mask"],
                                                *p["statics"], p["n"]))
    for a, b in zip(got, want):
        _close(a, b, 1e-5)


def _train_step_launches(device, route):
    """Launch counts of one energy + force train step of a 3-block bf16
    model on ``route``, after checking its loss and updated parameters are
    finite."""
    kw = dict(node_dim=16, node_irreps="16x0e+8x1o+4x2e", embed_basis="one-hot",
              num_basis=8, action_blocks=3, output_modes=["energy"],
              compute_dtype="bfloat16", update_compute_dtype="bfloat16",
              use_pallas_scatter=route, pallas_layout=(16, 16, 16, 64))
    module, extra, _ = resolve_model("xpainn", **kw)
    init_params(module, seed=0)
    module = module.to(device)
    rng = np.random.default_rng(0)
    dps = []
    for _ in range(6):
        n = int(rng.integers(4, 10))
        pos = rng.normal(size=(n, 3)) * 1.5
        dps.append(Datapoint(rng.integers(1, 9, n), pos, edge_index=radius_graph_np(pos, 5.0)[0],
                             energy=float(rng.normal()), forces=rng.normal(size=(n, 3))))
    layout = {"block_nodes": 16, "chunk": 16, "pad_nodes": 16, "max_chunks": 64}
    batch = batch_to_device(collate(dps, kernel_layout=layout), device)
    params = list(module.parameters())
    opt = resolve_optimizer("adamw", params)
    step = make_step_core(make_forward(module, extra, create_graph=True),
                          WeightedLoss("l2", energy=1.0, forces=10.0), params, opt,
                          resolve_lr_schedule("cosine_annealing", 5e-4, 100, warmup_steps=10),
                          True, False, 5.0, 0.999, ErrorMetric("energy", "forces"))
    fm.reset_launch_counts()
    loss, _ = step(batch, 0, 1.0, [p.detach().clone() for p in params])
    torch.cuda.synchronize()
    assert torch.isfinite(loss) and all(torch.isfinite(p).all() for p in params)
    return dict(fm.LAUNCHES)


@pytest.mark.gpu
def test_cuda_train_step_launches_all_three_kernels(cuda_device):
    """One energy + force train step of a 3-block mega model on the card:
    each message block launches its forward kernel once, its backward
    twice (for the forces, and in the parameter-gradient pass) and its
    second order once, 3 + 6 + 3 as the JAX package's step
    (test_torch_training.py), and the loss and the updated parameters are
    finite."""
    counts = _train_step_launches(cuda_device, "mega")
    assert counts == _counts(message_fwd=3, message_bwd=6, message_bwd2=3)


# ---------------------------------------------------------------------------
# the v2 and v1 gather-scale-scatter kernels and the v2 route
# ---------------------------------------------------------------------------
def _v2_problem(device, d=480, seed=0):
    """A molecule batch in the v2 slot layout with a slot_cap tail; x and
    w2 random, w2 on every slot (padding and tail slots add nothing)."""
    p = _problem(device, *CASES[0], seed=seed)
    rng = np.random.default_rng(seed + 1)
    t = p["meta"][0].shape[0]
    p["xv"] = torch.as_tensor(rng.normal(size=(p["n"], d)).astype(np.float32), device=device)
    p["w2"] = torch.as_tensor(rng.normal(size=(t, d)).astype(np.float32), device=device)
    m = p["meta"]
    p["v2args"] = (m[0], m[1], m[4], m[5], m[6], p["n"], p["bn"], p["chunk"], p["bn"] + 32, 64)
    return p


@pytest.mark.gpu
@pytest.mark.parametrize("wdt,rel", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_cuda_gather_scatter_v2_matches_plain(cuda_device, wdt, rel):
    p = _v2_problem(cuda_device)
    w2 = p["w2"].to(getattr(torch, wdt))
    a = p["v2args"]
    plan = gs2.v2_slot_plan(*a[:5], p["n"], p["n"], p["bn"], p["chunk"])
    got = gs2.gather_scale_scatter_v2_cuda(p["xv"], w2, plan, p["n"])
    want = gs2.gather_scale_scatter_v2_plain(p["xv"].cpu(), w2.cpu(),
                                             *(t.cpu() for t in a[:5]), *a[5:8])
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    _close(got.cpu(), want, rel)


def _v1_problem(device, w_cols, n=512, e=4096, d=480, bn=64, seed=0, n_out=None,
                gap=None, cut=0):
    """bench_kernels.py's v1 problem at a small size: sorted uniform dst,
    uniform src.  ``n_out`` below n cuts the rows past it (and leaves the
    last block short of block_nodes); ``gap`` = (r0, r1) gives those rows
    no edge; ``cut`` edges at the end of block 1's run fall outside it."""
    rng = np.random.default_rng(seed)
    n_out = n if n_out is None else n_out
    dst = rng.integers(0, n, size=e)
    if gap is not None:
        dst = dst[(dst < gap[0]) | (dst >= gap[1])]
        e = dst.size
    dst = np.sort(dst).astype(np.int32)
    src = rng.integers(0, n, size=e).astype(np.int32)
    starts, counts = gs1.prepare_blocks(dst, n_out, bn, e)
    counts = counts.copy()
    counts[1] -= cut
    tt = lambda a: torch.as_tensor(a, device=device)
    return dict(x=tt(rng.normal(size=(n, d)).astype(np.float32)), src=tt(src), dst=tt(dst),
                w=tt(rng.normal(size=(e, d if w_cols == "D" else 1)).astype(np.float32)),
                starts=tt(starts), counts=tt(counts), n=n_out, bn=bn)


def _v1_args(p):
    return (p["x"], p["src"], p["dst"], p["w"], p["starts"], p["counts"], p["n"], p["bn"])


@pytest.mark.gpu
@pytest.mark.parametrize("w_cols", ["D", "1"])
def test_cuda_gather_scatter_matches_plain(cuda_device, w_cols):
    p = _v1_problem(cuda_device, w_cols)
    args = (p["x"], p["src"], p["dst"], p["w"], p["starts"], p["counts"], p["n"], p["bn"])
    got = gs1.gather_scale_scatter_cuda(*args)
    want = gs1.gather_scale_scatter_plain(*(t.cpu() if torch.is_tensor(t) else t for t in args))
    torch.cuda.synchronize()
    _close(got.cpu(), want, 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 3, 480, 481])
@pytest.mark.parametrize("w_cols", ["D", "1"])
def test_cuda_gather_scatter_column_widths(cuda_device, d, w_cols):
    """The v1 kernel's float4 columns (D % 4 == 0) and scalar columns
    (D = 1, 3, 481) against the plain version, 1e-5, bit for bit on a
    second call, one launch per call."""
    p = _v1_problem(cuda_device, w_cols, d=d)
    fm.reset_launch_counts()
    got = gs1.gather_scale_scatter_cuda(*_v1_args(p))
    assert fm.LAUNCHES == _counts(gather_scatter=1)
    want = gs1.gather_scale_scatter_plain(*(t.cpu() if torch.is_tensor(t) else t
                                            for t in _v1_args(p)))
    torch.cuda.synchronize()
    _close(got.cpu(), want, 1e-5)
    assert torch.equal(got, gs1.gather_scale_scatter_cuda(*_v1_args(p)))


@pytest.mark.gpu
@pytest.mark.parametrize("w_cols", ["D", "1"])
def test_cuda_gather_scatter_block_runs_and_empty_rows(cuda_device, w_cols):
    """Rows with no edge (a band of them), edges left outside their block's
    run, n_out no multiple of block_nodes with the rows past it cut:
    against the plain version, 1e-5."""
    p = _v1_problem(cuda_device, w_cols, n=520, n_out=500, gap=(130, 150), cut=7)
    got = gs1.gather_scale_scatter_cuda(*_v1_args(p))
    want = gs1.gather_scale_scatter_plain(*(t.cpu() if torch.is_tensor(t) else t
                                            for t in _v1_args(p)))
    torch.cuda.synchronize()
    assert got.shape == (500, 480) and float(got[130:150].abs().max()) == 0.0
    _close(got.cpu(), want, 1e-5)


@pytest.mark.gpu
def test_cuda_gather_scatter_kernels_repeat_bit_for_bit(cuda_device):
    p = _v2_problem(cuda_device)
    a = p["v2args"]
    for w2 in (p["w2"], p["w2"].to(torch.bfloat16)):
        run = lambda: gs2.gather_scale_scatter_v2(p["xv"], w2, *a)
        assert torch.equal(run(), run())
    q = _v1_problem(cuda_device, "D")
    run = lambda: gs1.gather_scale_scatter(q["x"], (q["src"], q["dst"]), q["w"],
                                           (q["starts"], q["counts"]), q["n"], q["bn"])
    assert torch.equal(run(), run())


def _engine(device, route):
    kw = dict(node_dim=16, node_irreps="16x0e+8x1o+4x2e", embed_basis="one-hot",
              num_basis=8, action_blocks=3, output_modes=["energy"],
              use_pallas_scatter=route, pallas_layout=(16, 16, 16, 64))
    module, extra, cutoff = resolve_model("xpainn", **kw)
    init_params(module, seed=0)
    return InferenceEngine(module=module, model_kwargs=kw, extra=extra, cutoff=cutoff,
                           device=device)


@pytest.mark.gpu
def test_cuda_v2_route_launches_and_refuses_batch_without_layout(cuda_device):
    """A 3-block v2 model on the card: one v2 kernel launch per block per
    predict (none of the message kernels), the same energies (1e-4) and
    forces (3e-3 of max |F|, chip_smoke.py's element-wise f32 gate: the
    plain route's index_add sums in another order) as the plain route with
    the same weights, and a batch collated without the slot layout is
    refused, not sent down the plain route."""
    eng, plain = _engine(cuda_device, True), _engine(cuda_device, False)
    rng = np.random.default_rng(0)
    dps = [Datapoint(rng.integers(1, 9, n), rng.normal(size=(n, 3)) * 1.5) for n in (6, 9, 7)]
    fm.reset_launch_counts()
    res = eng.predict(dps)
    torch.cuda.synchronize()
    assert fm.LAUNCHES == _counts(gather_scatter_v2=3)
    want = plain.predict(dps)
    energy = lambda rs: torch.tensor([float(r[keys.TOTAL_ENERGY]) for r in rs])
    forces = lambda rs: torch.as_tensor(np.concatenate([r[keys.FORCES] for r in rs]))
    _close(energy(res), energy(want), 1e-4)
    _close(forces(res), forces(want), 3e-3)
    with pytest.raises(ValueError, match="v2 message route"):
        eng.forward_batch(collate([eng.transform(d) for d in dps]))


@pytest.mark.gpu
def test_cuda_v2_train_step_launches(cuda_device):
    """One energy + force train step of a 3-block v2 model: 3 v2 launches
    (its backward is plain ops, as in the JAX package), no message kernel."""
    assert _train_step_launches(cuda_device, True) == _counts(gather_scatter_v2=3)
