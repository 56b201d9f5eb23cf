"""The port's CUDA message kernels against their plain PyTorch versions,
on a card.  Imports neither JAX nor the JAX package, so it also runs
where only PyTorch is installed:

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


def _problem(device, irreps, nb, sd, seed=0, bn=16, chunk=16, slot_tail=2):
    rng = np.random.default_rng(seed)
    dps = []
    for _ in range(10):
        n = int(rng.integers(4, 12))
        pos = rng.normal(size=(n, 3)) * 1.5
        ei, _ = radius_graph_np(pos, 5.0)
        dps.append(Datapoint(rng.integers(1, 9, n), pos, edge_index=ei))
    layout = {"block_nodes": bn, "chunk": chunk, "pad_nodes": 16, "max_chunks": 64}
    n_edges = sum(d.num_edges for d in dps)
    layout["slot_cap"] = ((n_edges + chunk - 1) // chunk) * chunk + 16 * chunk
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
    assert fm.LAUNCHES == {"message_fwd": 1, "message_bwd": 1, "message_bwd2": 0}
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
    assert fm.LAUNCHES == {"message_fwd": 1, "message_bwd": 1, "message_bwd2": 1}
    want = run(lambda a, b, c: fm.plain_message(a, b, c, m[2], m[3], p["mask"],
                                                *p["statics"], p["n"]))
    for a, b in zip(got, want):
        _close(a, b, 1e-5)


@pytest.mark.gpu
def test_cuda_train_step_launches_all_three_kernels(cuda_device):
    """One energy + force train step of a 3-block mega model on the card:
    each message block launches its forward kernel once, its backward
    twice (for the forces, and in the parameter-gradient pass) and its
    second order once, 3 + 6 + 3 as the JAX package's step
    (test_torch_training.py), and the loss and the updated parameters are
    finite."""
    kw = dict(node_dim=16, node_irreps="16x0e+8x1o+4x2e", embed_basis="one-hot",
              num_basis=8, action_blocks=3, output_modes=["energy"],
              compute_dtype="bfloat16", update_compute_dtype="bfloat16",
              use_pallas_scatter="mega", pallas_layout=(16, 16, 16, 64))
    module, extra, _ = resolve_model("xpainn", **kw)
    init_params(module, seed=0)
    module = module.to(cuda_device)
    rng = np.random.default_rng(0)
    dps = []
    for _ in range(6):
        n = int(rng.integers(4, 10))
        pos = rng.normal(size=(n, 3)) * 1.5
        dps.append(Datapoint(rng.integers(1, 9, n), pos, edge_index=radius_graph_np(pos, 5.0)[0],
                             energy=float(rng.normal()), forces=rng.normal(size=(n, 3))))
    layout = {"block_nodes": 16, "chunk": 16, "pad_nodes": 16, "max_chunks": 64}
    batch = batch_to_device(collate(dps, kernel_layout=layout), cuda_device)
    params = list(module.parameters())
    opt = resolve_optimizer("adamw", params)
    step = make_step_core(make_forward(module, extra, create_graph=True),
                          WeightedLoss("l2", energy=1.0, forces=10.0), params, opt,
                          resolve_lr_schedule("cosine_annealing", 5e-4, 100, warmup_steps=10),
                          True, False, 5.0, 0.999, ErrorMetric("energy", "forces"))
    fm.reset_launch_counts()
    loss, _ = step(batch, 0, 1.0, [p.detach().clone() for p in params])
    torch.cuda.synchronize()
    assert fm.LAUNCHES == {"message_fwd": 3, "message_bwd": 6, "message_bwd2": 3}
    assert torch.isfinite(loss) and all(torch.isfinite(p).all() for p in params)
