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
from xequinet_torch.run.inference import InferenceEngine

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
    assert fm.LAUNCHES == {"message_fwd": 1, "message_bwd": 1}
    with pytest.raises(ValueError, match="slot layout"):
        eng.predict([small, big])
    with pytest.raises(ValueError, match="mega message route"):
        eng.forward_batch(collate([eng.transform(small), eng.transform(big)]))


@pytest.mark.gpu
def test_cuda_second_order_raises(cuda_device):
    p = _problem(cuda_device, *CASES[0])
    m = p["meta"]
    x = p["x"].clone().requires_grad_()
    out = fm.fused_message(x, p["ef"], p["wf"], m, p["mask"], *p["statics"], p["n"],
                           p["bn"], p["chunk"], p["bn"] + 32, 64, "float32")
    (gx,) = torch.autograd.grad(out.sum(), (x,))
    assert torch.isfinite(gx).all()
    out = fm.fused_message(x, p["ef"], p["wf"], m, p["mask"], *p["statics"], p["n"],
                           p["bn"], p["chunk"], p["bn"] + 32, 64, "float32")
    with pytest.raises(NotImplementedError):
        torch.autograd.grad(out.sum(), (x,), create_graph=True)
