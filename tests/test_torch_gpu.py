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
from xequinet_torch.data.batching import (_apply_kernel_layout, bucket_capacity, collate,
                                          kernel_slot_cap)
from xequinet_torch.data.datapoint import Datapoint
from xequinet_torch.models.model import init_params, resolve_model
from xequinet_torch.ops import fused_message as fm
from xequinet_torch.ops import gather_scatter as gs1
from xequinet_torch.ops import gather_scatter_v2 as gs2
from xequinet_torch.ops.irreps import Irreps
from xequinet_torch.ops.radius_graph import radius_graph_np, radius_graph_pbc_np
from xequinet_torch.ops.spatial_sort import ghost_layout_pbc
from xequinet_torch.models.properties import make_forward
from xequinet_torch.run.inference import InferenceEngine, batch_to_device
from xequinet_torch.training.loss import ErrorMetric, WeightedLoss
from xequinet_torch.training.lr_schedule import resolve_lr_schedule, resolve_optimizer
from xequinet_torch.training.trainer import make_step_core

# the first three take message_bwd's Hopper tile pass in bf16 (the third is
# FLAGSHIP_KW's widths); the last two its mma.sync tile pass, with d_wf in
# registers: H = 640 (node_dim 192, past the Hopper pass's 576) and a run of
# irreps of odd multiplicity (15x0e)
CASES = [("16x0e+8x1o+4x2e", 8, 16), ("120x0e+24x1o", 8, 16),
         ("128x0e+64x1o+32x2e", 20, 128), ("128x0e+64x1o+32x2e", 20, 192),
         ("15x0e+8x1o+4x2e", 8, 16)]
MMA_SYNC_CASES = CASES[3:]
# the widths past the first tile passes' limits: Kf = 33 (num_basis 23), Kf =
# 128 (num_basis 118, the JAX kernels' maximum) and H = 1152 (node_dim 256)
WIDE = [("128x0e+64x1o+32x2e", 23, 128), ("128x0e+64x1o+32x2e", 118, 128),
        ("256x0e+128x1o+64x2e", 23, 256)]
WIDE_IDS = ("kf33", "kf128", "h1152")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _problem(device, irreps, nb, sd, seed=0, bn=16, chunk=16, slot_tail=2, n_mols=10,
             odd_tail=0, dense=0):
    """A molecule batch in the slot layout with a slot_cap tail (``odd_tail``
    more slots make the slot count no multiple of 16) and seeded operands;
    ``dense`` > 0 adds a molecule of that many atoms all within the cutoff
    of each other (rows of dense - 1 slots)."""
    rng = np.random.default_rng(seed)
    dps = []
    for _ in range(n_mols):
        n = int(rng.integers(4, 12))
        pos = rng.normal(size=(n, 3)) * 1.5
        ei, _ = radius_graph_np(pos, 5.0)
        dps.append(Datapoint(rng.integers(1, 9, n), pos, edge_index=ei))
    if dense:
        pos = rng.uniform(-1.0, 1.0, size=(dense, 3))
        dps.append(Datapoint(rng.integers(1, 9, dense), pos,
                             edge_index=radius_graph_np(pos, 5.0)[0]))
    layout = {"block_nodes": bn, "chunk": chunk, "pad_nodes": max(16, dense),
              "max_chunks": 0}
    n_edges = sum(d.num_edges for d in dps)
    n_blocks = sum(d.num_atoms for d in dps) // bn + 2  # each block pads its run
    layout["slot_cap"] = ((n_edges + chunk - 1) // chunk + n_blocks + 16) * chunk + odd_tail
    batch = collate(dps, kernel_layout=layout)
    return _operands(device, batch, irreps, nb, sd, rng, bn, chunk)


def _operands(device, batch, irreps, nb, sd, rng, bn, chunk):
    """Seeded operands of one message op on a batch in the slot layout."""
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
@pytest.mark.parametrize("case", MMA_SYNC_CASES, ids=("h640", "odd_run"))
def test_cuda_mma_sync_bwd_many_tiles_per_block(cuda_device, case):
    """The widths that the Hopper tile pass refuses keep the mma.sync tile
    pass (d_wf in registers): on a batch of more slot tiles than the card
    has SMs, with a ragged last tile, against the plain VJP in bf16, and
    the same bits on a second call."""
    assert not fm.hopper_route("bfloat16", *case)
    assert fm.tile_route("message_bwd", "bfloat16", *case)
    ni, h, hp, d, dp, sdp, kw, kf = fm._launch_dims(*case)
    assert fm._dwf_regs("message_bwd", ni, case[2], d, kw, kf)
    p = _problem(cuda_device, *case, n_mols=240, odd_tail=5)
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert p["mask"].shape[0] > 3 * 16 * n_sm
    m = p["meta"]
    run = lambda: fm.message_bwd_cuda(p["x"], p["ef"], p["wf"], p["g"], m, *p["statics"],
                                      p["n"], p["bn"], p["chunk"], "bfloat16")
    got = run()
    want = fm.plain_message_bwd(p["x"], p["ef"], p["wf"], p["g"], m[2], m[3], p["mask"],
                                *p["statics"], p["n"], torch.bfloat16)
    torch.cuda.synchronize()
    for a, b, c in zip(got, want, run()):
        _close(a, b, 2e-2)
        assert torch.equal(a, c)
    assert float(got[1][~p["mask"]].abs().max()) == 0.0


def _ghost_problem(device, bn, seed=0, n=3000):
    """bench.py's periodic MD box at 3000 atoms (x spacing 0.15 A, a
    16 x 16 A cross-section, all axes periodic) in the MD host build's
    layout: ghost rows from ``ghost_layout_pbc``, chunk 1024,
    ``block_nodes`` ``bn``, pad_nodes the sorted reach x 1.25, slot_cap
    from ``kernel_slot_cap``; flagship widths."""
    rng = np.random.default_rng(seed)
    lx = n * 0.15
    cell = np.diag([lx, 16.0, 16.0])
    pos = np.column_stack([(np.arange(n) * 0.15 + rng.normal(size=n) * 0.5) % lx,
                           rng.uniform(0, 16.0, size=(n, 2))])
    pbc = np.array([True] * 3)
    ei, offs = radius_graph_pbc_np(pos, cell, pbc, 5.0)
    plan = ghost_layout_pbc(pos, cell, pbc, ei, offs)
    n_ext = n + plan["n_ghosts"]
    node_cap = bucket_capacity(n_ext)
    ne = ei.shape[1]
    e_cap = (ne + 1023) // 1024 * 1024 + 1024
    order = np.argsort(plan["dst_ext"], kind="stable")
    edge_index = np.full((2, e_cap), node_cap - 1, dtype=np.int32)
    edge_index[0, :ne] = plan["dst_ext"][order]
    edge_index[1, :ne] = plan["src_ext"][order]
    real = np.arange(node_cap) < n_ext
    real[:n_ext] = ~plan["is_ghost"]
    batch = {
        keys.ATOMIC_NUMBERS: np.ones(node_cap, dtype=np.int32),
        keys.POSITIONS: np.zeros((node_cap, 3), dtype=np.float32),
        keys.BATCH: np.where(real, 0, 1).astype(np.int32), keys.NODE_MASK: real,
        keys.GRAPH_MASK: np.array([True, False]), keys.EDGE_INDEX: edge_index,
        keys.EDGE_MASK: np.arange(e_cap) < ne,
    }
    pad = ((int(plan["reach"] * 1.25) + 15) // 8) * 8
    layout = {"block_nodes": bn, "chunk": 1024, "pad_nodes": pad, "max_chunks": 0}
    layout["slot_cap"] = kernel_slot_cap(node_cap, e_cap, layout)
    batch = _apply_kernel_layout(batch, layout)
    return _operands(device, batch, "128x0e+64x1o+32x2e", 20, 128, rng, bn, 1024), plan


@pytest.mark.gpu
@pytest.mark.parametrize("bn", [256, 512])
@pytest.mark.parametrize("mm,rel", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_cuda_message_kernels_periodic_ghost_layout(cuda_device, bn, mm, rel):
    """The forward and first-order backward kernels on the MD hot loop's
    layout: a periodic ghost layout, chunk 1024, 256- and 512-row blocks,
    a window far wider than the training batches' (pad_nodes from the
    sorted reach), against their plain versions; zero d_ef on every slot
    that adds nothing, the slot_cap tail past the covered chunks included."""
    p, plan = _ghost_problem(cuda_device, bn)
    assert plan["n_ghosts"] > 0 and p["chunk"] == 1024 and p["bn"] == bn
    cd = getattr(torch, mm)
    m = p["meta"]
    out = fm.message_fwd_cuda(p["x"], p["ef"], p["wf"], m, *p["statics"], p["n"], bn, 1024, mm)
    want = fm.plain_message(p["x"], p["ef"], p["wf"], m[2], m[3], p["mask"], *p["statics"],
                            p["n"], cd)
    torch.cuda.synchronize()
    _close(out, want, rel)
    got = fm.message_bwd_cuda(p["x"], p["ef"], p["wf"], p["g"], m, *p["statics"], p["n"], bn,
                              1024, mm)
    want = fm.plain_message_bwd(p["x"], p["ef"], p["wf"], p["g"], m[2], m[3], p["mask"],
                                *p["statics"], p["n"], cd)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        _close(a, b, rel)
    covered = 1024 * int(m[4][-1] + m[5][-1])
    assert covered < p["mask"].shape[0] and float(got[1][~p["mask"]].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# message_bwd's Hopper tile pass (csrc/message_bwd_hopper.cuh): the ring of
# stages, the tails of a walk, the halo layout and the bf16x2 products
# ---------------------------------------------------------------------------
def _bwd_close(p, rel=2e-2, mask=None):
    """The bf16 backward against the plain VJP (2e-2 of the largest
    reference magnitude), zero d_ef rows on every slot that adds nothing,
    and the same bits on a second call; returns the outputs."""
    m, mask = p["meta"], p["mask"] if mask is None else mask
    run = lambda: fm.message_bwd_cuda(p["x"], p["ef"], p["wf"], p["g"], m, *p["statics"],
                                      p["n"], p["bn"], p["chunk"], "bfloat16")
    got = run()
    want = fm.plain_message_bwd(p["x"], p["ef"], p["wf"], p["g"], m[2], m[3], mask,
                                *p["statics"], p["n"], torch.bfloat16)
    torch.cuda.synchronize()
    for a, b, c in zip(got, want, run()):
        assert torch.isfinite(a).all()
        _close(a, b, rel)
        assert torch.equal(a, c)
    if (~mask).any():
        assert float(got[1][~mask].abs().max()) == 0.0
    return got


@pytest.mark.gpu
def test_cuda_hopper_bwd_ring_wraps_and_tails(cuda_device):
    """Flagship widths (the Hopper tile pass) on a batch of more tiles per
    block than ring stages, a slot count that is no multiple of 16 (a last
    tile partly full), whole tiles of padding in the slot_cap tail and
    slots past the covered chunk range: against the plain VJP, zero d_ef
    rows on the slots that add nothing, the same bits on a second call."""
    assert fm.hopper_route("bfloat16", *CASES[2])
    p = _problem(cuda_device, *CASES[2], n_mols=240, odd_tail=5)
    n_slots = p["mask"].shape[0]
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    ni, h, hp, d, dp, sdp, kw, kf = fm._launch_dims(*CASES[2])
    nst = fm._hopper_layout(ni, CASES[2][2], d, kw, kf)[1]
    assert n_slots % 16 == 5 and n_slots // 16 > 2 * nst * n_sm
    m = p["meta"]
    covered = p["chunk"] * int(m[4][-1] + m[5][-1])
    assert covered + 16 < n_slots  # whole tiles past the covered range
    _bwd_close(p)


@pytest.mark.gpu
def test_cuda_hopper_bwd_zero_slots(cuda_device):
    """A call with no slot: dx and d_wf zero, d_ef empty."""
    p = _problem(cuda_device, *CASES[0])
    z = torch.zeros(0, dtype=torch.int32, device=cuda_device)
    n = p["n"]
    plan = {"slot_src": z, "slot_dst": z, "dst_ptr": torch.zeros(n + 1, dtype=torch.int32,
                                                                   device=cuda_device),
            "dst_slots": z, "dst_pos": z, "src_ptr": torch.zeros(n + 1, dtype=torch.int32,
                                                                 device=cuda_device),
            "src_slots": z, "src_pos": z}
    meta = tuple(p["meta"][:7]) + (plan,)
    dx, d_ef, d_wf = fm.message_bwd_cuda(p["x"], p["ef"][:0].contiguous(), p["wf"], p["g"],
                                         meta, *p["statics"], n, p["bn"], p["chunk"],
                                         "bfloat16")
    torch.cuda.synchronize()
    assert d_ef.shape == (0, fm.F_PACK)
    assert float(dx.abs().max()) == 0.0 and float(d_wf.abs().max()) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("bn", [256, 512])
def test_cuda_hopper_bwd_halo_shard_layout(cuda_device, bn):
    """Shard 0 of 4 of a periodic box in HaloCalculator's layout (its
    partition, a window of local and halo rows, chunk 1024), flagship
    widths: the Hopper tile pass against the plain VJP."""
    from xequinet_torch.parallel import halo as hm

    rng = np.random.default_rng(3)
    n = 3000
    lx = n * 0.15
    cell = np.diag([lx, 16.0, 16.0])
    pos = np.column_stack([(np.arange(n) * 0.15 + rng.normal(size=n) * 0.5) % lx,
                           rng.uniform(0, 16.0, size=(n, 2))])
    z = rng.integers(1, 9, size=n).astype(np.int32)
    stacked, geom, _, _, _, _ = hm.prepare_halo_system(z, pos, 5.0, 4, cell=cell,
                                                       pbc=np.array([True] * 3))
    bn = min(bn, geom["n_local"])
    stacked, _, _ = hm.apply_halo_kernel_layout(stacked, geom,
                                                {"block_nodes": bn, "chunk": 1024},
                                                margin=1.3)
    shard = {k: v[0] for k, v in stacked.items()}
    shard[keys.POSITIONS] = np.zeros((geom["window"], 3), np.float32)
    p = _operands(cuda_device, shard, "128x0e+64x1o+32x2e", 20, 128, rng, bn, 1024)
    assert geom["halo"] > 0 and fm.hopper_route("bfloat16", *p["statics"])
    _bwd_close(p)


def _pair_problem(device, scale, seed=5):
    """Two-atom molecules (each node the source of one slot, so dx holds each
    slot's scratch row as it is) at irreps 2x0e+2x1o, whose fw = ef @ wf is
    exact in any order (small integers): fo = rnd(gs * fw) is then the same
    bits in the kernel and in the plain version, and so must dgv = rnd(fo *
    gms_v) be.  gms_v is zero on lane 1 and on the second l = 1 irrep, so
    that each harmonic d_ef column is one lane's drsh.  ``scale`` multiplies
    gs and gms_v (2^-6 and 2^-124 put the products below f32's normal
    range)."""
    rng = np.random.default_rng(seed)
    dps = []
    for _ in range(40):
        pos = np.array([[0.0, 0.0, 0.0], [1.0 + rng.uniform(), 0.0, 0.0]])
        dps.append(Datapoint(rng.integers(1, 9, 2), pos, edge_index=radius_graph_np(pos, 5.0)[0]))
    layout = {"block_nodes": 16, "chunk": 16, "pad_nodes": 16, "max_chunks": 0}
    batch = collate(dps, kernel_layout=layout)
    irreps, nb, nd = "2x0e+2x1o", 4, 8
    p = _operands(device, batch, irreps, nb, nd, rng, 16, 16)
    _, _, _, _, (h, hp, d, dp, sdp, n_y) = fm.structure_matrices(irreps, nb, nd)
    kw, t = nb + 1, p["ef"].shape[0]
    bf = lambda a: torch.as_tensor(a, dtype=torch.float32).to(torch.bfloat16).float()
    ef = np.zeros((t, fm.F_PACK), np.float32)
    ef[:, :kw] = rng.integers(-2, 3, size=(t, kw))
    ef[:, kw:kw + n_y] = rng.normal(size=(t, n_y))
    wf = np.zeros((fm.F_PACK, hp), np.float32)
    wf[:kw, :h] = rng.integers(-2, 3, size=(kw, h))
    x = p["x"].cpu().numpy() * np.where(np.arange(hp + dp) < hp, scale[0], 1.0)
    g = p["g"].cpu().numpy()
    g[:, sdp:] *= scale[1]
    g[:, sdp + 1] = 0.0
    g[:, sdp + 5:sdp + 8] = 0.0
    to = lambda a: bf(a).to(device)
    return dict(p, x=to(x), ef=to(ef), wf=to(wf), g=to(g)), (h, hp, d, kw, kw + n_y)


@pytest.mark.gpu
@pytest.mark.parametrize("scale", [(1.0, 1.0), (2.0 ** -6, 2.0 ** -124)],
                         ids=("normal", "below_f32_normal"))
def test_cuda_hopper_bwd_bf16x2_products_bit_for_bit(cuda_device, scale):
    """The Hopper pass rounds dgv = fo * gms_v and drsh = fo' * gms_v as
    __hmul2 on bf16x2 pairs, the plain version (and the TPU kernel) as an
    f32 product rounded to bf16: the same values on every valid slot, with
    ordinary products and with products below f32's normal range."""
    p, (h, hp, d, kw, kf) = _pair_problem(cuda_device, scale)
    assert fm.hopper_route("bfloat16", *p["statics"])
    m, mask = p["meta"], p["mask"]
    dx, d_ef, _ = fm.message_bwd_cuda(p["x"], p["ef"], p["wf"], p["g"], m, *p["statics"],
                                      p["n"], p["bn"], p["chunk"], "bfloat16")
    rows, _, d_ef_ref, _ = fm.message_bwd_rows(p["x"], p["ef"], p["wf"], p["g"], m[2], m[3],
                                               mask, *p["statics"], torch.bfloat16)
    torch.cuda.synchronize()
    src = m[2].long()[mask]
    assert torch.equal(dx[src][:, hp:hp + d], rows[mask][:, h:])  # dgv
    assert torch.equal(d_ef[mask][:, kw:kf], d_ef_ref[mask][:, kw:kf])  # drsh
    if scale[1] < 1.0:
        small = rows[mask][:, h:].abs()
        assert bool(((small > 0) & (small < 2.0 ** -126)).any())


@pytest.mark.gpu
def test_cuda_engine_refuses_batch_outside_kernel_layout(cuda_device):
    """A mega model on the card serves a batch that holds a molecule larger
    than its window (40 atoms, pad_nodes 8) through the kernels, the engine
    fitting the slot layout to the batch: one forward and one backward
    launch per predict, and the plain route's energies (1e-4) and forces
    (3e-3 of max |F|, chip_smoke.py's element-wise f32 gate) with the same
    weights.  A batch collated without any slot layout still raises rather
    than take the plain route."""
    kw = dict(node_dim=16, node_irreps="16x0e+8x1o+4x2e", embed_basis="one-hot",
              num_basis=8, action_blocks=1, output_modes=["energy"],
              use_pallas_scatter="mega", pallas_layout=(16, 16, 8, 64))
    module, extra, cutoff = resolve_model("xpainn", **kw)
    init_params(module, seed=0)
    eng = InferenceEngine(module=module, model_kwargs=kw, extra=extra, cutoff=cutoff,
                          device=cuda_device)
    kw_plain = dict(kw, use_pallas_scatter=False)
    plain_module = resolve_model("xpainn", **kw_plain)[0]
    plain_module.load_state_dict(module.state_dict())
    plain = InferenceEngine(module=plain_module, model_kwargs=kw_plain, extra=extra,
                            cutoff=cutoff, device=cuda_device)
    rng = np.random.default_rng(0)
    small = Datapoint(rng.integers(1, 9, 6), rng.normal(size=(6, 3)) * 1.5)
    big = Datapoint(rng.integers(1, 9, 40), rng.normal(size=(40, 3)) * 2.0)
    for dps in ([small], [small, big]):
        fm.reset_launch_counts()
        res = eng.predict(dps)
        torch.cuda.synchronize()
        assert fm.LAUNCHES == _counts(message_fwd=1, message_bwd=1)
        want = plain.predict(dps)
        energy = lambda rs: torch.tensor([float(r[keys.TOTAL_ENERGY]) for r in rs])
        forces = lambda rs: torch.as_tensor(np.concatenate([r[keys.FORCES] for r in rs]))
        _close(energy(res), energy(want), 1e-4)
        _close(forces(res), forces(want), 3e-3)
    with pytest.raises(ValueError, match="mega message route"):
        eng.forward_batch(collate([eng.transform(small), eng.transform(big)]))


@pytest.mark.gpu
def test_cuda_ewald_model_mega_matches_plain(cuda_device):
    """The periodic XPaiNN-Ewald (chip_smoke.py phase 8 (a)'s model at 16
    channels, 3 action blocks, k-points (2, 2, 2)) served on the card on
    the mega route: 3 forward and 3 backward message launches per predict
    with forces and virial, and the plain route's energies (1e-4), forces
    (3e-3 of max |F|) and virial (1e-3 of max |V|) with the same weights."""
    kw = dict(node_dim=16, node_irreps="16x0e+8x1o+4x2e", embed_basis="one-hot",
              num_basis=8, action_blocks=3, output_modes=["energy"], use_pbc=True,
              num_k_points=[2, 2, 2], projection_dim=8, use_pallas_scatter="mega",
              pallas_layout=(16, 16, 16, 64))
    engines = {}
    for route in ("mega", False):
        k = dict(kw, use_pallas_scatter=route)
        module, extra, cutoff = resolve_model("xpainn-ewald", **k)
        init_params(module, seed=0)
        engines[route] = InferenceEngine(module=module, model_kwargs=k, extra=extra,
                                         cutoff=cutoff, device=cuda_device)
    rng = np.random.default_rng(2)
    dps = []
    for _ in range(6):
        n = int(rng.integers(8, 17))
        cell = np.diag(rng.uniform(4.5, 6.5, size=3)) + rng.normal(size=(3, 3)) * 0.15
        dps.append(Datapoint(rng.integers(1, 9, n), rng.uniform(0, 1, size=(n, 3)) @ cell,
                             cell=cell, pbc=np.array([True] * 3)))
    fm.reset_launch_counts()
    res = engines["mega"].predict(dps, compute_virial=True)
    torch.cuda.synchronize()
    assert fm.LAUNCHES == _counts(message_fwd=3, message_bwd=3)
    want = engines[False].predict(dps, compute_virial=True)
    stack = lambda rs, k: torch.as_tensor(np.concatenate([np.reshape(r[k], (-1,)) for r in rs]))
    _close(stack(res, keys.TOTAL_ENERGY), stack(want, keys.TOTAL_ENERGY), 1e-4)
    _close(stack(res, keys.FORCES), stack(want, keys.FORCES), 3e-3)
    _close(stack(res, keys.VIRIAL), stack(want, keys.VIRIAL), 1e-3)


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


# ---------------------------------------------------------------------------
# message_bwd2's Hopper tile pass (csrc/message_bwd2_hopper.cuh): the ring of
# stages, the tails of a walk, the halo layout, the packed single products
# and the widths it refuses
# ---------------------------------------------------------------------------
def _bwd2_close(p, cots, rel=2e-2):
    """The bf16 second order without cwf against the plain double VJP (2e-2
    of the largest reference magnitude), zero d2ef rows on every slot that
    adds nothing, zero d2g rows where no slot ends, and the same bits on a
    second call; returns the outputs."""
    m, mask = p["meta"], p["mask"]
    run = lambda: fm.message_bwd2_cuda(p["x"], p["ef"], p["wf"], p["g"], *cots, m,
                                       *p["statics"], p["n"], p["bn"], p["chunk"], "bfloat16")
    got = run()
    want = fm.plain_message_bwd2(p["x"], p["ef"], p["wf"], p["g"], *cots, m[2], m[3], mask,
                                 *p["statics"], p["n"], torch.bfloat16)
    torch.cuda.synchronize()
    for a, b, c in zip(got, want, run()):
        assert torch.isfinite(a).all()
        _close(a, b, rel)
        assert torch.equal(a, c)
    if (~mask).any():
        assert float(got[1][~mask].abs().max()) == 0.0
    return got


@pytest.mark.gpu
def test_cuda_hopper_bwd2_ring_wraps_and_tails(cuda_device):
    """Flagship widths without cwf (the Hopper tile pass of message_bwd2) on
    a batch of more tiles per block than ring stages, a slot count that is
    no multiple of 16 (a last tile partly full), whole tiles of padding in
    the slot_cap tail and slots past the covered chunk range: against the
    plain double VJP, zero d2ef rows on the slots that add nothing, zero
    d2g rows where no slot ends, the same bits on a second call."""
    assert fm.hopper2_route("bfloat16", *CASES[2])
    p = _problem(cuda_device, *CASES[2], n_mols=240, odd_tail=5)
    n_slots = p["mask"].shape[0]
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    ni, h, hp, d, dp, sdp, kw, kf = fm._launch_dims(*CASES[2])
    n_pt = fm.pair_table(*CASES[2])[1]
    nst = fm._hopper2_layout(ni, CASES[2][2], d, kw, kf, n_pt)[1]
    assert n_slots % 16 == 5 and n_slots // 16 > 2 * nst * n_sm
    m = p["meta"]
    covered = p["chunk"] * int(m[4][-1] + m[5][-1])
    assert covered + 16 < n_slots  # whole tiles past the covered range
    got = _bwd2_close(p, _cotangents(p, with_cwf=False))
    assert float(got[3][_empty_rows(p)].abs().max()) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES[:3], ids=("small", "two_ls", "flagship"))
def test_cuda_hopper_bwd2_takes_each_hopper_width(cuda_device, case):
    """Every CASES width the Hopper pass takes (one pair tile and a
    scalar tile; five pair tiles of l = 0 and l = 1 groups; the flagship's
    nine m64 tiles), with padding row pairs in the table, on a ragged
    batch: against the plain double VJP, repeating bit for bit."""
    assert fm.hopper2_route("bfloat16", *case)
    tab = fm.pair_table(*case)[0]
    assert (tab < 0).any() or case == CASES[2]
    p = _problem(cuda_device, *case, n_mols=60, odd_tail=5)
    _bwd2_close(p, _cotangents(p, with_cwf=False))


@pytest.mark.gpu
def test_cuda_hopper_bwd2_zero_slots(cuda_device):
    """A call with no slot: d2x, d2wf and d2g zero, d2ef empty."""
    p = _problem(cuda_device, *CASES[0])
    assert fm.hopper2_route("bfloat16", *CASES[0])
    z = torch.zeros(0, dtype=torch.int32, device=cuda_device)
    n = p["n"]
    ptr = torch.zeros(n + 1, dtype=torch.int32, device=cuda_device)
    plan = {"slot_src": z, "slot_dst": z, "dst_ptr": ptr, "dst_slots": z, "dst_pos": z,
            "src_ptr": ptr.clone(), "src_slots": z, "src_pos": z}
    meta = tuple(p["meta"][:7]) + (plan,)
    ef0 = p["ef"][:0].contiguous()
    d2x, d2ef, d2wf, d2g = fm.message_bwd2_cuda(p["x"], ef0, p["wf"], p["g"], p["x"], ef0, None,
                                                meta, *p["statics"], n, p["bn"], p["chunk"],
                                                "bfloat16")
    torch.cuda.synchronize()
    assert d2ef.shape == (0, fm.F_PACK)
    for t in (d2x, d2wf, d2g):
        assert float(t.abs().max()) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("bn", [256, 512])
def test_cuda_hopper_bwd2_halo_shard_layout(cuda_device, bn):
    """Shard 0 of 4 of a periodic box in HaloCalculator's layout (its
    partition, a window of local and halo rows, chunk 1024), flagship
    widths without cwf: the Hopper tile pass against the plain double
    VJP."""
    from xequinet_torch.parallel import halo as hm

    rng = np.random.default_rng(3)
    n = 3000
    lx = n * 0.15
    cell = np.diag([lx, 16.0, 16.0])
    pos = np.column_stack([(np.arange(n) * 0.15 + rng.normal(size=n) * 0.5) % lx,
                           rng.uniform(0, 16.0, size=(n, 2))])
    z = rng.integers(1, 9, size=n).astype(np.int32)
    stacked, geom, _, _, _, _ = hm.prepare_halo_system(z, pos, 5.0, 4, cell=cell,
                                                       pbc=np.array([True] * 3))
    bn = min(bn, geom["n_local"])
    stacked, _, _ = hm.apply_halo_kernel_layout(stacked, geom,
                                                {"block_nodes": bn, "chunk": 1024},
                                                margin=1.3)
    shard = {k: v[0] for k, v in stacked.items()}
    shard[keys.POSITIONS] = np.zeros((geom["window"], 3), np.float32)
    p = _operands(cuda_device, shard, "128x0e+64x1o+32x2e", 20, 128, rng, bn, 1024)
    assert geom["halo"] > 0 and fm.hopper2_route("bfloat16", *p["statics"])
    _bwd2_close(p, _cotangents(p, with_cwf=False))


@pytest.mark.gpu
@pytest.mark.parametrize("scale", [(1.0, 1.0), (2.0 ** -6, 2.0 ** -124)],
                         ids=("normal", "below_f32_normal"))
def test_cuda_hopper_bwd2_single_products_bit_for_bit(cuda_device, scale):
    """The Hopper pass rounds the single products of two bf16 values as
    __hmul2 on two slots' values, the plain version (and the TPU kernel) as
    an f32 product rounded to bf16: with fw and r small integers (so that a
    = rnd(cxh fw + r gs) and the gate sums are exact in any order), the d2x
    lanes rnd(gms_v a[gate]), the harmonic d2ef columns (one lane of gms_v
    left per column) and the hidden d2x columns of the gates (dfo and u
    from rnd(gv gms_v), rnd(ef[y] gms_v), rnd(cxv gms_v), rnd(cef[y] gms_v))
    are the same values on every valid slot, with ordinary products and
    with products below f32's normal range (x and cx times 2^-6, gms_v
    times 2^-124)."""
    p, (h, hp, d, kw, kf) = _pair_problem(cuda_device, (1.0, scale[1]))
    assert fm.hopper2_route("bfloat16", *p["statics"])
    ni = Irreps(p["statics"][0]).num_irreps
    rng = np.random.default_rng(9)
    t = p["ef"].shape[0]
    bf = lambda a: torch.as_tensor(a, dtype=torch.float32).to(torch.bfloat16).float()
    x = p["x"].cpu().numpy() * scale[0]
    cx = rng.normal(size=x.shape).astype(np.float32) * scale[0]
    cx[:, h:hp] = 0.0
    cx[:, hp + d:] = 0.0
    cef = np.zeros((t, fm.F_PACK), np.float32)
    cef[:, :kw] = rng.integers(-2, 3, size=(t, kw))
    cef[:, kw:kf] = rng.normal(size=(t, kf - kw))
    to = lambda a: bf(a).to(cuda_device)
    p = dict(p, x=to(x))
    cx, cef = to(cx), to(cef)
    m, mask = p["meta"], p["mask"]
    d2x, d2ef, _, _ = fm.message_bwd2_cuda(p["x"], p["ef"], p["wf"], p["g"], cx, cef, None, m,
                                           *p["statics"], p["n"], p["bn"], p["chunk"],
                                           "bfloat16")
    # the reference on the CPU: index_add on the card sums with float
    # atomics, which flush f32's subnormals to zero
    cpu = lambda t: t.cpu()
    rows_x, _, _, _, d2ef_ref, _ = fm.message_bwd2_rows(
        *map(cpu, (p["x"], p["ef"], p["wf"], p["g"], cx, cef)), None, *map(cpu, (m[2], m[3])),
        mask.cpu(), *p["statics"], torch.bfloat16)
    d2x, d2ef, src, mask = d2x.cpu(), d2ef.cpu(), m[2].long().cpu()[mask.cpu()], mask.cpu()
    assert torch.equal(d2x[src][:, hp:hp + d], rows_x[mask][:, h:])  # the d2x lanes
    assert torch.equal(d2ef[mask][:, kw:kf], d2ef_ref[mask][:, kw:kf])  # harmonic columns
    assert torch.equal(d2x[src][:, :2 * ni], rows_x[mask][:, :2 * ni])  # the gates' columns
    if scale[1] < 1.0:
        small = rows_x[mask][:, h:].abs()
        assert bool(((small > 0) & (small < 2.0 ** -126)).any())


# the widths message_bwd2's Hopper pass refuses, each still on the pass it
# takes (bf16 without cwf): the mma.sync tile pass at H = 640 and an odd run
# (d2wf in registers), Kf = 33 and Kf = 128 (WIDE), H = 1152 (LEAN)
BWD2_REFUSED = MMA_SYNC_CASES + WIDE
BWD2_REFUSED_IDS = ("h640", "odd_run") + WIDE_IDS


@pytest.mark.gpu
@pytest.mark.parametrize("case", BWD2_REFUSED, ids=BWD2_REFUSED_IDS)
def test_cuda_bwd2_refused_widths_keep_their_pass(cuda_device, case):
    """Each width the Hopper pass refuses takes the mma.sync tile pass, on a
    batch of more slot tiles than the card has SMs with a ragged last
    tile: against the plain double VJP in bf16 without cwf, repeating bit
    for bit; and at the flagship widths f32 and a cotangent on d_wf keep
    the walk kernels."""
    assert not fm.hopper2_route("bfloat16", *case)
    assert fm.tile_route("message_bwd2", "bfloat16", *case)
    p = _problem(cuda_device, *case, n_mols=200, odd_tail=5)
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert p["mask"].shape[0] > 2 * 16 * n_sm
    _bwd2_close(p, _cotangents(p, with_cwf=False))
    assert not fm.hopper2_route("float32", *CASES[2])
    assert not fm.hopper2_route("bfloat16", *CASES[2], has_cwf=True)
    assert not fm.tile_route("message_bwd2", "bfloat16", *CASES[2], has_cwf=True)


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["tile", "hopper"])
def test_cuda_bwd2_phase_probe_counts_cycles(cuda_device, which):
    """The phase probe's stamped instances of message_bwd2's two tile
    passes run at the flagship widths, stamp cycles for every block (and
    role) and count no launch in LAUNCHES."""
    p = _problem(cuda_device, *CASES[2], n_mols=60)
    cx, cef, _ = _cotangents(p, with_cwf=False)
    fm.reset_launch_counts()
    stamps = fm.bwd2_phase_stamps(p["x"], p["ef"], p["wf"], p["g"], cx, cef, p["meta"],
                                  *p["statics"], p["n"], p["bn"], p["chunk"], "bfloat16",
                                  which=which)
    torch.cuda.synchronize()
    assert fm.LAUNCHES == _counts()
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert stamps.shape == ((n_sm, fm.HB2_WGS + 1, 8) if which == "hopper" else (n_sm, 8))
    assert int(stamps.min()) >= 0 and bool((stamps.sum(-1) > 0).all())


def _fwd_close(p, rel=2e-2):
    """The bf16 forward against the plain version (2e-2 of the largest
    reference magnitude), finite, zero rows where no slot ends, and the
    same bits on a second call; returns the output."""
    m = p["meta"]
    run = lambda: fm.message_fwd_cuda(p["x"], p["ef"], p["wf"], m, *p["statics"], p["n"],
                                      p["bn"], p["chunk"], "bfloat16")
    out = run()
    want = fm.plain_message(p["x"], p["ef"], p["wf"], m[2], m[3], p["mask"], *p["statics"],
                            p["n"], torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    _close(out, want, rel)
    ptr = fm.build_slot_plan(m, p["n"], p["n"], p["bn"], p["chunk"])["dst_ptr"]
    empty = ptr[1:] == ptr[:-1]
    if empty.any():
        assert float(out[empty].abs().max()) == 0.0
    assert torch.equal(out, run())
    return out


@pytest.mark.gpu
def test_cuda_hopper_fwd_ring_wraps_and_tails(cuda_device):
    """Flagship widths (the Hopper tile pass of message_fwd) on a batch with
    a 40-atom molecule (groups of 16 rows of 39 slots each: many more tiles
    a group than ring stages), groups with a partly full last tile,
    groups of no slot (a tile of padding) and a slot count that is no
    multiple of 16: against the plain version, zero rows where no slot
    ends, the same bits on a second call."""
    assert fm.fwd_hopper_route("bfloat16", *CASES[2])
    p = _problem(cuda_device, *CASES[2], n_mols=240, odd_tail=5, dense=40)
    ni, h, hp, d, dp, sdp, kw, kf = fm._launch_dims(*CASES[2])
    _, n_pt, na = fm.fwd_table(*CASES[2])
    nst = fm._fwd_hopper_layout(ni, CASES[2][2], d, kw, kf, n_pt, na)[1]
    ptr = fm.build_slot_plan(p["meta"], p["n"], p["n"], p["bn"], p["chunk"])["dst_ptr"]
    ptr = ptr.cpu().numpy()
    r0 = np.arange(0, p["n"], 16)
    per_group = ptr[np.minimum(r0 + 16, p["n"])] - ptr[r0]
    assert per_group.max() > 16 * 2 * nst and (per_group == 0).any()
    assert (per_group % 16 != 0).any() and p["mask"].shape[0] % 16 == 5
    _fwd_close(p)


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES[:3], ids=("small", "two_ls", "flagship"))
def test_cuda_hopper_fwd_takes_each_hopper_width(cuda_device, case):
    """Every CASES width the forward's Hopper pass takes (one pair tile and
    a scalar tile, a warpgroup with padding columns only; five pair tiles
    of l = 0 and l = 1 groups; the flagship's nine m64 tiles), with padding
    entries in the table, on a ragged batch: against the plain version,
    repeating bit for bit."""
    assert fm.fwd_hopper_route("bfloat16", *case)
    p = _problem(cuda_device, *case, n_mols=60, odd_tail=5)
    _fwd_close(p)


@pytest.mark.gpu
def test_cuda_hopper_fwd_zero_slots(cuda_device):
    """A call with no slot: every group a tile of padding, every row zero."""
    p = _problem(cuda_device, *CASES[2])
    assert fm.fwd_hopper_route("bfloat16", *CASES[2])
    z = torch.zeros(0, dtype=torch.int32, device=cuda_device)
    n = p["n"]
    ptr = torch.zeros(n + 1, dtype=torch.int32, device=cuda_device)
    plan = {"slot_src": z, "slot_dst": z, "dst_ptr": ptr, "dst_slots": z, "dst_pos": z,
            "src_ptr": ptr.clone(), "src_slots": z, "src_pos": z}
    meta = tuple(p["meta"][:7]) + (plan,)
    out = fm.message_fwd_cuda(p["x"], p["ef"][:0].contiguous(), p["wf"], meta, *p["statics"],
                              n, p["bn"], p["chunk"], "bfloat16")
    torch.cuda.synchronize()
    assert out.shape == (n, 640) and float(out.abs().max()) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("bn", [256, 512])
def test_cuda_hopper_fwd_halo_shard_layout(cuda_device, bn):
    """Shard 0 of 4 of a periodic box in HaloCalculator's layout (its
    partition, a window of local and halo rows, chunk 1024), flagship
    widths: the forward's Hopper tile pass against the plain version."""
    from xequinet_torch.parallel import halo as hm

    rng = np.random.default_rng(3)
    n = 3000
    lx = n * 0.15
    cell = np.diag([lx, 16.0, 16.0])
    pos = np.column_stack([(np.arange(n) * 0.15 + rng.normal(size=n) * 0.5) % lx,
                           rng.uniform(0, 16.0, size=(n, 2))])
    z = rng.integers(1, 9, size=n).astype(np.int32)
    stacked, geom, _, _, _, _ = hm.prepare_halo_system(z, pos, 5.0, 4, cell=cell,
                                                       pbc=np.array([True] * 3))
    bn = min(bn, geom["n_local"])
    stacked, _, _ = hm.apply_halo_kernel_layout(stacked, geom,
                                                {"block_nodes": bn, "chunk": 1024},
                                                margin=1.3)
    shard = {k: v[0] for k, v in stacked.items()}
    shard[keys.POSITIONS] = np.zeros((geom["window"], 3), np.float32)
    p = _operands(cuda_device, shard, "128x0e+64x1o+32x2e", 20, 128, rng, bn, 1024)
    assert geom["halo"] > 0 and fm.fwd_hopper_route("bfloat16", *p["statics"])
    _fwd_close(p)


@pytest.mark.gpu
@pytest.mark.parametrize("case", BWD2_REFUSED, ids=BWD2_REFUSED_IDS)
def test_cuda_fwd_refused_widths_keep_their_pass(cuda_device, case):
    """Each width the forward's Hopper pass refuses (H = 640, an odd run,
    Kf = 33, Kf = 128, H = 1152) takes the mma.sync tile pass, on a batch
    of more groups than the card has SMs with ragged last tiles: against
    the plain version in bf16, repeating bit for bit; f32 keeps the walk
    kernel."""
    assert not fm.fwd_hopper_route("bfloat16", *case)
    assert fm.tile_route("message_fwd", "bfloat16", *case)
    p = _problem(cuda_device, *case, n_mols=320, odd_tail=5)
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert p["n"] > 16 * n_sm
    _fwd_close(p)
    assert not fm.fwd_hopper_route("float32", *CASES[2])
    assert not fm.tile_route("message_fwd", "float32", *CASES[2])


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["tile_fwd", "hopper_fwd"])
def test_cuda_fwd_phase_probe_counts_cycles(cuda_device, which):
    """The phase probe's stamped instances of message_fwd's two tile passes
    run at the flagship widths, stamp cycles for every block (and role),
    count no launch in LAUNCHES and give their pass's output: the Hopper
    pass's bits, the mma.sync pass's within 2e-2 of the plain version."""
    p = _problem(cuda_device, *CASES[2], n_mols=240)
    m = p["meta"]
    args = (p["x"], p["ef"], p["wf"], m, *p["statics"], p["n"], p["bn"], p["chunk"],
            "bfloat16")
    want = fm.message_fwd_cuda(*args)
    fm.reset_launch_counts()
    stamps, out = fm.fwd_phase_stamps(*args, which=which)
    torch.cuda.synchronize()
    assert fm.LAUNCHES == _counts()
    if which == "hopper_fwd":
        assert torch.equal(out, want)
    else:
        _close(out, fm.plain_message(p["x"], p["ef"], p["wf"], m[2], m[3], p["mask"],
                                     *p["statics"], p["n"], torch.bfloat16), 2e-2)
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    n_groups = -(-p["n"] // 16)
    assert stamps.shape == ((min(n_sm, n_groups), fm.HF_WGS + 1, 8) if which == "hopper_fwd"
                            else (n_groups, 8))
    assert int(stamps.min()) >= 0 and bool((stamps.sum(-1) > 0).all())


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


def _remat_step(device, policy):
    """(launches, energy, forces, parameter gradients) of one energy + force
    loss of a 3-block bf16 mega model with remat ``policy`` (None: off),
    seed-0 weights, under deterministic sums; then one train step's
    launches."""
    import torch.utils.deterministic as tud

    from xequinet_torch.training.trainer import loss_and_grads

    kw = dict(node_dim=16, node_irreps="16x0e+8x1o+4x2e", embed_basis="one-hot",
              num_basis=8, action_blocks=3, output_modes=["energy"],
              compute_dtype="bfloat16", update_compute_dtype="bfloat16",
              use_pallas_scatter="mega", pallas_layout=(16, 16, 16, 64))
    if policy is not None:
        kw.update(remat=True, remat_policy=policy)
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
    forward = make_forward(module, extra, create_graph=True)
    lossfn = WeightedLoss("l2", energy=1.0, forces=10.0)
    was, fill = torch.are_deterministic_algorithms_enabled(), tud.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True)
    try:
        _, _, out, grads = loss_and_grads(forward, lossfn, params, batch, True, False)
    finally:
        torch.use_deterministic_algorithms(was)
        tud.fill_uninitialized_memory = fill
    opt = resolve_optimizer("adamw", params)
    step = make_step_core(forward, lossfn, params, opt,
                          resolve_lr_schedule("cosine_annealing", 5e-4, 100, warmup_steps=10),
                          True, False, 5.0, 0.999, ErrorMetric("energy", "forces"))
    fm.reset_launch_counts()
    loss, _ = step(batch, 0, 1.0, [p.detach().clone() for p in params])
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    return (dict(fm.LAUNCHES), out[keys.TOTAL_ENERGY].detach(), out[keys.FORCES].detach(),
            [g.detach() for g in grads])


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["full", "save_edge_agg"])
def test_cuda_remat_train_step_launches_and_bits(cuda_device, policy):
    """A remat train step of the 3-block mega model on the card launches the
    JAX program's kernels, 3 + 8 + 3 (test_torch_remat.py reads them from
    its jaxpr; without remat 3 + 6 + 3), and under deterministic sums its
    energy, forces and parameter gradients equal those without remat bit
    for bit, the step without remat run right before (the engine orders
    the parameter pass by per-thread sequence numbers, and a remat rerun
    records nodes on the card's backward thread, so a later call's sums
    may run in another order)."""
    counts0, e0, f0, g0 = _remat_step(cuda_device, None)
    assert counts0 == _counts(message_fwd=3, message_bwd=6, message_bwd2=3)
    counts, e, f, g = _remat_step(cuda_device, policy)
    assert counts == _counts(message_fwd=3, message_bwd=8, message_bwd2=3)
    assert torch.equal(e, e0) and torch.equal(f, f0)
    for a, b in zip(g, g0):
        assert torch.equal(a, b)


def _wide_checks(p, mm, rel, repeat=True):
    """The three message kernels at the problem's widths against their plain
    versions (the second order without and with cwf), zero d_ef / d2ef rows
    on every slot that adds nothing, and the same bits on a second call."""
    m, mask, cd = p["meta"], p["mask"], getattr(torch, mm)
    args = (*p["statics"], p["n"], p["bn"], p["chunk"], mm)
    plain_args = (m[2], m[3], mask, *p["statics"], p["n"], cd)
    runs = [
        (lambda: (fm.message_fwd_cuda(p["x"], p["ef"], p["wf"], m, *args),),
         lambda: (fm.plain_message(p["x"], p["ef"], p["wf"], *plain_args),)),
        (lambda: fm.message_bwd_cuda(p["x"], p["ef"], p["wf"], p["g"], m, *args),
         lambda: fm.plain_message_bwd(p["x"], p["ef"], p["wf"], p["g"], *plain_args)),
    ]
    for with_cwf in (False, True):
        cots = _cotangents(p, with_cwf=with_cwf)
        runs.append((
            lambda c=cots: fm.message_bwd2_cuda(p["x"], p["ef"], p["wf"], p["g"], *c, m, *args),
            lambda c=cots: fm.plain_message_bwd2(p["x"], p["ef"], p["wf"], p["g"], *c,
                                                 *plain_args)))
    for kernel, plain in runs:
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.isfinite(a).all()
            _close(a, b, rel)
        if len(got) > 1:
            assert float(got[1][~mask].abs().max()) == 0.0
        if repeat:
            for a, b in zip(got, kernel()):
                assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("case", WIDE + [("256x0e+128x1o+64x2e", 118, 256)],
                         ids=WIDE_IDS + ("kf128-h1152",))
@pytest.mark.parametrize("mm,rel", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_cuda_message_kernels_wide_shapes(cuda_device, case, mm, rel):
    """Kf = 33, Kf = 128, H = 1152 and both at once (where the bf16 second
    order takes its walk kernels, in column chunks) on a slot count that is
    no multiple of the tile, with padding slots and a slot_cap tail: every
    kernel against its plain version in f32 and bf16, repeating bit for
    bit."""
    p = _problem(cuda_device, *case, odd_tail=5)
    assert p["mask"].shape[0] % 16 == 5 and not bool(p["mask"][-5:].any())
    _wide_checks(p, mm, rel)


@pytest.mark.gpu
@pytest.mark.parametrize("case", WIDE, ids=WIDE_IDS)
def test_cuda_message_kernels_wide_many_tiles_per_block(cuda_device, case):
    """The wide shapes in bf16 on more slot tiles than the card has SMs, so
    each persistent block of a tile pass walks several tiles (at H = 1152
    the backward's one stage with wf read from L2 and the second order's
    lean layout), its dfw rows go to the d_wf pass: against the plain
    versions, and repeating bit for bit."""
    p = _problem(cuda_device, *case, n_mols=240)
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert p["mask"].shape[0] > 3 * 16 * n_sm
    routes = [fm.tile_route(k, "bfloat16", *p["statics"])
              for k in ("message_fwd", "message_bwd", "message_bwd2")]
    assert all(routes)
    _wide_checks(p, "bfloat16", 2e-2)


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
@pytest.mark.parametrize("d", [3, 480, 481])
@pytest.mark.parametrize("wdt,rel", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_cuda_gather_scatter_v2_rows_and_widths(cuda_device, d, wdt, rel):
    """The v2 kernel's float4 columns (D % 4 == 0; four bf16 of w2 per
    8-byte load) and scalar columns (D = 3, 481) on a plan with rows of no
    slot and rows of more than 32 slots (a 40-atom molecule within the
    cutoff): against the plain version, one launch per call, the same bits
    on a second call."""
    p = _problem(cuda_device, *CASES[0], dense=40)
    rng = np.random.default_rng(5)
    t = p["meta"][0].shape[0]
    x = torch.as_tensor(rng.normal(size=(p["n"], d)).astype(np.float32), device=cuda_device)
    w2 = torch.as_tensor(rng.normal(size=(t, d)).astype(np.float32),
                         device=cuda_device).to(getattr(torch, wdt))
    m = p["meta"]
    plan = gs2.v2_slot_plan(m[0], m[1], m[4], m[5], m[6], p["n"], p["n"], p["bn"], p["chunk"])
    runs = plan["dst_ptr"][1:] - plan["dst_ptr"][:-1]
    assert int(runs.max()) > 32 and int(runs.min()) == 0
    fm.reset_launch_counts()
    got = gs2.gather_scale_scatter_v2_cuda(x, w2, plan, p["n"])
    assert fm.LAUNCHES == _counts(gather_scatter_v2=1)
    want = gs2.gather_scale_scatter_v2_plain(x.cpu(), w2.cpu(), m[0].cpu(), m[1].cpu(),
                                             m[4].cpu(), m[5].cpu(), m[6].cpu(), p["n"],
                                             p["bn"], p["chunk"])
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and float(got[runs == 0].abs().max()) == 0.0
    _close(got.cpu(), want, rel)
    assert torch.equal(got, gs2.gather_scale_scatter_v2_cuda(x, w2, plan, p["n"]))


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


# the rest of the model zoo at small widths (chip_smoke.py phase 9 runs
# them at full width): PaiNN and SO3krates run no kernel; the Cartesian
# head and XMatNet sit on the mega route's message kernels
ZOO_XPAINN = dict(node_dim=16, node_irreps="16x0e+8x1o+4x2e", embed_basis="one-hot",
                  num_basis=8, action_blocks=3, use_pallas_scatter="mega",
                  pallas_layout=(16, 16, 16, 64))
ZOO_SHELLS = {"H": [0, 0, 1], "He": [0, 0, 1], "Li": [0, 0, 0, 1, 1], "Be": [0, 0, 0, 1, 1],
              **{e: [0, 0, 0, 1, 1, 2] for e in ("B", "C", "N", "O")}}
ZOO = {
    "painn": ("painn", dict(node_dim=16, num_basis=8), {}),
    "so3krates": ("so3krates", dict(node_dim=24, node_channel=8, num_basis=8,
                                    embed_basis="one-hot"), {}),
    "cartesian": ("xpainn", dict(ZOO_XPAINN, output_modes=["energy", "cartesian"],
                                 hidden_channels=4, hidden_dim=8),
                  dict(message_fwd=3, message_bwd=3)),
    "xmatnet": ("xmatnet", dict(ZOO_XPAINN, hidden_irreps="4x0e+4x1o+4x2e",
                                target_basis=ZOO_SHELLS, elements=list(ZOO_SHELLS)),
                dict(message_fwd=3)),
}


def _zoo_molecules(n_mols=6, seed=3):
    rng = np.random.default_rng(seed)
    dps = []
    for _ in range(n_mols):
        n = int(rng.integers(5, 12))
        pos = rng.normal(size=(n, 3)) * 1.5
        dps.append(Datapoint(rng.integers(1, 9, n), pos, edge_index=radius_graph_np(pos, 5.0)[0]))
    return dps


@pytest.mark.gpu
@pytest.mark.parametrize("cell", list(ZOO))
def test_cuda_model_zoo_matches_cpu(cuda_device, cell):
    """Each family in f32 on the card against the port's own CPU run of the
    same weights, on the same collated batch: energies 1e-4, forces 3e-3 of
    max |F| (chip_smoke.py's element-wise f32 gate), the Cartesian tensor
    and XMatNet's blocks 1e-4 of the largest entry; the launches of one
    call: none for PaiNN and SO3krates, 3 + 3 per Cartesian-head predict
    with forces, 3 forward launches per XMatNet forward."""
    model, kw, want_launches = ZOO[cell]
    module, extra, cutoff = resolve_model(model, **kw)
    init_params(module, seed=0)
    state = module.state_dict()
    engines = {}
    for name, dev in (("card", cuda_device), ("cpu", torch.device("cpu"))):
        m = resolve_model(model, **kw)[0]
        m.load_state_dict(state)
        engines[name] = InferenceEngine(module=m, model_kwargs=kw, extra=extra, cutoff=cutoff,
                                        device=dev)
    forces = cell != "xmatnet"
    batch = engines["card"].collate(_zoo_molecules())
    fm.reset_launch_counts()
    got = engines["card"].forward_batch(batch, forces)
    torch.cuda.synchronize()
    assert fm.LAUNCHES == _counts(**want_launches)
    want = engines["cpu"].forward_batch(batch, forces)
    checks = {keys.TOTAL_ENERGY: 1e-4, keys.FORCES: 3e-3, keys.CARTESIAN_TENSOR: 1e-4,
              keys.NODE_MAT_BLOCKS: 1e-4, keys.EDGE_MAT_BLOCKS: 1e-4}
    assert set(want) & set(checks)
    for k in set(want) & set(checks):
        _close(got[k].cpu(), want[k], checks[k])


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["cartesian", "xmatnet"])
def test_cuda_model_zoo_train_step_launches(cuda_device, cell):
    """One bf16 train step on the card: 3 + 6 + 3 message launches for the
    Cartesian head on {energy, forces, cartesian_tensor} (the force loss's
    second order), 3 + 3 + 0 for XMatNet on its matrix blocks (no force
    term); a finite loss and parameters."""
    model, kw, _ = ZOO[cell]
    kw = dict(kw, compute_dtype="bfloat16", update_compute_dtype="bfloat16")
    module, extra, _ = resolve_model(model, **kw)
    init_params(module, seed=0)
    module = module.to(cuda_device)
    rng = np.random.default_rng(4)
    dps = _zoo_molecules()
    if cell == "cartesian":
        weights = {"energy": 1.0, "forces": 10.0, keys.CARTESIAN_TENSOR: 1.0}
        for d in dps:
            d.energy, d.forces = float(rng.normal()), rng.normal(size=(d.num_atoms, 3))
            d.extras[keys.CARTESIAN_TENSOR] = rng.normal(size=(3, 3)).astype(np.float32)
        want = dict(message_fwd=3, message_bwd=6, message_bwd2=3)
    else:
        weights = {keys.NODE_MAT_BLOCKS: 1.0, keys.EDGE_MAT_BLOCKS: 1.0}
        for d in dps:
            for k, n in ((keys.NODE_MAT_BLOCKS, d.num_atoms), (keys.EDGE_MAT_BLOCKS, d.num_edges)):
                d.extras[k] = rng.normal(size=(n, 14, 14)).astype(np.float32)
        want = dict(message_fwd=3, message_bwd=3)
    layout = {"block_nodes": 16, "chunk": 16, "pad_nodes": 16, "max_chunks": 64}
    batch = batch_to_device(collate(dps, kernel_layout=layout), cuda_device)
    params = list(module.parameters())
    step = make_step_core(make_forward(module, extra, create_graph=True),
                          WeightedLoss("l2", **weights), params, resolve_optimizer("adamw", params),
                          resolve_lr_schedule("cosine_annealing", 5e-4, 100, warmup_steps=10),
                          "forces" in weights, False, 5.0, 0.999, ErrorMetric(*weights))
    fm.reset_launch_counts()
    loss, _ = step(batch, 0, 1.0, [p.detach().clone() for p in params])
    torch.cuda.synchronize()
    assert fm.LAUNCHES == _counts(**want)
    assert torch.isfinite(loss) and all(torch.isfinite(p).all() for p in params)


@pytest.mark.gpu
def test_cuda_exported_energy_program_matches_calculator(cuda_device, tmp_path):
    """``export_model`` on the card (energy with the virial, 64 atoms, 2048
    edges, an f32 XPaiNN checkpoint): the loaded program launches no
    kernel and agrees with the plain Calculator on the card, energy 1e-4
    relative, forces element-wise 3e-3 / 2e-4 of max |F| (max, 99th
    percentile per atom; chip_smoke.py's F32_FORCE_TOL), virial 1e-3."""
    from xequinet_torch.interface.calculator import Calculator
    from xequinet_torch.interface.export import export_model, load_exported
    from xequinet_torch.training.trainer import save_checkpoint

    kw = dict(node_dim=32, node_irreps="32x0e+16x1o+8x2e", embed_basis="one-hot", num_basis=8,
              action_blocks=2, output_modes=["energy"], cutoff=5.0)
    module, _, _ = resolve_model("xpainn", **kw)
    init_params(module, seed=0)
    ckpt = str(tmp_path / "m.ckpt")
    save_checkpoint(ckpt, module, {"model_name": "xpainn", "model_kwargs": kw,
                                   "default_units": {}})
    export_model(ckpt, str(tmp_path / "exp"), max_atoms=64, max_edges=2048)
    program, manifest = load_exported(str(tmp_path / "exp"))
    assert manifest["compute_virial"] and manifest["max_atoms"] == 64
    rng = np.random.default_rng(8)
    z = rng.integers(1, 9, 40).astype(np.int32)
    pos = rng.normal(size=(40, 3)) * 2.5
    ei, _ = radius_graph_np(pos, 5.0)
    args = [np.zeros((64, 3), np.float32), np.zeros(64, np.int32),
            np.zeros((2, 2048), np.int32), np.arange(2048) < ei.shape[1],
            np.zeros(1, np.int32)]
    args[0][:40], args[1][:40], args[2][:, :ei.shape[1]] = pos, z, ei
    fm.reset_launch_counts()
    e, f, v = program(*[torch.as_tensor(a, device=cuda_device) for a in args])
    torch.cuda.synchronize()
    assert fm.LAUNCHES == _counts()
    ref = Calculator(ckpt, compute_virial=True, device=cuda_device).calculate(z, pos)
    assert abs(float(e) - ref[keys.TOTAL_ENERGY]) <= 1e-4 * abs(ref[keys.TOTAL_ENERGY])
    f = f.cpu().numpy()[:40]
    scale = np.abs(ref[keys.FORCES]).max()
    assert np.abs(f - ref[keys.FORCES]).max() <= 3e-3 * scale
    assert np.quantile(np.linalg.norm(f - ref[keys.FORCES], axis=-1), 0.99) <= 2e-4 * scale
    vw = ref[keys.VIRIAL]
    assert np.abs(v.cpu().numpy() - vw).max() <= 1e-3 * np.abs(vw).max()


@pytest.mark.gpu
def test_cuda_halo_forward_two_ranks_matches_single_process(cuda_device, tmp_path):
    """Two ranks of one gloo group on the card (tests/_torch_halo_worker.py)
    each run their shard of a 400-atom free chain through the message
    kernels (f32 mega route, 2 + 2 launches per rank): energy and forces
    against the single-process plain route on the card, 1e-5 and 1e-4 of
    the largest |F|."""
    from tests._torch_halo_worker import run_pool
    from xequinet_torch.parallel.halo import apply_halo_kernel_layout, halo_partition

    fm.build_kernels()  # once, before the ranks start
    kw = dict(node_dim=16, node_irreps="16x0e+8x1o+4x2e", embed_basis="one-hot",
              num_basis=8, cutoff=5.0, action_blocks=2, output_modes=["energy"])
    rng = np.random.default_rng(0)
    x = np.cumsum(rng.uniform(0.8, 1.6, size=400))
    pos = np.column_stack([x, rng.normal(size=(400, 2)) * 1.2])
    z = rng.integers(1, 9, size=400).astype(np.int32)
    ei, _ = radius_graph_np(pos, 5.0)
    ei = ei[:, np.argsort(ei[0], kind="stable")]
    module, extra, _ = resolve_model("xpainn", **kw)
    init_params(module, seed=0)
    state = {k: v.numpy() for k, v in module.state_dict().items()}
    stacked, geom = halo_partition(z, pos, ei, 2, halo=32)
    stacked, _, mxc = apply_halo_kernel_layout(stacked, geom, {"block_nodes": 64,
                                                               "chunk": 32})
    mega = dict(kw, use_pallas_scatter="mega", pallas_layout=(64, 32, geom["halo"], mxc))
    outs = run_pool({"halo": dict(kind="forward", kw=mega, state=state, stacked=stacked,
                                  geom=geom, device="cuda")}, tmp_path, 2)
    want = make_forward(module.to(cuda_device).requires_grad_(False), extra)(
        batch_to_device(collate([Datapoint(z, pos, edge_index=ei)]), cuda_device), True)
    e_want = float(want[keys.TOTAL_ENERGY][0])
    f_want = want[keys.FORCES][:400].cpu().numpy()
    nl, h = geom["n_local"], geom["halo"]
    nm = stacked[keys.NODE_MASK][:, h:h + nl].reshape(-1)
    for o in outs:
        r = o["halo"]
        assert r["launches"].get("message_fwd") == 2 and r["launches"].get("message_bwd") == 2
        assert abs(r["energy"] - e_want) <= 1e-5 * max(abs(e_want), 1.0)
        f = r["forces"].reshape(-1, 3)[nm]
        assert np.abs(f - f_want).max() <= 1e-4 * np.abs(f_want).max()


# ---------------------------------------------------------------------------
# The f32 tile passes of message_bwd and message_bwd2
# (csrc/message_f32_tile.cuh): every width they take, the tails of a walk,
# zero slots, the halo and ghost layouts, the widths they refuse, a train
# step, the phase probe
# ---------------------------------------------------------------------------
# the CASES widths the f32 passes take (all but H = 640: ten consumer warps)
F32_CASES = CASES[:3] + CASES[4:]
F32_IDS = ("small", "two_ls", "flagship", "odd_run")


def _kernels_run(fn):
    """The names of the CUDA kernels one call of ``fn`` launches
    (torch.profiler; a session that recorded no kernel at all, as a
    profiler in one process sometimes does, is taken again)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = " ".join(e.key for e in prof.key_averages())
        if "_kernel" in names:
            break
    return names


def _route(kernel, p, cots=None, cwf=None):
    """The route a call of ``kernel``'s wrapper takes on the problem: 3 the
    f32 tile pass, 0 the walk kernels (the setup the wrapper launches
    with)."""
    m = p["meta"]
    if kernel == "message_bwd":
        return fm._bwd_setup(p["x"], p["ef"], p["wf"], p["g"], m, *p["statics"], p["n"],
                             p["bn"], p["chunk"], "float32")["route"]
    return fm._bwd2_setup(p["x"], p["ef"], p["wf"], p["g"], *cots, cwf, m, *p["statics"],
                          p["n"], p["bn"], p["chunk"], "float32")["route"]


def _f32_checks(p, cots=None, mask=None):
    """message_bwd in f32 (or message_bwd2 without cwf with ``cots`` = (cx,
    cef)) against its plain version within 1e-5 of the largest reference
    magnitude, zero d_ef rows on the slots that add nothing, zero d2g rows
    where no slot ends, the same bits on a second call; returns the names
    of the kernels a call launched."""
    m, mask = p["meta"], p["mask"] if mask is None else mask
    if cots is None:
        run = lambda: fm.message_bwd_cuda(p["x"], p["ef"], p["wf"], p["g"], m, *p["statics"],
                                          p["n"], p["bn"], p["chunk"], "float32")
        want = fm.plain_message_bwd(p["x"], p["ef"], p["wf"], p["g"], m[2], m[3], mask,
                                    *p["statics"], p["n"], torch.float32)
    else:
        run = lambda: fm.message_bwd2_cuda(p["x"], p["ef"], p["wf"], p["g"], *cots, None, m,
                                           *p["statics"], p["n"], p["bn"], p["chunk"],
                                           "float32")
        want = fm.message_bwd2_closed(p["x"], p["ef"], p["wf"], p["g"], *cots, None, m[2],
                                      m[3], mask, *p["statics"], p["n"], torch.float32)
    got = run()
    torch.cuda.synchronize()
    for a, b, c in zip(got, want, run()):
        assert torch.isfinite(a).all()
        _close(a, b, 1e-5)
        assert torch.equal(a, c)
    if (~mask).any():
        assert float(got[1][~mask].abs().max()) == 0.0
    if cots is not None and got[3].shape[0]:
        ptr = fm.build_slot_plan(m, p["n"], p["n"], p["bn"], p["chunk"])["dst_ptr"]
        empty = ptr[1:] == ptr[:-1]
        if bool(empty.any()):
            assert float(got[3][empty].abs().max()) == 0.0
    return _kernels_run(run)


def _f32_cots(p):
    cx, cef, _ = _cotangents(p, with_cwf=False)
    return cx, cef


@pytest.mark.gpu
@pytest.mark.parametrize("case", F32_CASES, ids=F32_IDS)
@pytest.mark.parametrize("kernel", ["message_bwd", "message_bwd2"])
def test_cuda_f32_passes_take_each_width(cuda_device, case, kernel):
    """Every CASES width the f32 tile passes take (one to nine consumer
    warps, padding lanes in their irrep warps, an odd run of irreps), on a
    ragged batch (padding slots, a slot_cap tail, rows with no slot):
    against the plain versions at 1e-5, bit for bit on a second call, and
    through the f32 tile pass, no walk kernel."""
    assert fm.f32_route(kernel, "float32", *case)
    p = _problem(cuda_device, *case, n_mols=60, odd_tail=5)
    cots = _f32_cots(p) if kernel == "message_bwd2" else None
    assert _route(kernel, p, cots) == 3
    names = _f32_checks(p, cots)
    assert f"{kernel}_f32_kernel" in names
    assert f"{kernel}_dx_kernel" not in names and f"{kernel}_slot_kernel" not in names


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["message_bwd", "message_bwd2"])
def test_cuda_f32_passes_ring_wraps_and_tails(cuda_device, kernel):
    """Flagship widths on a batch of many more tiles per block than ring
    stages, a slot count that is no multiple of the tile, whole tiles of
    padding in the slot_cap tail and slots past the covered chunk range:
    against the plain versions at 1e-5, bit for bit on a second call."""
    p = _problem(cuda_device, *CASES[2], n_mols=240, odd_tail=5)
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    ni, h, hp, d, dp, sdp, kw, kf = fm._launch_dims(*CASES[2])
    nst = fm._f32_layout(kernel, ni, CASES[2][2], d, kw, kf)[1]
    assert int(p["mask"].sum()) // fm.F32_BT > 3 * nst * n_sm
    m = p["meta"]
    assert p["chunk"] * int(m[4][-1] + m[5][-1]) + 16 < p["mask"].shape[0]
    _f32_checks(p, _f32_cots(p) if kernel == "message_bwd2" else None)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["message_bwd", "message_bwd2"])
def test_cuda_f32_passes_zero_slots(cuda_device, kernel):
    """A call with no slot: dx (d2x), d_wf (d2wf) and d2g zero, d_ef empty."""
    p = _problem(cuda_device, *CASES[2])
    z = torch.zeros(0, dtype=torch.int32, device=cuda_device)
    n = p["n"]
    zp = torch.zeros(n + 1, dtype=torch.int32, device=cuda_device)
    plan = {"slot_src": z, "slot_dst": z, "dst_ptr": zp, "dst_slots": z, "dst_pos": z,
            "src_ptr": zp, "src_slots": z, "src_pos": z}
    meta = tuple(p["meta"][:7]) + (plan,)
    ef = p["ef"][:0].contiguous()
    if kernel == "message_bwd":
        out = fm.message_bwd_cuda(p["x"], ef, p["wf"], p["g"], meta, *p["statics"], n, p["bn"],
                                  p["chunk"], "float32")
    else:
        out = fm.message_bwd2_cuda(p["x"], ef, p["wf"], p["g"], torch.ones_like(p["x"]),
                                   torch.ones_like(ef), None, meta, *p["statics"], n, p["bn"],
                                   p["chunk"], "float32")
    torch.cuda.synchronize()
    assert out[1].shape == (0, fm.F_PACK)
    for t in out[:1] + out[2:]:
        assert float(t.abs().max()) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("bn", [256, 512])
def test_cuda_f32_passes_halo_shard_layout(cuda_device, bn):
    """Shard 0 of 4 of a periodic box in HaloCalculator's layout (local and
    halo rows in one window, chunk 1024), flagship widths, f32: both passes
    against their plain versions."""
    from xequinet_torch.parallel import halo as hm

    rng = np.random.default_rng(3)
    n = 3000
    lx = n * 0.15
    cell = np.diag([lx, 16.0, 16.0])
    pos = np.column_stack([(np.arange(n) * 0.15 + rng.normal(size=n) * 0.5) % lx,
                           rng.uniform(0, 16.0, size=(n, 2))])
    z = rng.integers(1, 9, size=n).astype(np.int32)
    stacked, geom, _, _, _, _ = hm.prepare_halo_system(z, pos, 5.0, 4, cell=cell,
                                                       pbc=np.array([True] * 3))
    bn = min(bn, geom["n_local"])
    stacked, _, _ = hm.apply_halo_kernel_layout(stacked, geom,
                                                {"block_nodes": bn, "chunk": 1024},
                                                margin=1.3)
    shard = {k: v[0] for k, v in stacked.items()}
    shard[keys.POSITIONS] = np.zeros((geom["window"], 3), np.float32)
    p = _operands(cuda_device, shard, "128x0e+64x1o+32x2e", 20, 128, rng, bn, 1024)
    assert geom["halo"] > 0 and fm.f32_route("message_bwd2", "float32", *p["statics"])
    _f32_checks(p)
    _f32_checks(p, _f32_cots(p))


@pytest.mark.gpu
@pytest.mark.parametrize("bn", [256, 512])
def test_cuda_f32_passes_periodic_ghost_layout(cuda_device, bn):
    """The MD hot loop's periodic ghost layout (chunk 1024, a wide window),
    f32: both passes against their plain versions."""
    p, plan = _ghost_problem(cuda_device, bn)
    assert plan["n_ghosts"] > 0
    _f32_checks(p)
    _f32_checks(p, _f32_cots(p))


# the widths the f32 passes refuse: H = 640 (ten consumer warps), Kf = 33
# (Kw = 24, Kf past 32) and H = 1152
F32_REFUSED = [CASES[3], WIDE[0], WIDE[2]]


@pytest.mark.gpu
@pytest.mark.parametrize("case", F32_REFUSED, ids=("h640", "kf33", "h1152"))
def test_cuda_f32_refused_widths_keep_the_walk_kernels(cuda_device, case):
    """The widths the f32 tile passes refuse, and the second order with a
    cotangent on d_wf, keep the walk kernels: against the plain versions in
    f32 at 1e-5, on the walk route."""
    for kernel in ("message_bwd", "message_bwd2"):
        assert not fm.f32_route(kernel, "float32", *case)
    assert not fm.f32_route("message_bwd2", "float32", *CASES[2], has_cwf=True)
    p = _problem(cuda_device, *case, n_mols=20, odd_tail=5)
    assert _route("message_bwd", p) == 0 and _route("message_bwd2", p, _f32_cots(p)) == 0
    _f32_checks(p)
    _f32_checks(p, _f32_cots(p))
    q = _problem(cuda_device, *CASES[2], n_mols=20)
    cots = _cotangents(q, with_cwf=True)
    assert _route("message_bwd2", q, cots[:2], cots[2]) == 0
    m = q["meta"]
    got = fm.message_bwd2_cuda(q["x"], q["ef"], q["wf"], q["g"], *cots, m, *q["statics"],
                               q["n"], q["bn"], q["chunk"], "float32")
    want = fm.plain_message_bwd2(q["x"], q["ef"], q["wf"], q["g"], *cots, m[2], m[3],
                                 q["mask"], *q["statics"], q["n"], torch.float32)
    for a, b in zip(got, want):
        _close(a, b, 1e-5)


@pytest.mark.gpu
def test_cuda_f32_flagship_train_step_runs_the_f32_passes(cuda_device):
    """One f32 energy + force train step of a 3-block model at the flagship
    widths (128x0e+64x1o+32x2e, node_dim 128, 20 bases) on the mega route:
    3 + 6 + 3 launches, through the f32 tile passes of message_bwd,
    message_bwd2 and message_fwd (the forward's 3 times in the step) and no
    walk kernel, a finite loss and finite parameters."""
    from torch.profiler import ProfilerActivity, profile

    kw = dict(node_dim=128, node_irreps="128x0e+64x1o+32x2e", embed_basis="one-hot",
              num_basis=20, action_blocks=3, output_modes=["energy"],
              compute_dtype="float32", use_pallas_scatter="mega",
              pallas_layout=(16, 16, 16, 64))
    module, extra, _ = resolve_model("xpainn", **kw)
    init_params(module, seed=0)
    module = module.to(cuda_device)
    rng = np.random.default_rng(0)
    dps = []
    for _ in range(8):
        n = int(rng.integers(4, 12))
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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        loss, _ = step(batch, 0, 1.0, [q.detach().clone() for q in params])
        torch.cuda.synchronize()
    assert torch.isfinite(loss) and all(torch.isfinite(q).all() for q in params)
    assert fm.LAUNCHES == _counts(message_fwd=3, message_bwd=6, message_bwd2=3)
    names = " ".join(e.key for e in prof.key_averages())
    assert "message_bwd_f32_kernel" in names and "message_bwd2_f32_kernel" in names
    for walk in ("message_bwd_dx_kernel", "message_bwd_slot_kernel", "message_bwd2_dg_kernel",
                 "message_bwd2_dx_kernel", "message_bwd2_slot_kernel", "message_fwd_kernel"):
        assert walk not in names
    assert sum(e.count for e in prof.key_averages() if "message_fwd_f32_kernel" in e.key) == 3


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["message_bwd", "message_bwd2"])
def test_cuda_f32_phase_probe_counts_cycles(cuda_device, kernel):
    """The phase probe's stamped instance of each f32 tile pass runs at the
    flagship widths, stamps cycles for every block's consumers and
    producer, gives the route's outputs and counts no launch in LAUNCHES."""
    p = _problem(cuda_device, *CASES[2], n_mols=60)
    m = p["meta"]
    args = (p["x"], p["ef"], p["wf"], p["g"])
    if kernel == "message_bwd2":
        args += _f32_cots(p) + (None,)
    args += (m, *p["statics"], p["n"], p["bn"], p["chunk"], "float32")
    fm.reset_launch_counts()
    stamps = fm.f32_phase_stamps(kernel, *args)
    torch.cuda.synchronize()
    assert fm.LAUNCHES == _counts()
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert stamps.shape == (n_sm, 2, 8)
    assert int(stamps.min()) >= 0 and bool((stamps.sum(-1) > 0).all())


# ---------------------------------------------------------------------------
# message_fwd's f32 tile pass (csrc/message_fwd_f32.cuh): every width it
# takes, the ring and the tails of a range, zero slots, the halo and ghost
# layouts, the widths it refuses, a train step, the phase probe
# ---------------------------------------------------------------------------
def _fwd_route32(p, n_out=None):
    """The route the f32 forward takes on the problem: 3 the f32 tile pass,
    0 the walk kernel (the setup the wrapper launches with)."""
    return fm._fwd_setup(p["x"], p["ef"], p["wf"], p["meta"], *p["statics"],
                         p["n"] if n_out is None else n_out, p["bn"], p["chunk"],
                         "float32")["route"]


def _fwd_f32_checks(p, n_out=None):
    """message_fwd in f32 on ``n_out`` output rows (all of x's by default)
    against its plain version within 1e-5 of the largest reference
    magnitude, finite, zero rows where no slot ends, the same bits on a
    second call; returns the names of the kernels a call launched."""
    m, n_out = p["meta"], p["n"] if n_out is None else n_out
    run = lambda: fm.message_fwd_cuda(p["x"], p["ef"], p["wf"], m, *p["statics"], n_out,
                                      p["bn"], p["chunk"], "float32")
    # slots ending past n_out add nothing: the plain sums' first n_out rows
    want = fm.plain_message(p["x"], p["ef"], p["wf"], m[2], m[3], p["mask"], *p["statics"],
                            p["n"], torch.float32)[:n_out]
    got = run()
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.isfinite(got).all()
    _close(got, want, 1e-5)
    assert torch.equal(got, run())
    ptr = fm.build_slot_plan(m, n_out, p["n"], p["bn"], p["chunk"])["dst_ptr"]
    empty = ptr[1:] == ptr[:-1]
    if bool(empty.any()):
        assert float(got[empty].abs().max()) == 0.0
    return _kernels_run(run)


@pytest.mark.gpu
@pytest.mark.parametrize("case", F32_CASES, ids=F32_IDS)
def test_cuda_fwd_f32_pass_takes_each_width(cuda_device, case):
    """Every CASES width the forward's f32 tile pass takes (one to nine
    consumer warps, padding lanes in their irrep warps, an odd run of
    irreps), on a ragged batch (padding slots, a slot_cap tail, rows with
    no slot): against the plain version at 1e-5, bit for bit on a second
    call, through the f32 tile pass and not the walk kernel."""
    assert fm.f32_route("message_fwd", "float32", *case)
    p = _problem(cuda_device, *case, n_mols=60, odd_tail=5)
    assert _fwd_route32(p) == 3
    names = _fwd_f32_checks(p)
    assert "message_fwd_f32_kernel" in names and "message_fwd_kernel" not in names


@pytest.mark.gpu
def test_cuda_fwd_f32_pass_ring_wraps_and_tails(cuda_device):
    """Flagship widths on a batch of many more tiles per block than ring
    stages, with a 40-atom molecule (rows of 39 slots: a destination's run
    over five tiles), a slot count that is no multiple of the tile, padding
    slots and slots past the covered chunk range; then on fewer rows than
    x has (n_out below x's rows, as in the halo and ghost layouts): against
    the plain version at 1e-5, bit for bit on a second call."""
    p = _problem(cuda_device, *CASES[2], n_mols=480, odd_tail=5, dense=40)
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    ni, h, hp, d, dp, sdp, kw, kf = fm._launch_dims(*CASES[2])
    nst = fm._f32_layout("message_fwd", ni, CASES[2][2], d, kw, kf)[1]
    assert int(p["mask"].sum()) // fm.F32_BT // n_sm > 2 * nst
    m = p["meta"]
    assert p["chunk"] * int(m[4][-1] + m[5][-1]) + 16 < p["mask"].shape[0]
    _fwd_f32_checks(p)
    assert _fwd_route32(p, p["n"] - 37) == 3
    _fwd_f32_checks(p, p["n"] - 37)


@pytest.mark.gpu
def test_cuda_fwd_f32_pass_trailing_rows_without_slots(cuda_device):
    """A batch padded to 512-row blocks, as bench.py's is: its last 571
    rows have no slot, more than one block's share of rows and slots, so
    the run is cut among several blocks (a row weighs as one slot): every
    row written, those without a slot exactly zero, against the plain
    version at 1e-5, bit for bit on a second call."""
    p = _problem(cuda_device, *CASES[2], n_mols=60, odd_tail=5, bn=512, chunk=512)
    ptr = fm.build_slot_plan(p["meta"], p["n"], p["n"], p["bn"], p["chunk"])["dst_ptr"]
    trailing = p["n"] - 1 - int(torch.nonzero(ptr[1:] > ptr[:-1]).max())
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert trailing > 2 * (int(ptr[-1]) + p["n"]) // n_sm
    assert _fwd_route32(p) == 3
    _fwd_f32_checks(p)


@pytest.mark.gpu
def test_cuda_fwd_f32_pass_zero_slots(cuda_device):
    """A call with no slot, on the f32 tile pass: every row zero; and a
    batch of fewer rows than the card has SMs (a block per row, most rows
    without a slot)."""
    p = _problem(cuda_device, *CASES[2])
    z = torch.zeros(0, dtype=torch.int32, device=cuda_device)
    n = p["n"]
    ptr = torch.zeros(n + 1, dtype=torch.int32, device=cuda_device)
    plan = {"slot_src": z, "slot_dst": z, "dst_ptr": ptr, "dst_slots": z, "dst_pos": z,
            "src_ptr": ptr.clone(), "src_slots": z, "src_pos": z}
    meta = tuple(p["meta"][:7]) + (plan,)
    out = fm.message_fwd_cuda(p["x"], p["ef"][:0].contiguous(), p["wf"], meta, *p["statics"],
                              n, p["bn"], p["chunk"], "float32")
    torch.cuda.synchronize()
    assert out.shape == (n, 640) and float(out.abs().max()) == 0.0
    q = _problem(cuda_device, *CASES[2], n_mols=2)
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert q["n"] < n_sm and _fwd_route32(q) == 3
    _fwd_f32_checks(q)


@pytest.mark.gpu
@pytest.mark.parametrize("bn", [256, 512])
def test_cuda_fwd_f32_pass_halo_shard_layout(cuda_device, bn):
    """Shard 0 of 4 of a periodic box in HaloCalculator's layout (local and
    halo rows in one window, chunk 1024), flagship widths, f32: the
    forward's f32 tile pass against the plain version, on all of the
    window's rows and on its first n_local rows."""
    from xequinet_torch.parallel import halo as hm

    rng = np.random.default_rng(3)
    n = 3000
    lx = n * 0.15
    cell = np.diag([lx, 16.0, 16.0])
    pos = np.column_stack([(np.arange(n) * 0.15 + rng.normal(size=n) * 0.5) % lx,
                           rng.uniform(0, 16.0, size=(n, 2))])
    z = rng.integers(1, 9, size=n).astype(np.int32)
    stacked, geom, _, _, _, _ = hm.prepare_halo_system(z, pos, 5.0, 4, cell=cell,
                                                       pbc=np.array([True] * 3))
    bn = min(bn, geom["n_local"])
    stacked, _, _ = hm.apply_halo_kernel_layout(stacked, geom,
                                                {"block_nodes": bn, "chunk": 1024},
                                                margin=1.3)
    shard = {k: v[0] for k, v in stacked.items()}
    shard[keys.POSITIONS] = np.zeros((geom["window"], 3), np.float32)
    p = _operands(cuda_device, shard, "128x0e+64x1o+32x2e", 20, 128, rng, bn, 1024)
    assert geom["halo"] > 0 and _fwd_route32(p) == 3
    _fwd_f32_checks(p)
    _fwd_f32_checks(p, geom["n_local"])


@pytest.mark.gpu
@pytest.mark.parametrize("bn", [256, 512])
def test_cuda_fwd_f32_pass_periodic_ghost_layout(cuda_device, bn):
    """The MD hot loop's periodic ghost layout (chunk 1024, a wide window),
    f32: the forward's f32 tile pass against the plain version, on all rows
    and on the real (non-ghost) ones' count."""
    p, plan = _ghost_problem(cuda_device, bn)
    assert plan["n_ghosts"] > 0 and _fwd_route32(p) == 3
    _fwd_f32_checks(p)
    _fwd_f32_checks(p, p["n"] - plan["n_ghosts"])


@pytest.mark.gpu
@pytest.mark.parametrize("case", F32_REFUSED, ids=("h640", "kf33", "h1152"))
def test_cuda_fwd_f32_refused_widths_keep_the_walk_kernel(cuda_device, case):
    """The widths the forward's f32 tile pass refuses keep the walk kernel:
    against the plain version in f32 at 1e-5, on the walk route."""
    assert not fm.f32_route("message_fwd", "float32", *case)
    p = _problem(cuda_device, *case, n_mols=20, odd_tail=5)
    assert _fwd_route32(p) == 0
    names = _fwd_f32_checks(p)
    assert "message_fwd_kernel" in names and "message_fwd_f32_kernel" not in names


@pytest.mark.gpu
def test_cuda_fwd_f32_phase_probe_counts_cycles(cuda_device):
    """The phase probe's stamped instance of the forward's f32 pass runs at
    the flagship widths, stamps cycles for every block's consumer warps and
    producer, and counts no launch in LAUNCHES; other dtypes are refused."""
    p = _problem(cuda_device, *CASES[2], n_mols=60)
    m = p["meta"]
    args = (p["x"], p["ef"], p["wf"], m, *p["statics"], p["n"], p["bn"], p["chunk"])
    fm.reset_launch_counts()
    stamps = fm.f32_phase_stamps("message_fwd", *args, "float32")
    torch.cuda.synchronize()
    assert fm.LAUNCHES == _counts()
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    n_cw = fm.f32_units(*CASES[2])[1]
    assert stamps.shape == (min(n_sm, p["n"]), n_cw + 1, 8)
    assert int(stamps.min()) >= 0 and bool((stamps.sum(-1) > 0).all())
    with pytest.raises(ValueError, match="f32_route"):
        fm.f32_phase_stamps("message_fwd", *args, "bfloat16")


@pytest.mark.gpu
def test_cuda_fwd_f32_pass_split_runs_of_one_l(cuda_device):
    """Irreps of one l in two runs (8x0e+4x1o+8x0e): the l = 0 warp's
    units hold irreps of both runs, so its output columns are not one run
    of the row: against the plain version at 1e-5, bit for bit on a second
    call, on the f32 tile pass."""
    case = ("8x0e+4x1o+8x0e", 8, 16)
    assert fm.f32_route("message_fwd", "float32", *case)
    p = _problem(cuda_device, *case, n_mols=60, odd_tail=5)
    assert _fwd_route32(p) == 3
    assert "message_fwd_f32_kernel" in _fwd_f32_checks(p)
