"""Smoke run of the PyTorch / CUDA port (xequinet_torch) on one GPU.

    python3 chip_smoke.py                  # on a machine with a CUDA card
    python3 chip_smoke.py --profile DIR    # also trace forward+forces and a
                                           # train step with torch.profiler
    python3 chip_smoke.py --cpu-rehearsal  # tiny CPU run of phases 3-5
                                           # with the plain versions

Phases (any failed check exits non-zero):
  1. device: the nvidia-smi name / power-limit line; fails without CUDA.
  2. build: nvcc builds every kernel from xequinet_torch/csrc (sm_90a),
     one process per source, started together; prints seconds and the
     ptxas register / shared-memory report.
  3. kernel vs plain: a bench-shaped batch (bench.py build_batch recipe,
     rng 1234, 1024 molecules of 12-28 atoms, BN 512, chunk 512, pad 32),
     flagship widths, f32 and bf16: the forward kernel against its plain
     version, the backward kernel against the plain VJP on dx, d_ef, d_wf,
     the second-order kernel against the plain double VJP on d2x, d2ef,
     d2wf, d2g, with no cotangent on d_wf (force training) and a random one.
  4. inference: flagship XPaiNN (FLAGSHIP_KW of bench.py, seeded weights)
     served by InferenceEngine.predict on the card through the kernels:
     launch counts (3 + 3 + 0 per predict with forces, 3 + 0 + 0 energy
     only), finite outputs, agreement with the plain route on the card
     (bf16: energies and mean |F|; f32: also every force component), and in
     f32 the plain route on the CPU as a second reference.
  5. training: flagship XPaiNN at full width and depth trains on the same
     batch (bench.py's recipe: {energy: 1, forces: 10} l2, AdamW, cosine
     schedule with warmup, grad clip 5.0, EMA 0.999): 3 + 6 + 3 launches per
     step, finite loss and gradients, a falling loss over 20 steps; one f32
     step on the kernel route against one on the plain route from the same
     weights; then run_train from an overrides dict on an XDB dataset of
     bench-recipe molecules it writes to a temporary directory, 2 epochs on
     the kernels, its last checkpoint served by InferenceEngine.
  6. times on the card (CUDA events): each kernel and its plain version,
     the bound (bytes and operations the function needs on this batch),
     the predict wall time and edges/s, the flagship train step's ms,
     edges/s and peak memory.
Then one JSON line with the kernels, the card line, and last the device
JSON line.  It imports nothing of JAX or of the JAX package.
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

# flagship configuration (bench.py FLAGSHIP_KW) and its kernel layout
FLAGSHIP_KW = dict(
    node_dim=128, node_irreps="128x0e+64x1o+32x2e", embed_basis="one-hot",
    num_basis=20, action_blocks=3, output_modes=["energy"], remat=False,
    compute_dtype="bfloat16", update_compute_dtype="bfloat16",
    use_pallas_scatter="mega",
)
BN, CHUNK, PAD_NODES, MAX_CHUNKS = 512, 512, 32, 64
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 pipes,
# HBM3 bandwidth
PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# whole-model f32 forces, element-wise: (max |dF| / max |F| over every
# component, 99th percentile of the per-atom |dF| / max |F|).  At random
# weights the model's backward amplifies summation-order differences:
# the plain route alone, card against CPU, differs by 1.0e-3 and 3.4e-5
# (PERF.md); the limits are about 3x and 6x that.  A wrong sign or a
# swapped component of one force moves it by 2 |F_i|; a systematic error
# moves the percentile.
F32_FORCE_TOL = (3e-3, 2e-4)


def fail(msg):
    print(f"FAILED: {msg}", flush=True)
    sys.exit(1)


def card_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return out.stdout.strip().splitlines()[0]
    except Exception as e:  # the card's name still comes from torch below
        return f"nvidia-smi unavailable ({e})"


def build_molecules(n_mols, seed=1234, atoms_lo=12, atoms_hi=28, cutoff=5.0):
    """bench.py build_batch's molecules (same rng draws)."""
    from xequinet_torch.data.datapoint import Datapoint
    from xequinet_torch.ops.radius_graph import radius_graph_np

    rng = np.random.default_rng(seed)
    dps = []
    for _ in range(n_mols):
        n = int(rng.integers(atoms_lo, atoms_hi + 1))
        pos = rng.normal(size=(n, 3)) * (n ** (1 / 3)) * 0.9
        ei, _ = radius_graph_np(pos, cutoff)
        z = rng.integers(1, 9, size=n).astype(np.int32)
        e = float(rng.normal())
        f = rng.normal(size=(n, 3))
        dps.append(Datapoint(z, pos, edge_index=ei, energy=e, forces=f))
    return dps


def layout(bn=BN, chunk=CHUNK):
    return {"block_nodes": bn, "chunk": chunk, "pad_nodes": PAD_NODES,
            "max_chunks": MAX_CHUNKS}


def rel_err(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def time_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def message_problem(batch, device, seed=7, bn=BN, chunk=CHUNK):
    """Flagship-width operands of one message op on the batch's slots."""
    from xequinet_torch import keys
    from xequinet_torch.ops import fused_message as fm
    from xequinet_torch.ops.irreps import Irreps

    irreps = FLAGSHIP_KW["node_irreps"]
    nb, nd = FLAGSHIP_KW["num_basis"], FLAGSHIP_KW["node_dim"]
    _, _, _, _, (h, hp, d, dp, sdp, n_y) = fm.structure_matrices(irreps, nb, nd)
    rng = np.random.default_rng(seed)
    n = batch[keys.POSITIONS].shape[0]
    t = batch[keys.EDGE_MASK].shape[0]
    x_cat = rng.normal(size=(n, hp + dp)).astype(np.float32)
    x_cat[:, h:hp] = 0.0
    x_cat[:, hp + d:] = 0.0
    rbf = rng.normal(size=(t, nb)).astype(np.float32)
    fcut = rng.uniform(0.1, 1.0, size=(t, 1)).astype(np.float32)
    vec = rng.normal(size=(t, 3)).astype(np.float32)
    wf = np.zeros((fm.F_PACK, hp), dtype=np.float32)
    wf[: nb + 1, :h] = rng.normal(size=(nb + 1, h)) / np.sqrt(nb)
    g = rng.normal(size=(n, sdp + dp)).astype(np.float32)
    # cotangents on (dx, d_ef, d_wf), zero where the model's autograd
    # hands in zero (cef columns >= Kf, cwf rows >= Kf and columns >= H)
    kf = nb + 1 + n_y
    cx = rng.normal(size=(n, hp + dp)).astype(np.float32)
    cef = np.zeros((t, fm.F_PACK), dtype=np.float32)
    cef[:, :kf] = rng.normal(size=(t, kf))
    cwf = np.zeros((fm.F_PACK, hp), dtype=np.float32)
    cwf[:kf, :h] = rng.normal(size=(kf, h))
    tt = lambda a: torch.as_tensor(a, device=device)
    ef = fm.pack_edge_features(tt(rbf), tt(fcut), tt(vec), Irreps(irreps))
    b = {k: tt(v) for k, v in batch.items()}
    ei = b[keys.EDGE_INDEX]
    slot_meta = (b[keys.K_SRC2], b[keys.K_DST2], ei[1], ei[0], b[keys.K_CHUNK_BASE],
                 b[keys.K_NCHUNKS], b[keys.K_WSTARTS])
    # the slot plan is built once per batch on the main path (the first
    # message block), so the kernels are compared and timed with it built
    plan = fm.build_slot_plan(slot_meta, n, n, bn, chunk)
    return dict(x_cat=tt(x_cat), ef=ef.contiguous(), wf=tt(wf), g=tt(g), cx=tt(cx),
                cef=tt(cef), cwf=tt(cwf),
                slot_meta=slot_meta + (plan,), edge_mask=b[keys.EDGE_MASK], n_out=n,
                n_atoms=int(batch[keys.NODE_MASK].sum()), statics=(irreps, nb, nd))


def plain_fwd(p, mm):
    from xequinet_torch.ops import fused_message as fm

    sm = p["slot_meta"]
    return fm.plain_message(p["x_cat"], p["ef"], p["wf"], sm[2], sm[3], p["edge_mask"],
                            *p["statics"], p["n_out"], getattr(torch, mm))


def plain_bwd(p, mm):
    from xequinet_torch.ops import fused_message as fm

    sm = p["slot_meta"]
    return fm.plain_message_bwd(p["x_cat"], p["ef"], p["wf"], p["g"], sm[2], sm[3],
                                p["edge_mask"], *p["statics"], p["n_out"],
                                getattr(torch, mm))


def kernel_fwd(p, mm):
    from xequinet_torch.ops import fused_message as fm

    return fm.message_fwd_cuda(p["x_cat"], p["ef"], p["wf"], p["slot_meta"], *p["statics"],
                               p["n_out"], BN, CHUNK, mm)


def kernel_bwd(p, mm):
    from xequinet_torch.ops import fused_message as fm

    return fm.message_bwd_cuda(p["x_cat"], p["ef"], p["wf"], p["g"], p["slot_meta"],
                               *p["statics"], p["n_out"], BN, CHUNK, mm)


def plain_bwd2(p, mm, cwf=None):
    from xequinet_torch.ops import fused_message as fm

    sm = p["slot_meta"]
    return fm.plain_message_bwd2(p["x_cat"], p["ef"], p["wf"], p["g"], p["cx"], p["cef"],
                                 cwf, sm[2], sm[3], p["edge_mask"], *p["statics"],
                                 p["n_out"], getattr(torch, mm))


def kernel_bwd2(p, mm, cwf=None):
    from xequinet_torch.ops import fused_message as fm

    return fm.message_bwd2_cuda(p["x_cat"], p["ef"], p["wf"], p["g"], p["cx"], p["cef"],
                                cwf, p["slot_meta"], *p["statics"], p["n_out"], BN, CHUNK,
                                mm)


def phase_kernels(batch, device):
    """Phase 3: each kernel against its plain version, f32 and bf16."""
    p = message_problem(batch, device)
    abs_err = {}  # bf16 (the flagship dtype): max |kernel - plain|
    for mm in ("float32", "bfloat16"):
        tol = TOL[mm]
        out_k, out_p = kernel_fwd(p, mm), plain_fwd(p, mm)
        torch.cuda.synchronize()
        e = rel_err(out_k, out_p)
        print(f"[kernels] message_fwd {mm}: max|err|/max|ref| = {e:.3e} (limit {tol:g})")
        if not (e <= tol and torch.isfinite(out_k).all()):
            fail(f"message_fwd {mm} disagrees with plain")
        abs_err["message_fwd"] = float((out_k - out_p).abs().max())
        got, want = kernel_bwd(p, mm), plain_bwd(p, mm)
        torch.cuda.synchronize()
        for name, a, b in zip(("dx", "d_ef", "d_wf"), got, want):
            e = rel_err(a, b)
            print(f"[kernels] message_bwd {mm} {name}: max|err|/max|ref| = {e:.3e} "
                  f"(limit {tol:g})")
            if not (e <= tol and torch.isfinite(a).all()):
                fail(f"message_bwd {mm} {name} disagrees with plain")
        abs_err["message_bwd"] = max(float((a - b).abs().max()) for a, b in zip(got, want))
        # second order: no cotangent on d_wf (force training) and a random one
        for cwf_tag, cwf in (("cwf=None", None), ("random cwf", p["cwf"])):
            got, want = kernel_bwd2(p, mm, cwf), plain_bwd2(p, mm, cwf)
            torch.cuda.synchronize()
            for name, a, b in zip(("d2x", "d2ef", "d2wf", "d2g"), got, want):
                e = rel_err(a, b)
                print(f"[kernels] message_bwd2 {mm} {cwf_tag} {name}: max|err|/max|ref| = "
                      f"{e:.3e} (limit {tol:g})")
                if not (e <= tol and torch.isfinite(a).all()):
                    fail(f"message_bwd2 {mm} {cwf_tag} {name} disagrees with plain")
            if float(got[1][~p["edge_mask"]].abs().max()) != 0.0:
                fail("message_bwd2: padding / tail slots got non-zero d2ef rows")
            if cwf is None:
                abs_err["message_bwd2"] = max(float((a - b).abs().max())
                                              for a, b in zip(got, want))
            del got, want
    return p, abs_err


def compare_outputs(tag, got, want, n_graphs, n_atoms, tol, f_tol=None):
    """Per-graph energies and mean |F| within ``tol`` (bench.py's gate);
    with ``f_tol`` = (max, p99) also the forces element-wise."""
    from xequinet_torch import keys

    e_err = rel_err(got[keys.TOTAL_ENERGY][:n_graphs].cpu(),
                    want[keys.TOTAL_ENERGY][:n_graphs].cpu())
    fg = got[keys.FORCES][:n_atoms].cpu()
    fw = want[keys.FORCES][:n_atoms].cpu()
    fa, fb = float(fg.abs().mean()), float(fw.abs().mean())
    f_mean = abs(fa - fb) / max(fb, 1e-30)
    f_max = rel_err(fg, fw)
    atom = ((fg - fw).norm(dim=-1) / fw.abs().max()).numpy()
    q50, q99 = np.quantile(atom, [0.5, 0.99])
    lim = ("none", "none") if f_tol is None else f_tol
    print(f"[slice] {tag}: energy max|err|/max|E| = {e_err:.3e}, mean|F| rel diff "
          f"= {f_mean:.3e} (limit {tol:g}); force max|err|/max|F| = {f_max:.3e} "
          f"(limit {lim[0]}), per-atom |dF|/max|F| median {q50:.3e}, 99th "
          f"percentile {q99:.3e} (limit {lim[1]})")
    if not (e_err <= tol and f_mean <= tol):
        fail(f"{tag}: energies or mean |F| disagree")
    if f_tol is not None and not (f_max <= f_tol[0] and q99 <= f_tol[1]):
        fail(f"{tag}: forces disagree element-wise")


def phase_slice(dps, device):
    """Phase 4: flagship XPaiNN served through the kernels."""
    from xequinet_torch import keys
    from xequinet_torch.models.model import init_params, resolve_model
    from xequinet_torch.ops import fused_message as fm
    from xequinet_torch.run.inference import InferenceEngine

    def engine(dev=device, **over):
        kw = dict(FLAGSHIP_KW, pallas_layout=(BN, CHUNK, PAD_NODES, MAX_CHUNKS), **over)
        module, extra, cutoff = resolve_model("xpainn", **kw)
        init_params(module, seed=0)
        return InferenceEngine(module=module, model_kwargs=kw, extra=extra,
                               cutoff=cutoff, device=dev)

    eng = engine()
    fm.reset_launch_counts()
    res = eng.predict(dps, compute_forces=True)
    torch.cuda.synchronize()
    counts = dict(fm.LAUNCHES)
    print(f"[slice] predict with forces: launches {counts}")
    if counts != {"message_fwd": 3, "message_bwd": 3, "message_bwd2": 0}:
        fail(f"expected 3 + 3 + 0 kernel launches per predict, got {counts}")
    e = np.array([float(r[keys.TOTAL_ENERGY]) for r in res])
    f = np.concatenate([r[keys.FORCES] for r in res])
    if len(res) != len(dps) or f.shape != (sum(d.num_atoms for d in dps), 3):
        fail("predict returned wrong shapes")
    if not (np.isfinite(e).all() and np.isfinite(f).all()):
        fail("non-finite energies or forces")
    print(f"[slice] {len(res)} structures: energy mean {e.mean():.6f}, "
          f"mean|F| {np.abs(f).mean():.6f}")
    launch_counts = counts

    fm.reset_launch_counts()
    res_e = eng.predict(dps, compute_forces=False)
    torch.cuda.synchronize()
    counts = dict(fm.LAUNCHES)
    print(f"[slice] energy-only predict: launches {counts}")
    if counts != {"message_fwd": 3, "message_bwd": 0, "message_bwd2": 0}:
        fail(f"expected 3 + 0 + 0 kernel launches for energy only, got {counts}")
    e2 = np.array([float(r[keys.TOTAL_ENERGY]) for r in res_e])
    if not np.allclose(e2, e, rtol=1e-5, atol=1e-5):
        fail("energy-only predict differs from the predict with forces")

    # same weights through the plain route on the card
    n_g, n_at = len(dps), sum(d.num_atoms for d in dps)
    state = eng.module.state_dict()
    plain = engine(use_pallas_scatter=False)
    plain.module.load_state_dict(state)
    mega_b = eng.collate(dps)
    plain_b = plain.collate(dps)
    got = eng.forward_batch(mega_b)
    want = plain.forward_batch(plain_b)
    compare_outputs("bf16 mega vs plain route", got, want, n_g, n_at, TOL["bfloat16"])
    # f32: the kernels against the plain route on the card, element-wise,
    # and the plain route on the card against itself on the CPU, which
    # shows how far f32 forces move with summation order alone
    f32 = dict(compute_dtype="float32", update_compute_dtype="float32")
    k32, p32 = engine(**f32), engine(use_pallas_scatter=False, **f32)
    c32 = engine(dev="cpu", use_pallas_scatter=False, **f32)
    for e in (k32, p32, c32):
        e.module.load_state_dict(state)
    out_k, out_p = k32.forward_batch(mega_b), p32.forward_batch(plain_b)
    t0 = time.perf_counter()
    out_c = c32.forward_batch(plain_b)
    print(f"[slice] f32 plain route on the CPU: {time.perf_counter() - t0:.1f} s")
    compare_outputs("f32 plain route, card vs CPU", out_p, out_c, n_g, n_at, 1e-4)
    compare_outputs("f32 mega vs plain route on the card", out_k, out_p, n_g, n_at, 1e-4,
                    F32_FORCE_TOL)
    compare_outputs("f32 mega on the card vs plain route on the CPU", out_k, out_c, n_g,
                    n_at, 1e-4, F32_FORCE_TOL)
    cotangent_scales(p32, plain_b)
    return eng, launch_counts


TRAIN_WEIGHTS = {"energy": 1.0, "forces": 10.0}
# per-parameter f32 gradient limit of the kernel route against the plain
# route: GRAD_TOL + GRAD_ULP_FACTOR x the plain route's own change when the
# positions move by one f32 ulp (x (1 + 1e-7)).  At random weights the
# force loss's parameter gradient is that ill-conditioned (the equivariant
# LayerNorm after the first message block divides by a small RMS); on the
# CPU the JAX package's step sits at 0.65 of that change from the port's
# (tests/test_torch_training.py).  A wrong sign or a dropped term moves a
# gradient by its own size.
GRAD_TOL, GRAD_ULP_FACTOR = 1e-4, 2.0


def train_model(device, **over):
    """Flagship XPaiNN with seeded weights, its forward for training and
    the step core of bench.py's recipe."""
    from xequinet_torch.models.model import init_params, resolve_model
    from xequinet_torch.models.properties import make_forward
    from xequinet_torch.training.loss import ErrorMetric, WeightedLoss
    from xequinet_torch.training.lr_schedule import resolve_lr_schedule, resolve_optimizer
    from xequinet_torch.training.trainer import make_step_core

    kw = dict(FLAGSHIP_KW, pallas_layout=(BN, CHUNK, PAD_NODES, MAX_CHUNKS))
    kw.update(over)
    module, extra, _ = resolve_model("xpainn", **kw)
    init_params(module, seed=0)
    module = module.to(device)
    params = list(module.parameters())
    opt = resolve_optimizer("adamw", params)
    sched = resolve_lr_schedule("cosine_annealing", 5e-4, 10000, warmup_steps=100)
    forward = make_forward(module, extra, create_graph=True)
    step = make_step_core(forward, WeightedLoss("l2", **TRAIN_WEIGHTS), params, opt, sched,
                          True, False, 5.0, 0.999, ErrorMetric("energy", "forces"))
    return module, forward, step, [p.detach().clone() for p in params]


def model_grads(module, forward, batch, pos_scale=1.0):
    from xequinet_torch import keys
    from xequinet_torch.training.loss import WeightedLoss
    from xequinet_torch.training.trainer import loss_and_grads

    b = dict(batch)
    b[keys.POSITIONS] = b[keys.POSITIONS] * pos_scale
    named = list(module.named_parameters())
    loss, _, _, grads = loss_and_grads(forward, WeightedLoss("l2", **TRAIN_WEIGHTS),
                                       [p for _, p in named], b, True, False)
    return float(loss.detach()), {n: g for (n, _), g in zip(named, grads)}


def phase_training(dps, batch, device, card):
    """Phase 5: flagship training on the card.  Returns (launches per
    train step, the step function and its inputs for phase 6)."""
    from xequinet_torch.data.batching import collate
    from xequinet_torch.ops import fused_message as fm
    from xequinet_torch.run.inference import batch_to_device

    b = batch_to_device(batch, device)
    module, forward, step, ema = train_model(device)
    loss0, _ = model_grads(module, forward, b)
    fm.reset_launch_counts()
    loss, _ = step(b, 0, 1.0, ema)
    torch.cuda.synchronize()
    counts = dict(fm.LAUNCHES)
    print(f"[train] flagship bf16 train step: launches {counts}")
    # per block: the forward, the backward that makes the forces, the
    # second order of the parameter-gradient pass, and the backward again
    # in that pass (the cotangent on the block's aggregate, from the energy
    # term and through the later blocks' second derivatives), as the JAX
    # package's train step runs its kernels (tests/test_torch_training.py)
    if counts != {"message_fwd": 3, "message_bwd": 6, "message_bwd2": 3}:
        fail(f"expected 3 + 6 + 3 kernel launches per train step, got {counts}")
    if not (np.isfinite(float(loss)) and all(torch.isfinite(p).all()
                                              for p in module.parameters())):
        fail("non-finite loss or parameters after a train step")
    _, grads = model_grads(module, forward, b)
    bad = [n for n, g in grads.items() if not torch.isfinite(g).all()]
    if bad or not np.isfinite(loss0):
        fail(f"non-finite gradients: {bad[:5]}")
    for i in range(1, 20):
        step(b, i, 1.0, ema)
    loss20, _ = model_grads(module, forward, b)
    print(f"[train] loss on the fixed batch: {loss0:.6f} before, {loss20:.6f} after 20 steps")
    if not loss20 < loss0:
        fail("the training loss did not fall over 20 steps")

    # f32: one step's loss and gradients, kernel route against plain route
    f32 = dict(compute_dtype="float32", update_compute_dtype="float32")
    plain_batch = batch_to_device(collate(dps), device)
    mk, fk, _, _ = train_model(device, **f32)
    mp, fp, _, _ = train_model(device, use_pallas_scatter=False, **f32)
    mp.load_state_dict(mk.state_dict())
    lk, gk = model_grads(mk, fk, b)
    lp, gp = model_grads(mp, fp, plain_batch)
    _, gp_nudged = model_grads(mp, fp, plain_batch, 1.0 + 1e-7)
    print(f"[train] f32 kernel and plain route steps: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB — {card}")
    rel = abs(lk - lp) / abs(lp)
    worst, worst_ratio = "", 0.0
    for n, g in gp.items():
        scale = max(float(g.abs().max()), 1e-30)
        limit = GRAD_TOL + GRAD_ULP_FACTOR * float((gp_nudged[n] - g).abs().max()) / scale
        err = float((gk[n] - g).abs().max()) / scale
        if err / limit > worst_ratio:
            worst, worst_ratio = n, err / limit
        if err > limit:
            fail(f"f32 train step: gradient of {n} differs by {err:.3e} of its max "
                 f"(limit {limit:.3e})")
    print(f"[train] f32 step, kernel vs plain route: loss rel diff {rel:.3e} (limit 1e-4); "
          f"every parameter gradient within its limit, the closest {worst} at "
          f"{worst_ratio:.3f} of it")
    if rel > 1e-4:
        fail("f32 train step: loss differs between kernel and plain route")
    del mk, mp, gk, gp, gp_nudged
    torch.cuda.empty_cache()
    return counts, step, b, ema


def phase_entry_point(device, card):
    """Phase 5, continued: run_train from an overrides dict on an XDB dataset
    of bench-recipe molecules, 2 epochs on the kernels; its last checkpoint
    served by InferenceEngine on the card."""
    import os
    import tempfile

    from xequinet_torch import keys
    from xequinet_torch.data.store import create_dataset
    from xequinet_torch.ops import fused_message as fm
    from xequinet_torch.run.inference import InferenceEngine
    from xequinet_torch.run.train import run_train
    from xequinet_torch.utils.config import load_config

    dps = build_molecules(320, seed=99)
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        create_dataset(os.path.join(tmp, "db"), dps, units={})
        over = {
            "model": {"model_kwargs": dict(
                FLAGSHIP_KW, pallas_layout=(BN, CHUNK, PAD_NODES, MAX_CHUNKS))},
            "data": {"db_path": os.path.join(tmp, "db"), "targets": ["energy", "forces"],
                     "batch_size": 32, "valid_batch_size": 32},
            "trainer": {"max_epochs": 2, "warmup_epochs": 1, "lossfn": "l2",
                        "losses_weight": TRAIN_WEIGHTS, "ema_decay": 0.999, "grad_clip": 5.0,
                        "save_dir": os.path.join(tmp, "out"), "log_steps": 4, "seed": 0},
        }
        fm.reset_launch_counts()
        t0 = time.perf_counter()
        tr = run_train(load_config(overrides=over))
        torch.cuda.synchronize()
        counts = dict(fm.LAUNCHES)
        print(f"[train] run_train: 2 epochs, {tr.step} steps in "
              f"{time.perf_counter() - t0:.1f} s on {tr.device}, launches {counts} — {card}")
        if tr.device.type != "cuda" or counts["message_bwd2"] != 3 * tr.step or \
                min(counts.values()) == 0:
            fail(f"run_train did not train through the kernels: {counts}")
        eng = InferenceEngine(os.path.join(tmp, "out", "xequinet_last.ckpt"))
        fm.reset_launch_counts()
        res = eng.predict(dps[:8])
        torch.cuda.synchronize()
        f = np.concatenate([r[keys.FORCES] for r in res])
        print(f"[train] last checkpoint served on {eng.device}: 8 structures, launches "
              f"{dict(fm.LAUNCHES)}, mean|F| {np.abs(f).mean():.6f}")
        if not (np.isfinite(f).all() and fm.LAUNCHES["message_bwd"] == 3):
            fail("the trained checkpoint did not serve through the kernels")


def cotangent_scales(eng, batch):
    """The largest |dE/d node features| after each block (forces pass):
    the scale of the backward's cotangents, against which a last-bit
    difference of the forward becomes a force difference."""
    from xequinet_torch import keys

    seen = {}

    def hook(name):
        def f(mod, inp, out):
            for kk in (keys.NODE_INVARIANT, keys.NODE_EQUIVARIANT):
                if out[kk].requires_grad:
                    out[kk].register_hook(
                        lambda g, kk=kk: seen.__setitem__((name, kk), float(g.abs().max())))
        return f

    blocks = list(eng.module.blocks.named_children())
    handles = [m.register_forward_hook(hook(n)) for n, m in blocks]
    eng.forward_batch(batch)
    for h in handles:
        h.remove()
    for n, m in blocks:
        s, v = seen.get((n, keys.NODE_INVARIANT)), seen.get((n, keys.NODE_EQUIVARIANT))
        if s is not None:
            v = "none" if v is None else f"{v:.4g}"
            print(f"[slice] f32 plain route, max |dE/d features| after block {n} "
                  f"({type(m).__name__}): scalar {s:.4g}, equivariant {v}")


def kernel_costs(p, mm):
    """(bytes, flops) each function (forward, backward, second order) needs
    on these inputs: only the live
    part of each operand (the real atoms' H + D columns of x_cat, the
    real edges' kf = nb+1+nY columns of ef, the kw = nb+1 live rows and H
    columns of wf_aug, the node_dim + D live columns of the cotangent and
    of the aggregate), each input read once and each output written once;
    one source and one destination index per real edge."""
    from xequinet_torch.ops import fused_message as fm

    irreps, nb, nd = p["statics"]
    _, _, _, _, (h, hp, d, dp, sdp, n_y) = fm.structure_matrices(irreps, nb, nd)
    kw, kf = nb + 1, nb + 1 + n_y
    isz = 2 if mm == "bfloat16" else 4
    n_at, n_e = p["n_atoms"], int(p["edge_mask"].sum())
    inputs = (n_at * (h + d) + n_e * kf + kw * h) * isz + 2 * n_e * 4
    fwd_bytes = inputs + n_at * (nd + d) * 4
    fwd_flops = n_e * (2 * kw * h + h + 3 * d + nd + d)
    bwd_bytes = inputs + n_at * (nd + d) * isz + (n_at * (h + d) + n_e * kf + kw * h) * 4
    bwd_flops = n_e * (4 * kw * h + 2 * kf * h + 4 * h + 8 * d)
    # second order, no cotangent on d_wf (force training): reads x, cx, ef,
    # cef, g, wf once, writes d2x, d2ef, d2wf, d2g once; per real edge the
    # closed form's fw and r (4 Kw H), the d2ef filter row (2 Kw H), the d2wf
    # outer products (4 Kf H), a, fo, dfw2, dfwr and the d2x rows (12 H), the
    # lane sums of dfo and u and the d2g / d2x vector rows (16 D) and the
    # scalar d2g row (2 node_dim)
    bwd2_bytes = (2 * n_at * (h + d) + 2 * n_e * kf + n_at * (nd + d) + kw * h) * isz \
        + 2 * n_e * 4 + (n_at * (h + d) + n_e * kf + kf * h + n_at * (nd + d)) * 4
    bwd2_flops = n_e * (6 * kw * h + 4 * kf * h + 12 * h + 16 * d + 2 * nd)
    return (fwd_bytes, fwd_flops), (bwd_bytes, bwd_flops), (bwd2_bytes, bwd2_flops)


def bound_ms(nbytes, flops, mm):
    peak = PEAK_BF16 if mm == "bfloat16" else PEAK_F32
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def profile_call(tag, fn, out_dir, card, calls=3):
    """Where the device time of ``fn`` goes: torch.profiler over ``calls``
    calls after a warm-up; the busy share is the summed kernel time over
    the window's host wall time.  Writes DIR/profile_<tag>.txt."""
    import os

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    avgs = prof.key_averages()
    dev = lambda e: getattr(e, "self_device_time_total", None) or \
        getattr(e, "self_cuda_time_total", 0.0)
    kernels = [e for e in avgs if str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy_ms = sum(dev(e) for e in kernels) / 1e3 / calls
    try:
        table = avgs.table(sort_by="self_device_time_total", row_limit=40)
    except (AttributeError, KeyError):
        table = avgs.table(sort_by="self_cuda_time_total", row_limit=40)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"profile_{tag}.txt"), "w") as fh:
        fh.write(f"{card}\nwall {wall_ms:.3f} ms/call, device busy {busy_ms:.3f} ms/call\n")
        fh.write(table)
    print(f"[profile] {tag}: wall {wall_ms:.3f} ms/call, device kernels {busy_ms:.3f} "
          f"ms/call, idle share {max(0.0, 1 - busy_ms / wall_ms):.3f} — {card}")
    top = sorted(kernels, key=dev, reverse=True)[:15]
    for e in top:
        print(f"[profile]   {dev(e) / 1e3 / calls:9.3f} ms/call  {e.count // calls:5d} calls  "
              f"{e.key[:90]}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", metavar="DIR",
                    help="also trace forward+forces and a train step with "
                         "torch.profiler and write the per-kernel tables to "
                         "DIR/profile_<tag>.txt")
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run phases 3-5 at a tiny size on the CPU with the plain "
                         "versions (never reports ok)")
    args = ap.parse_args()
    if args.cpu_rehearsal:
        return rehearsal()

    # phase 1: device
    card = card_line()
    print(f"[device] {card}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    from xequinet_torch import keys
    from xequinet_torch.data.batching import collate
    from xequinet_torch.ops import fused_message as fm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    print(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    # phase 2: build
    t0 = time.perf_counter()
    info = fm.build_kernels()
    print(f"[build] all kernels in {time.perf_counter() - t0:.1f} s (parallel nvcc)")
    for name, rec in info.items():
        print(f"[build] {name}: {rec['seconds']:.1f} s")
        for line in str(rec["ptxas"]).splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                print(f"[build]   {line.strip()}")

    # phase 3: kernels against their plain versions
    t0 = time.perf_counter()
    dps = build_molecules(1024)
    batch = collate(dps, kernel_layout=layout())
    n_real = int(batch[keys.EDGE_MASK].sum())
    print(f"[batch] {sum(d.num_atoms for d in dps)} atoms, {n_real} edges, "
          f"{batch[keys.EDGE_MASK].shape[0]} slots, {batch[keys.POSITIONS].shape[0]} "
          f"node rows ({time.perf_counter() - t0:.1f} s on the host)")
    p, abs_err = phase_kernels(batch, device)

    # phase 4: inference
    eng, launches = phase_slice(dps, device)

    # phase 5: training
    per_step, step, b, ema = phase_training(dps, batch, device, card)
    phase_entry_point(device, card)

    # phase 6: times (bf16, the flagship's dtype)
    mm = "bfloat16"
    rows = []
    timed = (
        ("message_fwd", "xequinet_torch/csrc/message_fwd.cu",
         "xequinet_tpu/ops/pallas_message.py:177", kernel_fwd, plain_fwd),
        ("message_bwd", "xequinet_torch/csrc/message_bwd.cu",
         "xequinet_tpu/ops/pallas_message.py:331", kernel_bwd, plain_bwd),
        ("message_bwd2", "xequinet_torch/csrc/message_bwd2.cu",
         "xequinet_tpu/ops/pallas_message.py:563", kernel_bwd2, plain_bwd2),
    )
    # inputs already in the kernels' dtype, so the wrappers launch the
    # kernels and nothing else; the second order without a cotangent on
    # d_wf, as force training runs it
    p_mm = dict(p, **{k: p[k].to(getattr(torch, mm))
                      for k in ("x_cat", "ef", "wf", "g", "cx", "cef")})
    for (name, src, rep, kfn, pfn), (nbytes, flops) in zip(timed, kernel_costs(p, mm)):
        k_ms = time_ms(lambda: kfn(p_mm, mm))
        p_ms = time_ms(lambda: pfn(p_mm, mm), iters=5, warmup=1)
        b_ms, b_by = bound_ms(nbytes, flops, mm)
        print(f"[time] {name} ({mm}): kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.2f} GFLOP), launches per predict {launches[name]}, per train "
              f"step {per_step[name]} — {card}")
        # "launches" is this slice's main path (one train step); the two
        # paths' counts stand beside it, each read just after its own reset
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                     "launches": per_step[name], "launches_predict": launches[name],
                     "launches_train_step": per_step[name], "max_abs_err": abs_err[name],
                     "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None})
    # why the second order has a specialisation without the cwf terms:
    # against the general kernel on a materialised zero cwf, interleaved
    # so that the two repeats of each show the noise
    zero_cwf = torch.zeros_like(p_mm["wf"])
    spec = [time_ms(lambda: kernel_bwd2(p_mm, mm))]
    gen = [time_ms(lambda: kernel_bwd2(p_mm, mm, zero_cwf)) for _ in range(2)]
    spec.append(time_ms(lambda: kernel_bwd2(p_mm, mm)))
    print(f"[time] message_bwd2 ({mm}) without cwf {spec[0]:.4f}, {spec[1]:.4f} ms; general "
          f"kernel on a zero cwf {gen[0]:.4f}, {gen[1]:.4f} ms — {card}")
    del p_mm, zero_cwf

    mega_b = eng.collate(dps)
    dev_ms = time_ms(lambda: eng.forward_batch(mega_b), iters=5, warmup=1)
    print(f"[time] device forward+forces on the collated batch: {dev_ms:.3f} ms, "
          f"{n_real / (dev_ms / 1e3):.1f} edges/s — {card}")
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        eng.predict(dps)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))
    print(f"[time] predict wall (neighbour lists + collate + device + host copy), "
          f"median of 3: {wall * 1e3:.1f} ms, {n_real / wall:.1f} edges/s — {card}")

    # the flagship train step: the batch on the device, the slot plan
    # built inside the step (the first message block builds it), each step
    # ending in a synchronize
    i0 = 20
    steps = []
    for i in range(i0, i0 + 7):
        t0 = time.perf_counter()
        step(b, i, 1.0, ema)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
    step_ms = float(np.median(steps)) * 1e3
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    step(b, i0 + 7, 1.0, ema)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"[time] flagship train step (bf16, mega, 3 + 6 + 3 kernels), median of 7: "
          f"{step_ms:.3f} ms (min {min(steps) * 1e3:.3f}, max {max(steps) * 1e3:.3f}), "
          f"{n_real / (step_ms / 1e3):.1f} edges/s; peak device memory "
          f"{peak / 2**30:.3f} GiB, {(peak - held) / 2**30:.3f} GiB above the "
          f"{held / 2**30:.3f} GiB held before the step — {card}")

    if args.profile:
        profile_call("forward_forces", lambda: eng.forward_batch(mega_b), args.profile, card)
        profile_call("train_step", lambda: step(b, i0 + 8, 1.0, ema), args.profile, card)

    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def rehearsal():
    """Phases 3-5 at a tiny size on the CPU: plain versions only."""
    from xequinet_torch import keys
    from xequinet_torch.data.batching import collate
    from xequinet_torch.models.model import init_params, resolve_model
    from xequinet_torch.run.inference import InferenceEngine, batch_to_device

    torch.set_num_threads(2)
    dps = build_molecules(12)
    bn, chunk = 32, 32
    batch = collate(dps, kernel_layout=layout(bn, chunk))
    p = message_problem(batch, "cpu", bn=bn, chunk=chunk)
    for mm in ("float32", "bfloat16"):
        out = plain_fwd(p, mm)
        grads = plain_bwd(p, mm) + plain_bwd2(p, mm) + plain_bwd2(p, mm, p["cwf"])
        assert torch.isfinite(out).all() and all(torch.isfinite(t).all() for t in grads)
    kw = dict(FLAGSHIP_KW, action_blocks=1, pallas_layout=(bn, chunk, PAD_NODES, MAX_CHUNKS))
    module, extra, cutoff = resolve_model("xpainn", **kw)
    init_params(module, seed=0)
    eng = InferenceEngine(module=module, model_kwargs=kw, extra=extra, cutoff=cutoff,
                          device="cpu")
    res = eng.predict(dps)
    f = np.concatenate([r[keys.FORCES] for r in res])
    assert np.isfinite(f).all() and len(res) == len(dps)
    f32 = dict(kw, compute_dtype="float32", update_compute_dtype="float32")
    outs = []
    for kwi in (f32, dict(f32, use_pallas_scatter=False)):
        module, extra, cutoff = resolve_model("xpainn", **kwi)
        init_params(module, seed=0)
        e = InferenceEngine(module=module, model_kwargs=kwi, extra=extra, cutoff=cutoff,
                            device="cpu")
        b = e.collate([e.transform(d) for d in dps])
        outs.append(e.forward_batch(b))
    cotangent_scales(e, b)
    compare_outputs("f32 mega vs plain route on the CPU", *outs, len(dps),
                    sum(d.num_atoms for d in dps), 1e-4, F32_FORCE_TOL)
    # one tiny train step of bench.py's recipe through the plain versions
    module, forward, step, ema = train_model(
        "cpu", action_blocks=1, pallas_layout=(bn, chunk, PAD_NODES, MAX_CHUNKS))
    tb = batch_to_device(batch, "cpu")
    loss0, _ = model_grads(module, forward, tb)
    loss, _ = step(tb, 0, 1.0, ema)
    assert np.isfinite(float(loss)) and all(torch.isfinite(q).all() for q in module.parameters())
    print(f"[rehearsal] one train step on the CPU: loss {float(loss):.6f}")
    for (nbytes, flops), name in zip(kernel_costs(p, "bfloat16"), ("fwd", "bwd", "bwd2")):
        print(f"[rehearsal] message_{name} needs {nbytes / 1e6:.3f} MB, "
              f"{flops / 1e9:.4f} GFLOP at this size")
    print(f"[rehearsal] {len(dps)} structures on the CPU: plain message op, predict and "
          f"a train step ran (not a device result)")


if __name__ == "__main__":
    main()
