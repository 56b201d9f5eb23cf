"""Smoke run of the PyTorch / CUDA port (xequinet_torch) on one GPU.

    python3 chip_smoke.py                  # on a machine with a CUDA card
    python3 chip_smoke.py --profile DIR    # also trace forward+forces and a
                                           # train step of each route with
                                           # torch.profiler
    python3 chip_smoke.py --cpu-rehearsal  # tiny CPU run of phases 3-5
                                           # with the plain versions

Phases (any failed check exits non-zero):
  1. device: the nvidia-smi name / power-limit line; fails without CUDA.
  2. build: nvcc builds every kernel from xequinet_torch/csrc (sm_90a),
     one process per source (five), started together; prints seconds and
     the ptxas register / shared-memory report.
  3. kernel vs plain: a bench-shaped batch (bench.py build_batch recipe,
     rng 1234, 1024 molecules of 12-28 atoms, BN 512, chunk 512, pad 32),
     flagship widths, f32 and bf16: the forward kernel against its plain
     version, the backward kernel against the plain VJP on dx, d_ef, d_wf,
     the second-order kernel against the plain double VJP on d2x, d2ef,
     d2wf, d2g, with no cotangent on d_wf (force training) and a random one;
     the v2 gather-scale-scatter at the model's call on the same slots (x
     [24576, 480] f32, w2 on every slot in f32 and in bf16); the v1 one at
     bench_kernels.py run's shape (n 16384, e 163840, d 480, bn 256) with
     [E, D] and [E, 1] weights, and the v1 op's entry point forward and
     backward (one launch).
  4. inference: flagship XPaiNN (FLAGSHIP_KW of bench.py, seeded weights)
     served by InferenceEngine.predict on the card through the kernels:
     on the mega route 3 + 3 + 0 message launches per predict with forces,
     3 + 0 + 0 energy only; on the v2 route (use_pallas_scatter=True) 3 v2
     launches either way; finite outputs, agreement with the plain route on
     the card (bf16: energies and mean |F|; f32: also every force
     component), and in f32 the plain route on the CPU as a second reference.
  5. training: flagship XPaiNN at full width and depth trains on the same
     batch (bench.py's recipe: {energy: 1, forces: 10} l2, AdamW, cosine
     schedule with warmup, grad clip 5.0, EMA 0.999): on the mega route 3 +
     6 + 3 launches per step and a falling loss over 20 steps, on the v2
     route 3 v2 launches per step and a falling loss over 10; finite loss
     and gradients; one f32 step on each kernel route against one on the
     plain route from the same weights; then run_train from an overrides
     dict on an XDB dataset of bench-recipe molecules it writes to a
     temporary directory, 2 epochs on the mega kernels, its last checkpoint
     served by InferenceEngine.
  6. times on the card (CUDA events): each kernel and its plain version,
     the bound (bytes and operations the function needs on these inputs),
     the library yardstick where one PyTorch call computes the same
     function (torch.sparse.mm for the v1 op at an [E, 1] weight, timed in
     turns with the kernel), the backward's and the second order's split
     per launch (tile pass, row passes, reduction; torch.profiler) and
     their scratch bytes, each
     route's device forward+forces, the mega predict wall time and
     edges/s, each route's train step ms, edges/s and peak memory.
Then one JSON line with the kernels, the card line, and last the device
JSON line.  It imports nothing of JAX or of the JAX package.
"""

import argparse
import json
import subprocess
import sys
import time
import warnings

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
MESSAGE_KERNELS = ("message_fwd", "message_bwd", "message_bwd2")
# the v2 route (use_pallas_scatter=True) of the same model
V2 = {"use_pallas_scatter": True}
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


def v2_problem(batch, device, seed=11):
    """The v2 kernel's call in the flagship model on the batch's slots: x
    [n, D] f32 (the equivariant state), w2 [T, D] random on every slot
    (padding and tail slots add nothing however large their weight), in
    f32 (the model's) and bf16 (bench_kernels.py make_v2(bfloat16)); the
    slot plan built once, as the first message block builds it."""
    from xequinet_torch import keys
    from xequinet_torch.ops import gather_scatter_v2 as gs2
    from xequinet_torch.ops.irreps import Irreps
    from xequinet_torch.ops.slot_layout import window_size

    d = Irreps(FLAGSHIP_KW["node_irreps"]).dim
    gen = torch.Generator(device=device).manual_seed(seed)
    n, t = batch[keys.POSITIONS].shape[0], batch[keys.EDGE_MASK].shape[0]
    tt = lambda a: torch.as_tensor(a, device=device)
    x = torch.randn((n, d), generator=gen, device=device)
    w2 = torch.randn((t, d), generator=gen, device=device)
    args = tuple(tt(batch[k]) for k in (keys.K_SRC2, keys.K_DST2, keys.K_CHUNK_BASE,
                                        keys.K_NCHUNKS, keys.K_WSTARTS))
    args += (n, BN, CHUNK, window_size(BN, PAD_NODES), MAX_CHUNKS)
    return dict(x=x, w2={"float32": w2, "bfloat16": w2.to(torch.bfloat16)}, args=args,
                plan=gs2.v2_slot_plan(*args[:5], n, n, BN, CHUNK), n=n, d=d,
                n_atoms=int(batch[keys.NODE_MASK].sum()), n_e=int(batch[keys.EDGE_MASK].sum()))


def v2_kernel(p, wdt):
    from xequinet_torch.ops import gather_scatter_v2 as gs2

    return gs2.gather_scale_scatter_v2_cuda(p["x"], p["w2"][wdt], p["plan"], p["n"])


def v2_plain(p, wdt):
    from xequinet_torch.ops import gather_scatter_v2 as gs2

    return gs2.gather_scale_scatter_v2_plain(p["x"], p["w2"][wdt], *p["args"][:8])


def v1_problem(device, n=16384, e=163840, d=480, bn=256):
    """bench_kernels.py run's default problem: its indices (rng 0: sorted
    uniform dst, uniform src; its counts_cap capacity), x and w [E, D]
    drawn on the card, and the [E, 1] weight of w's first column; the CSR
    matrix (dst, src, w[:, 0]) of the library yardstick."""
    from xequinet_torch.ops import gather_scatter as gs1

    rng = np.random.default_rng(0)
    dst = np.sort(rng.integers(0, n, size=e)).astype(np.int32)
    src = rng.integers(0, n, size=e).astype(np.int32)
    counts_cap = int(e / (n / bn) * 2.5 + 64)  # bench_kernels.py counts_cap
    starts, counts = gs1.prepare_blocks(dst, n, bn, counts_cap)
    tt = lambda a: torch.as_tensor(a, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((n, d), generator=gen, device=device)
    w = torch.randn((e, d), generator=gen, device=device)
    w_cols = {"[E, D]": w, "[E, 1]": w[:, :1].contiguous()}
    # duplicate (dst, src) pairs summed into one entry: the same sum
    coo = torch.sparse_coo_tensor(torch.stack([tt(dst).long(), tt(src).long()]),
                                  w_cols["[E, 1]"][:, 0], (n, n), check_invariants=False)
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        csr = coo.coalesce().to_sparse_csr()
    return dict(x=x, src=tt(src), dst=tt(dst), w=w_cols, starts=tt(starts),
                counts=tt(counts), n=n, e=e, d=d, bn=bn, csr=csr)


def v1_args(q, wk):
    return (q["x"], q["src"], q["dst"], q["w"][wk], q["starts"], q["counts"], q["n"], q["bn"])


def v1_kernel(q, wk):
    from xequinet_torch.ops import gather_scatter as gs1

    return gs1.gather_scale_scatter_cuda(*v1_args(q, wk))


def v1_plain(q, wk):
    from xequinet_torch.ops import gather_scatter as gs1

    return gs1.gather_scale_scatter_plain(*v1_args(q, wk))


def v1_library(q):
    """One PyTorch call of the same function at the [E, 1] weight: the
    sparse product of the CSR matrix (dst, src, w) with x.  Timed as a
    yardstick only; the port never calls it."""
    return torch.sparse.mm(q["csr"], q["x"])


def phase_scatter_kernels(batch, device):
    """Phase 3, continued: the v2 kernel against its plain version at the
    model's flagship call (w2 in f32 and in bf16), the v1 kernel at
    bench_kernels.py run's shape ([E, D] and [E, 1] weights), and the
    library yardstick against the v1 kernel at [E, 1].  Returns the two
    problems and max |kernel - plain| per case."""
    pv2 = v2_problem(batch, device)
    abs_err = {}
    for wdt in ("float32", "bfloat16"):
        got, want = v2_kernel(pv2, wdt), v2_plain(pv2, wdt)
        torch.cuda.synchronize()
        e = rel_err(got, want)
        print(f"[kernels] gather_scatter_v2 w2 {wdt}: max|err|/max|ref| = {e:.3e} "
              f"(limit {TOL[wdt]:g})")
        if not (e <= TOL[wdt] and torch.isfinite(got).all()):
            fail(f"gather_scatter_v2 w2 {wdt} disagrees with plain")
        abs_err[("gather_scatter_v2", wdt)] = float((got - want).abs().max())
        del got, want
    q = v1_problem(device)
    for wk in ("[E, D]", "[E, 1]"):
        got, want = v1_kernel(q, wk), v1_plain(q, wk)
        torch.cuda.synchronize()
        e = rel_err(got, want)
        print(f"[kernels] gather_scatter w {wk}: max|err|/max|ref| = {e:.3e} (limit 1e-05)")
        if not (e <= TOL["float32"] and torch.isfinite(got).all()):
            fail(f"gather_scatter w {wk} disagrees with plain")
        abs_err[("gather_scatter", wk)] = float((got - want).abs().max())
        if wk == "[E, 1]":
            e = rel_err(v1_library(q), got)
            print(f"[kernels] torch.sparse.mm (CSR dst, src, w) vs gather_scatter w [E, 1]: "
                  f"max|err|/max|ref| = {e:.3e} (the same function)")
            if not e <= TOL["float32"]:
                fail("the library yardstick computes another function")
        del got, want
    return pv2, q, abs_err


def phase_v1_op(q):
    """The v1 op through its entry point, ``gather_scale_scatter`` (the
    call bench_kernels.py run times), forward and backward on the card;
    its launches, read just after their own reset."""
    from xequinet_torch.ops import cuda_build
    from xequinet_torch.ops import gather_scatter as gs1

    x = q["x"].clone().requires_grad_()
    cuda_build.reset_launch_counts()
    out = gs1.gather_scale_scatter(x, (q["src"], q["dst"]), q["w"]["[E, D]"],
                                   (q["starts"], q["counts"]), q["n"], q["bn"])
    (gx,) = torch.autograd.grad((out * out).sum(), (x,))
    torch.cuda.synchronize()
    counts = expect_launches("v1 op forward + backward", gather_scatter=1)
    if not (torch.isfinite(out).all() and torch.isfinite(gx).all()):
        fail("v1 op: non-finite output or gradient")
    return counts


def phase_v2_slice(dps, device, refs):
    """Phase 4, continued: flagship XPaiNN with use_pallas_scatter=True
    served by InferenceEngine.predict through the v2 kernel: 3 v2
    launches per predict and none of the message kernels, bench.py's bf16
    aggregates against the plain route, and in f32 the element-wise forces
    against the plain route on the card and on the CPU.  Returns the
    engine and its launches per predict."""
    from xequinet_torch import keys
    from xequinet_torch.ops import cuda_build

    eng = make_engine(device, **V2)
    eng.module.load_state_dict(refs["state"])
    cuda_build.reset_launch_counts()
    res = eng.predict(dps, compute_forces=True)
    torch.cuda.synchronize()
    counts = expect_launches("v2 predict with forces", gather_scatter_v2=3)
    e = np.array([float(r[keys.TOTAL_ENERGY]) for r in res])
    f = np.concatenate([r[keys.FORCES] for r in res])
    if len(res) != len(dps) or f.shape != (refs["n_at"], 3):
        fail("v2 predict returned wrong shapes")
    if not (np.isfinite(e).all() and np.isfinite(f).all()):
        fail("v2: non-finite energies or forces")
    cuda_build.reset_launch_counts()
    eng.predict(dps, compute_forces=False)
    torch.cuda.synchronize()
    expect_launches("v2 energy-only predict", gather_scatter_v2=3)
    n_g, n_at = refs["n_g"], refs["n_at"]
    v2_b = eng.collate(dps)
    if keys.K_SRC2 not in v2_b:
        fail("the v2 engine collated without the slot layout")
    compare_outputs("bf16 v2 vs plain route", eng.forward_batch(v2_b), refs["want_bf16"], n_g,
                    n_at, TOL["bfloat16"])
    k32 = make_engine(device, **V2, **F32)
    k32.module.load_state_dict(refs["state"])
    out_k = k32.forward_batch(v2_b)
    compare_outputs("f32 v2 vs plain route on the card", out_k, refs["out_p"], n_g, n_at, 1e-4,
                    F32_FORCE_TOL)
    compare_outputs("f32 v2 on the card vs plain route on the CPU", out_k, refs["out_c"], n_g,
                    n_at, 1e-4, F32_FORCE_TOL)
    return eng, counts


def scatter_costs(n_rows_live, n_slots_live, d, w_bytes_per_slot):
    """(bytes, flops) of one gather-scale-scatter: the live rows of x read
    once and of out written once (f32), each live slot's weight row and
    its two int32 indices read once, 2 FLOPs per live slot and column."""
    nbytes = 2 * n_rows_live * d * 4 + n_slots_live * (w_bytes_per_slot + 8)
    return nbytes, 2 * n_slots_live * d


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


def make_engine(device, **over):
    """InferenceEngine of flagship XPaiNN (FLAGSHIP_KW with ``over``) on
    seeded weights."""
    from xequinet_torch.models.model import init_params, resolve_model
    from xequinet_torch.run.inference import InferenceEngine

    kw = dict(FLAGSHIP_KW, pallas_layout=(BN, CHUNK, PAD_NODES, MAX_CHUNKS))
    kw.update(over)
    module, extra, cutoff = resolve_model("xpainn", **kw)
    init_params(module, seed=0)
    return InferenceEngine(module=module, model_kwargs=kw, extra=extra, cutoff=cutoff,
                           device=device)


def expect_launches(tag, **want):
    """Fail unless the launch counts since the last reset are ``want``
    (every other kernel at 0)."""
    from xequinet_torch.ops import cuda_build

    counts = dict(cuda_build.LAUNCHES)
    print(f"[launches] {tag}: {counts}")
    if counts != {name: want.get(name, 0) for name in counts}:
        fail(f"{tag}: expected launches {want} (the rest 0), got {counts}")
    return counts


def phase_slice(dps, device):
    """Phase 4: flagship XPaiNN served through the kernels (mega route).
    Returns the engine, its launches per predict and the plain route's
    outputs that the v2 route is compared with."""
    from xequinet_torch import keys
    from xequinet_torch.ops import fused_message as fm

    engine = lambda dev=device, **over: make_engine(dev, **over)
    eng = engine()
    fm.reset_launch_counts()
    res = eng.predict(dps, compute_forces=True)
    torch.cuda.synchronize()
    counts = expect_launches("mega predict with forces", message_fwd=3, message_bwd=3)
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
    expect_launches("mega energy-only predict", message_fwd=3)
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
    refs = dict(state=state, plain_b=plain_b, want_bf16=want, out_p=out_p, out_c=out_c,
                n_g=n_g, n_at=n_at)
    return eng, launch_counts, refs


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


F32 = dict(compute_dtype="float32", update_compute_dtype="float32")


def plain_f32_reference(dps, device):
    """The f32 plain route's weights, loss and parameter gradients on the
    flagship batch (collated without the slot layout), and its gradients
    again with the positions moved by one f32 ulp (x (1 + 1e-7))."""
    from xequinet_torch.data.batching import collate
    from xequinet_torch.run.inference import batch_to_device

    mp, fp, _, _ = train_model(device, use_pallas_scatter=False, **F32)
    pb = batch_to_device(collate(dps), device)
    lp, gp = model_grads(mp, fp, pb)
    _, gp_nudged = model_grads(mp, fp, pb, 1.0 + 1e-7)
    state = {k: v.clone() for k, v in mp.state_dict().items()}
    del mp, pb
    return state, lp, gp, gp_nudged


def f32_step_check(tag, over, b, ref, device, card):
    """One f32 step's loss and parameter gradients on the kernel route
    ``over`` from the plain route's weights, against the plain route's
    (``ref`` from :func:`plain_f32_reference`), under the per-parameter
    limit GRAD_TOL + GRAD_ULP_FACTOR x the plain route's one-ulp change."""
    state, lp, gp, gp_nudged = ref
    mk, fk, _, _ = train_model(device, **F32, **over)
    mk.load_state_dict(state)
    lk, gk = model_grads(mk, fk, b)
    print(f"[train] f32 {tag} and plain route steps: peak device memory "
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
            fail(f"f32 {tag} train step: gradient of {n} differs by {err:.3e} of its max "
                 f"(limit {limit:.3e})")
    print(f"[train] f32 step, {tag} vs plain route: loss rel diff {rel:.3e} (limit 1e-4); "
          f"every parameter gradient within its limit, the closest {worst} at "
          f"{worst_ratio:.3f} of it")
    if rel > 1e-4:
        fail(f"f32 {tag} train step: loss differs between kernel and plain route")
    del mk, gk
    torch.cuda.empty_cache()


def phase_training(tag, over, n_steps, want, b, ref, device, card):
    """Phase 5: flagship bf16 training on the kernel route ``over`` on the
    card: launches per step ``want``, finite loss, parameters and
    gradients, a falling loss over ``n_steps`` steps, and the f32 step
    check.  Returns (launches per train step, the step function and its
    EMA for phase 6)."""
    from xequinet_torch.ops import cuda_build

    module, forward, step, ema = train_model(device, **over)
    loss0, _ = model_grads(module, forward, b)
    cuda_build.reset_launch_counts()
    loss, _ = step(b, 0, 1.0, ema)
    torch.cuda.synchronize()
    counts = expect_launches(f"flagship bf16 {tag} train step", **want)
    if not (np.isfinite(float(loss)) and all(torch.isfinite(p).all()
                                              for p in module.parameters())):
        fail(f"{tag}: non-finite loss or parameters after a train step")
    _, grads = model_grads(module, forward, b)
    bad = [n for n, g in grads.items() if not torch.isfinite(g).all()]
    if bad or not np.isfinite(loss0):
        fail(f"{tag}: non-finite gradients: {bad[:5]}")
    for i in range(1, n_steps):
        step(b, i, 1.0, ema)
    loss_n, _ = model_grads(module, forward, b)
    print(f"[train] {tag}: loss on the fixed batch {loss0:.6f} before, {loss_n:.6f} after "
          f"{n_steps} steps")
    if not loss_n < loss0:
        fail(f"{tag}: the training loss did not fall over {n_steps} steps")
    f32_step_check(tag, over, b, ref, device, card)
    return counts, step, ema


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
                min(counts[k] for k in MESSAGE_KERNELS) == 0 or \
                counts["gather_scatter_v2"] + counts["gather_scatter"] != 0:
            fail(f"run_train did not train through the message kernels: {counts}")
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


# each wrapper's launches by pass (kernel names as torch.profiler shows them)
PASSES = {
    "message_bwd": (("tile pass", "message_bwd_tile_kernel"),
                    ("dx pass", "message_bwd_dx_rows_kernel"),
                    ("d_wf reduction", "xeq_dwf_reduce_kernel")),
    "message_bwd2": (("tile pass", "message_bwd2_tile_kernel"),
                     ("d2x pass", "message_bwd2_d2x_rows_kernel"),
                     ("d2g pass", "message_bwd2_d2g_rows_kernel"),
                     ("d2wf reduction", "xeq_dwf_reduce_kernel")),
}


def pass_split(name, fn, p_mm, mm, card, calls=10):
    """A wrapper's device time per launch by pass (torch.profiler over
    ``calls`` calls of ``fn`` after a warm-up) and its bf16 scratch bytes.
    Returns ({pass: ms per call}, scratch bytes); passes the profiler did
    not see are None."""
    from torch.profiler import ProfilerActivity, profile

    from xequinet_torch.ops import fused_message as fm

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev = lambda e: getattr(e, "self_device_time_total", None) or \
        getattr(e, "self_cuda_time_total", 0.0)
    split = {}
    for tag, kname in PASSES[name]:
        us = sum(dev(e) for e in prof.key_averages() if e.key.startswith(kname))
        split[tag] = us / 1e3 / calls if us else None
    irreps, nb, nd = p_mm["statics"]
    _, _, _, _, (h, _, d, _, _, _) = fm.structure_matrices(irreps, nb, nd)
    t = p_mm["ef"].shape[0]
    shapes = ([fm.bwd_scratch_shape(t, h, d)] if name == "message_bwd"
              else list(fm.bwd2_scratch_shapes(t, h, nd, d)))
    scratch = sum(r * w * 2 for r, w in shapes)
    shown = ", ".join(f"{k} " + ("not measured" if v is None else f"{v:.4f} ms")
                      for k, v in split.items())
    print(f"[time] {name} ({mm}) per launch by pass (torch.profiler, {calls} calls): "
          f"{shown}; scratch " + " + ".join(f"{r} x {w}" for r, w in shapes)
          + f" bf16 = {scratch / 1e6:.1f} MB written once, read once — {card}")
    return split, scratch


def bound_ms(nbytes, flops, mm):
    peak = PEAK_BF16 if mm == "bfloat16" else PEAK_F32
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_train_step(tag, step, b, ema, i0, n_real, card):
    """Host clock around 7 flagship train steps, each ending in a
    synchronize (median), then one more step's peak device memory."""
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
    print(f"[time] flagship train step (bf16, {tag}), median of 7: "
          f"{step_ms:.3f} ms (min {min(steps) * 1e3:.3f}, max {max(steps) * 1e3:.3f}), "
          f"{n_real / (step_ms / 1e3):.1f} edges/s; peak device memory "
          f"{peak / 2**30:.3f} GiB, {(peak - held) / 2**30:.3f} GiB above the "
          f"{held / 2**30:.3f} GiB held before the step — {card}")


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
    from xequinet_torch.run.inference import batch_to_device

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
    pv2, pv1, scatter_err = phase_scatter_kernels(batch, device)
    v1_launches = phase_v1_op(pv1)

    # phase 4: inference, the mega route and the v2 route
    eng, launches, refs = phase_slice(dps, device)
    eng_v2, launches_v2 = phase_v2_slice(dps, device, refs)
    del refs

    # phase 5: training.  Mega: per block the forward, the backward that
    # makes the forces, the second order of the parameter-gradient pass,
    # and the backward again in that pass (the cotangent on the block's
    # aggregate, from the energy term and through the later blocks' second
    # derivatives), as the JAX package's train step runs its kernels
    # (tests/test_torch_training.py).  v2: the kernel is the forward only;
    # its backward is plain ops, as in the JAX package.
    b = batch_to_device(batch, device)
    ref = plain_f32_reference(dps, device)
    per_step, step, ema = phase_training(
        "mega", {}, 20, dict(message_fwd=3, message_bwd=6, message_bwd2=3), b, ref, device,
        card)
    per_step_v2, step_v2, ema_v2 = phase_training(
        "v2", V2, 10, dict(gather_scatter_v2=3), b, ref, device, card)
    del ref
    torch.cuda.empty_cache()
    phase_entry_point(device, card)

    # phase 6: times.  The message kernels in bf16, the flagship's dtype
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
        # "launches" is the mega route's train step; the two paths' counts
        # stand beside it, each read just after its own reset
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                     "launches": per_step[name], "launches_predict": launches[name],
                     "launches_train_step": per_step[name], "max_abs_err": abs_err[name],
                     "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None})
        if name in PASSES:
            rows[-1]["split_ms"], rows[-1]["scratch_bytes"] = pass_split(
                name, lambda: kfn(p_mm, mm), p_mm, mm, card)
    # why the second order has a specialisation without the cwf terms:
    # against the general kernel on a materialised zero cwf, interleaved
    # so that the two repeats of each show the noise
    zero_cwf = torch.zeros_like(p_mm["wf"])
    spec = [time_ms(lambda: kernel_bwd2(p_mm, mm))]
    gen = [time_ms(lambda: kernel_bwd2(p_mm, mm, zero_cwf)) for _ in range(2)]
    spec.append(time_ms(lambda: kernel_bwd2(p_mm, mm)))
    print(f"[time] message_bwd2 ({mm}) without cwf {spec[0]:.4f}, {spec[1]:.4f} ms; general "
          f"kernel on a zero cwf {gen[0]:.4f}, {gen[1]:.4f} ms — {card}")
    del p_mm, zero_cwf, p

    # the gather-scale-scatter kernels, f32 x: v2 at the model's call with
    # w2 in f32 (the model's) and bf16, v1 at bench_kernels.py run's shape
    # with an [E, 1] weight (where one library call computes the same
    # function) and an [E, D] weight
    def scatter_case(tag, kfn, pfn, nbytes, flops, err):
        k_ms = time_ms(kfn)
        p_ms = time_ms(pfn, iters=5, warmup=1)
        b_ms, b_by = bound_ms(nbytes, flops, "float32")
        print(f"[time] {tag}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP) — {card}")
        return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                "max_abs_err": err}

    v2_cases = {
        wdt: scatter_case(f"gather_scatter_v2 (w2 {wdt})", lambda: v2_kernel(pv2, wdt),
                          lambda: v2_plain(pv2, wdt),
                          *scatter_costs(pv2["n_atoms"], pv2["n_e"], pv2["d"],
                                         pv2["d"] * (4 if wdt == "float32" else 2)),
                          scatter_err[("gather_scatter_v2", wdt)])
        for wdt in ("float32", "bfloat16")}
    print(f"[time] gather_scatter_v2: launches per predict {launches_v2['gather_scatter_v2']}, "
          f"per train step {per_step_v2['gather_scatter_v2']} (v2 route)")
    rows.append(dict(
        {"name": "gather_scatter_v2", "route": "cuda",
         "source": "xequinet_torch/csrc/gather_scatter_v2.cu",
         "replaces": "xequinet_tpu/ops/pallas_scatter_v2.py:105",
         "launches": per_step_v2["gather_scatter_v2"],
         "launches_predict": launches_v2["gather_scatter_v2"],
         "launches_train_step": per_step_v2["gather_scatter_v2"]},
        **v2_cases["float32"], library_ms=None,
        library="none: no single PyTorch call gathers, scales by a [T, D] weight and scatters",
        w2_bfloat16=v2_cases["bfloat16"]))
    del pv2
    v1_cases = {
        wk: scatter_case(f"gather_scatter (w {wk})", lambda: v1_kernel(pv1, wk),
                         lambda: v1_plain(pv1, wk),
                         *scatter_costs(pv1["n"], pv1["e"], pv1["d"],
                                        4 * pv1["w"][wk].shape[1]),
                         scatter_err[("gather_scatter", wk)])
        for wk in ("[E, 1]", "[E, D]")}
    # the kernel and the library call at [E, 1] in turns, twice, so that
    # the pairs show the noise; the row keeps the library's first time
    turns = [(time_ms(lambda: v1_kernel(pv1, "[E, 1]")), time_ms(lambda: v1_library(pv1)))
             for _ in range(2)]
    lib_ms = turns[0][1]
    print(f"[time] torch.sparse.mm (CSR dst, src, w) at w [E, 1]: {lib_ms:.4f} ms, beside the "
          f"kernel's {v1_cases['[E, 1]']['ms']:.4f} ms; in turns, kernel / library: "
          + ", ".join(f"{k:.4f} / {l:.4f} ms" for k, l in turns) + f" — {card}")
    rows.append(dict(
        {"name": "gather_scatter", "route": "cuda",
         "source": "xequinet_torch/csrc/gather_scatter.cu",
         "replaces": "xequinet_tpu/ops/pallas_scatter.py:74",
         "launches": v1_launches["gather_scatter"], "launches_predict": 0,
         "launches_train_step": 0, "weight": "[E, 1]"},
        **v1_cases["[E, 1]"], library_ms=lib_ms, library="torch.sparse.mm of CSR (dst, src, w)",
        w_full=dict(v1_cases["[E, D]"], library_ms=None)))
    del pv1

    mega_b = eng.collate(dps)
    v2_b = eng_v2.collate(dps)
    for tag, e, bb in (("mega", eng, mega_b), ("v2", eng_v2, v2_b)):
        dev_ms = time_ms(lambda: e.forward_batch(bb), iters=5, warmup=1)
        print(f"[time] {tag} device forward+forces on the collated batch: {dev_ms:.3f} ms, "
              f"{n_real / (dev_ms / 1e3):.1f} edges/s — {card}")
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        eng.predict(dps)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))
    print(f"[time] mega predict wall (neighbour lists + collate + device + host copy), "
          f"median of 3: {wall * 1e3:.1f} ms, {n_real / wall:.1f} edges/s — {card}")

    # the flagship train step: the batch on the device, the slot plan
    # built inside the step (the first message block builds it), each step
    # ending in a synchronize
    i0 = 20
    time_train_step("mega, 3 + 6 + 3 message kernels", step, b, ema, i0, n_real, card)
    time_train_step("v2, 3 v2 kernels", step_v2, b, ema_v2, i0, n_real, card)

    if args.profile:
        profile_call("forward_forces", lambda: eng.forward_batch(mega_b), args.profile, card)
        profile_call("train_step", lambda: step(b, i0 + 8, 1.0, ema), args.profile, card)
        profile_call("v2_forward_forces", lambda: eng_v2.forward_batch(v2_b), args.profile,
                     card)
        profile_call("v2_train_step", lambda: step_v2(b, i0 + 8, 1.0, ema_v2), args.profile,
                     card)

    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def rehearsal():
    """Phases 3-5 at a tiny size on the CPU: plain versions only."""
    from xequinet_torch import keys
    from xequinet_torch.data.batching import collate
    from xequinet_torch.run.inference import batch_to_device

    torch.set_num_threads(2)
    dps = build_molecules(12)
    bn, chunk = 32, 32
    lay = (bn, chunk, PAD_NODES, MAX_CHUNKS)
    batch = collate(dps, kernel_layout=layout(bn, chunk))
    p = message_problem(batch, "cpu", bn=bn, chunk=chunk)
    for mm in ("float32", "bfloat16"):
        out = plain_fwd(p, mm)
        grads = plain_bwd(p, mm) + plain_bwd2(p, mm) + plain_bwd2(p, mm, p["cwf"])
        assert torch.isfinite(out).all() and all(torch.isfinite(t).all() for t in grads)
    pv2 = v2_problem(batch, "cpu")
    pv2["args"] = pv2["args"][:6] + (bn, chunk) + pv2["args"][8:]
    q = v1_problem("cpu", n=256, e=2048, d=32, bn=32)
    assert torch.isfinite(v2_plain(pv2, "bfloat16")).all()
    assert rel_err(v1_library(q), v1_plain(q, "[E, 1]")) <= TOL["float32"]
    n_at = sum(d.num_atoms for d in dps)
    for over in ({}, V2):
        tag = "v2" if over else "mega"
        eng = make_engine("cpu", action_blocks=2, pallas_layout=lay, **over)
        res = eng.predict(dps)
        f = np.concatenate([r[keys.FORCES] for r in res])
        assert np.isfinite(f).all() and len(res) == len(dps)
        outs = []
        for route in (over, {"use_pallas_scatter": False}):
            e = make_engine("cpu", action_blocks=2, pallas_layout=lay, **F32, **route)
            b = e.collate([e.transform(d) for d in dps])
            assert (keys.K_SRC2 in b) == bool(route["use_pallas_scatter"] if route else True)
            outs.append(e.forward_batch(b))
        compare_outputs(f"f32 {tag} vs plain route on the CPU", *outs, len(dps), n_at, 1e-4,
                        F32_FORCE_TOL)
        # one tiny train step of bench.py's recipe through the plain versions
        module, forward, step, ema = train_model("cpu", action_blocks=1, pallas_layout=lay,
                                                 **over)
        tb = batch_to_device(batch, "cpu")
        loss, _ = step(tb, 0, 1.0, ema)
        assert np.isfinite(float(loss)) and all(torch.isfinite(t).all()
                                                for t in module.parameters())
        print(f"[rehearsal] one {tag} train step on the CPU: loss {float(loss):.6f}")
    cotangent_scales(e, b)
    for (nbytes, flops), name in zip(kernel_costs(p, "bfloat16"), ("fwd", "bwd", "bwd2")):
        print(f"[rehearsal] message_{name} needs {nbytes / 1e6:.3f} MB, "
              f"{flops / 1e9:.4f} GFLOP at this size")
    nbytes, flops = scatter_costs(pv2["n_atoms"], pv2["n_e"], pv2["d"], 4 * pv2["d"])
    print(f"[rehearsal] gather_scatter_v2 needs {nbytes / 1e6:.3f} MB, {flops / 1e9:.4f} GFLOP "
          f"at this size")
    print(f"[rehearsal] {len(dps)} structures on the CPU: plain message and scatter ops, mega "
          f"and v2 predict and train steps ran (not a device result)")


if __name__ == "__main__":
    main()
