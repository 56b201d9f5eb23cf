"""Smoke run of the PyTorch / CUDA port (xequinet_torch) on one GPU.

    python3 chip_smoke.py                  # on a machine with a CUDA card
    python3 chip_smoke.py --profile DIR    # also trace forward+forces and a
                                           # train step of each route with
                                           # torch.profiler
    python3 chip_smoke.py --cpu-rehearsal  # tiny CPU run of phases 3-5
                                           # and 7-16 with the plain versions

Phases (any failed check exits non-zero):
  1. device: the nvidia-smi name / power-limit line; fails without CUDA.
  2. build: nvcc builds every kernel from xequinet_torch/csrc (sm_90a),
     one process per source (six), started together; prints seconds and
     the ptxas register / shared-memory report.
  3. kernel vs plain: a bench-shaped batch (bench.py build_batch recipe,
     rng 1234, 1024 molecules of 12-28 atoms, BN 512, chunk 512, pad 32),
     flagship widths, f32 and bf16: the forward kernel against its plain
     version, the backward kernel against the plain VJP on dx, d_ef, d_wf,
     the second-order kernel against the plain double VJP on d2x, d2ef,
     d2wf, d2g, with no cotangent on d_wf (force training) and a random one;
     the same at four other shapes on the same slots (Kf = 33, num_basis
     23; Kf = 128, num_basis 118; H = 1152, node_dim 256 and
     256x0e+128x1o+64x2e; H = 640, node_dim 192, which the Hopper tile
     passes of the three message kernels refuse and their mma.sync tile
     passes take, message_bwd's with d_wf in registers), each also bit for
     bit on a second call, with the route (Hopper tile pass, tile pass,
     f32 tile pass or walk kernels) each takes;
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
     component), and in f32 the plain route on the CPU as a second reference;
     a batch whose largest molecule (40 atoms) exceeds pad_nodes 32, served
     through the kernels (the engine fits the slot layout to the batch)
     against the plain route; the wide model (num_basis 23, node_dim 256,
     256x0e+128x1o+64x2e) at full width against the plain route.
  5. training: flagship XPaiNN at full width and depth trains on the same
     batch (bench.py's recipe: {energy: 1, forces: 10} l2, AdamW, cosine
     schedule with warmup, grad clip 5.0, EMA 0.999): on the mega route 3 +
     6 + 3 launches per step and a falling loss over 20 steps, on the v2
     route 3 v2 launches per step and a falling loss over 10, the wide
     model on the mega route 3 + 6 + 3 launches and a falling loss over 10;
     finite loss and gradients; one f32 step on each flagship kernel route
     against one on the plain route from the same weights; then run_train
     from an overrides dict on an XDB dataset of bench-recipe molecules it
     writes to a temporary directory, 2 epochs on the mega kernels, its last
     checkpoint served by InferenceEngine.
  6. times on the card (CUDA events): each kernel and its plain version,
     the bound (bytes and operations the function needs on these inputs),
     the library yardstick where one PyTorch call computes the same
     function (torch.sparse.mm for the v1 op at an [E, 1] weight, timed in
     turns with the kernel), the pass each message kernel takes (at the
     flagship widths the Hopper tile passes of message_fwd, message_bwd
     and, without cwf, message_bwd2: the script fails on another), each
     wrapper's split per launch (tile pass, row passes, d_wf pass,
     reduction; torch.profiler) and the backwards' scratch bytes; the
     forward's Hopper pass again bit for bit on a second call and its error
     against the plain version beside the mma.sync pass's on the same
     operands (the phase probe's instance of it); the message kernels' f32
     instances at flagship widths (the f32 tile passes of all three, each
     also against its plain version at 1e-5, bit for bit on a second call
     and split by pass; the script fails if one takes another route) and
     the wide shapes in bf16 and in f32 (on whichever pass each takes)
     beside their bounds, each route's device forward+forces (the wide model's too), the
     mega predict wall time and edges/s, each route's train step ms,
     edges/s and peak memory (the wide model's too; and the flagship's
     mega step in f32, with the share its 3 + 6 + 3 message launches
     take of it at the f32 times above).
  7. MD: (a) bench.py's MD hot loop (md_hotloop_pbc_metric: its
     10,000-atom periodic box, cell diag(1500, 16, 16) A, its rng and
     drift) through Calculator(pallas="mega", skin=0.5, max_atoms=10240,
     max_edges 1.55 x the edges) on a flagship-width checkpoint written
     by the port's trainer: the mega route and 3 + 3 message launches on
     every call, the best of 3 medians of 15 calls and edges/s, rebuilds
     and asynchronous swaps, peak memory, the plain route's ms per call,
     the hot loop's split (message kernels, other device ops, idle share;
     torch.profiler) and one rebuild's host build; mega against plain
     with a bf16 and an f32 checkpoint of the same weights (md_agreement:
     energy, mean |F|, mean |virial|, f32 forces element-wise); (b) the
     same agreement on a 4,000-atom unsorted free chain; (c) run_md from
     an extxyz file it writes, system (b), NVE 100 steps of 0.25 fs at
     f32, skin 0.5, on the mega route (3 + 3 launches per force call) and
     the plain route: the mega route's energy drift per atom within 2x
     the plain route's + 1e-4 eV, ms per step.
  8. XPaiNN-Ewald and the conditioned multi-head XPaiNN, each mega route
     against its plain route on the card: (a) bench.py's pbc_ewald_mega
     path, FLAGSHIP_KW with one Ewald block (num_k_points (3, 3, 3), K =
     171, projection_dim 8) on bench.py's crystal batch (rng 1234, 640
     cells, layout (128, 512, 32, 128)): InferenceEngine.predict with
     forces and virial (3 + 3 launches), bf16 energies, mean |F| and the
     mean |virial| band, f32 energies, forces element-wise and the virial
     mean and element-wise; the device forward+forces+virial, peak memory
     and the Ewald blocks' share of device time (torch.profiler); 10
     training steps on bench.py's recipe with a virial term (3 + 6 + 3
     launches per step, a falling loss) and one f32 step against the
     plain route's; (b) the free variant (k_cutoff 0.4, delta_k 0.2, 20
     k-bases, K = 13) on phase 3's molecules; (c) charge and spin
     embeddings with the energy, charges, dipole, polar and spatial heads
     on the molecules with random integer charges and spins (every head,
     and the f32 charges summing to each graph's charge within 1e-4); (d)
     Calculator(pallas="mega", skin=0.5) of the (a) model on phase 7's
     periodic box after a worker swap against plain Calculators (phase 7's
     md_agreement).
  9. the rest of the model zoo on phase 3's molecules, seeded weights: (a)
     PaiNN and (b) SO3krates at their builders' defaults (node_dim 128 /
     120, 3 blocks, gfn2-xtb aux56, f32; SO3krates 32 channels of l <= 3, 4
     heads), served with forces with no kernel launch, the first 64
     molecules against the port's CPU run of the same weights and against
     a random rotation of themselves (energy 1e-4, forces F32_FORCE_TOL);
     (c) the Cartesian head (order 2, "ij", 32 channels mixed up to l = 4)
     on the flagship XPaiNN, 3 + 3 launches per predict with forces, and
     (d) XMatNet on the flagship backbone (hidden 32x0e+32x1o+32x2e, 2
     matrix layers, def2-SVP's shells H-O: 14 x 14 blocks), 3 launches per
     forward, each mega route against its plain route (f32 1e-4; bf16
     energy and mean |F| 2e-2, the tensor and the blocks within 2e-2 plus
     twice the bf16 plain route's own distance from the f32 plain route)
     and in f32 T(Rx) = R T R^T, B(Rx) = D B D^T within 1e-4; each cell's
     device time (CUDA events; torch.profiler's busy time, idle share and
     the head's share), edges/s and predict wall, and 10 training steps
     (no launch, PaiNN on the molecules without a pair closer than 0.5 A;
     3 + 6 + 3 on {energy, forces, cartesian_tensor}; 3 + 3 + 0 on the
     matrix blocks) with a falling loss, a median of 7 timed steps and the
     peak memory.
 10. the user-facing drivers through ``xequinet_torch.cli.main``, with config
     files written as text and read by the port's own YAML reader, at full
     width on the mega route (FLAGSHIP_KW): (a) ``train -C`` for one epoch on
     an XDB dataset of 320 bench molecules (3 + 6 + 3 launches per step, 3 +
     3 per validation batch), the same config in a subprocess sent SIGTERM
     after its first logged step (exit code 143 and a checkpoint), then
     ``train --resume`` to its end; (b) ``test`` on that checkpoint's test
     split (3 + 3 launches per batch), its MAE and RMSE against the same
     batches through InferenceEngine.forward_batch; (c) ``infer --forces``
     on an extxyz of phase 3's 1024 molecules in chunks of 128 (3 + 3 per
     chunk), each structure against InferenceEngine.predict on the same
     chunks, structures/s and edges/s; (d) ``opt --freq --shermo
     --save-hessian`` with an f32 checkpoint of phase 7's model on 4 of
     phase 3's molecules without a pair under 0.8 A, one of them with a
     $freeze file (no launch: the plain route), energies that fall, frozen
     atoms unmoved, the L-BFGS evaluation rate and one evaluation's device
     share, then on the largest molecule Calculator.hessian on the card
     against the CPU (1e-4 of max |H| + 2x the card's change under a
     one-ulp move), the translational sum rule (1e-3) and analytic_hessian
     against numerical_hessian (the JAX test's atol 5e-3, rtol 1e-2), with
     the Hessian's ms; (e) ``md -C`` on phase 7's 4,000-atom free chain with
     ``pallas: mega``, NVE 20 steps (3 + 3 per force call); (f) IPIDriver
     against a fake i-PI server on localhost, 3 rounds, against
     Calculator.calculate.  The drivers' agreement limits are 1e-6 plus
     twice the reference's own spread over two calls.
 11. determinism, export, data parallelism and profiling, at FLAGSHIP_KW:
     (a) the spread of two identical calls (max |a - b| / max |a| of
     energy, forces, virial and parameter gradients) and the median ms of
     the bf16 mega train step and the f32 plain route's step on phase 3's
     batch, InferenceEngine.predict and one Calculator.calculate on phase
     7's box, with PyTorch's default sums (the port's) and under
     torch.use_deterministic_algorithms (which must repeat bit for bit);
     (b) export_model at 256 atoms and 8192 edges of f32 checkpoints, six
     cases in six spawned processes (energy with the virial on the
     28-atom molecule, periodic on a phase 8 cell, gmx on a 120-atom
     periodic box in nm and kJ/mol with n_edges_found and needed_reps
     checked, dipole and a baked net charge on phase 8 (c)'s heads,
     matrix on phase 9 (d)'s XMatNet), each loaded program (no launch)
     against the plain Calculator or forward: energy 1e-4, forces 3e-3 /
     2e-4, each plus twice the reference's own spread, with the export's
     seconds and the program's ms per call; (c) two spawned ranks of one
     gloo group on the one card train through run_train with dp_devices
     2, a micro-batch of 32 molecules each, one epoch of 8 steps:
     exactly 3 + 6 + 3 launches per step on each rank, bit-identical
     parameters and EMA, checkpoints from rank 0 alone, and one f32
     step's all-reduced gradient against the mean of the two
     micro-batches' gradients taken in one process (phase 6's limit); the
     step's and the all-reduce's ms; (d) utils/profiling.trace around two
     mega train steps holds the annotate names and the three message
     kernels, and device_memory_stats reads the card.
 12. one large system over four ranks (spawned, one gloo group on the one
     card; the exchanges stage their rows through the host), seed-0
     weights of phase 7's model: the message kernels against their plain
     versions on shard 0's halo layout of phase 7's box, and their times;
     (a) HaloCalculator(pallas="mega") on phase 7's 10,000-atom box and
     4,000-atom chain against the single-process Calculator (bf16:
     energy and mean |F| 2e-2; f32 on the 2^-10 A grid: 1e-4, forces
     element-wise F32_FORCE_TOL plus twice the references' own spreads),
     3 + 3 launches per rank and call, each call's host partition,
     forward and forces (host clock and CUDA events), exchanges and
     all-gather timed beside the single-process Calculator's ms; (b)
     run_md with halo_devices 4, 20 NVE steps on the chain, replicas bit
     for bit and against the single-process run_md (1e-4 A), the
     trajectory from rank 0 alone; (c) run_halo_train with gp 2 x dp 2
     on six 2,000-atom boxes (3 + 6 + 3 launches per rank and step, a
     falling loss, rank-0 checkpoints), one f32 make_halo_train_step's
     mean gradient against the single-process gradient of the same loss
     (phase 6's limit), XPaiNN-Ewald with a charge against the
     single-process Calculator; (d) the edge partition (plain f32 route,
     nodes replicated) of the box: energy, forces and virial against one
     process; (e) the same with NCCL, one card per rank, when the machine
     has four cards (else "nccl_multi_card: not run").
 13. the convergence study's path (xequinet_torch/tools) at a short budget:
     (a) the synthetic PES on the card against the CPU on 16 seed-7
     clusters (energy 1e-5 relative, forces 1e-4 of max |F|); (b) 960
     structures of 8-32 atoms generated on the card by the generator's
     main; (c) ``train -C`` through ``cli.main`` with the study tool's
     make_config at the study's widths (FLAGSHIP_KW's), bf16, mega route,
     batch 64, 12 epochs of which the last 2 in f32: exactly 3 + 6 + 3
     launches per step in the bf16 and in the f32 epochs and 3 + 3 per
     validation batch, the f32 switch logged with the optimizer still on
     the module's tensors and the EMA copy rebuilt, finite losses, the
     validation force MAE of the last epoch at most 0.9 of the first's
     (EMA weights); (d) run_test on the last checkpoint (EMA), finite
     metrics; (e) the study tool's nve_drift (FIRE, 600 Langevin steps,
     400 NVE steps of 0.5 fs, 24 atoms) on that f32 checkpoint: the
     plain route with no launch (the Calculator's size rules), finite
     energies, the drift printed, and the ms per call.
 14. (run after phase 6's times, where torch.profiler sees the card) the
     backward's stream-floor probe (xequinet_torch/tools/
     bwd_stream_floor.py): bench.py's batch at default_rng(0), its layout
     (48 blocks, 10 max chunks, 189,952 slots) against the JAX tool's JSON;
     one call of the floor kernel (csrc/bwd_stream_floor.cu: message_bwd's
     tile route with a near-empty body), one launch and none on any earlier
     path, bit for bit against its plain version; the floor and message_bwd
     on the same operands timed and split by pass (each split must sum to
     at least 0.9 of its CUDA-event time per call), beside the floor's own
     byte bound, message_bwd's, the bytes the floor moves and the
     tensor-core ideal, and the reading (stream or body); message_bwd's
     Hopper tile pass split by phase (clock64() stamps of its instrumented
     instance, which counts no launch); after phase 15, the floor's
     launches on every model path, all 0.
 15. remat (models/remat.py; after phase 13): FLAGSHIP_KW on the mega
     route with remat off, "full" and "save_edge_agg", seed-0 weights, on
     phase 3's batch: (a) f32 and (b) bf16 force-loss energies, forces and
     parameter gradients against remat off, bit for bit under
     deterministic sums (f32 must be; bf16 prints any difference) and
     within twice the no-remat call's own spread with the default sums;
     (c) launches per forces-only call and per train step under each
     policy, mega and v2 routes, equal to the JAX program's pallas_calls
     (3 + 3, 3 + 8 + 3; v2 3, 3); (d) one bf16 mega train step's peak
     device memory, its rise above the memory held before, and its ms
     (host clock and CUDA events) per setting at 1024 and 4096 molecules;
     (e) phase 8's 640 Ewald crystals, the force and virial loss under
     remat against remat off as in (a), and each setting's step peak;
     (f) run_train with ``remat: true`` for an epoch and resumed for a
     second (3 + 8 + 3 per step, 3 + 3 per validation batch), then its
     checkpoint through predict and a Calculator call on phase 7's box
     (3 + 3 each).
 16. the last user-facing pieces (after phase 15): (a) a torch-saved dict
     of seeded 8-wide vectors for every element, converted by
     utils/qc.convert_torch_table into a temporary PRE_FOLDER, as the
     embedding of XPaiNN at FLAGSHIP_KW's widths on the mega route, serving
     phase 3's molecules with forces (exactly 3 + 3 launches) within the
     bf16 2e-2 band of the plain route; (b) a reference-format data.lmdb of
     320 fake-PyG records (bench molecules; past 256 records the keys'
     byte order is not index order) converted by
     tools/convert_lmdb_dataset.py without the lmdb package: record i at
     index i and each split equal to the in-place dataset of the LMDB, then
     ``train -C`` on it for one epoch on the mega route (exactly 3 + 6 + 3
     launches per step, 3 + 3 per validation batch, finite losses); (c)
     300 structures generated on the card at the bf16 study's usage, then
     tools/bf16_accuracy_study.py's main, 2 epochs each of f32, bf16 and
     bf16_f32ft at the study's widths: no launch (the plain route, as in
     JAX), finite test metrics, results.json written, the f32 switch
     logged, each mode's mean step ms.
Then one JSON line with the kernels (each with its launches per MD call
and per phase 8, 9, 10, 11, 12, 13, 15 and 16 path too, and its times on the
halo layout; the sixth row, the stream floor, with its launches per probe
call), the card line, and last the device JSON line.
It imports nothing of JAX or of the JAX package.
"""

import argparse
import contextlib
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


def kernel_route(name, mm, statics):
    """Which pass of a message kernel its wrapper takes at these widths (by
    shape alone, as the wrapper chooses)."""
    from xequinet_torch.ops import fused_message as fm

    if name == "message_fwd" and fm.fwd_hopper_route(mm, *statics):
        return "Hopper tile pass"
    if name == "message_bwd" and fm.hopper_route(mm, *statics):
        return "Hopper tile pass"
    if name == "message_bwd2" and fm.hopper2_route(mm, *statics):  # no cwf, as trained
        return "Hopper tile pass"
    if fm.f32_route(name, mm, *statics):  # no cwf in the second order, as trained
        return "f32 tile pass"
    return "tile pass" if fm.tile_route(name, mm, *statics) else "walk kernels"


def message_problem(batch, device, seed=7, bn=BN, chunk=CHUNK, widths=None):
    """Operands of one message op on the batch's slots, at the flagship's
    widths or at ``widths`` = (irreps, num_basis, node_dim)."""
    from xequinet_torch import keys
    from xequinet_torch.ops import fused_message as fm
    from xequinet_torch.ops.irreps import Irreps

    irreps, nb, nd = widths or (FLAGSHIP_KW["node_irreps"], FLAGSHIP_KW["num_basis"],
                                FLAGSHIP_KW["node_dim"])
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
                n_atoms=int(batch[keys.NODE_MASK].sum()), statics=(irreps, nb, nd),
                bn=bn, chunk=chunk)


def plain_fwd(p, mm):
    from xequinet_torch.ops import fused_message as fm

    sm = p["slot_meta"]
    return (fm.plain_message(p["x_cat"], p["ef"], p["wf"], sm[2], sm[3], p["edge_mask"],
                             *p["statics"], p["n_out"], getattr(torch, mm)),)


def plain_bwd(p, mm):
    from xequinet_torch.ops import fused_message as fm

    sm = p["slot_meta"]
    return fm.plain_message_bwd(p["x_cat"], p["ef"], p["wf"], p["g"], sm[2], sm[3],
                                p["edge_mask"], *p["statics"], p["n_out"],
                                getattr(torch, mm))


def kernel_fwd(p, mm):
    from xequinet_torch.ops import fused_message as fm

    return (fm.message_fwd_cuda(p["x_cat"], p["ef"], p["wf"], p["slot_meta"], *p["statics"],
                                p["n_out"], p["bn"], p["chunk"], mm),)


def kernel_bwd(p, mm):
    from xequinet_torch.ops import fused_message as fm

    return fm.message_bwd_cuda(p["x_cat"], p["ef"], p["wf"], p["g"], p["slot_meta"],
                               *p["statics"], p["n_out"], p["bn"], p["chunk"], mm)


def plain_bwd2(p, mm, cwf=None):
    from xequinet_torch.ops import fused_message as fm

    sm = p["slot_meta"]
    return fm.plain_message_bwd2(p["x_cat"], p["ef"], p["wf"], p["g"], p["cx"], p["cef"],
                                 cwf, sm[2], sm[3], p["edge_mask"], *p["statics"],
                                 p["n_out"], getattr(torch, mm))


def kernel_bwd2(p, mm, cwf=None):
    from xequinet_torch.ops import fused_message as fm

    return fm.message_bwd2_cuda(p["x_cat"], p["ef"], p["wf"], p["g"], p["cx"], p["cef"],
                                cwf, p["slot_meta"], *p["statics"], p["n_out"], p["bn"],
                                p["chunk"], mm)


# the message kernels' outputs, by name, as each wrapper returns them
OUT_NAMES = {"message_fwd": ("agg",), "message_bwd": ("dx", "d_ef", "d_wf"),
             "message_bwd2": ("d2x", "d2ef", "d2wf", "d2g")}


def check_message_kernels(p, tag="", repeat=False):
    """Each message kernel against its plain version on the problem ``p``,
    f32 and bf16, the second order with no cotangent on d_wf (force
    training) and a random one; with ``repeat``, also the same bits on a
    second call.  Fails on any disagreement; returns bf16 max |kernel -
    plain| per kernel (the second order without cwf)."""
    abs_err = {}
    cases = [("message_fwd", "", lambda mm: (kernel_fwd(p, mm), plain_fwd(p, mm)),
              lambda mm: kernel_fwd(p, mm)),
             ("message_bwd", "", lambda mm: (kernel_bwd(p, mm), plain_bwd(p, mm)),
              lambda mm: kernel_bwd(p, mm))]
    for cwf_tag, cwf in (("cwf=None", None), ("random cwf", p["cwf"])):
        cases.append(("message_bwd2", cwf_tag,
                      lambda mm, c=cwf: (kernel_bwd2(p, mm, c), plain_bwd2(p, mm, c)),
                      lambda mm, c=cwf: kernel_bwd2(p, mm, c)))
    for mm in ("float32", "bfloat16"):
        tol = TOL[mm]
        for name, cwf_tag, both, again in cases:
            got, want = both(mm)
            torch.cuda.synchronize()
            label = " ".join(t for t in (name, tag, mm, cwf_tag) if t)
            for out, a, b in zip(OUT_NAMES[name], got, want):
                e = rel_err(a, b)
                print(f"[kernels] {label} {out}: max|err|/max|ref| = {e:.3e} (limit {tol:g})")
                if not (e <= tol and torch.isfinite(a).all()):
                    fail(f"{label} {out} disagrees with plain")
            if name != "message_fwd" and float(got[1][~p["edge_mask"]].abs().max()) != 0.0:
                fail(f"{label}: padding / tail slots got non-zero d_ef rows")
            if mm == "bfloat16" and cwf_tag != "random cwf":
                abs_err[name] = max(float((a - b).abs().max()) for a, b in zip(got, want))
            if repeat:
                if not all(torch.equal(a, b) for a, b in zip(got, again(mm))):
                    fail(f"{label}: a second call gave other bits")
                print(f"[kernels] {label}: the same bits on a second call")
            del got, want
    return abs_err


def phase_kernels(batch, device):
    """Phase 3: each kernel against its plain version, f32 and bf16."""
    p = message_problem(batch, device)
    return p, check_message_kernels(p)


# the message kernels' widths past the first tile passes' limits: Kf = 33
# (num_basis 23), Kf = 128 (num_basis 118, the JAX kernels' maximum), H =
# 1152 (node_dim 256, 256x0e+128x1o+64x2e); and H = 640 (node_dim 192),
# past message_bwd's Hopper tile pass (H <= 576), where its mma.sync tile
# pass keeps d_wf in registers
WIDE_SHAPES = {"Kf=33": ("128x0e+64x1o+32x2e", 23, 128),
               "Kf=128": ("128x0e+64x1o+32x2e", 118, 128),
               "H=1152": ("256x0e+128x1o+64x2e", 23, 256),
               "H=640": ("128x0e+64x1o+32x2e", 20, 192)}


def phase_wide_kernels(batch, device):
    """Phase 3, continued: the shapes of ``WIDE_SHAPES`` on the same slots,
    each kernel against its plain version in f32 and bf16, repeating bit
    for bit; prints which route (Hopper tile pass, tile pass or walk
    kernels) each takes.
    Returns {shape: its bf16 operands} for phase 6."""
    wide = {}
    for tag, widths in WIDE_SHAPES.items():
        p = message_problem(batch, device, widths=widths)
        routes = {k: kernel_route(k, "bfloat16", widths) for k in OUT_NAMES}
        print(f"[kernels] wide shape {tag} {widths}: bf16 routes {routes}")
        if tag == "H=640" and set(routes.values()) != {"tile pass"}:
            fail(f"H=640: the message kernels take {routes}, not the mma.sync tile passes "
                 f"this shape is here to check")
        check_message_kernels(p, tag, repeat=True)
        wide[tag] = dict(p, **{k: p[k].to(torch.bfloat16)
                               for k in ("x_cat", "ef", "wf", "g", "cx", "cef")})
        del p
        torch.cuda.empty_cache()
    print(f"[kernels] wide shapes: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return wide


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


def model_kwargs(model, over):
    """The model kwargs of ``model``: FLAGSHIP_KW with ``over`` for the
    XPaiNN families (XPaiNN, XPaiNN-Ewald, XMatNet), the builder's own
    defaults with ``over`` for PaiNN and SO3krates."""
    if model in ("painn", "so3krates"):
        return dict(over)
    kw = dict(FLAGSHIP_KW, pallas_layout=(BN, CHUNK, PAD_NODES, MAX_CHUNKS))
    kw.update(over)
    return kw


def make_engine(device, model="xpainn", **over):
    """InferenceEngine of flagship XPaiNN (FLAGSHIP_KW with ``over``; or
    another model family, see :func:`model_kwargs`) on seeded weights."""
    from xequinet_torch.models.model import init_params, resolve_model
    from xequinet_torch.run.inference import InferenceEngine

    kw = model_kwargs(model, over)
    module, extra, cutoff = resolve_model(model, **kw)
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


# the wide model: FLAGSHIP_KW at num_basis 23 (Kf = 33), node_dim 256 and
# 256x0e+128x1o+64x2e (H = 1152), past the widths of the first tile passes
WIDE = dict(num_basis=23, node_dim=256, node_irreps="256x0e+128x1o+64x2e")


def phase_wide_slice(dps, device):
    """Phase 4, continued: the wide model on the mega route at full width,
    served by InferenceEngine.predict through the kernels (3 + 3 launches
    per predict with forces), against the plain route with the same
    weights: bf16 energies and mean |F|, and in f32 every force component.
    Returns its engine and collated batch."""
    from xequinet_torch import keys
    from xequinet_torch.ops import fused_message as fm

    eng = make_engine(device, **WIDE)
    fm.reset_launch_counts()
    res = eng.predict(dps, compute_forces=True)
    torch.cuda.synchronize()
    expect_launches("wide mega predict with forces", message_fwd=3, message_bwd=3)
    e = np.array([float(r[keys.TOTAL_ENERGY]) for r in res])
    f = np.concatenate([r[keys.FORCES] for r in res])
    if len(res) != len(dps) or not (np.isfinite(e).all() and np.isfinite(f).all()):
        fail("wide model: wrong shapes or non-finite energies or forces")
    n_g, n_at = len(dps), sum(d.num_atoms for d in dps)
    state = eng.module.state_dict()
    plain = make_engine(device, use_pallas_scatter=False, **WIDE)
    plain.module.load_state_dict(state)
    mega_b, plain_b = eng.collate(dps), plain.collate(dps)
    compare_outputs("bf16 wide mega vs plain route", eng.forward_batch(mega_b),
                    plain.forward_batch(plain_b), n_g, n_at, TOL["bfloat16"])
    k32 = make_engine(device, **WIDE, **F32)
    p32 = make_engine(device, use_pallas_scatter=False, **WIDE, **F32)
    for x in (k32, p32):
        x.module.load_state_dict(state)
    compare_outputs("f32 wide mega vs plain route on the card", k32.forward_batch(mega_b),
                    p32.forward_batch(plain_b), n_g, n_at, 1e-4, F32_FORCE_TOL)
    del k32, p32, plain
    torch.cuda.empty_cache()
    return eng, mega_b


def phase_big_molecule(device, state):
    """Phase 4, continued: a batch whose largest molecule (40 atoms) is
    larger than the flagship's pad_nodes (32).  The engine fits the slot
    layout to the batch, so the flagship serves it through the kernels (3
    + 3 launches), matching the plain route with the same weights (bf16
    energies and mean |F|; f32 every force component)."""
    from xequinet_torch.ops import fused_message as fm

    dps = build_molecules(63, seed=5) + build_molecules(1, seed=6, atoms_lo=40, atoms_hi=40)
    n_g, n_at = len(dps), sum(d.num_atoms for d in dps)
    engines = {}
    for tag, over in (("mega", {}), ("plain", {"use_pallas_scatter": False})):
        for dt, extra in (("bf16", {}), ("f32", F32)):
            engines[tag, dt] = make_engine(device, **over, **extra)
            engines[tag, dt].module.load_state_dict(state)
    fm.reset_launch_counts()
    engines["mega", "bf16"].predict(dps)
    torch.cuda.synchronize()
    expect_launches(f"predict of {n_g} molecules, the largest of 40 atoms (pad_nodes "
                    f"{PAD_NODES})", message_fwd=3, message_bwd=3)
    for dt, tol, f_tol in (("bf16", TOL["bfloat16"], None), ("f32", 1e-4, F32_FORCE_TOL)):
        mb = engines["mega", dt].collate(dps)
        pb = engines["plain", dt].collate(dps)
        compare_outputs(f"{dt} 40-atom batch, mega vs plain route",
                        engines["mega", dt].forward_batch(mb),
                        engines["plain", dt].forward_batch(pb), n_g, n_at, tol, f_tol)
    del engines
    torch.cuda.empty_cache()


TRAIN_WEIGHTS = {"energy": 1.0, "forces": 10.0}
# per-parameter f32 gradient limit of the kernel route against the plain
# route: GRAD_TOL + GRAD_ULP_FACTOR x the plain route's own change when the
# positions move by one f32 ulp (x (1 + 1e-7)).  The plain route is run
# under torch.use_deterministic_algorithms for this reference: with its
# float-atomic sums a second call moves the force loss's gradients by
# several per cent of their largest entries (plain_f32_reference prints
# it), and the one-ulp sample then missed that noise.  At random weights the
# force loss's parameter gradient is that ill-conditioned (the equivariant
# LayerNorm after the first message block divides by a small RMS); on the
# CPU the JAX package's step sits at 0.65 of that change from the port's
# (tests/test_torch_training.py).  A wrong sign or a dropped term moves a
# gradient by its own size.
GRAD_TOL, GRAD_ULP_FACTOR = 1e-4, 2.0
# a training task: (model family, loss weights, whether the virial is a
# target); the flagship's is bench.py's recipe
FLAGSHIP_TASK = ("xpainn", TRAIN_WEIGHTS, False)


def train_model(device, task=FLAGSHIP_TASK, dp_step=False, **over):
    """Flagship XPaiNN (or ``task``'s model family) with seeded weights,
    its forward for training and the step core of bench.py's recipe; with
    ``dp_step``, the data-parallel step (``make_dp_train_step``, in a
    process group) without the clip, its optimizer as ``step.optimizer``."""
    from xequinet_torch.models.model import init_params, resolve_model
    from xequinet_torch.models.properties import make_forward
    from xequinet_torch.parallel.data_parallel import make_dp_train_step
    from xequinet_torch.training.loss import ErrorMetric, WeightedLoss
    from xequinet_torch.training.lr_schedule import resolve_lr_schedule, resolve_optimizer
    from xequinet_torch.training.trainer import make_step_core

    model, weights, virial = task
    module, extra, _ = resolve_model(model, **model_kwargs(model, over))
    init_params(module, seed=0)
    module = module.to(device)
    params = list(module.parameters())
    opt = resolve_optimizer("adamw", params)
    sched = resolve_lr_schedule("cosine_annealing", 5e-4, 10000, warmup_steps=100)
    forward = make_forward(module, extra, create_graph=True)
    core, clip = (make_dp_train_step, None) if dp_step else (make_step_core, 5.0)
    step = core(forward, WeightedLoss("l2", **weights), params, opt, sched,
                "forces" in weights, virial, clip, 0.999, ErrorMetric(*weights))
    step.optimizer = opt
    return module, forward, step, [p.detach().clone() for p in params]


def model_grads(module, forward, batch, pos_scale=1.0, task=FLAGSHIP_TASK):
    from xequinet_torch import keys
    from xequinet_torch.training.loss import WeightedLoss
    from xequinet_torch.training.trainer import loss_and_grads

    _, weights, virial = task
    b = dict(batch)
    b[keys.POSITIONS] = b[keys.POSITIONS] * pos_scale
    named = list(module.named_parameters())
    loss, _, _, grads = loss_and_grads(forward, WeightedLoss("l2", **weights),
                                       [p for _, p in named], b, "forces" in weights, virial)
    return float(loss.detach()), {n: g for (n, _), g in zip(named, grads)}


F32 = dict(compute_dtype="float32", update_compute_dtype="float32")


def plain_f32_reference(dps, device, task=FLAGSHIP_TASK, **over):
    """The f32 plain route's weights, loss and parameter gradients on the
    flagship batch (collated without the slot layout), computed with
    deterministic sums, and per parameter the change of its gradients when
    the positions move by one f32 ulp (x (1 + 1e-7)).  Prints how far a
    call with the default (float-atomic) sums lands from it."""
    from xequinet_torch.data.batching import collate
    from xequinet_torch.run.inference import batch_to_device

    mp, fp, _, _ = train_model(device, task, **dict(over, use_pallas_scatter=False, **F32))
    pb = batch_to_device(collate(dps), device)
    torch.use_deterministic_algorithms(True)
    try:
        lp, gp = model_grads(mp, fp, pb, task=task)
        _, gp_nudged = model_grads(mp, fp, pb, 1.0 + 1e-7, task)
    finally:
        torch.use_deterministic_algorithms(False)
    moved = {n: float((gp_nudged[n] - g).abs().max()) for n, g in gp.items()}
    _, gp_atomic = model_grads(mp, fp, pb, task=task)
    rel = lambda d: max((float(d[n].abs().max()) / max(float(g.abs().max()), 1e-30), n)
                        for n, g in gp.items())
    r_n, n_n = rel({n: gp_nudged[n] - g for n, g in gp.items()})
    r_a, n_a = rel({n: gp_atomic[n] - g for n, g in gp.items()})
    print(f"[train] f32 plain route's gradients, the largest change over the parameters (of "
          f"each one's max): one-ulp move {r_n:.3e} ({n_n}); the default float-atomic sums "
          f"{r_a:.3e} ({n_a})")
    state = {k: v.clone() for k, v in mp.state_dict().items()}
    del mp, pb
    return state, lp, gp, moved


def f32_step_check(tag, over, b, ref, device, card, task=FLAGSHIP_TASK):
    """One f32 step's loss and parameter gradients on the kernel route
    ``over`` from the plain route's weights, against the plain route's
    (``ref`` from :func:`plain_f32_reference`), under the per-parameter
    limit GRAD_TOL + GRAD_ULP_FACTOR x the plain route's one-ulp change."""
    state, lp, gp, moved = ref
    mk, fk, _, _ = train_model(device, task, **dict(over, **F32))
    mk.load_state_dict(state)
    lk, gk = model_grads(mk, fk, b, task=task)
    print(f"[train] f32 {tag} and plain route steps: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB — {card}")
    rel = abs(lk - lp) / abs(lp)
    worst, worst_ratio = "", 0.0
    for n, g in gp.items():
        scale = max(float(g.abs().max()), 1e-30)
        limit = GRAD_TOL + GRAD_ULP_FACTOR * moved[n] / scale
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


def phase_training(tag, over, n_steps, want, b, ref, device, card, task=FLAGSHIP_TASK):
    """Phase 5: flagship bf16 training on the kernel route ``over`` on the
    card: launches per step ``want``, finite loss, parameters and
    gradients, a falling loss over ``n_steps`` steps, and the f32 step
    check (none without ``ref``).  Returns (launches per train step, the
    step function and its EMA for phase 6)."""
    from xequinet_torch.ops import cuda_build

    module, forward, step, ema = train_model(device, task, **over)
    loss0, _ = model_grads(module, forward, b, task=task)
    card_run = device.type == "cuda"
    cuda_build.reset_launch_counts()
    loss, _ = step(b, 0, 1.0, ema)
    if card_run:
        torch.cuda.synchronize()
    counts = path_launches(f"{tag} train step", card_run, **want)
    if not (np.isfinite(float(loss)) and all(torch.isfinite(p).all()
                                              for p in module.parameters())):
        fail(f"{tag}: non-finite loss or parameters after a train step")
    _, grads = model_grads(module, forward, b, task=task)
    bad = [n for n, g in grads.items() if not torch.isfinite(g).all()]
    if bad or not np.isfinite(loss0):
        fail(f"{tag}: non-finite gradients: {bad[:5]}")
    for i in range(1, n_steps):
        step(b, i, 1.0, ema)
    loss_n, _ = model_grads(module, forward, b, task=task)
    print(f"[train] {tag}: loss on the fixed batch {loss0:.6f} before, {loss_n:.6f} after "
          f"{n_steps} steps")
    if not loss_n < loss0:
        fail(f"{tag}: the training loss did not fall over {n_steps} steps")
    if ref is not None:
        f32_step_check(tag, over, b, ref, device, card, task)
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


def pass_split(name, fn, p_mm, mm, card, calls=10):
    """A wrapper's device time per launch by pass (torch.profiler over
    ``calls`` calls of ``fn`` after a warm-up) and its scratch bytes (bf16
    on the bf16 tile routes; the f32 second order's f32 d2g rows; none on
    the walk kernels and the f32 first order).  Returns ({pass: ms per
    launch} of the passes the profiler saw, scratch bytes)."""
    from xequinet_torch.ops import fused_message as fm
    from xequinet_torch.tools import bwd_stream_floor as bsf

    split, seen = bsf.pass_split(fn, fm.PASSES[name], calls)
    irreps, nb, nd = p_mm["statics"]
    _, _, _, _, (h, _, d, _, _, _) = fm.structure_matrices(irreps, nb, nd)
    t = p_mm["ef"].shape[0]
    route = kernel_route(name, mm, p_mm["statics"])
    isz, dt = (4, "f32") if mm == "float32" else (2, "bf16")
    shapes = ([] if name == "message_fwd" or route == "walk kernels" else
              [fm.bwd2_scratch_shapes(t, h, nd, d)[1]] * (name == "message_bwd2")
              if route == "f32 tile pass" else [fm.bwd_scratch_shape(t, h, d)]
              if name == "message_bwd" else list(fm.bwd2_scratch_shapes(t, h, nd, d)))
    scratch = sum(r * w * isz for r, w in shapes)
    shown = ", ".join(f"{k} {v:.4f} ms" for k, v in split.items()) or "not measured"
    print(f"[time] {name} ({mm}, {route}) per launch by pass (torch.profiler, {calls} calls"
          f"{bsf.seen_note(seen, calls)}): {shown}; scratch "
          + (" + ".join(f"{r} x {w}" for r, w in shapes)
             + f" {dt} = {scratch / 1e6:.1f} MB written once, read once" if shapes else "none")
          + f" — {card}")
    return split, scratch


def bound_ms(nbytes, flops, mm):
    peak = PEAK_BF16 if mm == "bfloat16" else PEAK_F32
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_train_step(tag, step, b, ema, i0, n_real, card, dtype="bf16"):
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
    print(f"[time] train step ({dtype}, {tag}), median of 7: "
          f"{step_ms:.3f} ms (min {min(steps) * 1e3:.3f}, max {max(steps) * 1e3:.3f}), "
          f"{n_real / (step_ms / 1e3):.1f} edges/s; peak device memory "
          f"{peak / 2**30:.3f} GiB, {(peak - held) / 2**30:.3f} GiB above the "
          f"{held / 2**30:.3f} GiB held before the step — {card}")
    return step_ms


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


# ---------------------------------------------------------------------------
# Phase 7: MD
# ---------------------------------------------------------------------------
# bench.py md_hotloop_pbc_metric's model: FLAGSHIP_KW without the kernel
# route (the Calculator picks it) and remat, cutoff 5.0
MD_KW = dict({k: v for k, v in FLAGSHIP_KW.items() if k not in ("use_pallas_scatter", "remat")},
             cutoff=5.0)
# phase 7's sizes on the card: bench.py's 10,000-atom periodic box, the
# 4,000-atom free chain, and the run_md stage
MD_SIZES = dict(n_box=10000, max_box=10240, n_free=4000, max_free=4096, md_steps=100,
                iters=15, kw={})
# and in the CPU rehearsal: a small model, systems of a few hundred atoms
# (the mega route's least capacities: 1024 atoms, 4096 edges).  Its model
# is f32 in both slots: at 16 channels the bf16 virial moves by ~3% with
# the rounding points alone (either route against f32), past the bf16 band
MD_REHEARSAL = dict(n_box=600, max_box=1024, n_free=700, max_free=1024, md_steps=10, iters=2,
                    kw=dict(node_dim=16, node_irreps="16x0e+8x1o+4x2e", num_basis=8,
                            action_blocks=2, compute_dtype="float32",
                            update_compute_dtype="float32"))


# f32 virial of the periodic box, mega against plain route: the JAX
# package's f32 band (tests/test_pbc_mega.py, 1e-3).  The strain virial
# sums positions of up to 1500 A times forces whose f32 rounding moves
# with summation order (the element-wise force gate above), so it cancels
# far more than energy and forces do
MD_F32_VIRIAL_TOL = 1e-3
# and element-wise, max |dV| / max |V| on the 2^-10 A grid: the JAX
# package's 1e-3 was set for an 800 A chain; the box spans 1500 A, and the
# strain virial's f32 cancellation grows with the span (6.9e-4 measured,
# PERF.md section 6).  Both routes sum forces with float atomics, so each
# differs from itself from call to call by up to about this much on the same
# grid geometry (PERF.md, PR 9): the limit is MD_F32_VIRIAL_ELEM_TOL plus
# twice the larger of the two routes' own spreads, measured in the same
# run.  A layout or ghost-shift fault shows at the wrap-edge fraction, far
# above 1% (tests/test_pbc_mega.py)
MD_F32_VIRIAL_ELEM_TOL = 2e-3
# a grid of 2^-10 A: coordinates below 8192 A on it, and their sums and
# differences with the cell's (multiples of 2^-4 A), are exact in f32
MD_GRID = 2.0 ** -10
# phase 7 (c)'s NVE step, fs
MD_DT = 0.05


def md_checkpoint(path, model="xpainn", **over):
    """Seeded XPaiNN (MD_KW with ``over``, torch.Generator seed 0; or
    another model family) written by the port's trainer checkpoint
    writer."""
    from xequinet_torch.models.model import init_params, resolve_model
    from xequinet_torch.training.trainer import save_checkpoint

    kw = dict(MD_KW, **over)
    module, _, _ = resolve_model(model, **kw)
    init_params(module, seed=0)
    save_checkpoint(path, module, {"model_name": model, "model_kwargs": kw,
                                   "default_units": {}})
    return path


def md_box(n):
    """bench.py md_hotloop_pbc_metric's periodic box (its rng,
    default_rng(3), after the draws of its checkpoint molecule): x spacing
    0.15 A with 0.5 A noise, a 16 x 16 A cross-section, all axes periodic.
    Returns (z, pos, cell, pbc, rng); the rng goes on to draw the drift."""
    rng = np.random.default_rng(3)
    rng.integers(1, 5, 6), rng.normal(size=(6, 3))
    lx = n * 0.15
    cell = np.diag([lx, 16.0, 16.0])
    x = (np.arange(n) * 0.15 + rng.normal(size=n) * 0.5) % lx
    pos = np.column_stack([x, rng.uniform(0, 16.0, size=(n, 2))])
    z = rng.integers(1, 9, size=n).astype(np.int32)
    return z, pos, cell, np.array([True, True, True]), rng


def md_free_chain(n, seed=11):
    """tests/test_mega_production.py's quasi-1D chain, not sorted along
    its axis."""
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.uniform(0.9, 1.5, size=n))
    pos = np.column_stack([x, rng.normal(size=(n, 2)) * 1.0])
    pos = pos[rng.permutation(n)]
    return rng.integers(1, 5, size=n).astype(np.int32), pos


def md_edge_cap(n_edges):
    """bench.py's MD capacity: 1.55 x the cutoff list, in whole chunks."""
    return ((int(n_edges * 1.55) + 1023) // 1024) * 1024


def md_force_err(got, want):
    """(max |dF| / max |F| over every component, 99th percentile of the
    per-atom |dF| / max |F|)."""
    scale = np.abs(want).max()
    atom = np.linalg.norm(got - want, axis=-1) / scale
    return float(np.abs(got - want).max() / scale), float(np.quantile(atom, 0.99))


def md_compare(tag, got, want, tol, f_tol=None, v_tol=None, v_elem=False):
    """Energy and mean |F| within ``tol`` relative, mean |virial| within
    ``v_tol`` when given (with ``v_elem`` the virial element-wise instead:
    max |dV| / max |V|); with ``f_tol`` = (max, p99) the forces
    element-wise."""
    from xequinet_torch import keys

    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    fg, fw = got[keys.FORCES], want[keys.FORCES]
    errs = {"energy": rel(got[keys.TOTAL_ENERGY], want[keys.TOTAL_ENERGY]),
            "mean|F|": rel(np.abs(fg).mean(), np.abs(fw).mean())}
    limits = {"energy": tol, "mean|F|": tol}
    if v_tol is not None:
        vg, vw = got[keys.VIRIAL], want[keys.VIRIAL]
        if v_elem:
            k = int(np.abs(vg - vw).argmax()) % 9
            name = f"virial max|dV|/max|V| (element {'xyz'[k // 3]}{'xyz'[k % 3]})"
            errs[name] = float(np.abs(vg - vw).max() / np.abs(vw).max())
        else:
            name = "mean|virial|"
            errs[name] = rel(np.abs(vg).mean(), np.abs(vw).mean())
        limits[name] = v_tol
    f_max, q99 = md_force_err(fg, fw)
    lim = ("none", "none") if f_tol is None else tuple(f"{x:.3g}" for x in f_tol)
    print(f"[md] {tag}: " + ", ".join(f"{k} rel diff {v:.3e} (limit {limits[k]:g})"
                                      for k, v in errs.items())
          + f"; force max|dF|/max|F| {f_max:.3e} (limit {lim[0]}), 99th "
          f"percentile per atom {q99:.3e} (limit {lim[1]})")
    if not (np.isfinite(fg).all() and all(v <= limits[k] for k, v in errs.items())):
        fail(f"{tag}: energy, mean |F| or the virial disagree")
    if f_tol is not None and not (f_max <= f_tol[0] and q99 <= f_tol[1]):
        fail(f"{tag}: forces disagree element-wise")


def md_launches(tag, card_run):
    """Message launches since the last reset: 3 forward + 3 backward per
    Calculator call on the mega route, nothing else (the CPU runs the
    plain versions and counts nothing)."""
    if card_run:
        expect_launches(tag, message_fwd=3, message_bwd=3)
    from xequinet_torch.ops import cuda_build

    return dict(cuda_build.LAUNCHES)


def md_pair(ckpt, caps, device, **kw):
    """(mega, plain) Calculators of one checkpoint."""
    from xequinet_torch.interface.calculator import Calculator

    return (Calculator(ckpt, pallas="mega", device=device, **caps, **kw),
            Calculator(ckpt, device=device, **caps, **kw))


def md_agreement(tag, z, pos, calcs, card_run, **sys_kw):
    """Mega against plain route on one geometry, with 3 + 3 launches per
    mega call; ``calcs`` maps "bf16" and "f32" to a (mega, plain) pair of
    Calculators of the bf16 and the f32 checkpoint.
    bf16: energy and mean |F| within 2e-2 (bench.py's band); the mean
    |virial| no further from the f32 plain route's than 2e-2 plus twice
    the bf16 plain route's own largest distance over 3 calls (at flagship
    width bf16 rounding alone moves it by several per cent, and the plain
    route's atomic sums move it from call to call; PERF.md, section 6).
    f32 on the MD geometry: energy and mean |F| within 1e-4, mean |virial|
    within MD_F32_VIRIAL_TOL.  f32 on the geometry rounded to MD_GRID,
    where both routes form the same edge vectors exactly and only the
    order of the sums differs: energy and mean |F| as before, the forces
    element-wise within F32_FORCE_TOL and the virial element-wise within
    MD_F32_VIRIAL_ELEM_TOL plus twice the larger of the routes' own
    spreads over repeated calls on the grid geometry.  (On the raw geometry the ghost rows' derived
    positions, owner + shift @ cell, round apart from the plain route's
    differences at 1500 A, so the element-wise bounds hold on the grid.)"""
    from xequinet_torch import keys
    from xequinet_torch.ops import cuda_build

    virial = "cell" in sys_kw
    pos_q = np.round(pos / MD_GRID) * MD_GRID
    res = {}

    def mega_call(calc, p, what):
        cuda_build.reset_launch_counts()
        out = calc.calculate(z, p, **sys_kw)
        md_launches(f"{tag} {what} mega call", card_run)
        if calc.last_route != "mega":
            fail(f"{tag}: the mega Calculator took the {calc.last_route} route")
        return out

    for label in ("bf16", "f32"):
        mega, plain = calcs[label]
        res[label] = (mega_call(mega, pos, label), plain.calculate(z, pos, **sys_kw))
        if label == "bf16" and virial:  # the plain route sums with atomics: it varies
            res["bf16 repeats"] = [plain.calculate(z, pos, **sys_kw) for _ in range(2)]
        if label == "f32":
            res["grid"] = (mega_call(mega, pos_q, "f32 grid"), plain.calculate(z, pos_q, **sys_kw))
            if virial:  # each route's own spread on the grid (its atomic sums vary)
                res["grid repeats"] = ([mega_call(mega, pos_q, "f32 grid repeat")],
                                       [plain.calculate(z, pos_q, **sys_kw) for _ in range(2)])
    (m16, p16), (m32, p32) = res["bf16"], res["f32"]
    md_compare(f"{tag} bf16 checkpoint mega vs plain route", m16, p16, TOL["bfloat16"])
    if virial:
        mean_v = lambda r: float(np.abs(r[keys.VIRIAL]).mean())
        dist = lambda r: abs(mean_v(r) - mean_v(p32)) / mean_v(p32)
        d_m, d_p = dist(m16), [dist(r) for r in [p16] + res["bf16 repeats"]]
        limit = TOL["bfloat16"] + 2 * max(d_p)
        print(f"[md] {tag} bf16 mean |virial| against the f32 plain route's: mega route "
              f"{d_m:.3e}, plain route " + ", ".join(f"{d:.3e}" for d in d_p)
              + f" (3 calls; limit for mega: 2e-2 + 2 x the largest = {limit:.3e})")
        if d_m > limit:
            fail(f"{tag}: the mega route's bf16 virial is further from f32 than the band")
    md_compare(f"{tag} f32 checkpoint mega vs plain route", m32, p32, 1e-4,
               v_tol=MD_F32_VIRIAL_TOL if virial else None)
    v_elem_tol = None
    if virial:
        spread = lambda r, ref: float(np.abs(r[keys.VIRIAL] - ref[keys.VIRIAL]).max()
                                      / np.abs(ref[keys.VIRIAL]).max())
        (m_rep, p_rep), (m_q, p_q) = res["grid repeats"], res["grid"]
        s_m, s_p = [spread(r, m_q) for r in m_rep], [spread(r, p_q) for r in p_rep]
        v_elem_tol = MD_F32_VIRIAL_ELEM_TOL + 2 * max(s_m + s_p)
        print(f"[md] {tag} f32 virial on the grid, each route against its own first call: mega "
              + ", ".join(f"{x:.3e}" for x in s_m) + "; plain "
              + ", ".join(f"{x:.3e}" for x in s_p) + f" (the limit for mega vs plain: "
              f"{MD_F32_VIRIAL_ELEM_TOL:g} + 2 x the largest = {v_elem_tol:.3e})")
    md_compare(f"{tag} f32 checkpoint mega vs plain route, positions on the {MD_GRID:g} A "
               f"grid", *res["grid"], 1e-4, F32_FORCE_TOL, v_elem_tol, v_elem=True)


def md_split(calc, z, pos_fn, sys_kw, card, calls=5):
    """The hot loop's steady-state time by part: torch.profiler over
    ``calls`` calls (wall per call; the message kernels' device time; the
    rest of the device time, the plain PyTorch ops; idle share = 1 - busy
    / wall), and the host build of one rebuild (the C++ list and the
    numpy layout), which the skin's worker thread takes off the call."""
    import re

    from torch.profiler import ProfilerActivity, profile

    from xequinet_torch.ops.radius_graph import radius_graph_pbc_np

    dev = lambda e: getattr(e, "self_device_time_total", None) or \
        getattr(e, "self_cuda_time_total", 0.0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            calc.calculate(z, pos_fn(), **sys_kw)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / calls
    kernels = [e for e in prof.key_averages() if str(getattr(e, "device_type", "")).endswith(
        "CUDA")]
    ours = re.compile(r"\b(message_\w+_kernel|xeq_\w+_kernel)\b")
    k_ms = sum(dev(e) for e in kernels if ours.search(e.key)) / 1e3 / calls
    busy = sum(dev(e) for e in kernels) / 1e3 / calls
    pos = pos_fn()
    t0 = time.perf_counter()
    ei, offs = radius_graph_pbc_np(pos, sys_kw["cell"], sys_kw["pbc"],
                                   calc.cutoff + calc.skin)
    t1 = time.perf_counter()
    n_cap, e_cap = calc._capacities(len(z))
    built = calc._mega_host_build(z, pos, ei, len(z), n_cap, e_cap, None, None,
                                  cell=sys_kw["cell"], pbc=sys_kw["pbc"], offs=offs)
    t2 = time.perf_counter()
    if built is None:
        fail("the MD host build refused the box")
    print(f"[md] hot-loop split (torch.profiler, {calls} steady calls): wall {wall:.3f} ms/call; "
          f"message kernels {k_ms:.3f} ms, other device ops {busy - k_ms:.3f} ms, idle share "
          f"{max(0.0, 1 - busy / wall):.3f}; one rebuild's host build: neighbour list (C++) "
          f"{(t1 - t0) * 1e3:.1f} ms + spatial layout and slots {(t2 - t1) * 1e3:.1f} ms "
          f"(worker thread) — {card}")


def md_energies(lines):
    import re

    out = [tuple(map(float, m.groups())) for m in
           (re.search(r"Epot=(\S+)eV Ekin=(\S+)eV", ln) for ln in lines) if m]
    return np.array(out)


class _Lines:
    """A logger that keeps run_md's lines."""

    def __init__(self):
        self.lines = []

    def info(self, msg):
        self.lines.append(msg)


def phase_md(device, card, tmp, sizes, profile_dir=None):
    """Phase 7: the MD entry point.  (a) bench.py's periodic MD hot loop
    through Calculator(pallas="mega", skin=0.5); (b) a free chain; (c)
    run_md from an extxyz file on (b), NVE, on the mega and the plain
    route.  Returns the mega route's launches per Calculator call."""
    import os

    from xequinet_torch import keys
    from xequinet_torch.data.datapoint import Datapoint
    from xequinet_torch.data.fmt_conversion import read_xyz, write_xyz
    from xequinet_torch.interface.calculator import Calculator
    from xequinet_torch.ops import cuda_build
    from xequinet_torch.ops.radius_graph import radius_graph_np, radius_graph_pbc_np
    from xequinet_torch.run.dynamics import run_md
    from xequinet_torch.utils.config import load_md_config
    from xequinet_torch.utils.qc import ATOM_MASS

    card_run = device.type == "cuda"
    sync = torch.cuda.synchronize if card_run else (lambda: None)
    ck16 = md_checkpoint(os.path.join(tmp, "md_bf16.ckpt"), **sizes["kw"])
    ck32 = md_checkpoint(os.path.join(tmp, "md_f32.ckpt"), **dict(sizes["kw"], **F32))

    # (a) the periodic hot loop
    z, pos, cell, pbc, rng = md_box(sizes["n_box"])
    box = dict(cell=cell, pbc=pbc)
    t0 = time.perf_counter()
    ei, _ = radius_graph_pbc_np(pos, cell, pbc, 5.0)
    n_edges = ei.shape[1]
    caps = dict(max_atoms=sizes["max_box"], max_edges=md_edge_cap(n_edges))
    print(f"[md] (a) periodic box: {len(z)} atoms, cell diag {np.diag(cell).tolist()}, "
          f"{n_edges} edges at the cutoff (C++ list {1e3 * (time.perf_counter() - t0):.1f} ms), "
          f"max_edges {caps['max_edges']}")
    hot = Calculator(ck16, pallas="mega", skin=0.5, device=device, **caps)
    trail = []  # every geometry the hot Calculator is given, in order

    def step():
        """The next geometry of the hot loop: 0.01 A of drift per call."""
        nonlocal pos
        pos = pos + rng.normal(size=pos.shape) * 0.01
        trail.append(pos)
        return pos

    cuda_build.reset_launch_counts()
    trail.append(pos)
    t0 = time.perf_counter()
    res = hot.calculate(z, pos, **box)
    sync()
    first = time.perf_counter() - t0
    launches = md_launches("(a) first call (host build + upload + slot plan + model)", card_run)
    st = hot._skin_state
    bn, chunk, pad, _ = hot._mega["layout"]
    if hot.last_route != "mega" or not np.isfinite(res[keys.FORCES]).all() or \
            res[keys.FORCES].shape != (len(z), 3):
        fail(f"(a): route {hot.last_route}, or non-finite / misshapen forces")
    print(f"[md] (a) first call {first * 1e3:.1f} ms: route {hot.last_route}, "
          f"{st['n_ext'] - len(z)} ghost rows, {st['rows']} node rows, pad_nodes {pad}, "
          f"block_nodes {bn}, chunk {chunk}, slots {st['dev_static'][keys.EDGE_MASK].shape[0]}")
    cuda_build.reset_launch_counts()
    hot.calculate(z, step(), **box)
    sync()
    launches = md_launches("(a) steady call (positions only)", card_run)
    if card_run:
        torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() if card_run else 0
    medians = []
    for _ in range(3):  # bench.py's metric: best of 3 medians of 3 x iters calls
        times = []
        for _ in range(sizes["iters"]):
            p = step()
            t0 = time.perf_counter()
            res = hot.calculate(z, p, **box)
            times.append(time.perf_counter() - t0)
            if hot.last_route != "mega":
                fail("(a): a hot-loop call left the mega route")
        medians.append(float(np.median(times)))
    dt = min(medians)
    peak = torch.cuda.max_memory_allocated() if card_run else 0
    mm = dict(MD_KW, **sizes["kw"])["compute_dtype"]
    print(f"[md] (a) hot loop ({mm}, skin 0.5, drift 0.01 A per call): best of 3 medians of "
          f"{sizes['iters']} calls {dt * 1e3:.3f} ms/call (medians "
          + ", ".join(f"{m * 1e3:.3f}" for m in medians)
          + f"), {n_edges / dt:.1f} edges/s; n_rebuilds {hot.n_rebuilds}, n_async_swaps "
          f"{hot.n_async_swaps}; peak device memory {peak / 2**30:.3f} GiB "
          f"({held / 2**30:.3f} GiB held before) — {card}")
    plain16 = Calculator(ck16, skin=0.5, device=device, **caps)
    pp = pos
    plain16.calculate(z, pp, **box)
    times = []
    for _ in range(5):
        pp = pp + rng.normal(size=pos.shape) * 0.01
        t0 = time.perf_counter()
        plain16.calculate(z, pp, **box)
        times.append(time.perf_counter() - t0)
    p_dt = float(np.median(times))
    print(f"[md] (a) plain route, same loop: median of 5 calls {p_dt * 1e3:.3f} ms/call, "
          f"{n_edges / p_dt:.1f} edges/s — {card}")
    if card_run:
        md_split(hot, z, step, box, card)
        if profile_dir:
            profile_call("md_hot_loop", lambda: hot.calculate(z, step(), **box), profile_dir,
                         card)
    # the hot loop's own Calculator against the plain route, at its last
    # geometry (inside the skin: served from the list the worker built),
    # beside an f32 twin driven through the same geometries.  The loop ran
    # without the virial, as bench.py's; a Calculator reads compute_virial
    # at each call, so turning it on keeps the list
    hot.compute_virial = plain16.compute_virial = True
    hot32 = Calculator(ck32, pallas="mega", skin=0.5, compute_virial=True, device=device,
                       **caps)
    for p in trail:
        hot32.calculate(z, p, **box)
        if hot32.last_route != "mega":
            fail("(a): the f32 twin left the mega route")
    swaps = f"n_rebuilds / n_async_swaps: bf16 {hot.n_rebuilds} / {hot.n_async_swaps}, " \
        f"f32 twin {hot32.n_rebuilds} / {hot32.n_async_swaps}"
    print(f"[md] (a) the f32 twin took the hot loop's {len(trail)} geometries; {swaps}")
    if card_run and min(hot.n_async_swaps, hot32.n_async_swaps) < 1:
        fail(f"(a): no list built by the skin's worker thread was swapped in ({swaps})")
    plain32 = Calculator(ck32, skin=0.5, compute_virial=True, device=device, **caps)
    synced = [c.n_rebuilds - c.n_async_swaps for c in (hot, hot32)]
    md_agreement("(a) periodic box, the hot loop's Calculators (skin 0.5)", z, pos,
                 {"bf16": (hot, plain16), "f32": (hot32, plain32)}, card_run, **box)
    if [c.n_rebuilds - c.n_async_swaps for c in (hot, hot32)] != synced:
        fail("(a): a compared call rebuilt its list: the skin's list was not what served it")
    for c in (hot, hot32, plain16, plain32):
        c.close()
    del hot, hot32, plain16, plain32

    # (b) a free system
    zf, posf = md_free_chain(sizes["n_free"])
    eif, _ = radius_graph_np(posf, 5.0)
    caps_f = dict(max_atoms=sizes["max_free"], max_edges=md_edge_cap(eif.shape[1]))
    print(f"[md] (b) free chain: {len(zf)} atoms, {eif.shape[1]} edges, max_edges "
          f"{caps_f['max_edges']}")
    md_agreement("(b) free chain", zf, posf, {"bf16": md_pair(ck16, caps_f, device),
                                               "f32": md_pair(ck32, caps_f, device)}, card_run)

    # (c) run_md from an extxyz file, NVE at f32, mega and plain.  At
    # random weights the forces on this chain are large for its light
    # atoms: at 0.25 fs both routes drift ~0.2 eV per atom in 100 steps,
    # and no drift check could fail there.  At MD_DT (PERF.md, section 6)
    # the check has a negative control: the mega route with forces 1% too
    # large must drift past the limit.  The routes' trajectories part
    # chaotically, so the mega run's logged energies are held against the
    # plain route at the frames it wrote
    import xequinet_torch.run.dynamics as dynamics

    class Scaled(Calculator):
        """Forces 1% too large (the drift check's negative control)."""

        def calculate(self, *args, **kw):
            out = super().calculate(*args, **kw)
            return dict(out, **{keys.FORCES: out[keys.FORCES] * 1.01})

    xyz = os.path.join(tmp, "chain.xyz")
    write_xyz(xyz, [Datapoint(zf, posf)])
    drifts = {}
    for tag, route, cls in (("mega", "mega", Calculator), ("plain", None, Calculator),
                            ("control", "mega", Scaled)):
        traj = os.path.join(tmp, f"traj_{tag}.xyz")
        over = dict(input_file=xyz, model_file=ck32, pallas=route, skin=0.5, seed=0,
                    init_temperature=300.0, device=str(device), xyz_traj=traj,
                    ensembles=[{"name": "nve", "timestep": MD_DT, "steps": sizes["md_steps"],
                                "log_interval": 5}])
        log = _Lines()
        cuda_build.reset_launch_counts()
        dynamics.Calculator = cls
        try:
            t0 = time.perf_counter()
            state = run_md(load_md_config(overrides=over), logger=log)
            sync()
            wall = time.perf_counter() - t0
        finally:
            dynamics.Calculator = Calculator
        e = md_energies(log.lines)
        tot = e.sum(axis=1)
        drifts[tag] = float(np.abs(tot - tot[0]).max() / len(zf))
        if tag == "control":
            print(f"[md] (c) negative control, the mega route with forces x 1.01: drift "
                  f"{drifts[tag]:.3e} eV per atom")
            break
        n_calls = 1 + sizes["md_steps"] + len(e)  # first forces, one per step, one per log
        counts = dict(cuda_build.LAUNCHES)
        print(f"[md] (c) run_md NVE on the {tag} route: {sizes['md_steps']} steps of {MD_DT} fs, "
              f"{wall / sizes['md_steps'] * 1e3:.2f} ms per step (wall, with {len(e)} logged "
              f"energy calls), total-energy drift {drifts[tag]:.3e} eV per atom over the logged "
              f"steps, launches {counts} — {card}")
        if state.step != sizes["md_steps"] or not np.isfinite(state.pos).all() or len(e) == 0:
            fail(f"(c) run_md on the {tag} route did not finish")
        if card_run:
            want = 3 * n_calls if route else 0
            if counts["message_fwd"] != want or counts["message_bwd"] != want or \
                    sum(counts.values()) != 2 * want:
                fail(f"(c) {tag}: expected {want} + {want} message launches, got {counts}")
        if route:  # the mega run's energies at its own frames, on the plain route
            frames = read_xyz(traj)
            ref = Calculator(ck32, device=device, **caps_f)
            outs = [ref.calculate(zf, f.pos) for f in frames]
            errs = [abs(o[keys.TOTAL_ENERGY] - ep) / abs(ep) for o, ep in zip(outs, e[:, 0])]
            acc = np.linalg.norm(outs[0][keys.FORCES], axis=-1) / ATOM_MASS[zf]
            print(f"[md] (c) the mega run's logged Epot at its {len(frames)} frames against the "
                  f"plain route there: max rel diff {max(errs):.3e} (limit 1e-4); max |F| / m at "
                  f"the first frame {acc.max():.1f} eV/A/amu")
            if len(frames) != len(e) or max(errs) > 1e-4:
                fail("(c) the mega run's energies disagree with the plain route at its frames")
    limit = 2 * drifts["plain"] + 1e-4
    if not drifts["mega"] <= limit < drifts["control"]:
        fail(f"(c) NVE drift: mega route {drifts['mega']:.3e} eV/atom, negative control "
             f"{drifts['control']:.3e}; the limit 2 x the plain route's + 1e-4 = {limit:.3e} "
             f"must lie between them")
    return {"launches": launches}


# ---------------------------------------------------------------------------
# Phase 8: XPaiNN-Ewald (periodic and free) and the conditioned multi-head
# XPaiNN
# ---------------------------------------------------------------------------
# bench.py build_crystal_batch's slot layout (CRYSTAL_BN 128, chunk 512,
# pad_nodes 32, 128 chunks)
CRYSTAL_LAYOUT = (128, 512, 32, 128)
# bench.py's pbc_ewald_mega path at FLAGSHIP_KW: one reciprocal-cell Ewald
# block, num_k_points (3, 3, 3) (K = 171 k-points), projection_dim 8
EWALD_PBC = dict(use_pbc=True, num_k_points=[3, 3, 3], projection_dim=8, ewald_blocks=1)
# its free variant (bench.py's ewald path): the k-voxel grid at k_cutoff
# 0.4, delta_k 0.2 (K = 13 k-points), 20 k-bases
EWALD_FREE = dict(use_pbc=False, k_cutoff=0.4, delta_k=0.2, num_k_basis=20,
                  projection_dim=8, ewald_blocks=1)
# XPaiNN conditioned on charge and spin, with the non-Cartesian heads
MULTI_HEADS = dict(charge_embed=True, spin_embed=True,
                   output_modes=["energy", "charges", "dipole", "polar", "spatial"])
# bench.py's crystal training recipe (_train_step_metric with the virial)
EWALD_TASK = ("xpainn-ewald", {"energy": 1.0, "forces": 10.0, "virial": 1.0}, True)
# f32 virial, mega against plain route, on the crystal batch: mean |virial|
# at the f32 aggregate limit, element-wise max |dV| / max |V| at the JAX
# package's f32 virial band (tests/test_pbc_mega.py)
EWALD_F32_VIRIAL_TOL = (1e-4, 1e-3)
# phase 8's sizes on the card and in the CPU rehearsal
EWALD_SIZES = dict(n_cells=640, train_steps=10, md=MD_SIZES, kw={},
                   layout=(BN, CHUNK, PAD_NODES, MAX_CHUNKS))
EWALD_REHEARSAL = dict(n_cells=8, train_steps=2, md=MD_REHEARSAL, kw=MD_REHEARSAL["kw"],
                       layout=(32, 32, PAD_NODES, MAX_CHUNKS))


def build_crystals(n_cells, seed=1234, cutoff=5.0):
    """bench.py build_crystal_batch's cells (same rng draws): 8-16 atoms in
    a skewed cell of 4.5-6.5 A, with energy, force and virial labels."""
    from xequinet_torch.data.datapoint import Datapoint
    from xequinet_torch.ops.radius_graph import radius_graph_pbc_np

    rng = np.random.default_rng(seed)
    dps = []
    for _ in range(n_cells):
        n = int(rng.integers(8, 17))
        cell = np.diag(rng.uniform(4.5, 6.5, size=3)) + rng.normal(size=(3, 3)) * 0.15
        pos = rng.uniform(0, 1, size=(n, 3)) @ cell
        pbc = np.array([True, True, True])
        ei, offs = radius_graph_pbc_np(pos, cell, pbc, cutoff)
        dps.append(Datapoint(
            rng.integers(1, 9, size=n).astype(np.int32), pos, cell=cell, pbc=pbc,
            edge_index=ei, cell_offsets=offs, energy=float(rng.normal()),
            forces=rng.normal(size=(n, 3)).astype(np.float32),
            virial=rng.normal(size=(3, 3)).astype(np.float32)))
    return dps


def ewald_k(module):
    """The number of k-points of a model's Ewald initial block."""
    from xequinet_torch.models.ewald import EwaldInitialPBC

    init = next(m for m in module.blocks if hasattr(m, "k_index") or hasattr(m, "k_grid"))
    return (init.k_index if isinstance(init, EwaldInitialPBC) else init.k_grid).shape[0]


def path_launches(tag, card_run, **want):
    """The launch counts since the last reset, held to ``want`` on the card
    (the CPU runs the plain versions and counts nothing)."""
    from xequinet_torch.ops import cuda_build

    if card_run:
        return expect_launches(tag, **want)
    return dict(cuda_build.LAUNCHES)


def twins(device, model, over, state, **variants):
    """Engines of ``model`` (FLAGSHIP_KW with ``over`` and each variant's
    overrides), all carrying the weights ``state``."""
    out = {}
    for name, extra in variants.items():
        out[name] = make_engine(device, model, **dict(over, **extra))
        out[name].module.load_state_dict(state)
    return out


def compare_virial(tag, got, want, n_graphs, mean_tol, elem_tol):
    """Mean |virial| relative difference and max |dV| / max |V| over every
    element of the real graphs."""
    from xequinet_torch import keys

    vg, vw = got[keys.VIRIAL][:n_graphs].cpu(), want[keys.VIRIAL][:n_graphs].cpu()
    mean = abs(float(vg.abs().mean()) - float(vw.abs().mean())) / float(vw.abs().mean())
    elem = rel_err(vg, vw)
    print(f"[ewald] {tag}: mean|virial| rel diff {mean:.3e} (limit {mean_tol:g}), "
          f"max|dV|/max|V| {elem:.3e} (limit {elem_tol:g})")
    if not (mean <= mean_tol and elem <= elem_tol):
        fail(f"{tag}: the virial disagrees")


def bf16_virial_band(tag, got16, plain16, want32, n_graphs):
    """The bf16 mega route's mean |virial| no further from the f32 plain
    route's than 2e-2 plus twice the bf16 plain route's own largest
    distance over its calls ``plain16`` (phase 7's band: bf16 rounding
    alone moves the strain virial by per cents, and the plain route's
    atomic sums move it from call to call).  The element-wise difference
    from the bf16 plain route is printed, not held, as bf16 forces are."""
    from xequinet_torch import keys

    mean_v = lambda o: float(o[keys.VIRIAL][:n_graphs].abs().mean())
    ref = mean_v(want32)
    d_m = abs(mean_v(got16) - ref) / ref
    d_p = [abs(mean_v(o) - ref) / ref for o in plain16]
    limit = TOL["bfloat16"] + 2 * max(d_p)
    elem = rel_err(got16[keys.VIRIAL][:n_graphs].cpu(), plain16[0][keys.VIRIAL][:n_graphs].cpu())
    print(f"[ewald] {tag} bf16 mean |virial| against the f32 plain route's: mega route "
          f"{d_m:.3e}, plain route " + ", ".join(f"{d:.3e}" for d in d_p)
          + f" ({len(d_p)} calls; limit for mega: 2e-2 + 2 x the largest = {limit:.3e}); "
          f"max|dV|/max|V| against the bf16 plain route {elem:.3e} (limit none)")
    if d_m > limit:
        fail(f"{tag}: the mega route's bf16 virial is further from f32 than the band")


def head_errors(got, want, n_graphs, n_atoms, elementwise):
    """The dipole, polarizability and spatial extent per graph (max |err| /
    max |ref|); the atomic charges element-wise (``elementwise``) or by
    their mean |q| (bf16: the routes round at different points, as for
    forces)."""
    from xequinet_torch import keys

    errs = {k: rel_err(got[k][:n_graphs].cpu(), want[k][:n_graphs].cpu())
            for k in (keys.DIPOLE, keys.POLARIZABILITY, keys.SPATIAL_EXTENT)}
    qg = got[keys.ATOMIC_CHARGES][:n_atoms].cpu()
    qw = want[keys.ATOMIC_CHARGES][:n_atoms].cpu()
    if elementwise:
        errs["charges"] = rel_err(qg, qw)
    else:
        errs["mean|q|"] = abs(float(qg.abs().mean()) - float(qw.abs().mean())) / \
            float(qw.abs().mean())
    return errs


def compare_heads(tag, got, want, n_graphs, n_atoms, tol, elementwise):
    """:func:`head_errors` within ``tol``."""
    errs = head_errors(got, want, n_graphs, n_atoms, elementwise)
    print(f"[heads] {tag}: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (limit {tol:g})")
    if not all(np.isfinite(v) and v <= tol for v in errs.values()):
        fail(f"{tag}: a head disagrees")


def device_ms(fn, calls=3):
    """(wall ms, device-busy ms) per call of ``fn`` under torch.profiler,
    after a warm-up."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    dev = lambda e: getattr(e, "self_device_time_total", None) or \
        getattr(e, "self_cuda_time_total", 0.0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / calls
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    return wall, sum(dev(e) for e in kernels) / 1e3 / calls


def ewald_share(eng, batch, card):
    """The Ewald blocks' share of the device time of one forward + forces
    + virial (torch.profiler): the model from its Ewald initial block on
    (forward, and the backward to the node scalars, positions and cell that
    forces and virial need), run alone on the inputs the earlier blocks
    give it, against the whole call."""
    from xequinet_torch import keys
    from xequinet_torch.models.ewald import EwaldInitialNonPBC, EwaldInitialPBC
    from xequinet_torch.models.properties import compute_edge_data
    from xequinet_torch.run.inference import batch_to_device

    blocks = list(eng.module.blocks)
    i0 = next(i for i, m in enumerate(blocks)
              if isinstance(m, (EwaldInitialPBC, EwaldInitialNonPBC)))
    data = batch_to_device(batch, eng.device)
    with torch.no_grad():
        d = compute_edge_data(data)
        for m in blocks[:i0]:
            d = m(d)
    leaves = {k: d[k].detach().requires_grad_(True)
              for k in (keys.NODE_INVARIANT, keys.POSITIONS, keys.CELL)}

    def part():
        with torch.enable_grad():
            x = dict(d, **leaves)
            for m in blocks[i0:]:
                x = m(x)
            torch.autograd.grad(x[keys.TOTAL_ENERGY][data[keys.GRAPH_MASK]].sum(),
                                list(leaves.values()))

    w_all, b_all = device_ms(lambda: eng.forward_batch(batch, True, True))
    w_part, b_part = device_ms(part)
    print(f"[ewald] (a) torch.profiler, forward+forces+virial: whole call {b_all:.3f} ms of "
          f"device time (wall {w_all:.3f} ms, idle share {max(0.0, 1 - b_all / w_all):.3f}); "
          f"the Ewald blocks and their head, forward and backward, {b_part:.3f} ms: share "
          f"{b_part / b_all:.3f} — {card}")
    return b_part / b_all


def phase_ewald_pbc(device, card, sizes):
    """Phase 8 (a): bench.py's pbc_ewald_mega path at full width.  The
    periodic XPaiNN-Ewald (FLAGSHIP_KW + EWALD_PBC, seeded weights) on
    bench.py's crystal batch (rng 1234, 640 cells of 8-16 atoms, layout
    CRYSTAL_LAYOUT) served by InferenceEngine.predict with forces and
    virial through the kernels (3 + 3 message launches); against the plain
    route with the same weights: bf16 energies and mean |F| (2e-2) and the
    mean |virial| band, f32 energies and mean |F| (1e-4), forces
    element-wise (F32_FORCE_TOL) and the virial (EWALD_F32_VIRIAL_TOL);
    then training on bench.py's recipe with the virial term (3 + 6 + 3
    launches per step, a falling loss) and one f32 step against the plain
    route's.  Returns the launch counts and the engine and batch for (d)'s
    weights."""
    from xequinet_torch import keys
    from xequinet_torch.data.batching import collate
    from xequinet_torch.ops import cuda_build
    from xequinet_torch.run.inference import batch_to_device

    card_run = device.type == "cuda"
    dps = build_crystals(sizes["n_cells"])
    n_g, n_at = len(dps), sum(d.num_atoms for d in dps)
    over = dict(EWALD_PBC, pallas_layout=CRYSTAL_LAYOUT, **sizes["kw"])
    eng = make_engine(device, "xpainn-ewald", **over)
    n_k = ewald_k(eng.module)
    cuda_build.reset_launch_counts()
    res = eng.predict(dps, compute_forces=True, compute_virial=True)
    if card_run:
        torch.cuda.synchronize()
    predict = path_launches("(a) pbc ewald mega predict with forces and virial", card_run,
                            message_fwd=3, message_bwd=3)
    e = np.array([float(r[keys.TOTAL_ENERGY]) for r in res])
    f = np.concatenate([r[keys.FORCES] for r in res])
    v = np.stack([r[keys.VIRIAL] for r in res])
    if f.shape != (n_at, 3) or v.shape != (n_g, 3, 3) or not (
            np.isfinite(e).all() and np.isfinite(f).all() and np.isfinite(v).all()):
        fail("(a): predict returned wrong shapes or non-finite outputs")
    mega_b = eng.collate(dps)
    n_real = int(mega_b[keys.EDGE_MASK].sum())
    n_rows = mega_b[keys.POSITIONS].shape[0]
    print(f"[ewald] (a) {n_g} cells, {n_at} atoms, {n_real} edges, {n_rows} node rows, K = "
          f"{n_k} k-points; [N, K, D] f32 would be {n_rows * n_k * 128 * 4 / 2**30:.3f} GiB "
          f"per tensor; energy mean {e.mean():.6f}, mean|F| {np.abs(f).mean():.6f}, "
          f"mean|virial| {np.abs(v).mean():.6f}")
    eng_t = twins(device, "xpainn-ewald", over, eng.module.state_dict(),
                  plain={"use_pallas_scatter": False}, k32=F32,
                  p32=dict(F32, use_pallas_scatter=False))
    plain_b = eng_t["plain"].collate(dps)
    fb = lambda x, b: x.forward_batch(b, True, True)
    got16, want16 = fb(eng, mega_b), fb(eng_t["plain"], plain_b)
    got32, want32 = fb(eng_t["k32"], mega_b), fb(eng_t["p32"], plain_b)
    compare_outputs("(a) pbc ewald, bf16 mega vs plain route", got16, want16, n_g, n_at,
                    TOL["bfloat16"])
    bf16_virial_band("(a) pbc ewald", got16,
                     [want16] + [fb(eng_t["plain"], plain_b) for _ in range(2)], want32, n_g)
    compare_outputs("(a) pbc ewald, f32 mega vs plain route", got32, want32, n_g, n_at, 1e-4,
                    F32_FORCE_TOL)
    compare_virial("(a) pbc ewald, f32 mega vs plain route", got32, want32, n_g,
                   *EWALD_F32_VIRIAL_TOL)
    del eng_t, got16, want16, got32, want32
    if card_run:
        torch.cuda.empty_cache()
        dev_ms = time_ms(lambda: fb(eng, mega_b), iters=5, warmup=1)
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        fb(eng, mega_b)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        print(f"[time] (a) pbc ewald mega device forward+forces+virial (CUDA events): "
              f"{dev_ms:.3f} ms, {n_real / (dev_ms / 1e3):.1f} edges/s; peak device memory "
              f"{peak / 2**30:.3f} GiB, {(peak - held) / 2**30:.3f} GiB above the "
              f"{held / 2**30:.3f} GiB held — {card}")
        ewald_share(eng, mega_b, card)

    lay = dict(zip(("block_nodes", "chunk", "pad_nodes", "max_chunks"), CRYSTAL_LAYOUT))
    b = batch_to_device(collate(dps, kernel_layout=lay), device)
    ref = plain_f32_reference(dps, device, EWALD_TASK, **over)
    per_step, step, ema = phase_training(
        "pbc ewald mega", over, sizes["train_steps"],
        dict(message_fwd=3, message_bwd=6, message_bwd2=3), b, ref, device, card, EWALD_TASK)
    del ref
    if card_run:
        time_train_step("pbc ewald mega, energy + forces + virial, 3 + 6 + 3 message kernels",
                        step, b, ema, sizes["train_steps"], n_real, card)
    return predict, per_step


def phase_ewald_free(dps, device, card, sizes):
    """Phase 8 (b): the free XPaiNN-Ewald (FLAGSHIP_KW + EWALD_FREE) on the
    molecule batch of phase 3, through the kernels (3 + 3 launches per
    predict with forces), against the plain route: bf16 energies and mean
    |F|, f32 also every force component."""
    from xequinet_torch.ops import cuda_build

    card_run = device.type == "cuda"
    over = dict(EWALD_FREE, pallas_layout=sizes["layout"], **sizes["kw"])
    eng = make_engine(device, "xpainn-ewald", **over)
    cuda_build.reset_launch_counts()
    eng.predict(dps)
    if card_run:
        torch.cuda.synchronize()
    launches = path_launches("(b) free ewald mega predict with forces", card_run,
                             message_fwd=3, message_bwd=3)
    n_g, n_at = len(dps), sum(d.num_atoms for d in dps)
    eng_t = twins(device, "xpainn-ewald", over, eng.module.state_dict(),
                  plain={"use_pallas_scatter": False}, k32=F32,
                  p32=dict(F32, use_pallas_scatter=False))
    mega_b, plain_b = eng.collate(dps), eng_t["plain"].collate(dps)
    print(f"[ewald] (b) free: K = {ewald_k(eng.module)} k-points")
    compare_outputs("(b) free ewald, bf16 mega vs plain route", eng.forward_batch(mega_b),
                    eng_t["plain"].forward_batch(plain_b), n_g, n_at, TOL["bfloat16"])
    compare_outputs("(b) free ewald, f32 mega vs plain route",
                    eng_t["k32"].forward_batch(mega_b), eng_t["p32"].forward_batch(plain_b),
                    n_g, n_at, 1e-4, F32_FORCE_TOL)
    return launches


def multihead_inputs(dps, device, sizes):
    """Phase 8 (c)'s molecules (phase 3's with random integer charges
    -2..2 and spins 0..2) and its engine (FLAGSHIP_KW + MULTI_HEADS, mega
    route) with its plain-route twins in bf16 and f32: (dpc, eng, twins)."""
    from xequinet_torch.data.datapoint import Datapoint

    rng = np.random.default_rng(4321)
    dpc = [Datapoint(d.atomic_numbers, d.pos, edge_index=d.edge_index,
                     charge=int(rng.integers(-2, 3)), spin=int(rng.integers(0, 3)))
           for d in dps]
    over = dict(MULTI_HEADS, pallas_layout=sizes["layout"], **sizes["kw"])
    eng = make_engine(device, **over)
    eng_t = twins(device, "xpainn", over, eng.module.state_dict(),
                  plain={"use_pallas_scatter": False}, k32=F32,
                  p32=dict(F32, use_pallas_scatter=False))
    return dpc, eng, eng_t


def phase_multihead(dps, device, card, sizes):
    """Phase 8 (c): XPaiNN conditioned on charge and spin with the energy,
    charges, dipole, polar and spatial heads on the molecule batch of phase
    3 (:func:`multihead_inputs`), served through the kernels (3 + 3
    launches per predict); against the plain route: bf16 energies, mean
    |F|, each per-graph head within 2e-2 and mean |q|; f32 within 1e-4,
    forces and charges element-wise; the f32 charges sum to each graph's
    charge within 1e-4.  The compared calls run under deterministic sums:
    with the default float atomics both routes' bf16 dipoles move from
    call to call, and once landed 2.4e-2 apart on code the check had
    passed (on an H100; ``check_repeat.py --check heads`` measures both
    modes)."""
    from xequinet_torch import keys
    from xequinet_torch.ops import cuda_build

    card_run = device.type == "cuda"
    dpc, eng, eng_t = multihead_inputs(dps, device, sizes)
    cuda_build.reset_launch_counts()
    res = eng.predict(dpc)
    if card_run:
        torch.cuda.synchronize()
    launches = path_launches("(c) multi-head mega predict with forces", card_run,
                             message_fwd=3, message_bwd=3)
    want_keys = {keys.TOTAL_ENERGY, keys.FORCES, keys.ATOMIC_ENERGIES, keys.ATOMIC_CHARGES,
                 keys.DIPOLE, keys.POLARIZABILITY, keys.SPATIAL_EXTENT}
    if any(set(r) != want_keys or not all(np.isfinite(x).all() for x in r.values())
           for r in res):
        fail(f"(c): predict did not return finite {sorted(want_keys)}")
    n_g, n_at = len(dpc), sum(d.num_atoms for d in dpc)
    mega_b, plain_b = eng.collate(dpc), eng_t["plain"].collate(dpc)
    with deterministic_sums():
        got16, want16 = eng.forward_batch(mega_b), eng_t["plain"].forward_batch(plain_b)
        got32 = eng_t["k32"].forward_batch(mega_b)
        want32 = eng_t["p32"].forward_batch(plain_b)
    compare_outputs("(c) multi-head, bf16 mega vs plain route", got16, want16, n_g, n_at,
                    TOL["bfloat16"])
    compare_heads("bf16 mega vs plain route", got16, want16, n_g, n_at, TOL["bfloat16"], False)
    compare_outputs("(c) multi-head, f32 mega vs plain route", got32, want32, n_g, n_at, 1e-4,
                    F32_FORCE_TOL)
    compare_heads("f32 mega vs plain route", got32, want32, n_g, n_at, 1e-4, True)
    q = got32[keys.ATOMIC_CHARGES].cpu().double().numpy()
    nm = mega_b[keys.NODE_MASK]
    totals = np.bincount(mega_b[keys.BATCH][nm], weights=q[nm], minlength=n_g + 1)[:n_g]
    err = float(np.abs(totals - np.array([d.charge for d in dpc])).max())
    print(f"[heads] f32 mega route: the atomic charges sum to each graph's charge within "
          f"{err:.3e} (limit 1e-4)")
    if err > 1e-4:
        fail("(c): the atomic charges do not sum to the graphs' charges")
    return launches


def phase_ewald_md(device, card, tmp, sizes):
    """Phase 8 (d): Calculator(pallas="mega", skin=0.5) serving the (a)
    model (a bf16 checkpoint and an f32 twin, seed-0 weights as in (a)) on
    phase 7's 10,000-atom periodic box, driven 0.01 A per call until both
    have swapped in a list built by the skin's worker (on the card), then
    one call against plain Calculators on the same positions, as phase 7
    (a) does (md_agreement: the ghost rows on the mega route, 3 + 3
    launches per call)."""
    import os

    from xequinet_torch.interface.calculator import Calculator
    from xequinet_torch.ops.radius_graph import radius_graph_pbc_np

    card_run = device.type == "cuda"
    md = sizes["md"]
    kw = dict(EWALD_PBC, **md["kw"])
    ck16 = md_checkpoint(os.path.join(tmp, "ewald_bf16.ckpt"), "xpainn-ewald", **kw)
    ck32 = md_checkpoint(os.path.join(tmp, "ewald_f32.ckpt"), "xpainn-ewald",
                         **dict(kw, **F32))
    z, pos, cell, pbc, rng = md_box(md["n_box"])
    box = dict(cell=cell, pbc=pbc)
    ei, _ = radius_graph_pbc_np(pos, cell, pbc, 5.0)
    caps = dict(max_atoms=md["max_box"], max_edges=md_edge_cap(ei.shape[1]))
    hot = [Calculator(ck, pallas="mega", skin=0.5, compute_virial=True, device=device, **caps)
           for ck in (ck16, ck32)]
    calls = 0
    while True:
        for c in hot:
            c.calculate(z, pos, **box)
            if c.last_route != "mega":
                fail("(d): the ewald Calculator left the mega route")
        calls += 1
        if min(c.n_async_swaps for c in hot) >= 1 or (not card_run and calls >= 2):
            break
        if calls >= 60:
            fail("(d): no list built by the skin's worker thread was swapped in")
        pos = pos + rng.normal(size=pos.shape) * 0.01
    print(f"[ewald] (d) {len(z)}-atom periodic box, Calculator(pallas='mega', skin=0.5) of the "
          f"(a) model: {calls} calls; n_rebuilds / n_async_swaps: bf16 {hot[0].n_rebuilds} / "
          f"{hot[0].n_async_swaps}, f32 {hot[1].n_rebuilds} / {hot[1].n_async_swaps}")
    plain = [Calculator(ck, skin=0.5, compute_virial=True, device=device, **caps)
             for ck in (ck16, ck32)]
    synced = [c.n_rebuilds - c.n_async_swaps for c in hot]
    md_agreement("(d) periodic box, the ewald Calculators after a worker swap", z, pos,
                 {"bf16": (hot[0], plain[0]), "f32": (hot[1], plain[1])}, card_run, **box)
    if [c.n_rebuilds - c.n_async_swaps for c in hot] != synced:
        fail("(d): a compared call rebuilt its list: the skin's list was not what served it")
    for c in hot + plain:
        c.close()


def phase_ewald(dps, device, card, tmp, sizes):
    """Phase 8: (a)-(d); returns the message kernels' launches per path."""
    out = {}
    out["pbc_ewald_predict"], out["pbc_ewald_train_step"] = phase_ewald_pbc(device, card,
                                                                            sizes)
    out["free_ewald_predict"] = phase_ewald_free(dps, device, card, sizes)
    out["multihead_predict"] = phase_multihead(dps, device, card, sizes)
    phase_ewald_md(device, card, tmp, sizes)
    return out


# ---------------------------------------------------------------------------
# Phase 9: PaiNN, SO3krates, the Cartesian tensor head and XMatNet
# ---------------------------------------------------------------------------
# (a) PaiNN and (b) SO3krates at their builders' defaults: node_dim 128 /
# 120, 3 blocks, 20 Bessel bases, cosine cutoff 5.0, the gfn2-xtb aux56
# embedding, f32; SO3krates with 32 channels of every l up to max_l 3 and
# 4 heads.  Neither runs a kernel: their messages are plain segment sums,
# in the JAX package too
PAINN_KW, SO3_KW = {}, {}
# (c) the Cartesian head (order 2, "ij") on the flagship XPaiNN
CART_KW = dict(output_modes=["energy", "cartesian"], order=2, symmetry="ij",
               hidden_channels=32, hidden_dim=64)
# (d) XMatNet on the flagship backbone; the target basis is def2-SVP's shell
# structure, H to O (union basis 3x0e+2x1o+1x2e, D = 14)
SVP_SHELLS = {"H": [0, 0, 1], "He": [0, 0, 1], "Li": [0, 0, 0, 1, 1], "Be": [0, 0, 0, 1, 1],
              **{e: [0, 0, 0, 1, 1, 2] for e in ("B", "C", "N", "O")}}
XMAT_KW = dict(hidden_irreps="32x0e+32x1o+32x2e", n_mat_layers=2, target_basis=SVP_SHELLS,
               elements=list(SVP_SHELLS))
ZOO_TASKS = {
    "painn": ("painn", TRAIN_WEIGHTS, False),
    "so3krates": ("so3krates", TRAIN_WEIGHTS, False),
    "cartesian": ("xpainn", {"energy": 1.0, "forces": 10.0, "cartesian_tensor": 1.0}, False),
    "xmatnet": ("xmatnet", {"node_mat_blocks": 1.0, "edge_mat_blocks": 1.0}, False),
}
# PaiNN trains on the molecules whose closest pair is at least 0.5 A apart
# (shorter than any chemical bond; H2's is 0.74 A).  bench.py's recipe puts
# atoms at random, and on its 33 molecules with a pair under 0.3 A PaiNN at
# seed-0 weights reaches energies up to 2.5e17 and forces up to 2.8e19, in
# both packages alike (no layer norm tames its quadratic update): past
# f32's range in the force loss.  Serving and its holds keep every molecule
PAINN_MIN_CONTACT = 0.5
# phase 9's sizes on the card and in the CPU rehearsal ("kw": each cell's
# model kwargs on top of its defaults)
ZOO_SIZES = dict(n_ref=64, train_steps=10, layout=(BN, CHUNK, PAD_NODES, MAX_CHUNKS),
                 kw={"painn": PAINN_KW, "so3krates": SO3_KW, "cartesian": CART_KW,
                     "xmatnet": XMAT_KW})
ZOO_REHEARSAL = dict(
    n_ref=4, train_steps=2, layout=(32, 32, PAD_NODES, MAX_CHUNKS),
    kw={"painn": dict(node_dim=16, action_blocks=2),
        "so3krates": dict(node_dim=24, node_channel=4, action_blocks=2),
        "cartesian": dict(CART_KW, hidden_channels=4, hidden_dim=8, **MD_REHEARSAL["kw"]),
        "xmatnet": dict(XMAT_KW, hidden_irreps="4x0e+4x1o+4x2e", **MD_REHEARSAL["kw"])})


def rotated(dps, rot):
    """Copies of ``dps`` turned by the geometric rotation ``rot``, on the
    same edges (so that every row and slot lines up)."""
    from xequinet_torch.data.datapoint import Datapoint

    return [Datapoint(d.atomic_numbers, d.pos @ rot.T, edge_index=d.edge_index) for d in dps]


def random_rotation(seed):
    q, r = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    return q if np.linalg.det(q) > 0 else -q


def bf16_band(tag, got16, plain16, want32):
    """max |err| / max of the bf16 mega route's ``got16`` against the f32
    plain route's ``want32``, held within 2e-2 plus twice the bf16 plain
    route's own distance from f32 (``plain16``), phase 7's band: the two
    bf16 routes round at different points, and a quantity quadratic in
    the node features (the tensor, the blocks) doubles their rounding."""
    d_m, d_p = rel_err(got16, want32), rel_err(plain16, want32)
    limit = TOL["bfloat16"] + 2 * d_p
    print(f"[zoo] {tag} bf16 max|err|/max against the f32 plain route: mega route {d_m:.3e}, "
          f"plain route {d_p:.3e} (limit for mega: 2e-2 + 2 x plain = {limit:.3e}); mega "
          f"against the bf16 plain route {rel_err(got16, plain16):.3e} (limit none)")
    if not d_m <= limit:
        fail(f"{tag}: the mega route's bf16 output is further from f32 than the band")


def held(tag, err, tol):
    print(f"[zoo] {tag}: {err:.3e} (limit {tol:g})")
    if not err <= tol:
        fail(f"{tag}: {err:.3e} past the limit {tol:g}")


def zoo_times(tag, eng, dps, batch, forces, card, head=False):
    """The served call's device time (CUDA events), edges/s and the
    predict wall time (neighbour lists + collate + device + host copy,
    median of 3); under torch.profiler its device-busy time and idle
    share, and with ``head`` the device time of the model's last block
    (the Cartesian head, XMatNet's MatOut) run alone on the inputs the
    earlier blocks give it, and its share."""
    from xequinet_torch import keys
    from xequinet_torch.models.properties import compute_edge_data
    from xequinet_torch.run.inference import batch_to_device

    w_all, b_all = device_ms(lambda: eng.forward_batch(batch, forces))
    line = (f"[time] {tag} torch.profiler, {'forward+forces' if forces else 'forward'}: "
            f"{b_all:.3f} ms of device time in {w_all:.3f} ms of wall (idle share "
            f"{max(0.0, 1 - b_all / w_all):.3f})")
    if head:
        blocks = list(eng.module.blocks)
        with torch.no_grad():
            d = compute_edge_data(batch_to_device(batch, eng.device))
            for m in blocks[:-1]:
                d = m(d)

            def last():
                with torch.no_grad():
                    blocks[-1](dict(d))

            _, b_head = device_ms(last)
        line += f"; {type(blocks[-1]).__name__} alone {b_head:.3f} ms, share {b_head / b_all:.3f}"
    print(line + f" — {card}")

    n_real = int(batch[keys.EDGE_MASK].sum())
    dev_ms = time_ms(lambda: eng.forward_batch(batch, forces), iters=5, warmup=1)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        eng.predict(dps, compute_forces=forces)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))
    what = "forward+forces" if forces else "forward"
    print(f"[time] {tag} device {what} (CUDA events): {dev_ms:.3f} ms, "
          f"{n_real / (dev_ms / 1e3):.1f} edges/s; predict wall, median of 3: "
          f"{wall * 1e3:.1f} ms, {n_real / wall:.1f} edges/s — {card}")


def zoo_train(tag, cell, b, want, device, card, sizes, dtype):
    """10 steps of the cell's task on the batch ``b`` (launches per step
    ``want``, a falling loss), then on the card 7 timed steps and the peak
    memory.  Returns the launches per step."""
    over = dict(sizes["kw"][cell])
    if cell in ("cartesian", "xmatnet"):
        over["pallas_layout"] = sizes["layout"]
    per_step, step, ema = phase_training(tag, over, sizes["train_steps"], want, b, None,
                                         device, card, ZOO_TASKS[cell])
    if device.type == "cuda":
        from xequinet_torch import keys

        time_train_step(tag, step, b, ema, sizes["train_steps"],
                        int(b[keys.EDGE_MASK].sum()), card, dtype)
    del step, ema
    return per_step


def phase_zoo_f32(cell, dps, device, card, sizes):
    """Phase 9 (a) / (b): PaiNN or SO3krates (f32, seeded weights) served by
    InferenceEngine.predict with forces on the card with no kernel launch;
    the first ``n_ref`` molecules on the card against the port's own CPU
    run of the same weights (energy 1e-4 relative, forces through
    F32_FORCE_TOL) and against a random rotation of themselves (the energy
    unchanged, the forces rotated, within the same limits); then training
    on bench.py's recipe (no launch, a falling loss; PaiNN on the molecules
    without a pair closer than PAINN_MIN_CONTACT)."""
    from xequinet_torch import keys
    from xequinet_torch.data.batching import collate
    from xequinet_torch.ops import cuda_build
    from xequinet_torch.run.inference import batch_to_device

    tag = "a" if cell == "painn" else "b"
    card_run = device.type == "cuda"
    eng = make_engine(device, cell, **sizes["kw"][cell])
    cuda_build.reset_launch_counts()
    res = eng.predict(dps)
    if card_run:
        torch.cuda.synchronize()
    predict = path_launches(f"({tag}) {cell} predict with forces", card_run)
    e = np.array([float(r[keys.TOTAL_ENERGY]) for r in res])
    f = np.concatenate([r[keys.FORCES] for r in res])
    if f.shape != (sum(d.num_atoms for d in dps), 3) or not (np.isfinite(e).all()
                                                             and np.isfinite(f).all()):
        fail(f"({tag}): predict returned wrong shapes or non-finite outputs")
    n_params = sum(p.numel() for p in eng.module.parameters())
    print(f"[zoo] ({tag}) {cell}, {n_params / 1e6:.3f}M parameters: energy mean "
          f"{e.mean():.6f}, mean|F| {np.abs(f).mean():.6f}")
    sub = dps[:sizes["n_ref"]]
    n_g, n_at = len(sub), sum(d.num_atoms for d in sub)
    b = eng.collate(sub)
    got = eng.forward_batch(b)
    cpu = make_engine(torch.device("cpu"), cell, **sizes["kw"][cell])
    cpu.module.load_state_dict(eng.module.state_dict())
    compare_outputs(f"({tag}) {cell} f32, card vs the port on the CPU", got,
                    cpu.forward_batch(b), n_g, n_at, 1e-4, F32_FORCE_TOL)
    rot = random_rotation(90 + len(cell))
    got_r = eng.forward_batch(eng.collate(rotated(sub, rot)))
    turned = dict(got, **{keys.FORCES: got[keys.FORCES] @ torch.as_tensor(
        rot.T, dtype=got[keys.FORCES].dtype, device=got[keys.FORCES].device)})
    compare_outputs(f"({tag}) {cell} f32 on the card, rotated molecules vs rotated outputs",
                    got_r, turned, n_g, n_at, 1e-4, F32_FORCE_TOL)
    if card_run:
        zoo_times(f"({tag}) {cell}", eng, dps, eng.collate(dps), True, card)
    del eng, cpu
    train_dps = dps
    if cell == "painn":
        close = np.array([closest_pair(d) < PAINN_MIN_CONTACT for d in dps])
        train_dps = [d for d, c in zip(dps, close) if not c]
        print(f"[zoo] (a) painn trains on the {len(train_dps)} molecules without a pair closer "
              f"than {PAINN_MIN_CONTACT} A; served, the {int(close.sum())} others reach max|E| "
              f"{np.abs(e[close]).max(initial=0):.3e} (the rest {np.abs(e[~close]).max():.3e})")
    b = batch_to_device(collate(train_dps), device)
    return predict, zoo_train(f"{cell} f32", cell, b, {}, device, card, sizes, "f32")


def closest_pair(d):
    r = np.linalg.norm(d.pos[:, None] - d.pos[None], axis=-1)
    return float(r[np.triu_indices(d.num_atoms, 1)].min())


def cartesian_labels(dps, seed=1235):
    """Copies of ``dps`` with a random per-graph 3 x 3 Cartesian tensor."""
    from xequinet_torch import keys
    from xequinet_torch.data.datapoint import Datapoint

    rng = np.random.default_rng(seed)
    return [Datapoint(d.atomic_numbers, d.pos, edge_index=d.edge_index, energy=d.energy,
                      forces=d.forces,
                      extras={keys.CARTESIAN_TENSOR: rng.normal(size=(3, 3)).astype(np.float32)})
            for d in dps]


def matrix_labels(dps, seed=1236):
    """Copies of ``dps`` with XMatNet labels: MatToolkit.get_padded_blocks
    of a random symmetric AO matrix per molecule."""
    from xequinet_torch import keys
    from xequinet_torch.data.datapoint import Datapoint
    from xequinet_torch.utils.mat_toolkit import MatToolkit

    rng = np.random.default_rng(seed)
    tk = MatToolkit(SVP_SHELLS, list(SVP_SHELLS))
    out = []
    for d in dps:
        n_orb = int(sum(tk.atom2mask[int(z)].sum() for z in d.atomic_numbers))
        m = rng.normal(size=(n_orb, n_orb))
        nb, eb = tk.get_padded_blocks(d.atomic_numbers, 0.5 * (m + m.T), d.edge_index)
        out.append(Datapoint(d.atomic_numbers, d.pos, edge_index=d.edge_index, extras={
            keys.NODE_MAT_BLOCKS: nb.astype(np.float32),
            keys.EDGE_MAT_BLOCKS: eb.astype(np.float32)}))
    return out


def irreps_wigner_D(irreps, rot):
    """Block-diagonal Wigner-D (the port's) of a geometric rotation on a
    flat irreps array."""
    from xequinet_torch.ops.irreps import Irreps
    from xequinet_torch.ops.wigner import geometric_rotation_to_irrep_basis, wigner_D

    r = geometric_rotation_to_irrep_basis(rot)
    blocks = [wigner_D(ir.l, r) for mul, ir in Irreps(irreps) for _ in range(mul)]
    out = np.zeros((sum(len(x) for x in blocks),) * 2)
    off = 0
    for x in blocks:
        out[off:off + len(x), off:off + len(x)] = x
        off += len(x)
    return out


def phase_cartesian(dps, device, card, sizes):
    """Phase 9 (c): the Cartesian head on the flagship XPaiNN (bf16 message
    and update pipelines, mega route) served by InferenceEngine.predict
    with forces through the kernels (3 + 3 launches); against the plain
    route on the card: bf16 energies and mean |F| within 2e-2, the tensor
    (max |err| / max) in bf16_band; f32 within 1e-4, forces through
    F32_FORCE_TOL; in
    f32 on the mega route T(R x) = R T(x) R^T within 1e-4 of the largest
    entry; training on {energy: 1, forces: 10, cartesian_tensor: 1} (3 +
    6 + 3 launches, a falling loss)."""
    from xequinet_torch import keys
    from xequinet_torch.data.batching import collate
    from xequinet_torch.ops import cuda_build
    from xequinet_torch.run.inference import batch_to_device

    card_run = device.type == "cuda"
    over = dict(sizes["kw"]["cartesian"], pallas_layout=sizes["layout"])
    eng = make_engine(device, **over)
    cuda_build.reset_launch_counts()
    res = eng.predict(dps)
    if card_run:
        torch.cuda.synchronize()
    predict = path_launches("(c) cartesian head mega predict with forces", card_run,
                            message_fwd=3, message_bwd=3)
    t = np.stack([r[keys.CARTESIAN_TENSOR] for r in res])
    if t.shape != (len(dps), 3, 3) or not np.isfinite(t).all():
        fail("(c): predict did not return a finite 3 x 3 tensor per molecule")
    print(f"[zoo] (c) cartesian head: mean|T| {np.abs(t).mean():.6f}")
    n_g, n_at = len(dps), sum(d.num_atoms for d in dps)
    eng_t = twins(device, "xpainn", over, eng.module.state_dict(),
                  plain={"use_pallas_scatter": False}, k32=F32,
                  p32=dict(F32, use_pallas_scatter=False))
    mega_b, plain_b = eng.collate(dps), eng_t["plain"].collate(dps)
    tensor = lambda o: o[keys.CARTESIAN_TENSOR][:n_g].cpu()
    got16, plain16 = eng.forward_batch(mega_b), eng_t["plain"].forward_batch(plain_b)
    got32, want32 = eng_t["k32"].forward_batch(mega_b), eng_t["p32"].forward_batch(plain_b)
    compare_outputs("(c) cartesian head, bf16 mega vs plain route", got16, plain16, n_g, n_at,
                    TOL["bfloat16"])
    bf16_band("(c) tensor", tensor(got16), tensor(plain16), tensor(want32))
    compare_outputs("(c) cartesian head, f32 mega vs plain route", got32, want32, n_g, n_at,
                    1e-4, F32_FORCE_TOL)
    held("(c) f32 tensor max|err|/max, mega vs plain route",
         rel_err(tensor(got32), tensor(want32)), 1e-4)
    del got16, plain16, got32, want32
    sub = dps[:sizes["n_ref"]]
    rot = random_rotation(95)
    k32 = eng_t["k32"]
    t0 = tensor(k32.forward_batch(k32.collate(sub), False))[:len(sub)].double().numpy()
    t_r = tensor(k32.forward_batch(k32.collate(rotated(sub, rot)), False))[:len(sub)]
    held("(c) f32 mega route, T(R x) against R T(x) R^T, max|err|/max",
         rel_err(t_r, torch.as_tensor(rot @ t0 @ rot.T)), 1e-4)
    del eng_t, k32
    if card_run:
        zoo_times("(c) cartesian head, mega route", eng, dps, mega_b, True, card, head=True)
    del eng
    b = batch_to_device(collate(cartesian_labels(dps), kernel_layout=layout(*sizes["layout"][:2])),
                        device)
    return predict, zoo_train("cartesian head mega", "cartesian", b,
                              dict(message_fwd=3, message_bwd=6, message_bwd2=3), device, card,
                              sizes, "bf16")


def phase_xmatnet(dps, device, card, sizes):
    """Phase 9 (d): XMatNet on the flagship backbone (mega route), its
    forward through the kernels (3 launches); against the plain route on
    the same slot-layout batch: the onsite and offsite blocks (max |err| /
    max) in bf16_band and within 1e-4 in f32; in f32 on the mega route
    B(R x) = D(R) B(x) D(R)^T for both kinds of block within 1e-4 of the
    largest entry; training on {node_mat_blocks: 1, edge_mat_blocks: 1}
    (3 + 3 + 0 launches, a falling loss)."""
    from xequinet_torch import keys
    from xequinet_torch.data.batching import collate
    from xequinet_torch.ops import cuda_build
    from xequinet_torch.run.inference import batch_to_device

    card_run = device.type == "cuda"
    over = dict(sizes["kw"]["xmatnet"], pallas_layout=sizes["layout"])
    eng = make_engine(device, "xmatnet", **over)
    mega_b = eng.collate(dps)
    cuda_build.reset_launch_counts()
    out = eng.forward_batch(mega_b, False)
    if card_run:
        torch.cuda.synchronize()
    forward = path_launches("(d) xmatnet mega forward", card_run, message_fwd=3)
    blocks = (keys.NODE_MAT_BLOCKS, keys.EDGE_MAT_BLOCKS)
    nb, eb = (out[k] for k in blocks)
    if nb.shape[1:] != (14, 14) or eb.shape[0] != mega_b[keys.EDGE_MASK].shape[0] or not (
            torch.isfinite(nb).all() and torch.isfinite(eb).all()):
        fail(f"(d): blocks of shapes {tuple(nb.shape)}, {tuple(eb.shape)} or non-finite")
    print(f"[zoo] (d) xmatnet: onsite blocks {tuple(nb.shape)}, offsite blocks "
          f"{tuple(eb.shape)} ({int(mega_b[keys.EDGE_MASK].sum())} real edges), mean|B| "
          f"{float(nb.abs().mean()):.6f}, {float(eb.abs().mean()):.6f}")
    del out, nb, eb
    eng_t = twins(device, "xmatnet", over, eng.module.state_dict(),
                  plain={"use_pallas_scatter": False}, k32=F32,
                  p32=dict(F32, use_pallas_scatter=False))
    fb = lambda e: {k: v.cpu() for k, v in e.forward_batch(mega_b, False).items()
                    if k in blocks}
    got16, plain16, got32, want32 = (fb(e) for e in (eng, eng_t["plain"], eng_t["k32"],
                                                     eng_t["p32"]))
    for key in blocks:
        bf16_band(f"(d) {key}", got16[key], plain16[key], want32[key])
        held(f"(d) f32 {key} max|err|/max, mega vs plain route",
             rel_err(got32[key], want32[key]), 1e-4)
    del got16, plain16, got32, want32
    sub = dps[:sizes["n_ref"]]
    rot = random_rotation(96)
    d = torch.as_tensor(irreps_wigner_D("3x0e+2x1o+1x2e", rot))
    k32 = eng_t["k32"]
    o, o_r = (k32.forward_batch(k32.collate(x), False) for x in (sub, rotated(sub, rot)))
    for key in blocks:
        b0 = o[key].cpu().double()
        held(f"(d) f32 mega route, {key}(R x) against D {key}(x) D^T, max|err|/max",
             rel_err(o_r[key].cpu(), d @ b0 @ d.T), 1e-4)
    del eng_t, k32, o, o_r
    if card_run:
        zoo_times("(d) xmatnet, mega route", eng, dps, mega_b, False, card, head=True)
    del eng
    b = batch_to_device(collate(matrix_labels(dps), kernel_layout=layout(*sizes["layout"][:2])),
                        device)
    return forward, zoo_train("xmatnet mega", "xmatnet", b, dict(message_fwd=3, message_bwd=3),
                              device, card, sizes, "bf16")


def phase_zoo(dps, device, card, sizes):
    """Phase 9: (a)-(d); returns each path's launches, by kernel."""
    out = {}
    t0 = time.perf_counter()
    for cell in ("painn", "so3krates"):
        out[f"{cell}_predict"], out[f"{cell}_train_step"] = phase_zoo_f32(cell, dps, device,
                                                                          card, sizes)
    out["cartesian_predict"], out["cartesian_train_step"] = phase_cartesian(dps, device, card,
                                                                            sizes)
    out["xmatnet_forward"], out["xmatnet_train_step"] = phase_xmatnet(dps, device, card, sizes)
    print(f"[zoo] phase 9 in {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 10: the user-facing drivers, through the command line
# ---------------------------------------------------------------------------
# phase 10's sizes on the card and in the CPU rehearsal: the XDB dataset
# (n_train bench molecules, batch size), the infer batch size, the opt
# molecules, the MD chain and its steps, and the model's overrides ("kw")
CLI_SIZES = dict(n_train=320, batch=32, valid_batch=8, infer_batch=128, n_opt=4, opt_steps=40, md_atoms=4000,
                 md_steps=20, kw={}, layout=(BN, CHUNK, PAD_NODES, MAX_CHUNKS))
CLI_REHEARSAL = dict(n_train=24, batch=4, valid_batch=2, infer_batch=4, n_opt=2, opt_steps=10, md_atoms=700,
                     md_steps=4,
                     kw=dict(node_dim=16, node_irreps="16x0e+8x1o+4x2e", num_basis=8,
                             action_blocks=1),
                     layout=(32, 32, PAD_NODES, MAX_CHUNKS))
# opt takes phase 3's molecules without a pair closer than this (A)
OPT_MIN_PAIR = 0.8
# the JAX package's analytic-against-numerical Hessian test's model
# (tests/test_round2.py::mini_ckpt), f32
ROUND2_KW = dict(node_dim=16, node_irreps="16x0e+8x1o+4x2e", embed_basis="one-hot",
                 num_basis=8, cutoff=5.0, action_blocks=1, output_modes=["energy"])
# agreement of a driver with the engine / Calculator it wraps, relative:
# CLI_TOL plus twice the reference's own spread over two calls on the same
# inputs (the plain PyTorch sums use float atomics on the card)
CLI_TOL = 1e-6


def yaml_value(v):
    """A config value as YAML text: flow lists and mappings, quoted
    strings, floats with a dot (the port's reader refuses 1e-05)."""
    if isinstance(v, dict):
        return "{" + ", ".join(f"{k}: {yaml_value(x)}" for k, x in v.items()) + "}"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(yaml_value(x) for x in v) + "]"
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        r = repr(v)
        mant, _, exp = r.partition("e")
        return f"{mant}.0e{exp}" if exp and "." not in mant else r
    if isinstance(v, int):
        return str(v)
    return json.dumps(str(v))


def write_yaml(path, sections):
    """A config file as a user writes one: a block per section, comments."""
    lines = ["# written by chip_smoke.py phase 10"]
    for sec, body in sections.items():
        if isinstance(body, dict):
            lines.append(f"{sec}:")
            lines += [f"  {k}: {yaml_value(v)}  # {k}" for k, v in body.items()]
        else:
            lines.append(f"{sec}: {yaml_value(body)}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


class _Kept:
    """Wraps ``module.name`` while alive, keeping what each call returns."""

    def __init__(self, module, name):
        self.module, self.name, self.orig = module, name, getattr(module, name)
        self.results = []

    def __enter__(self):
        def keep(*a, **k):
            out = self.orig(*a, **k)
            self.results.append(out)
            return out

        setattr(self.module, self.name, keep)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def spread_limit(a, b):
    """CLI_TOL plus twice the relative distance of two reference calls."""
    return CLI_TOL + 2.0 * a / max(b, 1e-30)


class CountedValidation:
    """Wraps ``Trainer.validate`` while it is entered: counts the batches
    that run_train's own valid loader yields (a second pass over it
    launches nothing) and the kernel launches made inside validate()
    (read before and after each call)."""

    def __enter__(self):
        from xequinet_torch.ops import cuda_build
        from xequinet_torch.training import trainer as trainer_mod

        self.batches, self.launches = 0, dict.fromkeys(cuda_build.LAUNCHES, 0)
        self.trainer_cls, validate = trainer_mod.Trainer, trainer_mod.Trainer.validate
        self.validate = validate

        def counted_validate(trainer):
            self.batches += sum(1 for _ in trainer.valid_loader)
            before = dict(cuda_build.LAUNCHES)
            try:
                return validate(trainer)
            finally:
                for k, v in cuda_build.LAUNCHES.items():
                    self.launches[k] += v - before[k]

        self.trainer_cls.validate = counted_validate
        return self

    def __exit__(self, *exc):
        self.trainer_cls.validate = self.validate

    def split(self, tag, counts, steps, card_run, per_step, per_valid):
        """The launches ``counts`` of a run of ``steps`` steps cut into those
        of its steps and of its validation batches, each measured; on the
        card each must be ``per_step`` per step and ``per_valid`` per
        batch exactly (the rest 0). Returns (per step, per batch)."""
        in_steps = {k: v - self.launches[k] for k, v in counts.items()}
        print(f"[launches] {tag}: {self.launches} in {self.batches} validation batches, "
              f"{in_steps} in {steps} steps")
        if card_run:
            want_s = {k: per_step.get(k, 0) * steps for k in counts}
            want_v = {k: per_valid.get(k, 0) * self.batches for k in counts}
            if in_steps != want_s or self.launches != want_v:
                fail(f"{tag}: launches {in_steps} in the steps and {self.launches} in "
                     f"validation, expected {want_s} and {want_v}")
        return ({k: v // steps for k, v in in_steps.items()},
                {k: v // self.batches for k, v in self.launches.items() if v})


def train_counted(tag, cfg, last, card_run):
    """``train -C cfg`` through ``cli.main`` on the mega route: its steps
    (from its last checkpoint ``last``) and validation batches, and on the
    card exactly 3 + 6 + 3 launches per step and 3 + 3 per validation
    batch, each measured on its own (``CountedValidation``).
    Returns (steps, validation batches, launches, launches per step,
    launches per validation batch, wall s)."""
    from xequinet_torch import cli
    from xequinet_torch.convert import load_checkpoint
    from xequinet_torch.ops import cuda_build

    cuda_build.reset_launch_counts()
    with CountedValidation() as cv:
        t0 = time.perf_counter()
        cli.main(["train", "-C", cfg])
        sync_if(card_run)
        wall = time.perf_counter() - t0
    steps, valid = load_checkpoint(last)["step"], cv.batches
    if steps == 0 or valid == 0:
        fail(f"{tag}: {steps} steps and {valid} validation batches")
    counts = path_launches(tag, card_run, message_fwd=3 * steps + 3 * valid,
                           message_bwd=6 * steps + 3 * valid, message_bwd2=3 * steps)
    per_step, per_valid = cv.split(tag, counts, steps, card_run,
                                   dict(message_fwd=3, message_bwd=6, message_bwd2=3),
                                   dict(message_fwd=3, message_bwd=3))
    return steps, valid, counts, per_step, per_valid, wall


def cli_train(tmp, kw, dev_args, card_run, sizes, card):
    """Phase 10 (a): ``train -C`` for one epoch on an XDB dataset of bench
    molecules (3 + 6 + 3 launches per step, 3 + 3 per validation batch);
    the same config in a subprocess sent SIGTERM after its first logged
    step (exit 143 and a checkpoint); then ``train --resume``."""
    import os
    import signal

    from xequinet_torch import cli
    from xequinet_torch.convert import load_checkpoint
    from xequinet_torch.data.store import create_dataset

    db = os.path.join(tmp, "db")
    create_dataset(db, build_molecules(sizes["n_train"], seed=99), units={})
    data = {"db_path": db, "targets": ["energy", "forces"], "batch_size": sizes["batch"],
            "valid_batch_size": sizes["valid_batch"]}
    trainer = {"max_epochs": 1, "warmup_epochs": 1, "lossfn": "l2",
               "losses_weight": TRAIN_WEIGHTS, "ema_decay": 0.999, "grad_clip": 5.0,
               "save_dir": os.path.join(tmp, "out"), "log_steps": 4, "seed": 0}
    if not card_run:
        trainer["device"] = "cpu"
    cfg = write_yaml(os.path.join(tmp, "train.yaml"),
                     {"model": {"model_name": "xpainn", "model_kwargs": kw}, "data": data,
                      "trainer": trainer})
    last = os.path.join(tmp, "out", "xequinet_last.ckpt")
    steps, valid, counts, per_step, _, wall = train_counted("(a) train", cfg, last, card_run)
    print(f"[cli] (a) train -C: 1 epoch, {steps} steps and {valid} validation batches in "
          f"{wall:.1f} s, launches {counts} — {card}")

    # preemption: the same config, long, in a subprocess
    save2 = os.path.join(tmp, "pre")
    long_cfg = write_yaml(os.path.join(tmp, "long.yaml"),
                          {"model": {"model_name": "xpainn", "model_kwargs": kw}, "data": data,
                           "trainer": dict(trainer, max_epochs=1000, log_steps=1,
                                           save_dir=save2)})
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "xequinet_torch", "train", "-C", long_cfg],
                            cwd=here, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        seen = ""
        while time.perf_counter() - t0 < 300:
            line = proc.stdout.readline()
            if not line:
                break
            seen += line
            if " step 1 loss " in line:
                break
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    pre = os.path.join(save2, "xequinet_last.ckpt")
    print(f"[cli] (a) train in a subprocess, SIGTERM after its first logged step: exit code "
          f"{proc.returncode} after {time.perf_counter() - t0:.1f} s, checkpoint "
          f"{os.path.exists(pre)}")
    if proc.returncode != 128 + signal.SIGTERM or not os.path.exists(pre):
        fail(f"(a) preemption: exit {proc.returncode}, checkpoint {os.path.exists(pre)}; "
             f"output:\n{(seen + rest)[-3000:]}")
    blob = load_checkpoint(pre)
    epoch, step = blob["epoch"], blob["step"]
    resume_cfg = write_yaml(os.path.join(tmp, "resume.yaml"),
                            {"model": {"model_name": "xpainn", "model_kwargs": kw}, "data": data,
                             "trainer": dict(trainer, max_epochs=epoch + 2, save_dir=save2)})
    cli.main(["train", "-C", resume_cfg, "-c", pre, "--resume"])
    after = load_checkpoint(pre)
    print(f"[cli] (a) train --resume from epoch {epoch} step {step}: finished epoch "
          f"{after['epoch']} at step {after['step']}")
    if after["epoch"] != epoch + 1 or after["step"] <= step:
        fail("(a) the resumed run did not go on from the preemption checkpoint")
    return cfg, last, per_step


def sync_if(card_run):
    if card_run:
        torch.cuda.synchronize()


def cli_test(cfg, ckpt, kw, device, dev_args, card_run, card):
    """Phase 10 (b): ``test`` on the checkpoint's test split (3 + 3
    launches per batch); its MAE and RMSE against the same batches through
    ``InferenceEngine.forward_batch``."""
    from xequinet_torch import cli
    from xequinet_torch.data.batching import kernel_layout_from_model_kwargs
    from xequinet_torch.data.dataset import DataLoader
    from xequinet_torch.ops import cuda_build
    from xequinet_torch.run import test as run_test_mod
    from xequinet_torch.run.inference import InferenceEngine, batch_to_device
    from xequinet_torch.run.train import build_datasets
    from xequinet_torch.training.loss import ErrorMetric, MetricAccumulator
    from xequinet_torch.utils.config import load_config

    config = load_config(cfg)
    loader = DataLoader(build_datasets(config)[2], config.data.valid_batch_size,
                        kernel_layout=kernel_layout_from_model_kwargs(kw))
    n_batches = sum(1 for _ in loader)
    cuda_build.reset_launch_counts()
    with _Kept(run_test_mod, "run_test") as kept:
        t0 = time.perf_counter()
        cli.main(["test", "-C", cfg, "-c", ckpt] + dev_args)
        sync_if(card_run)
        wall = time.perf_counter() - t0
    counts = path_launches("(b) test", card_run, message_fwd=3 * n_batches,
                           message_bwd=3 * n_batches)
    got = kept.results[0]
    eng = InferenceEngine(ckpt, device=device)
    metric = ErrorMetric(*config.data.targets)
    refs = []
    for _ in range(2):
        acc = MetricAccumulator()
        for raw in loader:
            acc.update(metric(eng.forward_batch(raw), batch_to_device(raw, device)))
        refs.append(acc.compute())
    worst = 0.0
    for prop, r in refs[0].items():
        for m in ("mae", "rmse"):
            err = abs(got[prop][m] - r[m]) / r[m]
            limit = spread_limit(abs(refs[1][prop][m] - r[m]), r[m])
            worst = max(worst, err / limit)
            if err > limit:
                fail(f"(b) test: {prop} {m} {got[prop][m]:.9g} against forward_batch's "
                     f"{r[m]:.9g}, {err:.3e} relative (limit {limit:.3e})")
    print(f"[cli] (b) test: {n_batches} batches, {wall / n_batches * 1e3:.1f} ms per batch "
          f"(wall, model load and data included: {wall:.2f} s); every MAE and RMSE within its "
          f"limit of forward_batch on the same batches (the closest at {worst:.3f} of it) — "
          f"{card}")
    return {k: v // max(n_batches, 1) for k, v in counts.items()}


def cli_infer(dps, ckpt, device, dev_args, card_run, card, tmp, sizes):
    """Phase 10 (c): ``infer --forces`` on an extxyz of phase 3's molecules
    (3 + 3 launches per chunk); each structure against
    ``InferenceEngine.predict`` on the same chunks."""
    import os
    import pickle

    from xequinet_torch import cli, keys
    from xequinet_torch.data.fmt_conversion import read_xyz, write_xyz
    from xequinet_torch.ops import cuda_build
    from xequinet_torch.run.inference import InferenceEngine

    xyz, out = os.path.join(tmp, "infer.xyz"), os.path.join(tmp, "infer.pkl")
    write_xyz(xyz, dps)
    bs = sizes["infer_batch"]
    n_chunks = (len(dps) + bs - 1) // bs
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    cli.main(["infer", "-c", ckpt, "-in", xyz, "-out", out, "--forces", "-b", str(bs)] + dev_args)
    sync_if(card_run)
    wall = time.perf_counter() - t0
    counts = path_launches("(c) infer", card_run, message_fwd=3 * n_chunks,
                           message_bwd=3 * n_chunks)
    with open(out, "rb") as f:
        got = pickle.load(f)
    frames = read_xyz(xyz)
    eng = InferenceEngine(ckpt, device=device)
    refs = [[r for i in range(0, len(frames), bs) for r in eng.predict(frames[i : i + bs])]
            for _ in range(2)]

    # energies: |dE| over the largest |E| of the run, so that no structure
    # whose energy is near zero widens the limit of the others; forces: over
    # each structure's own max |F|.  Each distance names its structure.
    e_scale = max(abs(float(y[keys.TOTAL_ENERGY])) for y in refs[0])

    def dist(a, b):
        e = [abs(float(x[keys.TOTAL_ENERGY]) - float(y[keys.TOTAL_ENERGY])) / e_scale
             for x, y in zip(a, b)]
        f = [float(np.abs(x[keys.FORCES] - y[keys.FORCES]).max())
             / float(np.abs(y[keys.FORCES]).max()) for x, y in zip(a, b)]
        return [(max(v), int(np.argmax(v))) for v in (e, f)]

    ((e_err, e_at), (f_err, f_at)) = dist(got, refs[0])
    ((e_sp, e_sp_at), (f_sp, f_sp_at)) = dist(refs[1], refs[0])
    e_lim, f_lim = spread_limit(e_sp, 1.0), spread_limit(f_sp, 1.0)
    n_edges = sum(d.num_edges for d in dps)
    print(f"[cli] (c) infer --forces: {len(dps)} structures in {n_chunks} chunks of {bs}, "
          f"{wall:.3f} s (reading the file and the model included): {len(dps) / wall:.1f} "
          f"structures/s, {n_edges / wall:.1f} edges/s; against predict on the same chunks: "
          f"energy {e_err:.3e} of max |E| {e_scale:.6g} at structure {e_at} (limit {e_lim:.3e}, "
          f"predict's own spread {e_sp:.3e} at structure {e_sp_at}), forces {f_err:.3e} of "
          f"each structure's max |F| at structure {f_at} (limit {f_lim:.3e}, predict's own "
          f"spread {f_sp:.3e} at structure {f_sp_at}) — {card}")
    if len(got) != len(dps) or e_err > e_lim or f_err > f_lim:
        fail("(c) infer disagrees with InferenceEngine.predict")
    return {k: v // n_chunks for k, v in counts.items()}


def hessian_vs_numerical(device, ck5_path):
    """Phase 10 (d)'s analytic against numerical Hessian on the JAX
    package's own check (tests/test_round2.py: its model, its molecule at
    rng 0 and its tolerance, atol 5e-3 + rtol 1e-2) with the port's seed-0
    weights (the checkpoint is written to ``ck5_path`` once).  These turn
    the forces within 5e-4 A (on the CPU a force of atom 5 moves by 0.24
    eV/A over 2e-4 A), so JAX's step of 1e-3 A is off by 115 eV/A^2 of 148
    there: the step is 1e-4 A (f32 positions round at ~5e-7 A), and the
    limit adds twice the difference's own error estimate |D(eps) - D(2
    eps)| (on the CPU 10 of 225 entries pass the JAX tolerance only with
    it; its largest 0.12).  At the flagship's widths the curvature moves by
    ~3% under a one-ulp move, and central differences converge at no step.
    Returns the largest excess over the limit (> 0: missed; +inf if the
    analytic Hessian is not symmetric) and a line that reports it."""
    import os

    from xequinet_torch.interface.calculator import Calculator
    from xequinet_torch.run import geometry

    rng = np.random.default_rng(0)
    z5, p5 = rng.integers(1, 5, 5).astype(np.int32), rng.normal(size=(5, 3)) * 1.5
    if not os.path.exists(ck5_path):
        md_checkpoint(ck5_path, **dict(ROUND2_KW, **F32))
    ff = geometry.ForceField(Calculator(ck5_path, device=device), z5)
    h_a = geometry.analytic_hessian(ff, p5)
    h_n = geometry.numerical_hessian(ff, p5, eps=1e-4)
    own = np.abs(h_n - geometry.numerical_hessian(ff, p5, eps=2e-4))
    jax_tol = 5e-3 + 1e-2 * np.abs(h_n)
    excess = float((np.abs(h_a - h_n) - jax_tol - 2 * own).max())
    if not np.allclose(h_a, h_a.T, atol=1e-8):
        excess = float("inf")
    line = (f"analytic against numerical Hessian (the JAX test's model and molecule, eps 1e-4 "
            f"A) on {device.type}: max |dH| {np.abs(h_a - h_n).max():.3e} eV/A^2 of max "
            f"{np.abs(h_n).max():.3e}; {int((np.abs(h_a - h_n) > jax_tol).sum())} of "
            f"{h_n.size} entries past atol 5e-3 + rtol 1e-2, each within it plus 2 x |D(eps) "
            f"- D(2 eps)| (max {own.max():.3e}), largest excess {excess:.3e}: "
            f"{'held' if excess <= 0 else 'MISSED'}")
    return excess, line


def cli_opt(dps, device, dev_args, card_run, card, tmp, sizes):
    """Phase 10 (d): ``opt --freq --shermo --save-hessian`` with an f32
    checkpoint (phase 7's model) on phase 3's molecules without a close
    pair, one of them with a ``$freeze`` file: energies that fall, frozen
    atoms unmoved, the L-BFGS evaluation rate.  Then on the largest
    molecule the card's Hessian against the CPU's, the translational sum
    rule and the analytic Hessian against the numerical one.  Returns the
    checkpoint, the largest molecule at its optimised geometry and the
    launches (none: molecules this small take the plain route)."""
    import os

    from xequinet_torch import cli, keys
    from xequinet_torch.data.datapoint import Datapoint
    from xequinet_torch.data.fmt_conversion import read_xyz, write_xyz
    from xequinet_torch.interface.calculator import Calculator
    from xequinet_torch.ops import cuda_build
    from xequinet_torch.run import geometry

    ck = md_checkpoint(os.path.join(tmp, "opt_f32.ckpt"), **dict(sizes["kw"], **F32))
    mols = [d for d in dps if closest_pair(d) >= OPT_MIN_PAIR][: sizes["n_opt"]]
    big = max(range(len(mols)), key=lambda i: mols[i].num_atoms)
    frozen_i = 0 if big != 0 else 1
    calc = Calculator(ck, device=device)

    class Counted(geometry.ForceField):
        calls = 0

        def __call__(self, pos):
            Counted.calls += 1
            return super().__call__(pos)

    spent = [0.0]
    plain_optimize, plain_ff = geometry.optimize, geometry.ForceField

    def timed_optimize(*a, **k):
        t0 = time.perf_counter()
        try:
            return plain_optimize(*a, **k)
        finally:
            spent[0] += time.perf_counter() - t0

    final = {}
    cuda_build.reset_launch_counts()
    for tag, idx in (("free", [i for i in range(len(mols)) if i != frozen_i]),
                     ("frozen", [frozen_i])):
        xyz = os.path.join(tmp, f"opt_{tag}.xyz")
        write_xyz(xyz, [mols[i] for i in idx])
        argv = ["opt", "-c", ck, "-in", xyz, "-out", os.path.join(tmp, f"opt_{tag}_out.xyz"),
                "--freq", "--shermo", "--save-hessian", "--max-steps",
                str(sizes["opt_steps"])] + dev_args
        if tag == "frozen":
            with open(os.path.join(tmp, "cons.txt"), "w") as f:
                f.write("$freeze\nxyz 1-3\n")
            argv += ["-con", os.path.join(tmp, "cons.txt")]
        geometry.ForceField, geometry.optimize = Counted, timed_optimize
        try:
            with _Kept(geometry, "run_opt") as kept:
                cli.main(argv)
                sync_if(card_run)
        finally:
            geometry.ForceField, geometry.optimize = plain_ff, plain_optimize
        for k, (frame, entry) in enumerate(zip(read_xyz(xyz), kept.results[0])):
            e0 = [calc.calculate(frame.atomic_numbers, frame.pos)[keys.TOTAL_ENERGY]
                  for _ in range(2)]
            noise = abs(e0[1] - e0[0])
            suffix = "" if len(idx) == 1 else str(k)
            shm = os.path.join(tmp, f"opt_{tag}_freq{suffix}.shm")
            vals = [entry["energy"], *entry["thermo"].values(), *entry["frequencies_cm1"]]
            print(f"[cli] (d) opt, {tag} molecule {k} ({frame.num_atoms} atoms): E {e0[0]:.6f} -> "
                  f"{entry['energy']:.6f} eV, converged {entry['converged']}, frequencies "
                  f"{entry['frequencies_cm1'].min():.1f} .. {entry['frequencies_cm1'].max():.1f} "
                  f"cm^-1, {entry['thermo']['n_imaginary']} imaginary")
            if not (np.isfinite(vals).all() and np.isfinite(entry["positions"]).all()):
                fail(f"(d) opt, {tag}: non-finite results")
            if entry["energy"] > e0[0] + 2 * noise:
                fail(f"(d) opt, {tag}: the final energy {entry['energy']} is above the initial "
                     f"{e0[0]} (the Calculator's own spread {noise:.3e})")
            if not os.path.exists(shm) or "*wavenum" not in open(shm).read() or \
                    not os.path.exists(os.path.join(tmp, f"opt_{tag}_h{suffix}.txt")):
                fail(f"(d) opt, {tag}: no Shermo file or saved Hessian")
            if tag == "frozen" and not np.array_equal(entry["positions"][:3], frame.pos[:3]):
                fail("(d) opt: the frozen atoms moved")
            final[idx[k]] = entry["positions"]
            print(f"[cli] (d) opt, {tag} molecule {k}: closest pair {closest_pair(frame):.3f} A "
                  f"at the start, {closest_pair(Datapoint(frame.atomic_numbers, final[idx[k]])):.3f}"
                  f" A at the end")
    counts = path_launches("(d) opt", card_run)
    n_evals = Counted.calls
    print(f"[cli] (d) opt: {n_evals} L-BFGS evaluations in {spent[0]:.2f} s of optimisation, "
          f"{n_evals / spent[0]:.1f} evaluations/s — {card}")

    # the Hessian's time and the sum rule on the largest molecule, and the
    # card against the CPU on the smallest (a full-width Hessian takes the
    # CPU seconds), at their input geometries: at random weights the
    # optimiser pulls atoms together (a pair at 0.5 A in the CPU rehearsal)
    z, pos = mols[big].atomic_numbers, mols[big].pos
    if card_run:
        wall, busy = device_ms(lambda: calc.calculate(z, pos), calls=10)
        print(f"[cli] (d) one evaluation ({len(z)} atoms): {wall:.2f} ms of wall, of which the "
              f"device is busy {busy:.2f} ms (the rest: host round trip) — {card}")
    h, times = None, []
    for _ in range(2):  # the second call is the timed one
        t0 = time.perf_counter()
        h = calc.hessian(z, pos)
        sync_if(card_run)
        times.append((time.perf_counter() - t0) * 1e3)
    n = len(z)
    sum_rule = float(np.abs(h.reshape(3 * n, n, 3).sum(axis=1)).max()) / float(np.abs(h).max())
    small = min(mols, key=lambda d: d.num_atoms)
    zs, ps = small.atomic_numbers, small.pos
    hs = calc.hessian(zs, ps)
    moved = float(np.abs(calc.hessian(zs, ps * (1 + 1e-7)) - hs).max())
    h_cpu = Calculator(ck, device="cpu").hessian(zs, ps)
    scale = float(np.abs(h_cpu).max())
    err = float(np.abs(hs - h_cpu).max())
    limit = GRAD_TOL * scale + GRAD_ULP_FACTOR * moved
    print(f"[cli] (d) Calculator.hessian, {n} atoms: {times[1]:.1f} ms (first call "
          f"{times[0]:.1f}), translational sum rule {sum_rule:.3e} of max |H| (limit 1e-3); "
          f"{len(zs)} atoms on {device.type} against the CPU: max |dH| {err:.3e} eV/A^2 (limit "
          f"{limit:.3e} = {GRAD_TOL:g} x max |H| {scale:.3e} + {GRAD_ULP_FACTOR:g} x the "
          f"one-ulp change {moved:.3e}) — {card}")
    if err > limit or sum_rule > 1e-3:
        fail("(d) the Hessian disagrees with the CPU's or breaks the sum rule")
    excess, line = hessian_vs_numerical(device, ck5_path=os.path.join(tmp, "round2.ckpt"))
    print(f"[cli] (d) {line}")
    if excess > 0:
        fail("(d) the analytic Hessian disagrees with the numerical one")
    return ck, z, final[big], counts


def cli_md(ck, device, dev_args, card_run, card, tmp, sizes):
    """Phase 10 (e): ``md -C`` on a YAML of phase 7's free chain with
    ``pallas: mega``: 3 + 3 launches per force call, finite energies."""
    import os
    import re

    from xequinet_torch import cli
    from xequinet_torch.data.datapoint import Datapoint
    from xequinet_torch.data.fmt_conversion import write_xyz
    from xequinet_torch.ops import cuda_build

    zf, posf = md_free_chain(sizes["md_atoms"])
    xyz, log = os.path.join(tmp, "chain.xyz"), os.path.join(tmp, "md.log")
    write_xyz(xyz, [Datapoint(zf, posf)])
    steps, every = sizes["md_steps"], 5
    text = (f"# written by chip_smoke.py phase 10\ninput_file: {json.dumps(xyz)}\n"
            f"model_file: {json.dumps(ck)}\npallas: mega   # the message kernels\n"
            f"skin: 0.5\nseed: 0\ninit_temperature: 300.0\nlogfile: {json.dumps(log)}\n"
            + ("" if card_run else "device: cpu\n")
            + f"ensembles:\n  - {{name: nve, timestep: {MD_DT},\n     steps: {steps}, "
            f"log_interval: {every}}}\n")
    cfg = os.path.join(tmp, "md.yaml")
    with open(cfg, "w") as f:
        f.write(text)
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    cli.main(["md", "-C", cfg])
    sync_if(card_run)
    wall = time.perf_counter() - t0
    epot = [float(m.group(1)) for m in re.finditer(r"Epot=(\S+)eV", open(log).read())]
    n_calls = 1 + steps + len(epot)  # first forces, one per step, one per log
    counts = path_launches("(e) md", card_run, message_fwd=3 * n_calls, message_bwd=3 * n_calls)
    print(f"[cli] (e) md -C: {len(zf)}-atom chain, NVE {steps} steps of {MD_DT} fs in "
          f"{wall:.2f} s ({n_calls} force calls), logged Epot {epot} — {card}")
    if len(epot) != -(-steps // every) or not np.isfinite(epot).all():
        fail("(e) md: missing or non-finite logged energies")
    return {k: v // n_calls for k, v in counts.items()}


def _ipi_server(frames, replies):
    """A fake i-PI server on localhost for ``frames`` ((cell, positions) in
    Bohr): STATUS, POSDATA, STATUS, GETFORCE per frame, then EXIT; each
    reply's energy, forces and virial go to ``replies``."""
    import socket
    import struct
    import threading

    server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    server.bind(("localhost", 0))
    server.listen(1)
    server.settimeout(300)

    def recv(conn, n):
        buf = b""
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("the driver closed the connection")
            buf += chunk
        return buf

    def run():
        conn, _ = server.accept()
        try:
            hdr = lambda m: conn.sendall(m.ljust(12).encode())
            for cell, pos in frames:
                hdr("STATUS")
                recv(conn, 12)
                hdr("POSDATA")
                conn.sendall(cell.astype("<f8").tobytes() + np.zeros(9, "<f8").tobytes()
                             + struct.pack("<i", len(pos)) + pos.astype("<f8").tobytes())
                hdr("STATUS")
                recv(conn, 12)
                hdr("GETFORCE")
                if recv(conn, 12).decode().strip() != "FORCEREADY":
                    raise ValueError("no FORCEREADY")
                e = struct.unpack("<d", recv(conn, 8))[0]
                n = struct.unpack("<i", recv(conn, 4))[0]
                f = np.frombuffer(recv(conn, 24 * n), "<f8").reshape(n, 3)
                v = np.frombuffer(recv(conn, 72), "<f8").reshape(3, 3)
                recv(conn, 4)
                replies.append((e, f, v))
            hdr("EXIT")
        finally:
            conn.close()
            server.close()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return server.getsockname()[1], t


def cli_ipi(ck, z, pos, device, card_run, card):
    """Phase 10 (f): ``IPIDriver`` against a fake server, 3 rounds; each
    reply against ``Calculator.calculate`` in the wire's units.  Both run
    under deterministic sums: with the default float atomics the reply is
    a third sample of the reference's noise, and twice the spread of two
    samples did not always cover it (forces 9.057e-6 against a limit of
    8.111e-6 on an H100, on code the check had passed), so the limit is
    CLI_TOL alone."""
    from xequinet_torch import keys
    from xequinet_torch.interface.calculator import Calculator
    from xequinet_torch.interface.ipi_driver import IPIDriver
    from xequinet_torch.ops import cuda_build
    from xequinet_torch.utils.qc import unit_conversion

    bohr = unit_conversion("Angstrom", "Bohr")
    geoms = [pos, pos + 0.01, pos - 0.01]
    replies = []
    port, thread = _ipi_server([(np.zeros((3, 3)), g * bohr) for g in geoms], replies)
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    drv = IPIDriver(ck, z, address="localhost", port=port,
                    device=None if card_run else "cpu")
    with deterministic_sums():
        rounds = drv.run()
    wall = time.perf_counter() - t0
    thread.join(timeout=60)
    counts = path_launches("(f) i-PI", card_run)
    if rounds != len(geoms) or thread.is_alive() or len(replies) != len(geoms):
        fail(f"(f) i-PI: {rounds} rounds, {len(replies)} replies")
    ref = Calculator(ck, device=device)
    worst = 0.0
    for g, (e, f, _) in zip(geoms, replies):
        with deterministic_sums():
            r = [ref.calculate(z, g) for _ in range(2)]
        e_ref = [x[keys.TOTAL_ENERGY] * drv._e_conv for x in r]
        f_ref = [x[keys.FORCES] * drv._e_conv * drv._l_conv for x in r]
        fs = float(np.abs(f_ref[0]).max())
        for err, lim in ((abs(e - e_ref[0]) / abs(e_ref[0]),
                          spread_limit(abs(e_ref[1] - e_ref[0]), abs(e_ref[0]))),
                         (float(np.abs(f - f_ref[0]).max()) / fs,
                          spread_limit(float(np.abs(f_ref[1] - f_ref[0]).max()), fs))):
            worst = max(worst, err / lim)
            if err > lim:
                fail(f"(f) i-PI reply {err:.3e} from Calculator.calculate (limit {lim:.3e})")
    print(f"[cli] (f) i-PI: {rounds} rounds in {wall:.2f} s (driver start included); energies "
          f"and forces (Hartree, Hartree/Bohr) within their limits of Calculator.calculate, the "
          f"closest at {worst:.3f} of it — {card}")
    return counts


def phase_cli(dps, device, card, sizes):
    """Phase 10: the drivers through ``xequinet_torch.cli.main`` with config
    files written as text: (a) train, preemption and resume, (b) test, (c)
    infer, (d) opt with frequencies and the Hessian, (e) md, (f) the i-PI
    driver.  Returns each path's message-kernel launches per unit."""
    import os
    import tempfile

    card_run = device.type == "cuda"
    dev_args = [] if card_run else ["--device", "cpu"]  # on the card: the default
    kw = dict(FLAGSHIP_KW, pallas_layout=list(sizes["layout"]), **sizes["kw"])
    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        cfg, ckpt, out["cli_train_step"] = cli_train(tmp, kw, dev_args, card_run, sizes, card)
        out["cli_test_batch"] = cli_test(cfg, ckpt, kw, device, dev_args, card_run, card)
        out["cli_infer_chunk"] = cli_infer(dps, ckpt, device, dev_args, card_run, card, tmp,
                                           sizes)
        ck, z, pos, out["cli_opt"] = cli_opt(dps, device, dev_args, card_run, card, tmp, sizes)
        out["cli_md_call"] = cli_md(ck, device, dev_args, card_run, card, tmp, sizes)
        out["cli_ipi"] = cli_ipi(ck, z, pos, device, card_run, card)
    print(f"[cli] phase 10 in {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 11: determinism, export, data parallelism, profiling
# ---------------------------------------------------------------------------
# phase 11's sizes on the card and in the CPU rehearsal
P11_SIZES = dict(layout=(BN, CHUNK), kw={}, det=dict(calls=5, md=MD_SIZES),
                 dp=dict(n_train=512, n_valid=16, batch=64, timeout=420))
P11_REHEARSAL = dict(layout=(32, 32), kw=dict(action_blocks=1, node_dim=16,
                                              node_irreps="16x0e+8x1o+4x2e", num_basis=8),
                     det=dict(calls=2, md=MD_REHEARSAL),
                     dp=dict(n_train=16, n_valid=4, batch=4, timeout=240))


def spread(a, b):
    """max |a - b| / max |a|."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def grads_sample(module, forward, batch, task=FLAGSHIP_TASK):
    """Energy, forces (the virial where ``task`` trains on it) and every
    parameter gradient of the force loss on ``batch``, on the host."""
    from xequinet_torch import keys
    from xequinet_torch.training.loss import WeightedLoss
    from xequinet_torch.training.trainer import loss_and_grads

    _, weights, virial = task
    named = list(module.named_parameters())
    _, _, out, grads = loss_and_grads(forward, WeightedLoss("l2", **weights),
                                      [p for _, p in named], batch, "forces" in weights, virial)
    res = {k: out[key].detach().float().cpu().numpy() for k, key in
           (("energy", keys.TOTAL_ENERGY), ("forces", keys.FORCES), ("virial", keys.VIRIAL))
           if key in out}
    res.update({f"grad {n}": g.float().cpu().numpy() for (n, _), g in zip(named, grads)})
    return res


def det_spreads(samples):
    """The spread of each quantity between two samples; gradients as the
    largest over the parameters (with its name)."""
    a, b = samples
    out, worst = {}, (-1.0, "")
    for k in a:
        s = spread(a[k], b[k])
        if k.startswith("grad "):
            worst = max(worst, (s, k[5:]))
        else:
            out[k] = s
    if worst[1]:
        out[f"parameter gradients (worst: {worst[1]})"] = worst[0]
    return out


@contextlib.contextmanager
def deterministic_sums(enabled=True):
    """``torch.use_deterministic_algorithms(enabled)`` for the body and the
    caller's setting back on exit; empty tensors are not filled with NaN
    (the fill is not a sum, and only costs time)."""
    import torch.utils.deterministic as tud

    was = torch.are_deterministic_algorithms_enabled()
    was_warn = torch.is_deterministic_algorithms_warn_only_enabled()
    was_fill = tud.fill_uninitialized_memory
    torch.use_deterministic_algorithms(enabled)
    tud.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=was_warn)
        tud.fill_uninitialized_memory = was_fill


def det_case(tag, sample, timed, card_run, calls, card):
    """Phase 11 (a), one call: two samples and ``calls`` timed calls in
    each mode, PyTorch's default sums (the port's) and its deterministic
    algorithms (:func:`deterministic_sums` around the same call), timed in
    turns default, deterministic, deterministic, default.  ``sample()`` ->
    host arrays; ``timed()`` runs one call.  Returns each mode's (spreads,
    median ms), the cost and what moved under deterministic sums."""
    sync = torch.cuda.synchronize if card_run else (lambda: None)

    def in_mode(det, fn):
        with deterministic_sums(det):
            return fn()

    spreads = {det: det_spreads([in_mode(det, sample) for _ in range(2)])
               for det in (False, True)}
    ms = {False: [], True: []}
    for det in (False, True, True, False):
        for _ in range(calls):
            t0 = time.perf_counter()
            in_mode(det, timed)
            sync()
            ms[det].append((time.perf_counter() - t0) * 1e3)
    med = {det: float(np.median(v)) for det, v in ms.items()}
    for det in (False, True):
        name = "deterministic sums" if det else "default sums (the port's)"
        print(f"[det] {tag}, {name}: median {med[det]:.3f} ms of {2 * calls} calls; spread "
              "between two calls (max |a - b| / max |a|): "
              + ", ".join(f"{k} {v:.3e}" for k, v in spreads[det].items()) + f" — {card}")
    cost = med[True] / med[False] - 1.0
    moved = {k: v for k, v in spreads[True].items() if v != 0.0}
    print(f"[det] {tag}: deterministic sums cost {100 * cost:+.1f}% of the default's ms; "
          + (f"NOT bit for bit: {moved}" if moved else "bit for bit"))
    return {"default": (spreads[False], med[False]), "deterministic": (spreads[True], med[True]),
            "cost": cost, "moved": moved}


def phase_determinism(dps, device, card, tmp, sizes, kw, lay):
    """Phase 11 (a): the spread of two identical calls and the ms of each
    mode, for the flagship mega train step (bf16, the 1024-molecule
    batch), the f32 plain route's train step, InferenceEngine.predict (mega,
    bf16, with forces) and Calculator.calculate on phase 7's 10,000-atom
    periodic box (mega, skin 0.5, with the virial, the same geometry each
    call: the hot loop's device path).  The port keeps PyTorch's default
    sums: the deterministic algorithms cost more than 10% of predict's and
    of calculate's ms (ROADMAP section 3, recorded); fails if they do not
    repeat bit for bit, which that record states."""
    import os

    from xequinet_torch import keys
    from xequinet_torch.data.batching import collate
    from xequinet_torch.interface.calculator import Calculator
    from xequinet_torch.ops.radius_graph import radius_graph_pbc_np
    from xequinet_torch.run.inference import batch_to_device

    card_run = device.type == "cuda"
    calls = sizes["calls"]
    out = {}
    kw = dict(kw, pallas_layout=(*lay, PAD_NODES, MAX_CHUNKS))
    cases = (("mega train step (bf16)", kw, collate(dps, kernel_layout=layout(*lay))),
             ("plain route train step (f32)", dict(kw, use_pallas_scatter=False, **F32),
              collate(dps)))
    for tag, over, host_b in cases:
        b = batch_to_device(host_b, device)
        module, forward, step, ema = train_model(device, **over)
        it = iter(range(10 ** 6))
        out[tag] = det_case(tag, lambda: grads_sample(module, forward, b),
                            lambda: step(b, next(it), 1.0, ema), card_run, calls, card)
        del module, forward, step, ema, b
    eng = make_engine(device, **kw)

    def predict_sample():
        res = eng.predict(dps)
        return {"energy": np.array([r[keys.TOTAL_ENERGY] for r in res]),
                "forces": np.concatenate([r[keys.FORCES] for r in res])}

    out["InferenceEngine.predict"] = det_case("InferenceEngine.predict (mega, bf16, forces)",
                                              predict_sample, lambda: eng.predict(dps),
                                              card_run, calls, card)
    del eng
    md = sizes["md"]
    ck = md_checkpoint(os.path.join(tmp, "det_bf16.ckpt"), **md["kw"])
    z, pos, cell, pbc, _ = md_box(md["n_box"])
    ei, _ = radius_graph_pbc_np(pos, cell, pbc, 5.0)
    calc = Calculator(ck, pallas="mega", skin=0.5, compute_virial=True, device=device,
                      max_atoms=md["max_box"], max_edges=md_edge_cap(ei.shape[1]))
    box = dict(cell=cell, pbc=pbc)
    calc.calculate(z, pos, **box)
    calculate = lambda: calc.calculate(z, pos, **box)
    out["Calculator.calculate"] = det_case(
        f"Calculator.calculate ({len(z)}-atom periodic box, mega, "
        f"{dict(MD_KW, **md['kw'])['compute_dtype']}, virial)",
        lambda: {k: np.asarray(v) for k, v in calculate().items()
                 if k in (keys.TOTAL_ENERGY, keys.FORCES, keys.VIRIAL)},
        calculate, card_run, calls, card)
    if calc.last_route != "mega" or calc.n_rebuilds != 1:
        fail(f"(a): the Calculator left the hot loop's path (route {calc.last_route}, "
             f"{calc.n_rebuilds} rebuilds)")
    calc.close()
    moved = {tag: r["moved"] for tag, r in out.items() if r["moved"]}
    if moved:
        fail(f"(a): two calls with deterministic sums differ: {moved}")
    return out


# (b) export: the JAX export's default capacities
EXPORT_CAPS = (256, 8192)
# element-wise f32 forces of an exported program against the plain
# Calculator: PERF.md section 2's limits (F32_FORCE_TOL); energy 1e-4
EXPORT_E_TOL = 1e-4


def export_inputs(dp, caps, periodic=False, charge=0):
    """The energy / dipole / matrix signature's inputs for one structure
    padded to ``caps`` = (atoms, edges), as numpy arrays."""
    n, e = caps
    na, ne = dp.num_atoms, dp.num_edges
    pos = np.zeros((n, 3), dtype=np.float32)
    pos[:na] = dp.pos
    z = np.zeros(n, dtype=np.int32)
    z[:na] = dp.atomic_numbers
    ei = np.zeros((2, e), dtype=np.int32)
    ei[:, :ne] = dp.edge_index
    args = [pos, z, ei, np.arange(e) < ne]
    if periodic:
        offs = np.zeros((e, 3), dtype=np.float32)
        offs[:ne] = dp.cell_offsets
        args += [offs, np.asarray(dp.cell, dtype=np.float32)]
    return args + [np.array([charge], dtype=np.int32)]


def _export_job(ckpt, out_dir, kw, device_type):
    """One ``export_model`` at EXPORT_CAPS, in a worker process; returns its
    seconds."""
    from xequinet_torch.interface.export import export_model

    torch.set_num_threads(1)  # six tracers share the host's cores
    t0 = time.perf_counter()
    export_model(ckpt, out_dir, *EXPORT_CAPS, device=device_type, **kw)
    return time.perf_counter() - t0


def export_case(tag, job, device, card, inputs, reference, check):
    """The export ``job`` (a future of :func:`_export_job`: its directory and
    seconds): load the program, call it on ``inputs`` (no kernel launch)
    and hand its outputs and ``reference()`` (called twice: its own spread)
    to ``check``; returns the program's and the reference's ms per call
    (median of 10), and the launches of the program's call, measured."""
    from xequinet_torch.interface.export import load_exported
    from xequinet_torch.ops import cuda_build

    card_run = device.type == "cuda"
    sync = torch.cuda.synchronize if card_run else (lambda: None)
    out_dir, future = job
    t_export = future.result(timeout=600)
    module, manifest = load_exported(out_dir)
    args = [torch.as_tensor(a, device=device) for a in inputs]
    cuda_build.reset_launch_counts()
    got = [t.detach().cpu().numpy() for t in module(*args)]
    sync()
    counts = path_launches(f"(b) exported {tag} call", card_run)
    ref = [reference(), reference()]
    check(got, ref)
    times = {}
    for name, fn in (("program", lambda: module(*args)), ("reference", reference)):
        ts = []
        for _ in range(10):
            t1 = time.perf_counter()
            fn()
            sync()
            ts.append((time.perf_counter() - t1) * 1e3)
        times[name] = float(np.median(ts))
    print(f"[export] {tag}: exported in {t_export:.1f} s, in parallel with the others "
          f"({manifest['output_mode']}, "
          f"{manifest['inputs']} -> {manifest['outputs']}); loaded program {times['program']:.3f} "
          f"ms per call, its reference {times['reference']:.3f} ms — {card}")
    return times, counts


def held_energy_forces(tag, e_got, f_got, ref, conv_e=1.0, conv_f=1.0):
    """An exported energy and forces against the reference's (two calls,
    converted by ``conv_e`` / ``conv_f``): energy within EXPORT_E_TOL and
    forces element-wise within F32_FORCE_TOL, each plus twice the
    reference's own spread."""
    from xequinet_torch import keys

    (a, b) = ref
    e_w = a[keys.TOTAL_ENERGY] * conv_e
    f_w = a[keys.FORCES] * conv_f
    e_spread = abs(a[keys.TOTAL_ENERGY] - b[keys.TOTAL_ENERGY]) / abs(a[keys.TOTAL_ENERGY])
    f_spread = md_force_err(b[keys.FORCES], a[keys.FORCES])
    e_err = abs(float(e_got) - e_w) / abs(e_w)
    f_err = md_force_err(f_got[:len(f_w)], f_w)
    e_lim = EXPORT_E_TOL + 2 * e_spread
    f_lim = [t + 2 * s for t, s in zip(F32_FORCE_TOL, f_spread)]
    print(f"[export] {tag}: energy rel diff {e_err:.3e} (limit {e_lim:.3e}), forces max "
          f"{f_err[0]:.3e} / p99 per atom {f_err[1]:.3e} (limits {f_lim[0]:.3e} / "
          f"{f_lim[1]:.3e}); the reference's own spread {e_spread:.3e} / {f_spread[0]:.3e}")
    if not (e_err <= e_lim and f_err[0] <= f_lim[0] and f_err[1] <= f_lim[1]):
        fail(f"(b) {tag}: the exported program disagrees with its reference")


def phase_export(dps, device, card, tmp, kw):
    """Phase 11 (b): ``export_model`` on the card at the JAX defaults (256
    atoms, 8192 edges) from f32 checkpoints of phases 7-9, each loaded
    program against the plain Calculator (or the plain forward): energy
    with the virial (the 28-atom molecule), ``periodic`` (a phase 8 cell),
    ``dipole`` (phase 8 (c)'s five heads), ``gmx`` (a periodic box in nm
    and kJ/mol), ``matrix`` (phase 9 (d)'s XMatNet) and ``net_charge``.
    The six exports run in six spawned processes at once (tracing is host
    work).  Returns the launches of the six exported calls, summed (none:
    the plain route)."""
    import multiprocessing
    import os
    from concurrent.futures import ProcessPoolExecutor

    from xequinet_torch.ops import cuda_build

    t0 = time.perf_counter()
    ck = md_checkpoint(os.path.join(tmp, "x32.ckpt"), **dict(kw, **F32))
    ck_q = md_checkpoint(os.path.join(tmp, "q32.ckpt"), **dict(kw, **MULTI_HEADS, **F32))
    ck_m = md_checkpoint(os.path.join(tmp, "m32.ckpt"), model="xmatnet",
                         **dict(kw, **XMAT_KW, **F32))
    jobs_kw = {"energy": (ck, dict(compute_virial=True)),
               "periodic energy": (ck, dict(periodic=True)),
               "gmx": (ck, dict(output_mode="gmx", max_reps=1)),
               "dipole": (ck_q, dict(output_mode="dipole")),
               "net charge": (ck_q, dict(net_charge=1, compute_virial=False)),
               "matrix": (ck_m, dict(output_mode="matrix"))}
    pool = ProcessPoolExecutor(len(jobs_kw), mp_context=multiprocessing.get_context("spawn"))
    jobs = {}
    for tag, (ckpt, over) in jobs_kw.items():
        out_dir = os.path.join(tmp, tag.replace(" ", "_"))
        jobs[tag] = (out_dir, pool.submit(_export_job, ckpt, out_dir, over, device.type))
    try:
        calls = _export_checks(jobs, dps, device, card, ck, ck_q, ck_m)
    finally:
        pool.shutdown(cancel_futures=True)
    print(f"[export] phase 11 (b) in {time.perf_counter() - t0:.1f} s")
    return {k: sum(c[k] for c in calls) for k in cuda_build.LAUNCHES}


def _export_checks(jobs, dps, device, card, ck, ck_q, ck_m):
    """Phase 11 (b)'s holds, one per export of ``jobs``; returns each
    exported call's launches."""
    from xequinet_torch import keys
    from xequinet_torch.data.batching import collate
    from xequinet_torch.data.datapoint import Datapoint
    from xequinet_torch.interface.calculator import Calculator
    from xequinet_torch.interface.export import GMX_UNITS
    from xequinet_torch.models.properties import make_forward
    from xequinet_torch.ops.radius_graph import radius_graph_pbc_np
    from xequinet_torch.run.inference import (InferenceEngine, batch_to_device,
                                              load_model_from_checkpoint)
    from xequinet_torch.utils.qc import unit_conversion

    mol = max(dps, key=lambda d: d.num_atoms)
    calc = Calculator(ck, compute_virial=True, device=device)
    ref_mol = lambda: calc.calculate(mol.atomic_numbers, mol.pos)

    def energy_check(got, ref):
        held_energy_forces(f"energy + virial, {mol.num_atoms} atoms", got[0], got[1], ref)
        v_err = float(np.abs(got[2] - ref[0][keys.VIRIAL]).max()
                      / np.abs(ref[0][keys.VIRIAL]).max())
        print(f"[export] energy + virial: virial max|dV|/max|V| {v_err:.3e} (limit 1e-3)")
        if v_err > 1e-3:
            fail("(b) the exported virial disagrees")

    calls = []

    def case(*args):
        times, counts = export_case(*args)
        calls.append(counts)
        return times

    times = case("energy", jobs["energy"], device, card, export_inputs(mol, EXPORT_CAPS),
                 ref_mol, energy_check)
    print(f"[export] the loaded energy program {times['program']:.3f} ms per call beside "
          f"Calculator.calculate's {times['reference']:.3f} ms on the same molecule — {card}")

    cell = build_crystals(8)[3]
    ref_cell = lambda: calc.calculate(cell.atomic_numbers, cell.pos, cell=cell.cell,
                                      pbc=cell.pbc)
    case("periodic energy", jobs["periodic energy"], device, card,
         export_inputs(cell, EXPORT_CAPS, periodic=True), ref_cell,
         lambda got, ref: held_energy_forces(f"periodic, a {cell.num_atoms}-atom cell",
                                             got[0], got[1], ref))

    # gmx: a 12 A periodic box of 120 atoms, in nm and kJ/mol
    rng = np.random.default_rng(17)
    box = np.eye(3) * 12.0
    zb = rng.integers(1, 9, 120).astype(np.int32)
    pb = rng.uniform(0, 1, size=(120, 3)) @ box
    n_edges = radius_graph_pbc_np(pb, box, np.ones(3, bool), 5.0)[0].shape[1]
    nm = unit_conversion("nm", "Angstrom")
    gmx_in = [np.zeros((EXPORT_CAPS[0], 3), np.float32), np.zeros(EXPORT_CAPS[0], np.int32),
              (box / nm).astype(np.float32), np.ones(3, bool), np.zeros(1, np.int32)]
    gmx_in[0][:120] = pb / nm
    gmx_in[1][:120] = zb
    e_conv = unit_conversion("eV", GMX_UNITS[keys.TOTAL_ENERGY])

    def gmx_check(got, ref):
        n_found, needed = int(got[2]), got[3].tolist()
        print(f"[export] gmx: n_edges_found {n_found} (the host list {n_edges}, max_edges "
              f"{EXPORT_CAPS[1]}), needed_reps {needed} (max_reps 1)")
        if n_found != n_edges or n_found > EXPORT_CAPS[1] or max(needed) > 1:
            fail("(b) gmx: the in-graph neighbour list overflowed or missed edges")
        held_energy_forces("gmx, a 120-atom periodic box", got[0], got[1], ref, e_conv,
                           e_conv * nm)

    case("gmx", jobs["gmx"], device, card, gmx_in,
         lambda: calc.calculate(zb, pb, cell=box, pbc=np.ones(3, bool)), gmx_check)

    # dipole and net_charge on the five-head model, with a charge of +1
    eng_q = InferenceEngine(ck_q, device=device)
    mol_q = Datapoint(mol.atomic_numbers, mol.pos, edge_index=mol.edge_index, charge=1)
    ref_q = lambda: eng_q.predict([mol_q], compute_forces=False)[0]

    def dipole_check(got, ref):
        errs = {}
        for i, k in enumerate((keys.ATOMIC_CHARGES, keys.DIPOLE)):
            w = ref[0][k]
            errs[k] = float(np.abs(got[i][:len(w)] - w).max() / np.abs(w).max())
            errs[k + " spread"] = float(np.abs(ref[1][k] - w).max() / np.abs(w).max())
        q_sum = float(got[0][:mol.num_atoms].sum())
        print(f"[export] dipole, charge +1: charges {errs[keys.ATOMIC_CHARGES]:.3e}, dipole "
              f"{errs[keys.DIPOLE]:.3e} of their max (limit 1e-4 + 2x the spread); charges "
              f"sum to {q_sum:.6f}")
        for k in (keys.ATOMIC_CHARGES, keys.DIPOLE):
            if errs[k] > 1e-4 + 2 * errs[k + " spread"]:
                fail(f"(b) dipole: {k} disagrees")
        if abs(q_sum - 1.0) > 1e-4:
            fail("(b) dipole: the charges do not sum to the total charge")

    case("dipole", jobs["dipole"], device, card,
         export_inputs(mol, EXPORT_CAPS, charge=1), ref_q, dipole_check)
    calc_q = Calculator(ck_q, device=device)
    case("net charge", jobs["net charge"], device, card,
         export_inputs(mol, EXPORT_CAPS, charge=-3),
         lambda: calc_q.calculate(mol.atomic_numbers, mol.pos, charge=1),
         lambda got, ref: held_energy_forces("energy, net_charge +1 baked in (input -3 "
                                             "ignored)", got[0], got[1], ref))

    # matrix: XMatNet's blocks against its plain forward
    m_mod, m_extra, _, _, _ = load_model_from_checkpoint(ck_m)
    m_fwd = make_forward(m_mod.to(device).eval().requires_grad_(False), m_extra)
    m_batch = collate([mol])
    ref_m = lambda: {k: v.cpu().numpy() for k, v in
                     m_fwd(batch_to_device(m_batch, device), False, False).items()
                     if k in (keys.NODE_MAT_BLOCKS, keys.EDGE_MAT_BLOCKS)}

    def matrix_check(got, ref):
        rows = {keys.NODE_MAT_BLOCKS: mol.num_atoms, keys.EDGE_MAT_BLOCKS: mol.num_edges}
        for i, (k, n) in enumerate(rows.items()):
            w = ref[0][k][:n]
            err = float(np.abs(got[i][:n] - w).max() / np.abs(w).max())
            spread = float(np.abs(ref[1][k][:n] - w).max() / np.abs(w).max())
            print(f"[export] matrix: {k} {err:.3e} of its max (limit 1e-4 + 2 x {spread:.3e})")
            if err > 1e-4 + 2 * spread:
                fail(f"(b) matrix: {k} disagrees")

    case("matrix", jobs["matrix"], device, card, export_inputs(mol, EXPORT_CAPS), ref_m,
         matrix_check)
    calc.close()
    return calls


def dp_micro_batch(rank, lay):
    """Rank ``rank``'s micro-batch of phase 11 (c)'s f32 gradient check: 32
    bench molecules each (seed 77), in the mega slot layout."""
    from xequinet_torch.data.batching import collate

    dps = build_molecules(64, seed=77)
    return collate(dps[32 * rank:32 * (rank + 1)], kernel_layout=layout(*lay))


def _dp_rank(rank, port, db, tmp, sizes, kw, lay, device_type):
    """One rank of phase 11 (c), in a spawned process: a gloo group of 2 (the
    caller's own: maybe_init_distributed leaves it as it is), ``run_train``
    with dp_devices 2 on the mega route, each step's launches and ms
    recorded; then 10 all-reduces of the step's gradient buffer, timed, and
    one f32 ``make_dp_train_step`` without the clip.  Writes its record to
    ``tmp/dp_rank<rank>.json``."""
    import hashlib
    import json
    import os

    import torch.distributed as dist

    from xequinet_torch.ops import cuda_build
    from xequinet_torch.parallel import data_parallel as dp
    from xequinet_torch.run.inference import batch_to_device
    from xequinet_torch.run.train import run_train
    from xequinet_torch.training import trainer as trainer_mod
    from xequinet_torch.utils.config import load_config

    card_run = device_type == "cuda"
    sync = torch.cuda.synchronize if card_run else (lambda: None)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=2)
    rec = {"steps": [], "step_ms": [], "allreduce_ms": []}
    build = trainer_mod.Trainer._build_steps

    def counted_build(self):
        build(self)
        step = self.train_step

        def counted(*a, **k):
            cuda_build.reset_launch_counts()
            sync()
            t0 = time.perf_counter()
            out = step(*a, **k)
            sync()
            rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
            rec["steps"].append(dict(cuda_build.LAUNCHES))
            return out

        self.train_step = counted

    trainer_mod.Trainer._build_steps = counted_build
    kw = dict(FLAGSHIP_KW, pallas_layout=(*lay, PAD_NODES, MAX_CHUNKS), **kw)
    trainer = {"max_epochs": 1, "warmup_epochs": 0, "lossfn": "l2",
               "losses_weight": TRAIN_WEIGHTS, "ema_decay": 0.999, "grad_clip": 5.0,
               "save_dir": os.path.join(tmp, f"run{rank}"), "log_steps": 1000, "seed": 0,
               "dp_devices": 2}
    if not card_run:
        trainer["device"] = "cpu"
    cfg = load_config(overrides={
        "model": {"model_name": "xpainn", "model_kwargs": kw},
        "data": {"db_path": db, "targets": ["energy", "forces"],
                 "batch_size": sizes["batch"], "valid_batch_size": 8},
        "trainer": trainer})
    t0 = time.perf_counter()
    tr = run_train(cfg)
    sync()
    rec["wall_s"] = time.perf_counter() - t0
    trainer_mod.Trainer._build_steps = build
    # the step's all-reduce alone: the gradients' sizes and the loss
    grads = [torch.zeros_like(p) for p in tr.module.parameters()]
    grads.append(torch.zeros(1, device=grads[0].device))
    for _ in range(10):
        sync()
        t0 = time.perf_counter()
        dp.all_reduce_mean_(grads)
        sync()
        rec["allreduce_ms"].append((time.perf_counter() - t0) * 1e3)
    digest = lambda ts: hashlib.sha256(b"".join(
        t.detach().double().cpu().numpy().tobytes() for t in ts)).hexdigest()
    rec["params"] = digest(tr.module.parameters())
    rec["ema"] = digest(tr.ema_module.parameters())
    rec["world_size"] = tr.world_size
    # one f32 step of make_dp_train_step (no clip) from the seed-0 f32
    # weights: the all-reduced gradient, read back from Adam's first moment
    module, _, step, ema = train_model(torch.device(device_type), dp_step=True,
                                       **dict(kw, **F32))
    b = batch_to_device(dp_micro_batch(rank, lay), device_type)
    step(b, 0, 1.0, ema)
    b1 = step.optimizer.defaults["betas"][0]
    if rank == 0:
        torch.save({n: (step.optimizer.state[p]["exp_avg"] / (1 - b1)).cpu()
                    for n, p in module.named_parameters()}, os.path.join(tmp, "dp_grads.pt"))
    with open(os.path.join(tmp, f"dp_rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    dist.destroy_process_group()


def phase_dp(device, card, tmp, sizes, kw, lay):
    """Phase 11 (c): two ranks of one gloo group on the one card (NCCL
    refuses two ranks on one device; gloo stages the card's tensors through
    the host) train FLAGSHIP_KW on the mega route, bf16, on bench molecules,
    a micro-batch of batch / 2 per rank, one epoch, through ``run_train``
    with dp_devices 2: bit-identical parameters and EMA at the end, 3 + 6 +
    3 message launches per step on each rank, checkpoints from rank 0
    alone, and the gradient of one f32 ``make_dp_train_step`` without the
    clip (Adam's first moment over 1 - beta1) against the mean of the two
    micro-batches' gradients taken here, within phase 6's limit.
    Returns the launches per rank and step."""
    import json
    import os
    import socket

    import torch.multiprocessing as mp

    from xequinet_torch.data.store import create_dataset

    card_run = device.type == "cuda"
    t0 = time.perf_counter()
    db = os.path.join(tmp, "dpdb")
    n_train, n_valid = sizes["n_train"], sizes["n_valid"]
    create_dataset(db, build_molecules(n_train + n_valid, seed=98), units={},
                   split={"train": list(range(n_train)),
                          "valid": list(range(n_train, n_train + n_valid)), "test": []})
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    ctx = mp.start_processes(_dp_rank, args=(port, db, tmp, sizes, kw, lay, device.type), nprocs=2,
                             join=False, start_method="spawn")
    deadline = time.perf_counter() + sizes["timeout"]
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() > deadline:
                fail(f"(c) the two ranks did not finish within {sizes['timeout']} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(5)
    recs = []
    for r in range(2):
        with open(os.path.join(tmp, f"dp_rank{r}.json")) as f:
            recs.append(json.load(f))
    print(f"[dp] world size 2 on one card over gloo (two processes on one device; gloo "
          f"stages the card's tensors through the host): its ms are not a multi-GPU speed")
    want = dict(message_fwd=3, message_bwd=6, message_bwd2=3) if card_run else {}
    counts = recs[0]["steps"][0]
    for r, rec in enumerate(recs):
        bad = [c for c in rec["steps"] if card_run and
               c != {k: want.get(k, 0) for k in c}]
        print(f"[dp] rank {r}: {len(rec['steps'])} steps in {rec['wall_s']:.1f} s of run_train; "
              f"median step {np.median(rec['step_ms']):.3f} ms; the step's gradient all-reduce "
              f"alone {np.median(rec['allreduce_ms']):.3f} ms (median of "
              f"{len(rec['allreduce_ms'])}); launches per step {rec['steps'][0]} — {card}")
        if bad or rec["world_size"] != 2:
            fail(f"(c) rank {r}: launches per step {bad[:2]} (want {want}), world size "
                 f"{rec['world_size']}")
    if recs[0]["params"] != recs[1]["params"] or recs[0]["ema"] != recs[1]["ema"]:
        fail("(c) the ranks' parameters or EMA differ after training")
    if len(recs[0]["steps"]) != len(recs[1]["steps"]):
        fail("(c) the ranks ran different numbers of steps")
    ck0 = [f for f in os.listdir(os.path.join(tmp, "run0")) if f.endswith(".ckpt")]
    ck1 = [f for f in os.listdir(os.path.join(tmp, "run1")) if f.endswith(".ckpt")] \
        if os.path.isdir(os.path.join(tmp, "run1")) else []
    print(f"[dp] parameters and EMA bit-identical on both ranks; checkpoints: rank 0 {ck0}, "
          f"rank 1 {ck1}")
    if not ck0 or ck1:
        fail("(c) checkpoints were not written by rank 0 alone")

    # the f32 DP step's gradient against the mean of the two micro-batches'
    # gradients, taken in this process
    module, forward, _, _ = train_model(device, **dict(
        kw, pallas_layout=(*lay, PAD_NODES, MAX_CHUNKS), **F32))
    from xequinet_torch.run.inference import batch_to_device

    got = torch.load(os.path.join(tmp, "dp_grads.pt"))
    sums, nudged = {}, {}
    for r in range(2):
        b = batch_to_device(dp_micro_batch(r, lay), device)
        for acc, scale in ((sums, 1.0), (nudged, 1.0 + 1e-7)):
            _, g = model_grads(module, forward, b, scale)
            for n, v in g.items():
                acc[n] = acc.get(n, 0) + v.cpu()
    worst, worst_ratio = "", 0.0
    for n, v in sums.items():
        mean = v / 2
        scale_n = max(float(mean.abs().max()), 1e-30)
        limit = GRAD_TOL + GRAD_ULP_FACTOR * float((nudged[n] / 2 - mean).abs().max()) / scale_n
        err = float((got[n] - mean).abs().max()) / scale_n
        if err / limit > worst_ratio:
            worst, worst_ratio = n, err / limit
        if err > limit:
            fail(f"(c) the f32 DP step's gradient of {n} differs from the mean by {err:.3e} of "
                 f"its max (limit {limit:.3e})")
    print(f"[dp] f32 make_dp_train_step (no clip): its gradient, from Adam's first moment, "
          f"within its limit of the two micro-batches' mean taken in one process for every "
          f"parameter, the closest {worst} at {worst_ratio:.3f} of it; phase 11 (c) in "
          f"{time.perf_counter() - t0:.1f} s")
    return {k: v for k, v in counts.items()}


def phase_profiling(dps, device, card, tmp, kw, lay):
    """Phase 11 (d): ``utils/profiling.trace`` around two mega train steps,
    each in an ``annotate`` range: the trace holds the annotate names and
    (on the card) the three message kernels; ``device_memory_stats`` reads
    the card."""
    import json
    import os
    import re

    from xequinet_torch.data.batching import collate
    from xequinet_torch.run.inference import batch_to_device
    from xequinet_torch.utils import profiling

    card_run = device.type == "cuda"
    module, forward, step, ema = train_model(device, **dict(kw, pallas_layout=(
        *lay, PAD_NODES, MAX_CHUNKS)))
    b = batch_to_device(collate(dps[:256], kernel_layout=layout(*lay)), device)
    step(b, 0, 1.0, ema)
    logdir = os.path.join(tmp, "trace")
    with profiling.trace(logdir):
        for i in (1, 2):
            with profiling.annotate(f"xeq_train_step_{i}"):
                step(b, i, 1.0, ema)
        if card_run:
            torch.cuda.synchronize()
    with open(os.path.join(logdir, "trace.json")) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    found = {k: sorted(n for n in names if re.search(rf"\b{k}_[a-z0-9_]*kernel", n))[:2]
             for k in MESSAGE_KERNELS}
    mem = profiling.device_memory_stats()
    print(f"[profile] trace.json: annotate ranges "
          f"{sorted(n for n in names if n.startswith('xeq_train_step'))}; "
          f"message kernels {found}; device_memory_stats {mem}")
    if not {"xeq_train_step_1", "xeq_train_step_2"} <= names:
        fail("(d) the trace lacks the annotate ranges")
    if card_run and (not all(found.values()) or not mem
                     or not all(v["limit_gb"] > 0 for v in mem.values())):
        fail("(d) the trace lacks a message kernel, or no card's memory was read")


def phase_11(dps, device, card, sizes):
    """Phase 11: (a) determinism, (b) export, (c) data parallelism across
    two processes, (d) profiling.  Returns each path's launches."""
    import os
    import tempfile

    t0 = time.perf_counter()
    out = {}
    kw, lay = sizes["kw"], sizes["layout"]
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        phase_determinism(dps, device, card, tmp, sizes["det"], kw, lay)
        out["export_call"] = phase_export(dps, device, card, tmp, kw)
        out["dp_train_step"] = phase_dp(device, card, tmp, sizes["dp"], kw, lay)
        phase_profiling(dps, device, card, tmp, kw, lay)
    print(f"[phase 11] in {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 12: one large system split over several ranks
# ---------------------------------------------------------------------------
# sizes on the card: phase 7's 10,000-atom box and 4,000-atom chain over 4
# ranks; run_md's steps; run_halo_train's boxes (gp 2 x dp 2), epochs and rate;
# the box of the f32 gradient and the Ewald check.  The training rate: the
# energy term grows as the square of the atoms, and on 2,000-atom boxes
# AdamW's first step at 3e-4 overshoots (the loss 1.5e4 -> 3.3e6, then
# up and down); at 3e-6 it falls step by step (PERF.md, phase 12)
H12_SIZES = dict(ranks=4, n_box=10000, n_free=4000, md_steps=20, n_train_atoms=2000,
                 n_train=4, n_valid=2, epochs=3, lr=3e-6, n_small=2000, calls=3,
                 timeout=900, kw={})
H12_REHEARSAL = dict(ranks=4, n_box=600, n_free=700, md_steps=4, n_train_atoms=400,
                     n_train=4, n_valid=2, epochs=2, lr=3e-4, n_small=400, calls=1,
                     timeout=600, kw=MD_REHEARSAL["kw"])
# the halo calculators' kernel layout (HaloCalculator's default, the JAX
# package's): block_nodes min(256, n_local), chunk 1024
H12_LAYOUT = (256, 1024)
H12_WEIGHTS = (1.0, 10.0)


def h12_box(n, seed):
    """md_box(n) moved by 0.05 A of noise from ``seed`` (seed 0: md_box
    itself): the training set's boxes."""
    z, pos, cell, pbc, _ = md_box(n)
    if seed:
        pos = pos + np.random.default_rng(seed).normal(size=pos.shape) * 0.05
    return z, pos, cell, pbc


def h12_labels(n, perm=None):
    """The f32 gradient check's labels: energy 0, forces from seed 12 (in
    input order, or sorted by ``perm``)."""
    f = (np.random.default_rng(12).normal(size=(n, 3)) * 0.1).astype(np.float32)
    return 0.0, (f if perm is None else f[perm])


def _h12_rank(rank, port, tmp, sizes, device_type, backend):
    """One rank of phase 12, in a spawned process: a group of ``ranks``
    (gloo on the one card, or NCCL with one card per rank).  Runs (a) the
    HaloCalculator on the box and the chain, (b) run_md with halo_devices,
    (c) run_halo_train (gp 2 x dp 2), one f32 make_halo_train_step and the
    Ewald model with a charge, (d) the edge partition; writes its record
    to ``tmp/h12_<backend>_<rank>.json`` and (rank 0) the arrays to
    ``tmp/h12_<backend>.npz``.  With NCCL only (a) runs."""
    import hashlib
    import os

    import torch.distributed as dist

    from xequinet_torch import keys
    from xequinet_torch.ops import cuda_build
    from xequinet_torch.ops import scatter as sc
    from xequinet_torch.parallel import halo as hm

    card_run = device_type == "cuda"
    # the host's cores shared by the ranks; f32 without TF32, as in main()
    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    if backend == "nccl":
        torch.cuda.set_device(rank)
    world = sizes["ranks"]
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    dev = torch.device("cuda", torch.cuda.current_device()) if card_run else torch.device("cpu")
    sync = torch.cuda.synchronize if card_run else (lambda: None)
    digest = lambda a: hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()
    rec, arrays = {"transport": None}, {}
    ck = {k: os.path.join(tmp, f"h12_{k}.ckpt") for k in ("bf16", "f32", "ewald", "plain")}

    # (a) forward and forces: the parts of each call timed, launches counted
    def call(calc, z, pos, sys_kw, tag, n_calls):
        samples = []
        for i in range(n_calls):
            cuda_build.reset_launch_counts()
            sc.reset_exchange_stats()
            sync()
            t0 = time.perf_counter()
            stacked, geom, perm, ws = calc.prepare(z, pos, **sys_kw)
            t1 = time.perf_counter()
            if card_run:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
            e, f_local = calc.run(stacked, geom, ws, "cell" in sys_kw)
            if card_run:
                ev[1].record()
            sync()
            t2 = time.perf_counter()
            stats = dict(sc.EXCHANGE_STATS)
            launches = dict(cuda_build.LAUNCHES)
            forces = calc.gather(f_local, stacked, geom, perm)
            t3 = time.perf_counter()
            samples.append({"prep_ms": (t1 - t0) * 1e3, "run_ms": (t2 - t1) * 1e3,
                            "device_ms": ev[0].elapsed_time(ev[1]) if card_run else None,
                            "gather_ms": (t3 - t2) * 1e3, "total_ms": (t3 - t0) * 1e3,
                            "exchange_ms": stats["seconds"] * 1e3,
                            "exchanges": stats["calls"], "exchange_bytes": stats["bytes"],
                            "launches": launches, "energy": float(e)})
            rec["transport"] = stats["transport"]
            arrays[f"{tag}_{i}"] = forces
            rec.setdefault("digests", {})[f"{tag}_{i}"] = digest(forces)
        rec.setdefault("geom", {})[tag] = {k: int(v) for k, v in geom.items()} | {
            "edge_cap": int(calc._edge_cap), "slot_cap": calc._slot_cap,
            "max_chunks": calc._mxc,
            "real_edges": [int(x) for x in stacked[keys.EDGE_MASK].sum(1)]}
        rec.setdefault("calls", {})[tag] = samples

    t0 = time.perf_counter()
    zb, posb, cell, pbc = h12_box(sizes["n_box"], 0)
    box = dict(cell=cell, pbc=pbc)
    zc, posc = md_free_chain(sizes["n_free"])
    dev_arg = device_type
    for label in ("bf16", "f32"):
        calc = hm.HaloCalculator(ck[label], pallas="mega", pallas_layout=H12_LAYOUT,
                                 device=dev_arg)
        grid = label == "f32"
        pb = np.round(posb / MD_GRID) * MD_GRID if grid else posb
        pc = np.round(posc / MD_GRID) * MD_GRID if grid else posc
        # the first call builds the model: not timed
        call(calc, zb, pb, box, f"box_{label}_warm", 1)
        call(calc, zb, pb, box, f"box_{label}", 1 + (sizes["calls"] if label == "bf16" else 1))
        call(calc, zc, pc, {}, f"chain_{label}", 2)
        del calc
    rec["a_s"] = time.perf_counter() - t0
    if backend == "nccl":
        _h12_write(tmp, backend, rank, rec, arrays)
        dist.destroy_process_group()
        return

    # (b) MD: every force call counted
    t0 = time.perf_counter()
    from xequinet_torch.run.dynamics import run_md
    from xequinet_torch.utils.config import MDConfig

    orig = hm.HaloCalculator.calculate
    md_calls = []

    def counted(self, *a, **k):
        cuda_build.reset_launch_counts()
        out = orig(self, *a, **k)
        md_calls.append(dict(cuda_build.LAUNCHES))
        return out

    hm.HaloCalculator.calculate = counted
    state = run_md(MDConfig(
        ensembles=[{"name": "nve", "timestep": MD_DT, "steps": sizes["md_steps"],
                    "log_interval": 5}],
        input_file=os.path.join(tmp, "h12_chain.xyz"), model_file=ck["f32"],
        logfile=os.path.join(tmp, f"h12_md_{rank}.log"),
        xyz_traj=os.path.join(tmp, f"h12_md_traj_{rank}.xyz"), seed=3, init_temperature=300.0,
        halo_devices=world, pallas="mega", device=dev_arg))
    hm.HaloCalculator.calculate = orig
    rec["md"] = {"pos": digest(state.pos), "vel": digest(state.vel), "calls": md_calls}
    arrays["md_pos"] = state.pos
    rec["b_s"] = time.perf_counter() - t0

    # (c) training: run_halo_train with each step's launches and loss
    t0 = time.perf_counter()
    from xequinet_torch.run.train import run_train
    from xequinet_torch.utils.config import load_config

    make_step = hm.make_halo_train_step
    steps = []

    def counted_step(*a, **k):
        step = make_step(*a, **k)

        def run(*sa, **sk):
            cuda_build.reset_launch_counts()
            sync()
            s0 = time.perf_counter()
            loss = step(*sa, **sk)
            sync()
            steps.append({"launches": dict(cuda_build.LAUNCHES), "loss": float(loss),
                          "ms": (time.perf_counter() - s0) * 1e3})
            return loss

        return run

    hm.make_halo_train_step = counted_step
    kw = dict(FLAGSHIP_KW, pallas_layout=(*H12_LAYOUT, 0, 0), **sizes["kw"])
    trainer = {"max_epochs": sizes["epochs"], "warmup_epochs": 0, "max_lr": sizes["lr"],
               "seed": 0,
               "losses_weight": {"energy": H12_WEIGHTS[0], "forces": H12_WEIGHTS[1]},
               "save_dir": os.path.join(tmp, f"h12_run{rank}"), "run_name": "halo",
               "dp_devices": 2, "gp_devices": world // 2, "log_steps": 1000}
    if not card_run:
        trainer["device"] = "cpu"
    cfg = load_config(overrides={
        "model": {"model_name": "xpainn", "model_kwargs": kw},
        "data": {"db_path": os.path.join(tmp, "h12_db"), "targets": ["energy", "forces"],
                 "cutoff": 5.0},
        "trainer": trainer})
    module = run_train(cfg)
    hm.make_halo_train_step = make_step
    rec["train"] = {"steps": steps, "params": digest(np.concatenate(
        [p.detach().float().cpu().numpy().ravel() for p in module.parameters()])),
        "layout": list(cfg.model.model_kwargs["pallas_layout"]),
        "files": sorted(os.listdir(trainer["save_dir"]))}
    del module

    # one f32 step of make_halo_train_step over every rank: the mean
    # gradient, from a tap that keeps it
    from xequinet_torch.models.model import resolve_model
    from xequinet_torch.run.inference import load_model_from_checkpoint

    zs, poss, cells, pbcs = h12_box(sizes["n_small"], 0)
    stacked, geom, perm, ws, _, _ = hm.prepare_halo_system(zs, poss, 5.0, world, cell=cells,
                                                           pbc=pbcs)
    bn = min(H12_LAYOUT[0], geom["n_local"])
    stacked, _, mxc = hm.apply_halo_kernel_layout(stacked, geom, {"block_nodes": bn,
                                                                  "chunk": H12_LAYOUT[1]})
    loaded, _, _, _, mc = load_model_from_checkpoint(ck["f32"])
    module, _, _ = resolve_model("xpainn", **dict(mc["model_kwargs"], use_pallas_scatter="mega",
                                                  pallas_layout=(bn, H12_LAYOUT[1],
                                                                 geom["halo"], mxc)))
    module.load_state_dict(loaded.state_dict())
    module = module.to(dev)
    names = [n for n, _ in module.named_parameters()]

    class Tap:
        def step(self):
            self.grads = [p.grad.detach().cpu().numpy().copy() for p in module.parameters()]

    tap = Tap()
    e_label, f_label = h12_labels(len(zs), perm)
    f_st = hm.scatter_labels_to_shards(stacked, geom, f_label)
    cuda_build.reset_launch_counts()
    loss = make_step(module, None, geom, tap, *H12_WEIGHTS)(
        hm.local_batch(stacked, rank, dev), e_label, f_st[rank], ws)
    rec["grad_step"] = {"loss": float(loss), "launches": dict(cuda_build.LAUNCHES),
                        "grads": digest(np.concatenate([g.ravel() for g in tap.grads]))}
    for n, g in zip(names, tap.grads):
        arrays[f"grad/{n}"] = g
    del module

    # XPaiNN-Ewald with a charge, on the same box
    calc = hm.HaloCalculator(ck["ewald"], pallas="mega", pallas_layout=H12_LAYOUT,
                             device=dev_arg)
    cuda_build.reset_launch_counts()
    res = calc.calculate(zs, poss, cell=cells, pbc=pbcs, charge=1)
    rec["ewald"] = {"energy": res[keys.TOTAL_ENERGY], "launches": dict(cuda_build.LAUNCHES)}
    arrays["ewald_forces"] = res[keys.FORCES]
    del calc
    rec["c_s"] = time.perf_counter() - t0

    # (d) edge partition: the plain f32 route on the box, nodes replicated
    t0 = time.perf_counter()
    from xequinet_torch.data.batching import collate
    from xequinet_torch.data.datapoint import Datapoint
    from xequinet_torch.ops.radius_graph import radius_graph_pbc_np
    from xequinet_torch.parallel.edge_partition import make_edge_parallel_forward, shard_batch
    from xequinet_torch.run.inference import batch_to_device

    ei, offs = radius_graph_pbc_np(posb, cell, pbc, 5.0)
    batch = collate([Datapoint(zb, posb, cell=cell, pbc=pbc, edge_index=ei,
                               cell_offsets=offs)])
    loaded, extra, _, _, _ = load_model_from_checkpoint(ck["plain"])
    fwd = make_edge_parallel_forward(loaded.to(dev).requires_grad_(False),
                                     extra_properties=extra)
    share = batch_to_device(shard_batch(batch, world, rank), dev)
    out = fwd(share, True, True)
    sync()
    s0 = time.perf_counter()
    out = fwd(share, True, True)
    sync()
    rec["edge"] = {"ms": (time.perf_counter() - s0) * 1e3,
                   "energy": float(out[keys.TOTAL_ENERGY][0]),
                   "forces": digest(out[keys.FORCES].cpu().numpy())}
    arrays["edge_forces"] = out[keys.FORCES][:len(zb)].cpu().numpy()
    arrays["edge_virial"] = out[keys.VIRIAL][0].cpu().numpy()
    rec["d_s"] = time.perf_counter() - t0
    _h12_write(tmp, backend, rank, rec, arrays)
    dist.destroy_process_group()


def _h12_write(tmp, backend, rank, rec, arrays):
    import json
    import os

    with open(os.path.join(tmp, f"h12_{backend}_{rank}.json"), "w") as f:
        json.dump(rec, f)
    if rank == 0:
        np.savez(os.path.join(tmp, f"h12_{backend}.npz"), **arrays)


def _h12_spawn(tmp, sizes, device_type, backend):
    """Start the ranks and wait for them, killing all on the time limit;
    returns (records by rank, rank 0's arrays)."""
    import json
    import os
    import socket

    import torch.multiprocessing as mp

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    ctx = mp.start_processes(_h12_rank, args=(port, tmp, sizes, device_type, backend),
                             nprocs=sizes["ranks"], join=False, start_method="spawn")
    deadline = time.perf_counter() + sizes["timeout"]
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() > deadline:
                fail(f"the {sizes['ranks']} {backend} ranks did not finish within "
                     f"{sizes['timeout']} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(5)
    recs = []
    for r in range(sizes["ranks"]):
        with open(os.path.join(tmp, f"h12_{backend}_{r}.json")) as f:
            recs.append(json.load(f))
    return recs, dict(np.load(os.path.join(tmp, f"h12_{backend}.npz")))


def h12_kernels(device, card, sizes):
    """Phase 12, kernels: the message kernels against their plain versions on
    shard 0's halo layout of the box (HaloCalculator's partition and slot
    layout), then each one's time beside its plain version's and its bound.
    Returns {name: (max_abs_err, ms, plain_ms, bound_ms, bound_by)}."""
    from xequinet_torch import keys
    from xequinet_torch.parallel import halo as hm

    z, pos, cell, pbc = h12_box(sizes["n_box"], 0)
    stacked, geom, _, _, _, _ = hm.prepare_halo_system(z, pos, 5.0, sizes["ranks"],
                                                       cell=cell, pbc=pbc)
    bn = min(H12_LAYOUT[0], geom["n_local"])
    stacked, slot_cap, mxc = hm.apply_halo_kernel_layout(
        stacked, geom, {"block_nodes": bn, "chunk": H12_LAYOUT[1]}, margin=1.3)
    shard = {k: v[0] for k, v in stacked.items()}
    shard[keys.POSITIONS] = np.zeros((geom["window"], 3), np.float32)
    p = message_problem(shard, device, bn=bn, chunk=H12_LAYOUT[1])
    p["n_atoms"] = int((shard[keys.ATOMIC_NUMBERS] > 0).sum())  # window rows read
    print(f"[halo] shard 0 of {sizes['ranks']}: window {geom['window']} rows (n_local "
          f"{geom['n_local']}, halo {geom['halo']}), {int(shard[keys.EDGE_MASK].sum())} real "
          f"edges in {slot_cap} slots, block_nodes {bn}, chunk {H12_LAYOUT[1]}, max_chunks "
          f"{mxc}")
    if device.type != "cuda":
        for mm in ("float32", "bfloat16"):
            assert all(torch.isfinite(t).all() for t in plain_fwd(p, mm) + plain_bwd(p, mm))
        return {}
    err = check_message_kernels(p, tag="halo shard 0")
    mm = "bfloat16"
    p_mm = dict(p, **{k: p[k].to(torch.bfloat16) for k in ("x_cat", "ef", "wf", "g", "cx",
                                                            "cef")})
    out = {}
    fns = (("message_fwd", kernel_fwd, plain_fwd), ("message_bwd", kernel_bwd, plain_bwd),
           ("message_bwd2", kernel_bwd2, plain_bwd2))
    for (name, kfn, pfn), (nbytes, flops) in zip(fns, kernel_costs(p, mm)):
        k_ms = time_ms(lambda: kfn(p_mm, mm))
        p_ms = time_ms(lambda: pfn(p_mm, mm), iters=5, warmup=1)
        b_ms, b_by = bound_ms(nbytes, flops, mm)
        print(f"[time] {name} ({mm}) on shard 0's halo layout, "
              f"{kernel_route(name, mm, p['statics'])}: kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.3f} GFLOP) — {card}")
        out[name] = {"max_abs_err": err[name], "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                     "bound_by": b_by}
    del p, p_mm
    return out


def _h12_calls_summary(recs, tag):
    """Medians over the timed calls of every rank of one case."""
    keys_ = ("prep_ms", "run_ms", "device_ms", "gather_ms", "total_ms", "exchange_ms")
    out = {}
    for k in keys_:
        vals = [c[k] for r in recs for c in r["calls"][tag] if c[k] is not None]
        out[k] = float(np.median(vals)) if vals else None
    c0 = recs[0]["calls"][tag][0]
    out["exchanges"] = c0["exchanges"]
    out["bytes_sent"] = c0["exchange_bytes"]
    return out


def _h12_check_a(part, recs, arr, ref, ref_ms, card, card_run, ranks, kw):
    """Phase 12 (a), or (e) over NCCL: every rank the same forces, 3 + 3
    launches per rank and call, the calls' parts timed, and agreement with
    the single-process Calculator (bf16 2e-2; f32 on the grid 1e-4 and
    forces element-wise within F32_FORCE_TOL plus twice the larger of the
    two runs' own spreads over two calls).  Returns one call's launches."""
    from xequinet_torch import keys

    from xequinet_torch.ops.irreps import Irreps
    from xequinet_torch.parallel.halo import comm_bytes_per_block

    kw = dict(MD_KW, **kw)
    feat_dim = kw["node_dim"] + Irreps(kw["node_irreps"]).dim  # the aggregate's columns
    refresh = {t: comm_bytes_per_block(recs[0]["geom"][f"{t}_bf16"], feat_dim,
                                       0)["halo_exchange"] for t in ("box", "chain")}
    want = dict(message_fwd=3, message_bwd=3) if card_run else {}
    for r in recs[1:]:
        if r["digests"] != recs[0]["digests"]:
            fail(f"{part} the ranks returned different forces")
    halo_call = None
    for r, rec in enumerate(recs):
        for tag, samples in rec["calls"].items():
            for c in samples:
                got = {k: v for k, v in c["launches"].items() if v}
                if card_run and got != want:
                    fail(f"{part} rank {r} {tag}: launches {got}, want {want}")
                halo_call = c["launches"]
    for sys_tag in ("box", "chain"):
        g = recs[0]["geom"][f"{sys_tag}_bf16"]
        print(f"[halo] {part} {sys_tag}: {ranks} shards of n_local {g['n_local']}, halo "
              f"{g['halo']}, window {g['window']}, edge_cap {g['edge_cap']}, real edges per "
              f"shard {g['real_edges']}, slot_cap {g['slot_cap']}, max_chunks "
              f"{g['max_chunks']}")
        for label in ("bf16", "f32"):
            tag = f"{sys_tag}_{label}"
            s = _h12_calls_summary(recs, tag)
            print(f"[halo] {part} {tag}, per rank and call (median over ranks and calls): "
                  f"total {s['total_ms']:.2f} ms = host partition {s['prep_ms']:.2f} + "
                  f"forward and forces {s['run_ms']:.2f} (CUDA events "
                  + (f"{s['device_ms']:.2f}" if s['device_ms'] is not None else "not measured")
                  + f") + all-gather {s['gather_ms']:.2f} ms; exchanges "
                  f"{s['exchange_ms']:.2f} ms of host time in {s['exchanges']}, rank 0 sending "
                  f"{s['bytes_sent']} bytes, a feature refresh {refresh[sys_tag]} (2 x halo "
                  f"{g['halo']} x {feat_dim} columns x 4 bytes); launches {halo_call}"
                  + (f"; the single-process Calculator {ref_ms[sys_tag]:.2f} ms"
                     if label == "bf16" else "") + f" — {card}")
        e16 = recs[0]["calls"][f"{sys_tag}_bf16"][0]["energy"]
        md_compare(f"{part} {sys_tag} bf16 halo over {ranks} ranks vs single-process mega",
                   {keys.TOTAL_ENERGY: e16, keys.FORCES: arr[f"{sys_tag}_bf16_0"]},
                   ref[f"{sys_tag}_bf16"], TOL["bfloat16"])
        r0, r1 = ref[f"{sys_tag}_f32"]
        spread_max, spread_q = md_force_err(r1[keys.FORCES], r0[keys.FORCES])
        h_max, h_q = md_force_err(arr[f"{sys_tag}_f32_1"], arr[f"{sys_tag}_f32_0"])
        f_tol = (F32_FORCE_TOL[0] + 2 * max(spread_max, h_max),
                 F32_FORCE_TOL[1] + 2 * max(spread_q, h_q))
        print(f"[halo] {part} {sys_tag} f32 own spreads over two calls (max, p99): "
              f"single-process plain {spread_max:.3e}, {spread_q:.3e}; halo {h_max:.3e}, "
              f"{h_q:.3e}")
        e32 = recs[0]["calls"][f"{sys_tag}_f32"][0]["energy"]
        md_compare(f"{part} {sys_tag} f32 halo over {ranks} ranks vs single-process plain, on "
                   f"the {MD_GRID:g} A grid",
                   {keys.TOTAL_ENERGY: e32, keys.FORCES: arr[f"{sys_tag}_f32_0"]}, r0,
                   1e-4, f_tol)
    return halo_call


def _h12_nccl(tmp, device, card, sizes, ref, ref_ms):
    """Phase 12 (e): (a) again with NCCL, one card per rank, where the
    machine has the cards; else a line that says it did not run."""
    card_run = device.type == "cuda"
    ranks = sizes["ranks"]
    n_cards = torch.cuda.device_count() if card_run else 0
    if n_cards < ranks:
        print(f"[halo] nccl_multi_card: not run ({n_cards} card)")
        return
    t0 = time.perf_counter()
    nrecs, narr = _h12_spawn(tmp, sizes, device.type, "nccl")
    print(f"[halo] (e) {ranks} NCCL ranks, one card each, exchange transport "
          f"{nrecs[0]['transport']}; (a) in {nrecs[0]['a_s']:.1f} s, the ranks in "
          f"{time.perf_counter() - t0:.1f} s — {card}")
    _h12_check_a("(e)", nrecs, narr, ref, ref_ms, card, card_run, ranks, sizes["kw"])
    print(f"[halo] nccl_multi_card: ran on {ranks} of {n_cards} cards")


def phase_halo(device, card, sizes, nccl_only=False):
    """Phase 12: one large system split over ``ranks`` processes (gloo on
    the one card; NCCL with one card per rank when there are enough).
    (a) HaloCalculator(pallas="mega") on phase 7's box and chain against the
    single-process Calculator (bf16: energy and mean |F| 2e-2; f32 on the
    2^-10 A grid: energy and mean |F| 1e-4, forces element-wise within
    F32_FORCE_TOL plus twice the reference's own spread), 3 + 3 launches
    per rank and call, the call's parts timed; the kernels on shard 0's
    halo layout; (b) run_md with halo_devices against the single-process
    run_md, replicas bit-identical; (c) run_halo_train gp 2 x dp 2 (3 + 6 +
    3 launches per rank and step, a falling loss, rank-0 checkpoints), one
    f32 make_halo_train_step's gradient against the single-process
    gradient of the same loss, XPaiNN-Ewald with a charge against the
    single-process Calculator; (d) the edge partition (plain f32 route) of
    the box against the single-process forward: energy, forces, virial;
    (e) the NCCL run (``nccl_only``: the references and (e) alone).
    Returns (each path's launches, the kernels' records)."""
    import os
    import tempfile

    from xequinet_torch import keys
    from xequinet_torch.data.batching import collate
    from xequinet_torch.data.datapoint import Datapoint
    from xequinet_torch.data.fmt_conversion import write_xyz
    from xequinet_torch.data.store import create_dataset
    from xequinet_torch.interface.calculator import Calculator
    from xequinet_torch.ops.radius_graph import radius_graph_pbc_np
    from xequinet_torch.run.inference import batch_to_device, load_model_from_checkpoint
    from xequinet_torch.models.properties import make_forward

    t_all = time.perf_counter()
    card_run = device.type == "cuda"
    ranks = sizes["ranks"]
    kern = {} if nccl_only else h12_kernels(device, card, sizes)
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        # the checkpoints (seed-0 weights, phase 7's model), the chain as an
        # extxyz for run_md, the training boxes as an XDB dataset
        md_checkpoint(os.path.join(tmp, "h12_bf16.ckpt"), **sizes["kw"])
        f32 = dict(sizes["kw"], **F32)
        md_checkpoint(os.path.join(tmp, "h12_f32.ckpt"), **f32)
        md_checkpoint(os.path.join(tmp, "h12_plain.ckpt"), **f32)
        md_checkpoint(os.path.join(tmp, "h12_ewald.ckpt"), "xpainn-ewald",
                      **dict(f32, charge_embed=True, **EWALD_PBC))
        zc, posc = md_free_chain(sizes["n_free"])
        write_xyz(os.path.join(tmp, "h12_chain.xyz"), [Datapoint(zc, posc)])
        n_t, n_v = sizes["n_train"], sizes["n_valid"]
        boxes = [h12_box(sizes["n_train_atoms"], 100 + i) for i in range(n_t + n_v)]
        create_dataset(os.path.join(tmp, "h12_db"), [
            Datapoint(z, p, cell=c, pbc=b, energy=0.0, forces=np.zeros((len(z), 3)))
            for z, p, c, b in boxes], units={},
            split={"train": list(range(n_t)), "valid": list(range(n_t, n_t + n_v)),
                   "test": []})

        # the single-process references first, on the idle card
        zb, posb, cell, pbc = h12_box(sizes["n_box"], 0)
        box = dict(cell=cell, pbc=pbc)
        ref, ref_ms = {}, {}
        for sys_tag, z, pos, kw in (("box", zb, posb, box), ("chain", zc, posc, {})):
            mega = Calculator(os.path.join(tmp, "h12_bf16.ckpt"), pallas="mega",
                              device=device)
            ref[f"{sys_tag}_bf16"] = mega.calculate(z, pos, **kw)
            times = []
            for _ in range(sizes["calls"]):
                t0 = time.perf_counter()
                mega.calculate(z, pos, **kw)
                if card_run:
                    torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            ref_ms[sys_tag] = float(np.median(times))
            plain = Calculator(os.path.join(tmp, "h12_f32.ckpt"), device=device)
            grid = np.round(pos / MD_GRID) * MD_GRID
            ref[f"{sys_tag}_f32"] = [plain.calculate(z, grid, **kw) for _ in range(2)]
            del mega, plain
        if card_run:
            torch.cuda.empty_cache()
        print(f"[halo] single-process Calculator(pallas='mega'), bf16, median of "
              f"{sizes['calls']} calls: box {ref_ms['box']:.2f} ms, chain {ref_ms['chain']:.2f} "
              f"ms per call — {card}")

        if nccl_only:
            _h12_nccl(tmp, device, card, sizes, ref, ref_ms)
            return {}, {}
        t0 = time.perf_counter()
        recs, arr = _h12_spawn(tmp, sizes, device.type, "gloo")
        spawn_s = time.perf_counter() - t0
        where = "the one card" if card_run else "the CPU"
        print(f"[halo] {ranks} ranks of one gloo group on {where}, exchange transport: "
              f"{recs[0]['transport']}; the ranks ran in {spawn_s:.1f} s "
              f"((a) {recs[0]['a_s']:.1f} s, (b) {recs[0]['b_s']:.1f} s, (c) "
              f"{recs[0]['c_s']:.1f} s, (d) {recs[0]['d_s']:.1f} s) — {card}")

        # (a) every rank the same result; launches; agreement; times
        want = dict(message_fwd=3, message_bwd=3) if card_run else {}
        halo_call = _h12_check_a("(a)", recs, arr, ref, ref_ms, card, card_run, ranks,
                                 sizes["kw"])

        # (b) MD
        for r, rec in enumerate(recs):
            if (rec["md"]["pos"], rec["md"]["vel"]) != (recs[0]["md"]["pos"],
                                                        recs[0]["md"]["vel"]):
                fail(f"(b) rank {r}'s MD state differs from rank 0's")
            bad = [c for c in rec["md"]["calls"]
                   if card_run and {k: v for k, v in c.items() if v} != want]
            if bad:
                fail(f"(b) rank {r}: launches per force call {bad[:2]}")
        if any(os.path.exists(os.path.join(tmp, f"h12_md_traj_{r}.xyz")) for r in
               range(1, ranks)) or not os.path.exists(os.path.join(tmp, "h12_md_traj_0.xyz")):
            fail("(b) the trajectory was not written by rank 0 alone")
        from xequinet_torch.run.dynamics import run_md
        from xequinet_torch.utils.config import MDConfig

        # the single-process run twice (its own spread is printed).  The
        # chain spans ~4,800 A, where an f32 coordinate's ulp is ~2.4e-4 A,
        # and at random weights it heats by ~2,000 K in 1 fs: positions are
        # held with tests/test_halo.py's run_md limit, |dx| <= 1e-5 + 1e-4
        # |x| element-wise, and the logged Epot within 1e-4
        singles = []
        for _ in range(2):
            lines = _Lines()
            st = run_md(MDConfig(
                ensembles=[{"name": "nve", "timestep": MD_DT, "steps": sizes["md_steps"],
                            "log_interval": 5}],
                input_file=os.path.join(tmp, "h12_chain.xyz"),
                model_file=os.path.join(tmp, "h12_f32.ckpt"), seed=3, init_temperature=300.0,
                pallas="mega", device=device.type), logger=lines)
            singles.append((st.pos, md_energies(lines.lines)))
        with open(os.path.join(tmp, "h12_md_0.log")) as f:
            e_halo = md_energies(f.read().splitlines())
        x0 = singles[0][0]
        spread = float(np.abs(singles[1][0] - x0).max())
        d_pos = float(np.abs(arr["md_pos"] - x0).max())
        ratio = float((np.abs(arr["md_pos"] - x0) / (1e-5 + 1e-4 * np.abs(x0))).max())
        d_e = float(np.abs(e_halo[:, 0] - singles[0][1][:, 0]).max()
                    / np.abs(singles[0][1][:, 0]).max())
        print(f"[halo] (b) run_md halo_devices {ranks}, {sizes['md_steps']} NVE steps on the "
              f"{sizes['n_free']}-atom chain: {len(recs[0]['md']['calls'])} force calls per "
              f"rank, each {want or 'no launch (CPU)'}; replicas bit-identical; against the "
              f"single-process run_md (its own spread {spread:.3e} A): max |dx| {d_pos:.3e} A, "
              f"at {ratio:.3f} of the limit 1e-5 + 1e-4 |x|; Epot at the {len(e_halo)} logged "
              f"frames {d_e:.3e} of max |Epot| (limit 1e-4)")
        if ratio > 1.0 or d_e > 1e-4 or len(e_halo) != len(singles[0][1]):
            fail("(b) the halo MD trajectory left the single-process one")

        # (c) training
        tr = recs[0]["train"]
        want_step = dict(message_fwd=3, message_bwd=6, message_bwd2=3) if card_run else {}
        for r, rec in enumerate(recs):
            if rec["train"]["params"] != tr["params"]:
                fail(f"(c) rank {r}'s parameters differ after run_halo_train")
            bad = [s["launches"] for s in rec["train"]["steps"]
                   if card_run and {k: v for k, v in s["launches"].items() if v} != want_step]
            if bad:
                fail(f"(c) rank {r}: launches per train step {bad[:2]} (want {want_step})")
            if r and any(f.endswith(".ckpt") for f in rec["train"]["files"]):
                fail(f"(c) rank {r} wrote a checkpoint")
        if not {"halo_last.ckpt", "halo_best.ckpt"} <= set(tr["files"]):
            fail("(c) rank 0 wrote no last / best checkpoint")
        losses = [s["loss"] for s in tr["steps"]]
        print(f"[halo] (c) run_halo_train dp 2 x gp {ranks // 2}, {len(losses)} steps on "
              f"{sizes['n_train']} boxes of {sizes['n_train_atoms']} atoms: loss "
              + ", ".join(f"{x:.4g}" for x in losses) + f"; median step "
              f"{np.median([s['ms'] for s in tr['steps']]):.1f} ms; launches per step "
              f"{tr['steps'][0]['launches']}; layout written back {tr['layout']}; rank 0 "
              f"files {tr['files']} — {card}")
        per_epoch = len(losses) // sizes["epochs"]
        first, last = np.mean(losses[:per_epoch]), np.mean(losses[-per_epoch:])
        print(f"[halo] (c) mean step loss, first epoch {first:.4g}, last epoch {last:.4g}")
        if not (np.isfinite(losses).all() and last < first):
            fail("(c) the halo training loss did not fall")

        # one f32 halo step's gradient against the single-process gradient
        zs, poss, cells, pbcs = h12_box(sizes["n_small"], 0)
        ei, offs = radius_graph_pbc_np(poss, cells, pbcs, 5.0)
        sb = batch_to_device(collate([Datapoint(zs, poss, cell=cells, pbc=pbcs, edge_index=ei,
                                                cell_offsets=offs)]), device)
        module, extra, _, _, _ = load_model_from_checkpoint(os.path.join(tmp, "h12_f32.ckpt"))
        module = module.to(device)
        fwd = make_forward(module, extra, create_graph=True)
        e_label, f_label = h12_labels(len(zs))
        f_label = torch.as_tensor(f_label, device=device)
        named = list(module.named_parameters())

        def loss_grads(scale):
            b = dict(sb)
            b[keys.POSITIONS] = b[keys.POSITIONS] * scale
            out = fwd(b, True, False)
            f = out[keys.FORCES][:len(zs)]
            loss = H12_WEIGHTS[0] * (out[keys.TOTAL_ENERGY][0] - e_label) ** 2 + \
                H12_WEIGHTS[1] * ((f - f_label) ** 2).sum() / (3.0 * len(zs))
            grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
            return float(loss.detach()), {
                n: (torch.zeros_like(p) if g is None else g).cpu().numpy()
                for (n, p), g in zip(named, grads)}

        with deterministic_sums():
            l_ref, g_ref = loss_grads(1.0)
            _, g_nudged = loss_grads(1.0 + 1e-7)
        gs = recs[0]["grad_step"]
        if any(r["grad_step"]["grads"] != gs["grads"] for r in recs):
            fail("(c) the ranks' mean gradients differ")
        if card_run and {k: v for k, v in gs["launches"].items() if v} != want_step:
            fail(f"(c) the f32 halo step launched {gs['launches']}")
        worst, ratio = "", 0.0
        for n, g in g_ref.items():
            scale = max(float(np.abs(g).max()), 1e-30)
            limit = GRAD_TOL + GRAD_ULP_FACTOR * float(np.abs(g_nudged[n] - g).max()) / scale
            err = float(np.abs(arr[f"grad/{n}"] - g).max()) / scale
            if err / limit > ratio:
                worst, ratio = n, err / limit
            if err > limit:
                fail(f"(c) f32 halo step: gradient of {n} differs by {err:.3e} of its max "
                     f"(limit {limit:.3e})")
        rel = abs(gs["loss"] - l_ref) / abs(l_ref)
        print(f"[halo] (c) f32 make_halo_train_step over {ranks} ranks on a "
              f"{sizes['n_small']}-atom box (launches {gs['launches']}): loss rel diff {rel:.3e} "
              f"(limit 1e-4) against the single-process plain route's; every mean gradient "
              f"within its limit, the closest {worst} at {ratio:.3f} of it")
        if rel > 1e-4:
            fail("(c) the f32 halo step's loss differs from the single-process loss")
        del module, sb

        # XPaiNN-Ewald with a charge
        calc = Calculator(os.path.join(tmp, "h12_ewald.ckpt"), device=device)
        we = [calc.calculate(zs, poss, cell=cells, pbc=pbcs, charge=1) for _ in range(2)]
        ew = recs[0]["ewald"]
        s_max, s_q = md_force_err(we[1][keys.FORCES], we[0][keys.FORCES])
        md_compare(f"(c) XPaiNN-Ewald (K = 171) with charge 1, halo over {ranks} ranks "
                   f"(launches {ew['launches']}) vs the single-process plain Calculator",
                   {keys.TOTAL_ENERGY: ew["energy"], keys.FORCES: arr["ewald_forces"]}, we[0],
                   1e-4, (F32_FORCE_TOL[0] + 2 * s_max, F32_FORCE_TOL[1] + 2 * s_q))
        if card_run and {k: v for k, v in ew["launches"].items() if v} != want:
            fail(f"(c) the Ewald halo call launched {ew['launches']}")

        # (d) edge partition
        ed = recs[0]["edge"]
        if any(r["edge"]["forces"] != ed["forces"] for r in recs):
            fail("(d) the ranks' edge-partition forces differ")
        ei, offs = radius_graph_pbc_np(posb, cell, pbc, 5.0)
        bb = batch_to_device(collate([Datapoint(zb, posb, cell=cell, pbc=pbc, edge_index=ei,
                                                cell_offsets=offs)]), device)
        module, extra, _, _, _ = load_model_from_checkpoint(os.path.join(tmp, "h12_plain.ckpt"))
        fwd = make_forward(module.to(device).requires_grad_(False), extra)
        outs = [fwd(bb, True, True) for _ in range(2)]
        if card_run:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fwd(bb, True, True)
        if card_run:
            torch.cuda.synchronize()
        single_ms = (time.perf_counter() - t0) * 1e3
        res = [{keys.TOTAL_ENERGY: float(o[keys.TOTAL_ENERGY][0]),
                keys.FORCES: o[keys.FORCES][:len(zb)].cpu().numpy(),
                keys.VIRIAL: o[keys.VIRIAL][0].cpu().numpy()} for o in outs]
        s_max, s_q = md_force_err(res[1][keys.FORCES], res[0][keys.FORCES])
        v_spread = float(np.abs(res[1][keys.VIRIAL] - res[0][keys.VIRIAL]).max()
                         / np.abs(res[0][keys.VIRIAL]).max())
        md_compare(f"(d) edge partition over {ranks} ranks, plain f32 route, vs the single "
                   f"process", {keys.TOTAL_ENERGY: ed["energy"],
                                keys.FORCES: arr["edge_forces"], keys.VIRIAL: arr["edge_virial"]},
                   res[0], 1e-4, (F32_FORCE_TOL[0] + 2 * s_max, F32_FORCE_TOL[1] + 2 * s_q),
                   MD_F32_VIRIAL_ELEM_TOL + 2 * v_spread, v_elem=True)
        print(f"[halo] (d) edge partition forward+forces+virial {ed['ms']:.2f} ms per rank "
              f"(host clock), the single process {single_ms:.2f} ms — {card}")
        del module, bb, outs

        # (e) NCCL with one card per rank
        _h12_nccl(tmp, device, card, sizes, ref, ref_ms)
    print(f"[phase 12] in {time.perf_counter() - t_all:.1f} s")
    return {"halo_call": halo_call or {}, "halo_step": tr["steps"][0]["launches"]}, kern


# ---------------------------------------------------------------------------
# Phase 13: the convergence study's path at a short budget
# ---------------------------------------------------------------------------
# phase 13's sizes on the card and in the CPU rehearsal: the PES check's
# structures, the generated dataset (structures, atoms per structure), the
# study's widths, epochs, f32 epochs and batch, the NVE steps, and the bar
# (card only) on the validation force MAE of the last epoch over the
# first's.  Validation runs on the EMA weights (decay 0.999), which after
# 144 steps still hold 0.999^144 = 0.87 of the seed's: a correct run read
# 0.844 on the card (PERF.md), so the bar is 0.9.  The study's 1
# meV/atom/ps NVE bar holds the integrators and the protocol on the
# synthetic PES itself (a window of fewer than 400 steps reads the
# oscillation, not the drift: none in the rehearsal); the model's forces
# are held to central differences of its energy, plus twice what the
# energy's own call-to-call spread adds: 5e-2 of |F| on the card, where a
# correct 12-epoch model read 3.8e-3 to 7.0e-3 (a sign error reads 2),
# falling only slowly with the step (its PES at |F| of about 50 eV/A;
# 1.4e-3 to 3.1e-3 on the CPU), 1e-2 for the rehearsal's small model.  Its
# own drift is printed: a model of a few epochs has the random weights'
# PES, stiff near the cutoff with no short-range repulsion, and the
# converged study holds the bar on its model (PERF.md)
STUDY_SIZES = dict(n_pes=16, n_data=960, atoms=(8, 32), epochs=12, f32_epochs=2, batch=64,
                   md_steps=400, mae_ratio=0.9, drift_bound=1.0, fd_tol=5e-2, blocks=3,
                   flags=dict(node_dim=128, irreps="128x0e+64x1o+32x2e", num_basis=20))
STUDY_REHEARSAL = dict(n_pes=2, n_data=40, atoms=(8, 12), epochs=3, f32_epochs=1, batch=4,
                       md_steps=40, mae_ratio=None, drift_bound=None, fd_tol=1e-2, blocks=1,
                       flags=dict(node_dim=16, irreps="16x0e+8x1o+4x2e", num_basis=8))


def study_pes(device, card, sizes):
    """(a) The synthetic PES on the device against the CPU on seed-7
    clusters of the extended elements: energy 1e-5 relative, forces 1e-4
    of max |F|."""
    from xequinet_torch.tools import make_synthetic_dataset as gen

    gen.use_extended_elements()
    rng = np.random.default_rng(7)
    on_dev, on_cpu = gen.make_energy_fn(device), gen.make_energy_fn("cpu")
    worst_e = worst_f = 0.0
    lo, hi = sizes["atoms"]
    for _ in range(sizes["n_pes"]):
        z, pos = gen.random_cluster(rng, int(rng.integers(lo, hi + 1)))
        e1, g1 = on_dev(pos, z)
        e2, g2 = on_cpu(pos, z)
        e1, g1, e2, g2 = float(e1), g1.cpu().numpy(), float(e2), g2.numpy()
        if not (np.isfinite(e1) and np.isfinite(g1).all()):
            fail("(a) the PES on the device is not finite")
        worst_e = max(worst_e, abs(e1 - e2) / abs(e2))
        worst_f = max(worst_f, float(np.abs(g1 - g2).max() / np.abs(g2).max()))
    t0 = time.perf_counter()
    for _ in range(20):
        on_dev(pos, z)[1].cpu()
    ms = (time.perf_counter() - t0) / 20 * 1e3
    print(f"[study] (a) PES on {device.type} vs the CPU, {sizes['n_pes']} seed-7 clusters: "
          f"energy {worst_e:.3e} (limit 1e-5), forces {worst_f:.3e} of max |F| (limit 1e-4); "
          f"{ms:.2f} ms per energy and gradient at {len(z)} atoms — {card}")
    if worst_e > 1e-5 or worst_f > 1e-4:
        fail(f"(a) PES device vs CPU: energy {worst_e:.3e}, forces {worst_f:.3e}")


def study_yaml(path, cfg):
    """The study's config as a user writes it: the fields that differ from
    the schema's defaults."""
    import dataclasses

    from xequinet_torch.utils.config import XequiConfig

    base = XequiConfig()
    sections = {}
    for sec in ("model", "data", "trainer"):
        got, want = getattr(cfg, sec), getattr(base, sec)
        sections[sec] = {f.name: getattr(got, f.name) for f in dataclasses.fields(got)
                         if getattr(got, f.name) != getattr(want, f.name)}
    return write_yaml(path, sections)


def study_train(tmp, db, device, card, sizes):
    """(c) ``train -C`` through ``cli.main`` with the study tool's config:
    the launches per step in the bf16 and the f32 epochs and per validation
    batch, the f32 switch (logged, the optimizer on the module's tensors,
    the EMA rebuilt), finite losses and a falling validation force MAE."""
    import os
    import re

    from xequinet_torch import cli
    from xequinet_torch.tools import convergence_study as study

    card_run = device.type == "cuda"
    out = os.path.join(tmp, "study")
    cfg = study.make_config(db, out, sizes["epochs"], compute_dtype="bfloat16",
                            f32_finetune_epochs=sizes["f32_epochs"], mega=True,
                            batch_size=sizes["batch"], device=None if card_run else "cpu",
                            **sizes["flags"])
    cfg.model.model_kwargs["action_blocks"] = sizes["blocks"]
    path = study_yaml(os.path.join(tmp, "study.yaml"), cfg)
    ledger = study.TrainLaunches()
    t0 = time.perf_counter()
    with ledger.active():
        cli.main(["train", "-C", path])
    sync_if(card_run)
    wall = time.perf_counter() - t0
    log = os.path.join(out, cfg.trainer.log_file)
    text = open(log).read()
    counted = ledger.summary()
    per_step, per_valid = counted["launches_per_train_step"], counted["launches_per_valid_batch"]
    print(f"[study] (c) train -C, {counted['epochs_counted']} epochs by dtype, "
          f"{counted['steps_counted']} steps, {counted['valid_batches_counted']} validation "
          f"batches in {wall:.1f} s; launches per step {per_step}, per validation batch "
          f"{per_valid}; f32 switch {counted['f32_switch']} — {card}")
    if counted["epochs_counted"] != {"bfloat16": sizes["epochs"] - sizes["f32_epochs"],
                                     "float32": sizes["f32_epochs"]}:
        fail(f"(c) epochs by dtype {counted['epochs_counted']}")
    if "f32 fine-tune: compute dtypes switched to float32" not in text:
        fail("(c) the f32 switch is not in the trainer log")
    sw = counted["f32_switch"][0] if len(counted["f32_switch"]) == 1 else {}
    if not (sw.get("optimizer_holds_module_params") and sw.get("step_params_are_module_params")
            and sw.get("ema_rebuilt") and sw.get("compute_dtype") == "float32"
            and sw.get("mid_run")):
        fail(f"(c) the f32 switch: {counted['f32_switch']}")
    if card_run:
        want = {"message_fwd": 3.0, "message_bwd": 6.0, "message_bwd2": 3.0}
        for dt, got in per_step.items():
            if got != want:
                fail(f"(c) {dt} epochs: {got} launches per step, expected {want}")
        if per_valid != {"message_fwd": 3.0, "message_bwd": 3.0, "message_bwd2": 0.0}:
            fail(f"(c) {per_valid} launches per validation batch, expected 3 / 3 / 0")
    losses = [float(x) for x in re.findall(r"loss (\S+)", text)]
    if not losses or not np.isfinite(losses).all():
        fail(f"(c) non-finite or missing losses in the log: {losses[:20]}")
    epochs = study.parse_epochs(log)
    curve = study.parse_curve(log)
    step_ms = [e["step_ms"] for e in epochs if e["step_ms"] is not None]
    print("[study] (c) validation force MAE by epoch (EMA weights; from the log): "
          + ", ".join(f"{e}: {m:.4f}" for e, m in curve)
          + f"; median step {np.median(step_ms):.1f} ms, median epoch "
          f"{np.median([e['seconds'] for e in epochs]):.2f} s — {card}")
    if len(curve) != sizes["epochs"]:
        fail(f"(c) {len(curve)} validation rows parsed for {sizes['epochs']} epochs")
    if sizes["mae_ratio"] is not None and curve[-1][1] > sizes["mae_ratio"] * curve[0][1]:
        fail(f"(c) validation force MAE {curve[0][1]:.4f} -> {curve[-1][1]:.4f}, above "
             f"{sizes['mae_ratio']} of the first epoch's")
    launches = {f"study_train_step_{'bf16' if dt == 'bfloat16' else 'f32'}":
                {k: int(v) for k, v in got.items()} for dt, got in per_step.items()}
    launches["study_valid_batch"] = {k: int(v) for k, v in per_valid.items()}
    return cfg, os.path.join(out, f"{cfg.trainer.run_name}_last.ckpt"), launches


def phase_study(device, card, sizes):
    """Phase 13: the convergence study's path (xequinet_torch/tools) at a
    short budget: (a) the PES on the device against the CPU; (b) a dataset
    generated on the device by the generator's ``main``; (c) ``train -C``
    at the study's widths on the mega route with the f32 switch; (d)
    ``run_test`` on the last checkpoint, EMA; (e) the NVE protocol on the
    synthetic PES, the checkpoint's forces against differences of its
    energy, and ``nve_drift`` on it.  Returns the message-kernel launches per unit of each path."""
    import os
    import tempfile

    from xequinet_torch.ops import cuda_build
    from xequinet_torch.run.test import run_test
    from xequinet_torch.tools import convergence_study as study
    from xequinet_torch.tools import make_synthetic_dataset as gen

    card_run = device.type == "cuda"
    dev_args = [] if card_run else ["--device", "cpu"]
    t_all = time.perf_counter()
    # the extended elements rebind the generator's module globals: put the
    # H, C, N, O set back for later phases
    hcno = (gen.ELEMENTS, gen.ELEMENT_P)
    study_pes(device, card, sizes)
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        db = os.path.join(tmp, "synth")
        t0 = time.perf_counter()
        gen.main([db, "--n", str(sizes["n_data"]), "--atoms", *map(str, sizes["atoms"]),
                  "--elements", "extended", "--seed", "7"] + dev_args)
        print(f"[study] (b) {sizes['n_data']} structures generated on {device.type} in "
              f"{time.perf_counter() - t0:.1f} s, dataset sha256 "
              f"{study.dataset_checksum(db)[:16]} — {card}")

        cfg, ckpt, launches = study_train(tmp, db, device, card, sizes)

        cuda_build.reset_launch_counts()
        t0 = time.perf_counter()
        metrics = run_test(cfg, ckpt_file=ckpt, use_ema=True,
                           device=None if card_run else "cpu")
        sync_if(card_run)
        flat = [v for r in metrics.values() for v in (r["mae"], r["rmse"])]
        print(f"[study] (d) run_test on the last checkpoint, EMA, in "
              f"{time.perf_counter() - t0:.2f} s: "
              + ", ".join(f"{p} MAE {r['mae']:.4f} RMSE {r['rmse']:.4f} ({r['count']})"
                          for p, r in sorted(metrics.items()))
              + f"; launches {dict(cuda_build.LAUNCHES)} — {card}")
        if not metrics or not np.isfinite(flat).all():
            fail(f"(d) run_test metrics {metrics}")

        dev_arg = None if card_run else "cpu"
        t0 = time.perf_counter()
        pes = study.pes_nve_drift(sizes["md_steps"], 0.5, 300.0, np.random.default_rng(7),
                                  device=dev_arg)
        bound = sizes["drift_bound"]
        print(f"[study] (e) NVE on the synthetic PES on {device.type}, {pes['n_atoms']} atoms, "
              f"{pes['steps']} steps of {pes['timestep_fs']} fs after FIRE and 600 Langevin "
              f"steps, in {time.perf_counter() - t0:.1f} s: drift "
              f"{pes['drift_meV_per_atom_per_ps']:.4f} meV/atom/ps (limit "
              f"{bound if bound is not None else 'none at this length'}), max |dE| "
              f"{pes['max_abs_dev_meV_per_atom']:.4f} meV/atom, {pes['ms_per_call']:.2f} ms "
              f"per call — {card}")
        if not np.isfinite(pes["drift_meV_per_atom_per_ps"]) or (
                bound is not None and pes["drift_meV_per_atom_per_ps"] > bound):
            fail(f"(e) NVE drift on the synthetic PES {pes}")
        fd = study.force_check(ckpt, np.random.default_rng(7), device=dev_arg)
        fd_limit = sizes["fd_tol"] + 2 * fd["spread_rel"]
        print(f"[study] (e) the checkpoint's forces against central differences of its "
              f"energy (h {fd['h_A']} A, route {fd['route']}): {fd['rel_err_along_F']:.2e} "
              f"along F, {fd['rel_err_random']:.2e} along a random direction, of |F| "
              f"{fd['force_norm']:.3f}; the energy's spread over 3 calls "
              f"{fd['energy_spread']:.3e} ({fd['spread_rel']:.2e} of h |F|); limit "
              f"{sizes['fd_tol']} + 2 x that = {fd_limit:.2e} — {card}")
        if not max(fd["rel_err_along_F"], fd["rel_err_random"]) <= fd_limit:
            fail(f"(e) forces against differences of the energy: {fd}")
        t0 = time.perf_counter()
        drift = study.nve_drift(ckpt, tmp, sizes["md_steps"], 0.5, 300.0,
                                np.random.default_rng(7), device=dev_arg)
        print(f"[study] (e) nve_drift on the checkpoint, {drift['n_atoms']} atoms, "
              f"{drift['steps']} NVE steps of {drift['timestep_fs']} fs after FIRE and 600 "
              f"Langevin steps, in {time.perf_counter() - t0:.1f} s: drift "
              f"{drift['drift_meV_per_atom_per_ps']:.4f} meV/atom/ps (printed: a model of a "
              f"few epochs), max |dE| {drift['max_abs_dev_meV_per_atom']:.4f} meV/atom; route "
              f"{drift['route']}, launches per force call {drift['launches_per_call']}, "
              f"{drift['ms_per_call']:.2f} ms per call — {card}")
        if not np.isfinite([drift["drift_meV_per_atom_per_ps"],
                            drift["max_abs_dev_meV_per_atom"]]).all():
            fail(f"(e) NVE drift {drift}")
        # a 24-atom cluster takes the plain route by the Calculator's size
        # rules (as the JAX Calculator's), with no kernel launch
        if drift["route"] != "plain" or any(drift["launches_per_call"].values()):
            fail(f"(e) route {drift['route']}, launches {drift['launches_per_call']}")
        launches["study_nve_call"] = {k: int(round(v))
                                      for k, v in drift["launches_per_call"].items()}
    gen.ELEMENTS, gen.ELEMENT_P = hcno
    print(f"[phase 13] in {time.perf_counter() - t_all:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 14: the backward's stream-floor probe
# ---------------------------------------------------------------------------
# the probe's layout at bench.py's batch, default_rng(0): the JAX tool's
# tools/bwd_stream_floor.json
FLOOR_LAYOUT = (48, 10, 189952)


def phase_floor(device, card):
    """Phase 14: the stream-floor probe (xequinet_torch/tools/
    bwd_stream_floor.py) on its flagship batch: its layout against the JAX
    tool's; one call of the floor kernel (one launch) held bit for bit
    against its plain version; the floor, message_bwd on the same operands
    and their passes timed, beside the bounds and the reading.  Returns the
    floor's row fields (``floor_on_paths`` checks its launches on the model
    paths)."""
    from xequinet_torch.ops import cuda_build
    from xequinet_torch.tools import bwd_stream_floor as bsf

    t0 = time.perf_counter()
    p = bsf.problem(device)
    print(f"[floor] layout {p['layout']} (n_blocks, max_chunks, n_slots; the JAX tool's "
          f"{FLOOR_LAYOUT}), {p['n_valid']} valid slots, {p['n_atoms']} atoms")
    if p["layout"] != FLOOR_LAYOUT:
        fail(f"the probe's layout {p['layout']} is not the JAX tool's {FLOOR_LAYOUT}")
    cuda_build.reset_launch_counts()
    got = bsf.floor_call(p)
    torch.cuda.synchronize()
    counts = expect_launches("stream-floor probe, one call", bwd_stream_floor=1)
    try:
        err = bsf.check_exact(got, bsf.plain_floor(p))
    except RuntimeError as e:
        fail(str(e))
    print(f"[floor] kernel against its plain version: the same bits (max |err| {err:g})")
    del got
    try:
        res = bsf.measure(p, phases=("hopper",))
    except RuntimeError as e:
        fail(str(e))
    for line in bsf.report(res, card):
        print(f"[floor] {line}")
    print(f"[phase 14] in {time.perf_counter() - t0:.1f} s")
    return {"launches": counts["bwd_stream_floor"], "max_abs_err": err, "ms": res["floor_ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["floor_bound_ms"], "bound_by": "bytes",
            "library_ms": None,
            "library": "none: no single PyTorch call stages message_bwd's streams",
            "split_ms": res["floor_split_ms"], "split_share": res["floor_split_share"],
            "moved_bytes": res["floor_moved_bytes"],
            "moved_ms": res["floor_moved_ms"], "message_bwd_ms": res["message_bwd_ms"],
            "message_bwd_split_ms": res["message_bwd_split_ms"],
            "message_bwd_bound_ms": res["message_bwd_bound_ms"], "ideal_ms": res["ideal_ms"],
            "reading": res["reading"], "message_bwd_phases": res["phases"]}


def floor_on_paths(rows):
    """Phase 14, continued: the floor kernel's launches on every model path
    its row counted (predict, train step, phases 7-13's paths), all 0."""
    row = next(r for r in rows if r["name"] == "bwd_stream_floor")
    on_paths = {k: v for k, v in row.items() if k.startswith("launches_")}
    print(f"[floor] launches on the model paths: {sum(on_paths.values())} over "
          f"{len(on_paths)} paths")
    if any(on_paths.values()):
        fail(f"bwd_stream_floor launched on a model path: {on_paths}")


# ---------------------------------------------------------------------------
# Phase 15: rematerialization (remat, remat_policy)
# ---------------------------------------------------------------------------
# remat off, then the two policies (models/remat.py)
REMAT_POLICIES = (None, "full", "save_edge_agg")
# the JAX program's pallas_calls with remat at three blocks, as
# tests/test_torch_remat.py reads them from its jaxprs: per forces-only call
# and per train step
REMAT_MEGA = ({"message_fwd": 3, "message_bwd": 3},
              {"message_fwd": 3, "message_bwd": 8, "message_bwd2": 3})
REMAT_V2 = ({"gather_scatter_v2": 3}, {"gather_scatter_v2": 3})
# phase 15's sizes on the card and in the CPU rehearsal: the memory cells
# (molecules of bench.py's build_batch at rng 1234), the Ewald crystals
# (phase 8's batch), run_train's molecules and phase 7's box
REMAT_SIZES = dict(kw={}, layout=(BN, CHUNK), memory=(1024, 4096), steps=5, n_cells=640,
                   n_train=320, batch=32, crystal_layout=CRYSTAL_LAYOUT,
                   box=dict(n_box=10000, max_box=10240))
REMAT_REHEARSAL = dict(kw=dict(node_dim=16, node_irreps="16x0e+8x1o+4x2e", num_basis=8,
                               pallas_layout=(32, 32, PAD_NODES, MAX_CHUNKS)),
                       layout=(32, 32), memory=(12, 24), steps=2, n_cells=8, n_train=16,
                       batch=4, crystal_layout=(32, 32, PAD_NODES, MAX_CHUNKS),
                       box=dict(n_box=600, max_box=1024))


def remat_over(policy):
    """The model kwargs of one remat setting (None: remat off)."""
    return {} if policy is None else {"remat": True, "remat_policy": policy}


def remat_agreement(tag, b, device, card, over, task=FLAGSHIP_TASK):
    """Phase 15 (a), (b), (e): the force loss's energy, forces (virial) and
    parameter gradients of the model ``over`` with remat "full" and
    "save_edge_agg" against remat off, the same seed-0 weights: under
    deterministic sums bit for bit, the remat call right after a call
    without remat; under the default sums within twice remat off's own
    spread.  (The autograd engine orders ready nodes by sequence numbers
    that each thread counts for itself, and a remat rerun records nodes
    on the card's backward thread: so the parameter pass's sums after it
    can run in another order, the next call's bits then moving by
    rounding, with or without remat.)  Returns {policy: what differs under
    deterministic sums (quantity: max |a - b| / max |a|)}."""
    card_run = device.type == "cuda"
    models = {policy: train_model(device, task, **over, **remat_over(policy))[:2]
              for policy in REMAT_POLICIES}
    with deterministic_sums(False):
        own = [grads_sample(*models[None], b, task) for _ in range(2)]
    norm = lambda d: {("parameter gradients" if k.startswith("parameter gradients") else k): v
                      for k, v in d.items()}
    spread0 = norm(det_spreads(own))
    print(f"[remat] {tag}: remat off, two calls with the default sums: "
          + ", ".join(f"{k} {v:.3e}" for k, v in spread0.items()) + f" — {card}")
    out = {}
    for policy in REMAT_POLICIES[1:]:
        with deterministic_sums(True):
            pair = [grads_sample(*models[p], b, task) for p in (None, policy)]
        moved = {k: v for k, v in det_spreads(pair).items() if v != 0.0}
        with deterministic_sums(False):
            away = norm(det_spreads([own[0], grads_sample(*models[policy], b, task)]))
        over_limit = {k: (v, spread0[k]) for k, v in away.items() if v > 2.0 * spread0[k]}
        print(f"[remat] {tag}, {policy} against remat off: deterministic sums "
              + (f"NOT bit for bit: {moved}" if moved else "bit for bit")
              + "; default sums " + ", ".join(f"{k} {v:.3e}" for k, v in away.items())
              + f" (limit 2x the own spread) — {card}")
        if over_limit:
            fail(f"{tag}, remat {policy}: farther from remat off than twice its own spread: "
                 f"{over_limit}")
        out[policy] = moved
    del models
    if card_run:
        torch.cuda.empty_cache()
    return out


def remat_launches(b, device, card, sizes):
    """Phase 15 (c): the kernels' launches per forces-only call and per
    train step under each policy, mega and v2 routes, against the JAX
    program's pallas_calls (REMAT_MEGA, REMAT_V2)."""
    from xequinet_torch.models.model import resolve_model
    from xequinet_torch.models.properties import make_forward
    from xequinet_torch.ops import cuda_build

    card_run = device.type == "cuda"
    sync = torch.cuda.synchronize if card_run else (lambda: None)
    out = {}
    for route, want in (("mega", REMAT_MEGA), ("v2", REMAT_V2)):
        for policy in REMAT_POLICIES[1:]:
            over = dict(sizes["kw"], **remat_over(policy), **(V2 if route == "v2" else {}))
            module, _, step, ema = train_model(device, **over)
            _, extra, _ = resolve_model("xpainn", **model_kwargs("xpainn", over))
            tag = f"remat {policy}, {route}"
            cuda_build.reset_launch_counts()
            make_forward(module, extra)(b, True, False)
            sync()
            force = path_launches(f"{tag} forces-only call", card_run, **want[0])
            cuda_build.reset_launch_counts()
            step(b, 0, 1.0, ema)
            sync()
            train = path_launches(f"{tag} train step", card_run, **want[1])
            out[f"remat_{policy}_{route}_predict"] = force
            out[f"remat_{policy}_{route}_train_step"] = train
            del module, step, ema
    return out


def remat_memory(dps, device, card, sizes):
    """Phase 15 (d): one bf16 mega train step's peak device memory and its
    rise above the memory held before, and the step's ms (host clock,
    median of ``steps`` steps each ending in a synchronize; CUDA events over
    ``steps`` steps), for each remat setting, at each batch of
    ``sizes["memory"]`` molecules."""
    from xequinet_torch import keys
    from xequinet_torch.data.batching import collate
    from xequinet_torch.run.inference import batch_to_device

    card_run = device.type == "cuda"
    n_steps = sizes["steps"]
    rows = {}
    for n in sizes["memory"]:
        mols = dps if n == len(dps) else build_molecules(n)
        b = batch_to_device(collate(mols, kernel_layout=layout(*sizes["layout"])), device)
        n_real = int(b[keys.EDGE_MASK].sum())
        for policy in REMAT_POLICIES:
            module, _, step, ema = train_model(device, **sizes["kw"], **remat_over(policy))
            step(b, 0, 1.0, ema)  # warm: the optimizer's state and the slot plan's buffers
            if not card_run:
                print(f"[remat] {n} molecules, remat {policy}: one step on the CPU (memory and "
                      f"time not measured)")
                del module, step, ema
                continue
            torch.cuda.synchronize()
            host = []
            for i in range(n_steps):
                t0 = time.perf_counter()
                step(b, 1 + i, 1.0, ema)
                torch.cuda.synchronize()
                host.append((time.perf_counter() - t0) * 1e3)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for i in range(n_steps):
                step(b, 1 + n_steps + i, 1.0, ema)
            end.record()
            torch.cuda.synchronize()
            events = start.elapsed_time(end) / n_steps
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            step(b, 1 + 2 * n_steps, 1.0, ema)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            rows[(n, policy)] = dict(peak=peak, rise=peak - held, held=held,
                                     host_ms=float(np.median(host)), events_ms=events)
            print(f"[remat] bf16 mega train step, {n} molecules ({n_real} edges), remat "
                  f"{policy}: peak device memory {peak / 2**30:.3f} GiB, "
                  f"{(peak - held) / 2**30:.3f} GiB above the {held / 2**30:.3f} GiB held; "
                  f"{float(np.median(host)):.3f} ms "
                  f"(host clock, median of {n_steps}; min {min(host):.3f}), {events:.3f} ms (CUDA "
                  f"events over {n_steps}) — {card}")
            del module, step, ema
            torch.cuda.empty_cache()
        del b
        if card_run:
            off = rows[(n, None)]
            print(f"[remat] {n} molecules: the step's rise above the memory held, full / off "
                  f"{rows[(n, 'full')]['rise'] / off['rise']:.3f}, save_edge_agg / off "
                  f"{rows[(n, 'save_edge_agg')]['rise'] / off['rise']:.3f}; step ms full / off "
                  f"{rows[(n, 'full')]['events_ms'] / off['events_ms']:.3f} (CUDA events) — "
                  f"{card}")
            if rows[(n, "full")]["peak"] >= off["peak"]:
                print(f"[remat] {n} molecules: remat full does NOT lower the step's peak "
                      f"({rows[(n, 'full')]['peak'] / 2**30:.3f} against "
                      f"{off['peak'] / 2**30:.3f} GiB)")
    return rows


def remat_ewald(device, card, sizes):
    """Phase 15 (e): phase 8's periodic XPaiNN-Ewald (EWALD_PBC) on its
    crystal batch, one force-loss step with the virial under remat "full"
    and "save_edge_agg" against remat off (energy, forces, virial and
    gradients, bit for bit under deterministic sums), then one bf16 train
    step's peak per setting."""
    from xequinet_torch.data.batching import collate
    from xequinet_torch.ops import cuda_build
    from xequinet_torch.run.inference import batch_to_device

    card_run = device.type == "cuda"
    dps = build_crystals(sizes["n_cells"])
    lay = dict(zip(("block_nodes", "chunk", "pad_nodes", "max_chunks"), sizes["crystal_layout"]))
    b = batch_to_device(collate(dps, kernel_layout=lay), device)
    over = {**EWALD_PBC, **sizes["kw"], "pallas_layout": sizes["crystal_layout"]}
    moved = remat_agreement(f"(e) pbc ewald, {len(dps)} cells, bf16", b, device, card, over,
                            EWALD_TASK)
    out = {}
    for policy in REMAT_POLICIES:
        _, _, step, ema = train_model(device, EWALD_TASK, **over, **remat_over(policy))
        step(b, 0, 1.0, ema)
        if card_run:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
        cuda_build.reset_launch_counts()
        step(b, 1, 1.0, ema)
        if card_run:
            torch.cuda.synchronize()
        want = REMAT_MEGA[1] if policy else dict(message_fwd=3, message_bwd=6, message_bwd2=3)
        counts = path_launches(f"(e) pbc ewald train step, remat {policy}", card_run, **want)
        if policy:
            out[f"remat_{policy}_ewald_train_step"] = counts
        if card_run:
            peak = torch.cuda.max_memory_allocated()
            print(f"[remat] (e) pbc ewald bf16 train step, remat {policy}: peak device memory "
                  f"{peak / 2**30:.3f} GiB, {(peak - held) / 2**30:.3f} GiB above the "
                  f"{held / 2**30:.3f} GiB held — {card}")
        del step, ema
        if card_run:
            torch.cuda.empty_cache()
    return out, moved


def remat_entry_points(device, card, sizes):
    """Phase 15 (f): run_train with ``remat: true`` for one epoch on bench
    molecules (3 + 8 + 3 launches per step, 3 + 3 per validation batch),
    resumed for a second epoch from its checkpoint (the same per step);
    then the checkpoint through InferenceEngine.predict (3 + 3) and one
    Calculator.calculate on phase 7's box on the mega route (3 + 3)."""
    import os
    import tempfile

    from xequinet_torch import keys
    from xequinet_torch.convert import load_checkpoint
    from xequinet_torch.data.store import create_dataset
    from xequinet_torch.interface.calculator import Calculator
    from xequinet_torch.ops import cuda_build
    from xequinet_torch.ops.radius_graph import radius_graph_pbc_np
    from xequinet_torch.run.inference import InferenceEngine
    from xequinet_torch.run.train import run_train
    from xequinet_torch.utils.config import load_config

    card_run = device.type == "cuda"
    sync = torch.cuda.synchronize if card_run else (lambda: None)
    out = {}
    dps = build_molecules(sizes["n_train"], seed=99)
    kw = {**FLAGSHIP_KW, "pallas_layout": (BN, CHUNK, PAD_NODES, MAX_CHUNKS), **sizes["kw"],
          "remat": True}
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        create_dataset(os.path.join(tmp, "db"), dps, units={})
        save = os.path.join(tmp, "out")
        last = os.path.join(save, "xequinet_last.ckpt")
        trainer = {"max_epochs": 1, "warmup_epochs": 1, "lossfn": "l2",
                   "losses_weight": TRAIN_WEIGHTS, "ema_decay": 0.999, "grad_clip": 5.0,
                   "save_dir": save, "log_steps": 4, "seed": 0}
        if not card_run:
            trainer["device"] = "cpu"
        steps0 = 0
        for tag, extra in (("one epoch", {}),
                           ("resumed for a second epoch", {"max_epochs": 2, "resume": True,
                                                           "ckpt_file": last})):
            over = {"model": {"model_kwargs": kw},
                    "data": {"db_path": os.path.join(tmp, "db"), "targets": ["energy", "forces"],
                             "batch_size": sizes["batch"], "valid_batch_size": sizes["batch"]},
                    "trainer": dict(trainer, **extra)}
            cuda_build.reset_launch_counts()
            with CountedValidation() as cv:
                t0 = time.perf_counter()
                run_train(load_config(overrides=over))
                sync()
                wall = time.perf_counter() - t0
            steps = load_checkpoint(last)["step"] - steps0
            valid = cv.batches
            if steps == 0 or valid == 0:
                fail(f"(f) run_train with remat, {tag}: {steps} steps, {valid} validation batches")
            want = {k: REMAT_MEGA[1][k] * steps + REMAT_MEGA[0].get(k, 0) * valid
                    for k in REMAT_MEGA[1]}
            counts = path_launches(f"(f) run_train with remat, {tag}", card_run, **want)
            print(f"[remat] (f) run_train with remat, {tag}: {steps} steps and {valid} "
                  f"validation batches in {wall:.1f} s — {card}")
            per_step, _ = cv.split(f"(f) run_train with remat, {tag}", counts, steps, card_run,
                                   REMAT_MEGA[1], REMAT_MEGA[0])
            out["remat_full_run_train_step"] = per_step if card_run else counts
            steps0 += steps
        eng = InferenceEngine(last, device=device)
        if not all(getattr(blk, "remat_policy", None) == "full" for blk in eng.module.blocks
                   if type(blk).__name__ in ("XPainnMessage", "XPainnUpdate")):
            fail("(f) the remat checkpoint's model is not remat'd")
        cuda_build.reset_launch_counts()
        res = eng.predict(dps[:64])
        sync()
        out["remat_full_ckpt_predict"] = path_launches("(f) the remat checkpoint's predict",
                                                       card_run, **REMAT_MEGA[0])
        f = np.concatenate([r[keys.FORCES] for r in res])
        z, pos, cell, pbc, _ = md_box(sizes["box"]["n_box"])
        ei, _ = radius_graph_pbc_np(pos, cell, pbc, 5.0)
        calc = Calculator(last, pallas="mega", device=device, max_atoms=sizes["box"]["max_box"],
                          max_edges=md_edge_cap(ei.shape[1]))
        cuda_build.reset_launch_counts()
        r = calc.calculate(z, pos, cell=cell, pbc=pbc)
        sync()
        out["remat_full_md_call"] = path_launches("(f) the remat checkpoint's Calculator call",
                                                  card_run, **REMAT_MEGA[0])
        if calc.last_route != "mega" or not (np.isfinite(f).all() and
                                             np.isfinite(r[keys.FORCES]).all()):
            fail(f"(f): route {calc.last_route}, or non-finite forces")
        print(f"[remat] (f) the remat checkpoint served: predict on {len(res)} molecules mean|F| "
              f"{np.abs(f).mean():.6f}; Calculator on phase 7's box ({len(z)} atoms, route "
              f"{calc.last_route}) energy {float(r[keys.TOTAL_ENERGY]):.6f}")
    return out


def phase_remat(dps, b, device, card, sizes):
    """Phase 15: remat on the card.  (a) f32 and (b) bf16 flagship force-loss
    steps with remat against remat off; (c) launches; (d) memory and time
    at two batch sizes; (e) the Ewald crystals; (f) a remat checkpoint
    through run_train (and its resume), predict and the Calculator.
    Returns the kernels' launches per path."""
    t0 = time.perf_counter()
    out = {}
    moved = {}
    for tag, over in (("(a) f32", F32), ("(b) bf16", {})):
        moved[tag] = remat_agreement(f"{tag} flagship, {len(dps)} molecules", b, device, card,
                                     dict(over, **sizes["kw"]))
    if any(moved["(b) bf16"].values()):
        print(f"[remat] (b) bf16 remat differs from remat off under deterministic sums "
              f"(within the default sums' spread): {moved['(b) bf16']}")
    out.update(remat_launches(b, device, card, sizes))
    remat_memory(dps, device, card, sizes)
    ewald, moved["(e) ewald"] = remat_ewald(device, card, sizes)
    out.update(ewald)
    out.update(remat_entry_points(device, card, sizes))
    print(f"[phase 15] in {time.perf_counter() - t0:.1f} s")
    # f32 and the Ewald step must repeat remat off bit for bit (the rest of
    # the phase first, so that one run shows every reading)
    for tag in ("(a) f32", "(e) ewald"):
        if any(moved[tag].values()):
            fail(f"{tag}: remat is not bit for bit under deterministic sums: {moved[tag]}")
    return out


# ---------------------------------------------------------------------------
# Phase 16: the last user-facing pieces (embedding tables, the LMDB
# converter, the bf16 accuracy study)
# ---------------------------------------------------------------------------
P16_SIZES = dict(kw={}, layout=(BN, CHUNK, PAD_NODES, MAX_CHUNKS), n_records=320, batch=32,
                 valid_batch=8, n_study=300, study_epochs=2, tiny=False)
P16_REHEARSAL = dict(kw=dict(node_dim=16, node_irreps="16x0e+8x1o+4x2e", num_basis=8,
                             action_blocks=1),
                     layout=(32, 32, PAD_NODES, MAX_CHUNKS), n_records=264, batch=32,
                     valid_batch=8, n_study=48, study_epochs=2, tiny=True)
# the custom table: seeded 8-wide vectors under these names
P16_EMBED, P16_AUX = "smoke16", "rand8"


def p16_custom_embedding(dps, device, card, tmp, sizes):
    """(a) A torch-saved dict of seeded 8-wide vectors for every element,
    converted by ``convert_torch_table`` into a temporary ``PRE_FOLDER``;
    XPaiNN at FLAGSHIP_KW's widths with that table as its embedding, mega
    route, serves phase 3's molecules (exactly 3 + 3 launches per predict
    with forces) within the bf16 band of the plain route."""
    import os
    from pathlib import Path

    from xequinet_torch import keys
    from xequinet_torch.models.basic import AtomEmbedding
    from xequinet_torch.ops import cuda_build
    from xequinet_torch.utils import qc

    card_run = device.type == "cuda"
    rng = np.random.default_rng(16)
    pt = os.path.join(tmp, "embedding.pt")
    torch.save({e: torch.tensor(rng.normal(size=8).astype(np.float32))
                for e in qc.ELEMENTS_LIST[1:]}, pt)
    shipped = qc.PRE_FOLDER
    qc.PRE_FOLDER = Path(tmp) / "pre_computed"
    try:
        npz = qc.convert_torch_table(pt, P16_EMBED, P16_AUX)
        table = np.load(npz)["table"]
        over = dict(sizes["kw"], embed_basis=P16_EMBED, aux_basis=P16_AUX,
                    pallas_layout=sizes["layout"])
        eng = make_engine(device, **over)
        plain = make_engine(device, **dict(over, use_pallas_scatter=False))
    finally:
        qc.PRE_FOLDER = shipped
        qc.get_embedding_table.cache_clear()
    fixed = next(m for m in eng.module.modules() if isinstance(m, AtomEmbedding)).fixed
    if table.shape != (len(qc.ELEMENTS_LIST), 8) or table[0].any() or not np.array_equal(
            fixed.cpu().numpy(), table.astype(np.float32)):
        fail(f"(a) the converted table {table.shape} is not the model's embedding")
    plain.module.load_state_dict(eng.module.state_dict())
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    res = eng.predict(dps, compute_forces=True)
    sync_if(card_run)
    wall = time.perf_counter() - t0
    counts = path_launches("(a) custom-embedding predict with forces", card_run,
                           message_fwd=3, message_bwd=3)
    f = np.concatenate([r[keys.FORCES] for r in res])
    if len(res) != len(dps) or not np.isfinite(f).all():
        fail("(a) predict with the converted table: wrong count or non-finite forces")
    n_g, n_at = len(dps), sum(d.num_atoms for d in dps)
    compare_outputs(f"(a) bf16 mega vs plain route, {P16_EMBED}_{P16_AUX} embedding",
                    eng.forward_batch(eng.collate(dps)), plain.forward_batch(plain.collate(dps)),
                    n_g, n_at, TOL["bfloat16"])
    print(f"[p16] (a) {npz.name} ({table.shape[0]} x {table.shape[1]}) converted by "
          f"convert_torch_table; predict with forces of {n_g} molecules in {wall:.2f} s on the "
          f"mega route, launches {counts} — {card}")
    return {"custom_embed_predict": counts}


def p16_converted_dataset(device, card, tmp, sizes):
    """(b) A reference-format ``data.lmdb`` of fake-PyG records (bench
    molecules, more than 256, so that byte order of the keys is not index
    order), converted by ``tools/convert_lmdb_dataset.py``: the record
    count, record i at index i at a few indices, each split record for
    record against the in-place dataset of the LMDB; then ``train -C``
    on it for one epoch on the mega route."""
    import os
    import re

    from xequinet_torch.data import lmdb_pure
    from xequinet_torch.data.lmdb_reader import pyg_dumps
    from xequinet_torch.data.store import XDBDataset
    from xequinet_torch.tools import convert_lmdb_dataset

    card_run = device.type == "cuda"
    n = sizes["n_records"]
    mols = build_molecules(n, seed=160)
    payloads = [{"atomic_numbers": torch.tensor(d.atomic_numbers, dtype=torch.int64),
                 "pos": torch.tensor(d.pos, dtype=torch.float32),
                 "energy": torch.tensor([d.energy], dtype=torch.float64),
                 "forces": torch.tensor(d.forces, dtype=torch.float32)} for d in mols]
    src, dst = os.path.join(tmp, "ref"), os.path.join(tmp, "xdb")
    os.makedirs(src)
    t0 = time.perf_counter()
    lmdb_pure.write_lmdb(os.path.join(src, "data.lmdb"),
                         {i.to_bytes(8, "little"): pyg_dumps(p) for i, p in enumerate(payloads)})
    idx = np.random.default_rng(n).permutation(n).tolist()
    k = n // 10
    split = {"train": idx[2 * k:], "valid": idx[:k], "test": idx[k:2 * k]}
    with open(os.path.join(src, "split.json"), "w") as fh:
        json.dump(split, fh)
    with open(os.path.join(src, "info.json"), "w") as fh:
        json.dump({"units": {"energy": "eV", "pos": "Angstrom"}}, fh)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    convert_lmdb_dataset.main([src, dst])
    conv_s = time.perf_counter() - t0
    xdb = XDBDataset(dst, split="train").reader
    if len(xdb) != n:
        fail(f"(b) {len(xdb)} records converted of {n}")
    for i in (0, 1, 255, 256, n - 1):  # key 256 sorts right after key 0 as bytes
        r, d = xdb[i], mols[i]
        if not (np.array_equal(r.atomic_numbers, d.atomic_numbers)
                and np.array_equal(r.pos, d.pos.astype(np.float32))
                and np.array_equal(r.forces, d.forces.astype(np.float32))
                and r.energy == d.energy):
            fail(f"(b) converted record {i} is not source record {i}")
    xdb.close()
    for name, want in split.items():
        got, ref = XDBDataset(dst, split=name), XDBDataset(src, split=name)
        if len(got) != len(ref) or len(got) != len(want):
            fail(f"(b) split {name}: {len(got)} converted, {len(ref)} in place")
        for i in range(len(got)):
            a, b = got[i], ref[i]
            if not all(np.array_equal(getattr(a, f), getattr(b, f))
                       for f in ("atomic_numbers", "pos", "forces", "energy")):
                fail(f"(b) split {name}, item {i}: the XDB differs from the in-place LMDB")
        got.reader.close()
        ref.reader.close()
    print(f"[p16] (b) {n} fake-PyG records written as data.lmdb in {write_s:.2f} s, converted "
          f"in {conv_s:.2f} s (no lmdb package: the pure page walker); {n} records, record i "
          f"at index i spot-checked, each split equal to the in-place dataset")

    kw = model_kwargs("xpainn", dict(sizes["kw"], pallas_layout=sizes["layout"]))
    save = os.path.join(tmp, "out")
    trainer = {"max_epochs": 1, "warmup_epochs": 1, "lossfn": "l2",
               "losses_weight": TRAIN_WEIGHTS, "ema_decay": 0.999, "grad_clip": 5.0,
               "save_dir": save, "log_steps": 2, "seed": 0}
    if not card_run:
        trainer["device"] = "cpu"
    cfg = write_yaml(os.path.join(tmp, "train16.yaml"), {
        "model": {"model_name": "xpainn", "model_kwargs": kw},
        "data": {"db_path": dst, "targets": ["energy", "forces"],
                 "batch_size": sizes["batch"], "valid_batch_size": sizes["valid_batch"]},
        "trainer": trainer})
    steps, valid, counts, per_step, per_valid, wall = train_counted(
        "(b) train on the converted data", cfg, os.path.join(save, "xequinet_last.ckpt"),
        card_run)
    losses = [float(x) for x in re.findall(r"loss (\S+)", open(os.path.join(
        save, "loss.log")).read())]
    if not losses or not np.isfinite(losses).all():
        fail(f"(b) non-finite or missing losses in the log: {losses[:20]}")
    print(f"[p16] (b) train -C on the converted data: 1 epoch, {steps} steps and {valid} "
          f"validation batches in {wall:.1f} s, losses {losses[0]:.4f} -> {losses[-1]:.4f}, "
          f"launches {counts} — {card}")
    return {"converted_train_step": per_step, "converted_valid_batch": per_valid}


def p16_bf16_study(device, card, tmp, sizes):
    """(c) The bf16 accuracy study's path at a short budget: structures
    generated on the device by the generator's ``main`` at the study's
    usage (8-20 atoms, H C N O, seed 7), then the study tool's ``main``,
    2 epochs each of f32, bf16 and bf16_f32ft at the study's widths: the
    plain route (no launch), finite test metrics, results.json written,
    the f32 switch logged."""
    import os

    from xequinet_torch.ops import cuda_build
    from xequinet_torch.tools import bf16_accuracy_study as bf16
    from xequinet_torch.tools import make_synthetic_dataset as gen

    card_run = device.type == "cuda"
    dev_args = [] if card_run else ["--device", "cpu"]
    db, out = os.path.join(tmp, "synth"), os.path.join(tmp, "bf16_study")
    t0 = time.perf_counter()
    gen.main([db, "--n", str(sizes["n_study"])] + dev_args)
    gen_s = time.perf_counter() - t0
    modes = ("f32", "bf16", "bf16_f32ft")
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    res = bf16.main([db, "--epochs", str(sizes["study_epochs"]), "--modes", ",".join(modes),
                     "--out", out] + dev_args + (["--tiny"] if sizes["tiny"] else []))
    wall = time.perf_counter() - t0
    counts = path_launches("(c) the bf16 study, plain route", card_run)
    written = json.loads(open(os.path.join(out, "results.json")).read())
    for mode in modes:
        m = written.get(mode, {})
        flat = [v for p in ("energy", "forces") for v in (m.get(p, {}).get("mae"),
                                                             m.get(p, {}).get("rmse"))]
        if None in flat or not np.isfinite(flat).all() or any(written["kernel_launches"][mode]
                                                                  .values()):
            fail(f"(c) {mode}: test metrics {m}, launches {written['kernel_launches'][mode]}")
    log = open(os.path.join(out, "bf16_f32ft", "loss.log")).read()
    if "f32 fine-tune: compute dtypes switched to float32" not in log:
        fail("(c) bf16_f32ft: the f32 switch is not in the trainer log")
    print(f"[p16] (c) {sizes['n_study']} structures generated on {device.type} in {gen_s:.1f} "
          f"s; the study, {sizes['study_epochs']} epochs per mode, in {wall:.1f} s: "
          + "; ".join(f"{md} force MAE {res[md]['forces']['mae']:.4f} energy MAE "
                      f"{res[md]['energy']['mae']:.4f}, {res['wall_s'][md]:.1f} s, mean step "
                      f"{res['step_ms_mean'][md]:.1f} ms" for md in modes)
          + f"; launches {counts} — {card}")
    return {"bf16_study_run": counts}


def phase_tools16(dps, device, card, sizes):
    """Phase 16: (a) a custom embedding table through ``convert_torch_table``
    served on the mega route; (b) a reference LMDB dataset converted by the
    port's tool and trained on; (c) the bf16 accuracy study's path.
    Returns the message-kernel launches per unit of each path."""
    import os
    import tempfile

    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        out.update(p16_custom_embedding(dps, device, card, tmp, sizes))
        out.update(p16_converted_dataset(device, card, tmp, sizes))
        out.update(p16_bf16_study(device, card, tmp, sizes))
    print(f"[phase 16] in {time.perf_counter() - t0:.1f} s")
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", metavar="DIR",
                    help="also trace forward+forces and a train step with "
                         "torch.profiler and write the per-kernel tables to "
                         "DIR/profile_<tag>.txt")
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run phases 3-5 and 7-16 at a tiny size on the CPU with the "
                         "plain versions (never reports ok)")
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
    # the Hopper tile passes' dynamic shared memory at the flagship widths
    # (ptxas reports static shared memory only)
    fw = (FLAGSHIP_KW["node_irreps"], FLAGSHIP_KW["num_basis"], FLAGSHIP_KW["node_dim"])
    ni, _, _, d, _, _, kw, kf = fm._launch_dims(*fw)
    _, n_pt, na = fm.fwd_table(*fw)
    for name, (smem, nst, stage) in (
            ("message_fwd", fm._fwd_hopper_layout(ni, fw[2], d, kw, kf, n_pt, na)),
            ("message_bwd", fm._hopper_layout(ni, fw[2], d, kw, kf)),
            ("message_bwd2", fm._hopper2_layout(ni, fw[2], d, kw, kf, fm.pair_table(*fw)[1]))):
        print(f"[build] {name}'s Hopper tile pass at the flagship widths: {smem} bytes of "
              f"dynamic shared memory, {nst} stages of {stage}")

    # phase 3: kernels against their plain versions
    t0 = time.perf_counter()
    dps = build_molecules(1024)
    batch = collate(dps, kernel_layout=layout())
    n_real = int(batch[keys.EDGE_MASK].sum())
    print(f"[batch] {sum(d.num_atoms for d in dps)} atoms, {n_real} edges, "
          f"{batch[keys.EDGE_MASK].shape[0]} slots, {batch[keys.POSITIONS].shape[0]} "
          f"node rows ({time.perf_counter() - t0:.1f} s on the host)")
    p, abs_err = phase_kernels(batch, device)
    wide = phase_wide_kernels(batch, device)
    pv2, pv1, scatter_err = phase_scatter_kernels(batch, device)
    v1_launches = phase_v1_op(pv1)

    # phase 4: inference, the mega route and the v2 route
    eng, launches, refs = phase_slice(dps, device)
    eng_v2, launches_v2 = phase_v2_slice(dps, device, refs)
    phase_big_molecule(device, refs["state"])
    del refs
    eng_w, wide_b = phase_wide_slice(dps, device)

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
    _, step_w, ema_w = phase_training(
        "wide mega", WIDE, 10, dict(message_fwd=3, message_bwd=6, message_bwd2=3), b, None,
        device, card)
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
        print(f"[time] {name} ({mm}), {kernel_route(name, mm, p['statics'])}: kernel "
              f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.2f} GFLOP), launches per predict {launches[name]}, per train "
              f"step {per_step[name]} — {card}")
        # "launches" is the mega route's train step; the two paths' counts
        # stand beside it, each read just after its own reset
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                     "pass": kernel_route(name, mm, p["statics"]),
                     "launches": per_step[name], "launches_predict": launches[name],
                     "launches_train_step": per_step[name], "max_abs_err": abs_err[name],
                     "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None})
        if name in fm.PASSES:
            rows[-1]["split_ms"], rows[-1]["scratch_bytes"] = pass_split(
                name, lambda: kfn(p_mm, mm), p_mm, mm, card)
    # message_fwd's Hopper tile pass at the flagship widths: its route, the
    # same bits on a second call, its bf16 error beside the mma.sync pass's
    # on the same operands (the phase probe's instance of that pass)
    if rows[0]["pass"] != "Hopper tile pass":
        fail(f"message_fwd takes the {rows[0]['pass']} at the flagship widths, not its Hopper "
             f"tile pass")
    agg = kernel_fwd(p_mm, mm)[0]
    if not torch.equal(agg, kernel_fwd(p_mm, mm)[0]):
        fail("message_fwd's Hopper tile pass: a second call gave other bits")
    want = plain_fwd(p_mm, mm)[0]
    _, agg_old = fm.fwd_phase_stamps(p_mm["x_cat"], p_mm["ef"], p_mm["wf"], p_mm["slot_meta"],
                                     *p_mm["statics"], p_mm["n_out"], p_mm["bn"], p_mm["chunk"],
                                     mm, which="tile_fwd")
    e_new, e_old = rel_err(agg, want), rel_err(agg_old, want)
    print(f"[kernels] message_fwd ({mm}) at the flagship widths: Hopper tile pass "
          f"max|err|/max|ref| = {e_new:.3e}, the mma.sync tile pass on the same operands "
          f"{e_old:.3e} (limit {TOL[mm]:g}); the same bits on a second call")
    if not e_new <= TOL[mm]:
        fail("message_fwd's Hopper tile pass disagrees with plain")
    rows[0]["rel_err"], rows[0]["mma_sync_rel_err"] = e_new, e_old
    del agg, agg_old, want
    # the f32 instances at the flagship widths (f32_finetune_epochs, f32
    # checkpoints and MD run them): the f32 tile passes of the three, each
    # against its plain version and bit for bit on a second call, split by
    # pass
    for row, (name, _, _, kfn, pfn), (nbytes, flops) in zip(rows, timed,
                                                           kernel_costs(p, "float32")):
        route = kernel_route(name, "float32", p["statics"])
        if route != "f32 tile pass":
            fail(f"{name} takes the {route} in f32 at the flagship widths, not its f32 tile pass")
        k_ms = time_ms(lambda: kfn(p, "float32"), iters=5, warmup=1)
        b_ms, b_by = bound_ms(nbytes, flops, "float32")
        print(f"[time] {name} (float32, {route}): kernel {k_ms:.4f} ms, bound {b_ms:.4f} "
              f"ms ({b_by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP) — {card}")
        row["float32"] = {"ms": k_ms, "bound_ms": b_ms, "bound_by": b_by, "route": route}
        got, want = kfn(p, "float32"), pfn(p, "float32")
        e = max(rel_err(a, b) for a, b in zip(got, want))
        same = all(torch.equal(a, b) for a, b in zip(got, kfn(p, "float32")))
        print(f"[kernels] {name} (float32) at the flagship widths, f32 tile pass: "
              f"max|err|/max|ref| = {e:.3e} over {', '.join(OUT_NAMES[name])} (limit "
              f"{TOL['float32']:g}); " + ("the same bits on a second call" if same else
                                          "other bits on a second call"))
        if not (e <= TOL["float32"] and all(torch.isfinite(a).all() for a in got)):
            fail(f"{name}'s f32 tile pass disagrees with plain")
        if not same:
            fail(f"{name}'s f32 tile pass: a second call gave other bits")
        row["float32"]["rel_err"] = e
        row["float32"]["max_abs_err"] = max(float((a - b).abs().max())
                                            for a, b in zip(got, want))
        del got, want
        row["float32"]["split_ms"], row["float32"]["scratch_bytes"] = pass_split(
            name, lambda: kfn(p, "float32"), p, "float32", card)
    # the wide shapes in bf16, on the same slots
    for tag, pw in wide.items():
        for row, (name, _, _, kfn, _), (nbytes, flops) in zip(rows, timed, kernel_costs(pw, mm)):
            route = kernel_route(name, mm, pw["statics"])
            k_ms = time_ms(lambda: kfn(pw, mm), iters=5, warmup=1)
            b_ms, b_by = bound_ms(nbytes, flops, mm)
            print(f"[time] {name} ({mm}) at {tag} {pw['statics']}, {route}: kernel {k_ms:.4f} "
                  f"ms, bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.1f} MB, "
                  f"{flops / 1e9:.2f} GFLOP) — {card}")
            row.setdefault("wide_bfloat16", {})[tag] = {
                "ms": k_ms, "bound_ms": b_ms, "bound_by": b_by, "route": route}
            if name in fm.PASSES:
                pass_split(name, lambda: kfn(pw, mm), pw, mm, card)
    # the wide shapes in f32 on the same slots (the operands above, cast),
    # on whichever pass each takes: the widths past f32_route keep the walk
    # kernels
    for tag, pw in wide.items():
        pw32 = dict(pw, **{k: pw[k].float() for k in ("x_cat", "ef", "wf", "g", "cx", "cef")})
        for row, (name, _, _, kfn, _), (nbytes, flops) in zip(rows, timed,
                                                               kernel_costs(pw32, "float32")):
            route = kernel_route(name, "float32", pw["statics"])
            k_ms = time_ms(lambda: kfn(pw32, "float32"), iters=5, warmup=1)
            b_ms, b_by = bound_ms(nbytes, flops, "float32")
            print(f"[time] {name} (float32) at {tag} {pw['statics']}, {route}: kernel "
                  f"{k_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.1f} MB, "
                  f"{flops / 1e9:.2f} GFLOP) — {card}")
            row.setdefault("wide_float32", {})[tag] = {
                "ms": k_ms, "bound_ms": b_ms, "bound_by": b_by, "route": route}
        del pw32
        torch.cuda.empty_cache()
    del wide
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
    # the stream floor (phase 14) runs on no model path: its row takes each
    # path's count as the others do, and phase 14 fills in the rest
    rows.append({"name": "bwd_stream_floor", "route": "cuda",
                 "source": "xequinet_torch/csrc/bwd_stream_floor.cu",
                 "replaces": "tools/bwd_stream_floor.py:135",
                 "launches_predict": launches["bwd_stream_floor"],
                 "launches_train_step": per_step["bwd_stream_floor"]})

    mega_b = eng.collate(dps)
    v2_b = eng_v2.collate(dps)
    for tag, e, bb in (("mega", eng, mega_b), ("v2", eng_v2, v2_b), ("wide mega", eng_w, wide_b)):
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
    time_train_step("wide mega, 3 + 6 + 3 message kernels", step_w, b, ema_w, 10, n_real, card)
    # the flagship step in f32 (f32_finetune_epochs and f32 checkpoints
    # train so) and the share its 3 + 6 + 3 message launches take of it, at
    # the f32 times measured above
    _, _, step32, ema32 = train_model(device, **F32)
    ms32 = time_train_step("mega, 3 + 6 + 3 message kernels", step32, b, ema32, 0, n_real, card,
                           dtype="f32")
    k32 = sum(n * row["float32"]["ms"] for n, row in zip((3, 6, 3), rows))
    print(f"[time] train step (f32, mega): its message kernels 3 x {rows[0]['float32']['ms']:.4f}"
          f" + 6 x {rows[1]['float32']['ms']:.4f} + 3 x {rows[2]['float32']['ms']:.4f} = "
          f"{k32:.3f} ms, {k32 / ms32:.1%} of the step's {ms32:.3f} ms — {card}")
    del step32, ema32
    torch.cuda.empty_cache()

    # phase 14: the backward's stream-floor probe, run beside phase 6's
    # times: torch.profiler in this process has seen no device kernel after
    # phases 12 and 13 on an H100 (cause not found), and the probe's
    # reading needs its split by pass.  Its launches per probe call
    # and its times complete the sixth row
    next(r for r in rows if r["name"] == "bwd_stream_floor").update(
        phase_floor(device, card))

    if args.profile:
        profile_call("forward_forces", lambda: eng.forward_batch(mega_b), args.profile, card)
        profile_call("train_step", lambda: step(b, i0 + 8, 1.0, ema), args.profile, card)
        profile_call("v2_forward_forces", lambda: eng_v2.forward_batch(v2_b), args.profile,
                     card)
        profile_call("v2_train_step", lambda: step_v2(b, i0 + 8, 1.0, ema_v2), args.profile,
                     card)

    # phase 7: MD.  The message kernels' launches per Calculator call of the
    # MD hot loop stand beside each row's
    import os
    import tempfile

    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        md = phase_md(device, card, tmp, MD_SIZES, profile_dir=args.profile)
    for row in rows:
        row["launches_md_call"] = md["launches"].get(row["name"], 0)

    # phase 8: XPaiNN-Ewald (periodic and free) and the conditioned
    # multi-head XPaiNN; each path's launches stand beside each row's
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        ewald = phase_ewald(dps, device, card, tmp, EWALD_SIZES)
    for row in rows:
        for path, counts in ewald.items():
            row[f"launches_{path}"] = counts.get(row["name"], 0)

    # phase 9: PaiNN, SO3krates, the Cartesian head and XMatNet; each path's
    # launches stand beside each row's
    zoo = phase_zoo(dps, device, card, ZOO_SIZES)
    for row in rows:
        for path, counts in zoo.items():
            row[f"launches_{path}"] = counts.get(row["name"], 0)

    # phase 10: the user-facing drivers through the command line; each
    # path's launches (per train step, test batch, infer chunk, MD call;
    # opt and i-PI in all) stand beside each row's
    drivers = phase_cli(dps, device, card, CLI_SIZES)
    for row in rows:
        for path, counts in drivers.items():
            row[f"launches_{path}"] = counts.get(row["name"], 0)

    # phase 11: determinism, export, data parallelism and profiling; each
    # path's launches (per rank and train step, per exported call) stand
    # beside each row's
    p11 = phase_11(dps, device, card, P11_SIZES)
    for row in rows:
        for path, counts in p11.items():
            row[f"launches_{path}"] = counts.get(row["name"], 0)

    # phase 12: one large system over several ranks; each path's launches
    # (per rank and halo force call, per rank and halo train step) and the
    # kernels' times on a shard's halo layout stand beside each row's
    p12, halo_kernels = phase_halo(device, card, H12_SIZES)
    for row in rows:
        for path, counts in p12.items():
            row[f"launches_{path}"] = counts.get(row["name"], 0)
        if row["name"] in halo_kernels:
            row["halo_layout"] = halo_kernels[row["name"]]

    # phase 13: the convergence study's path; its launches per train step
    # (bf16 and f32 epochs), per validation batch and per NVE force call
    # stand beside each row's
    p13 = phase_study(device, card, STUDY_SIZES)
    for row in rows:
        for path, counts in p13.items():
            row[f"launches_{path}"] = counts.get(row["name"], 0)

    # phase 15: remat; its paths' launches (per forces-only call and train
    # step under each policy, mega and v2, the Ewald step, run_train's step,
    # the checkpoint's predict and Calculator call) stand beside each row's
    p15 = phase_remat(dps, b, device, card, REMAT_SIZES)
    for row in rows:
        for path, counts in p15.items():
            row[f"launches_{path}"] = counts.get(row["name"], 0)

    # phase 16: the last user-facing pieces; each path's launches (per predict
    # with the converted table, per train step and validation batch on the
    # converted data, over the whole bf16 study run) stand beside each row's
    p16 = phase_tools16(dps, device, card, P16_SIZES)
    for row in rows:
        for path, counts in p16.items():
            row[f"launches_{path}"] = counts.get(row["name"], 0)

    # phase 14, continued: the floor kernel ran on none of those paths
    floor_on_paths(rows)

    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def rehearsal():
    """Phases 3-5 and 7-16 at a tiny size on the CPU: plain versions only."""
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
        out, = plain_fwd(p, mm)
        grads = plain_bwd(p, mm) + plain_bwd2(p, mm) + plain_bwd2(p, mm, p["cwf"])
        assert torch.isfinite(out).all() and all(torch.isfinite(t).all() for t in grads)
    for tag, widths in WIDE_SHAPES.items():  # the wide shapes' plain versions
        pw = message_problem(batch, "cpu", bn=bn, chunk=chunk, widths=widths)
        for t in plain_fwd(pw, "bfloat16") + plain_bwd(pw, "float32"):
            assert torch.isfinite(t).all(), tag
    # a molecule larger than pad_nodes through the mega route's plain op
    big = build_molecules(3) + build_molecules(1, seed=6, atoms_lo=40, atoms_hi=40)
    eng = make_engine("cpu", action_blocks=1, pallas_layout=lay, **WIDE)
    bb = eng.collate([eng.transform(d) for d in big])
    assert keys.K_SRC2 in bb and np.isfinite(eng.predict(big)[-1][keys.FORCES]).all()
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
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        phase_md(torch.device("cpu"), "CPU rehearsal, not a device result", tmp, MD_REHEARSAL)
    print("[rehearsal] phase 7 (MD) ran at a tiny size on the CPU (not a device result)")
    with tempfile.TemporaryDirectory() as tmp:
        phase_ewald(dps, torch.device("cpu"), "CPU rehearsal, not a device result", tmp,
                    EWALD_REHEARSAL)
    print("[rehearsal] phase 8 (XPaiNN-Ewald, multi-head) ran at a tiny size on the CPU (not a "
          "device result)")
    phase_zoo(dps, torch.device("cpu"), "CPU rehearsal, not a device result", ZOO_REHEARSAL)
    print("[rehearsal] phase 9 (PaiNN, SO3krates, the Cartesian head, XMatNet) ran at a tiny "
          "size on the CPU (not a device result)")
    phase_cli(dps, torch.device("cpu"), "CPU rehearsal, not a device result", CLI_REHEARSAL)
    print("[rehearsal] phase 10 (train, preemption, resume, test, infer, opt, md, i-PI through "
          "the command line) ran at a tiny size on the CPU (not a device result)")
    phase_11(dps, torch.device("cpu"), "CPU rehearsal, not a device result", P11_REHEARSAL)
    print("[rehearsal] phase 11 (determinism, export, data parallelism, profiling) ran at a "
          "tiny size on the CPU (not a device result)")
    phase_halo(torch.device("cpu"), "CPU rehearsal, not a device result", H12_REHEARSAL)
    print("[rehearsal] phase 12 (halo forward, MD and training over four ranks, edge "
          "partition) ran at a tiny size on the CPU (not a device result)")
    phase_study(torch.device("cpu"), "CPU rehearsal, not a device result", STUDY_REHEARSAL)
    print("[rehearsal] phase 13 (the study's PES, generator, train with the f32 switch, test "
          "and NVE drift) ran at a tiny size on the CPU (not a device result)")
    from xequinet_torch.tools import bwd_stream_floor as bsf

    pf = bsf.problem("cpu", seed=1234, n_mols=12, bn=bn, chunk=chunk)
    dx, d_ef, d_wf = bsf.plain_floor(pf)
    assert not dx.any() and not d_wf.any() and d_ef.any()
    print(f"[rehearsal] phase 14 (the stream-floor probe) ran its plain floor on {pf['layout']} "
          f"(n_blocks, max_chunks, n_slots) on the CPU (not a device result)")
    phase_remat(dps, batch_to_device(batch, "cpu"), torch.device("cpu"),
                "CPU rehearsal, not a device result", REMAT_REHEARSAL)
    print("[rehearsal] phase 15 (remat: agreement, launches, memory cells, Ewald, run_train, "
          "predict, Calculator) ran at a tiny size on the CPU (not a device result)")
    phase_tools16(dps, torch.device("cpu"), "CPU rehearsal, not a device result",
                  P16_REHEARSAL)
    print("[rehearsal] phase 16 (a converted embedding table served, an LMDB dataset converted "
          "and trained on, the bf16 study's path) ran at a tiny size on the CPU (not a device "
          "result)")


if __name__ == "__main__":
    main()
