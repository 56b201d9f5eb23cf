"""The first-order message backward's stream floor on the card, and the
split of its tile pass by phase.

Port of the JAX package's ``tools/bwd_stream_floor.py``.  The floor kernel
(``csrc/bwd_stream_floor.cu``, :func:`~xequinet_torch.ops.fused_message.
bwd_stream_floor_cuda`) runs ``message_bwd``'s bf16 tile route (its Hopper
tile pass, ``csrc/message_bwd_hopper.cuh``) with a near-empty body: the
same persistent grid, tile walk, producer warp, bulk copies into the ring
of stages, shared memory and stores, then the backward's own dx pass and
d_wf reduction.  Its time is what moving the backward's operands and
results costs, below which no change to the backward's arithmetic can go.

The phase split: :func:`~xequinet_torch.ops.fused_message.bwd_phase_stamps`
launches a tile pass alone with clock64() stamps per phase: the mma.sync
tile pass (``csrc/message_bwd.cu``, which wider shapes take; no model path
launches it at these widths) and the Hopper pass.  Each phase's share of the
stamped cycles times the stamped pass's device time gives its ms.

Reading: with ``ideal`` the tensor-core time of the backward's three
filter contractions, ``floor + ideal`` near the tile pass's measured time
says the streams are the gap (the lever: TMA, fewer staged bytes, no
scratch); well under it, the body is (the lever: ``wgmma`` and fewer
elementwise instructions).

Steps, as the JAX tool's: bench.py's ``build_batch`` recipe at
``default_rng(0)`` on the port's collate (1024 molecules, the
(512, 512, 32, 64) slot layout), then the operands drawn from the same rng
in the JAX tool's order (:147-158) and cut to the port's shapes; the floor
held bit for bit against :func:`~xequinet_torch.ops.fused_message.
plain_bwd_stream_floor`; the floor and ``message_bwd`` on the same
operands each timed as the median of 3 repetitions of 20 calls (CUDA
events) and split by pass with torch.profiler, each split held to its
timed call; the two tile passes split by phase; the bounds; the reading.

Usage:
    python -m xequinet_torch.tools.bwd_stream_floor [--device cpu] [--out PATH]

It runs on the card unless ``--device cpu`` is given, and writes
``bwd_stream_floor.json`` beside this file (or ``--out``).  On the CPU it
builds the batch, prints the layout and runs the plain floor; it times
nothing there and writes nothing.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
from pathlib import Path

import numpy as np
import torch

# bench.py's KERNEL_BN, KERNEL_CHUNK and build_batch layout
BN, CHUNK, PAD_NODES, MAX_CHUNKS = 512, 512, 32, 64
# the JAX tool's widths (bench.py FLAGSHIP_KW) and matmul dtype
IRREPS, NUM_BASIS, NODE_DIM, MM = "128x0e+64x1o+32x2e", 20, 128, "bfloat16"
# the JAX tool's timing: the median of REPS repetitions of CALLS calls
REPS, CALLS = 3, 20
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3
PEAK_BF16, PEAK_BYTES = 989e12, 3.35e12
# the least share of a wrapper's CUDA-event ms per call that its passes'
# device ms (torch.profiler) must sum to: the split accounts for the call
SPLIT_SHARE = 0.9
# the calls torch.profiler records for a split by pass
SPLIT_CALLS = 10
# (floor + ideal) / the tile pass's time at or above which the streams
# are read as the gap, and at or below which the body is
STREAM_SHARE, BODY_SHARE = 0.75, 0.5
OUT = Path(__file__).with_name("bwd_stream_floor.json")


def build_batch(rng, n_mols=1024, atoms_lo=12, atoms_hi=28, cutoff=5.0, bn=BN, chunk=CHUNK):
    """bench.py's ``build_batch`` on the port's collate: the same rng
    draws, molecule by molecule, and its slot layout."""
    from ..data.batching import collate
    from ..data.datapoint import Datapoint
    from ..ops.radius_graph import radius_graph_np

    dps = []
    for _ in range(n_mols):
        n = int(rng.integers(atoms_lo, atoms_hi + 1))
        pos = rng.normal(size=(n, 3)) * (n ** (1 / 3)) * 0.9
        ei, _ = radius_graph_np(pos, cutoff)
        z = rng.integers(1, 9, size=n).astype(np.int32)
        e = float(rng.normal())
        f = rng.normal(size=(n, 3))
        dps.append(Datapoint(z, pos, edge_index=ei, energy=e, forces=f))
    layout = {"block_nodes": bn, "chunk": chunk, "pad_nodes": PAD_NODES,
              "max_chunks": MAX_CHUNKS}
    return collate(dps, kernel_layout=layout)


def layout_numbers(batch, bn=BN):
    """(n_blocks, max_chunks, n_slots), the JAX tool's three numbers."""
    from .. import keys

    n_padded = batch[keys.ATOMIC_NUMBERS].shape[0]
    return ((n_padded + bn - 1) // bn, int(batch[keys.K_NCHUNKS].max()),
            len(batch[keys.K_SRC2]))


def problem(device, seed=0, n_mols=1024, bn=BN, chunk=CHUNK):
    """The batch and the operands, as the JAX tool makes them: one
    ``default_rng(seed)`` draws the batch, then x_cat [n_padded, Hp+Dp],
    ef [n_slots, 128], g_pad [n_blocks * BN, SDp+Dp] and wfby [128, Hp+Dp]
    in that order (tools/bwd_stream_floor.py:147-158).  Cut to the port's
    operands: wf is wfby's first Hp columns, g is g_pad's first n_padded
    rows (the port's cotangent has one row per node row; n_padded is a
    multiple of BN here, so nothing is cut at the flagship batch), and
    the packing contract the kernels rely on (pallas_message.py:151-171)
    is applied: x's padding columns [H, Hp) and [Hp+D, Hp+Dp), ef's columns
    >= Kf and wf's rows >= Kw and columns >= H are zero.  Every operand is
    bf16 (the JAX tool's ``mm``), so the wrappers launch their kernels and
    nothing else."""
    from .. import keys
    from ..ops import fused_message as fm

    _, _, _, _, (h, hp, d, dp, sdp, n_y) = fm.structure_matrices(IRREPS, NUM_BASIS, NODE_DIM)
    kw, kf = NUM_BASIS + 1, NUM_BASIS + 1 + n_y
    rng = np.random.default_rng(seed)
    batch = build_batch(rng, n_mols, bn=bn, chunk=chunk)
    n_blocks, max_chunks, n_slots = layout_numbers(batch, bn)
    n_padded = batch[keys.ATOMIC_NUMBERS].shape[0]
    x_cat = rng.normal(size=(n_padded, hp + dp))
    ef = rng.normal(size=(n_slots, fm.F_PACK))
    g_pad = rng.normal(size=(n_blocks * bn, sdp + dp))
    wfby = rng.normal(size=(fm.F_PACK, hp + dp))
    x_cat[:, h:hp] = 0.0
    x_cat[:, hp + d:] = 0.0
    ef[:, kf:] = 0.0
    wf = wfby[:, :hp].copy()
    wf[kw:] = 0.0
    wf[:, h:] = 0.0
    bf = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device).to(torch.bfloat16)
    b = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    ei = b[keys.EDGE_INDEX]
    slot_meta = (b[keys.K_SRC2], b[keys.K_DST2], ei[1], ei[0], b[keys.K_CHUNK_BASE],
                 b[keys.K_NCHUNKS], b[keys.K_WSTARTS])
    # the slot plan is built once per batch on the model's path, so the
    # calls are checked and timed with it built
    plan = fm.build_slot_plan(slot_meta, n_padded, n_padded, bn, chunk)
    return dict(x_cat=bf(x_cat), ef=bf(ef), wf=bf(wf), g=bf(g_pad[:n_padded]),
                slot_meta=slot_meta + (plan,), statics=(IRREPS, NUM_BASIS, NODE_DIM),
                n_out=n_padded, bn=bn, chunk=chunk, layout=(n_blocks, max_chunks, n_slots),
                n_atoms=int(batch[keys.NODE_MASK].sum()),
                n_valid=int((plan["slot_dst"] >= 0).sum()), batch=batch)


def _args(p):
    return (p["x_cat"], p["ef"], p["wf"], p["g"], p["slot_meta"], *p["statics"], p["n_out"],
            p["bn"], p["chunk"], MM)


def floor_call(p):
    """One call of the floor kernel's wrapper: (dx, d_ef, d_wf)."""
    from ..ops import fused_message as fm

    return fm.bwd_stream_floor_cuda(*_args(p))


def plain_floor(p):
    from ..ops import fused_message as fm

    return fm.plain_bwd_stream_floor(*_args(p))


def bwd_call(p):
    """One call of message_bwd's wrapper on the same operands."""
    from ..ops import fused_message as fm

    return fm.message_bwd_cuda(*_args(p))


def check_exact(got, want):
    """max |got - want| over (dx, d_ef, d_wf); raises unless every output
    is the same bits (the floor copies, it computes nothing)."""
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise RuntimeError(f"the floor kernel differs from its plain version (max |err| "
                           f"{err:g})")
    return err


def costs(p):
    """Bytes and operations from the problem's shapes: real atoms' live
    x / g columns, the valid slots' edge-feature columns, each input read
    once and each output written once, one source and one destination
    index per valid slot (as chip_smoke.kernel_costs counts the backward).

    ``bwd_bytes``: what message_bwd must move (Kf columns of ef and d_ef);
    ``floor_bytes``: what the floor's outputs need, the staged Kf-to-32
    columns of ef read and of d_ef written, dx and d_wf written (x, g, wf
    and the indices do not enter them);
    ``moved_bytes``: what the floor's design moves, the tile pass's staging
    (x row, g row, ef columns per valid slot, mostly from L2 where rows
    repeat), its three slot indices, its scratch rows written and read
    back, d_ef's 128 columns, dx's whole rows, wf's live rows per block and
    the d_wf partials written and read; ``ideal_flops``: the backward's
    three filter contractions (fw, d_ef's filter columns, d_wf) per slot."""
    from ..ops import fused_message as fm

    irreps, nb, nd = p["statics"]
    _, _, _, _, (h, hp, d, dp, sdp, n_y) = fm.structure_matrices(irreps, nb, nd)
    kw, kf = nb + 1, nb + 1 + n_y
    ru = lambda v, m: (v + m - 1) // m * m
    ke, ht8, dt8, sd8 = ru(kf, 32), ru(h, 8), ru(d, 8), ru(nd, 8)
    n_at, n_e = p["n_atoms"], p["n_valid"]
    n_rows, n_slots = p["x_cat"].shape[0], p["layout"][2]
    n_part = (torch.cuda.get_device_properties(p["x_cat"].device).multi_processor_count
              if p["x_cat"].is_cuda else 132)

    def function_bytes(k_cols):
        inputs = (n_at * (h + d) + n_e * k_cols + kw * h) * 2 + 2 * n_e * 4
        return inputs + n_at * (nd + d) * 2 + (n_at * (h + d) + n_e * k_cols + kw * h) * 4

    rs = ht8 + dt8
    moved = (n_e * (rs + sd8 + dt8 + ke) * 2 + n_slots * 3 * 4 + 2 * n_e * rs * 2
             + (n_rows + 1) * 4 + n_slots * fm.F_PACK * 4 + n_rows * (hp + dp) * 4
             + n_part * ru(kw, 32) * ru(h, 16) * 2 + 2 * n_part * kf * h * 4
             + fm.F_PACK * hp * 4)
    floor_bytes = n_e * ke * 2 + (n_at * (h + d) + n_e * ke + kw * h) * 4
    return dict(bwd_bytes=function_bytes(kf), floor_bytes=floor_bytes, moved_bytes=moved,
                ideal_flops=n_e * (4 * kw * h + 2 * kf * h), scratch_bytes=n_e * rs * 2)


def time_calls(fn, reps=REPS, calls=CALLS):
    """The median over ``reps`` repetitions of the ms per call of
    ``calls`` calls (CUDA events), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / calls)
    return float(np.median(out))


def pass_split(fn, passes, calls=SPLIT_CALLS):
    """({pass: device ms per launch}, {pass: launches recorded}) by kernel
    name (torch.profiler over ``calls`` calls after a warm-up, each pass
    launched once per call).  A pass's ms is its device time over the
    launches the profiler recorded, so a record it dropped does not lower
    it; passes it did not see are left out."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev = lambda e: getattr(e, "self_device_time_total", None) or \
        getattr(e, "self_cuda_time_total", 0.0)
    split, seen = {}, {}
    for tag, kname in passes:  # kernel names, templated or not
        evs = [e for e in prof.key_averages() if re.search(rf"\b{kname}\b", e.key)]
        n = sum(e.count for e in evs)
        if n:
            split[tag], seen[tag] = sum(dev(e) for e in evs) / 1e3 / n, n
    return split, seen


def seen_note(seen, calls):
    """The passes of which the profiler recorded other than ``calls``
    launches, as a note for a printed line ("" when none)."""
    short = {k: n for k, n in seen.items() if n != calls}
    return "".join(f"; {k} {n} of {calls} launches recorded" for k, n in short.items())


def check_split(name, split, ms):
    """The share of ``ms`` (a wrapper's CUDA-event ms per call) that its
    passes' device ms sum to; raises unless the split has a tile pass and
    that share is at least SPLIT_SHARE, so that a profiler that missed
    launches gives no reading."""
    share = sum(split.values()) / ms
    if "tile pass" not in split or share < SPLIT_SHARE:
        raise RuntimeError(f"torch.profiler's split of {name} ({split}) does not account for "
                           f"its {ms:.4f} ms per call (share {share:.3f}, at least "
                           f"{SPLIT_SHARE} wanted): the reading needs the split by pass")
    return share


def reading(floor_ms, ideal_ms, measured_ms):
    """(verdict, sentence): whether the streams or the body bound a pass
    of ``measured_ms`` whose stream floor is ``floor_ms``."""
    share = (floor_ms + ideal_ms) / measured_ms
    lead = (f"floor + ideal = {floor_ms:.4f} + {ideal_ms:.4f} ms is {share:.0%} of the "
            f"measured {measured_ms:.4f} ms")
    if share >= STREAM_SHARE:
        return "stream", (f"{lead}: the streams are the gap; the lever is TMA, fewer "
                          f"staged bytes or no scratch")
    if share <= BODY_SHARE:
        return "body", (f"{lead}: the body is the gap; the lever is wgmma and fewer "
                        f"elementwise instructions")
    return "both", (f"{lead}: streams and body each take a large share; neither lever "
                    f"alone closes the gap")


def phase_split(p, passes=("tile", "hopper"), calls=SPLIT_CALLS):
    """``message_bwd``'s tile passes split by phase: for each of ``passes``
    (``which`` of ``bwd_phase_stamps``: "tile", the mma.sync pass; "hopper",
    the Hopper pass) the stamped pass's device ms (torch.profiler over
    ``calls`` launches) and per role its phases' shares of the stamped
    cycles and ms (share x device ms).  Roles: the block's thread 0 for
    "tile"; the consumer warpgroups (summed) and the producer warp for
    "hopper"."""
    from ..ops import fused_message as fm

    names = {"tile": "message_bwd_tile_kernel", "hopper": "message_bwd_hopper_kernel"}
    out = {}
    for which in passes:
        kname = names[which]
        fn = lambda: fm.bwd_phase_stamps(*_args(p), which=which)
        split, _ = pass_split(fn, (("tile pass", kname),), calls)
        stamps = fn().double().cpu().numpy()
        torch.cuda.synchronize()
        ms = split.get("tile pass", float("nan"))
        roles = ({"block": stamps.sum(0)} if which == "tile" else
                 {"warpgroups": stamps[:, :-1].sum((0, 1)), "producer": stamps[:, -1].sum(0)})
        rec = {"stamped_ms": ms}
        for role, cyc in roles.items():
            phases = fm.PHASES["producer" if role == "producer" else which]
            share = cyc / cyc.sum()
            rec[role] = {n: {"share": float(s), "ms": float(s * ms)}
                         for n, s in zip(phases, share) if n != "-"}
        out[which] = rec
    return out


def phase_lines(phases, card):
    """The printed lines of :func:`phase_split`."""
    lines = []
    for which, rec in phases.items():
        for role, split in rec.items():
            if role == "stamped_ms":
                continue
            by = ", ".join(f"{n} {v['ms']:.4f} ({v['share']:.1%})" for n, v in split.items())
            lines.append(f"{which} tile pass, stamped {rec['stamped_ms']:.4f} ms, {role}: "
                         f"{by} — {card}")
    return lines


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0]


def measure(p, phases=("tile", "hopper")):
    """The numbers of the JSON on the card (floor first: its launch
    happens before message_bwd's, with the same operands resident), the
    tile passes of ``phases`` split by phase (:func:`phase_split`).
    Raises where a split by pass does not account for its timed call."""
    from ..ops import fused_message as fm

    c = costs(p)
    floor_ms = time_calls(lambda: floor_call(p))
    floor_split, floor_seen = pass_split(lambda: floor_call(p), fm.PASSES["bwd_stream_floor"])
    bwd_ms = time_calls(lambda: bwd_call(p))
    bwd_split, bwd_seen = pass_split(lambda: bwd_call(p), fm.PASSES["message_bwd"])
    plain_ms = time_calls(lambda: plain_floor(p), reps=1, calls=5)
    ideal_ms = c["ideal_flops"] / PEAK_BF16 * 1e3
    floor_share = check_split("the floor", floor_split, floor_ms)
    bwd_share = check_split("message_bwd", bwd_split, bwd_ms)
    # the reading compares the tile passes (the dx pass is the same kernel
    # in both)
    verdict, text = reading(floor_split["tile pass"], ideal_ms, bwd_split["tile pass"])
    phases = phase_split(p, phases)
    n_blocks, max_chunks, n_slots = p["layout"]
    return {
        "floor_ms": floor_ms, "n_blocks": n_blocks, "max_chunks": max_chunks,
        "n_slots": n_slots, "floor_split_ms": floor_split, "floor_split_seen": floor_seen,
        "floor_split_share": floor_share, "plain_ms": plain_ms,
        "message_bwd_ms": bwd_ms, "message_bwd_split_ms": bwd_split,
        "message_bwd_split_seen": bwd_seen, "message_bwd_split_share": bwd_share,
        "message_bwd_bound_ms": c["bwd_bytes"] / PEAK_BYTES * 1e3,
        "message_bwd_bound_bytes": c["bwd_bytes"],
        "floor_bound_ms": c["floor_bytes"] / PEAK_BYTES * 1e3,
        "floor_bound_bytes": c["floor_bytes"],
        "floor_moved_bytes": c["moved_bytes"],
        "floor_moved_ms": c["moved_bytes"] / PEAK_BYTES * 1e3,
        "scratch_bytes": c["scratch_bytes"], "ideal_flops": c["ideal_flops"],
        "ideal_ms": ideal_ms, "reading": verdict, "reading_text": text,
        "n_valid_slots": p["n_valid"], "n_atoms": p["n_atoms"], "phases": phases,
    }


def report(res, card):
    """The tool's printed lines."""
    def split(who):
        by = ", ".join(f"{k} {v:.4f}" for k, v in res[f"{who}_split_ms"].items())
        return (f"by pass: {by} ms, {res[f'{who}_split_share']:.1%} of the call"
                f"{seen_note(res[f'{who}_split_seen'], SPLIT_CALLS)}")

    return [
        f"bwd stream floor: {res['floor_ms']:.4f} ms/call ({res['n_blocks']} blocks x "
        f"{res['max_chunks']} max_chunks, {res['n_slots']} slots; {split('floor')}) — {card}",
        f"message_bwd on the same operands: {res['message_bwd_ms']:.4f} ms/call "
        f"({split('message_bwd')}) — {card}",
        f"bounds: the floor's own {res['floor_bound_ms']:.4f} ms "
        f"({res['floor_bound_bytes'] / 1e6:.1f} MB at 3.35 TB/s), message_bwd's "
        f"{res['message_bwd_bound_ms']:.4f} ms ({res['message_bwd_bound_bytes'] / 1e6:.1f} "
        f"MB); the floor's design moves "
        f"{res['floor_moved_bytes'] / 1e6:.1f} MB ({res['floor_moved_ms']:.4f} ms at "
        f"3.35 TB/s); tensor-core ideal {res['ideal_ms']:.4f} ms "
        f"({res['ideal_flops'] / 1e9:.2f} GFLOP at 989 TFLOP/s); plain floor "
        f"{res['plain_ms']:.4f} ms",
        f"reading ({res['reading']}): {res['reading_text']}",
        *phase_lines(res["phases"], card),
    ]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="where the probe runs: cuda (the default) or cpu (the plain "
                         "floor, no time)")
    ap.add_argument("--out", default=str(OUT), help="the JSON written by a card run")
    args = ap.parse_args(argv)

    from ..ops import cuda_build
    from ..run.inference import resolve_device

    dev = resolve_device(args.device)
    p = problem(dev)
    n_blocks, max_chunks, n_slots = p["layout"]
    print(f"layout: {n_blocks} blocks x {max_chunks} max_chunks, {n_slots} slots, "
          f"{p['n_valid']} valid slots, {p['n_atoms']} atoms")
    if dev.type != "cuda":
        out = plain_floor(p)
        print(f"plain floor on the CPU: d_ef of {out[1].shape[0]} slots; no time taken "
              f"(not a device result), nothing written")
        return None
    card = card_line()
    cuda_build.reset_launch_counts()
    got = floor_call(p)
    torch.cuda.synchronize()
    launches = cuda_build.LAUNCHES["bwd_stream_floor"]
    err = check_exact(got, plain_floor(p))
    print(f"floor kernel against its plain version: the same bits (max |err| {err:g}), "
          f"{launches} launch")
    res = measure(p)
    res.update(max_abs_err=err, card=card, device=torch.cuda.get_device_name(0))
    for line in report(res, card):
        print(line)
    Path(args.out).write_text(json.dumps(res, indent=1) + "\n")
    print(f"wrote {args.out}")
    return res


if __name__ == "__main__":
    main()
