"""A message kernel, either backward or the forward, of two source trees
timed in turns on one card.

``--kernel message_bwd`` (the default), ``--kernel message_bwd2`` (the
second order without cwf, as force training runs it) or ``--kernel
message_fwd`` (the forward, on the same operands without g).  This process, in
the tree this file belongs to (the change), builds the operands of three
batches once with its own code and saves them to a temporary file:

* the stream-floor probe's batch (``bwd_stream_floor.problem``, bench.py's
  ``build_batch`` recipe at ``default_rng(0)``),
* the same recipe at ``default_rng(1234)``, bench.py's flagship batch,
* shard 0 of 4 of chip_smoke's 10,000-atom periodic box in
  HaloCalculator's layout (block_nodes 256, chunk 1024),

and for ``message_bwd2`` the cotangents cx and cef of each, drawn from
``default_rng(COT_SEED)`` (cef's columns >= Kf zero, as the model hands
them in).  Each tree (a checkout of the repo, e.g. a parent commit unpacked
with ``git archive``) is then imported in a process of its own, in the
order parent, change, change, parent, so that both run on the same card at
the same power limit and drift shows as the distance between a tree's own
runs.  Each process loads the same operands and the same pass names
(the change's ``PASSES[kernel]``) onto the card and times its tree's
wrapper with this file's tree's ``bwd_stream_floor.time_calls`` and
``pass_split`` (loaded by path): two more warm-up calls, then the median of
3 repetitions of 20 calls (CUDA events) after its own warm-up, and the
split by pass (torch.profiler).  Usage, from the root of the change's tree:

    python -m xequinet_torch.tools.bwd_compare PARENT_ROOT [CHANGE_ROOT] \
        [--kernel message_bwd2 | message_fwd] [--dtype float32] [--phases [PASS ...]]

``--dtype float32`` times the f32 instances on the same operands cast to
f32 (bf16 by default, the flagship's dtype).  Each ``RESULT`` line holds a
digest of the wrapper's outputs on each batch (sha1 of their bytes): in
bf16 parent and change must print the same digests where a change leaves
the bf16 passes as they were; in f32 the tool prints the change's largest
error against the parent's outputs (max |change - parent| / max |parent|
over the outputs).

It prints one ``RESULT {...}`` JSON line per process and the card's name
and power limit.  ``--phases`` also splits the change's tile passes of the
kernel by phase on the flagship batch (clock64() stamps of instrumented
instances, on no model path) in this process, after the turns:
``message_bwd2``'s through ``fused_message.bwd2_phase_stamps`` (``tile``,
the mma.sync pass; ``hopper``, the Hopper pass), ``message_fwd``'s through
``fused_message.fwd_phase_stamps`` (``tile_fwd``, ``hopper_fwd``), the f32
tile pass of each of the three kernels through
``fused_message.f32_phase_stamps`` (``f32``, on the operands cast to f32;
the forward's split per consumer warp too); all of the kernel's when none
is named; without PARENT_ROOT only the split runs.
It needs a card.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
TOOL = Path(__file__).with_name("bwd_stream_floor.py")
BATCHES = ("probe", "flagship", "halo_shard0")
KERNELS = ("message_bwd", "message_bwd2", "message_fwd")
DTYPES = ("bfloat16", "float32")
# the passes --phases splits, per kernel: the probe's ``which`` -> (the
# stamped kernel's name as torch.profiler shows it, the PHASES key of its
# blocks or warpgroups, that of its producer or None)
PHASE_PASSES = {
    "message_bwd": {"f32": ("message_bwd_f32_kernel", "f32", "producer_f32")},
    "message_bwd2": {"tile": ("message_bwd2_tile_stamped_kernel", "tile2", None),
                     "hopper": ("message_bwd2_hopper_kernel", "hopper2", "producer2"),
                     "f32": ("message_bwd2_f32_kernel", "f32", "producer_f32")},
    "message_fwd": {"tile_fwd": ("message_fwd_tile_stamped_kernel", "tile_fwd", None),
                    "hopper_fwd": ("message_fwd_hopper_kernel", "hopper_fwd", "producer_fwd"),
                    "f32": ("message_fwd_f32_kernel", "f32_fwd", "producer_f32")},
}
# the seed of message_bwd2's cotangents
COT_SEED = 11


def halo_shard0(dev, irreps, num_basis, node_dim):
    """Operands of shard 0 of 4 of the 10,000-atom box (chip_smoke.md_box,
    its rng) in HaloCalculator's layout, seeded like chip_smoke's message
    problems."""
    import numpy as np
    import torch

    from xequinet_torch import keys
    from xequinet_torch.ops import fused_message as fm
    from xequinet_torch.parallel import halo as hm

    n = 10000
    rng = np.random.default_rng(3)
    rng.integers(1, 5, 6), rng.normal(size=(6, 3))
    lx = n * 0.15
    cell = np.diag([lx, 16.0, 16.0])
    x = (np.arange(n) * 0.15 + rng.normal(size=n) * 0.5) % lx
    pos = np.column_stack([x, rng.uniform(0, 16.0, size=(n, 2))])
    z = rng.integers(1, 9, size=n).astype(np.int32)
    stacked, geom, _, _, _, _ = hm.prepare_halo_system(z, pos, 5.0, 4, cell=cell,
                                                       pbc=np.array([True] * 3))
    bn = min(256, geom["n_local"])
    stacked, _, _ = hm.apply_halo_kernel_layout(stacked, geom, {"block_nodes": bn, "chunk": 1024},
                                                margin=1.3)
    shard = {k: v[0] for k, v in stacked.items()}
    _, _, _, _, (h, hp, d, dp, sdp, n_y) = fm.structure_matrices(irreps, num_basis, node_dim)
    r = np.random.default_rng(7)
    n_rows, t = shard[keys.ATOMIC_NUMBERS].shape[0], shard[keys.EDGE_MASK].shape[0]
    x_cat = r.normal(size=(n_rows, hp + dp))
    x_cat[:, h:hp] = 0.0
    x_cat[:, hp + d:] = 0.0
    ef = r.normal(size=(t, fm.F_PACK))
    ef[:, num_basis + 1 + n_y:] = 0.0
    wf = np.zeros((fm.F_PACK, hp))
    wf[:num_basis + 1, :h] = r.normal(size=(num_basis + 1, h))
    g = r.normal(size=(n_rows, sdp + dp))
    bf = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev).to(torch.bfloat16)
    b = {k: torch.as_tensor(v, device=dev) for k, v in shard.items()}
    ei = b[keys.EDGE_INDEX]
    meta = (b[keys.K_SRC2], b[keys.K_DST2], ei[1], ei[0], b[keys.K_CHUNK_BASE],
            b[keys.K_NCHUNKS], b[keys.K_WSTARTS])
    plan = fm.build_slot_plan(meta, n_rows, n_rows, bn, 1024)
    return (bf(x_cat), bf(ef), bf(wf), bf(g), meta + (plan,), irreps, num_basis, node_dim,
            n_rows, bn, 1024, "bfloat16")


def cotangents(args, seed):
    """(cx, cef) for one batch's ``message_bwd_cuda`` arguments: normal
    draws of ``default_rng(seed)`` in bf16, zero where the model hands in
    zero (x's padding columns, cef's columns >= Kf)."""
    import numpy as np
    import torch

    from xequinet_torch.ops import fused_message as fm

    x, ef = args[0], args[1]
    irreps, nb, nd = args[5:8]
    _, _, _, _, (h, hp, d, dp, sdp, n_y) = fm.structure_matrices(irreps, nb, nd)
    rng = np.random.default_rng(seed)
    cx = rng.normal(size=tuple(x.shape))
    cx[:, h:hp] = 0.0
    cx[:, hp + d:] = 0.0
    cef = rng.normal(size=tuple(ef.shape))
    cef[:, nb + 1 + n_y:] = 0.0
    bf = lambda a: torch.as_tensor(a, dtype=torch.float32, device=x.device).to(torch.bfloat16)
    return bf(cx), bf(cef)


def kernel_args(kernel, args, cots=None):
    """The wrapper's arguments: ``message_bwd_cuda``'s, for
    ``message_bwd2_cuda`` the same with (cx, cef) and no cwf after g, for
    ``message_fwd_cuda`` the same without g."""
    if kernel == "message_bwd":
        return args
    if kernel == "message_fwd":
        return args[:3] + args[4:]
    return args[:4] + tuple(cots) + (None,) + args[4:]


def as_dtype(args, dtype):
    """A wrapper's arguments with its bf16 operands cast to ``dtype`` and
    its compute dtype (the last argument) set to it."""
    import torch

    cast = lambda a: a.to(getattr(torch, dtype)) if isinstance(a, torch.Tensor) and \
        a.dtype == torch.bfloat16 else a
    return tuple(cast(a) for a in args[:-1]) + (dtype,)


def digest(outs):
    """sha1 of the outputs' bytes, in order (16 hex digits)."""
    h = hashlib.sha1()
    for t in outs:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def rel_err(got, ref):
    """max |got - ref| / max |ref| over the outputs (each as f32)."""
    err = max(float((a.float() - b.float()).abs().max()) if a.numel() else 0.0
              for a, b in zip(got, ref))
    scale = max(float(b.float().abs().max()) if b.numel() else 0.0 for b in ref)
    return err / max(scale, 1e-30)


def save_operands(path, kernel="message_bwd", dtype="bfloat16"):
    """The three batches' arguments of ``kernel``'s wrapper in ``dtype``,
    built on the CPU by this tree's code, and this tree's pass names of
    ``kernel``."""
    import torch

    from xequinet_torch.ops import fused_message as fm
    from xequinet_torch.tools import bwd_stream_floor as bsf

    cpu = torch.device("cpu")
    batches = {"probe": bsf._args(bsf.problem(cpu)),
               "flagship": bsf._args(bsf.problem(cpu, seed=1234)),
               "halo_shard0": halo_shard0(cpu, bsf.IRREPS, bsf.NUM_BASIS, bsf.NODE_DIM)}
    if kernel != "message_bwd":
        batches = {k: kernel_args(kernel, a, cotangents(a, COT_SEED) if kernel ==
                                  "message_bwd2" else None) for k, a in batches.items()}
    batches = {k: as_dtype(a, dtype) for k, a in batches.items()}
    torch.save({"kernel": kernel, "dtype": dtype, "batches": batches,
                "passes": fm.PASSES[kernel]}, path)


def _to(obj, dev):
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if isinstance(obj, tuple):
        return tuple(_to(o, dev) for o in obj)
    if isinstance(obj, dict):
        return {k: _to(v, dev) for k, v in obj.items()}
    return obj


def measure_tree(label, operands, save=None):
    """One process's measurement of the xequinet_torch on sys.path, on the
    saved operands, timed by this file's tree's tool, with the digest of
    each batch's outputs; ``save``: a path that the outputs go to."""
    import torch

    from xequinet_torch.ops import cuda_build
    from xequinet_torch.ops import fused_message as fm

    spec = importlib.util.spec_from_file_location("_bwd_timing", TOOL)
    timing = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timing)
    dev = torch.device("cuda")
    saved = torch.load(operands, weights_only=True)
    kernel = saved["kernel"]
    cuda_build.build_kernels([kernel])
    wrapper = getattr(fm, f"{kernel}_cuda")
    out = {"label": label, "kernel": kernel, "dtype": saved.get("dtype", "bfloat16"),
           "package": str(Path(fm.__file__).parents[1])}
    kept = {}
    for name in BATCHES:
        args = _to(saved["batches"][name], dev)
        fn = lambda: wrapper(*args)
        fn(), fn()
        ms = timing.time_calls(fn)
        split, _ = timing.pass_split(fn, saved["passes"])
        outs = fn()
        outs = (outs,) if isinstance(outs, torch.Tensor) else tuple(outs)
        torch.cuda.synchronize()
        out[name] = {"ms": ms, "split": split, "split_share": sum(split.values()) / ms,
                     "digest": digest(outs)}
        if save:
            kept[name] = tuple(t.cpu() for t in outs)
        del args, outs
    if save:
        torch.save(kept, save)
    return out


def phase_split(kernel="message_bwd2", passes=None, calls=10):
    """The change's tile passes of ``kernel`` split by phase on the flagship
    batch: per pass (a key of ``PHASE_PASSES[kernel]``: "tile" / "tile_fwd",
    the mma.sync pass; "hopper" / "hopper_fwd", the Hopper pass; "f32", the
    f32 tile pass on the operands cast to f32) the stamped launch's device
    ms (torch.profiler over ``calls`` launches) and per role its phases'
    shares of the stamped cycles and their ms (share x device ms).  Roles:
    the block's thread 0 for the mma.sync passes; the consumer warpgroups
    (summed) and the producer warp for the Hopper passes; the consumers'
    thread 0 (the forward's: each consumer warp's lane 0, summed) and the
    producer warp for the f32 passes.  Where more than one consumer role is
    stamped, also each one's phases as ms ("per_warpgroup_ms", the
    forward's f32 pass "per_warp_ms")."""
    import torch

    from xequinet_torch.ops import fused_message as fm
    from xequinet_torch.tools import bwd_stream_floor as bsf

    passes = tuple(passes or PHASE_PASSES[kernel])
    if not set(passes) <= set(PHASE_PASSES[kernel]):
        raise ValueError(f"{kernel}'s passes are {sorted(PHASE_PASSES[kernel])} "
                         "(message_bwd's bf16 passes: python -m "
                         "xequinet_torch.tools.bwd_stream_floor)")
    dev = torch.device("cuda")
    args = bsf._args(bsf.problem(dev, seed=1234))
    cots = cotangents(args, COT_SEED) if kernel == "message_bwd2" else None

    def stamp(which):
        if which == "f32":  # the f32 instance, on the same operands cast to f32
            return fm.f32_phase_stamps(kernel, *as_dtype(kernel_args(kernel, args, cots),
                                                         "float32"))
        if kernel == "message_bwd2":
            return fm.bwd2_phase_stamps(*args[:4], *cots, *args[4:], which=which)
        return fm.fwd_phase_stamps(*kernel_args(kernel, args), which=which)[0]
    out = {}
    for which in passes:
        kname, role_key, producer_key = PHASE_PASSES[kernel][which]
        fn = lambda: stamp(which)
        split, _ = bsf.pass_split(fn, (("tile pass", kname),), calls)
        stamps = fn().double().cpu().numpy()
        torch.cuda.synchronize()
        ms = split.get("tile pass", float("nan"))
        lead = "consumers" if which == "f32" else "warpgroups"  # thread 0 of all consumers
        roles = ({"block": stamps.sum(0)} if producer_key is None else
                 {lead: stamps[:, :-1].sum((0, 1)), "producer": stamps[:, -1].sum(0)})
        rec = {"stamped_ms": ms}
        for role, cyc in roles.items():
            phases = fm.PHASES[producer_key if role == "producer" else role_key]
            share = cyc / cyc.sum()
            rec[role] = {n: {"share": float(v), "ms": float(v * ms)}
                         for n, v in zip(phases, share) if n != "-"}
        if producer_key is not None and stamps.shape[1] > 2:  # each role's phases, as ms
            per = stamps[:, :-1].sum(0)
            per = per / per.sum(1, keepdims=True) * ms
            rec["per_warp_ms" if which == "f32" else "per_warpgroup_ms"] = {
                n: [float(v) for v in per[:, c]]
                for c, n in enumerate(fm.PHASES[role_key]) if n != "-"}
        out[which] = rec
    return out


def build_parser():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*", help="PARENT_ROOT [CHANGE_ROOT]")
    ap.add_argument("--kernel", default="message_bwd", choices=KERNELS)
    ap.add_argument("--phases", nargs="*", default=None,
                    choices=sorted({w for v in PHASE_PASSES.values() for w in v}),
                    help="also split the change's tile passes of the kernel by phase: "
                         "message_bwd2's mma.sync pass (tile) and Hopper pass (hopper), "
                         "message_fwd's (tile_fwd, hopper_fwd), the f32 pass of each kernel "
                         "(f32); all of the kernel's when none is named")
    ap.add_argument("--dtype", default="bfloat16", choices=DTYPES,
                    help="the operands' dtype, so the instance timed (bf16 by default)")
    ap.add_argument("--one", nargs="+", metavar="LABEL OPERANDS [SAVE]",
                    help=argparse.SUPPRESS)
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if args.one:  # a child process: the tree is on PYTHONPATH
        print("RESULT " + json.dumps(measure_tree(*args.one)), flush=True)
        return None
    if not args.trees and args.phases is None:
        ap.error("PARENT_ROOT is required")
    parent = Path(args.trees[0]).resolve() if args.trees else None
    change = Path(args.trees[1]).resolve() if len(args.trees) > 1 else ROOT
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(card, flush=True)
    results = []
    if args.trees:
        results = compare(parent, change, args.kernel, card, args.dtype)
    if args.phases is not None:
        phases = phase_split(args.kernel, tuple(args.phases))
        print("PHASES " + json.dumps(phases), flush=True)
        for which, rec in phases.items():
            for role, split in rec.items():
                if role == "stamped_ms":
                    continue
                if role in ("per_warpgroup_ms", "per_warp_ms"):
                    by = ", ".join(f"{n} " + " / ".join(f"{v:.4f}" for v in vs)
                                   for n, vs in split.items())
                else:
                    by = ", ".join(f"{n} {v['ms']:.4f} ({v['share']:.1%})"
                                   for n, v in split.items())
                print(f"{args.kernel} {which} tile pass, stamped {rec['stamped_ms']:.4f} ms, "
                      f"{role}: {by} — {card}")
    return results


def compare(parent, change, kernel, card, dtype="bfloat16"):
    """The turns parent, change, change, parent on the three batches; prints
    each process's RESULT line, a summary per batch and, per batch, whether
    the two trees' first runs gave the same bits (the digests) and, in f32,
    the change's largest error against the parent's outputs."""
    import torch

    results = []
    with tempfile.TemporaryDirectory() as tmp:
        operands = os.path.join(tmp, "operands.pt")
        save_operands(operands, kernel, dtype)
        kept = [os.path.join(tmp, f"outputs{i}.pt") for i in range(2)]
        for i, (tree, label) in enumerate(((parent, "parent"), (change, "change"),
                                           (change, "change"), (parent, "parent"))):
            t0 = time.time()
            env = dict(os.environ, PYTHONPATH=str(tree))
            save = [kept[i]] if dtype == "float32" and i < 2 else []
            run = subprocess.run([sys.executable, __file__, "--one", label, operands] + save,
                                 cwd=tree, env=env, capture_output=True, text=True,
                                 timeout=900)
            line = next((s for s in run.stdout.splitlines() if s.startswith("RESULT ")), None)
            if run.returncode != 0 or line is None:
                raise RuntimeError(f"{label} ({tree}) failed:\n{run.stderr[-4000:]}")
            rec = json.loads(line[len("RESULT "):])
            rec["seconds"] = time.time() - t0
            results.append(rec)
            print(line, flush=True)
        ref, got = ((torch.load(k, weights_only=True) for k in kept) if dtype == "float32"
                    else (None, None))
    for name in BATCHES:
        print(f"{kernel} ({dtype}) {name}: " + ", ".join(
            f"{r['label']} {r[name]['ms']:.4f} ms (" + ", ".join(
                f"{k} {v:.4f}" for k, v in r[name]['split'].items()) + ")" for r in results)
            + f" — {card}")
        same = results[0][name]["digest"] == results[1][name]["digest"]
        line = f"{kernel} ({dtype}) {name}: digests parent {results[0][name]['digest']}, " \
               f"change {results[1][name]['digest']}: " + ("the same bits" if same else "differ")
        if ref is not None:
            err = rel_err(got[name], ref[name])
            results[1][name]["rel_err_vs_parent"] = err
            line += f"; change against parent max|err|/max|parent| = {err:.3e}"
        print(line, flush=True)
    return results


if __name__ == "__main__":
    main()
