"""``message_bwd`` of two source trees timed in turns on one card.

This process, in the tree this file belongs to (the change), builds the
operands of three batches once with its own code and saves them to a
temporary file:

* the stream-floor probe's batch (``bwd_stream_floor.problem``, bench.py's
  ``build_batch`` recipe at ``default_rng(0)``),
* the same recipe at ``default_rng(1234)``, bench.py's flagship batch,
* shard 0 of 4 of chip_smoke's 10,000-atom periodic box in
  HaloCalculator's layout (block_nodes 256, chunk 1024).

Each tree (a checkout of the repo, e.g. a parent commit unpacked with
``git archive``) is then imported in a process of its own, in the order
parent, change, change, parent, so that both run on the same card at the
same power limit and drift shows as the distance between a tree's own
runs.  Each process loads the same operands and the same pass names onto
the card and times its tree's ``message_bwd_cuda`` (bf16) with this
file's tree's ``bwd_stream_floor.time_calls`` and ``pass_split`` (loaded
by path): two more warm-up calls, then the median of 3 repetitions of 20
calls (CUDA events) after its own warm-up, and the split by pass
(torch.profiler).  Usage, from the root of the change's tree:

    python -m xequinet_torch.tools.bwd_compare PARENT_ROOT [CHANGE_ROOT]

It prints one ``RESULT {...}`` JSON line per process and the card's name
and power limit.  It needs a card.
"""

from __future__ import annotations

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


def save_operands(path):
    """The three batches' ``message_bwd_cuda`` arguments, built on the CPU
    by this tree's code, and this tree's pass names of ``message_bwd``."""
    import torch

    from xequinet_torch.ops import fused_message as fm
    from xequinet_torch.tools import bwd_stream_floor as bsf

    cpu = torch.device("cpu")
    batches = {"probe": bsf._args(bsf.problem(cpu)),
               "flagship": bsf._args(bsf.problem(cpu, seed=1234)),
               "halo_shard0": halo_shard0(cpu, bsf.IRREPS, bsf.NUM_BASIS, bsf.NODE_DIM)}
    torch.save({"batches": batches, "passes": fm.PASSES["message_bwd"]}, path)


def _to(obj, dev):
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if isinstance(obj, tuple):
        return tuple(_to(o, dev) for o in obj)
    if isinstance(obj, dict):
        return {k: _to(v, dev) for k, v in obj.items()}
    return obj


def measure_tree(label, operands):
    """One process's measurement of the xequinet_torch on sys.path, on the
    saved operands, timed by this file's tree's tool."""
    import torch

    from xequinet_torch.ops import cuda_build
    from xequinet_torch.ops import fused_message as fm

    spec = importlib.util.spec_from_file_location("_bwd_timing", TOOL)
    timing = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timing)
    dev = torch.device("cuda")
    cuda_build.build_kernels(["message_bwd"])
    saved = torch.load(operands, weights_only=True)
    out = {"label": label, "package": str(Path(fm.__file__).parents[1])}
    for name in BATCHES:
        args = _to(saved["batches"][name], dev)
        fn = lambda: fm.message_bwd_cuda(*args)
        fn(), fn()
        ms = timing.time_calls(fn)
        split, _ = timing.pass_split(fn, saved["passes"])
        out[name] = {"ms": ms, "split": split, "split_share": sum(split.values()) / ms}
        del args
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--one"]:  # a child process: the tree is on PYTHONPATH
        print("RESULT " + json.dumps(measure_tree(argv[1], argv[2])), flush=True)
        return None
    parent = Path(argv[0]).resolve()
    change = Path(argv[1]).resolve() if len(argv) > 1 else ROOT
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(card, flush=True)
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        operands = os.path.join(tmp, "operands.pt")
        save_operands(operands)
        for tree, label in ((parent, "parent"), (change, "change"), (change, "change"),
                            (parent, "parent")):
            t0 = time.time()
            env = dict(os.environ, PYTHONPATH=str(tree))
            run = subprocess.run([sys.executable, __file__, "--one", label, operands], cwd=tree,
                                 env=env, capture_output=True, text=True, timeout=900)
            line = next((s for s in run.stdout.splitlines() if s.startswith("RESULT ")), None)
            if run.returncode != 0 or line is None:
                raise RuntimeError(f"{label} ({tree}) failed:\n{run.stderr[-4000:]}")
            rec = json.loads(line[len("RESULT "):])
            rec["seconds"] = time.time() - t0
            results.append(rec)
            print(line, flush=True)
    for name in BATCHES:
        print(f"{name}: " + ", ".join(f"{r['label']} {r[name]['ms']:.4f} ms (tile pass "
                                      f"{r[name]['split'].get('tile pass', float('nan')):.4f})"
                                      for r in results) + f" — {card}")
    return results


if __name__ == "__main__":
    main()
