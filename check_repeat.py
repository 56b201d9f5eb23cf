"""Repeat two of ``chip_smoke.py``'s checks on the card, with PyTorch's
default sums and under its deterministic algorithms, and print each run's
reading: whether a check can change its verdict between runs of unchanged
code.

* ``hessian``: phase 10 (d)'s analytic against numerical Hessian; the
  reading is the largest excess over the limit (> 0: the check misses).
* ``heads``: phase 8 (c)'s bf16 heads, the mega route against the plain
  route on phase 3's molecules; the reading is each head's error (limit
  2e-2).

    python3 check_repeat.py [--check hessian heads] [--repeats N]

Needs a card; prints the card's name and power limit beside the results.
"""

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

import chip_smoke as cs


def summary(tag, mode, values, limit, card):
    missed = sum(v > limit for v in values)
    print(f"[repeat] {tag}, {mode}: {missed} of {len(values)} runs past {limit:g}; min "
          f"{min(values):.6e}, median {float(np.median(values)):.6e}, max {max(values):.6e} "
          f"— {card}")


def repeat_hessian(device, tmp, repeats, card):
    ck = os.path.join(tmp, "round2.ckpt")
    for det in (False, True):
        mode = "deterministic sums" if det else "default sums"
        excess = []
        for i in range(repeats):
            with cs.deterministic_sums(det):
                e, line = cs.hessian_vs_numerical(device, ck)
            excess.append(e)
            print(f"[repeat] hessian, {mode}, run {i}: {line}")
        summary("hessian excess", mode, excess, 0.0, card)


def repeat_heads(device, repeats, card):
    dpc, eng, eng_t = cs.multihead_inputs(cs.build_molecules(1024), device, cs.EWALD_SIZES)
    mega_b, plain_b = eng.collate(dpc), eng_t["plain"].collate(dpc)
    n_g, n_at = len(dpc), sum(d.num_atoms for d in dpc)
    for det in (False, True):
        mode = "deterministic sums" if det else "default sums"
        runs = []
        for i in range(repeats):
            with cs.deterministic_sums(det):
                errs = cs.head_errors(eng.forward_batch(mega_b),
                                      eng_t["plain"].forward_batch(plain_b), n_g, n_at, False)
            runs.append(errs)
            print(f"[repeat] heads, {mode}, run {i}: "
                  + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
        for k in runs[0]:
            summary(f"heads {k}", mode, [r[k] for r in runs], cs.TOL["bfloat16"], card)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", nargs="+", choices=("hessian", "heads"),
                    default=["hessian", "heads"])
    ap.add_argument("--repeats", type=int, default=8)
    args = ap.parse_args()
    card = cs.card_line()
    if not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        if "hessian" in args.check:
            repeat_hessian(device, tmp, args.repeats, card)
        if "heads" in args.check:
            repeat_heads(device, args.repeats, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
