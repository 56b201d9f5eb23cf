"""Compare two XDB datasets record by record.

Written to hold the port's synthetic-dataset generator against another
generator's output of the same seed (the JAX package's
``tools/make_synthetic_dataset.py``, or the port's on another device):

    python -m xequinet_torch.tools.compare_datasets <dir_a> <dir_b>

Prints as JSON: the record counts, the number of
records whose atom counts or atomic numbers differ, whether the split
files are equal, and over the records with equal atomic numbers the
largest position gap (A), the largest energy gap relative to |E|, and the
largest force gap relative to the record's max |F|, each with the record
that sets it.  Reads only the two directories; needs no device.  The
port's test of the generator against the JAX tool's holds this result.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def compare(dir_a, dir_b):
    from ..data.store import XDBDataset

    a, b = XDBDataset(dir_a), XDBDataset(dir_b)
    z_diff, gaps = [], {}  # record -> (position, energy, force) gaps
    for i in range(min(len(a.reader), len(b.reader))):
        x, y = a.reader[i], b.reader[i]
        if x.num_atoms != y.num_atoms or not np.array_equal(x.atomic_numbers, y.atomic_numbers):
            z_diff.append(i)
            continue
        gaps[i] = (float(np.abs(x.pos - y.pos).max()),
                   abs(float(x.energy) - float(y.energy)) / max(abs(float(y.energy)), 1e-30),
                   float(np.abs(x.forces - y.forces).max()
                         / max(np.abs(y.forces).max(), 1e-30)))
    worst = [max(gaps, key=lambda i: gaps[i][j]) if gaps else None for j in range(3)]
    gap = lambda j: gaps[worst[j]][j] if gaps else None
    split_a = json.loads((Path(dir_a) / "split.json").read_text())
    split_b = json.loads((Path(dir_b) / "split.json").read_text())
    return {
        "records": [len(a.reader), len(b.reader)],
        "atomic_numbers_differ": len(z_diff), "first_differing": z_diff[:10],
        "split_equal": split_a == split_b,
        "max_pos_gap_A": gap(0), "at_record": worst[0],
        "max_energy_gap_rel": gap(1), "energy_at_record": worst[1],
        "max_force_gap_rel_max_F": gap(2), "forces_at_record": worst[2],
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("dir_a")
    ap.add_argument("dir_b")
    args = ap.parse_args(argv)
    print(json.dumps(compare(args.dir_a, args.dir_b), indent=1))


if __name__ == "__main__":
    main()
