"""Generate a physically-structured synthetic dataset for accuracy studies.

Port of the JAX package's ``tools/make_synthetic_dataset.py``.  The labels
come from an explicit many-body empirical PES: species-dependent Morse
pairs (Lorentz-Berthelot mixing over per-element well depths and radii,
cosine cutoff) plus an Axilrod-Teller-Muto triple-dipole 3-body term.
Energies are computed in torch float32 (as the JAX tool computes them with
x64 off) and forces are their exact autograd gradient, so F = -dE/dR holds
to machine precision.

Configurations are random packed clusters relaxed for a few
steepest-descent steps on the same PES, then thermally perturbed.  The
numpy draws are the JAX tool's, in the same order, so a seed gives the
same atomic numbers and (up to f32 rounding in the descent) the same
positions and labels.  Output is an XDB dataset directory (info.json +
split.json) consumable by ``xeq-torch train``.

Usage:
    python -m xequinet_torch.tools.make_synthetic_dataset <dst_dir> [--n 3000]
        [--atoms 8 20] [--seed 7] [--elements hcno|extended] [--device cpu]

The PES runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

# per-element Morse parameters (eV / Angstrom), loosely tracking covalent
# trends for H, C, N, O (+ F, P, S with --elements extended)
ELEMENTS = np.array([1, 6, 7, 8], dtype=np.int32)
ELEMENT_P = [0.4, 0.3, 0.15, 0.15]
D_E = {1: 0.8, 6: 1.6, 7: 1.4, 8: 1.2,
       9: 1.0, 15: 1.5, 16: 1.3}  # well depth, eV
R_E = {1: 0.9, 6: 1.5, 7: 1.4, 8: 1.3,
       9: 1.2, 15: 1.9, 16: 1.8}  # equilibrium radius, Angstrom
A_E = {1: 2.2, 6: 1.8, 7: 1.9, 8: 2.0,
       9: 2.3, 15: 1.6, 16: 1.7}  # stiffness, 1/Angstrom
C9 = 0.25  # ATM 3-body strength, eV * Angstrom^9
R_CUT = 5.0


def use_extended_elements():
    """Widen the element set to H, C, N, O, F, P, S."""
    global ELEMENTS, ELEMENT_P
    ELEMENTS = np.array([1, 6, 7, 8, 9, 15, 16], dtype=np.int32)
    ELEMENT_P = [0.34, 0.26, 0.12, 0.12, 0.06, 0.04, 0.06]


def _tables():
    zmax = int(ELEMENTS.max()) + 1
    d = np.zeros(zmax)
    r = np.zeros(zmax)
    a = np.zeros(zmax)
    for z in ELEMENTS:
        d[z], r[z], a[z] = D_E[int(z)], R_E[int(z)], A_E[int(z)]
    return d, r, a


def make_energy_fn(device=None):
    """``efn(pos, z) -> (E, dE/dR)``: the PES in float32 on ``device``
    (None: the card; without one that raises unless the caller asks for
    the CPU).  ``pos`` [n, 3] and ``z`` [n] are host arrays; E is a 0-d
    tensor and dE/dR an [n, 3] tensor on the device."""
    from ..run.inference import resolve_device

    dev = resolve_device(device)
    d_t, r_t, a_t = (torch.as_tensor(t, dtype=torch.float32, device=dev) for t in _tables())

    def energy(pos, z):
        n = pos.shape[0]
        diff = pos[:, None, :] - pos[None, :, :]
        r2 = torch.sum(diff * diff, dim=-1)
        iu = tuple(torch.triu_indices(n, n, offset=1, device=pos.device))
        rij = torch.sqrt(r2[iu] + 1e-12)
        # Lorentz-Berthelot mixing
        dd = torch.sqrt(d_t[z][:, None] * d_t[z][None, :])[iu]
        rr = 0.5 * (r_t[z][:, None] + r_t[z][None, :])[iu]
        aa = 0.5 * (a_t[z][:, None] + a_t[z][None, :])[iu]
        # smooth cutoff (cosine) so the PES is strictly short-ranged
        fc = torch.where(rij < R_CUT, 0.5 * (torch.cos(torch.pi * rij / R_CUT) + 1.0),
                         torch.zeros_like(rij))
        x = torch.exp(-aa * (rij - rr))
        e_pair = torch.sum(dd * (x * x - 2.0 * x) * fc)
        # Axilrod-Teller-Muto triple-dipole (3-body)
        eye = torch.eye(n, dtype=pos.dtype, device=pos.device)
        r_safe = torch.sqrt(r2 + eye)
        inv = torch.where(eye.bool(), torch.zeros_like(r_safe), 1.0 / r_safe)
        cosp = torch.einsum("ijk,ilk->ijl", diff, diff) * (inv[:, :, None] * inv[:, None, :])
        atm = (1.0 + cosp * cosp.permute(1, 2, 0) * cosp.permute(2, 0, 1)) * (
            inv[:, :, None] * inv[None, :, :] * inv[:, None, :]) ** 3
        # each unordered triple appears 6 times in the full tensor
        e_three = C9 * torch.sum(atm) / 6.0
        return e_pair + e_three

    def efn(pos, z):
        p = torch.as_tensor(np.asarray(pos), dtype=torch.float32, device=dev)
        p.requires_grad_(True)
        zt = torch.as_tensor(np.asarray(z), dtype=torch.long, device=dev)
        with torch.enable_grad():
            e = energy(p, zt)
            g, = torch.autograd.grad(e, p)
        return e.detach(), g

    return efn


def random_cluster(rng, n):
    z = rng.choice(ELEMENTS, size=n, p=ELEMENT_P).astype(np.int32)
    # sequential insertion with a minimum-distance constraint
    pos = [np.zeros(3)]
    while len(pos) < n:
        cand = rng.normal(scale=0.75 * n ** (1 / 3), size=3)
        dmin = min(np.linalg.norm(cand - p) for p in pos)
        if 0.75 < dmin < 4.0:
            pos.append(cand)
    return z, np.asarray(pos)


def _descend(efn, pos, z, steps):
    """``steps`` steepest-descent steps of at most 0.05 A per atom."""
    for _ in range(steps):
        _, g = efn(pos, z)
        g = g.cpu().numpy()
        gn = np.linalg.norm(g, axis=-1, keepdims=True)
        pos = pos - 0.05 * g / np.maximum(gn, 1.0)
    return pos


def generate(n_structures, atoms, seed, device=None, report_every=500):
    """(datapoints, split): the JAX tool's clusters, labels and 80/10/10
    split, drawn from ``np.random.default_rng(seed)``."""
    from ..data.datapoint import Datapoint

    efn = make_energy_fn(device)
    rng = np.random.default_rng(seed)
    dps = []
    while len(dps) < n_structures:
        n = int(rng.integers(atoms[0], atoms[1] + 1))
        z, pos = random_cluster(rng, n)
        # a few steepest-descent steps to pull out of the repulsive wall
        pos = _descend(efn, pos, z, 8)
        # thermal perturbation (~300-1500 K displacement scale)
        pos = pos + rng.normal(scale=rng.uniform(0.03, 0.12), size=pos.shape)
        e, g = efn(pos, z)
        e, g = float(e), g.cpu().numpy()
        if not np.isfinite(e) or not np.all(np.isfinite(g)):
            continue
        if np.abs(g).max() > 50.0:  # reject pathological overlaps
            continue
        dps.append(Datapoint(z, pos, energy=e, forces=-g))
        if report_every and len(dps) % report_every == 0:
            print(f"{len(dps)}/{n_structures}", flush=True)

    idx = rng.permutation(len(dps))
    n_tr = int(0.8 * len(dps))
    n_va = int(0.1 * len(dps))
    split = {
        "train": idx[:n_tr].tolist(),
        "valid": idx[n_tr : n_tr + n_va].tolist(),
        "test": idx[n_tr + n_va :].tolist(),
    }
    return dps, split


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("dst")
    ap.add_argument("--n", type=int, default=3000)
    ap.add_argument("--atoms", type=int, nargs=2, default=(8, 20))
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--elements", choices=["hcno", "extended"], default="hcno")
    ap.add_argument("--device", default=None,
                    help="where the PES runs: cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.elements == "extended":
        use_extended_elements()

    from ..data.store import create_dataset

    dps, split = generate(args.n, args.atoms, args.seed, device=args.device)
    create_dataset(
        args.dst, dps,
        units={"energy": "eV", "pos": "Angstrom", "forces": "eV/Angstrom"},
        split=split,
    )
    print(f"wrote {len(dps)} structures to {args.dst}")


def sample_structure(rng, n_atoms=24, relax_steps=40, device=None):
    """One relaxed cluster on the true PES (for MD studies)."""
    from ..data.datapoint import Datapoint

    efn = make_energy_fn(device)
    z, pos = random_cluster(rng, n_atoms)
    return Datapoint(z, _descend(efn, pos, z, relax_steps))


if __name__ == "__main__":
    main()
