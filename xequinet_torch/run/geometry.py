"""``xeq opt``: geometry optimisation, frequencies and thermochemistry.

Port of ``xequinet_tpu/run/geometry.py``.  The built-in engine is scipy's
L-BFGS-B over a ``ForceField`` (one ``Calculator.calculate`` per
evaluation, on the card unless ``device="cpu"``), with ``$freeze``
constraints as coordinate bounds; the analytic Hessian comes from
``Calculator.hessian`` (autograd on the plain route), the numerical one
from central differences of the forces; then a rigid-rotor harmonic
oscillator analysis and the Shermo input file.  geomeTRIC through PySCF
stays an optional engine, imported only when it is asked for.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..data.datapoint import Datapoint
from ..data.fmt_conversion import read_structures, write_xyz
from ..interface.calculator import Calculator
from ..utils.logger import ZeroLogger
from ..utils.qc import ATOM_MASS, unit_conversion
from .dynamics import ForceField

KB_EV = 8.617333262e-5  # eV/K
H_PLANCK_EV_S = 4.135667696e-15  # eV s
C_CM_S = 2.99792458e10  # cm/s
EV_TO_CM1 = 8065.543937
AMU_KG = 1.66053906660e-27
EV_J = 1.602176634e-19
ANG_M = 1e-10


def has_geometric_engine() -> bool:
    """True when the optional PySCF+geomeTRIC optimization engine is
    importable."""
    try:
        import geometric  # noqa: F401
        import pyscf  # noqa: F401
    except ImportError:
        return False
    return True


def xequi_method(mole, ff: ForceField) -> Tuple[float, np.ndarray]:
    """Energy (Hartree) and nuclear gradient (a.u.) at a PySCF Mole's
    geometry, the PySCF-method adapter.  Delta-learning terms attached to
    ``ff.extra_calcs`` are included, so the shim serves both pure-ML and
    delta checkpoints."""
    from ..data.fmt_conversion import datapoint_from_pyscf

    dp = datapoint_from_pyscf(mole)
    e_ev, f_ev = ff(dp.pos)
    energy = float(e_ev) * unit_conversion("eV", "Hartree")
    grad = -np.asarray(f_ev) * unit_conversion("eV/Angstrom", "au")
    return energy, grad


def make_pyscf_method(dp: Datapoint, ff: ForceField):
    """Wrap the ForceField as a PySCF 'fake method' usable anywhere PySCF
    expects one (geomeTRIC optimization, thermochemistry pipelines);
    requires pyscf."""
    from pyscf.geomopt import as_pyscf_method

    from ..data.fmt_conversion import datapoint_to_pyscf

    mole = datapoint_to_pyscf(dp)
    return as_pyscf_method(mole, lambda m: xequi_method(m, ff))


def optimize_geometric(
    ff: ForceField,
    dp: Datapoint,
    constraints: Optional[str],
    max_steps: int,
    options: Optional[Dict] = None,
    logger=None,
) -> Tuple[np.ndarray, float, bool]:
    """Geometry optimization delegated to the geomeTRIC engine through
    PySCF (requires pyscf + geometric): the path that serves full
    geomeTRIC constraint files (distance/angle/dihedral, $set, $scan)."""
    from pyscf.geomopt import geometric_solver

    logger = logger or ZeroLogger()
    fake_method = make_pyscf_method(dp, ff)
    converged, new_mole = geometric_solver.kernel(
        fake_method,
        constraints=constraints,
        maxsteps=max_steps,
        **(options or {}),
    )
    from ..data.fmt_conversion import datapoint_from_pyscf

    pos = datapoint_from_pyscf(new_mole).pos
    e, f = ff(pos)
    logger.info(
        f"geomeTRIC optimization {'converged' if converged else 'NOT converged'}: "
        f"E={e:.6f} eV, max|F|={np.abs(f).max():.4f} eV/A"
    )
    return pos, e, bool(converged)


def parse_constraints(path: str, n_atoms: int) -> np.ndarray:
    """Parse a geomeTRIC-style constraints file.  Supported natively: the
    ``$freeze`` section with ``xyz`` / ``atoms`` atom selections (1-based
    indices, commas and i-j ranges).  Returns a boolean frozen-atom mask
    [n_atoms].

    Other constraint classes (distance/angle/dihedral, $set, $scan) need
    the geomeTRIC engine (run_opt auto-delegates when pyscf + geometric
    are installed) and raise NotImplementedError here.
    """
    frozen = np.zeros(n_atoms, dtype=bool)
    section = None
    with open(path) as f:
        for raw in f:
            line = raw.split("#")[0].strip()
            if not line:
                continue
            if line.startswith("$"):
                section = line[1:].lower()
                continue
            if section != "freeze":
                raise NotImplementedError(
                    f"constraint section '${section}' requires the "
                    "geomeTRIC engine (install geometric + pyscf); the "
                    "built-in optimizer supports $freeze xyz/atoms only"
                )
            parts = line.split()
            kind = parts[0].lower()
            if kind not in ("xyz", "atoms"):
                raise NotImplementedError(
                    f"freeze type '{kind}' requires the geomeTRIC engine; "
                    "built-in support is whole-atom freezing (xyz/atoms)"
                )
            for token in "".join(parts[1:]).split(","):
                if "-" in token:
                    a, b = token.split("-")
                    frozen[int(a) - 1 : int(b)] = True
                else:
                    frozen[int(token) - 1] = True
    return frozen


def optimize(
    ff: ForceField,
    pos0: np.ndarray,
    max_steps: int = 200,
    fmax: float = 0.05,
    frozen: Optional[np.ndarray] = None,
    logger=None,
    options: Optional[Dict] = None,
) -> Tuple[np.ndarray, float, bool]:
    """L-BFGS-B over flattened coordinates; converges when max |F| < fmax
    (eV/A) over the free atoms.  ``frozen`` pins atoms via coordinate
    bounds (the projected-gradient constraint of L-BFGS-B)."""
    from scipy.optimize import minimize

    logger = logger or ZeroLogger()
    state = {"n": 0, "converged": False}
    free = (
        np.ones(len(pos0), dtype=bool) if frozen is None else ~np.asarray(frozen)
    )
    free3 = np.repeat(free, 3)

    def fun(x):
        e, f = ff(x.reshape(-1, 3))
        state["n"] += 1
        state["fmax"] = float(np.abs(f[free]).max()) if free.any() else 0.0
        g = -f.reshape(-1).astype(np.float64)
        g[~free3] = 0.0
        return float(e), g

    def cb(xk):
        # scipy stops cleanly when the callback raises StopIteration
        if state.get("fmax", np.inf) < fmax:
            raise StopIteration

    x0 = pos0.reshape(-1).astype(np.float64)
    bounds = None
    if frozen is not None and frozen.any():
        bounds = [
            (xi, xi) if not fi else (None, None) for xi, fi in zip(x0, free3)
        ]
    res = minimize(
        fun,
        x0,
        jac=True,
        method="L-BFGS-B",
        callback=cb,
        bounds=bounds,
        options={"maxiter": max_steps, "gtol": fmax * 0.01,
                 **(options or {})},
    )
    pos = res.x.reshape(-1, 3)
    e, f = ff(pos)
    converged = bool(np.abs(f[free]).max() < fmax) if free.any() else True
    logger.info(
        f"optimization {'converged' if converged else 'NOT converged'}: "
        f"E={e:.6f} eV, max|F|={np.abs(f[free]).max() if free.any() else 0.0:.4f} eV/A, "
        f"{state['n']} evaluations"
    )
    return pos, e, converged


def analytic_hessian(ff: ForceField, pos: np.ndarray) -> np.ndarray:
    """Analytic [3N, 3N] Hessian in eV/A^2 through ``Calculator.hessian``.
    Valid for pure-ML force fields; delta models (xTB extra terms) need
    the numerical fallback."""
    if ff.extra_calcs:
        raise ValueError("analytic Hessian undefined with extra (xTB) terms; "
                         "use numerical_hessian")
    H = ff.calc.hessian(
        ff.z, pos / ff.l_conv,
        cell=ff.cell / ff.l_conv if ff.cell is not None else None,
        pbc=ff.pbc, charge=ff.charge, spin=ff.spin,
    )
    # model units -> eV/A^2
    return H * ff.e_conv / (ff.l_conv**2)


def numerical_hessian(ff: ForceField, pos: np.ndarray, eps: float = 5e-3) -> np.ndarray:
    """Central-difference Hessian from forces, [3N, 3N] in eV/A^2 (the
    fallback for delta models)."""
    n3 = pos.size
    H = np.zeros((n3, n3))
    flat = pos.reshape(-1)
    for i in range(n3):
        xp = flat.copy()
        xp[i] += eps
        _, fp = ff(xp.reshape(-1, 3))
        xm = flat.copy()
        xm[i] -= eps
        _, fm = ff(xm.reshape(-1, 3))
        H[i] = -(fp - fm).reshape(-1) / (2 * eps)
    return 0.5 * (H + H.T)


def harmonic_analysis(
    hessian: np.ndarray, masses: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Mass-weighted normal-mode analysis.

    Returns (frequencies in cm^-1 — negative entries denote imaginary
    modes — and the mode matrix).
    """
    m = np.repeat(masses, 3)
    Hmw = hessian / np.sqrt(np.outer(m, m))  # eV / (A^2 amu)
    w2, modes = np.linalg.eigh(Hmw)
    # omega^2 [eV/(A^2 amu)] -> angular frequency in s^-1
    conv = EV_J / (ANG_M**2 * AMU_KG)  # to s^-2
    omega = np.sign(w2) * np.sqrt(np.abs(w2) * conv)
    freq_cm = omega / (2 * math.pi * C_CM_S)
    return freq_cm, modes


def thermochemistry(
    freq_cm: np.ndarray,
    energy_ev: float,
    masses: np.ndarray,
    temperature: float = 298.15,
    n_skip: int = 6,
) -> Dict[str, float]:
    """Ideal-gas RRHO thermochemistry (ZPE, thermal corrections).

    Vibrational modes: the 3N-6 (or 3N-5) largest |freq| after dropping
    translations/rotations; imaginary modes are skipped with a count.
    """
    order = np.argsort(np.abs(freq_cm))
    vib = freq_cm[order[n_skip:]]
    imag = int(np.sum(vib < -10.0))
    vib = vib[vib > 10.0]
    hv = vib * 1.0 / EV_TO_CM1  # eV per quantum
    kt = KB_EV * temperature
    zpe = float(0.5 * hv.sum())
    x = hv / kt
    e_vib = float(np.sum(hv / np.expm1(x)))
    s_vib = float(KB_EV * np.sum(x / np.expm1(x) - np.log1p(-np.exp(-x))))
    return {
        "E_el (eV)": energy_ev,
        "ZPE (eV)": zpe,
        "E_vib_thermal (eV)": e_vib,
        "S_vib (eV/K)": s_vib,
        "n_imaginary": imag,
        "E_tot (eV)": energy_ev + zpe + e_vib,
    }


def to_shermo(
    path: str,
    atomic_numbers: np.ndarray,
    pos_ang: np.ndarray,
    energy_ev: float,
    wavenums_cm1: np.ndarray,
) -> None:
    """Shermo input file: electronic energy in Hartree, wavenumbers in
    cm^-1 (imaginary as negative), element/mass/coordinate table in
    Angstrom, ground electronic level."""
    from ..utils.qc import ELEMENTS_LIST

    e_hartree = energy_ev * unit_conversion("eV", "Hartree")
    masses = ATOM_MASS[atomic_numbers]
    with open(path, "w") as f:
        f.write(f"*E\n    {e_hartree:10.6f}\n")
        f.write("*wavenum\n")
        for w in np.asarray(wavenums_cm1):
            f.write(f"    {float(w):8.4f}\n")
        f.write("*atoms\n")
        for z, m, c in zip(atomic_numbers, masses, pos_ang):
            f.write(
                f"{ELEMENTS_LIST[int(z)]: <2} {m:10.6f} "
                f"{c[0]:10.6f} {c[1]:10.6f} {c[2]:10.6f}\n"
            )
        f.write("*elevel\n    0.000000   1\n")


def run_opt(
    ckpt_file: str,
    input_file: str,
    output_file: Optional[str] = None,
    max_steps: int = 200,
    fmax: float = 0.05,
    freq: bool = False,
    temperature: float = 298.15,
    delta_method: Optional[str] = None,
    constraints: Optional[str] = None,
    shermo: bool = False,
    save_hessian: bool = False,
    no_opt: bool = False,
    input_format: Optional[str] = None,
    opt_params: Optional[str] = None,
    engine: str = "auto",
    logger=None,
    device=None,
) -> List[Dict]:
    """``engine``: "native" = built-in L-BFGS-B ($freeze constraints
    only), "geometric" = delegate to geomeTRIC via PySCF (full constraint
    files), "auto" = native unless the constraint file needs geomeTRIC
    and the engine is installed.  ``device``: None = the card."""
    logger = logger or ZeroLogger()
    calc = Calculator(ckpt_file, device=device)
    frames = read_structures(input_file, input_format)
    # extra scipy L-BFGS-B options from a JSON file
    opt_options = None
    if opt_params:
        import json

        with open(opt_params) as f:
            opt_options = json.load(f)
    results = []
    opt_frames, opt_energies = [], []
    stem = input_file.rsplit(".", 1)[0]
    for i, dp in enumerate(frames):
        ff = ForceField(
            calc, dp.atomic_numbers,
            cell=dp.cell if dp.has_cell else None,
            pbc=dp.pbc if dp.has_cell else None,
            charge=dp.charge, spin=dp.spin,
        )
        if delta_method:
            from ..data.fmt_conversion import datapoint_to_xtb

            def xtb_extra(pos_ang, _dp=dp):
                d = Datapoint(_dp.atomic_numbers, pos_ang, charge=_dp.charge,
                              spin=_dp.spin)
                res = datapoint_to_xtb(d, method=delta_method).singlepoint()
                h2ev = unit_conversion("Hartree", "eV")
                b2a = unit_conversion("Bohr", "Angstrom")
                return res.get("energy") * h2ev, -res.get("gradient") * h2ev / b2a

            ff.extra_calcs.append(xtb_extra)
        use_geometric = engine == "geometric"
        if use_geometric and not has_geometric_engine():
            raise ImportError(
                "engine='geometric' requires pyscf + geometric installed"
            )
        frozen = None
        if constraints and not use_geometric:
            try:
                frozen = parse_constraints(constraints, len(dp.atomic_numbers))
            except NotImplementedError:
                if engine == "native" or not has_geometric_engine():
                    raise
                logger.info(
                    "constraint file needs the geomeTRIC engine; "
                    "delegating optimization to geomeTRIC via PySCF"
                )
                use_geometric = True
        if no_opt:
            pos = dp.pos.copy()
            e, _ = ff(pos)
            converged = True
        elif use_geometric:
            pos, e, converged = optimize_geometric(
                ff, dp, constraints, max_steps, options=opt_options,
                logger=logger,
            )
        else:
            pos, e, converged = optimize(
                ff, dp.pos, max_steps, fmax, frozen=frozen, logger=logger,
                options=opt_options,
            )
        entry = {"energy": e, "converged": converged, "positions": pos}
        if freq:
            masses = ATOM_MASS[dp.atomic_numbers]
            # analytic for pure-ML; numerical central differences when an
            # xTB delta term is attached
            H = numerical_hessian(ff, pos) if ff.extra_calcs else analytic_hessian(ff, pos)
            freqs, _ = harmonic_analysis(H, masses)
            thermo = thermochemistry(freqs, e, masses, temperature)
            entry["frequencies_cm1"] = freqs
            entry["thermo"] = thermo
            logger.info(
                f"structure {i}: frequencies (cm^-1): "
                + ", ".join(f"{f:.1f}" for f in freqs[-min(len(freqs), 9):])
            )
            logger.info(
                "thermo: " + ", ".join(f"{k}={v}" for k, v in thermo.items())
            )
            suffix = "" if len(frames) == 1 else str(i)
            if shermo:
                to_shermo(f"{stem}_freq{suffix}.shm", dp.atomic_numbers, pos,
                          e, freqs)
                logger.info(f"shermo input written to {stem}_freq{suffix}.shm")
            if save_hessian:
                np.savetxt(f"{stem}_h{suffix}.txt", H)
        results.append(entry)
        opt_frames.append(
            Datapoint(dp.atomic_numbers, pos,
                      cell=dp.cell if dp.has_cell else None,
                      pbc=dp.pbc if dp.has_cell else None)
        )
        opt_energies.append(e)
    if output_file:
        write_xyz(output_file, opt_frames, energies=opt_energies)
        logger.info(f"optimized structures written to {output_file}")
    return results


def run_opt_from_args(args) -> List[Dict]:
    return run_opt(
        args.ckpt,
        args.input,
        output_file=getattr(args, "output", None),
        max_steps=args.max_steps,
        fmax=args.fmax,
        freq=getattr(args, "freq", False),
        temperature=getattr(args, "temp", 298.15),
        delta_method=getattr(args, "delta", None),
        constraints=getattr(args, "constraints", None),
        input_format=getattr(args, "format", None),
        opt_params=getattr(args, "opt_params", None),
        engine=getattr(args, "engine", "auto"),
        shermo=getattr(args, "shermo", False),
        save_hessian=getattr(args, "save_hessian", False),
        no_opt=getattr(args, "no_opt", False),
        device=getattr(args, "device", None),
    )
