"""Structure formats: the (ext)xyz reader and writer, and the ASE, PySCF
and xTB adapters.

Port of ``xequinet_tpu/data/fmt_conversion.py`` (``read_xyz``,
``write_xyz``, ``read_structures`` with its ASE branch, the ASE and PySCF
adapters both ways, and ``datapoint_to_xtb``).  The self-contained extxyz
parser keeps the drivers free of third-party packages, including the
charge / multiplicity comment-line convention; ``ase``, ``pyscf`` and
``tblite`` are imported only in the functions that need them.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import List, Optional, Sequence, TextIO, Union

import numpy as np

from ..utils.qc import ELEMENTS_DICT, ELEMENTS_LIST
from .datapoint import Datapoint


def _parse_comment(comment: str) -> dict:
    """Parse 'charge=0 multiplicity=1' / extxyz Lattice=... key-values."""
    out = {}
    for m in re.finditer(r'(\w+)="([^"]*)"', comment):
        out[m.group(1).lower()] = m.group(2)
    rest = re.sub(r'\w+="[^"]*"', "", comment)
    for m in re.finditer(r"(\w+)=(\S+)", rest):
        out[m.group(1).lower()] = m.group(2)
    return out


def read_xyz(path: Union[str, Path, TextIO], index: Optional[slice] = None) -> List[Datapoint]:
    """Read (ext)xyz frames into Datapoints.

    Supports charge / multiplicity (or spin) in the comment line, extxyz
    ``Lattice="ax ay az bx ..."`` and ``pbc="T T T"``, and per-atom extra
    columns ``Properties=species:S:1:pos:R:3:forces:R:3``.
    """
    if hasattr(path, "read"):
        lines = path.read().splitlines()
    else:
        lines = Path(path).read_text().splitlines()
    frames: List[Datapoint] = []
    i = 0
    while i < len(lines):
        if not lines[i].strip():
            i += 1
            continue
        n = int(lines[i].strip())
        comment = lines[i + 1] if i + 1 < len(lines) else ""
        meta = _parse_comment(comment)
        species, pos, extra_cols = [], [], []
        fields = meta.get("properties", "species:S:1:pos:R:3").split(":")
        col_spec = [(fields[j], fields[j + 1], int(fields[j + 2]))
                    for j in range(0, len(fields), 3)]
        for row in lines[i + 2 : i + 2 + n]:
            toks = row.split()
            col = 0
            rowdata = {}
            for name, _, width in col_spec:
                rowdata[name] = toks[col : col + width]
                col += width
            species.append(rowdata.get("species", [toks[0]])[0])
            pos.append([float(x) for x in rowdata.get("pos", toks[1:4])])
            extra_cols.append(rowdata)
        z = np.array([ELEMENTS_DICT[s] if s in ELEMENTS_DICT else int(s) for s in species],
                     dtype=np.int32)
        kw = {}
        if "charge" in meta:
            kw["charge"] = int(float(meta["charge"]))
        if "multiplicity" in meta:
            kw["spin"] = int(float(meta["multiplicity"])) - 1
        elif "spin" in meta:
            kw["spin"] = int(float(meta["spin"]))
        if "energy" in meta:
            kw["energy"] = float(meta["energy"])
        if "lattice" in meta:
            kw["cell"] = np.array([float(x) for x in meta["lattice"].split()]).reshape(3, 3)
            kw["pbc"] = np.array([t.strip().lower() in ("t", "true", "1")
                                  for t in meta.get("pbc", "T T T").split()])
        if any("forces" in rd for rd in extra_cols):
            kw["forces"] = np.array([[float(x) for x in rd.get("forces", [0, 0, 0])]
                                     for rd in extra_cols])
        frames.append(Datapoint(atomic_numbers=z, pos=np.array(pos), **kw))
        i += 2 + n
    if index is not None:
        frames = frames[index]
    return frames


def write_xyz(
    path: Union[str, Path],
    frames: Sequence[Datapoint],
    forces: Optional[Sequence[np.ndarray]] = None,
    energies: Optional[Sequence[float]] = None,
    append: bool = False,
    comments: Optional[Sequence[str]] = None,
) -> None:
    """Write frames as extxyz."""
    with open(path, "a" if append else "w") as f:
        for k, dp in enumerate(frames):
            f.write(f"{dp.num_atoms}\n")
            parts = []
            if dp.cell is not None:
                lat = " ".join(f"{x:.8f}" for x in dp.cell.reshape(-1))
                parts.append(f'Lattice="{lat}"')
                pbc = " ".join("T" if b else "F" for b in dp.pbc)
                parts.append(f'pbc="{pbc}"')
            props = "Properties=species:S:1:pos:R:3"
            have_f = forces is not None and forces[k] is not None
            if have_f:
                props += ":forces:R:3"
            parts.append(props)
            if energies is not None and energies[k] is not None:
                parts.append(f"energy={energies[k]:.10f}")
            if dp.charge is not None:
                parts.append(f"charge={dp.charge}")
            if comments and comments[k]:
                parts.append(comments[k])
            f.write(" ".join(parts) + "\n")
            for a in range(dp.num_atoms):
                row = f"{ELEMENTS_LIST[int(dp.atomic_numbers[a])]} " + " ".join(
                    f"{x: .8f}" for x in dp.pos[a])
                if have_f:
                    row += " " + " ".join(f"{x: .8f}" for x in forces[k][a])
                f.write(row + "\n")


def read_structures(path: Union[str, Path], fmt: Optional[str] = None) -> List[Datapoint]:
    """Read structures with an optional explicit format: xyz / extxyz (or
    no format for a .xyz / .extxyz path) through the built-in reader, any
    other format through ``ase.io.read`` (raises without ase)."""
    p = str(path)
    if fmt in (None, "xyz", "extxyz") and (
        fmt is not None or p.endswith(".xyz") or p.endswith(".extxyz")
    ):
        return read_xyz(path)
    xyz_err = None
    if fmt is None:
        # unknown extension: the built-in reader first, then ASE
        try:
            return read_xyz(path)
        except Exception as err:
            xyz_err = err
    try:
        from ase import io as ase_io
    except ImportError:
        if xyz_err is not None:
            raise xyz_err  # the real parse failure, not 'no ase'
        raise
    atoms_list = ase_io.read(p, index=":", format=fmt)
    if not isinstance(atoms_list, list):
        atoms_list = [atoms_list]
    return [datapoint_from_ase(a) for a in atoms_list]


def datapoint_from_ase(atoms) -> Datapoint:
    """ASE Atoms -> Datapoint (requires ase)."""
    kw = {}
    if atoms.pbc.any():
        kw["cell"] = np.asarray(atoms.cell)
        kw["pbc"] = np.asarray(atoms.pbc)
    info = atoms.info
    if "charge" in info:
        kw["charge"] = int(info["charge"])
    if "multiplicity" in info:
        kw["spin"] = int(info["multiplicity"]) - 1
    return Datapoint(atomic_numbers=atoms.get_atomic_numbers().astype(np.int32),
                     pos=atoms.get_positions(), **kw)


def datapoint_to_ase(dp: Datapoint):
    """Datapoint -> ASE Atoms (requires ase)."""
    from ase import Atoms

    kw = {}
    if dp.has_cell:
        kw["cell"] = dp.cell
        kw["pbc"] = dp.pbc
    atoms = Atoms(numbers=dp.atomic_numbers, positions=dp.pos, **kw)
    if dp.charge is not None:
        atoms.info["charge"] = int(dp.charge)
    if dp.spin is not None:
        atoms.info["multiplicity"] = int(dp.spin) + 1
    return atoms


def datapoint_from_pyscf(mole) -> Datapoint:
    """PySCF Mole -> Datapoint: element symbols from ``mole.elements``,
    coordinates from ``mole.atom_coords()`` (Bohr) in the model's position
    unit, the net charge and the spin (n_alpha - n_beta)."""
    from .. import keys
    from ..utils.qc import get_default_units, unit_conversion

    pos_unit = get_default_units().get(keys.POSITIONS, "Angstrom")
    pos = np.asarray(mole.atom_coords()) * unit_conversion("Bohr", pos_unit)
    z = np.array([ELEMENTS_DICT[str(s).capitalize()] for s in mole.elements], dtype=np.int32)
    return Datapoint(atomic_numbers=z, pos=pos, charge=int(mole.charge), spin=int(mole.spin))


def datapoint_to_pyscf(dp: Datapoint, basis: str = "sto-3g"):
    """Datapoint -> PySCF Mole, or Cell with a cell (requires pyscf)."""
    from pyscf import gto

    atom = [(ELEMENTS_LIST[int(z)], tuple(p)) for z, p in zip(dp.atomic_numbers, dp.pos)]
    if dp.has_cell:
        from pyscf.pbc import gto as pbcgto

        return pbcgto.Cell(atom=atom, a=dp.cell, basis=basis, unit="Angstrom").build()
    return gto.M(atom=atom, basis=basis, charge=int(dp.charge or 0), spin=int(dp.spin or 0),
                 unit="Angstrom")


def datapoint_to_xtb(dp: Datapoint, method: str = "GFN2-xTB"):
    """Datapoint -> tblite calculator for delta-learning baselines
    (requires tblite)."""
    from tblite.interface import Calculator

    from ..utils.qc import units

    return Calculator(
        method,
        np.asarray(dp.atomic_numbers, dtype=np.int64),
        dp.pos * units["Angstrom"],  # Angstrom -> Bohr
        charge=float(dp.charge or 0),
        uhf=int(dp.spin or 0),
    )
