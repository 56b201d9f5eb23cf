"""Units, element data and xTB-basis atom embeddings.

Copy of ``xequinet_tpu/utils/qc.py:25-244`` (numpy only): a CODATA-2018
atomic-unit algebra where every unit is a float in atomic units and
arithmetic unit expressions such as "eV/Ang^2" are parsed and evaluated;
the element tables (symbols, ground-state multiplicities, masses); and
the per-element embedding tables of the fixed-table atom embedding (each
element's xTB AO basis projected onto an auxiliary basis), read from the
``.npz`` copies in ``utils/pre_computed``.  A missing table is generated
by ``gen_int2c1e`` from the xTB and auxiliary basis files in
``utils/basis`` (copies of the JAX package's), which needs PySCF, or
converted from a torch-saved dict by ``convert_torch_table``.
"""

from __future__ import annotations

import re
from functools import lru_cache
from math import pi
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from .. import keys


def gen_units_dict() -> Dict[str, float]:
    """All units as floats in atomic units (CODATA 2018)."""
    _c = 299792458.0  # speed of light, m/s (exact)
    _mu0 = 4.0e-7 * pi  # permeability of vacuum
    _hplanck = 6.62607015e-34  # Planck constant (exact)
    _e = 1.602176634e-19  # elementary charge (exact)
    _me = 9.1093837015e-31  # electron mass
    _NA = 6.02214076e23  # Avogadro number (exact)
    _amu = 1.66053906660e-27  # atomic mass unit, kg

    _eps0 = 1 / _mu0 / _c**2
    _hbar = _hplanck / (2 * pi)

    u: Dict[str, float] = {}
    u["AU"] = u["au"] = 1.0
    u["mol"] = _NA
    u["e"] = 1.0
    u["Coulomb"] = u["C"] = 1 / _e
    u["Bohr"] = u["a0"] = 1.0
    u["meter"] = u["m"] = (_me * _e**2) / (4 * pi * _eps0 * _hbar**2)
    u["Angstrom"] = u["Ang"] = u["m"] * 1e-10
    u["cm"] = u["m"] * 1e-2
    u["nm"] = u["Angstrom"] * 10
    u["kg"] = 1 / _amu
    u["g"] = u["kg"] * 1e-3
    u["Hartree"] = u["Ha"] = u["Eh"] = 1.0
    u["Joule"] = u["J"] = (4 * pi * _eps0 * _hbar) ** 2 / (_me * _e**4)
    u["kJoule"] = u["kJ"] = u["J"] * 1000
    u["eV"] = u["J"] * _e
    u["meV"] = u["eV"] / 1000
    u["cal"] = u["J"] * 4.184
    u["kcal"] = u["cal"] * 1000
    u["Debye"] = u["D"] = _me * _e / (1e21 * 4 * pi * _eps0 * _hbar**2 * _c)
    u["second"] = u["s"] = (_me * _e**4) / (4 * pi * _eps0) ** 2 / _hbar**3
    u["fs"] = u["s"] * 1e-15
    u["ps"] = u["fs"] * 1000
    u["Pascal"] = u["Pa"] = u["J"] / u["m"] ** 3
    u["GPa"] = u["Pa"] * 1e9
    u["bar"] = u["Pa"] * 1e5
    u["kbar"] = u["bar"] * 1e3
    u["Bohr_magneton"] = u["muB"] = 0.5
    return u


units = gen_units_dict()

DEFAULT_UNITS_MAP: Dict[str, str] = {
    keys.POSITIONS: "Angstrom",
}


def check_unit(unit: str) -> bool:
    """Check that a unit expression only contains known units / digits."""
    for tok in re.split(r"[+\-*/^()\s]", unit):
        if tok == "" or tok in units or tok.isdigit():
            continue
        return False
    return True


def eval_unit(unit: str) -> float:
    if not check_unit(unit):
        raise ValueError(f"Invalid unit {unit}")
    expr = unit.replace("^", "**")
    return float(eval(expr, {"__builtins__": {}}, units))


def unit_conversion(unit_in: Optional[str], unit_out: Optional[str]) -> float:
    if unit_in is None or unit_out is None or unit_in == unit_out:
        return 1.0
    return eval_unit(unit_in) / eval_unit(unit_out)


def set_default_units(unit_dict: Dict[str, str]) -> None:
    """Set the model's internal unit system (reference qc.py:117-144)."""
    for prop, unit in unit_dict.items():
        if prop in keys.GRAD_PROPERTIES:
            raise ValueError(
                "Do not set units for gradient properties directly; set the "
                "units of the corresponding base property instead."
            )
        if prop in keys.BASE_PROPERTIES:
            raise ValueError(
                "Do not set units for base properties directly; set the "
                "units of the corresponding property instead."
            )
        if prop == keys.ATOMIC_CHARGES:
            raise ValueError(
                "Do not set units for atomic charges; set the charge instead."
            )
        if not check_unit(unit):
            raise ValueError(f"Invalid unit {unit} for property {prop}")
    DEFAULT_UNITS_MAP.update(unit_dict)
    if keys.TOTAL_ENERGY in DEFAULT_UNITS_MAP:
        energy_unit = DEFAULT_UNITS_MAP[keys.TOTAL_ENERGY]
        pos_unit = DEFAULT_UNITS_MAP[keys.POSITIONS]
        DEFAULT_UNITS_MAP[keys.FORCES] = f"{energy_unit}/{pos_unit}"
        DEFAULT_UNITS_MAP[keys.VIRIAL] = f"{energy_unit}/{pos_unit}^3"
    if keys.TOTAL_CHARGE in DEFAULT_UNITS_MAP:
        DEFAULT_UNITS_MAP[keys.ATOMIC_CHARGES] = DEFAULT_UNITS_MAP[keys.TOTAL_CHARGE]
    for base_prop, prop in keys.BASE_PROPERTIES.items():
        if prop in DEFAULT_UNITS_MAP:
            DEFAULT_UNITS_MAP[base_prop] = DEFAULT_UNITS_MAP[prop]


def get_default_units() -> Dict[str, str]:
    return dict(DEFAULT_UNITS_MAP)


THIS_FOLDER = Path(__file__).parent
PRE_FOLDER = THIS_FOLDER / "pre_computed"

# fmt: off
ELEMENTS_LIST = ['d',
  'H',                                                                                                  'He',
  'Li', 'Be',                                                             'B',  'C',  'N',  'O',  'F',  'Ne',
  'Na', 'Mg',                                                             'Al', 'Si', 'P',  'S',  'Cl', 'Ar',
  'K',  'Ca', 'Sc', 'Ti', 'V',  'Cr', 'Mn', 'Fe', 'Co', 'Ni', 'Cu', 'Zn', 'Ga', 'Ge', 'As', 'Se', 'Br', 'Kr',
  'Rb', 'Sr', 'Y',  'Zr', 'Nb', 'Mo', 'Tc', 'Ru', 'Rh', 'Pd', 'Ag', 'Cd', 'In', 'Sn', 'Sb', 'Te', 'I',  'Xe',
  'Cs', 'Ba',
        'La', 'Ce', 'Pr', 'Nd', 'Pm', 'Sm', 'Eu', 'Gd', 'Tb', 'Dy', 'Ho', 'Er', 'Tm', 'Yb', 'Lu',
        'Hf', 'Ta', 'W',  'Re', 'Os', 'Ir', 'Pt', 'Au', 'Hg', 'Tl', 'Pb', 'Bi', 'Po', 'At', 'Rn',
]
ELEMENTS_DICT = {e: i for i, e in enumerate(ELEMENTS_LIST)}
ATOM_MULT = [-1,
  2,                                                 1,
  2, 1,                               2, 3, 4, 3, 2, 1,
  2, 1,                               2, 3, 4, 3, 2, 1,
  2, 1, 2, 3, 4, 7, 6, 5, 4, 3, 2, 1, 2, 3, 4, 3, 2, 1,
  2, 1, 2, 3, 6, 7, 6, 5, 4, 1, 2, 1, 2, 3, 4, 3, 2, 1,
  2, 1,
        2, 3, 4, 5, 6, 7, 8, 9, 6, 5, 4, 3, 2, 1, 2,
        3, 4, 5, 6, 5, 4, 3, 2, 1, 2, 3, 4, 3, 2, 1,
]
ATOM_MASS = np.array([0.0,
    1.008,                                                                                                                 4.003,
    6.941, 9.012,                                                                       10.81, 12.01, 14.01, 16.00, 19.00, 20.18,
    22.99, 24.31,                                                                       26.98, 28.09, 30.97, 32.06, 35.45, 39.95,
    39.10, 40.08, 44.96, 47.87, 50.94, 52.00, 54.94, 55.85, 58.93, 58.69, 63.55, 65.38, 69.72, 72.63, 74.92, 78.96, 79.90, 83.80,
    85.47, 87.62, 88.91, 91.22, 92.91, 95.96, 98.,   101.1, 102.9, 106.4, 107.9, 112.4, 114.8, 118.7, 121.8, 127.6, 126.9, 131.3,
    132.9, 137.3,
                  138.9, 140.1, 140.9, 144.2, 145.,  150.4, 152.0, 157.3, 158.9, 162.5, 164.9, 167.3, 168.9, 173.1, 175.0,
                  178.5, 180.9, 183.8, 186.2, 190.2, 192.2, 195.1, 197.0, 200.6, 204.4, 207.2, 209.,  210.,  210.,  222.,
])
# fmt: on


BASIS_FOLDER = THIS_FOLDER / "basis"


def _save_table(rows, embed_basis: str, aux_basis: str) -> Path:
    """Write ``rows`` (one per element of ``ELEMENTS_LIST[1:]``) as
    ``<embed>_<aux>.npz`` under ``PRE_FOLDER`` with a zero padding row 0,
    and drop ``get_embedding_table``'s cached tables."""
    table = np.stack(rows)
    table = np.concatenate([np.zeros((1, table.shape[-1])), table])
    PRE_FOLDER.mkdir(exist_ok=True)
    out = PRE_FOLDER / f"{embed_basis}_{aux_basis}.npz"
    np.savez(out, table=table)
    get_embedding_table.cache_clear()
    return out


def gen_int2c1e(embed_basis: str = "gfn2-xtb", aux_basis: str = "aux56") -> Path:
    """Generate per-element embedding vectors by projecting each element's
    AO basis onto an auxiliary basis via PySCF overlap integrals
    (``xequinet_tpu/utils/qc.py:175-210``).  Requires pyscf (ImportError
    without it); the xTB and auxiliary basis files ship in
    ``utils/basis``, and an ``embed_basis`` without a file there is passed
    to PySCF by name.  Saves <embed>_<aux>.npz and returns its path."""
    from pyscf import gto

    basis = (
        str(BASIS_FOLDER / f"{embed_basis}.dat")
        if (BASIS_FOLDER / f"{embed_basis}.dat").exists()
        else embed_basis
    )
    orbaux = str(BASIS_FOLDER / f"{aux_basis}.dat")
    aux = gto.M(atom="X 0 0 0", basis={"X": orbaux})
    nao_aux = aux.nao
    ao_loc_nr = aux.ao_loc_nr()[:-1]

    rows = []
    for atom, mult in zip(ELEMENTS_LIST[1:], ATOM_MULT[1:]):
        mol = gto.M(
            atom=f"X 0 0 0; {atom} 0 0 0",
            basis={"X": orbaux, atom: basis},
            spin=mult - 1,
        )
        ovlp = mol.intor("int1e_ovlp")
        projection = ovlp[:nao_aux, nao_aux:]
        embedding = np.sum(projection, axis=-1)
        rows.append(embedding[ao_loc_nr])
    return _save_table(rows, embed_basis, aux_basis)


def convert_torch_table(pt_file: str, embed_basis: str, aux_basis: str) -> Path:
    """Convert a torch-saved embedding dict (element symbol -> 1-D tensor,
    every element of ``ELEMENTS_LIST[1:]``) to ``<embed>_<aux>.npz`` under
    ``PRE_FOLDER`` (``xequinet_tpu/utils/qc.py:213-225``); returns its
    path."""
    import torch

    d = torch.load(pt_file, map_location="cpu", weights_only=False)
    rows = [np.asarray(d[atom], dtype=np.float64) for atom in ELEMENTS_LIST[1:]]
    return _save_table(rows, embed_basis, aux_basis)


@lru_cache(maxsize=None)
def get_embedding_table(embed_basis: str = "gfn2-xtb", aux_basis: str = "aux28") -> tuple:
    """Per-element embedding table as a tuple of tuples, shape
    (n_elements + 1, n_aux); row 0 is padding."""
    f = PRE_FOLDER / f"{embed_basis}_{aux_basis}.npz"
    if not f.exists():
        try:
            gen_int2c1e(embed_basis, aux_basis)
        except ImportError as exc:
            raise FileNotFoundError(
                f"No precomputed embedding table {f} and PySCF is not installed "
                "to generate it; convert one with convert_torch_table, or use "
                "embed_basis='one-hot'."
            ) from exc
    table = np.load(f)["table"].astype(np.float32)
    return tuple(tuple(float(v) for v in row) for row in table)
