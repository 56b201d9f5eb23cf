"""Units: a CODATA-2018 atomic-unit algebra.

Copy of the unit part of ``xequinet_tpu/utils/qc.py:25-131``: every unit
is a float in atomic units, and arithmetic unit expressions such as
"eV/Ang^2" are parsed and evaluated.  The element tables and the xTB
embeddings of that module come with a later slice.
"""

from __future__ import annotations

import re
from math import pi
from typing import Dict, Optional

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
