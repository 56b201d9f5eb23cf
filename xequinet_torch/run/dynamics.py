"""`xeq md`: the molecular dynamics entry point.

Port of ``xequinet_tpu/run/dynamics.py`` (host numpy): integrators
(Velocity Verlet NVE, Langevin, Berendsen NVT / NPT / anisotropic NPT,
Andersen, Nose-Hoover chain NVT, MTK NPT and its anisotropic form, FIRE)
driven by the port's ``Calculator``, multi-stage ensemble chains,
Maxwell-Boltzmann initial velocities with zero total momentum, and extxyz
trajectory output.  Each force call is one ``Calculator.calculate`` on
the card (``device=None``, the default) or on the CPU (``device: cpu`` in
the MD config).  With ``halo_devices > 1`` one system is split over that
many processes (``parallel/halo.HaloCalculator``; launched by torchrun,
or inside the caller's process group): every rank integrates the same
state and rank 0 alone writes the log and the trajectory.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .. import keys
from ..data.datapoint import Datapoint
from ..data.fmt_conversion import read_structures, write_xyz
from ..interface.calculator import Calculator
from ..parallel.mesh import rank
from ..utils.config import MDConfig, load_md_config
from ..utils.logger import ZeroLogger
from ..utils.precision import set_matmul_precision
from ..utils.qc import ATOM_MASS, unit_conversion
from .inference import resolve_device

KB_EV = 8.617333262e-5  # eV / K
# internal units: eV, Angstrom, amu  ->  time unit = A sqrt(amu/eV)
FS_PER_TIME_UNIT = 10.180505710774743


@dataclass
class MDState:
    pos: np.ndarray  # [N, 3] Angstrom
    vel: np.ndarray  # [N, 3] A / internal-time
    masses: np.ndarray  # [N] amu
    step: int = 0

    def kinetic_energy(self) -> float:
        return float(0.5 * np.sum(self.masses[:, None] * self.vel**2))

    def temperature(self) -> float:
        dof = 3 * len(self.masses) - 3
        return 2.0 * self.kinetic_energy() / (max(dof, 1) * KB_EV)


def maxwell_boltzmann(
    masses: np.ndarray, temperature: float, rng: np.random.Generator
) -> np.ndarray:
    """Initial velocities at T, zero total momentum."""
    sigma = np.sqrt(KB_EV * temperature / masses)[:, None]
    vel = rng.normal(size=(len(masses), 3)) * sigma
    # remove center-of-mass momentum (Stationary)
    p = (masses[:, None] * vel).sum(0)
    vel -= p / masses.sum()
    return vel


class ForceField:
    """Energy/forces in (eV, Angstrom) from a Calculator, converting from
    model units once."""

    def __init__(self, calc: Calculator, atomic_numbers, cell=None, pbc=None,
                 charge=None, spin=None) -> None:
        self.calc = calc
        self.z = np.asarray(atomic_numbers)
        self.cell = cell
        self.pbc = pbc
        self.charge = charge
        self.spin = spin
        u = calc.units
        self.e_conv = unit_conversion(u.get(keys.TOTAL_ENERGY, "eV"), "eV")
        self.l_conv = unit_conversion(u.get(keys.POSITIONS, "Angstrom"), "Angstrom")
        self.extra_calcs: List = []  # e.g. xTB delta baseline
        # virial (eV) of the latest ML call; barostats reuse it instead of
        # paying a second force evaluation per step
        self.last_virial: Optional[np.ndarray] = None

    def __call__(self, pos_ang: np.ndarray):
        res = self.calc.calculate(
            self.z, pos_ang / self.l_conv,
            cell=self.cell / self.l_conv if self.cell is not None else None,
            pbc=self.pbc, charge=self.charge, spin=self.spin,
        )
        e = res[keys.TOTAL_ENERGY] * self.e_conv
        f = res[keys.FORCES] * self.e_conv / self.l_conv
        vir = res.get(keys.VIRIAL)
        self.last_virial = vir * self.e_conv if vir is not None else None
        for extra in self.extra_calcs:
            ee, ff = extra(pos_ang)
            e = e + ee
            f = f + ff
        return e, f


# ---------------------------------------------------------------------------
# Integrators (host loop; each force call is one Calculator call)
# ---------------------------------------------------------------------------
class VelocityVerlet:
    def __init__(self, ff: ForceField, timestep_fs: float) -> None:
        self.ff = ff
        self.dt = timestep_fs / FS_PER_TIME_UNIT
        self._forces: Optional[np.ndarray] = None

    def step(self, s: MDState, rng) -> MDState:
        if self._forces is None:
            _, self._forces = self.ff(s.pos)
        m = s.masses[:, None]
        vel_half = s.vel + 0.5 * self.dt * self._forces / m
        pos = s.pos + self.dt * vel_half
        _, forces = self.ff(pos)
        vel = vel_half + 0.5 * self.dt * forces / m
        self._forces = forces
        return MDState(pos, vel, s.masses, s.step + 1)


class Langevin(VelocityVerlet):
    """BAOAB Langevin thermostat."""

    def __init__(self, ff, timestep_fs: float, temperature: float,
                 friction_fs: float = 0.01) -> None:
        super().__init__(ff, timestep_fs)
        self.temperature = temperature
        self.gamma = friction_fs * FS_PER_TIME_UNIT  # per internal time

    def step(self, s: MDState, rng) -> MDState:
        if self._forces is None:
            _, self._forces = self.ff(s.pos)
        m = s.masses[:, None]
        dt = self.dt
        c1 = math.exp(-self.gamma * dt)
        vel = s.vel + 0.5 * dt * self._forces / m
        pos = s.pos + 0.5 * dt * vel
        sigma = np.sqrt(KB_EV * self.temperature / s.masses)[:, None]
        vel = c1 * vel + math.sqrt(max(1 - c1 * c1, 0.0)) * sigma * rng.normal(
            size=vel.shape
        )
        pos = pos + 0.5 * dt * vel
        _, forces = self.ff(pos)
        vel = vel + 0.5 * dt * forces / m
        self._forces = forces
        return MDState(pos, vel, s.masses, s.step + 1)


class BerendsenNVT(VelocityVerlet):
    def __init__(self, ff, timestep_fs: float, temperature: float,
                 taut_fs: float = 100.0) -> None:
        super().__init__(ff, timestep_fs)
        self.temperature = temperature
        self.taut = taut_fs / FS_PER_TIME_UNIT

    def step(self, s: MDState, rng) -> MDState:
        s2 = super().step(s, rng)
        t_cur = max(s2.temperature(), 1e-9)
        lam = math.sqrt(
            1.0 + (self.dt / self.taut) * (self.temperature / t_cur - 1.0)
        )
        return MDState(s2.pos, s2.vel * lam, s2.masses, s2.step)


class Andersen(VelocityVerlet):
    """Andersen thermostat: random velocity re-draws at collision rate."""

    def __init__(self, ff, timestep_fs: float, temperature: float,
                 andersen_prob: float = 0.01) -> None:
        super().__init__(ff, timestep_fs)
        self.temperature = temperature
        self.prob = andersen_prob

    def step(self, s: MDState, rng) -> MDState:
        s2 = super().step(s, rng)
        hit = rng.random(len(s2.masses)) < self.prob
        if hit.any():
            sigma = np.sqrt(KB_EV * self.temperature / s2.masses)[:, None]
            vel = s2.vel.copy()
            vel[hit] = rng.normal(size=(hit.sum(), 3)) * sigma[hit]
            s2 = MDState(s2.pos, vel, s2.masses, s2.step)
        return s2


class BerendsenNPT(BerendsenNVT):
    """Berendsen NPT: NVT velocity scaling + isotropic cell/position
    rescaling toward the target pressure (requires a periodic system and
    a virial-capable force field)."""

    def __init__(self, ff, timestep_fs: float, temperature: float,
                 pressure_gpa: float = 0.0, taut_fs: float = 100.0,
                 taup_fs: float = 1000.0, compressibility_gpa: float = 0.457
                 ) -> None:
        super().__init__(ff, timestep_fs, temperature, taut_fs)
        assert ff.cell is not None, "NPT requires a periodic cell"
        self.pressure = pressure_gpa
        self.taup = taup_fs / FS_PER_TIME_UNIT
        self.beta = compressibility_gpa  # 1/GPa (default: water, 4.57e-5/bar)

    def _virial(self) -> np.ndarray:
        """Virial (eV) from the force call the Verlet step just made."""
        vir = self.ff.last_virial
        if vir is None:
            raise RuntimeError("force field does not provide a virial; "
                               "load the Calculator with compute_virial=True")
        return vir

    def step(self, s: MDState, rng) -> MDState:
        s2 = super().step(s, rng)
        # instantaneous pressure: (2 Ekin + virial trace) / (3 V), eV/A^3
        vir = self._virial()
        vol = abs(np.linalg.det(self.ff.cell))
        ev_a3_to_gpa = 160.21766208
        p_inst = (
            (2 * s2.kinetic_energy() + np.trace(vir))
            / (3 * vol)
        ) * ev_a3_to_gpa
        scale = (
            1.0 - (self.dt / self.taup) * self.beta * (self.pressure - p_inst)
        ) ** (1.0 / 3.0)
        self.ff.cell = self.ff.cell * scale
        return MDState(s2.pos * scale, s2.vel, s2.masses, s2.step)


class BerendsenNPTAniso(BerendsenNPT):
    """Anisotropic (full-cell) Berendsen NPT: each step applies a symmetric
    scaling matrix mu = I - (dt*beta/(3 taup)) (P_target I - P_inst) built
    from the full pressure tensor, so the cell shape relaxes too."""

    def step(self, s: MDState, rng) -> MDState:
        s2 = BerendsenNVT.step(self, s, rng)
        vir = self._virial()
        vol = abs(np.linalg.det(self.ff.cell))
        ev_a3_to_gpa = 160.21766208
        # kinetic part of the pressure tensor: sum_i m_i v_i v_i^T / V
        kin = np.einsum("n,ni,nj->ij", s2.masses, s2.vel, s2.vel)
        p_tensor = ((kin + 0.5 * (vir + vir.T)) / vol) * ev_a3_to_gpa  # GPa
        mu = np.eye(3) - (self.dt * self.beta / (3.0 * self.taup)) * (
            self.pressure * np.eye(3) - p_tensor
        )
        mu = 0.5 * (mu + mu.T)
        # row-vector convention: lattice rows a_i' = a_i mu, positions r' = r mu
        self.ff.cell = self.ff.cell @ mu
        return MDState(s2.pos @ mu, s2.vel, s2.masses, s2.step)


def _sinhx_over_x(x: np.ndarray) -> np.ndarray:
    """sinh(x)/x, series-stabilized near 0 (MTK velocity/position factors)."""
    x = np.asarray(x, dtype=float)
    small = np.abs(x) < 1e-4
    safe = np.where(small, 1.0, x)
    return np.where(small, 1.0 + x * x / 6.0, np.sinh(safe) / safe)


class NoseHooverChain:
    """Nosé-Hoover thermostat chain propagator (Martyna-Tuckerman-Klein).

    Propagates the chain for a half step dt against a coupled subsystem
    with ``n_dof`` degrees of freedom and kinetic energy ``kin2/2``,
    returning the velocity scale factor exp(-v_xi1 * dt).  Uses the
    3-term Suzuki-Yoshida decomposition for reversibility.  The chain's
    own energy (for the conserved quantity H' of NHC dynamics) is
    ``energy()``.  Built in, without ASE.
    """

    _SY3 = (1.3512071919596578, -1.7024143839193155, 1.3512071919596578)

    def __init__(self, n_dof: int, temperature: float, tau_fs: float = 50.0,
                 chain_length: int = 3, n_loops: int = 1) -> None:
        self.n_dof = int(n_dof)
        self.kt = KB_EV * temperature
        tau = tau_fs / FS_PER_TIME_UNIT
        m = max(int(chain_length), 1)
        self.q = np.full(m, self.kt * tau * tau)
        self.q[0] *= self.n_dof
        self.xi = np.zeros(m)
        self.vxi = np.zeros(m)
        self.n_loops = int(n_loops)

    def propagate(self, kin2: float, dt: float) -> float:
        """Advance the chain by dt against current 2*K = ``kin2``; returns
        the factor to apply to the coupled velocities."""
        m = len(self.q)
        scale = 1.0
        for _ in range(self.n_loops):
            for w in self._SY3:
                dts = w * dt / self.n_loops
                g = (self.q[m - 2] * self.vxi[m - 2] ** 2 - self.kt) / self.q[m - 1] \
                    if m > 1 else (kin2 - self.n_dof * self.kt) / self.q[0]
                self.vxi[m - 1] += 0.25 * dts * g
                for j in range(m - 2, -1, -1):
                    damp = math.exp(-0.125 * dts * self.vxi[j + 1])
                    g = ((kin2 - self.n_dof * self.kt) / self.q[0] if j == 0
                         else (self.q[j - 1] * self.vxi[j - 1] ** 2 - self.kt) / self.q[j])
                    self.vxi[j] = (self.vxi[j] * damp + 0.25 * dts * g) * damp
                s = math.exp(-0.5 * dts * self.vxi[0])
                scale *= s
                kin2 *= s * s
                self.xi += 0.5 * dts * self.vxi
                for j in range(m - 1):
                    damp = math.exp(-0.125 * dts * self.vxi[j + 1])
                    g = ((kin2 - self.n_dof * self.kt) / self.q[0] if j == 0
                         else (self.q[j - 1] * self.vxi[j - 1] ** 2 - self.kt) / self.q[j])
                    self.vxi[j] = (self.vxi[j] * damp + 0.25 * dts * g) * damp
                g = (self.q[m - 2] * self.vxi[m - 2] ** 2 - self.kt) / self.q[m - 1] \
                    if m > 1 else (kin2 - self.n_dof * self.kt) / self.q[0]
                self.vxi[m - 1] += 0.25 * dts * g
        return scale

    def energy(self) -> float:
        """Thermostat contribution to the NHC conserved quantity."""
        e = 0.5 * float(np.sum(self.q * self.vxi**2))
        e += self.n_dof * self.kt * self.xi[0]
        e += self.kt * float(np.sum(self.xi[1:]))
        return e


class NoseHooverNVT(VelocityVerlet):
    """Nosé-Hoover-chain NVT: half-chain -> velocity Verlet -> half-chain.

    Samples the canonical ensemble exactly (unlike Berendsen); the
    conserved quantity H' = K + U + sum_j Q_j v_xi_j^2/2 + N_f kT xi_1 +
    kT sum_{j>=2} xi_j is exposed via :meth:`conserved_energy` and
    bounded-drift-tested in tests/test_round4.py.
    """

    def __init__(self, ff, timestep_fs: float, temperature: float,
                 tau_fs: float = 50.0, chain_length: int = 3) -> None:
        super().__init__(ff, timestep_fs)
        self.temperature = temperature
        self.n_dof_of = lambda n: 3 * n - 3
        self.chain: Optional[NoseHooverChain] = None
        self._tau_fs = tau_fs
        self._chain_length = chain_length

    def _ensure_chain(self, s: MDState) -> NoseHooverChain:
        if self.chain is None:
            self.chain = NoseHooverChain(
                self.n_dof_of(len(s.masses)), self.temperature,
                self._tau_fs, self._chain_length,
            )
        return self.chain

    def step(self, s: MDState, rng) -> MDState:
        chain = self._ensure_chain(s)
        scale = chain.propagate(2.0 * s.kinetic_energy(), 0.5 * self.dt)
        s = MDState(s.pos, s.vel * scale, s.masses, s.step)
        s2 = super().step(s, rng)
        scale = chain.propagate(2.0 * s2.kinetic_energy(), 0.5 * self.dt)
        return MDState(s2.pos, s2.vel * scale, s2.masses, s2.step)

    def conserved_energy(self, s: MDState, e_pot: float) -> float:
        chain = self._ensure_chain(s)
        return s.kinetic_energy() + e_pot + chain.energy()


_EV_A3_TO_GPA = 160.21766208


class MTKNPT:
    """Isotropic Martyna-Tobias-Klein NPT (Nosé-Hoover barostat).

    Explicitly reversible integrator (Tuckerman, "Statistical Mechanics",
    ch. 5 NPT algorithm): separate NHC thermostats on particles and on
    the cell, MTK sinh(x)/x velocity/position factors, volume moved by
    exp(3 v_eps dt).  Samples the true isothermal-isobaric ensemble, as
    ASE's ``NPT`` stage does; Berendsen (above) does not.  Pressure in
    GPa, virial convention P = (2K + tr W)/(3V) as in BerendsenNPT.
    """

    def __init__(self, ff: ForceField, timestep_fs: float, temperature: float,
                 pressure_gpa: float = 0.0, taut_fs: float = 50.0,
                 taup_fs: float = 500.0, chain_length: int = 3) -> None:
        assert ff.cell is not None, "NPT requires a periodic cell"
        self.ff = ff
        self.dt = timestep_fs / FS_PER_TIME_UNIT
        self.temperature = temperature
        self.p_ext = pressure_gpa / _EV_A3_TO_GPA  # eV / A^3
        self.taut_fs = taut_fs
        self.taup = taup_fs / FS_PER_TIME_UNIT
        self.chain_length = chain_length
        self.chain_p: Optional[NoseHooverChain] = None
        self.chain_b: Optional[NoseHooverChain] = None
        self.v_eps = 0.0
        self.w = None  # barostat mass
        self._forces: Optional[np.ndarray] = None

    def _ensure(self, s: MDState) -> None:
        if self.chain_p is None:
            n_dof = 3 * len(s.masses) - 3
            self.n_dof = n_dof
            kt = KB_EV * self.temperature
            self.w = (n_dof + 3) * kt * self.taup**2
            self.chain_p = NoseHooverChain(
                n_dof, self.temperature, self.taut_fs, self.chain_length)
            # barostat thermostat on the taup timescale (tau back in fs)
            self.chain_b = NoseHooverChain(
                1, self.temperature, self.taup * FS_PER_TIME_UNIT,
                self.chain_length)

    def _pressure(self, s: MDState) -> float:
        vir = self.ff.last_virial
        if vir is None:
            raise RuntimeError("force field does not provide a virial; "
                               "load the Calculator with compute_virial=True")
        vol = abs(np.linalg.det(self.ff.cell))
        return (2.0 * s.kinetic_energy() + np.trace(vir)) / (3.0 * vol)

    def _half_baro(self, s: MDState) -> None:
        vol = abs(np.linalg.det(self.ff.cell))
        g_eps = (3.0 * vol * (self._pressure(s) - self.p_ext)
                 + (3.0 / self.n_dof) * 2.0 * s.kinetic_energy()) / self.w
        self.v_eps += 0.5 * self.dt * g_eps

    def _half_thermo(self, s: MDState) -> MDState:
        sb = self.chain_b.propagate(self.w * self.v_eps**2, 0.5 * self.dt)
        self.v_eps *= sb
        sp = self.chain_p.propagate(2.0 * s.kinetic_energy(), 0.5 * self.dt)
        return MDState(s.pos, s.vel * sp, s.masses, s.step)

    def step(self, s: MDState, rng) -> MDState:
        self._ensure(s)
        if self._forces is None:
            _, self._forces = self.ff(s.pos)
        dt, dt2 = self.dt, 0.5 * self.dt
        s = self._half_thermo(s)
        self._half_baro(s)
        # MTK half-kick with barostat coupling factor
        alpha = 1.0 + 3.0 / self.n_dof
        aa = alpha * self.v_eps * dt2
        m = s.masses[:, None]
        vel = (s.vel * math.exp(-aa)
               + dt2 * (self._forces / m) * math.exp(-0.5 * aa)
               * _sinhx_over_x(0.5 * aa))
        # position + cell update
        ve_dt = self.v_eps * dt
        pos = (s.pos * math.exp(ve_dt)
               + dt * vel * math.exp(0.5 * ve_dt) * _sinhx_over_x(0.5 * ve_dt))
        self.ff.cell = self.ff.cell * math.exp(ve_dt)
        _, forces = self.ff(pos)
        vel = (vel * math.exp(-aa)
               + dt2 * (forces / m) * math.exp(-0.5 * aa)
               * _sinhx_over_x(0.5 * aa))
        self._forces = forces
        s = MDState(pos, vel, s.masses, s.step + 1)
        self._half_baro(s)
        return self._half_thermo(s)

    def conserved_energy(self, s: MDState, e_pot: float) -> float:
        self._ensure(s)
        vol = abs(np.linalg.det(self.ff.cell))
        return (s.kinetic_energy() + e_pot
                + 0.5 * self.w * self.v_eps**2
                + self.chain_p.energy() + self.chain_b.energy()
                + self.p_ext * vol)


class MTKNPTAniso(MTKNPT):
    """Anisotropic MTK NPT (Parrinello-Rahman-style full-cell barostat).

    The cell velocity is a symmetric 3x3 matrix v_g; velocity/position
    updates use eigendecomposition-based matrix exponentials of
    v_g + (tr v_g / N_f) I.  Equations: Martyna, Tobias & Klein,
    J. Chem. Phys. 101, 4177 (1994), "fully flexible cell".
    """

    def _ensure(self, s: MDState) -> None:
        first = self.chain_p is None
        super()._ensure(s)
        if first:
            kt = KB_EV * self.temperature
            self.w_g = (self.n_dof + 3) * kt * self.taup**2 / 3.0
            self.v_g = np.zeros((3, 3))
            self.chain_b = NoseHooverChain(
                6, self.temperature, self.taup * FS_PER_TIME_UNIT,
                self.chain_length)

    def _p_tensor(self, s: MDState) -> np.ndarray:
        vir = self.ff.last_virial
        if vir is None:
            raise RuntimeError("force field does not provide a virial")
        vol = abs(np.linalg.det(self.ff.cell))
        kin = np.einsum("n,ni,nj->ij", s.masses, s.vel, s.vel)
        return (kin + 0.5 * (vir + vir.T)) / vol

    def _half_baro(self, s: MDState) -> None:
        vol = abs(np.linalg.det(self.ff.cell))
        g_g = (vol * (self._p_tensor(s) - self.p_ext * np.eye(3))
               + (2.0 * s.kinetic_energy() / self.n_dof) * np.eye(3)) / self.w_g
        self.v_g = self.v_g + 0.5 * self.dt * 0.5 * (g_g + g_g.T)

    def _half_thermo(self, s: MDState) -> MDState:
        kin2_b = self.w_g * float(np.sum(self.v_g * self.v_g))
        sb = self.chain_b.propagate(kin2_b, 0.5 * self.dt)
        self.v_g *= sb
        sp = self.chain_p.propagate(2.0 * s.kinetic_energy(), 0.5 * self.dt)
        return MDState(s.pos, s.vel * sp, s.masses, s.step)

    def step(self, s: MDState, rng) -> MDState:
        self._ensure(s)
        if self._forces is None:
            _, self._forces = self.ff(s.pos)
        dt, dt2 = self.dt, 0.5 * self.dt
        s = self._half_thermo(s)
        self._half_baro(s)
        m = s.masses[:, None]

        def kick(vel, forces):
            # row-vector convention: v' = v O diag O^T
            mm = self.v_g + (np.trace(self.v_g) / self.n_dof) * np.eye(3)
            lam, o = np.linalg.eigh(0.5 * (mm + mm.T))
            e1 = np.exp(-lam * dt2)
            e2 = np.exp(-0.5 * lam * dt2) * _sinhx_over_x(0.5 * lam * dt2)
            v_o = vel @ o
            f_o = (forces / m) @ o
            return (v_o * e1 + dt2 * f_o * e2) @ o.T

        vel = kick(s.vel, self._forces)
        # position + cell via exp(v_g dt)
        lam, o = np.linalg.eigh(0.5 * (self.v_g + self.v_g.T))
        e1 = np.exp(lam * dt)
        e2 = np.exp(0.5 * lam * dt) * _sinhx_over_x(0.5 * lam * dt)
        pos = ((s.pos @ o) * e1 + dt * (vel @ o) * e2) @ o.T
        self.ff.cell = (self.ff.cell @ o) * e1 @ o.T
        _, forces = self.ff(pos)
        vel = kick(vel, forces)
        self._forces = forces
        s = MDState(pos, vel, s.masses, s.step + 1)
        self._half_baro(s)
        return self._half_thermo(s)

    def conserved_energy(self, s: MDState, e_pot: float) -> float:
        self._ensure(s)
        vol = abs(np.linalg.det(self.ff.cell))
        return (s.kinetic_energy() + e_pot
                + 0.5 * self.w_g * float(np.sum(self.v_g * self.v_g))
                + self.chain_p.energy() + self.chain_b.energy()
                + self.p_ext * vol)


class FIREStage:
    """FIRE structure relaxation as an MD-chain stage (in place of running
    an ASE optimizer as an ensemble).  Velocities are
    re-thermalized by the next stage; positions are minimized in place."""

    def __init__(self, ff: ForceField, timestep_fs: float, fmax: float = 0.05,
                 dt_max_fs: float = 2.0) -> None:
        self.ff = ff
        self.dt0 = timestep_fs / FS_PER_TIME_UNIT
        self.dt_max = dt_max_fs / FS_PER_TIME_UNIT
        self.fmax = fmax
        self._v = None
        self._dt = self.dt0
        self._a = 0.1
        self._n_up = 0
        self.converged = False

    def step(self, s: MDState, rng) -> MDState:
        _, forces = self.ff(s.pos)
        if np.sqrt((forces**2).sum(-1)).max() < self.fmax:
            self.converged = True
            return MDState(s.pos, np.zeros_like(s.vel), s.masses, s.step + 1)
        if self._v is None:
            self._v = np.zeros_like(s.pos)
        v = self._v + self._dt * forces / s.masses[:, None]
        power = float((v * forces).sum())
        if power > 0:
            fn = np.linalg.norm(forces)
            vn = np.linalg.norm(v)
            v = (1 - self._a) * v + self._a * (forces / max(fn, 1e-12)) * vn
            self._n_up += 1
            if self._n_up > 5:
                self._dt = min(self._dt * 1.1, self.dt_max)
                self._a *= 0.99
        else:
            v = np.zeros_like(v)
            self._dt = self._dt * 0.5
            self._a = 0.1
            self._n_up = 0
        self._v = v
        pos = s.pos + self._dt * v
        return MDState(pos, np.zeros_like(s.vel), s.masses, s.step + 1)


ENSEMBLE_FACTORY = {
    "velocityverlet": VelocityVerlet,
    "nve": VelocityVerlet,
    "langevin": Langevin,
    "nvtberendsen": BerendsenNVT,
    "berendsen": BerendsenNVT,
    "andersen": Andersen,
    "nosehoover": NoseHooverNVT,
    "nose-hoover": NoseHooverNVT,
    "nvtnosehoover": NoseHooverNVT,
    "nhc": NoseHooverNVT,
    "nptberendsen": BerendsenNPT,
    # "npt" is the extended-Lagrangian barostat (as ASE's NPT stage:
    # Nose-Hoover + Parrinello-Rahman), not Berendsen
    "npt": MTKNPT,
    "npt-mtk": MTKNPT,
    "nptnosehoover": MTKNPT,
    "nptberendsenaniso": BerendsenNPTAniso,
    "npt-aniso": BerendsenNPTAniso,
    "npt-mtk-aniso": MTKNPTAniso,
    "npt-pr": MTKNPTAniso,
    "parrinellorahman": MTKNPTAniso,
    "fire": FIREStage,
    "optimize": FIREStage,
}


def run_md(config: MDConfig, logger=None) -> MDState:
    halo = bool(config.halo_devices and config.halo_devices > 1)
    if halo:
        # one system over halo_devices processes (torchrun's, or the
        # caller's group): every rank integrates the same replicated state
        # from the same seed, and rank 0 alone writes the log and the
        # trajectory
        from ..parallel.mesh import maybe_init_distributed

        maybe_init_distributed(resolve_device(config.device))
    logger = logger or ZeroLogger(config.logfile)
    rng = np.random.default_rng(config.seed or 0)
    frames = read_structures(config.input_file, config.input_format)
    dp = frames[0]
    masses = ATOM_MASS[dp.atomic_numbers]

    stage_names = [
        str(st.get("name", "nve")).lower() for st in (config.ensembles or [])
    ]
    needs_virial = any(
        "npt" in n or n == "parrinellorahman" for n in stage_names
    )
    set_matmul_precision(config.matmul_precision)
    if halo:
        from ..parallel.halo import HaloCalculator

        if needs_virial:
            raise ValueError("halo_devices > 1 gives no virial: run NPT stages with the "
                             "single-card Calculator")
        calc = HaloCalculator(config.model_file, n_shards=config.halo_devices,
                              pallas=config.pallas, device=config.device)
    else:
        calc = Calculator(config.model_file, compute_virial=needs_virial,
                          pallas=config.pallas, skin=config.skin,
                          matmul_precision=config.matmul_precision, device=config.device)
    ff = ForceField(
        calc, dp.atomic_numbers,
        cell=dp.cell if dp.has_cell else None,
        pbc=dp.pbc if dp.has_cell else None,
        charge=dp.charge, spin=dp.spin,
    )
    if config.delta_method:
        from ..data.fmt_conversion import datapoint_to_xtb

        def xtb_extra(pos_ang):
            d = Datapoint(dp.atomic_numbers, pos_ang, charge=dp.charge, spin=dp.spin)
            res = datapoint_to_xtb(d, method=config.delta_method).singlepoint()
            h2ev = unit_conversion("Hartree", "eV")
            b2a = unit_conversion("Bohr", "Angstrom")
            return res.get("energy") * h2ev, -res.get("gradient") * h2ev / b2a

        ff.extra_calcs.append(xtb_extra)

    vel = maxwell_boltzmann(masses, config.init_temperature, rng)
    state = MDState(dp.pos.copy(), vel, masses)

    for stage in config.ensembles or [{"name": "nve", "timestep": 0.5, "steps": 100}]:
        stage = dict(stage)
        name = stage.pop("name", "nve").lower()
        steps = int(stage.pop("steps", 100))
        timestep = float(stage.pop("timestep", 0.5))
        log_interval = int(stage.pop("log_interval", 10))
        stage.pop("device", None)
        integ_cls = ENSEMBLE_FACTORY[name]
        integ = integ_cls(ff, timestep, **stage)
        logger.info(f"MD stage {name}: {steps} steps x {timestep} fs")
        for i in range(steps):
            state = integ.step(state, rng)
            if (i + 1) % log_interval == 0 or i == steps - 1 or getattr(
                integ, "converged", False
            ):
                e_pot, _ = ff(state.pos)
                msg = (
                    f"step {state.step} t={state.step * timestep:.1f}fs "
                    f"Epot={e_pot:.6f}eV Ekin={state.kinetic_energy():.6f}eV "
                    f"T={state.temperature():.1f}K"
                )
                if hasattr(integ, "conserved_energy"):
                    msg += (
                        f" H'={integ.conserved_energy(state, e_pot):.6f}eV"
                    )
                logger.info(msg)
                if config.xyz_traj and rank() == 0:
                    # ff.cell is the live cell (barostats rescale it);
                    # writing dp.cell would freeze the initial cell into
                    # every NPT snapshot
                    snap = Datapoint(
                        dp.atomic_numbers, state.pos,
                        cell=ff.cell if ff.cell is not None else None,
                        pbc=dp.pbc if dp.has_cell else None,
                    )
                    write_xyz(
                        config.xyz_traj, [snap], energies=[e_pot],
                        append=(state.step > log_interval),
                    )
            if getattr(integ, "converged", False):
                logger.info(f"stage {name} converged at step {state.step}")
                break
    return state


def run_md_from_args(args) -> None:
    config = load_md_config(args.config)
    run_md(config)
