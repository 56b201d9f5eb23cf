"""Wigner-3j tables and Wigner-D matrices in the real spherical-harmonics
basis (numpy).

Port of ``xequinet_tpu/ops/wigner.py:32-163``.  Construction:

* real so(3) generators obtained by conjugating the complex su(2)
  generators with the standard complex->real change of basis,
* the 3j tensor for (l1,l2,l3) is the 1-dimensional null space of
  ``G ⊗ I ⊗ I + I ⊗ G ⊗ I + I ⊗ I ⊗ G``,
* normalized to unit Frobenius norm with the first non-zero entry made
  positive (e3nn's ``wigner_3j(1,1,0) = +δ/√3``).

The l=1 irrep basis is the (y, z, x) ordering of geometric axes.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import numpy as np


@lru_cache(maxsize=None)
def change_basis_real_to_complex(l: int) -> np.ndarray:
    """Unitary Q with the e3nn phase convention ((-i)^l); rows index real
    m, columns complex m (both ordered -l..l)."""
    q = np.zeros((2 * l + 1, 2 * l + 1), dtype=np.complex128)
    inv_s2 = 1.0 / math.sqrt(2.0)
    for m in range(-l, 0):
        q[l + m, l + abs(m)] = inv_s2
        q[l + m, l - abs(m)] = -1j * inv_s2
    q[l, l] = 1.0
    for m in range(1, l + 1):
        q[l + m, l + abs(m)] = (-1) ** m * inv_s2
        q[l + m, l - abs(m)] = 1j * (-1) ** m * inv_s2
    return (-1j) ** l * q


def _su2_generators(l: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    m = np.arange(-l, l + 1, dtype=np.float64)
    lp = np.zeros((2 * l + 1, 2 * l + 1), dtype=np.complex128)
    lm = np.zeros((2 * l + 1, 2 * l + 1), dtype=np.complex128)
    for i, mm in enumerate(m[:-1]):
        lp[i + 1, i] = math.sqrt(l * (l + 1) - mm * (mm + 1))
    for i, mm in enumerate(m[1:], start=1):
        lm[i - 1, i] = math.sqrt(l * (l + 1) - mm * (mm - 1))
    jz = np.diag(m).astype(np.complex128)
    jx = 0.5 * (lp + lm)
    jy = -0.5j * (lp - lm)
    return jx, jy, jz


@lru_cache(maxsize=None)
def so3_generators(l: int) -> Tuple[np.ndarray, ...]:
    """Real antisymmetric generators (A_1, A_2, A_3) of degree l."""
    q = change_basis_real_to_complex(l)
    gens = []
    for j in _su2_generators(l):
        a = np.conj(q.T) @ (1j * j) @ q
        if np.abs(a.imag).max() > 1e-9:
            raise RuntimeError(f"so3 generator for l={l} not real")
        gens.append(np.ascontiguousarray(a.real))
    return tuple(gens)


@lru_cache(maxsize=None)
def wigner_3j(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real-basis Wigner-3j tensor, shape (2l1+1, 2l2+1, 2l3+1)."""
    d1, d2, d3 = 2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1
    if not (abs(l1 - l2) <= l3 <= l1 + l2):
        return np.zeros((d1, d2, d3))
    g1, g2, g3 = so3_generators(l1), so3_generators(l2), so3_generators(l3)
    i1, i2, i3 = np.eye(d1), np.eye(d2), np.eye(d3)
    rows = []
    for k in range(3):
        op = (
            np.einsum("ij,kl,mn->ikmjln", g1[k], i2, i3)
            + np.einsum("ij,kl,mn->ikmjln", i1, g2[k], i3)
            + np.einsum("ij,kl,mn->ikmjln", i1, i2, g3[k])
        ).reshape(d1 * d2 * d3, d1 * d2 * d3)
        rows.append(op)
    _, s, vt = np.linalg.svd(np.concatenate(rows, axis=0))
    if s[-1] > 1e-8 * s[0]:
        raise RuntimeError(f"no invariant tensor found for ({l1},{l2},{l3})")
    if len(s) >= 2 and s[-2] < 1e-8 * s[0]:
        raise RuntimeError(f"multiplicity > 1 for ({l1},{l2},{l3})?")
    c = vt[-1].reshape(d1, d2, d3)
    flat = c.ravel()
    idx = np.argmax(np.abs(flat) > 1e-8)
    if flat[idx] < 0:
        c = -c
    return c / np.linalg.norm(c)


@lru_cache(maxsize=None)
def irrep_inner_coeff(l: int) -> float:
    """c_l with ``w3j(l,l,0)[m,m',0] = c_l * delta_{mm'}`` (= 1/sqrt(2l+1))."""
    return float(wigner_3j(l, l, 0)[0, 0, 0])


# ---------------------------------------------------------------------------
# Wigner D matrices (equivariance checks, Sph2Cart construction); port of
# xequinet_tpu/ops/wigner.py:137-163 without scipy.
# ---------------------------------------------------------------------------


def _rotation_log(r: np.ndarray) -> np.ndarray:
    """Principal logarithm of a 3x3 rotation matrix (antisymmetric)."""
    cos = float(np.clip((np.trace(r) - 1.0) / 2.0, -1.0, 1.0))
    theta = math.acos(cos)
    if theta < 1e-12:
        return 0.5 * (r - r.T)
    if math.pi - theta > 1e-6:
        return theta / (2.0 * math.sin(theta)) * (r - r.T)
    # a half turn: the axis is the column of R + I with the largest norm
    s = r + np.eye(3)
    n = s[:, int(np.argmax(np.linalg.norm(s, axis=0)))]
    n = n / np.linalg.norm(n)
    return theta * np.array([[0.0, -n[2], n[1]], [n[2], 0.0, -n[0]], [-n[1], n[0], 0.0]])


def _expm_antisymmetric(m: np.ndarray) -> np.ndarray:
    """exp(M) of a real antisymmetric M, through the Hermitian -iM."""
    w, u = np.linalg.eigh(-1j * m)
    return np.real((u * np.exp(1j * w)) @ u.conj().T)


def wigner_D(l: int, R_irrep: np.ndarray) -> np.ndarray:
    """Real Wigner-D matrix of degree ``l`` for a rotation given in the l=1
    irrep basis (pass ``geometric_rotation_to_irrep_basis(R_xyz)`` for a
    geometric rotation matrix)."""
    a = _rotation_log(np.asarray(R_irrep, dtype=np.float64))
    coeffs = [float(np.sum(a * g) / np.sum(g * g)) for g in so3_generators(1)]
    return _expm_antisymmetric(sum(c * g for c, g in zip(coeffs, so3_generators(l))))


_P_YZX = np.array([[0.0, 1.0, 0.0], [0.0, 0.0, 1.0], [1.0, 0.0, 0.0]])  # (x,y,z) -> (y,z,x)


def geometric_rotation_to_irrep_basis(R_xyz: np.ndarray) -> np.ndarray:
    """A geometric (x,y,z) rotation matrix in the l=1 irrep basis."""
    return _P_YZX @ R_xyz @ _P_YZX.T
