"""Cartesian tensor <-> irreps change of basis (numpy, host only).

Copy of ``xequinet_tpu/ops/cartesian.py`` (the port keeps its own): for a
formula such as ``"ij=ji"`` (index symmetries, optional minus signs) it
computes the orthonormal equivariant basis {Q_a} of the symmetry-
constrained rank-n Cartesian tensors, one intertwiner T: R^{2l+1} ->
(R^3)^{⊗n} per irrep copy, solving

    J_k^{(tensor)} T = T J_k^{(l)}   for k = 1..3,   (I - P_sym) T = 0

as an SVD null space, with the so(3) generators of ``ops/wigner.py``.
Where an irrep occurs once, Schur's lemma and the sign rule fix T.  Where
it occurs more than once (a general rank 3), the null space's basis is
whatever the LAPACK build returns, as in the JAX package.  All Cartesian
axes are in the irrep basis (y, z, x); callers roll them to (x, y, z).
"""

from __future__ import annotations

import itertools
from functools import lru_cache
from typing import List, Tuple

import numpy as np

from .irreps import Irrep, Irreps
from .wigner import so3_generators


def _parse_formula(formula: str) -> Tuple[str, List[Tuple[int, Tuple[int, ...]]]]:
    """Parse "ij=ji" style formulas -> (indices, [(sign, permutation), ...]).

    The permutation maps output slot -> source slot of the base term.
    """
    terms = formula.split("=")
    base = terms[0].replace("-", "")
    indices = base
    perms = [(1, tuple(range(len(base))))]
    for t in terms[1:]:
        sign = -1 if t.strip().startswith("-") else 1
        t = t.replace("-", "").strip()
        assert sorted(t) == sorted(base), f"bad formula term {t}"
        perm = tuple(base.index(c) for c in t)
        perms.append((sign, perm))
    return indices, perms


def _perm_closure(
    n: int, gens: List[Tuple[int, Tuple[int, ...]]]
) -> List[Tuple[int, Tuple[int, ...]]]:
    group = {tuple(range(n)): 1}
    frontier = list(group.items())
    while frontier:
        new = []
        for perm, sign in frontier:
            for gsign, gperm in gens:
                comp = tuple(perm[gperm[i]] for i in range(n))
                s = sign * gsign
                if comp not in group:
                    group[comp] = s
                    new.append((comp, s))
                elif group[comp] != s:
                    raise ValueError("inconsistent symmetry formula (term = -term)")
        frontier = new
    return [(s, p) for p, s in group.items()]


@lru_cache(maxsize=None)
def reduced_tensor_basis(formula: str) -> Tuple[Irreps, np.ndarray]:
    """Return (irreps, Q) with Q of shape [irreps.dim, 3^n]:

    ``cart.flatten() = sph @ Q`` and the rows are orthonormal.
    """
    indices, gens = _parse_formula(formula)
    n = len(indices)
    d = 3**n

    # symmetrization projector over the closure of the given permutations
    group = _perm_closure(n, gens)
    P = np.zeros((d, d))
    for sign, perm in group:
        M = np.zeros((d, d))
        for idx in itertools.product(range(3), repeat=n):
            src = tuple(idx[perm[i]] for i in range(n))
            M[int(np.ravel_multi_index(idx, (3,) * n)),
              int(np.ravel_multi_index(src, (3,) * n))] = 1.0
        P += sign * M
    P /= len(group)

    # tensor-representation generators
    g1 = so3_generators(1)
    J_tensor = []
    for k in range(3):
        J = np.zeros((d, d))
        for axis in range(n):
            mats = [np.eye(3)] * n
            mats[axis] = g1[k]
            M = mats[0]
            for m in mats[1:]:
                M = np.kron(M, m)
            J += M
        J_tensor.append(J)

    p_out = (-1) ** n
    chunks: List[Tuple[int, Irrep]] = []
    rows: List[np.ndarray] = []
    for l in range(0, n + 1):
        gl = so3_generators(l)
        dl = 2 * l + 1
        # unknown T: [d, dl]; constraints: J_t T - T J_l = 0 (x3), (I-P) T = 0
        blocks = []
        for k in range(3):
            blocks.append(
                np.kron(J_tensor[k], np.eye(dl)) - np.kron(np.eye(d), gl[k].T)
            )
        blocks.append(np.kron(np.eye(d) - P, np.eye(dl)))
        M = np.concatenate(blocks, axis=0)
        _, s, vt = np.linalg.svd(M)
        tol = 1e-8 * max(s[0], 1.0)
        null = vt[s.size - np.sum(s < tol) :] if np.sum(s < tol) else vt[:0]
        # each null vector reshapes to an intertwiner T
        Ts = [v.reshape(d, dl) for v in null]
        # orthonormalize in Frobenius inner product (SVD rows already are)
        for T in Ts:
            # normalize to isometry: T^T T = c I by Schur's lemma
            c = np.trace(T.T @ T) / dl
            T = T / np.sqrt(c)
            # canonical sign: first significant entry positive
            flat = T.ravel()
            idx = np.argmax(np.abs(flat) > 1e-8)
            if flat[idx] < 0:
                T = -T
            chunks.append((1, Irrep(l, p_out)))
            rows.append(T.T)  # [dl, d]

    if not rows:
        raise ValueError(f"formula {formula} admits no equivariant tensors")
    irreps = Irreps(chunks).simplify()
    Q = np.concatenate(rows, axis=0)  # [irreps.dim, 3^n]
    return irreps, Q
