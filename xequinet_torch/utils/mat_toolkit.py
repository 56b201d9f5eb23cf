"""Basis-aware conversion between QC matrices and padded per-atom /
per-pair blocks in the irreps layout (numpy, host only).

Copy of ``xequinet_tpu/utils/mat_toolkit.py`` (the port keeps its own):
the m-index permutations of the PySCF / Gaussian and ORCA orderings,
per-element masks against the union basis, pad / unpad, block
extraction and assembly.  The basis's shell structure is an explicit
``{element: [l, l, ...]}`` dict, or a basis name that
:func:`get_l_from_basis` resolves through PySCF (imported there, and
raising without it, as in the JAX package).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..ops.irreps import Irrep, Irreps
from .qc import ELEMENTS_DICT, ELEMENTS_LIST

# m-orderings relative to our (e3nn-convention) internal layout
M_IDX_COMMON = {
    0: [0],
    1: [1, 2, 0],  # (x, y, z) -> (y, z, x)
    2: [0, 1, 2, 3, 4],
    3: [0, 1, 2, 3, 4, 5, 6],
    4: [0, 1, 2, 3, 4, 5, 6, 7, 8],
}
M_IDX_ORCA = {
    0: [0],
    1: [1, 2, 0],
    2: [2, 3, 1, 4, 0],
    3: [3, 4, 2, 5, 1, 6, 0],
    4: [4, 5, 3, 6, 2, 7, 1, 8, 0],
}
M_IDX_ORIG = {
    0: [0],
    1: [0, 1, 2],
    2: [0, 1, 2, 3, 4],
    3: [0, 1, 2, 3, 4, 5, 6],
    4: [0, 1, 2, 3, 4, 5, 6, 7, 8],
}


def resolve_m_idx_type(map_type: str = "pyscf") -> Dict[int, List[int]]:
    map_type = map_type.lower()
    if map_type == "orca":
        return M_IDX_ORCA
    if map_type in ("pyscf", "gaussian"):
        return M_IDX_COMMON
    return M_IDX_ORIG


def get_l_from_basis(basis: str, element: str) -> List[int]:
    """Shell l-values of an element in a basis (requires pyscf), matching
    the JAX package's."""
    if basis == "hessian":
        return [1]
    from pyscf import gto

    loaded = gto.basis.load(basis, element)
    return [b[0] for b in loaded]


class MatToolkit:
    """Matrix <-> block toolkit.

    Args:
        target_basis: basis name (pyscf) OR a dict {element: [l, ...]} with
            explicit shell structures (torch/pyscf-free path).
        elements: elements present in the dataset (symbols or Z).
        map_type: input m-ordering convention.
    """

    def __init__(
        self,
        target_basis: Union[str, Dict[str, Sequence[int]]],
        elements: Sequence[Union[str, int]],
        map_type: str = "pyscf",
    ) -> None:
        self.elements = [
            e if isinstance(e, str) else ELEMENTS_LIST[e] for e in elements
        ]
        self.atomic_numbers = [
            e if isinstance(e, int) else ELEMENTS_DICT[e] for e in elements
        ]
        if isinstance(target_basis, dict):
            self._l_of = {e: list(target_basis[e]) for e in self.elements}
        else:
            self._l_of = {
                e: get_l_from_basis(target_basis, e) for e in self.elements
            }

        self.num_orb_per_angular, self.max_orb_per_angular = self._resolve_basis()
        self.atom2mask = self._gen_mask()

        self.basis_irreps = Irreps(
            [
                (int(mul), Irrep(l, (-1) ** l))
                for l, mul in enumerate(self.max_orb_per_angular)
            ]
        ).simplify()
        self.m_idx_map = resolve_m_idx_type(map_type)
        self.m_idx = self._gen_m_idx()
        self._m_inv = np.argsort(self.m_idx)

    # ------------------------------------------------------------------
    def _resolve_basis(self) -> Tuple[np.ndarray, np.ndarray]:
        num_orb = np.zeros((len(self.elements), 10), dtype=np.int64)
        for i, ele in enumerate(self.elements):
            ls, counts = np.unique(np.asarray(self._l_of[ele]), return_counts=True)
            num_orb[i, ls] = counts
        max_orb = num_orb.max(axis=0)
        max_l = int(np.nonzero(max_orb)[0].max()) + 1
        return num_orb[:, :max_l], max_orb[:max_l]

    def _gen_mask(self) -> Dict[int, np.ndarray]:
        atom2mask = {}
        for i, at in enumerate(self.atomic_numbers):
            mask = []
            for l, (n, m) in enumerate(
                zip(self.num_orb_per_angular[i], self.max_orb_per_angular)
            ):
                l_mask = np.zeros(m * (2 * l + 1), dtype=bool)
                l_mask[: n * (2 * l + 1)] = True
                mask.append(l_mask)
            atom2mask[at] = np.concatenate(mask)
        return atom2mask

    def _gen_m_idx(self) -> np.ndarray:
        m_idx = []
        offset = 0
        for mul, ir in self.basis_irreps:
            dim = ir.dim
            base = np.asarray(self.m_idx_map[ir.l])
            for u in range(mul):
                m_idx.append(base + offset + u * dim)
            offset += mul * dim
        return np.concatenate(m_idx)

    def get_basis_irreps(self) -> Irreps:
        return self.basis_irreps

    # ------------------------------------------------------------------
    def padding_matrix(self, at_no: np.ndarray, mat: np.ndarray) -> np.ndarray:
        n = len(at_no)
        dim = self.basis_irreps.dim
        out = np.zeros((n * dim, n * dim), dtype=mat.dtype)
        mask1d = np.concatenate([self.atom2mask[int(a)] for a in at_no])
        mask2d = np.outer(mask1d, mask1d)
        out[mask2d] = np.asarray(mat).ravel()
        return out

    def unpadding_matrix(self, at_no: np.ndarray, mat: np.ndarray) -> np.ndarray:
        mask1d = np.concatenate([self.atom2mask[int(a)] for a in at_no])
        mask2d = np.outer(mask1d, mask1d)
        m = int(mask1d.sum())
        return np.asarray(mat)[mask2d].reshape(m, m)

    def get_edge_index_full(self, at_no: np.ndarray) -> np.ndarray:
        n = len(at_no)
        pairs = [
            (i, j) for i in range(n) for j in range(n) if i != j
        ]
        return np.asarray(pairs, dtype=np.int64).T.reshape(2, -1)

    def get_padded_blocks(
        self, at_no: np.ndarray, mat: np.ndarray, edge_index: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        n = len(at_no)
        dim = self.basis_irreps.dim
        padded = self.padding_matrix(at_no, mat).reshape(n, dim, n, dim)
        padded = padded.transpose(0, 2, 1, 3)
        padded = padded[:, :, self.m_idx, :][:, :, :, self.m_idx]
        node_blocks = padded[np.arange(n), np.arange(n)]
        edge_blocks = padded[edge_index[0], edge_index[1]]
        return node_blocks, edge_blocks

    def get_mask(
        self, at_no: np.ndarray, edge_index: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        atom_mask = np.stack([self.atom2mask[int(a)] for a in at_no])
        # masks in the internal (m-permuted) layout
        atom_mask = atom_mask[:, self.m_idx]
        node_mask = atom_mask[:, :, None] * atom_mask[:, None, :]
        edge_mask = (
            atom_mask[edge_index[0]][:, :, None]
            * atom_mask[edge_index[1]][:, None, :]
        )
        return node_mask, edge_mask

    def assemble_blocks(
        self,
        at_no: np.ndarray,
        node_blocks: np.ndarray,
        edge_blocks: np.ndarray,
        edge_index: np.ndarray,
    ) -> np.ndarray:
        n = len(at_no)
        dim = node_blocks.shape[1]
        padded = np.zeros((n, n, dim, dim), dtype=node_blocks.dtype)
        padded[np.arange(n), np.arange(n)] = node_blocks
        padded[edge_index[0], edge_index[1]] = edge_blocks
        # undo the m permutation
        padded = padded[:, :, self._m_inv, :][:, :, :, self._m_inv]
        padded = padded.transpose(0, 2, 1, 3).reshape(n * dim, n * dim)
        return self.unpadding_matrix(at_no, padded)
