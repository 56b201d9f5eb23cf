"""Real spherical harmonics in the e3nn convention, built recursively.

Port of ``xequinet_tpu/ops/spherical.py:1-110``:

    Y_0 = 1,   Y_1(u) = u,   Y_l ∝ w3j(l-1, 1, l) · (Y_{l-1} ⊗ u)

with the per-degree scale fixed so that Y_l at the pole u = (0,1,0) has
+1 on its m=0 component ('norm'); 'component' multiplies degree l by
sqrt(2l+1).  Inputs are in the irrep basis: callers permute geometric
(x,y,z) vectors to (y,z,x).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Union

import numpy as np
import torch

from .irreps import Irreps
from .wigner import wigner_3j


@lru_cache(maxsize=None)
def _sh_scale(l: int) -> float:
    """Factor applied to the raw recursion output at degree l."""
    if l <= 1:
        return 1.0
    u = np.zeros(3)
    u[1] = 1.0
    y = u.copy()
    factor = 1.0
    for ll in range(2, l + 1):
        y_raw = np.einsum("abm,a,b->m", wigner_3j(ll - 1, 1, ll), y, u)
        factor = 1.0 / y_raw[ll]
        y = y_raw * factor
    return float(factor)


def _norm_scale(l: int, normalization: str) -> float:
    if normalization == "component":
        return float(np.sqrt(2 * l + 1))
    if normalization == "norm":
        return 1.0
    if normalization == "integral":
        return float(np.sqrt((2 * l + 1) / (4 * np.pi)))
    raise ValueError(f"unknown normalization {normalization}")


def spherical_harmonics(
    irreps: Union[str, Irreps],
    vectors: torch.Tensor,
    normalize: bool = True,
    normalization: str = "component",
    eps: float = 1e-12,
) -> torch.Tensor:
    """Harmonics of ``vectors`` [..., 3] for every irrep in ``irreps``;
    each (mul, l) chunk gets the degree-l harmonics tiled ``mul`` times.
    Zero vectors (padding edges) give zero harmonics for l >= 1."""
    irreps = Irreps(irreps)
    for _, ir in irreps:
        if ir.p != (-1) ** ir.l:
            raise ValueError(
                f"irrep {ir} has parity incompatible with spherical harmonics"
            )
    if normalize:
        norm2 = torch.sum(vectors * vectors, dim=-1, keepdim=True)
        inv = torch.where(
            norm2 > eps, 1.0 / torch.sqrt(torch.clamp(norm2, min=eps)),
            torch.zeros_like(norm2),
        )
        u = vectors * inv
    else:
        u = vectors

    ys = {0: torch.ones(u.shape[:-1] + (1,), dtype=u.dtype, device=u.device), 1: u}
    for l in range(2, irreps.lmax + 1):
        w = torch.as_tensor(wigner_3j(l - 1, 1, l), dtype=u.dtype, device=u.device)
        ys[l] = torch.einsum("...a,...b,abm->...m", ys[l - 1], u, w) * _sh_scale(l)

    chunks = []
    for mul, ir in irreps:
        y = ys[ir.l] * _norm_scale(ir.l, normalization)
        if mul > 1:
            y = y.unsqueeze(-2).expand(y.shape[:-1] + (mul, ir.dim))
            y = y.reshape(y.shape[:-2] + (mul * ir.dim,))
        chunks.append(y)
    return torch.cat(chunks, dim=-1)
