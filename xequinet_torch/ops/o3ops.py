"""Parameter-free O(3) primitives of the XPaiNN hot path.

Port of ``xequinet_tpu/ops/o3ops.py:38-160``.  Every op rides two
constant structure matrices per irreps layout,

    G [num_irreps, dim]   gate broadcast: lane j of irrep u -> G[u, j] = 1
    S [dim,  num_irreps]  inner-product reduction: S[j, u] = c_l(u)

so gating is ``x * (s @ G)``, the per-irrep inner product is
``(x1 * x2) @ S`` and the LayerNorm RMS rides the same S.  Float32
products run without TF32 (the caller keeps
``torch.backends.cuda.matmul.allow_tf32`` False, its default).
"""

from __future__ import annotations

import functools
from typing import Union

import numpy as np
import torch

from .irreps import Irreps
from .wigner import irrep_inner_coeff


@functools.lru_cache(maxsize=None)
def structure(irreps: Irreps):
    """(G [num_irreps, dim], S [dim, num_irreps], (scalar_mask [dim],
    scalar_idx, scalar_gates)) as numpy f32 / int32."""
    dim, ni = irreps.dim, irreps.num_irreps
    g = np.zeros((ni, dim), dtype=np.float32)
    s = np.zeros((dim, ni), dtype=np.float32)
    scalar_mask = np.zeros((dim,), dtype=np.float32)
    scalar_idx, scalar_gates = [], []
    gate = 0
    lane = 0
    for mul, ir in irreps:
        c = irrep_inner_coeff(ir.l)
        for _ in range(mul):
            g[gate, lane : lane + ir.dim] = 1.0
            s[lane : lane + ir.dim, gate] = c
            if ir.l == 0 and ir.p == 1:
                scalar_mask[lane] = 1.0
                scalar_idx.append(lane)
                scalar_gates.append(gate)
            gate += 1
            lane += ir.dim
    return g, s, (scalar_mask, np.asarray(scalar_idx, dtype=np.int64),
                  np.asarray(scalar_gates, dtype=np.int64))


def _mm(a: torch.Tensor, m: np.ndarray) -> torch.Tensor:
    return a @ torch.as_tensor(m, dtype=a.dtype, device=a.device)


def scalar_gate(
    x: torch.Tensor, s: torch.Tensor, irreps: Union[str, Irreps]
) -> torch.Tensor:
    """Channel-wise scalar gating (e3nn
    ``ElementwiseTensorProduct(irreps, f"{num_irreps}x0e")``).

    x: [..., irreps.dim];  s: [..., irreps.num_irreps]  ->  [..., irreps.dim]
    """
    g, _, _ = structure(Irreps(irreps))
    return x * _mm(s, g)


def equivariant_dot(
    x1: torch.Tensor, x2: torch.Tensor, irreps: Union[str, Irreps]
) -> torch.Tensor:
    """Per-irrep inner product out_u = c_l * sum_m x1[u,m] x2[u,m]
    -> [..., num_irreps]."""
    _, s, _ = structure(Irreps(irreps))
    return _mm(x1 * x2, s)


def invariant(
    x: torch.Tensor,
    irreps: Union[str, Irreps],
    squared: bool = False,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Modulus of each irrep: sqrt(c_l * ||x_u||^2 + eps^2) - eps."""
    sq = equivariant_dot(x, x, irreps)
    if squared:
        return sq
    return torch.sqrt(sq + eps * eps) - eps


def scalar_indices(irreps: Union[str, Irreps]) -> np.ndarray:
    """Flat indices of the even scalar (0e) lanes."""
    return structure(Irreps(irreps))[2][1]


def equivariant_layer_norm(
    x: torch.Tensor,
    irreps: Union[str, Irreps],
    weight: torch.Tensor,
    bias: torch.Tensor,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Equivariant LayerNorm (o3ops.py:127-159): mean-centre the even
    scalars, divide by the RMS of the per-irrep squared invariants, then a
    per-irrep weight and a bias on the scalar lanes.

    weight: [num_irreps]; bias: [num_scalars].
    """
    irreps = Irreps(irreps)
    g, s, (scalar_mask, scalar_idx, _) = structure(irreps)
    num_scalar = len(scalar_idx)
    if num_scalar > 0:
        mean = _mm(x, scalar_mask[:, None] / num_scalar)
        x = x - mean * torch.as_tensor(scalar_mask, dtype=x.dtype, device=x.device)
    inv_sq = _mm(x * x, s)
    inv_rms = 1.0 / torch.sqrt(torch.mean(inv_sq, dim=-1, keepdim=True) + eps)
    w_lane = _mm(weight, g)
    out = x * inv_rms * w_lane
    if num_scalar > 0:
        b_lane = torch.zeros((x.shape[-1],), dtype=out.dtype, device=out.device)
        idx = torch.as_tensor(scalar_idx, device=out.device)
        b_lane = b_lane.index_copy(0, idx, bias[:num_scalar].to(out.dtype))
        out = out + b_lane
    return out
