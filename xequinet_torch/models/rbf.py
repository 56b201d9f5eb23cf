"""Radial basis functions and cutoff envelopes.

Port of ``xequinet_tpu/models/rbf.py:20-41, 90-105, 183-188``: the Bessel
basis and the cosine cutoff.  The other names raise NotImplementedError
until a later slice ports them.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch import nn


def resolve_cutoff(cutoff_fn: str, cutoff: float) -> Callable:
    if cutoff_fn == "cosine":
        return cosine_cutoff(cutoff)
    raise NotImplementedError(f"cutoff function {cutoff_fn} is not ported yet")


def cosine_cutoff(cutoff: float) -> Callable:
    """0.5 (cos(pi d / rc) + 1) inside rc, 0 outside."""

    def fn(dist: torch.Tensor) -> torch.Tensor:
        val = 0.5 * (torch.cos(math.pi * dist / cutoff) + 1.0)
        return torch.where(dist < cutoff, val, torch.zeros_like(val))

    return fn


class SphericalBesselj0(nn.Module):
    """sin(f_n d)/(d + eps) with trainable frequencies ``freq``."""

    def __init__(self, num_basis: int = 20, cutoff: float = 5.0, eps: float = 1e-5):
        super().__init__()
        self.cutoff = cutoff
        self.eps = eps
        self.freq = nn.Parameter(
            math.pi * torch.arange(1, num_basis + 1, dtype=torch.float32) / cutoff
        )

    def forward(self, dist: torch.Tensor) -> torch.Tensor:
        coeff = math.sqrt(2.0 / self.cutoff)
        return coeff * torch.sin(self.freq * dist) / (dist + self.eps)


def resolve_rbf(rbf_kernel: str, num_basis: int, cutoff: float) -> nn.Module:
    if rbf_kernel == "bessel":
        return SphericalBesselj0(num_basis=num_basis, cutoff=cutoff)
    raise NotImplementedError(f"rbf kernel {rbf_kernel} is not ported yet")
