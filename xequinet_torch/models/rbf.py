"""Radial basis functions and cutoff envelopes.

Port of ``xequinet_tpu/models/rbf.py:20-188``.  Bases with trainable
parameters are modules (their parameters keep the flax names); cutoff
envelopes are parameter-free closures.  ``exponential_cutoff`` and
``flat_cutoff`` are the JAX package's corrected versions, not the
reference's.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
from torch import nn


def resolve_cutoff(cutoff_fn: str, cutoff: float, **kwargs) -> Callable:
    if cutoff_fn == "cosine":
        return cosine_cutoff(cutoff)
    if cutoff_fn == "polynomial":
        return polynomial_cutoff(cutoff, **kwargs)
    if cutoff_fn == "exponential":
        return exponential_cutoff(cutoff)
    if cutoff_fn == "flat":
        return flat_cutoff(cutoff, **kwargs)
    raise NotImplementedError(f"cutoff function {cutoff_fn} is not implemented")


def _inside(dist: torch.Tensor, cutoff: float, val) -> torch.Tensor:
    val = torch.as_tensor(val, dtype=dist.dtype, device=dist.device)
    return torch.where(dist < cutoff, val, torch.zeros_like(val))


def cosine_cutoff(cutoff: float) -> Callable:
    """0.5 (cos(pi d / rc) + 1) inside rc, 0 outside."""

    def fn(dist: torch.Tensor) -> torch.Tensor:
        return _inside(dist, cutoff, 0.5 * (torch.cos(math.pi * dist / cutoff) + 1.0))

    return fn


def polynomial_cutoff(cutoff: float, order: int = 3) -> Callable:
    """The polynomial envelope of Klicpera et al."""
    p = order

    def fn(dist: torch.Tensor) -> torch.Tensor:
        x = dist / cutoff
        val = (1.0 - 0.5 * (p + 1) * (p + 2) * x**p + p * (p + 2) * x ** (p + 1)
               - 0.5 * p * (p + 1) * x ** (p + 2))
        return _inside(dist, cutoff, val)

    return fn


def exponential_cutoff(cutoff: float) -> Callable:
    """exp(-d^2 / ((rc - d)(rc + d))) inside rc."""

    def fn(dist: torch.Tensor) -> torch.Tensor:
        d = torch.where(dist < cutoff, dist, torch.zeros_like(dist))
        denom = (cutoff - d) * (cutoff + d)
        return _inside(dist, cutoff, torch.exp(-(d * d) / torch.clamp(denom, min=1e-12)))

    return fn


def flat_cutoff(cutoff: float, offset_factor: float = 0.1) -> Callable:
    """1 until (1 - offset) rc, then a smooth cubic decay to 0 at rc."""
    if not 0.0 < offset_factor < 1.0:
        raise ValueError(f"offset_factor must lie in (0, 1), got {offset_factor}")

    def fn(dist: torch.Tensor) -> torch.Tensor:
        d_prime = dist / cutoff
        d_tilde = (1.0 - d_prime) / offset_factor
        steep = (3.0 - 2.0 * d_tilde) * d_tilde**2
        val = torch.where(d_prime < (1.0 - offset_factor), torch.ones_like(steep), steep)
        return _inside(dist, cutoff, val)

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


class GaussianSmearing(nn.Module):
    """Gaussians with trainable ``mean`` and ``std``."""

    def __init__(self, num_basis: int = 20, cutoff: float = 5.0, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.mean = nn.Parameter(torch.linspace(0.0, cutoff, num_basis))
        self.std = nn.Parameter(torch.ones(num_basis))

    def forward(self, dist: torch.Tensor) -> torch.Tensor:
        std = self.std.abs() + self.eps
        coeff = 1.0 / (std * math.sqrt(2.0 * math.pi))
        return coeff * torch.exp(-0.5 * ((dist - self.mean) / std) ** 2)


class ExponentialBernstein(nn.Module):
    """Bernstein polynomials of exp(-alpha d); ``alpha`` is a 0-d
    parameter stored through softplus-inverse."""

    def __init__(self, num_basis: int = 20, alpha: float = 0.5):
        super().__init__()
        logfactorial = np.zeros((num_basis,))
        for i in range(2, num_basis):
            logfactorial[i] = logfactorial[i - 1] + np.log(i)
        v = np.arange(0, num_basis)
        n = (num_basis - 1) - v
        logbinomial = logfactorial[-1] - logfactorial[v] - logfactorial[n]
        self.register_buffer("logc", torch.tensor(logbinomial, dtype=torch.float32),
                             persistent=False)
        self.register_buffer("n", torch.tensor(n, dtype=torch.float32), persistent=False)
        self.register_buffer("v", torch.tensor(v, dtype=torch.float32), persistent=False)
        self.alpha = nn.Parameter(torch.tensor(float(np.log(np.expm1(alpha))),
                                               dtype=torch.float32))

    def forward(self, dist: torch.Tensor) -> torch.Tensor:
        alpha = torch.logaddexp(self.alpha, torch.zeros_like(self.alpha))
        x = -alpha * dist
        # the clamp keeps padding edges (dist == 0) finite
        x = self.logc + self.n * x + self.v * torch.log(torch.clamp(-torch.expm1(x), min=1e-12))
        return torch.exp(x)


class ExponentialNorm(nn.Module):
    """exp-normal smearing with trainable ``beta`` and ``mu``."""

    def __init__(self, num_basis: int = 20, cutoff: float = 5.0):
        super().__init__()
        n = np.arange(1, num_basis + 1, dtype=np.float64)
        inv_beta = np.square(2.0 * (1.0 - np.exp(-cutoff)) / n)
        self.beta = nn.Parameter(torch.tensor(1.0 / inv_beta, dtype=torch.float32))
        self.mu = nn.Parameter(torch.linspace(1.0, math.exp(-cutoff), num_basis))

    def forward(self, dist: torch.Tensor) -> torch.Tensor:
        return torch.exp(-self.beta * torch.square(torch.exp(-dist) - self.mu))


_RBF_FACTORY = {
    "bessel": SphericalBesselj0,
    "gaussian": GaussianSmearing,
    "expbern": ExponentialBernstein,
    "expnorm": ExponentialNorm,
}


def resolve_rbf(rbf_kernel: str, num_basis: int, cutoff: float) -> nn.Module:
    """The basis module; its flax name is ``<class name>_0``."""
    if rbf_kernel not in _RBF_FACTORY:
        raise NotImplementedError(f"rbf kernel {rbf_kernel} is not implemented")
    if rbf_kernel == "expbern":
        return ExponentialBernstein(num_basis=num_basis)
    return _RBF_FACTORY[rbf_kernel](num_basis=num_basis, cutoff=cutoff)
