"""Weighted multi-task loss and error metrics over padded batches.

Port of ``xequinet_tpu/training/loss.py:26-199``.  Every reduction is
masked so padding rows never contribute: per-node properties by
NODE_MASK, per-edge ones by EDGE_MASK, the rest by GRAPH_MASK.  The
special cases are energy per atom and stress = virial / |det(cell)|.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch

from .. import keys

Tensor = torch.Tensor
DataDict = Dict[str, Tensor]


def _criterion(loss_fn: str) -> Callable[[Tensor, Tensor], Tensor]:
    """Elementwise loss (reduction happens in the masked mean)."""
    loss_fn = loss_fn.lower()
    if loss_fn in ("l1", "mae"):
        return lambda p, t: (p - t).abs()
    if loss_fn in ("l2", "mse"):
        return lambda p, t: (p - t) ** 2
    if loss_fn == "smoothl1":

        def smooth_l1(p, t, beta=1.0):
            d = (p - t).abs()
            return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)

        return smooth_l1
    raise NotImplementedError(f"loss function {loss_fn}")


def _mask_for(prop: str, target: DataDict) -> Tensor:
    if prop in keys.NODE_LEVEL_PROPERTIES:
        return target[keys.NODE_MASK]
    if prop in keys.EDGE_LEVEL_PROPERTIES:
        return target[keys.EDGE_MASK]
    return target[keys.GRAPH_MASK]


def _masked_sums(err: Tensor, mask: Tensor) -> Tuple[Tensor, Tensor]:
    """(sum of err over the valid rows, number of valid elements)."""
    extra = math.prod(err.shape[1:])
    m = mask.reshape(mask.shape + (1,) * (err.ndim - 1))
    return torch.where(m, err, torch.zeros_like(err)).sum(), mask.sum() * extra


def _masked_mean(err: Tensor, mask: Tensor) -> Tensor:
    total, count = _masked_sums(err, mask)
    return total / count.clamp(min=1)


def _volume(cell: Tensor) -> Tensor:
    return torch.linalg.det(cell).abs()[:, None, None].clamp(min=1e-9)


class WeightedLoss:
    """Per-property weighted loss; ``matloss`` is MAE + RMSE per property."""

    def __init__(self, loss_fn: str = "l2", **weights: float) -> None:
        if not weights:
            raise ValueError("At least one task should be present")
        self.loss_name = loss_fn.lower()
        self.weights = {k: float(v) for k, v in weights.items()}

    def _prop_loss(self, pred: Tensor, tgt: Tensor, mask: Tensor) -> Tensor:
        if self.loss_name == "matloss":
            mae = _masked_mean((pred - tgt).abs(), mask)
            mse = _masked_mean((pred - tgt) ** 2, mask)
            return mae + torch.sqrt(mse)
        return _masked_mean(_criterion(self.loss_name)(pred, tgt), mask)

    def __call__(self, result: DataDict, target: DataDict) -> Tuple[Tensor, Dict[str, Tensor]]:
        dev = target[keys.GRAPH_MASK].device
        total = torch.zeros((), dtype=torch.float32, device=dev)
        losses: Dict[str, Tensor] = {}

        if keys.ENERGY_PER_ATOM in self.weights:
            n_atoms = target[keys.NUM_ATOMS].float().clamp(min=1.0)
            val = self._prop_loss(result[keys.TOTAL_ENERGY] / n_atoms,
                                  target[keys.TOTAL_ENERGY] / n_atoms,
                                  target[keys.GRAPH_MASK])
            total = total + self.weights[keys.ENERGY_PER_ATOM] * val
            losses[keys.ENERGY_PER_ATOM] = val

        if keys.STRESS in self.weights:
            volume = _volume(target[keys.CELL])
            val = self._prop_loss(result[keys.VIRIAL] / volume,
                                  target[keys.VIRIAL] / volume, target[keys.GRAPH_MASK])
            total = total + self.weights[keys.STRESS] * val
            losses[keys.STRESS] = val

        for prop, w in self.weights.items():
            if prop in (keys.ENERGY_PER_ATOM, keys.STRESS):
                continue
            val = self._prop_loss(result[prop], target[prop], _mask_for(prop, target))
            total = total + w * val
            losses[prop] = val
        return total, losses


class ErrorMetric:
    """Summed L1 / L2 and counts per property, with the paired derived
    metrics (energy <-> energy/atom, virial <-> stress) added."""

    def __init__(self, *properties: str) -> None:
        self.properties = set()
        pairs = {keys.TOTAL_ENERGY: keys.ENERGY_PER_ATOM, keys.ENERGY_PER_ATOM: keys.TOTAL_ENERGY,
                 keys.VIRIAL: keys.STRESS, keys.STRESS: keys.VIRIAL}
        for prop in properties:
            self.properties.add(prop)
            if prop in pairs:
                self.properties.add(pairs[prop])

    def __call__(self, result: DataDict,
                 target: DataDict) -> Dict[str, Tuple[Tensor, Tensor, Tensor]]:
        out = {}
        for prop in self.properties:
            if prop == keys.ENERGY_PER_ATOM:
                n_atoms = target[keys.NUM_ATOMS].float().clamp(min=1.0)
                pred = result[keys.TOTAL_ENERGY] / n_atoms
                tgt = target[keys.TOTAL_ENERGY] / n_atoms
                mask = target[keys.GRAPH_MASK]
            elif prop == keys.STRESS:
                volume = _volume(target[keys.CELL])
                pred = result[keys.VIRIAL] / volume
                tgt = target[keys.VIRIAL] / volume
                mask = target[keys.GRAPH_MASK]
            else:
                if prop not in result or prop not in target:
                    continue
                pred, tgt = result[prop], target[prop]
                mask = _mask_for(prop, target)
            l1, n = _masked_sums((pred - tgt).abs(), mask)
            l2, _ = _masked_sums((pred - tgt) ** 2, mask)
            out[prop] = (l1, l2, n)
        return out


class MetricAccumulator:
    """Host-side accumulation of (l1, l2, count) triples -> MAE / RMSE."""

    def __init__(self) -> None:
        self.sums: Dict[str, list] = {}

    def update(self, metrics: Dict[str, Tuple]) -> None:
        for prop, (l1, l2, n) in metrics.items():
            acc = self.sums.setdefault(prop, [0.0, 0.0, 0])
            acc[0] += float(l1)
            acc[1] += float(l2)
            acc[2] += int(n)

    def compute(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for prop, (l1, l2, n) in self.sums.items():
            n = max(n, 1)
            out[prop] = {"mae": l1 / n, "rmse": math.sqrt(l2 / n), "count": n}
        return out

    def reset(self) -> None:
        self.sums = {}
