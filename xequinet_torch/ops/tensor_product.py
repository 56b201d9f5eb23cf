"""Clebsch-Gordan tensor products with e3nn semantics.

Port of ``xequinet_tpu/ops/tensor_product.py``.  The instructions and
their normalisation coefficients are computed in Python floats exactly
as the JAX package computes them (``irrep_normalization`` component /
norm / none, ``path_normalization`` element / path / none), so one flat
weight vector gives the same outputs in both packages.

Each path contracts its operands pairwise in an order written out here:
the Wigner-3j table C [i, j, k] meets one operand first, the other
second, and the multiplicities and weights last.  In the modes that pair
the channels (``uuw``, ``uuu``) the first pair is whichever of a·C, b·C
or a⊗b is the smallest, so that no [..., u, i, j, k] tensor is ever built.
f32 products run without TF32 (the caller keeps
``torch.backends.cuda.matmul.allow_tf32`` False, its default).
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .irreps import Irrep, Irreps
from .wigner import wigner_3j


class Instruction(NamedTuple):
    i_in1: int
    i_in2: int
    i_out: int
    mode: str  # uvw | uvu | uvv | uuw | uuu | uvuv
    has_weight: bool
    path_weight: float = 1.0


MODES = ("uvw", "uvu", "uvv", "uuw", "uuu", "uvuv")


def _fan(mode: str, mul1: int, mul2: int) -> int:
    return {"uvw": mul1 * mul2, "uvu": mul2, "uvv": mul1, "uuw": mul1, "uuu": 1,
            "uvuv": 1}[mode]


def _weight_shape(ins: Instruction, irreps_in1: Irreps, irreps_in2: Irreps,
                  irreps_out: Irreps) -> Tuple[int, ...]:
    m1, m2 = irreps_in1[ins.i_in1].mul, irreps_in2[ins.i_in2].mul
    mo = irreps_out[ins.i_out].mul
    return {"uvw": (m1, m2, mo), "uvu": (m1, m2), "uvv": (m1, m2), "uuw": (m1, mo),
            "uuu": (m1,), "uvuv": (m1, m2)}[ins.mode]


def _cg_pairs(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """sum_ij a[..., u, i] b[..., v, j] C[i, j, k] -> [..., u, v, k]."""
    ac = torch.einsum("...ui,ijk->...ujk", a, c)
    return torch.einsum("...ujk,...vj->...uvk", ac, b)


def _cg_paired(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """sum_ij a[..., u, i] b[..., u, j] C[i, j, k] -> [..., u, k], through
    the smallest of the three first products."""
    di, dj, dk = c.shape
    first = min((dj * dk, 0), (di * dk, 1), (di * dj, 2))[1]
    if first == 0:
        return torch.einsum("...ujk,...uj->...uk", torch.einsum("...ui,ijk->...ujk", a, c), b)
    if first == 1:
        return torch.einsum("...uik,...ui->...uk", torch.einsum("...uj,ijk->...uik", b, c), a)
    ab = a.unsqueeze(-1) * b.unsqueeze(-2)  # [..., u, i, j]
    return (ab.reshape(ab.shape[:-2] + (di * dj,)) @ c.reshape(di * dj, dk))


class TensorProduct:
    """A compiled tensor product: static metadata and Wigner-3j tables.

    ``apply(x1, x2, weights)`` computes it; modules own the parameters.
    """

    def __init__(self, irreps_in1, irreps_in2, irreps_out,
                 instructions: Sequence[Union[Instruction, Tuple]],
                 irrep_normalization: str = "component",
                 path_normalization: str = "element") -> None:
        self.irreps_in1 = Irreps(irreps_in1)
        self.irreps_in2 = Irreps(irreps_in2)
        self.irreps_out = Irreps(irreps_out)
        self.instructions = [ins if isinstance(ins, Instruction) else Instruction(*ins)
                             for ins in instructions]
        fan = lambda o: o.path_weight * _fan(o.mode, self.irreps_in1[o.i_in1].mul,
                                             self.irreps_in2[o.i_in2].mul)
        self.alphas: List[float] = []
        for ins in self.instructions:
            if irrep_normalization == "component":
                alpha = float(self.irreps_out[ins.i_out].ir.dim)
            elif irrep_normalization == "norm":
                alpha = float(self.irreps_in1[ins.i_in1].ir.dim
                              * self.irreps_in2[ins.i_in2].ir.dim)
            elif irrep_normalization == "none":
                alpha = 1.0
            else:
                raise ValueError(irrep_normalization)
            same_out = [o for o in self.instructions if o.i_out == ins.i_out]
            if path_normalization == "element":
                x = sum(fan(o) for o in same_out)
            elif path_normalization == "path":
                x = fan(ins) * len(same_out)
            elif path_normalization == "none":
                x = 1.0
            else:
                raise ValueError(path_normalization)
            if x > 0.0:
                alpha /= x
            alpha *= ins.path_weight
            self.alphas.append(math.sqrt(alpha))
        self.weight_shapes = [
            _weight_shape(ins, self.irreps_in1, self.irreps_in2, self.irreps_out)
            if ins.has_weight else None for ins in self.instructions]
        self.weight_numel = sum(int(np.prod(s)) for s in self.weight_shapes if s is not None)
        self._tables = {}  # (device, dtype) -> each path's Wigner-3j table

    def tables(self, device, dtype) -> List[torch.Tensor]:
        """Each path's Wigner-3j table, copied to ``device`` once."""
        key = (torch.device(device), dtype)
        if key not in self._tables:
            self._tables[key] = [
                torch.as_tensor(wigner_3j(self.irreps_in1[i.i_in1].ir.l,
                                          self.irreps_in2[i.i_in2].ir.l,
                                          self.irreps_out[i.i_out].ir.l),
                                dtype=dtype, device=device) for i in self.instructions]
        return self._tables[key]

    def apply(self, x1: torch.Tensor, x2: torch.Tensor,
              weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x1 [..., irreps_in1.dim], x2 [..., irreps_in2.dim]; ``weights``
        flat [weight_numel] (shared) or [..., weight_numel] (per sample)."""
        sl1, sl2 = self.irreps_in1.slices(), self.irreps_in2.slices()
        batch = torch.broadcast_shapes(x1.shape[:-1], x2.shape[:-1])
        shared = weights is not None and weights.dim() == 1
        out = {}
        w_off = 0
        for ins, alpha, wshape, c in zip(self.instructions, self.alphas, self.weight_shapes,
                                         self.tables(x1.device, x1.dtype)):
            mul1, ir1 = self.irreps_in1[ins.i_in1]
            mul2, ir2 = self.irreps_in2[ins.i_in2]
            mulo, iro = self.irreps_out[ins.i_out]
            a = x1[..., sl1[ins.i_in1]].reshape(x1.shape[:-1] + (mul1, ir1.dim))
            b = x2[..., sl2[ins.i_in2]].reshape(x2.shape[:-1] + (mul2, ir2.dim))
            w = None
            if ins.has_weight:
                if weights is None:
                    raise ValueError("tensor product expects weights")
                n = int(np.prod(wshape))
                wflat = weights[..., w_off : w_off + n]
                w = wflat.reshape(wflat.shape[:-1] + wshape)
                w_off += n
            e = "" if shared else "..."
            if ins.mode in ("uuw", "uuu"):
                p = _cg_paired(a, b, c)  # [..., u, k]
                if ins.mode == "uuu":
                    res = p if w is None else p * w.unsqueeze(-1)
                elif w is None:
                    res = p.sum(dim=-2, keepdim=True)
                else:
                    res = torch.einsum(f"...uk,{e}uw->...wk", p, w)
            else:
                p = _cg_pairs(a, b, c)  # [..., u, v, k]
                if ins.mode == "uvw":
                    if w is None:
                        raise ValueError("a uvw path needs weights")
                    res = torch.einsum(f"...uvk,{e}uvw->...wk", p, w)
                elif ins.mode == "uvuv":
                    res = p if w is None else p * w.unsqueeze(-1)
                    res = res.reshape(res.shape[:-3] + (mul1 * mul2, iro.dim))
                else:
                    red = -2 if ins.mode == "uvu" else -3
                    res = (p if w is None else p * w.unsqueeze(-1)).sum(dim=red)
            res = torch.broadcast_to(alpha * res, batch + (mulo, iro.dim))
            out[ins.i_out] = out[ins.i_out] + res if ins.i_out in out else res
        pieces = []
        for i_out, (mulo, iro) in enumerate(self.irreps_out):
            chunk = out.get(i_out)
            if chunk is None:
                chunk = torch.zeros(batch + (mulo, iro.dim), dtype=x1.dtype, device=x1.device)
            pieces.append(chunk.reshape(batch + (mulo * iro.dim,)))
        return torch.cat(pieces, dim=-1)

    def __call__(self, x1, x2, weights=None):
        return self.apply(x1, x2, weights)


def get_feasible_tp(irreps_in1, irreps_in2, filter_irreps_out, tp_mode: str = "uvw",
                    trainable: bool = True) -> Tuple[Irreps, List[Instruction]]:
    """Every CG-allowed path into ``filter_irreps_out``, with the
    reference's (QHNet's) normalisation: the fan-in sum runs over every
    instruction, not only those that share an output.  Returns the sorted
    middle irreps and the instructions pointing into them."""
    if tp_mode not in MODES:
        raise ValueError(f"unknown tensor product mode {tp_mode!r}")
    irreps_in1, irreps_in2 = Irreps(irreps_in1), Irreps(irreps_in2)
    filter_irreps_out = Irreps(filter_irreps_out)
    irreps_mid: List[Tuple[int, Irrep]] = []
    raw: List[Tuple[int, int, int]] = []
    for i, (mul1, ir1) in enumerate(irreps_in1):
        for j, (mul2, ir2) in enumerate(irreps_in2):
            for ir_out in ir1 * ir2:
                if ir_out not in filter_irreps_out:
                    continue
                if tp_mode in ("uuu", "uuw") and mul1 != mul2:
                    raise ValueError(f"{tp_mode} pairs channels: {mul1} != {mul2}")
                mul_out = {"uvw": filter_irreps_out.count(ir_out), "uvu": mul1,
                           "uvv": mul2, "uuu": mul1,
                           "uuw": filter_irreps_out.count(ir_out),
                           "uvuv": mul1 * mul2}[tp_mode]
                key = (mul_out, ir_out)
                if key not in irreps_mid:
                    irreps_mid.append(key)
                raw.append((i, j, irreps_mid.index(key)))
    mid = Irreps(irreps_mid)
    x_total = sum(_fan(tp_mode, irreps_in1[i].mul, irreps_in2[j].mul) for i, j, _ in raw)
    alphas = []
    for _, _, k in raw:
        alpha = float(mid[k].ir.dim)
        if x_total > 0:
            alpha /= x_total
        alphas.append(math.sqrt(alpha))
    sorted_irreps, p, _ = mid.sort()
    return sorted_irreps, [Instruction(i, j, p[k], tp_mode, trainable, alpha)
                           for (i, j, k), alpha in zip(raw, alphas)]
