"""Irreducible representations of O(3) — static metadata.

Copy of ``xequinet_tpu/ops/irreps.py`` (numpy-free plain Python; the
port keeps its own copy).  It re-creates the e3nn ``o3.Irreps`` concept;
no tensors are created here.  Conventions match
e3nn: an irrep is written ``<l><parity>`` with parity "e" (+1) or "o" (-1);
an ``Irreps`` is a direct sum like ``"128x0e + 64x1o + 32x2e"``; the flat
feature layout per chunk is u-major, i.e. ``(..., mul, 2l+1)`` reshaped to
``(..., mul * (2l+1))``.
"""

from __future__ import annotations

import re
from typing import Iterator, List, NamedTuple, Sequence, Tuple, Union


class Irrep(NamedTuple):
    """A single irreducible representation of O(3): degree l and parity p."""

    l: int
    p: int  # +1 (even, "e") or -1 (odd, "o")

    @property
    def dim(self) -> int:
        return 2 * self.l + 1

    @classmethod
    def parse(cls, s: Union[str, "Irrep", Tuple[int, int]]) -> "Irrep":
        if isinstance(s, Irrep):
            return s
        if isinstance(s, tuple):
            l, p = s
            return cls(int(l), int(p))
        s = s.strip()
        m = re.fullmatch(r"(\d+)([eo])", s)
        if m is None:
            raise ValueError(f"cannot parse irrep {s!r}")
        return cls(int(m.group(1)), 1 if m.group(2) == "e" else -1)

    def __str__(self) -> str:
        return f"{self.l}{'e' if self.p == 1 else 'o'}"

    def __repr__(self) -> str:
        return str(self)

    def __mul__(self, other: "Irrep") -> Iterator["Irrep"]:
        """Selection rule: l in |l1-l2| .. l1+l2, parity multiplies."""
        other = Irrep.parse(other)
        p = self.p * other.p
        for l in range(abs(self.l - other.l), self.l + other.l + 1):
            yield Irrep(l, p)

    def __lt__(self, other) -> bool:  # sort by (l, p) with e before o as e3nn
        return (self.l, -self.p * (-1) ** self.l) < (
            other.l,
            -other.p * (-1) ** other.l,
        )


class MulIrrep(NamedTuple):
    mul: int
    ir: Irrep

    @property
    def dim(self) -> int:
        return self.mul * self.ir.dim

    def __str__(self) -> str:
        return f"{self.mul}x{self.ir}"

    def __repr__(self) -> str:
        return str(self)


IrrepsLike = Union[str, "Irreps", Sequence]


class Irreps(tuple):
    """Direct sum of irreps with multiplicities, e.g. ``128x0e + 64x1o``.

    Immutable and hashable, so it can be a static field of flax modules.
    """

    def __new__(cls, irreps: IrrepsLike):
        if isinstance(irreps, Irreps):
            return super().__new__(cls, irreps)
        out: List[MulIrrep] = []
        if isinstance(irreps, str):
            if irreps.strip():
                for term in irreps.split("+"):
                    term = term.strip()
                    if "x" in term:
                        mul_s, ir_s = term.split("x")
                        out.append(MulIrrep(int(mul_s), Irrep.parse(ir_s)))
                    else:
                        out.append(MulIrrep(1, Irrep.parse(term)))
        elif isinstance(irreps, Irrep):
            out.append(MulIrrep(1, irreps))
        else:
            for item in irreps:
                if isinstance(item, MulIrrep):
                    out.append(item)
                elif isinstance(item, Irrep):
                    out.append(MulIrrep(1, item))
                else:
                    mul, ir = item
                    out.append(MulIrrep(int(mul), Irrep.parse(ir)))
        return super().__new__(cls, out)

    # ---- basic properties ------------------------------------------------
    @property
    def dim(self) -> int:
        return sum(mi.dim for mi in self)

    @property
    def num_irreps(self) -> int:
        return sum(mi.mul for mi in self)

    @property
    def lmax(self) -> int:
        if len(self) == 0:
            raise ValueError("empty irreps has no lmax")
        return max(mi.ir.l for mi in self)

    @property
    def ls(self) -> List[int]:
        return [mi.ir.l for mi in self for _ in range(mi.mul)]

    def slices(self) -> List[slice]:
        out = []
        off = 0
        for mi in self:
            out.append(slice(off, off + mi.dim))
            off += mi.dim
        return out

    def count(self, ir: Union[str, Irrep]) -> int:
        ir = Irrep.parse(ir)
        return sum(mi.mul for mi in self if mi.ir == ir)

    def __contains__(self, ir) -> bool:
        if isinstance(ir, (str, Irrep)):
            ir = Irrep.parse(ir)
            return any(mi.ir == ir for mi in self)
        return super().__contains__(ir)

    # ---- transformations -------------------------------------------------
    def simplify(self) -> "Irreps":
        out: List[Tuple[int, Irrep]] = []
        for mul, ir in self:
            if out and out[-1][1] == ir:
                out[-1] = (out[-1][0] + mul, ir)
            elif mul > 0:
                out.append((mul, ir))
        return Irreps(out)

    def sort(self):
        """Return (sorted_irreps, permutation p, inverse inv) à la e3nn.

        ``p[old_index] = new_index``.
        """
        order = sorted(range(len(self)), key=lambda i: self[i].ir)
        inv = order
        p = [0] * len(self)
        for new_i, old_i in enumerate(order):
            p[old_i] = new_i
        sorted_irreps = Irreps([self[i] for i in order])

        class _Ret(NamedTuple):
            irreps: Irreps
            p: tuple
            inv: tuple

        return _Ret(sorted_irreps, tuple(p), tuple(inv))

    def __add__(self, other) -> "Irreps":
        return Irreps(tuple(self) + tuple(Irreps(other)))

    def __repr__(self) -> str:
        return "+".join(str(mi) for mi in self) if len(self) else "Irreps()"

    def __str__(self) -> str:
        return repr(self)


def split_flat(x, irreps: Irreps):
    """Split a flat feature array [..., irreps.dim] into per-chunk views
    [..., mul, 2l+1] (static slicing: views of ``x``)."""
    chunks = []
    off = 0
    for mul, ir in irreps:
        d = mul * ir.dim
        chunk = x[..., off : off + d]
        chunks.append(chunk.reshape(tuple(chunk.shape[:-1]) + (mul, ir.dim)))
        off += d
    return chunks


def cat_flat(chunks, irreps: Irreps):
    """Inverse of :func:`split_flat`."""
    import torch

    flat = [
        c.reshape(tuple(c.shape[:-2]) + (mul * ir.dim,))
        for c, (mul, ir) in zip(chunks, irreps)
    ]
    return torch.cat(flat, dim=-1)
