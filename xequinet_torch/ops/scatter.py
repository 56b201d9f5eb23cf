"""Masked segment sums, and the collectives of the two decompositions of
one large system over several processes.

Port of ``xequinet_tpu/ops/scatter.py:19-131``.  ``index_add_`` takes the
place of ``jax.ops.segment_sum``.  Where the JAX package runs every shard
in one SPMD program (``shard_map`` over the ``gp`` mesh axis), the port
runs one process per shard in a ``torch.distributed`` group: a
``ppermute`` becomes an exchange between neighbouring ranks
(:class:`RingExchange`) and a ``psum`` an all-reduce (:class:`AllReduce`).
Both are autograd Functions whose backward calls the transposed
collective's ``.apply``, so the force loss can take the gradient of a
gradient through them.

* :func:`halo_parallel` (``parallel/halo.py``): nodes sharded in
  contiguous spatial ranges, each rank holding a window of ``halo + n_local
  + halo`` rows.  ``segment_sum(scope="edges")`` refreshes the window's
  halo rows from the neighbouring ranks, ``scope="graphs"`` all-reduces.
* :func:`edge_parallel` (``parallel/edge_partition.py``): nodes
  replicated, edges split; ``scope="edges"`` all-reduces.

Transport: NCCL moves the rows on the device (one card per rank); gloo
moves host tensors, so a card's rows go through the host inside the
exchange.  Which one runs follows the group's backend, never a fallback;
``EXCHANGE_STATS`` counts the exchanges, their bytes and the transport.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist


def segment_sum(
    src: torch.Tensor,
    index: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
    scope: str = "nodes",
) -> torch.Tensor:
    """Sum of ``src`` rows [M, ...] into ``num_segments`` buckets by
    ``index`` [M]; rows with ``mask`` False add nothing.

    ``scope`` says what the sum means when one system is split over
    processes: ``"nodes"`` a local reduction, ``"edges"`` an edge-to-node
    aggregation (halo rows refreshed under :func:`halo_parallel`, an
    all-reduce under :func:`edge_parallel`), ``"graphs"`` a graph-global
    sum over owned rows (an all-reduce under :func:`halo_parallel`)."""
    if mask is not None:
        m = mask.reshape(mask.shape + (1,) * (src.dim() - 1))
        src = torch.where(m, src, torch.zeros_like(src))
    out = torch.zeros(
        (num_segments,) + tuple(src.shape[1:]), dtype=src.dtype, device=src.device
    )
    out = out.index_add(0, index.long(), src)
    if scope == "edges":
        halo = _HALO_SPEC.get()
        if halo is not None:
            return halo_refresh(out, halo)
        edges = _EDGE_SPEC.get()
        if edges is not None:
            return all_reduce_sum(out, edges[0])
    elif scope == "graphs":
        return reduce_graphs(out)
    return out


def reduce_graphs(t: torch.Tensor) -> torch.Tensor:
    """A graph-global partial sum made whole: the all-reduce over the
    halo group under :func:`halo_parallel`, else ``t`` itself."""
    halo = _HALO_SPEC.get()
    return t if halo is None else all_reduce_sum(t, halo.group)


# ---------------------------------------------------------------------------
# The process group of a decomposition
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class HaloSpec:
    """One rank's place in a halo decomposition: its group (None: one
    process), the group's size and this rank's index in it, the owned rows
    ``n_local`` and the halo rows ``halo`` on either side, and whether the
    ring of ranks closes (a periodic system split along a lattice
    direction)."""

    group: Any
    size: int
    rank: int
    n_local: int
    halo: int
    periodic: bool = False


def group_size_rank(group) -> tuple:
    """(size, rank) of this process in ``group``; (1, 0) without a process
    group."""
    if not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def make_halo_spec(group, n_local: int, halo: int, periodic: bool = False) -> HaloSpec:
    size, rank = group_size_rank(group)
    return HaloSpec(group, size, rank, int(n_local), int(halo), bool(periodic))


_HALO_SPEC: contextvars.ContextVar = contextvars.ContextVar("halo_spec", default=None)
_EDGE_SPEC: contextvars.ContextVar = contextvars.ContextVar("edge_spec", default=None)


@contextlib.contextmanager
def halo_parallel(group, n_local: int, halo: int, periodic: bool = False):
    """Forward-time context of a halo shard (JAX ``halo_parallel``): every
    ``scope="edges"`` sum refreshes its ``halo`` rows on either side from
    the neighbouring ranks of ``group`` (two exchanges of [halo, D] rows),
    every ``scope="graphs"`` sum is all-reduced over the group.  Node
    features are translation-invariant, so rows that wrap a periodic ring
    take no shift (the position window's shift is ``parallel/halo``'s)."""
    token = _HALO_SPEC.set(make_halo_spec(group, n_local, halo, periodic))
    try:
        yield
    finally:
        _HALO_SPEC.reset(token)


@contextlib.contextmanager
def edge_parallel(group):
    """Forward-time context of an edge share (nodes replicated): every
    ``scope="edges"`` sum is all-reduced over ``group`` (None: the default
    group)."""
    token = _EDGE_SPEC.set((group,))
    try:
        yield
    finally:
        _EDGE_SPEC.reset(token)


# ---------------------------------------------------------------------------
# Collectives as autograd Functions
# ---------------------------------------------------------------------------
# exchanges run, bytes this rank sent, host seconds inside them (the
# transfer and, for gloo on a card, the staging through the host; an NCCL
# exchange's device time is not in it) and the transport of the latest one
EXCHANGE_STATS: Dict[str, Any] = {"calls": 0, "bytes": 0, "seconds": 0.0, "transport": None}


def reset_exchange_stats() -> None:
    EXCHANGE_STATS.update(calls=0, bytes=0, seconds=0.0, transport=None)


def transport(group) -> str:
    """"nccl" (rows stay on the device) or "gloo" (host tensors; a card's
    rows are staged through the host)."""
    return dist.get_backend(group)


def _global(group, r: int) -> int:
    if group is None or group is dist.group.WORLD:
        return r
    return dist.get_global_rank(group, r)


def _ring_pairs(size: int, periodic: bool):
    """(left_pairs, right_pairs) of (source, destination) ranks: the left
    halo of rank i comes from rank i-1 (its owned tail), the right halo
    from rank i+1 (its owned head); periodic closes the ring."""
    if periodic:
        left = [(i, (i + 1) % size) for i in range(size)]
        right = [(i, (i - 1) % size) for i in range(size)]
    else:
        left = [(i, i + 1) for i in range(size - 1)]
        right = [(i, i - 1) for i in range(1, size)]
    return left, right


def _ring_exchange(to_right: torch.Tensor, to_left: torch.Tensor, spec: HaloSpec):
    """(from_left, from_right): ``to_right`` of the left neighbour and
    ``to_left`` of the right neighbour; zeros at an open end.  One shard
    on a periodic ring is its own neighbour (a local copy)."""
    if spec.size == 1:
        if spec.periodic:
            return to_right.clone(), to_left.clone()
        return torch.zeros_like(to_right), torch.zeros_like(to_left)
    left_pairs, right_pairs = _ring_pairs(spec.size, spec.periodic)
    r = spec.rank
    send_right = [d for s, d in left_pairs if s == r]
    recv_left = [s for s, d in left_pairs if d == r]
    send_left = [d for s, d in right_pairs if s == r]
    recv_right = [s for s, d in right_pairs if d == r]
    t0 = time.perf_counter()
    kind = transport(spec.group)
    dev = to_right.device
    host = kind != "nccl" and dev.type != "cpu"
    stage = (lambda t: t.detach().cpu()) if host else (lambda t: t.detach().contiguous())
    from_left = torch.zeros_like(to_right, device="cpu" if host else dev)
    from_right = torch.zeros_like(to_left, device="cpu" if host else dev)
    # (op, tensor, peer, tag): tag 0 carries tails to the right, tag 1
    # heads to the left, so the two messages between the ranks of a ring
    # of two stay apart
    ops = ([(dist.isend, stage(to_right), p, 0) for p in send_right]
           + [(dist.isend, stage(to_left), p, 1) for p in send_left]
           + [(dist.irecv, from_left, p, 0) for p in recv_left]
           + [(dist.irecv, from_right, p, 1) for p in recv_right])
    g = spec.group
    if kind == "nccl":
        reqs = dist.batch_isend_irecv(
            [dist.P2POp(op, t, _global(g, p), g, tag) for op, t, p, tag in ops])
    else:
        reqs = [op(t, _global(g, p), group=g, tag=tag) for op, t, p, tag in ops]
    for req in reqs:
        req.wait()
    EXCHANGE_STATS["calls"] += 1
    EXCHANGE_STATS["bytes"] += sum(t.numel() * t.element_size() for op, t, _, _ in ops
                                   if op is dist.isend)
    EXCHANGE_STATS["transport"] = kind + (" (through the host)" if host else "")
    if host:
        from_left, from_right = from_left.to(dev), from_right.to(dev)
    EXCHANGE_STATS["seconds"] += time.perf_counter() - t0
    return from_left, from_right


class RingExchange(torch.autograd.Function):
    """``(from_left, from_right) = RingExchange.apply(to_right, to_left,
    spec)``: the two boundary ``ppermute``s of the JAX package.  The
    transpose of the exchange is the exchange in the other direction, run
    through ``.apply`` so that it is differentiable again."""

    @staticmethod
    def forward(ctx, to_right, to_left, spec):
        ctx.spec = spec
        return _ring_exchange(to_right, to_left, spec)

    @staticmethod
    def backward(ctx, g_left, g_right):
        d_to_left, d_to_right = RingExchange.apply(g_right.contiguous(), g_left.contiguous(),
                                                   ctx.spec)
        return d_to_right, d_to_left, None


def halo_refresh(agg: torch.Tensor, spec: HaloSpec) -> torch.Tensor:
    """The [h + nl + h, ...] window aggregate with its halo rows replaced
    by the neighbours' owned rows (JAX ``_halo_refresh``): the left halo
    from the left rank's rows [nl, nl + h) (its owned tail), the right
    halo from the right rank's rows [h, 2h) (its owned head); zeros at an
    open end."""
    nl, h = spec.n_local, spec.halo
    if h == 0 or (spec.size == 1 and not spec.periodic):
        return agg
    left, right = RingExchange.apply(agg[nl:nl + h].contiguous(), agg[h:2 * h].contiguous(),
                                     spec)
    return torch.cat([left, agg[h:h + nl], right], dim=0)


class AllReduce(torch.autograd.Function):
    """The sum over ``group`` (JAX ``psum``); its backward is the same
    all-reduce of the cotangent, through ``.apply``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.detach().clone().contiguous()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return AllReduce.apply(g.contiguous(), ctx.group), None


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The differentiable sum of ``t`` over ``group``; ``t`` itself
    without a process group or in a group of one."""
    if group_size_rank(group)[0] == 1:
        return t
    return AllReduce.apply(t, group)


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """[size * rows, ...]: ``t`` of every rank of ``group`` in rank order
    (not differentiable).  NCCL gathers on the device, gloo on the host."""
    size, _ = group_size_rank(group)
    if size == 1:
        return t
    dev = t.device
    src = t.detach().contiguous() if transport(group) == "nccl" else t.detach().cpu()
    out = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(out, src, group=group)
    return torch.cat(out).to(dev)
