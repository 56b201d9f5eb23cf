"""v1 gather-scale-scatter: ``out[c] = sum_{dst[e] == c} x[src[e]] * w[e]``
over sorted destinations and unwindowed sources, as a hand-written CUDA
kernel for Hopper with plain PyTorch beside it.

Port of ``xequinet_tpu/ops/pallas_scatter.py``: ``prepare_blocks``
(:51-71), ``_kernel`` (:74, via ``_gather_scale_scatter_impl`` :140-189)
as ``csrc/gather_scatter.cu`` (its source note says what bounds it on
the H100 and what its design does about that), and the differentiable
``gather_scale_scatter`` (:192-233).  No model path runs it; it is the
standalone op that ``bench_kernels.py::run`` measures in the JAX package.

Semantics of the TPU kernel kept here: destination block b adds the
edges of its run ``[starts[b], starts[b] + counts[b])`` into its rows, so
an edge adds only inside its destination block's run, and rows past
``n_out`` are cut.  ``w`` is ``[E, D]`` or ``[E, 1]`` (broadcast over
the columns); padding edges carry ``w == 0``.

Dispatch: the plain version for tensors on the CPU (the tests); for CUDA
tensors the kernel, or an error.  The kernel's launches count in
``cuda_build.LAUNCHES["gather_scatter"]``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .cuda_build import launch


def prepare_blocks(dst: np.ndarray, n_out: int, block_nodes: int,
                   edges_per_block: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side edge binning: for sorted ``dst``, (edge_start [n_blocks],
    edge_count [n_blocks]) int32 per destination block.  Raises if a block
    exceeds ``edges_per_block`` (the caller re-buckets)."""
    n_blocks = (n_out + block_nodes - 1) // block_nodes
    bounds = np.arange(1, n_blocks + 1) * block_nodes
    ends = np.searchsorted(dst, bounds, side="left")
    starts = np.concatenate([[0], ends[:-1]])
    counts = ends - starts
    if (counts > edges_per_block).any():
        raise ValueError(
            f"destination block exceeds edge capacity "
            f"({counts.max()} > {edges_per_block})"
        )
    return starts.astype(np.int32), counts.astype(np.int32)


def _run_bounds(rows, starts, counts, block_nodes):
    """[start, end) of the block run that each destination row's edges
    must lie in."""
    b = (rows // block_nodes).clamp(max=starts.numel() - 1)
    s = starts.long()[b]
    return s, s + counts.long()[b]


def gather_scale_scatter_plain(x, src, dst, w, starts, counts, n_out: int, block_nodes: int):
    """The op in plain tensor ops: index_select, multiply, index_add, with
    ``out`` in ``x.dtype``."""
    dst = dst.long()
    e = torch.arange(dst.numel(), device=dst.device)
    lo, hi = _run_bounds(dst, starts, counts, block_nodes)
    adds = (e >= lo) & (e < hi) & (dst < n_out)
    msg = x.index_select(0, src.long()) * w
    msg = torch.where(adds[:, None], msg, torch.zeros((), dtype=msg.dtype, device=msg.device))
    out = torch.zeros((n_out, x.shape[1]), dtype=x.dtype, device=x.device)
    return out.index_add(0, torch.where(adds, dst, 0), msg.to(x.dtype))


def row_edge_ranges(dst, starts, counts, n_out: int, block_nodes: int):
    """(row_lo, row_hi) int32 [n_out]: the edges of destination row c are
    ``row_lo[c] .. row_hi[c] - 1`` of the sorted ``dst``, cut to c's block
    run.  The plain statement of the ranges the kernel finds itself (by a
    search of ``dst`` inside the block's run), on ``dst``'s device."""
    d64 = dst.long().contiguous()
    rows = torch.arange(n_out, device=dst.device, dtype=torch.int64)
    s, e = _run_bounds(rows, starts, counts, block_nodes)
    lo = torch.maximum(torch.searchsorted(d64, rows), s)
    hi = torch.minimum(torch.searchsorted(d64, rows, right=True), e)
    return lo.int().contiguous(), torch.maximum(hi, lo).int().contiguous()


def gather_scale_scatter_cuda(x, src, dst, w, starts, counts, n_out: int, block_nodes: int):
    """out [n_out, D] f32 by ``csrc/gather_scatter.cu``: one launch, which
    finds each row's edge range itself; x and w float32."""
    if not x.is_cuda:
        raise ValueError("gather_scale_scatter_cuda takes CUDA tensors")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise ValueError("gather_scale_scatter: x and w must be float32")
    d = x.shape[1]
    if w.dim() != 2 or w.shape[0] != src.numel() or w.shape[1] not in (d, 1):
        raise ValueError("gather_scale_scatter: w must be [E, D] or [E, 1]")
    if dst.numel() != src.numel():
        raise ValueError("gather_scale_scatter: src and dst differ in length")
    xk, wk = x.contiguous(), w.contiguous()
    # no-ops for the int32 indices of prepare_blocks
    sk, dk, stk, ck = (t.int().contiguous() for t in (src, dst, starts, counts))
    out = torch.empty((n_out, d), dtype=torch.float32, device=x.device)
    if any(t.device != x.device for t in (wk, sk, dk, stk, ck)):
        raise ValueError("gather_scale_scatter: tensors must be on x's device")
    launch(
        "gather_scatter", xk.data_ptr(), wk.data_ptr(), sk.data_ptr(), dk.data_ptr(),
        stk.data_ptr(), ck.data_ptr(), out.data_ptr(), n_out, d, int(w.shape[1] == d),
        block_nodes, stk.numel(), torch.cuda.current_stream(x.device).cuda_stream,
    )
    return out


class GatherScaleScatter(torch.autograd.Function):
    """``gather_scale_scatter``'s custom VJP (pallas_scatter.py:192-233).
    Forward: the kernel on CUDA, the plain version on the CPU.  Backward:
    ``_bwd``'s plain ops (:216-230) with differentiable out-of-place ops, so
    a second order differentiates them as JAX does; ``dw`` is summed over
    the columns for an ``[E, 1]`` weight."""

    @staticmethod
    def forward(ctx, x, src, dst, w, starts, counts, n_out, block_nodes):
        ctx.save_for_backward(x, src, dst, w)
        args = (x, src, dst, w, starts, counts, n_out, block_nodes)
        if x.is_cuda:
            return gather_scale_scatter_cuda(*args)
        if x.device.type != "cpu":
            raise NotImplementedError(f"gather_scale_scatter on {x.device}")
        return gather_scale_scatter_plain(*args)

    @staticmethod
    def backward(ctx, g):
        x, src, dst, w = ctx.saved_tensors
        src = src.long()
        ge = g.index_select(0, dst.long())
        dx = torch.zeros_like(x).index_add(0, src, (ge * w).to(x.dtype))
        dw = ge * x.index_select(0, src)
        if w.shape[1] != x.shape[1]:
            dw = dw.sum(dim=1, keepdim=True)
        return dx, None, None, dw.to(w.dtype), None, None, None, None


def gather_scale_scatter(x, srcdst, w, block_meta, n_out: int, block_nodes: int):
    """out[c] = sum_e [dst[e] == c] x[src[e]] * w[e].

    srcdst: (src [E], dst [E]) with dst sorted ascending; block_meta:
    (starts, counts) from :func:`prepare_blocks`; w: [E, D] or [E, 1]."""
    src, dst = srcdst
    starts, counts = block_meta
    return GatherScaleScatter.apply(x, src, dst, w, starts, counts, n_out, block_nodes)
