"""v2 gather-scale-scatter: the equivariant-state aggregate of XPaiNN's v2
message route (``use_pallas_scatter=True``), as a hand-written CUDA
kernel for Hopper with plain PyTorch beside it.

Port of ``xequinet_tpu/ops/pallas_scatter_v2.py``: ``_kernel`` (:105, via
``gather_scale_scatter_v2`` :157-221) becomes ``csrc/gather_scatter_v2.cu``,
whose source note says what bounds it on the H100 and what its design does
about that; ``reference_impl`` (:224-228) and the differentiable
``fused_gather_scale_scatter`` (:234-276) come as they are, and
``prepare_v2`` (:38-102) is the host-side layout of ``ops/slot_layout.py``.
Over the block-aligned slot layout,

    out[b*BN + dst2[k]] += x[window_starts[b] + src2[k]] * w2[k]

for the slots k of each destination block b's chunk range; padding slots
(dst2 == BN) and slots past the last block's range add nothing.

Dispatch: the plain version for tensors on the CPU (the tests); for CUDA
tensors the kernel, or an error.  The kernel's launches count in
``cuda_build.LAUNCHES["gather_scatter_v2"]``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..models import remat
from .cuda_build import launch
from .fused_message import build_slot_plan, slot_rows
from .scatter import segment_sum
from .slot_layout import prepare_v2  # noqa: F401  (the op's host-side layout)


def reference_impl(x, src, dst, w, n_out):
    """``segment_sum(x[src] * w, dst)`` over the edges in their own order
    (pallas_scatter_v2.py:224-228)."""
    return segment_sum(x.index_select(0, src.long()) * w, dst, n_out)


def gather_scale_scatter_v2_plain(x, w2, src2, dst2, chunk_base, n_chunks, window_starts,
                                  n_out, block_nodes, chunk):
    """The op in plain tensor ops: index_select, multiply, index_add, with
    ``out`` in ``x.dtype``.  A bf16 ``w2`` multiplies as PyTorch promotes
    it (the kernel rounds where the TPU kernel does; the bf16 band covers
    the difference)."""
    src_row, dst_row, valid = slot_rows(src2, dst2, chunk_base, n_chunks, window_starts,
                                        n_out, x.shape[0], block_nodes, chunk)
    msg = x.index_select(0, torch.where(valid, src_row, 0)) * w2
    msg = torch.where(valid[:, None], msg, torch.zeros((), dtype=msg.dtype, device=msg.device))
    out = torch.zeros((n_out, x.shape[1]), dtype=x.dtype, device=x.device)
    return out.index_add(0, torch.where(valid, dst_row, 0), msg.to(x.dtype))


def v2_slot_plan(src2, dst2, chunk_base, n_chunks, window_starts, n_out, n_rows,
                 block_nodes, chunk) -> Dict[str, torch.Tensor]:
    """The CSR slot plan the kernel walks (``fused_message.build_slot_plan``
    on the v2 layout)."""
    return build_slot_plan((src2, dst2, None, None, chunk_base, n_chunks, window_starts),
                           n_out, n_rows, block_nodes, chunk)


def gather_scale_scatter_v2_cuda(x, w2, plan: Dict[str, torch.Tensor], n_out: int):
    """out [n_out, D] f32 by ``csrc/gather_scatter_v2.cu``: x f32, w2 f32 or
    bf16, ``plan`` from :func:`v2_slot_plan`."""
    if not x.is_cuda:
        raise ValueError("gather_scale_scatter_v2_cuda takes CUDA tensors")
    if x.dtype != torch.float32 or w2.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("gather_scale_scatter_v2: x must be float32, w2 float32 or bfloat16")
    if w2.dim() != 2 or w2.shape[1] != x.shape[1] or plan["dst_ptr"].numel() != n_out + 1:
        raise ValueError("gather_scale_scatter_v2: shapes do not match the slot plan")
    xk, wk = x.contiguous(), w2.contiguous()
    out = torch.empty((n_out, x.shape[1]), dtype=torch.float32, device=x.device)
    idx = (plan["dst_ptr"], plan["dst_slots"], plan["slot_src"])
    if any(t.device != x.device or not t.is_contiguous() for t in (wk,) + idx):
        raise ValueError("gather_scale_scatter_v2: tensors must be contiguous, on x's device")
    launch(
        "gather_scatter_v2", xk.data_ptr(), wk.data_ptr(), *(t.data_ptr() for t in idx),
        out.data_ptr(), n_out, x.shape[1], int(w2.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    return out


def gather_scale_scatter_v2(x, w2, src2, dst2, chunk_base, n_chunks, window_starts,
                            n_out: int, block_nodes: int, chunk: int, window: int,
                            max_chunks: int, plan: Optional[Dict[str, torch.Tensor]] = None):
    """``out[b*BN + dst2[k]] += x[ws[b] + src2[k]] * w2[k]``, cut to
    ``[:n_out]``, in ``x.dtype`` (pallas_scatter_v2.py:157-221): the kernel
    for CUDA tensors (with ``plan`` if the caller built it), the plain
    version for CPU tensors.  ``window`` and ``max_chunks`` size the TPU
    grid; the layout of ``prepare_v2`` / collate keeps every block inside
    them (collate raises otherwise), so they bound nothing here."""
    if x.is_cuda:
        if plan is None:
            plan = v2_slot_plan(src2, dst2, chunk_base, n_chunks, window_starts, n_out,
                                x.shape[0], block_nodes, chunk)
        return gather_scale_scatter_v2_cuda(x, w2, plan, n_out)
    if x.device.type != "cpu":
        raise NotImplementedError(f"gather_scale_scatter_v2 on {x.device}")
    return gather_scale_scatter_v2_plain(x, w2, src2, dst2, chunk_base, n_chunks,
                                         window_starts, n_out, block_nodes, chunk)


class FusedGatherScaleScatter(torch.autograd.Function):
    """``fused_gather_scale_scatter`` (pallas_scatter_v2.py:234-276).

    Forward: :func:`gather_scale_scatter_v2`.  Backward: ``_fused_bwd``'s
    plain ops (:265-273), written with differentiable out-of-place ops on
    the saved tensors, so that under ``create_graph=True`` (force
    training) autograd differentiates them a second time, as JAX does.
    The backward is plain in the JAX package too."""

    @staticmethod
    def forward(ctx, x, w, slot_src_global, slot_meta, n_out, block_nodes, chunk,
                window, max_chunks):
        src2, dst2, dst_global, cb, nc, ws = slot_meta[:6]
        plan = slot_meta[6] if len(slot_meta) > 6 else None
        ctx.save_for_backward(x, w, slot_src_global)
        ctx.dst_global = dst_global
        if remat.recomputing():
            # the message block only sums this aggregate into its outputs and
            # the backward reads the inputs alone: a recompute launches nothing
            return x.new_empty((n_out, x.shape[1]))
        return gather_scale_scatter_v2(x, w, src2, dst2, cb, nc, ws, n_out, block_nodes,
                                       chunk, window, max_chunks, plan)

    @staticmethod
    def backward(ctx, g):
        x, w, src_g = ctx.saved_tensors
        src_g = src_g.long()
        ge = g.index_select(0, ctx.dst_global.long())
        dx = torch.zeros_like(x).index_add(0, src_g, (ge * w).to(x.dtype))
        dw = (ge * x.index_select(0, src_g)).to(w.dtype)
        return (dx, dw) + (None,) * 7


def fused_gather_scale_scatter(x, w, slot_src_global, slot_meta, n_out, block_nodes, chunk,
                               window, max_chunks):
    """out[c] = sum over slots with destination c of x[src] * w.

    ``w`` is in block-aligned slot order with zeros on padding slots;
    ``slot_src_global`` are the global source rows per slot (for the
    backward); slot_meta = (src2, dst2, dst_global, chunk_base, n_chunks,
    window_starts[, slot plan])."""
    return FusedGatherScaleScatter.apply(x, w, slot_src_global, slot_meta, n_out,
                                         block_nodes, chunk, window, max_chunks)
