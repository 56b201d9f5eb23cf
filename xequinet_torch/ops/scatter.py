"""Masked segment sums.

Port of ``xequinet_tpu/ops/scatter.py:89-131`` without the halo scopes
(halo decomposition is a later slice).  ``index_add_`` takes the place of
``jax.ops.segment_sum``.
"""

from __future__ import annotations

from typing import Optional

import torch


def segment_sum(
    src: torch.Tensor,
    index: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sum of ``src`` rows [M, ...] into ``num_segments`` buckets by
    ``index`` [M]; rows with ``mask`` False add nothing."""
    if mask is not None:
        m = mask.reshape(mask.shape + (1,) * (src.dim() - 1))
        src = torch.where(m, src, torch.zeros_like(src))
    out = torch.zeros(
        (num_segments,) + tuple(src.shape[1:]), dtype=src.dtype, device=src.device
    )
    return out.index_add(0, index.long(), src)
