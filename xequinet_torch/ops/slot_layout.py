"""Host-side block-aligned slot layout of the fused message kernels.

Port of ``prepare_v2`` (``xequinet_tpu/ops/pallas_scatter_v2.py:38-102``),
numpy only.  Two structural facts of collated batches make it work:

* edges never cross molecules and each graph's nodes are contiguous, so
  for a destination block of ``BN`` nodes every source index lies in a
  contiguous window of ``W`` nodes around it;
* edges are sorted by destination, so per-block edge runs are contiguous
  in the edge axis; each run is padded to a multiple of the chunk ``C``.

Padding slots carry ``dst2 == BN`` and add nothing in the kernels.
"""

from __future__ import annotations

import numpy as np


def window_size(block_nodes: int, pad_nodes: int) -> int:
    """Gather window of one destination block (multiple of 8 margins)."""
    return block_nodes + 2 * ((pad_nodes + 7) // 8) * 8


def prepare_v2(
    src: np.ndarray,
    dst: np.ndarray,
    n_out: int,
    block_nodes: int,
    chunk: int,
    pad_nodes: int,
):
    """Returns (src2, dst2, edge_select, chunk_base, n_chunks,
    window_starts, window, max_chunks):

    * ``edge_select[k]`` = original edge index feeding padded slot k, or
      -1 for padding slots;
    * src2 is window-local, dst2 block-local (== block_nodes on padding).

    Raises if a source falls outside its destination's window (molecule
    larger than ``pad_nodes``).
    """
    n_blocks = (n_out + block_nodes - 1) // block_nodes
    bounds = np.arange(1, n_blocks + 1) * block_nodes
    ends = np.searchsorted(dst, bounds, side="left")
    starts = np.concatenate([[0], ends[:-1]])
    counts = ends - starts
    padded_counts = ((counts + chunk - 1) // chunk) * chunk
    padded_counts = np.maximum(padded_counts, chunk)
    chunk_starts = np.concatenate([[0], np.cumsum(padded_counts)[:-1]])
    total = int(padded_counts.sum())

    window = window_size(block_nodes, pad_nodes)
    window_starts = np.arange(n_blocks) * block_nodes - (window - block_nodes) // 2
    window_starts = np.clip(window_starts, 0, max(n_out - window, 0))
    window_starts = (window_starts // 8) * 8

    edge_select = np.full(total, -1, dtype=np.int64)
    src2 = np.zeros(total, dtype=np.int32)
    dst2 = np.full(total, block_nodes, dtype=np.int32)
    for b in range(n_blocks):
        s, e = int(starts[b]), int(ends[b])
        o = int(chunk_starts[b])
        k = e - s
        if k == 0:
            continue
        edge_select[o : o + k] = np.arange(s, e)
        src_loc = src[s:e] - window_starts[b]
        if src_loc.min() < 0 or src_loc.max() >= window:
            raise ValueError(
                f"source outside node window for block {b}; increase "
                f"pad_nodes (largest molecule > {pad_nodes}?)"
            )
        src2[o : o + k] = src_loc
        dst2[o : o + k] = dst[s:e] - b * block_nodes
    n_chunks = (padded_counts // chunk).astype(np.int32)
    return (
        src2,
        dst2,
        edge_select,
        (chunk_starts // chunk).astype(np.int32),
        n_chunks,
        window_starts.astype(np.int32),
        int(window),
        int(n_chunks.max()),
    )
