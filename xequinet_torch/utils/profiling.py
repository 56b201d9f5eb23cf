"""Tracing and profiling hooks.

Port of ``xequinet_tpu/utils/profiling.py``:

* ``trace(logdir)``: ``torch.profiler`` over the body (host and, on the
  card, device activity), written to ``logdir`` as a Chrome trace
  (``trace.json``, loadable in Perfetto or chrome://tracing);
* ``annotate(name)``: a named range on that timeline
  (``torch.profiler.record_function``), for host phases such as data
  loading and collation;
* ``StepTimer``: wall-clock step statistics (``utils/logger.py``);
* ``device_memory_stats()``: ``torch.cuda.memory_stats`` of every visible
  card.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Iterator

import torch

from .logger import StepTimer

__all__ = ["StepTimer", "annotate", "device_memory_stats", "trace"]


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the body (the host's operators, and the card's kernels when
    a card is present) and write ``logdir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str) -> torch.profiler.record_function:
    return torch.profiler.record_function(name)


def device_memory_stats() -> Dict[str, Dict[str, float]]:
    """Per visible card: bytes in use, the peak and the card's total, in
    GiB (empty without a card)."""
    out = {}
    for i in range(torch.cuda.device_count() if torch.cuda.is_available() else 0):
        m = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use_gb": m.get("allocated_bytes.all.current", 0) / 2**30,
            "peak_bytes_gb": m.get("allocated_bytes.all.peak", 0) / 2**30,
            "limit_gb": torch.cuda.get_device_properties(i).total_memory / 2**30,
        }
    return out
