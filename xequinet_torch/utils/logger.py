"""Logging and step timing.

Copy of ``xequinet_tpu/utils/logger.py`` (``ZeroLogger``) and of
``StepTimer`` from ``xequinet_tpu/utils/profiling.py:37-66``.  In a
process group only rank 0 logs; the other ranks get a logger that
drops everything.
"""

from __future__ import annotations

import logging
import os
import sys
import time
from typing import Dict, List, Optional


class _NoOpLogger:
    def __getattr__(self, name):
        return lambda *a, **k: None


def ZeroLogger(log_file: Optional[str] = None, name: str = "xequinet",
               level: int = logging.INFO):
    from ..parallel.mesh import rank

    if rank() != 0:
        return _NoOpLogger()
    logger = logging.getLogger(name)
    logger.setLevel(level)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    fmt = logging.Formatter("%(asctime)s [%(levelname)s] %(message)s")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file:
        parent = os.path.dirname(log_file)
        if parent:
            os.makedirs(parent, exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.propagate = False
    return logger


class StepTimer:
    """Wall-clock step statistics (mean / p50 / p95) over the last
    ``capacity`` steps; the caller ends each timed region after the work
    it measures is done (a ``torch.cuda.synchronize()`` on the card)."""

    def __init__(self, capacity: int = 1000) -> None:
        self.capacity = capacity
        self.samples: List[float] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self._t0 is not None:
            self.samples.append(time.perf_counter() - self._t0)
            self._t0 = None
            if len(self.samples) > self.capacity:
                self.samples = self.samples[-self.capacity :]

    def stats(self) -> Dict[str, float]:
        if not self.samples:
            return {}
        s = sorted(self.samples)
        n = len(s)
        return {
            "mean_ms": 1e3 * sum(s) / n,
            "p50_ms": 1e3 * s[n // 2],
            "p95_ms": 1e3 * s[min(int(0.95 * n), n - 1)],
            "count": n,
        }

    def reset(self) -> None:
        self.samples = []
