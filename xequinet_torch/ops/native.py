"""ctypes binding of the host C++ neighbour search (``csrc/neighborlist.cpp``).

Port of ``xequinet_tpu/ops/native.py:28-140``.  The source is compiled
with ``g++`` at first use into ``xequinet_torch/_build`` (a library named
by a hash of the source, written to a temporary name and renamed, so
concurrent processes never load a half-written file).  Without a
compiler every function returns None and ``ops/radius_graph.py`` takes
its numpy path.  Host code, not a kernel of the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .cuda_build import BUILD_DIR, CSRC_DIR

_SRC = CSRC_DIR / "neighborlist.cpp"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _so_path() -> Path:
    digest = hashlib.sha1(_SRC.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libxeqnative_{digest}.so"


def _build() -> Optional[ctypes.CDLL]:
    global _build_failed
    so = _so_path()
    if so.exists():
        return ctypes.CDLL(str(so))
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             str(_SRC), "-o", str(tmp)],
            check=True, capture_output=True,
        )
        os.replace(tmp, so)
        return ctypes.CDLL(str(so))
    except (subprocess.CalledProcessError, FileNotFoundError, OSError):
        _build_failed = True
        if tmp.exists():
            tmp.unlink()
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is None and not _build_failed:
            lib = _build()
            if lib is not None:
                lib.xeq_radius_graph.restype = ctypes.c_int64
                lib.xeq_radius_graph.argtypes = [
                    ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_double,
                    ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ]
                lib.xeq_radius_graph_pbc.restype = ctypes.c_int64
                lib.xeq_radius_graph_pbc.argtypes = [
                    ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
                    ctypes.c_double, ctypes.POINTER(ctypes.c_int64),
                    ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ]
            _lib = lib
    return _lib


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def radius_graph_native(
    pos: np.ndarray, cutoff: float
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Cell-list non-PBC neighbour search; None when the library is
    unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    pos = np.ascontiguousarray(pos, dtype=np.float64)
    n = pos.shape[0]
    cap = max(64, n * 64)
    while True:
        edges = np.empty(2 * cap, dtype=np.int64)
        found = lib.xeq_radius_graph(_dptr(pos), n, float(cutoff), _iptr(edges), cap)
        if found <= cap:
            break
        cap = int(found) + 16
    ei = np.stack([edges[:found], edges[cap : cap + found]])
    return ei, np.zeros((found, 3), dtype=np.float64)


def radius_graph_pbc_native(
    pos: np.ndarray, cell: np.ndarray, reps: np.ndarray, cutoff: float
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Image-expansion cell-list search on wrapped positions; returns
    (edge_index, integer offsets) or None when the library is
    unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    pos = np.ascontiguousarray(pos, dtype=np.float64)
    cell = np.ascontiguousarray(cell, dtype=np.float64)
    reps = np.ascontiguousarray(reps, dtype=np.int64)
    n = pos.shape[0]
    cap = max(64, n * 80)
    while True:
        edges = np.empty(2 * cap, dtype=np.int64)
        offs = np.empty(3 * cap, dtype=np.int64)
        found = lib.xeq_radius_graph_pbc(
            _dptr(pos), n, _dptr(cell), _iptr(reps), float(cutoff),
            _iptr(edges), _iptr(offs), cap,
        )
        if found <= cap:
            break
        cap = int(found) + 16
    ei = np.stack([edges[:found], edges[cap : cap + found]])
    return ei, offs[: 3 * found].reshape(found, 3).copy()
