"""Build, load and count the port's hand-written CUDA kernels.

One registry for every source under ``xequinet_torch/csrc``: each is
compiled by ``nvcc`` for ``sm_90a`` at first use into
``xequinet_torch/_build`` (a shared library with a plain C interface,
named by a hash of its sources) and bound with ``ctypes``.  The op
modules (``fused_message``, ``gather_scatter_v2``, ``gather_scatter``)
launch through :func:`kernel_fn` and count each launch in ``LAUNCHES``.
Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

_P = ctypes.c_void_p
_I = ctypes.c_int
_MESSAGE_HEADERS = ("message_common.cuh", "message_tile.cuh")
# name -> (source, headers it includes, C entry point, argtypes)
_KERNELS = {
    "message_fwd": ("message_fwd.cu", _MESSAGE_HEADERS, "xeq_message_fwd",
                    [_P] * 10 + [_I] * 10 + [_P]),
    "message_bwd": ("message_bwd.cu", _MESSAGE_HEADERS, "xeq_message_bwd",
                    [_P] * 20 + [_I] * 12 + [_P]),
    "message_bwd2": ("message_bwd2.cu", _MESSAGE_HEADERS, "xeq_message_bwd2",
                     [_P] * 28 + [_I] * 15 + [_P]),
    "gather_scatter_v2": ("gather_scatter_v2.cu", (), "xeq_gather_scatter_v2",
                          [_P] * 6 + [_I] * 3 + [_P]),
    "gather_scatter": ("gather_scatter.cu", (), "xeq_gather_scatter",
                       [_P] * 7 + [_I] * 5 + [_P]),
}

# launches of each CUDA kernel wrapper (one per wrapper call that launched)
LAUNCHES: Dict[str, int] = {name: 0 for name in _KERNELS}
# per source: {"seconds": nvcc wall time, "ptxas": registers / smem report}
BUILD_INFO: Dict[str, Dict[str, object]] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME / nvcc)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _lib_path(name: str) -> Path:
    src, headers = _KERNELS[name][:2]
    h = hashlib.sha1()
    for f in (src,) + headers:
        h.update((CSRC_DIR / f).read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def build_kernels(names=None) -> Dict[str, Dict[str, object]]:
    """Compile the named sources (all by default) that are not built yet,
    one nvcc per source, all started together; raises on a failed build.
    Returns BUILD_INFO."""
    names = list(_KERNELS) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            BUILD_INFO.setdefault(name, {"seconds": 0.0, "ptxas": "(cached)"})
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [
            _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-o", str(tmp), str(CSRC_DIR / _KERNELS[name][0]),
        ]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       time.perf_counter(), tmp, out)

    def finish(item):  # each nvcc's own wall time, not the wait in turn
        name, (p, t0, tmp, out) = item
        so, se = p.communicate()
        return name, p.returncode, time.perf_counter() - t0, se + so, tmp, out

    with ThreadPoolExecutor(max_workers=max(len(procs), 1)) as pool:
        done = list(pool.map(finish, procs.items()))
    for name, rc, seconds, report, tmp, out in done:
        BUILD_INFO[name] = {"seconds": seconds, "ptxas": report}
        if rc != 0:
            raise RuntimeError(f"nvcc failed for {_KERNELS[name][0]}:\n{report}")
        os.replace(tmp, out)
    return BUILD_INFO


def kernel_fn(name: str):
    """The C entry point of kernel ``name``, built and loaded on first use."""
    if name not in _LIBS:
        build_kernels([name])
        _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
    sym, argtypes = _KERNELS[name][2:]
    fn = getattr(_LIBS[name], sym)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def launch(name: str, *args) -> None:
    """Launch kernel ``name`` on its C entry point (pointers and the stream
    as Python ints); raises on a CUDA error and counts the launch."""
    err = kernel_fn(name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
