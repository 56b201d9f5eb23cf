"""The JAX package's native neighbour search, built privately for a test
module of the port.

The port reproduces the JAX package's C++ cell lists edge for edge, and
the tests that compare edge orders hold it to them.  The JAX package loads
``xequinet_tpu/native/libxeqnative.so`` from its source tree, rebuilds it
in place whenever it is older than its source, and falls back to its
numpy search (another edge order) for the rest of the process after any
error while loading it; several pytest-xdist workers starting at once can
meet such an error.  :func:`private_jax_native` points the JAX loader at a
library of its own under a temporary directory (one g++ run, about a
second), so no other process can touch it, and restores the loader's
state afterwards.  The JAX package itself is not changed.
"""

from __future__ import annotations

import contextlib
from pathlib import Path

import pytest


@contextlib.contextmanager
def private_jax_native(directory):
    """The JAX package's native library, compiled into ``directory`` and
    loaded in place of the shared one while the context lasts."""
    from xequinet_tpu.ops import native as jn

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jn, "_SO", Path(directory) / "libxeqnative.so")
        mp.setattr(jn, "_lib", None)
        mp.setattr(jn, "_build_failed", False)
        lib = jn.get_lib()
        assert lib is not None, (
            "the JAX package's native neighbour search did not build into a private path "
            "(g++ on xequinet_tpu/native/neighborlist.cpp): without it the JAX reference "
            "falls back to its numpy search, whose edge order differs from the cell lists' "
            "that the port reproduces")
        yield lib


def module_fixture(tmp_path_factory):
    """Body of the module-scoped fixtures of the test files that compare
    edge orders with the JAX package."""
    with private_jax_native(tmp_path_factory.mktemp("jax_native")):
        yield
