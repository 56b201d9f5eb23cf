"""Direct reading of reference XequiNet LMDB datasets.

Port of ``xequinet_tpu/data/lmdb_reader.py``.  Reference XequiNet keeps
its datasets in LMDB (little-endian uint64 keys -> pickled
``XequiData``).  The port's native store is XDB (data/store.py), but a
dataset directory with ``data.lmdb`` and no ``data.xdb`` is read in
place through this backend: the ``lmdb`` package where it is importable,
else the pure-Python page walker (data/lmdb_pure.py).  torch_geometric is
not needed (see below).

Deserialization without torch_geometric: the pickled records reference
``torch_geometric.data`` classes, which are not (and should not be) a
dependency of this package.  ``TolerantUnpickler`` substitutes inert
stub objects for any ``torch_geometric.*`` class; PyG objects pickle as
plain attribute dicts (Data -> {_store: BaseStorage}, BaseStorage ->
{_mapping: {name: tensor}}), so a recursive name lookup over the stub
tree recovers every tensor by field name.  Tensors themselves unpickle
with plain torch (baked in).
"""

from __future__ import annotations

import io
import pickle
from pathlib import Path
from typing import Any, Dict, Optional, Union

import numpy as np

from .datapoint import Datapoint


class _Stub:
    """Stand-in for an unavailable class during unpickling: keeps state
    as plain attributes and supports the reduce protocols pickle uses."""

    def __init__(self, *args, **kwargs) -> None:  # constructor-style reduce
        if args:
            self._args = args
        self.__dict__.update(kwargs)

    def __setstate__(self, state: Any) -> None:
        if isinstance(state, dict):
            self.__dict__.update(state)
        elif isinstance(state, tuple):
            for part in state:
                if isinstance(part, dict):
                    self.__dict__.update(part)
        else:
            self._state = state

    def __repr__(self) -> str:  # debugging aid
        return f"_Stub({sorted(self.__dict__)})"


class TolerantUnpickler(pickle.Unpickler):
    """Unpickler that replaces torch_geometric classes with stubs.

    Everything else (torch tensors, numpy arrays, builtins) resolves
    normally, so tensor payloads come back intact.
    """

    _STUB_PREFIXES = ("torch_geometric.",)

    def find_class(self, module: str, name: str):
        if module.startswith(self._STUB_PREFIXES) or module in (
            "torch_geometric",
        ):
            return type(name, (_Stub,), {"__module__": module})
        return super().find_class(module, name)


def tolerant_loads(blob: bytes) -> Any:
    return TolerantUnpickler(io.BytesIO(blob)).load()


def pyg_dumps(fields: Dict[str, Any]) -> bytes:
    """Pickle ``fields`` (name -> tensor) as reference XequiNet pickles its
    ``XequiData``: a ``torch_geometric.data.Data`` whose ``_store`` is a
    ``BaseStorage`` with ``_mapping = fields``.  The two classes are bare
    stand-ins in stand-in modules, put into ``sys.modules`` only while
    pickling, so torch_geometric is not needed and reading the blob back
    needs ``tolerant_loads``."""
    import sys
    import types

    names = ("torch_geometric", "torch_geometric.data")
    tg, tgd = (types.ModuleType(n) for n in names)
    BaseStorage = type("BaseStorage", (), {"__module__": names[1]})
    Data = type("Data", (), {"__module__": names[1]})
    tgd.BaseStorage, tgd.Data, tg.data = BaseStorage, Data, tgd
    saved = {n: sys.modules.get(n) for n in names}
    sys.modules.update(zip(names, (tg, tgd)))
    try:
        store, rec = BaseStorage(), Data()
        store._mapping, rec._store = fields, store
        return pickle.dumps(rec)
    finally:
        for n, mod in saved.items():
            if mod is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = mod


def _lookup(obj: Any, name: str, depth: int = 0) -> Any:
    """Find ``name`` anywhere in a stub/dict tree (bounded depth)."""
    if depth > 5:
        raise KeyError(name)
    if isinstance(obj, dict):
        if name in obj:
            return obj[name]
        for v in obj.values():
            if isinstance(v, (dict, _Stub)):
                try:
                    return _lookup(v, name, depth + 1)
                except KeyError:
                    pass
        raise KeyError(name)
    if isinstance(obj, _Stub):
        return _lookup(obj.__dict__, name, depth + 1)
    raise KeyError(name)


def _to_numpy(v: Any) -> Optional[np.ndarray]:
    if v is None:
        return None
    if hasattr(v, "detach"):  # torch tensor
        return np.asarray(v.detach().cpu())
    return np.asarray(v)


def record_to_datapoint(data: Any) -> Datapoint:
    """Extract a Datapoint from an unpickled reference record (a real
    XequiData, or the stub tree from TolerantUnpickler): cell / pbc
    reshaped, per-graph tensors squeezed of their leading batch dim."""

    def arr(name: str) -> Optional[np.ndarray]:
        try:
            return _to_numpy(_lookup(data, name)) if isinstance(
                data, (_Stub, dict)
            ) else _to_numpy(getattr(data, name, None))
        except KeyError:
            return None

    def scalar(name: str):
        v = arr(name)
        return None if v is None else v.reshape(-1)[0].item()

    kw: Dict[str, Any] = dict(
        atomic_numbers=arr("atomic_numbers"), pos=arr("pos")
    )
    cell = arr("cell")
    if cell is not None:
        pbc = arr("pbc")
        kw["cell"] = cell.reshape(3, 3)
        kw["pbc"] = pbc.reshape(3) if pbc is not None else np.ones(3, bool)
    for field in ("energy", "base_energy", "charge", "spin"):
        v = scalar(field)
        if v is not None:
            kw[field] = v
    for field in (
        "forces", "base_forces", "virial", "atomic_charges",
        "base_charges", "dipole", "base_dipole", "polar",
    ):
        v = arr(field)
        if v is not None:
            kw[field] = np.squeeze(v) if field in (
                "virial", "dipole", "base_dipole", "polar"
            ) else v
    return Datapoint(**kw)


class LMDBReader:
    """Random-access reader over a reference ``data.lmdb`` file.

    Uses the lmdb C package when available (read-only, no lock,
    subdir=False, as reference XequiNet opens it), and falls back to the
    pure-Python B-tree walker (data/lmdb_pure.py) otherwise, so reference
    datasets are read on any host without native packages.  Indices are
    positions in the reference's key scheme: little-endian uint64 record
    ids.
    """

    def __init__(self, path: Union[str, Path]) -> None:
        self.path = Path(path)
        try:
            import lmdb
        except ImportError:  # zero-dep fallback
            from .lmdb_pure import PureLMDBReader

            self._pure = PureLMDBReader(self.path)
            self._env = None
            self._n = self._pure.entries
            return
        self._pure = None
        self._env = lmdb.open(
            str(self.path), readonly=True, lock=False, subdir=False,
            map_size=2**40, readahead=False, meminit=False,
        )
        with self._env.begin() as txn:
            self._n = txn.stat()["entries"]

    def __len__(self) -> int:
        return self._n

    def _get_blob(self, key: bytes) -> Optional[bytes]:
        if self._env is None:
            return self._pure.get(key)
        with self._env.begin(buffers=True) as txn:
            blob = txn.get(key)
            return None if blob is None else bytes(blob)

    def __getitem__(self, i: int) -> Datapoint:
        blob = self._get_blob(int(i).to_bytes(8, "little"))
        if blob is None:
            raise IndexError(f"record {i} not in {self.path}")
        return record_to_datapoint(tolerant_loads(blob))

    def close(self) -> None:
        if self._env is not None:
            self._env.close()
        else:
            self._pure.close()
