"""XDB: an mmap-friendly record store for datapoints.

Copy of ``xequinet_tpu/data/store.py:19-263`` (numpy and mmap only), so
the two packages read each other's datasets byte for byte.  A dataset
directory holds ``data.xdb``, ``info.json`` (units + metadata) and
``<split>.json`` (train/valid/test index lists).  The store is one
append-only file of length-prefixed records with a trailing offset index.

Record format (little-endian):
  [uint32 n_fields] then per field:
    [uint16 name_len][name utf8][uint8 dtype_len][dtype str]
    [uint8 ndim][int64 shape...][raw bytes]
File layout:
  [8-byte magic "XDBSTOR1"][int64 size, record]...[int64 offsets...][int64 n_records]

A directory with ``data.lmdb`` and no ``data.xdb`` (a reference XequiNet
LMDB dataset) is read in place through ``data/lmdb_reader.LMDBReader``.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Union

import numpy as np

from .datapoint import Datapoint

MAGIC = b"XDBSTOR1"

_SCALAR_FIELDS = {"charge", "spin", "energy", "base_energy"}
_ARRAY_FIELDS = [
    "atomic_numbers",
    "pos",
    "pbc",
    "cell",
    "edge_index",
    "cell_offsets",
    "forces",
    "base_forces",
    "virial",
    "atomic_charges",
    "base_charges",
    "dipole",
    "base_dipole",
    "polar",
]


def _ser_record(fields: Dict[str, np.ndarray]) -> bytes:
    out = [struct.pack("<I", len(fields))]
    for name, arr in fields.items():
        arr = np.ascontiguousarray(arr)
        nb = name.encode()
        out.append(struct.pack("<H", len(nb)))
        out.append(nb)
        ds = arr.dtype.str.encode()
        out.append(struct.pack("<B", len(ds)))
        out.append(ds)
        out.append(struct.pack("<B", arr.ndim))
        out.append(struct.pack(f"<{arr.ndim}q", *arr.shape))
        out.append(arr.tobytes())
    return b"".join(out)


def _deser_record(buf: Union[bytes, memoryview]) -> Dict[str, np.ndarray]:
    off = 0
    (n_fields,) = struct.unpack_from("<I", buf, off)
    off += 4
    fields = {}
    for _ in range(n_fields):
        (nlen,) = struct.unpack_from("<H", buf, off)
        off += 2
        name = bytes(buf[off : off + nlen]).decode()
        off += nlen
        (dlen,) = struct.unpack_from("<B", buf, off)
        off += 1
        dtype = np.dtype(bytes(buf[off : off + dlen]).decode())
        off += dlen
        (ndim,) = struct.unpack_from("<B", buf, off)
        off += 1
        shape = struct.unpack_from(f"<{ndim}q", buf, off)
        off += 8 * ndim
        nbytes = int(np.prod(shape)) * dtype.itemsize if ndim else dtype.itemsize
        arr = np.frombuffer(buf, dtype=dtype, count=max(int(np.prod(shape)), 1), offset=off)
        arr = arr.reshape(shape)
        off += nbytes
        fields[name] = arr
    return fields


def datapoint_to_fields(dp: Datapoint) -> Dict[str, np.ndarray]:
    fields: Dict[str, np.ndarray] = {}
    for f in _ARRAY_FIELDS:
        v = getattr(dp, f)
        if v is not None:
            fields[f] = np.asarray(v)
    for f in _SCALAR_FIELDS:
        v = getattr(dp, f)
        if v is not None:
            fields[f] = np.asarray(v)
    for k, v in dp.extras.items():
        fields["x:" + k] = np.asarray(v)
    return fields


def fields_to_datapoint(fields: Dict[str, np.ndarray]) -> Datapoint:
    kw = {}
    extras = {}
    for k, v in fields.items():
        if k.startswith("x:"):
            extras[k[2:]] = np.array(v)
        elif k in _SCALAR_FIELDS:
            kw[k] = v.item()
        else:
            kw[k] = np.array(v)
    return Datapoint(extras=extras, **kw)


class XDBWriter:
    def __init__(self, path: Union[str, Path]) -> None:
        self.path = Path(path)
        self._f = open(self.path, "wb")
        self._f.write(MAGIC)
        self._offsets: List[int] = []

    def append(self, dp: Datapoint) -> int:
        blob = _ser_record(datapoint_to_fields(dp))
        self._offsets.append(self._f.tell())
        self._f.write(struct.pack("<q", len(blob)))
        self._f.write(blob)
        return len(self._offsets) - 1

    def close(self) -> None:
        for off in self._offsets:
            self._f.write(struct.pack("<q", off))
        self._f.write(struct.pack("<q", len(self._offsets)))
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class XDBReader:
    """Zero-copy random-access reader over one mmap (safe for concurrent
    readers, like the reference's read-only LMDB env, lmdb_data.py:45-56)."""

    def __init__(self, path: Union[str, Path]) -> None:
        self.path = Path(path)
        self._file = open(self.path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        if self._mm[:8] != MAGIC:
            self.close()
            raise ValueError(f"{path} is not an XDB store")
        (self._n,) = struct.unpack_from("<q", self._mm, len(self._mm) - 8)
        idx_start = len(self._mm) - 8 - 8 * self._n
        self._offsets = np.frombuffer(
            self._mm, dtype="<i8", count=self._n, offset=idx_start
        ).copy()  # copy so no exported pointer pins the mmap open

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i: int) -> Datapoint:
        off = int(self._offsets[i])
        (size,) = struct.unpack_from("<q", self._mm, off)
        view = memoryview(self._mm)[off + 8 : off + 8 + size]
        return fields_to_datapoint(_deser_record(view))

    def close(self) -> None:
        self._mm.close()
        self._file.close()


# ---------------------------------------------------------------------------
# Dataset directory: data.xdb + info.json + <split>.json
# ---------------------------------------------------------------------------


def create_dataset(
    db_path: Union[str, Path],
    datapoints: Iterable[Datapoint],
    units: Optional[Dict[str, str]] = None,
    split: Optional[Dict[str, Sequence[int]]] = None,
    split_name: str = "split",
) -> Path:
    """Create a dataset directory (the create_lmdb_dataset equivalent,
    reference lmdb_data.py:88-172)."""
    db_path = Path(db_path)
    db_path.mkdir(parents=True, exist_ok=True)
    with XDBWriter(db_path / "data.xdb") as w:
        n = 0
        for dp in datapoints:
            w.append(dp)
            n += 1
    info = {"units": units or {}, "num_records": n}
    (db_path / "info.json").write_text(json.dumps(info, indent=1))
    if split is None:
        idx = list(range(n))
        n_train = max(int(0.8 * n), 1)
        n_valid = max(int(0.1 * n), 1) if n > 2 else 0
        split = {
            "train": idx[:n_train],
            "valid": idx[n_train : n_train + n_valid],
            "test": idx[n_train + n_valid :],
        }
    (db_path / f"{split_name}.json").write_text(
        json.dumps({k: list(map(int, v)) for k, v in split.items()})
    )
    return db_path


class XDBDataset:
    """Random-access dataset over a store directory with a transform
    pipeline and a split filter (the LMDBDataset equivalent,
    reference lmdb_data.py:29-85)."""

    def __init__(
        self,
        db_path: Union[str, Path],
        split: str = "train",
        split_name: str = "split",
        transform=None,
        max_num_samples: Optional[int] = None,
    ) -> None:
        self.db_path = Path(db_path)
        xdb = self.db_path / "data.xdb"
        if xdb.exists():
            self.reader = XDBReader(xdb)
        elif (self.db_path / "data.lmdb").exists():
            from .lmdb_reader import LMDBReader

            self.reader = LMDBReader(self.db_path / "data.lmdb")
        else:
            raise FileNotFoundError(f"no data.xdb or data.lmdb under {self.db_path}")
        info = json.loads((self.db_path / "info.json").read_text())
        self.units: Dict[str, str] = info.get("units", {})
        split_file = self.db_path / f"{split_name}.json"
        if split_file.exists():
            indices = json.loads(split_file.read_text()).get(split, [])
        else:
            indices = list(range(len(self.reader)))
        if max_num_samples:
            indices = indices[:max_num_samples]
        self.indices = np.asarray(indices, dtype=np.int64)
        self.transform = transform

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, i: int) -> Datapoint:
        dp = self.reader[int(self.indices[i])]
        if self.transform is not None:
            dp = self.transform(dp)
        return dp
