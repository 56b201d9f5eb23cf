"""Convert a reference XequiNet LMDB dataset into an XDB dataset.

Port of the JAX package's ``tools/convert_lmdb_dataset.py``.  Reads the
source through ``data/lmdb_reader.LMDBReader`` (the ``lmdb`` package
where it is installed, else the pure page walker of
``data/lmdb_pure.py``) and the PyG payloads through the tolerant
unpickler, so neither ``lmdb`` nor ``torch_geometric`` is needed.  Host
only: no device is touched.

    python -m xequinet_torch.tools.convert_lmdb_dataset SRC DST [--split NAME]

Source layout (reference xequinet/data/lmdb_data.py): ``data.lmdb`` with
little-endian uint64 keys -> pickled XequiData, plus ``info.json`` (units)
and ``<split>.json`` (train/valid/test indices).  The output holds
``data.xdb``, ``info.json`` with ``num_records`` added and a copy of
``<split>.json``.

Records are written in index order, record i from key i, which is the
order the split file and the in-place reader (``XDBDataset`` on a
``data.lmdb`` directory) use.  The JAX tool writes them in the LMDB
cursor's order, which sorts the keys as bytes: past 256 records that is
not index order (key 256 comes right after key 0), so its copied split
then names other records than the source's.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def convert(src: Path, dst: Path, split_name: str = "split") -> int:
    """Convert ``src/data.lmdb`` into ``dst``; returns the record count."""
    from ..data.lmdb_reader import LMDBReader
    from ..data.store import XDBWriter

    src, dst = Path(src), Path(dst)
    reader = LMDBReader(src / "data.lmdb")
    dst.mkdir(parents=True, exist_ok=True)
    n = len(reader)
    try:
        with XDBWriter(dst / "data.xdb") as writer:
            for i in range(n):
                writer.append(reader[i])
    finally:
        reader.close()

    info_src = src / "info.json"
    info = json.loads(info_src.read_text()) if info_src.exists() else {}
    info["num_records"] = n
    (dst / "info.json").write_text(json.dumps(info, indent=1))
    split_src = src / f"{split_name}.json"
    if split_src.exists():
        (dst / f"{split_name}.json").write_text(split_src.read_text())
    print(f"converted {n} records -> {dst}")
    return n


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src", type=Path)
    ap.add_argument("dst", type=Path)
    ap.add_argument("--split", default="split")
    args = ap.parse_args(argv)
    convert(args.src, args.dst, args.split)


if __name__ == "__main__":
    main()
