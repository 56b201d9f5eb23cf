"""Pure-Python LMDB file access: a read-only B-tree page walker and a
minimal single-transaction writer.

Copy of ``xequinet_tpu/data/lmdb_pure.py`` (struct and mmap only).
Reference XequiNet datasets are LMDB files (little-endian uint64 keys ->
pickled records); the ``lmdb`` C package is not a given on the card's
host.  The on-disk format
(LMDB 0.9.x, ``MDB_DATA_VERSION = 1``) has been stable for a decade, so
reading it needs only the page structs:

  page header (16 B): pgno u64 | pad u16 | flags u16 | lower u16 | upper u16
    flags: 0x01 BRANCH, 0x02 LEAF, 0x04 OVERFLOW, 0x08 META, 0x20 LEAF2
    (for OVERFLOW pages the lower/upper union holds the page count u32)
  node (8 B + payload): lo u16 | hi u16 | flags u16 | ksize u16 | key | data
    branch: child pgno = lo | hi<<16 | flags<<32, payload = key only
    leaf:   data size = lo | hi<<16; node flag 0x01 F_BIGDATA -> payload
            after the key is a u64 overflow pgno instead of inline data
  meta (at offset 16 of pages 0/1): magic 0xBEEFC0DE u32 | version u32 |
    address u64 | mapsize u64 | db[FREE] 48 B | db[MAIN] 48 B |
    last_pg u64 | txnid u64;  each MDB_db: pad u32 | flags u16 | depth u16 |
    branch_pages u64 | leaf_pages u64 | overflow_pages u64 | entries u64 |
    root u64.  The page size lives in db[FREE].pad; the live meta is the
    one with the larger txnid.

Key comparison is memcmp (default LMDB compare); DUPSORT/LEAF2 databases
are out of scope (the reference uses neither).

The writer emits a freshly-compacted single-txn environment (no
freelist: free DB root = P_INVALID), bottom-up: leaves at fill order,
branch levels above, overflow pages for records larger than the LMDB
node maximum, and twin meta pages.  Files it writes open with the real
``lmdb`` package (cross-checked in tests when that package is present).
"""

from __future__ import annotations

import mmap
import struct
from pathlib import Path
from typing import Dict, Iterator, List, Tuple, Union

P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08
P_LEAF2 = 0x20
F_BIGDATA = 0x01
F_DUPDATA = 0x04
MDB_MAGIC = 0xBEEFC0DE
MDB_VERSION = 1
PAGEHDRSZ = 16
INVALID_PGNO = 0xFFFFFFFFFFFFFFFF


class PureLMDBReader:
    """Read-only access to an LMDB file without the lmdb package."""

    def __init__(self, path: Union[str, Path]) -> None:
        self.path = Path(path)
        self._f = open(self.path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        metas = []
        for pg in (0, 1):
            off = pg * 4096  # meta pages are at the file start regardless
            if off + 152 > len(self._mm):
                continue
            base = off + PAGEHDRSZ
            magic, version = struct.unpack_from("<II", self._mm, base)
            if magic != MDB_MAGIC or version != MDB_VERSION:
                continue
            psize = struct.unpack_from("<I", self._mm, base + 24)[0]
            txnid = struct.unpack_from("<Q", self._mm, base + 128)[0]
            metas.append((txnid, psize, base))
        if not metas:
            raise ValueError(f"{path}: not an LMDB data file")
        txnid, psize, base = max(metas)
        # psize from db[FREE].pad is at base+24; recheck meta offsets with
        # the real page size (metas sit at 0 and psize)
        if psize != 4096:
            metas = []
            for pg in (0, 1):
                off = pg * psize
                base = off + PAGEHDRSZ
                magic, version = struct.unpack_from("<II", self._mm, base)
                if magic == MDB_MAGIC and version == MDB_VERSION:
                    txnid = struct.unpack_from("<Q", self._mm, base + 128)[0]
                    metas.append((txnid, psize, base))
            txnid, psize, base = max(metas)
        self.psize = psize
        main = base + 24 + 48  # db[MAIN]
        (self._main_flags, self._depth) = struct.unpack_from(
            "<HH", self._mm, main + 4
        )
        self.entries = struct.unpack_from("<Q", self._mm, main + 32)[0]
        self.root = struct.unpack_from("<Q", self._mm, main + 40)[0]
        if self._main_flags & 0x04:  # MDB_DUPSORT
            raise NotImplementedError("DUPSORT databases not supported")

    # -- page helpers -----------------------------------------------------
    def _page(self, pgno: int) -> int:
        return pgno * self.psize

    def _page_flags(self, off: int) -> int:
        return struct.unpack_from("<H", self._mm, off + 10)[0]

    def _nkeys(self, off: int) -> int:
        lower = struct.unpack_from("<H", self._mm, off + 12)[0]
        return (lower - PAGEHDRSZ) >> 1

    def _node(self, off: int, i: int) -> Tuple[int, int, int, bytes, int]:
        """(lo|hi size/pgno, flags, ksize, key, payload offset)."""
        ptr = struct.unpack_from("<H", self._mm, off + PAGEHDRSZ + 2 * i)[0]
        noff = off + ptr
        lo, hi, fl, ksize = struct.unpack_from("<HHHH", self._mm, noff)
        key = bytes(self._mm[noff + 8 : noff + 8 + ksize])
        return lo | (hi << 16), fl, ksize, key, noff + 8 + ksize

    def _leaf_data(self, size: int, fl: int, payload: int) -> bytes:
        if fl & F_DUPDATA:
            raise NotImplementedError("DUPSORT databases not supported")
        if fl & F_BIGDATA:
            opg = struct.unpack_from("<Q", self._mm, payload)[0]
            ooff = self._page(opg)
            assert self._page_flags(ooff) & P_OVERFLOW
            return bytes(self._mm[ooff + PAGEHDRSZ : ooff + PAGEHDRSZ + size])
        return bytes(self._mm[payload : payload + size])

    # -- public API -------------------------------------------------------
    def get(self, key: bytes):
        if self.root == INVALID_PGNO:
            return None
        pgno = self.root
        for _ in range(64):  # depth bound
            off = self._page(pgno)
            flags = self._page_flags(off)
            n = self._nkeys(off)
            if flags & P_BRANCH:
                # child 0's key is implicit -inf; descend into the last
                # child whose key <= search key
                lo_i, hi_i, child = 1, n - 1, None
                pick = 0
                while lo_i <= hi_i:
                    mid = (lo_i + hi_i) // 2
                    _, _, _, k, _ = self._node(off, mid)
                    if k <= key:
                        pick = mid
                        lo_i = mid + 1
                    else:
                        hi_i = mid - 1
                pgno_lohi, fl, _, _, _ = self._node(off, pick)
                child = pgno_lohi | (fl << 32)
                pgno = child
            elif flags & P_LEAF:
                if flags & P_LEAF2:
                    raise NotImplementedError("LEAF2 pages not supported")
                lo_i, hi_i = 0, n - 1
                while lo_i <= hi_i:
                    mid = (lo_i + hi_i) // 2
                    size, fl, _, k, payload = self._node(off, mid)
                    if k == key:
                        return self._leaf_data(size, fl, payload)
                    if k < key:
                        lo_i = mid + 1
                    else:
                        hi_i = mid - 1
                return None
            else:
                raise ValueError(f"unexpected page flags 0x{flags:x}")
        raise ValueError("B-tree deeper than 64 levels (corrupt file)")

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        """In-order scan of all (key, value) pairs."""
        if self.root == INVALID_PGNO:
            return
        stack = [(self.root, 0)]
        while stack:
            pgno, i = stack.pop()
            off = self._page(pgno)
            flags = self._page_flags(off)
            n = self._nkeys(off)
            if flags & P_BRANCH:
                if i < n:
                    stack.append((pgno, i + 1))
                    pgno_lohi, fl, _, _, _ = self._node(off, i)
                    stack.append((pgno_lohi | (fl << 32), 0))
            else:
                for j in range(n):
                    size, fl, _, k, payload = self._node(off, j)
                    yield k, self._leaf_data(size, fl, payload)

    def stat(self) -> Dict[str, int]:
        return {"entries": self.entries, "psize": self.psize,
                "depth": self._depth}

    def close(self) -> None:
        self._mm.close()
        self._f.close()


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------
def write_lmdb(
    path: Union[str, Path],
    records: Dict[bytes, bytes],
    psize: int = 4096,
    mapsize: int = None,
) -> None:
    """Write ``records`` as a fresh single-transaction LMDB file.

    Produces a compacted environment equivalent to ``mdb_env_copy`` output:
    no freelist, sequentially allocated pages, twin metas with txnid 1.
    """
    path = Path(path)
    nodemax = ((psize - PAGEHDRSZ) // 2) & ~1  # me_nodemax for MDB_MINKEYS=2
    items = sorted(records.items())  # memcmp == bytes sort

    pages: List[bytes] = []  # data pages, pgno = index + 2

    def alloc(raw: bytes) -> int:
        pages.append(raw.ljust(psize, b"\0"))
        return len(pages) + 1  # pgno

    def page_bytes(pgno: int, flags: int, nodes: List[bytes],
                   overflow_count: int = 0) -> bytes:
        if flags & P_OVERFLOW:
            hdr = struct.pack("<QHHI", pgno, 0, flags, overflow_count)
            return hdr
        lower = PAGEHDRSZ + 2 * len(nodes)
        ptrs = []
        body = bytearray(psize)
        upper = psize
        for nd in nodes:
            sz = (len(nd) + 1) & ~1  # EVEN
            upper -= sz
            body[upper : upper + len(nd)] = nd
            ptrs.append(upper)
        hdr = struct.pack("<QHHHH", pgno, 0, flags, lower, upper)
        body[:PAGEHDRSZ] = hdr
        struct.pack_into(f"<{len(ptrs)}H", body, PAGEHDRSZ, *ptrs)
        return bytes(body)

    def leaf_node(key: bytes, data: bytes, big_pgno: int = None) -> bytes:
        if big_pgno is not None:
            return struct.pack("<HHHH", len(data) & 0xFFFF,
                               (len(data) >> 16) & 0xFFFF, F_BIGDATA,
                               len(key)) + key + struct.pack("<Q", big_pgno)
        return struct.pack("<HHHH", len(data) & 0xFFFF,
                           (len(data) >> 16) & 0xFFFF, 0, len(key)) + key + data

    def branch_node(key: bytes, child: int) -> bytes:
        return struct.pack("<HHHH", child & 0xFFFF, (child >> 16) & 0xFFFF,
                           (child >> 32) & 0xFFFF, len(key)) + key

    n_overflow = 0
    # ---- leaves ---------------------------------------------------------
    leaf_entries: List[Tuple[bytes, int]] = []  # (first key, pgno)
    cur_nodes: List[bytes] = []
    cur_first = None
    cur_space = psize - PAGEHDRSZ

    def flush_leaf():
        nonlocal cur_nodes, cur_first, cur_space
        if cur_nodes:
            pgno = len(pages) + 2
            pages.append(page_bytes(pgno, P_LEAF, cur_nodes))
            leaf_entries.append((cur_first, pgno))
            cur_nodes, cur_first, cur_space = [], None, psize - PAGEHDRSZ

    for key, data in items:
        if 8 + len(key) + len(data) > nodemax:
            n_ovpages = (PAGEHDRSZ + len(data) + psize - 1) // psize
            opg = len(pages) + 2
            raw = page_bytes(opg, P_OVERFLOW, [], n_ovpages) + data
            padded = raw.ljust(n_ovpages * psize, b"\0")
            for i in range(n_ovpages):
                pages.append(padded[i * psize : (i + 1) * psize])
            n_overflow += n_ovpages
            nd = leaf_node(key, data, big_pgno=opg)
        else:
            nd = leaf_node(key, data)
        need = ((len(nd) + 1) & ~1) + 2
        if need > cur_space:
            flush_leaf()
        if cur_first is None:
            cur_first = key
        cur_nodes.append(nd)
        cur_space -= need
    flush_leaf()

    # ---- branches -------------------------------------------------------
    depth = 1 if leaf_entries else 0
    n_branch = 0
    level = leaf_entries
    while len(level) > 1:
        depth += 1
        nxt: List[Tuple[bytes, int]] = []
        cur_nodes, cur_first, cur_space = [], None, psize - PAGEHDRSZ
        first_in_page = True

        def flush_branch():
            nonlocal cur_nodes, cur_first, cur_space, first_in_page, n_branch
            if cur_nodes:
                pgno = len(pages) + 2
                pages.append(page_bytes(pgno, P_BRANCH, cur_nodes))
                nxt.append((cur_first, pgno))
                n_branch += 1
                cur_nodes, cur_first, cur_space = [], None, psize - PAGEHDRSZ
                first_in_page = True

        for key, child in level:
            nd = branch_node(b"" if first_in_page else key, child)
            need = ((len(nd) + 1) & ~1) + 2
            if need > cur_space:
                flush_branch()
                nd = branch_node(b"", child)
                need = ((len(nd) + 1) & ~1) + 2
            if cur_first is None:
                cur_first = key
            cur_nodes.append(nd)
            cur_space -= need
            first_in_page = False
        flush_branch()
        level = nxt

    root = level[0][1] if level else INVALID_PGNO
    last_pg = len(pages) + 1
    n_leaf = len(leaf_entries)

    if mapsize is None:
        mapsize = max((last_pg + 16) * psize, 1 << 20)
        mapsize = (mapsize + psize - 1) // psize * psize

    def meta_page(pgno: int) -> bytes:
        body = bytearray(psize)
        struct.pack_into("<QHHHH", body, 0, pgno, 0, P_META, 0, 0)
        base = PAGEHDRSZ
        struct.pack_into("<IIQQ", body, base, MDB_MAGIC, MDB_VERSION, 0,
                         mapsize)
        # db[FREE]: psize in pad, empty tree
        struct.pack_into("<IHHQQQQQ", body, base + 24, psize, 0, 0,
                         0, 0, 0, 0, INVALID_PGNO)
        # db[MAIN]
        struct.pack_into("<IHHQQQQQ", body, base + 72, 0, 0, depth,
                         n_branch, n_leaf, n_overflow, len(items), root)
        struct.pack_into("<QQ", body, base + 120, last_pg, 1)
        return bytes(body)

    with open(path, "wb") as f:
        f.write(meta_page(0))
        f.write(meta_page(1))
        for p in pages:
            f.write(p)
