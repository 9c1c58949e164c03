"""Dependency-free LMDB file codec (read + one-shot write).

The reference trains from LMDB corpora through its FileClient lmdb backend
(Train/basicsr/utils/file_client.py:74-147, data/paired_image_dataset.py:
317-327), which wraps the C liblmdb via the ``lmdb`` package. Where neither
the package nor the shared library is installed, this module carries the
public liblmdb 0.9 on-disk format itself (struct layouts from the canonical
mdb.c: MDB_page / MDB_node / MDB_meta / MDB_db). It is the port's own copy
of the JAX package's codec, byte for byte the same format:

  * ``LmdbReader`` — read-only B+tree walker over a ``data.mdb`` memory
    map: meta-page selection by txnid, branch descent (search from index 1,
    node 0's key is never compared — mdb_node_search semantics), leaf
    binary search, F_BIGDATA overflow chains.
  * ``write_lmdb`` — one-shot bulk writer: sorted leaves built bottom-up,
    branch levels until a single root, contiguous overflow chains for
    values larger than the node max, twin meta pages. Output opens with
    stock liblmdb/py-lmdb (same magic/version/layout) and round-trips
    through ``LmdbReader``.

Used as the automatic fallback for the FileClient lmdb backend and the
LMDB corpus packer when the ``lmdb`` package is unavailable.
"""

from __future__ import annotations

import os
import os.path as osp
import struct

PAGE_SIZE = 4096
PAGE_HDR = 16
MAGIC = 0xBEEFC0DE
DATA_VERSION = 1

# MDB_page.mp_flags
P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08

# MDB_node.mn_flags
F_BIGDATA = 0x01

P_INVALID = 0xFFFFFFFFFFFFFFFF

# mdb.c: me_nodemax = ((psize - PAGEHDRSZ) / MDB_MINKEYS) & -2, MDB_MINKEYS=2
NODE_MAX = ((PAGE_SIZE - PAGE_HDR) // 2) & ~1

_PAGE_HDR_ST = struct.Struct("<QHHHH")      # pgno, pad, flags, lower, upper
_OVF_HDR_ST = struct.Struct("<QHHI")        # pgno, pad, flags, pb_pages
_NODE_HDR_ST = struct.Struct("<HHHH")       # lo, hi, flags, ksize
_DB_ST = struct.Struct("<IHHQQQQQ")         # pad, flags, depth, branch,
                                            # leaf, overflow, entries, root
_META_ST = struct.Struct("<IIQQ48s48sQQ")   # magic, version, addr, mapsize,
                                            # dbs[2], last_pg, txnid


def _data_path(path: str) -> str:
    """An LMDB env is a directory holding data.mdb (subdir mode) or the
    file itself (MDB_NOSUBDIR)."""
    return osp.join(path, "data.mdb") if osp.isdir(path) else path


class LmdbError(ValueError):
    """Malformed or unsupported LMDB data file. Subclasses ValueError so
    pre-existing callers that caught ValueError keep working; every defect
    a corrupted/truncated .mdb can trigger in LmdbReader raises this (never
    a bare struct.error / IndexError / hang — see tests/test_lmdb_fuzz.py)."""


# liblmdb accepts 512..65536-byte pages (mdb_env_open2 clamps); anything
# else in the env header is corruption.
_MIN_PSIZE, _MAX_PSIZE = 512, 65536


class LmdbReader:
    """Read-only access to one LMDB main database."""

    def __init__(self, path: str):
        with open(_data_path(path), "rb") as f:
            self._buf = f.read()
        if len(self._buf) < 2 * PAGE_SIZE:
            raise LmdbError(
                f"{path}: truncated LMDB file ({len(self._buf)} bytes < two "
                f"{PAGE_SIZE}-byte meta pages)")
        best = None
        for pgno in (0, 1):  # twin meta pages; live one has higher txnid
            off = pgno * PAGE_SIZE + PAGE_HDR
            magic, version, _addr, _mapsize, db0, db1, last_pg, txnid = \
                _META_ST.unpack_from(self._buf, off)
            if magic != MAGIC:
                raise LmdbError(f"{path}: not an LMDB data file "
                                f"(magic {magic:#x})")
            if version != DATA_VERSION:
                raise LmdbError(f"{path}: LMDB data version {version} "
                                f"unsupported (expected {DATA_VERSION})")
            if best is None or txnid >= best[0]:
                best = (txnid, db0, db1, last_pg)
        _txnid, db0, db1, _last = best
        # free-DB slot 0 doubles as env header: md_pad is the page size
        self._psize = _DB_ST.unpack_from(db0, 0)[0] or PAGE_SIZE
        if not (_MIN_PSIZE <= self._psize <= _MAX_PSIZE
                and self._psize & (self._psize - 1) == 0):
            raise LmdbError(
                f"{path}: bogus page size {self._psize} in env header")
        (_pad, _flags, self.depth, _b, _l, _o, self.entries,
         self._root) = _DB_ST.unpack_from(db1, 0)
        self._npages = len(self._buf) // self._psize
        if self._root != P_INVALID and self._root >= self._npages:
            raise LmdbError(
                f"{path}: main-DB root pgno {self._root} beyond file end "
                f"({self._npages} pages)")
        # depth bounds every descent/DFS below: a well-formed tree is at
        # most `depth` levels deep, so following more than that many branch
        # hops means a cycle or corrupted child pointers.
        if self._root != P_INVALID and not (1 <= self.depth <= 64):
            raise LmdbError(f"{path}: bogus B+tree depth {self.depth}")

    # ------------------------------------------------------------ pages --
    def _page(self, pgno: int):
        if pgno >= self._npages:
            raise LmdbError(f"page pointer {pgno} beyond file end "
                            f"({self._npages} pages)")
        off = pgno * self._psize
        _pg, _pad, flags, lower, upper = _PAGE_HDR_ST.unpack_from(
            self._buf, off)
        if not (PAGE_HDR <= lower <= upper <= self._psize):
            raise LmdbError(f"corrupt page header at pgno {pgno}: "
                            f"lower={lower} upper={upper}")
        return off, flags, lower, upper

    def _numkeys(self, lower: int) -> int:
        return (lower - PAGE_HDR) >> 1

    def _node(self, page_off: int, idx: int):
        """(key, lo, hi, flags, data_off) of node idx on the page."""
        ptr = struct.unpack_from(
            "<H", self._buf, page_off + PAGE_HDR + 2 * idx)[0]
        if not (PAGE_HDR <= ptr <= self._psize - 8):
            raise LmdbError(f"corrupt node pointer {ptr:#x} on page at "
                            f"offset {page_off:#x}")
        noff = page_off + ptr
        lo, hi, flags, ksize = _NODE_HDR_ST.unpack_from(self._buf, noff)
        if ptr + 8 + ksize > self._psize:
            raise LmdbError(f"node key overruns page: ptr={ptr:#x} "
                            f"ksize={ksize}")
        key = self._buf[noff + 8:noff + 8 + ksize]
        return key, lo, hi, flags, noff + 8 + ksize

    def _leaf_value(self, lo, hi, flags, data_off) -> bytes:
        size = lo | (hi << 16)
        if flags & F_BIGDATA:
            if data_off + 8 > len(self._buf):
                raise LmdbError("overflow pointer overruns file end")
            ovf_pgno = struct.unpack_from("<Q", self._buf, data_off)[0]
            if ovf_pgno >= self._npages:
                raise LmdbError(f"overflow page {ovf_pgno} beyond file end "
                                f"({self._npages} pages)")
            ovf_off = ovf_pgno * self._psize
            if ovf_off + PAGE_HDR + size > len(self._buf):
                raise LmdbError(
                    f"overflow value ({size} bytes at page {ovf_pgno}) "
                    f"overruns file end")
            return self._buf[ovf_off + PAGE_HDR:ovf_off + PAGE_HDR + size]
        if data_off + size > len(self._buf):
            raise LmdbError(f"inline value ({size} bytes) overruns file end")
        return self._buf[data_off:data_off + size]

    # ------------------------------------------------------------- api ---
    def get(self, key: bytes | str) -> bytes | None:
        if isinstance(key, str):
            key = key.encode("ascii")
        if self._root == P_INVALID:
            return None
        pgno = self._root
        hops = 0
        while True:
            hops += 1
            if hops > 64:  # liblmdb trees never get this deep; cycle guard
                raise LmdbError("branch descent exceeded 64 levels "
                                "(corrupt child pointers / cycle)")
            off, flags, lower, upper = self._page(pgno)
            n = self._numkeys(lower)
            if flags & P_BRANCH:
                # binary search from index 1 (mdb_node_search: low = 1 on
                # branch pages; node 0's key is never compared)
                lo_i, hi_i, child = 1, n - 1, 0
                while lo_i <= hi_i:
                    mid = (lo_i + hi_i) >> 1
                    k, nlo, nhi, nfl, _ = self._node(off, mid)
                    if key < k:
                        hi_i = mid - 1
                    else:
                        child = mid
                        lo_i = mid + 1
                k, nlo, nhi, nfl, _ = self._node(off, child)
                pgno = nlo | (nhi << 16) | (nfl << 32)
            elif flags & P_LEAF:
                lo_i, hi_i = 0, n - 1
                while lo_i <= hi_i:
                    mid = (lo_i + hi_i) >> 1
                    k, nlo, nhi, nfl, doff = self._node(off, mid)
                    if k == key:
                        return self._leaf_value(nlo, nhi, nfl, doff)
                    if key < k:
                        hi_i = mid - 1
                    else:
                        lo_i = mid + 1
                return None
            else:
                raise LmdbError(f"unexpected page flags {flags:#x} "
                                f"at pgno {pgno}")

    def items(self):
        """Yield (key, value) in key order (DFS over the B+tree)."""
        if self._root == P_INVALID:
            return
        stack = [self._root]
        visited = 0
        while stack:
            pgno = stack.pop()
            visited += 1
            if visited > self._npages:  # each page appears at most once
                raise LmdbError("B+tree walk visited more pages than the "
                                "file holds (corrupt child pointers / cycle)")
            off, flags, lower, _upper = self._page(pgno)
            n = self._numkeys(lower)
            if flags & P_BRANCH:
                for i in reversed(range(n)):
                    _k, nlo, nhi, nfl, _ = self._node(off, i)
                    stack.append(nlo | (nhi << 16) | (nfl << 32))
            elif flags & P_LEAF:
                for i in range(n):
                    k, nlo, nhi, nfl, doff = self._node(off, i)
                    yield k, self._leaf_value(nlo, nhi, nfl, doff)
            else:
                raise LmdbError(f"unexpected page flags {flags:#x} "
                                f"at pgno {pgno}")

    def keys(self):
        return (k for k, _ in self.items())


def _even(n: int) -> int:
    return n + (n & 1)


def write_lmdb(path: str, items, subdir: bool = True) -> int:
    """One-shot bulk write of ``items`` (iterable of (key, value) bytes
    pairs) as an LMDB env at ``path``. Returns the entry count."""
    pairs = []
    for k, v in items:
        if isinstance(k, str):
            k = k.encode("ascii")
        if isinstance(v, str):
            v = v.encode("ascii")
        pairs.append((bytes(k), bytes(v)))
    pairs.sort(key=lambda kv: kv[0])

    pages: list[bytes] = []  # data pages, starting at pgno 2

    def alloc(raw: bytes) -> int:
        pages.append(raw)
        return 1 + len(pages)  # pgno: metas are 0 and 1

    n_overflow = 0

    def build_value(value: bytes):
        """(node_flags, stored_data) — spill to overflow pages when the
        node would exceed the in-page max (mdb_node_add F_BIGDATA path)."""
        nonlocal n_overflow
        npages = (PAGE_HDR + len(value) + PAGE_SIZE - 1) // PAGE_SIZE
        hdr = _OVF_HDR_ST.pack(0, 0, P_OVERFLOW, npages)  # pgno patched below
        chain = hdr + value
        chain += b"\x00" * (npages * PAGE_SIZE - len(chain))
        first = None
        for i in range(npages):
            raw = chain[i * PAGE_SIZE:(i + 1) * PAGE_SIZE]
            pg = alloc(raw)
            if i == 0:
                first = pg
                # patch the overflow header's pgno in place
                pages[-1] = _OVF_HDR_ST.pack(pg, 0, P_OVERFLOW,
                                             npages) + raw[PAGE_HDR:]
        n_overflow += npages
        return F_BIGDATA, struct.pack("<Q", first), len(value)

    def pack_page(flags: int, nodes: list[bytes]) -> bytes:
        lower = PAGE_HDR + 2 * len(nodes)
        body = b"".join(reversed(nodes))  # node 0 ends at page end
        upper = PAGE_SIZE - len(body)
        ptrs, ofs = [], PAGE_SIZE
        for node in nodes:
            ofs -= len(node)
            ptrs.append(ofs)
        hdr = _PAGE_HDR_ST.pack(0, 0, flags, lower, upper)
        page = (hdr + struct.pack(f"<{len(nodes)}H", *ptrs)
                + b"\x00" * (upper - lower) + body)
        assert len(page) == PAGE_SIZE
        return page

    # ---- leaves -----------------------------------------------------------
    leaves: list[tuple[bytes, int]] = []  # (first_key, pgno)
    cur_nodes: list[bytes] = []
    cur_used = 0
    cur_first = None

    def flush_leaf():
        nonlocal cur_nodes, cur_used, cur_first
        if cur_nodes:
            pg = alloc(pack_page(P_LEAF, cur_nodes))
            # patch pgno into the header
            pages[-1] = _PAGE_HDR_ST.pack(
                pg, 0, P_LEAF, *_PAGE_HDR_ST.unpack_from(pages[-1])[3:]
            ) + pages[-1][PAGE_HDR:]
            leaves.append((cur_first, pg))
            cur_nodes, cur_used, cur_first = [], 0, None

    for key, value in pairs:
        if len(key) > 511:
            raise ValueError(f"key too long for LMDB: {len(key)} bytes")
        inline_sz = _even(8 + len(key) + len(value))
        if 8 + len(key) + len(value) <= NODE_MAX:
            nflags, stored, dsize = 0, value, len(value)
            node_sz = inline_sz
        else:
            nflags, stored, dsize = build_value(value)
            node_sz = _even(8 + len(key) + 8)
        node = _NODE_HDR_ST.pack(dsize & 0xFFFF, (dsize >> 16) & 0xFFFF,
                                 nflags, len(key)) + key + stored
        node += b"\x00" * (node_sz - len(node))
        if cur_used + 2 + node_sz > PAGE_SIZE - PAGE_HDR:
            flush_leaf()
        if cur_first is None:
            cur_first = key
        cur_nodes.append(node)
        cur_used += 2 + node_sz
    flush_leaf()

    # ---- branch levels ----------------------------------------------------
    n_branch = 0
    depth = 1 if leaves else 0
    level = leaves
    while len(level) > 1:
        depth += 1
        nxt: list[tuple[bytes, int]] = []
        bn_nodes, bn_used, bn_first = [], 0, None

        def flush_branch():
            nonlocal bn_nodes, bn_used, bn_first, n_branch
            if bn_nodes:
                pg = alloc(pack_page(P_BRANCH, bn_nodes))
                pages[-1] = _PAGE_HDR_ST.pack(
                    pg, 0, P_BRANCH,
                    *_PAGE_HDR_ST.unpack_from(pages[-1])[3:]
                ) + pages[-1][PAGE_HDR:]
                nxt.append((bn_first, pg))
                n_branch += 1
                bn_nodes, bn_used, bn_first = [], 0, None

        for first_key, child_pg in level:
            node_sz = _even(8 + len(first_key))
            node = _NODE_HDR_ST.pack(child_pg & 0xFFFF,
                                     (child_pg >> 16) & 0xFFFF,
                                     (child_pg >> 32) & 0xFFFF,
                                     len(first_key)) + first_key
            node += b"\x00" * (node_sz - len(node))
            if bn_used + 2 + node_sz > PAGE_SIZE - PAGE_HDR:
                flush_branch()
            if bn_first is None:
                bn_first = first_key
            bn_nodes.append(node)
            bn_used += 2 + node_sz
        flush_branch()
        level = nxt

    root = level[0][1] if level else P_INVALID
    n_leaf = len(leaves)
    last_pg = 1 + len(pages)
    mapsize = (2 + len(pages)) * PAGE_SIZE

    free_db = _DB_ST.pack(PAGE_SIZE, 0, 0, 0, 0, 0, 0, P_INVALID)
    main_db = _DB_ST.pack(0, 0, depth, n_branch, n_leaf, n_overflow,
                          len(pairs), root)

    def meta_page(pgno: int, txnid: int) -> bytes:
        meta = _META_ST.pack(MAGIC, DATA_VERSION, 0, mapsize,
                             free_db, main_db, last_pg, txnid)
        hdr = _PAGE_HDR_ST.pack(pgno, 0, P_META, 0, 0)
        page = hdr + meta
        return page + b"\x00" * (PAGE_SIZE - len(page))

    if subdir:
        os.makedirs(path, exist_ok=True)
        out = osp.join(path, "data.mdb")
    else:
        out = path
    with open(out, "wb") as f:
        f.write(meta_page(0, 0))
        f.write(meta_page(1, 1))
        for raw in pages:
            f.write(raw)
    return len(pairs)
