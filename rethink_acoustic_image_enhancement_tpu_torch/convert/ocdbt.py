"""A reader of tensorstore's OCDBT key-value format (the ``use_ocdbt: true``
layout of orbax checkpoints), in plain Python on ``utils/zstd.py``.

An OCDBT database is a directory with ``manifest.ocdbt`` and data files
(``d/<hash>``, or ``ocdbt.process_<i>/d/<hash>`` where orbax merged
per-process databases). The manifest names the latest version's B-tree
root; interior nodes hold prefix-compressed child keys, leaf nodes hold
prefix-compressed keys and their values, inline or as (data file, offset,
length) references. Every manifest and node is

    magic (u32, big-endian) | length (u64) | version (varint, 0) |
    compression (varint: 0 none, 1 zstd) | body | CRC32C (u32)

and is checked for its magic, its length and its checksum. A layout this
reader does not know by name (another format version, a compression
method other than none or zstd, a numbered manifest) raises
``OcdbtError``; nothing is guessed. The format is tensorstore's
("kvstore/ocdbt", format section of its documentation).

    db = Database("artifacts/.../net_g_5000")
    db.keys()                     # sorted str keys
    db.get("params.x.kernel/.zarray")   # bytes

Data files are read once each and sliced; ``get`` may be called from
several threads.
"""

from __future__ import annotations

import os
import struct
import threading
from dataclasses import dataclass

from ..utils import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
FORMAT_VERSION = 0
COMPRESSIONS = {0: "none", 1: "zstd"}
MANIFEST_KINDS = {0: "single", 1: "numbered"}


class OcdbtError(ValueError):
    """A malformed or unsupported OCDBT database."""


# ------------------------------------------------------------------ CRC32C --

def _crc32c_table() -> list[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data) -> int:
    """CRC-32C (Castagnoli) of ``data``."""
    crc = 0xFFFFFFFF
    t = _CRC_TABLE
    for b in bytes(data):
        crc = t[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# ---------------------------------------------------------------- decoding --

class _Reader:
    def __init__(self, buf: bytes, what: str):
        self.buf, self.p, self.what = buf, 0, what

    def bytes(self, n: int) -> bytes:
        if self.p + n > len(self.buf):
            raise OcdbtError(f"{self.what}: truncated")
        out = self.buf[self.p:self.p + n]
        self.p += n
        return out

    def u8(self) -> int:
        return self.bytes(1)[0]

    def varint(self) -> int:
        v, shift = 0, 0
        while True:
            b = self.u8()
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                return v
            shift += 7
            if shift > 63:
                raise OcdbtError(f"{self.what}: varint longer than 64 bits")

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def end(self) -> None:
        if self.p != len(self.buf):
            raise OcdbtError(f"{self.what}: {len(self.buf) - self.p} bytes "
                             "after its last field")


def _unframe(raw: bytes, magic: int, what: str, decoder: str) -> bytes:
    """Check an encoded manifest or node and return its decompressed body."""
    if len(raw) < 4 + 8 + 2 + 4:
        raise OcdbtError(f"{what}: {len(raw)} bytes, too short")
    got = struct.unpack(">I", raw[:4])[0]
    if got != magic:
        raise OcdbtError(f"{what}: magic {got:#010x}, expected {magic:#010x}")
    length = struct.unpack("<Q", raw[4:12])[0]
    if length != len(raw):
        raise OcdbtError(f"{what}: header length {length}, {len(raw)} bytes read")
    stored = struct.unpack("<I", raw[-4:])[0]
    if crc32c(raw[:-4]) != stored:
        raise OcdbtError(f"{what}: CRC32C mismatch")
    r = _Reader(raw[:-4], what)
    r.p = 12
    version = r.varint()
    if version != FORMAT_VERSION:
        raise OcdbtError(f"{what}: format version {version}; this reader "
                         f"knows version {FORMAT_VERSION}")
    method = r.varint()
    if method not in COMPRESSIONS:
        raise OcdbtError(f"{what}: compression method {method}; this reader "
                         f"knows {COMPRESSIONS}")
    body = raw[r.p:-4]
    return zstd.decompress(body, decoder) if method == 1 else body


@dataclass(frozen=True)
class DataFile:
    path: str  # relative to the database's directory
    base: str  # the prefix that paths read from a node in this file take


@dataclass(frozen=True)
class Ref:
    file: DataFile
    offset: int
    length: int


def _data_file_table(r: _Reader, base: str) -> list[DataFile]:
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix, base_len = r.varints(n), r.varints(n)
    files, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise OcdbtError(f"{r.what}: data file path prefix past its predecessor")
        full = prev[:prefix[i]] + r.bytes(suffix[i])
        if base_len[i] > len(full):
            raise OcdbtError(f"{r.what}: data file base path past its path")
        files.append(DataFile(base + full.decode(), base + full[:base_len[i]].decode()))
        prev = full
    return files


def _refs(r: _Reader, files: list[DataFile], n: int) -> list[Ref]:
    ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
    if any(i >= len(files) for i in ids):
        raise OcdbtError(f"{r.what}: data file id past its table")
    return [Ref(files[i], o, ln) for i, o, ln in zip(ids, offsets, lengths)]


def _keys(r: _Reader, n: int, interior: bool):
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    common = r.varints(n) if interior else None
    keys, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise OcdbtError(f"{r.what}: key prefix past its predecessor")
        prev = prev[:prefix[i]] + r.bytes(suffix[i])
        keys.append(prev)
    return keys, common


@dataclass(frozen=True)
class Manifest:
    root: Ref | None  # None for an empty tree
    height: int
    generation: int
    num_keys: int


def parse_manifest(raw: bytes, what: str = "manifest.ocdbt",
                   decoder: str = "native") -> Manifest:
    """The latest version's root of an encoded manifest (its config read
    and checked, not kept)."""
    r = _Reader(_unframe(raw, MANIFEST_MAGIC, what, decoder), what)
    r.bytes(16)  # the database's uuid
    kind = r.varint()
    if MANIFEST_KINDS.get(kind) != "single":
        raise OcdbtError(f"{what}: manifest kind {MANIFEST_KINDS.get(kind, kind)!r}; "
                         "this reader knows 'single'")
    r.varints(2)  # max inline value bytes, max decoded node bytes
    r.u8()  # version tree arity (log2)
    method = r.varint()
    if method not in COMPRESSIONS:
        raise OcdbtError(f"{what}: node compression method {method}; this "
                         f"reader knows {COMPRESSIONS}")
    if method == 1:
        r.bytes(4)  # zstd level (int32)
    files = _data_file_table(r, "")
    n = r.varint()
    if n == 0:
        raise OcdbtError(f"{what}: no version")
    generations = r.varints(n)
    heights = [r.u8() for _ in range(n)]
    roots = _refs(r, files, n)
    num_keys = r.varints(n)
    r.varints(2 * n)  # tree bytes, indirect value bytes
    r.bytes(8 * n)  # commit times
    m = r.varint()  # version tree nodes (older versions), not read
    r.varints(m)  # generation numbers
    _refs(r, files, m)
    r.varints(m)  # generation counts
    r.bytes(8 * m)  # commit times
    r.bytes(m)  # heights
    r.end()
    last = max(range(n), key=generations.__getitem__)
    root = roots[last] if num_keys[last] else None
    return Manifest(root, heights[last], generations[last], num_keys[last])


class Database:
    """The latest version of the OCDBT database in ``root`` (a directory)."""

    def __init__(self, root: str, decoder: str = "native"):
        self.root = root
        self.decoder = decoder
        self._files: dict[str, bytes] = {}
        self._lock = threading.Lock()  # get() runs on reader threads
        self.manifest = parse_manifest(self._file("manifest.ocdbt"),
                                       os.path.join(root, "manifest.ocdbt"), decoder)
        self._values: dict[bytes, bytes | Ref] = {}
        if self.manifest.root is not None:
            self._walk(self.manifest.root, self.manifest.height, b"")
        if len(self._values) != self.manifest.num_keys:
            raise OcdbtError(f"{root}: {len(self._values)} keys in the tree, "
                             f"the manifest says {self.manifest.num_keys}")

    def _file(self, rel: str) -> bytes:
        with self._lock:  # each file read once, whichever thread asks first
            if rel not in self._files:
                if os.path.isabs(rel) or ".." in rel.split("/"):
                    raise OcdbtError(f"data file {rel!r} outside {self.root}")
                with open(os.path.join(self.root, rel), "rb") as fh:
                    self._files[rel] = fh.read()
            return self._files[rel]

    def _slice(self, ref: Ref) -> bytes:
        data = self._file(ref.file.path)
        if ref.offset + ref.length > len(data):
            raise OcdbtError(f"{ref.file.path}: [{ref.offset}, "
                             f"{ref.offset + ref.length}) past its {len(data)} bytes")
        return data[ref.offset:ref.offset + ref.length]

    def _walk(self, ref: Ref, height: int, prefix: bytes) -> None:
        what = f"{ref.file.path}@{ref.offset}"
        r = _Reader(_unframe(self._slice(ref), BTREE_MAGIC, what, self.decoder), what)
        got = r.u8()
        if got != height:
            raise OcdbtError(f"{what}: node height {got}, its parent says {height}")
        files = _data_file_table(r, ref.file.base)
        n = r.varint()
        keys, common = _keys(r, n, interior=height > 0)
        if height > 0:
            children = _refs(r, files, n)
            r.varints(3 * n)  # keys, tree bytes, indirect value bytes
            r.end()
            for key, c, child in zip(keys, common, children):
                if c > len(key):
                    raise OcdbtError(f"{what}: subtree prefix past its key")
                self._walk(child, height - 1, prefix + key[:c])
            return
        lengths = r.varints(n)
        kinds = r.varints(n)
        if any(k > 1 for k in kinds):
            raise OcdbtError(f"{what}: value kind {max(kinds)}; this reader "
                             "knows 0 (inline) and 1 (indirect)")
        indirect = [i for i in range(n) if kinds[i] == 1]
        ids, offsets = r.varints(len(indirect)), r.varints(len(indirect))
        if any(i >= len(files) for i in ids):
            raise OcdbtError(f"{what}: data file id past its table")
        refs = {i: Ref(files[f], o, lengths[i]) for i, f, o in zip(indirect, ids, offsets)}
        for i in range(n):
            self._values[prefix + keys[i]] = refs[i] if kinds[i] else r.bytes(lengths[i])
        r.end()

    def keys(self) -> list[str]:
        return sorted(k.decode() for k in self._values)

    def __contains__(self, key: str) -> bool:
        return key.encode() in self._values

    def get(self, key: str) -> bytes:
        value = self._values.get(key.encode())
        if value is None:
            raise KeyError(key)
        return self._slice(value) if isinstance(value, Ref) else value
