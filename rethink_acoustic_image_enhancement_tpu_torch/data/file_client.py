"""File backends (Train/basicsr/utils/file_client.py:150-186): datasets
read every image's bytes through one ``get(filepath, key) -> bytes``
interface, from disk, from LMDB shards or from memcached.

  * ``DiskBackend``: the file's bytes.
  * ``LmdbBackend``: one LMDB env per client key; ``filepath`` is the
    record's key. It opens the envs with the ``lmdb`` package where that is
    installed, else reads the same files through ``data/lmdb_codec.py``.
  * ``MemcachedBackend``: the ``mc`` client protocol
    (``MemcachedClient.GetInstance``, ``Get``, ``ConvertBuffer``);
    ``sys_path`` points at a client library that is not installed.
"""

from __future__ import annotations

from typing import Any


class DiskBackend:
    def get(self, filepath: str) -> bytes:
        with open(filepath, "rb") as f:
            return f.read()


class LmdbBackend:
    """One LMDB env per client key (file_client.py:74-147)."""

    def __init__(self, db_paths, client_keys="default", readonly=True,
                 lock=False, readahead=False):
        if isinstance(client_keys, str):
            client_keys = [client_keys]
        if isinstance(db_paths, (str, bytes)):
            db_paths = [db_paths]
        if len(client_keys) != len(db_paths):
            raise ValueError(f"{len(client_keys)} client keys for "
                             f"{len(db_paths)} LMDB paths")
        self._client = {}
        try:
            import lmdb
        except ImportError:
            from .lmdb_codec import LmdbReader

            self._native = False
            for key, path in zip(client_keys, db_paths):
                self._client[key] = LmdbReader(str(path))
        else:
            self._native = True
            for key, path in zip(client_keys, db_paths):
                self._client[key] = lmdb.open(str(path), readonly=readonly,
                                              lock=lock, readahead=readahead)

    def get(self, filepath: str, client_key: str = "default") -> bytes:
        client = self._client[client_key]
        if self._native:
            with client.begin(write=False) as txn:
                return txn.get(str(filepath).encode("ascii"))
        return client.get(str(filepath))


class MemcachedBackend:
    """The ``mc`` memcached client (file_client.py:20-60)."""

    def __init__(self, server_list_cfg, client_cfg, sys_path=None):
        if sys_path is not None:
            import sys

            sys.path.append(sys_path)
        try:
            import mc
        except ImportError as e:
            raise ImportError("memcached backend needs the 'mc' package") from e
        self._client = mc.MemcachedClient.GetInstance(server_list_cfg,
                                                      client_cfg)
        self._mc_buffer = mc.pyvector()
        self._mc = mc

    def get(self, filepath: str) -> bytes:
        self._client.Get(str(filepath), self._mc_buffer)
        return self._mc.ConvertBuffer(self._mc_buffer)


class FileClient:
    """Dispatching client (file_client.py:150-186)."""

    _backends = {
        "disk": DiskBackend,
        "lmdb": LmdbBackend,
        "memcached": MemcachedBackend,
    }

    def __init__(self, backend: str = "disk", **kwargs: Any):
        if backend not in self._backends:
            raise ValueError(f"backend {backend!r} not supported; choose from "
                             f"{sorted(self._backends)}")
        self.backend = backend
        self.client = self._backends[backend](**kwargs)

    def get(self, filepath: str, client_key: str = "default") -> bytes:
        if self.backend == "lmdb":
            return self.client.get(filepath, client_key)
        return self.client.get(filepath)
