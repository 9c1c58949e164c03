"""File backend (Train/basicsr/utils/file_client.py:150-186): datasets read
every image's bytes through one ``get(filepath, key) -> bytes`` interface.

The disk backend is ported. LMDB shards and memcached are still to be
ported (ROADMAP.md, Queue A: the remaining datasets):
asking for them raises.
"""

from __future__ import annotations

from typing import Any


class DiskBackend:
    def get(self, filepath: str) -> bytes:
        with open(filepath, "rb") as f:
            return f.read()


_NOT_PORTED = ("lmdb", "memcached")


class FileClient:
    """Dispatching client (file_client.py:150-186)."""

    _backends = {"disk": DiskBackend}

    def __init__(self, backend: str = "disk", **kwargs: Any):
        if backend in _NOT_PORTED:
            raise NotImplementedError(
                f"the {backend} backend is not ported yet (ROADMAP.md, Queue "
                "A: the remaining datasets); use io_backend: {type: disk}")
        if backend not in self._backends:
            raise ValueError(f"backend {backend!r} not supported; choose from "
                             f"{sorted(self._backends)}")
        self.backend = backend
        self.client = self._backends[backend](**kwargs)

    def get(self, filepath: str, client_key: str = "default") -> bytes:
        return self.client.get(filepath)
