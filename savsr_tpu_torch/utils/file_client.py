"""File-IO backends (disk).

Same role as lbasicsr/utils/file_client.py: datasets fetch bytes by key
through a FileClient so the storage backend is a config choice. The port
has the disk backend; lmdb and memcached are not ported and raise
NotImplementedError when a config names them.
"""

from __future__ import annotations

from abc import ABCMeta, abstractmethod


class BaseStorageBackend(metaclass=ABCMeta):
    @abstractmethod
    def get(self, filepath: str) -> bytes: ...


class DiskBackend(BaseStorageBackend):
    def get(self, filepath: str) -> bytes:
        with open(str(filepath), "rb") as f:
            return f.read()


class FileClient:
    """Facade dispatching to a configured backend."""

    _backends = {
        "disk": DiskBackend,
    }

    def __init__(self, backend: str = "disk", **kwargs):
        if backend in ("lmdb", "memcached"):
            raise NotImplementedError(f"io_backend: type: {backend} is not ported yet")
        if backend not in self._backends:
            raise ValueError(
                f"Backend {backend} not supported. Available: {list(self._backends)}"
            )
        self.backend = backend
        self.client = self._backends[backend](**kwargs)

    def get(self, filepath: str, client_key: str = "default") -> bytes:
        return self.client.get(filepath)
