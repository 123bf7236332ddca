"""A copy of the JAX package's ``core/storage.py`` (standard library only),
kept here because the port imports nothing of that package. The port
starts no runtime, so nothing sets the storage root at ``init``: it comes
from ``RT_STORAGE_URI`` alone, the variable the JAX package's workers read.
Its docstring:

Cluster-wide storage workspace API.

Reference analog: ``python/ray/_private/storage.py`` — ``ray.init(
storage=...)`` configures a cluster-wide filesystem workspace; components
(workflow storage, spilling) get scoped clients via
``get_client(prefix)``. The reference uses pyarrow.fs for URI dispatch;
here local filesystems are first-class and other schemes can register a
filesystem factory.
"""

from __future__ import annotations

import os
import shutil
from typing import Callable, Dict, List, Optional

_schemes: Dict[str, Callable[[str, str], "StorageClient"]] = {}

# The storage root, as the JAX package's workers inherit it.
ENV_STORAGE_URI = "RT_STORAGE_URI"


class StorageClient:
    """Scoped KV-ish file workspace (reference: storage.KVClient)."""

    def __init__(self, root: str):
        # No makedirs here: constructing a client must not mutate the
        # store (read-only probes like Tuner.can_restore build clients
        # for paths that may not exist). put() creates dirs on write.
        self.root = root

    def _path(self, key: str) -> str:
        root = os.path.normpath(self.root)
        path = os.path.normpath(os.path.join(root, key))
        # Boundary-safe containment: "/x/ns2".startswith("/x/ns") is True,
        # so compare against root + separator, not a bare prefix.
        if path != root and not path.startswith(root + os.sep):
            raise ValueError(f"key {key!r} escapes the storage prefix")
        return path

    def put(self, key: str, value: bytes) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(value)
        os.replace(tmp, path)  # atomic publish

    def get(self, key: str) -> Optional[bytes]:
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def exists(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def delete(self, key: str) -> bool:
        try:
            os.unlink(self._path(key))
            return True
        except FileNotFoundError:
            return False

    def list(self, prefix: str = "") -> List[str]:
        base = self._path(prefix) if prefix else self.root
        out = []
        for dirpath, _, files in os.walk(base):
            for name in files:
                if name.endswith(".tmp"):
                    continue
                full = os.path.join(dirpath, name)
                out.append(os.path.relpath(full, self.root))
        return sorted(out)

    def delete_dir(self, key: str) -> bool:
        path = self._path(key)
        if os.path.isdir(path):
            shutil.rmtree(path)
            return True
        return False


def register_scheme(scheme: str,
                    factory: Callable[[str, str], StorageClient]) -> None:
    """Plug a non-local filesystem (e.g. object-store backed).

    ``factory(uri, prefix)`` must honor ``prefix`` scoping — components
    rely on disjoint namespaces regardless of backend.
    """
    _schemes[scheme] = factory


def client_for_uri(uri: str, prefix: str = "") -> StorageClient:
    """Client for an EXPLICIT storage URI (scheme-registry dispatch),
    independent of the configured root — used by components that take
    their own destination, e.g. the Tune syncer."""
    scheme, sep, rest = uri.partition("://")
    if sep and scheme != "file":
        if scheme in _schemes:
            return _schemes[scheme](uri, prefix)
        raise ValueError(f"unsupported storage scheme {scheme!r}")
    root = rest if sep else uri
    return StorageClient(os.path.join(root, prefix) if prefix else root)


def get_client(prefix: str = "") -> StorageClient:
    """Scoped client under the storage root ``RT_STORAGE_URI`` names.

    Reference: ``storage.get_client(prefix)`` — raises if storage wasn't
    configured, so misconfiguration fails at the call site.
    """
    uri = os.environ.get(ENV_STORAGE_URI)
    if uri is None:
        raise RuntimeError(
            f"storage is not configured; set {ENV_STORAGE_URI}")
    return client_for_uri(uri, prefix)
