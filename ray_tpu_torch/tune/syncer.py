"""A copy of the JAX package's ``tune/syncer.py`` on the port's copy of
``core/storage.py``. Its docstring:

Experiment syncing to remote storage.

Reference analog: ``python/ray/tune/syncer.py:184,209,231`` — the
``Syncer`` uploads trial/experiment dirs to cloud storage so a sweep
survives losing the head node's filesystem. Here the destination is any
URI the ``core.storage`` scheme registry resolves (local paths and
``file://`` first-class; object-store schemes pluggable via
``register_scheme``), and the unit of sync is the experiment directory
— experiment state, searcher/scheduler state, and trial checkpoints
(dict-backed checkpoints ride the state pickle; dir-backed ones are
materialized before upload by the runner).
"""

from __future__ import annotations

import os
from typing import Optional

from ..core.storage import StorageClient, client_for_uri


def is_uri(path: Optional[str]) -> bool:
    return bool(path) and "://" in path


class Syncer:
    """Mirror a local experiment dir into a storage URI and back."""

    def __init__(self, upload_uri: str, prefix: str = ""):
        self.upload_uri = upload_uri
        self.client: StorageClient = client_for_uri(upload_uri, prefix)
        # (mtime_ns, size) per uploaded rel path: the runner syncs after
        # every experiment-state write (~1/s) and re-uploading unchanged
        # trial artifacts each period would make sync cost O(dir size)
        # instead of O(changes).
        self._seen = {}

    def sync_up(self, local_dir: str) -> int:
        """Upload files changed since the last sync; returns uploads."""
        n = 0
        for dirpath, _, files in os.walk(local_dir):
            for name in files:
                if name.endswith(".tmp"):
                    continue
                full = os.path.join(dirpath, name)
                rel = os.path.relpath(full, local_dir)
                try:
                    st = os.stat(full)
                except FileNotFoundError:
                    continue  # raced with a writer's os.replace
                sig = (st.st_mtime_ns, st.st_size)
                if self._seen.get(rel) == sig:
                    continue
                with open(full, "rb") as f:
                    self.client.put(rel, f.read())
                self._seen[rel] = sig
                n += 1
        return n

    def sync_down(self, local_dir: str) -> int:
        """Download the full remote tree into ``local_dir``."""
        n = 0
        for key in self.client.list(""):
            data = self.client.get(key)
            if data is None:
                continue
            dest = os.path.join(local_dir, key)
            os.makedirs(os.path.dirname(dest), exist_ok=True)
            with open(dest, "wb") as f:
                f.write(data)
            n += 1
        return n
