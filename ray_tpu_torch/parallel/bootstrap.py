"""Multi-host bootstrap: a KV-store rendezvous, then ``torch.distributed``.
Counterpart of the JAX package's ``parallel/bootstrap.py``.

Hosts claim ranks through atomic KV writes, rank 0 publishes the
coordinator address, and every host then enters
``torch.distributed.init_process_group`` at that address
(``initialize_torch``, in place of ``initialize_jax``): NCCL on CUDA, gloo
when the caller asks for the CPU.

Usage (one call per host process)::

    bs = Bootstrap(kv_client, world_size=4)
    rank = bs.claim_rank()
    bs.coordinator_address(port=8476, host="10.0.0.1")  # rank 0 publishes
    bs.initialize_torch()                               # NCCL

Unlike the JAX package, rank 0 publishes ``127.0.0.1`` unless it is told
the address its peers reach it at (``host=``): it never probes the
network for an interface.
"""

from __future__ import annotations

import socket
import threading
import time
import uuid
from datetime import timedelta
from typing import Optional


class BootstrapError(RuntimeError):
    pass


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


class InMemoryKV:
    """A KV client for ranks that share one process (a world of one, or
    threads): the two calls ``Bootstrap`` makes, on a dict."""

    def __init__(self):
        self._data = {}
        self._lock = threading.Lock()

    def kv_put(self, key, value, namespace: str = "",
               overwrite: bool = True) -> bool:
        with self._lock:
            if not overwrite and (namespace, key) in self._data:
                return False
            self._data[(namespace, key)] = value
            return True

    def kv_get(self, key, namespace: str = ""):
        with self._lock:
            return self._data.get((namespace, key))


class Bootstrap:
    """One rendezvous session over a KV client.

    The client only needs ``kv_put(key, value, namespace=..., overwrite=...)``
    (returning whether it wrote) and ``kv_get(key, namespace=...)``.
    """

    NAMESPACE = "bootstrap"

    def __init__(self, kv_client, world_size: int, session: str = "default",
                 poll_s: float = 0.05, host_id: Optional[str] = None):
        self._kv = kv_client
        self.world_size = int(world_size)
        self.session = session
        self.rank: Optional[int] = None
        self._poll_s = poll_s
        self._coordinator: Optional[str] = None
        # A stable host_id lets a restarted host reclaim its rank slot; the
        # random default makes claim_rank idempotent within this process.
        self._token = (host_id or uuid.uuid4().hex).encode()

    def _key(self, *parts: str) -> bytes:
        return "/".join((self.session,) + parts).encode()

    # -- rank claim -------------------------------------------------------
    def claim_rank(self) -> int:
        """First-writer-wins rank slots (atomic no-overwrite KV puts)."""
        for rank in range(self.world_size):
            if self._kv.kv_put(self._key("rank", str(rank)), self._token,
                               namespace=self.NAMESPACE, overwrite=False):
                self.rank = rank
                return rank
            if self._kv.kv_get(self._key("rank", str(rank)),
                               namespace=self.NAMESPACE) == self._token:
                self.rank = rank
                return rank
        raise BootstrapError(
            f"all {self.world_size} ranks already claimed for session "
            f"{self.session!r}")

    # -- coordinator ------------------------------------------------------
    def coordinator_address(self, port: Optional[int] = None,
                            timeout_s: float = 60.0,
                            host: str = "127.0.0.1") -> str:
        """Rank 0 publishes ``host:port``; everyone else polls for it."""
        if self.rank is None:
            raise BootstrapError("claim_rank() first")
        key = self._key("coordinator")
        if self.rank == 0:
            address = f"{host}:{port or _free_port()}"
            self._kv.kv_put(key, address.encode(), namespace=self.NAMESPACE)
            self._coordinator = address
            return address
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            value = self._kv.kv_get(key, namespace=self.NAMESPACE)
            if value:
                self._coordinator = value.decode()
                return self._coordinator
            time.sleep(self._poll_s)
        raise BootstrapError("timed out waiting for coordinator address")

    # -- barrier ----------------------------------------------------------
    def barrier(self, name: str = "start", timeout_s: float = 60.0) -> None:
        """All ranks arrive before any proceeds (KV slot counting)."""
        if self.rank is None:
            raise BootstrapError("claim_rank() first")
        self._kv.kv_put(self._key("barrier", name, str(self.rank)), b"1",
                        namespace=self.NAMESPACE)
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            arrived = sum(
                1 for r in range(self.world_size)
                if self._kv.kv_get(self._key("barrier", name, str(r)),
                                   namespace=self.NAMESPACE))
            if arrived == self.world_size:
                return
            time.sleep(self._poll_s)
        raise BootstrapError(f"barrier {name!r} timed out")

    # -- torch.distributed hand-off -----------------------------------------
    def initialize_torch(self, backend: Optional[str] = None,
                         timeout_s: float = 300.0) -> None:
        """Join the ``torch.distributed`` world at the coordinator's address.

        ``backend`` None is NCCL (the card); ``"gloo"`` runs the group on
        the CPU (tests, several ranks sharing one card). After this returns
        on every host, ``MeshSpec.build`` sees every rank.
        """
        import torch.distributed as dist

        if self.rank is None:
            raise BootstrapError("claim_rank() first")
        if self._coordinator is None:
            self.coordinator_address()
        dist.init_process_group(
            backend or "nccl", init_method=f"tcp://{self._coordinator}",
            world_size=self.world_size, rank=self.rank,
            timeout=timedelta(seconds=timeout_s))
