"""ActorPool: map work over a fixed set of actors. A copy of the JAX
package's ``util/actor_pool.py`` whose ``get`` and ``wait`` come from the
runtime the caller passes (``runtime=``; ``ray_tpu.core`` is one), and
whose ``_wait_one`` waits only on refs of busy actors.

Reference analog: ``python/ray/util/actor_pool.py:8,46,120`` — submit,
map/map_unordered, get_next with a free-actor queue.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, List


class ActorPool:
    def __init__(self, actors: List[Any], runtime):
        self._runtime = runtime
        self._idle = list(actors)
        self._future_to_actor = {}
        self._pending = []  # submission order
        self._all = list(actors)

    def submit(self, fn: Callable, value: Any) -> None:
        """fn(actor, value) -> ObjectRef; blocks if no actor is free."""
        while not self._idle:
            self._wait_one()
        actor = self._idle.pop(0)
        ref = fn(actor, value)
        self._future_to_actor[ref] = actor
        self._pending.append(ref)

    def has_next(self) -> bool:
        return bool(self._pending)

    def get_next(self, timeout=None) -> Any:
        """Next result in submission order."""
        if not self._pending:
            raise StopIteration("no pending results")
        ref = self._pending.pop(0)
        value = self._runtime.get(ref, timeout=timeout)
        self._release(ref)
        return value

    def get_next_unordered(self, timeout=None) -> Any:
        if not self._pending:
            raise StopIteration("no pending results")
        ready, _ = self._runtime.wait(self._pending, num_returns=1,
                                      timeout=timeout)
        if not ready:
            raise TimeoutError("get_next_unordered timed out")
        ref = ready[0]
        self._pending.remove(ref)
        value = self._runtime.get(ref)
        self._release(ref)
        return value

    def _wait_one(self) -> None:
        # Only refs whose actor is still busy: a ready ref that already
        # freed its actor stays pending for get_next, and waiting on it
        # again would free nothing (the JAX package's pool loops forever
        # there once a map has more than twice as many values as actors).
        busy = [r for r in self._pending if r in self._future_to_actor]
        ready, _ = self._runtime.wait(busy, num_returns=1)
        # Result stays pending for get_next; but actor becomes free.
        actor = self._future_to_actor.pop(ready[0])
        if actor not in self._idle:
            self._idle.append(actor)

    def _release(self, ref) -> None:
        actor = self._future_to_actor.pop(ref, None)
        if actor is not None and actor not in self._idle:
            self._idle.append(actor)

    def map(self, fn: Callable, values: Iterable[Any]) -> Iterator[Any]:
        values = list(values)
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable, values: Iterable[Any]
                      ) -> Iterator[Any]:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    def has_free(self) -> bool:
        return bool(self._idle)

    def pop_idle(self):
        return self._idle.pop(0) if self._idle else None

    def push(self, actor) -> None:
        self._idle.append(actor)
