"""In-worker training session: report/checkpoint/rank context. A copy of
the JAX package's ``train/session.py``.

Reference analog: ``python/ray/air/session.py:12,64,221`` (public API) +
``python/ray/train/_internal/session.py:58,295``. The session is a plain
object installed in the worker process; ``report()`` appends to a result
buffer the executor drains via an actor method.

One difference: the port updates tensors in place (its optimizer and
``build_train``), where JAX arrays never change. So ``report`` snapshots
the tensors of a dict checkpoint to the host at the call
(``checkpoint.snapshot``); the checkpoint is the state of the step that
reported it, whenever the executor drains it.

Two more, because the port's actors may share one process (an in-process
runtime runs every trial and train worker as threads of the caller):

- A session is scoped to the thread that runs under it. ``init_session``
  installs the process's session, as in the JAX package: on a runtime of
  worker processes each actor keeps one. An actor body that runs user
  code (a trial's thread, a train worker's ``run_train_fn``) runs it
  ``within`` its own session, which that thread sees over the process's,
  nested: a train worker's session inside a trial's thread ends when its
  run does, and the trial's is the thread's again.
- A trial can be asked to stop (``request_stop``): its next ``report``
  raises ``SystemExit``, which ends the trial's function (the trial's
  thread takes it for a normal end). A worker process is killed instead;
  a thread cannot be, so without this a stopped trial in one process
  would go on training.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .checkpoint import Checkpoint, snapshot


@dataclass
class SessionContext:
    world_rank: int = 0
    world_size: int = 1
    local_rank: int = 0
    node_rank: int = 0
    experiment_name: str = ""
    trial_id: str = ""
    trial_dir: Optional[str] = None
    dataset_shards: Dict[str, Any] = field(default_factory=dict)
    loaded_checkpoint: Optional[Checkpoint] = None


class _Session:
    def __init__(self, ctx: SessionContext):
        self.ctx = ctx
        self.results: List[Dict] = []
        self.checkpoints: List[Optional[Checkpoint]] = []
        self._lock = threading.Lock()
        self._stop = False

    def request_stop(self) -> None:
        """Make the next ``report`` end the function that calls it."""
        self._stop = True

    def report(self, metrics: Dict, checkpoint: Optional[Checkpoint] = None):
        if self._stop:
            raise SystemExit("the trial was stopped")
        if checkpoint is not None and checkpoint._data is not None:
            checkpoint = Checkpoint.from_dict(snapshot(checkpoint._data))
        with self._lock:
            self.results.append(dict(metrics))
            self.checkpoints.append(checkpoint)

    def drain(self):
        with self._lock:
            out = list(zip(self.results, self.checkpoints))
            self.results = []
            self.checkpoints = []
            return out


_session: Optional[_Session] = None  # the process's
_bound = threading.local()  # .stack: the sessions this thread runs within


def init_session(ctx: SessionContext) -> _Session:
    """A new session, installed as the process's."""
    global _session
    _session = _Session(ctx)
    return _session


@contextlib.contextmanager
def within(session: _Session):
    """Run the block under ``session`` on this thread, over the session
    it ran under before (which it runs under again after the block)."""
    stack = _bound.__dict__.setdefault("stack", [])
    stack.append(session)
    try:
        yield session
    finally:
        stack.pop()


def get_session() -> Optional[_Session]:
    """The innermost session this thread runs within, else the
    process's."""
    stack = getattr(_bound, "stack", None)
    return stack[-1] if stack else _session


def shutdown_session() -> None:
    global _session
    _session = None


# -- public API (air/session.py surface) ------------------------------------

def report(metrics: Dict, checkpoint: Optional[Checkpoint] = None) -> None:
    """Report metrics (and optionally a checkpoint) from a train worker."""
    s = get_session()
    if s is None:
        raise RuntimeError("session.report() called outside a train session")
    s.report(metrics, checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    s = get_session()
    return s.ctx.loaded_checkpoint if s else None


def get_dataset_shard(name: str = "train"):
    s = get_session()
    if s is None:
        return None
    return s.ctx.dataset_shards.get(name)


def get_world_rank() -> int:
    s = get_session()
    return s.ctx.world_rank if s else 0


def get_world_size() -> int:
    s = get_session()
    return s.ctx.world_size if s else 1


def get_local_rank() -> int:
    s = get_session()
    return s.ctx.local_rank if s else 0


def get_trial_id() -> str:
    s = get_session()
    return s.ctx.trial_id if s else ""


def get_trial_dir() -> Optional[str]:
    s = get_session()
    return s.ctx.trial_dir if s else None
