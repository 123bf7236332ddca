"""WorkerGroup: a gang of actor processes forming one SPMD program.
Counterpart of the JAX package's ``train/worker_group.py``, on the actor
runtime the caller passes (``runtime=``: ``placement_group``,
``remove_placement_group``, ``PlacementGroupSchedulingStrategy``,
``remote``, ``get`` and ``kill``; ``ray_tpu.core`` has them all). The port
imports no runtime itself.

Reference analog: ``python/ray/train/_internal/worker_group.py:91,334`` — N
actors in a placement group, ``execute()`` runs a function on all workers.
A multi-process run joins one ``torch.distributed`` world through
``parallel.bootstrap.Bootstrap`` inside the workers.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from ..core.serialization import install
from .session import SessionContext, init_session, within


class _TrainWorker:
    """Actor body: hosts the session and executes arbitrary fns, each
    within the worker's session (an in-process runtime may run the worker
    in the thread of a Tune trial, whose session must stay the trial's)."""

    def __init__(self, world_rank: int, world_size: int, env: Optional[dict]):
        import os

        install()  # this process sends tensors (reports, checkpoints)
        os.environ.update(env or {})
        self.ctx = SessionContext(world_rank=world_rank,
                                  world_size=world_size,
                                  local_rank=world_rank)
        self.session = init_session(self.ctx)
        self._train_result = None
        self._train_error = None

    def setup_session(self, **ctx_updates):
        for k, v in ctx_updates.items():
            setattr(self.ctx, k, v)
        return True

    def execute(self, fn, *args, **kwargs):
        with within(self.session):
            return fn(*args, **kwargs)

    def run_train_fn(self, train_fn, config):
        """Run the user train loop to completion (blocking actor method)."""
        try:
            import inspect

            sig = inspect.signature(train_fn)
            with within(self.session):
                if len(sig.parameters) >= 1:
                    result = train_fn(config if config is not None else {})
                else:
                    result = train_fn()
            self._train_result = result
            return ("ok", result)
        except Exception as e:  # noqa: BLE001
            import traceback

            self._train_error = traceback.format_exc()
            return ("error", f"{e}\n{self._train_error}")

    def drain_results(self):
        return self.session.drain()

    def get_context(self):
        return {
            "world_rank": self.ctx.world_rank,
            "world_size": self.ctx.world_size,
        }


class InsufficientResourcesError(RuntimeError):
    """Gang capacity is not (yet) available — retryable by the Trainer.

    Distinct from plain RuntimeError so a genuine config/setup bug does
    not silently spin for gang_start_timeout_s before surfacing.
    """


_NO_RUNTIME = ("WorkerGroup needs runtime=: an object with placement_group, "
               "remove_placement_group, PlacementGroupSchedulingStrategy, "
               "remote, get, wait and kill, such as ray_tpu.core; the port "
               "imports no runtime itself")


class WorkerGroup:
    """N train-worker actors in a placement group of ``runtime``."""

    def __init__(self, num_workers: int,
                 resources_per_worker: Optional[Dict[str, float]] = None,
                 placement_strategy: str = "PACK",
                 env: Optional[dict] = None, runtime=None):
        if runtime is None:
            raise ValueError(_NO_RUNTIME)
        install()  # this process sends tensors (configs, checkpoints)
        self.runtime = runtime
        self.num_workers = num_workers
        resources = dict(resources_per_worker or {"CPU": 1.0})
        bundles = [dict(resources) for _ in range(num_workers)]
        self._pg = runtime.placement_group(bundles,
                                           strategy=placement_strategy)
        if not self._pg.wait(60):
            runtime.remove_placement_group(self._pg)
            raise InsufficientResourcesError(
                f"could not reserve {num_workers}x{resources} for WorkerGroup"
            )
        worker_cls = runtime.remote(_TrainWorker)
        self.workers = []
        for rank in range(num_workers):
            # max_concurrency=2: run_train_fn BLOCKS its executor slot
            # for the whole training run; the second slot keeps
            # drain_results/setup_session live so reports and async
            # checkpoints stream out DURING training. session.report/drain
            # are lock-guarded for exactly this concurrency.
            actor = worker_cls.options(
                num_cpus=resources.get("CPU", 1.0),
                max_concurrency=2,
                scheduling_strategy=runtime.PlacementGroupSchedulingStrategy(
                    placement_group=self._pg,
                    placement_group_bundle_index=rank,
                ),
            ).remote(rank, num_workers, env)
            self.workers.append(actor)

    def execute(self, fn: Callable, *args, **kwargs) -> List[Any]:
        """Run ``fn`` on every worker simultaneously; gather results.

        Reference: WorkerGroup.execute (worker_group.py:225-287).
        """
        refs = [w.execute.remote(fn, *args, **kwargs) for w in self.workers]
        return self.runtime.get(refs)

    def execute_async(self, fn: Callable, *args, **kwargs):
        return [w.execute.remote(fn, *args, **kwargs) for w in self.workers]

    def execute_single(self, rank: int, fn: Callable, *args, **kwargs):
        return self.runtime.get(
            self.workers[rank].execute.remote(fn, *args, **kwargs))

    def run_train_fns(self, train_fn: Callable, config):
        """Kick off the user train loop on all workers (non-blocking)."""
        return [w.run_train_fn.remote(train_fn, config) for w in self.workers]

    def drain_results(self) -> List[List]:
        return self.runtime.get([w.drain_results.remote()
                                 for w in self.workers])

    def setup_sessions(self, **ctx_updates) -> None:
        self.runtime.get([w.setup_session.remote(**ctx_updates)
                          for w in self.workers])

    def shutdown(self) -> None:
        for w in self.workers:
            try:
                self.runtime.kill(w)
            except Exception:  # an actor already gone is what shutdown wants
                pass
        self.runtime.remove_placement_group(self._pg)

    def __len__(self):
        return self.num_workers
