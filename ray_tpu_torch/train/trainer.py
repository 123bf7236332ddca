"""Trainers: the user-facing Train API. Counterpart of the JAX package's
``train/trainer.py``; ``TorchTrainer`` takes ``JaxTrainer``'s place.

Reference analog:
  - ``train/base_trainer.py:339`` ``BaseTrainer.fit`` (+ ``as_trainable``
    :365 so every Train job runs as a Tune trial);
  - ``train/data_parallel_trainer.py:320`` ``training_loop`` driving
    ``BackendExecutor`` (``train/_internal/backend_executor.py:42,93,275``)
    which starts a WorkerGroup and runs the user ``train_func`` per worker.

The gang runs on the actor runtime the caller passes (``runtime=``, as
``WorkerGroup`` takes it); ``fit`` starts no runtime and raises without
one. The retry, gang-start wait and checkpoint-on-report semantics are the
JAX package's. The user train_func uses ``session.report``; a
multi-process run joins its ``torch.distributed`` world inside the
train_func (``parallel.bootstrap``).
"""

from __future__ import annotations

import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from .checkpoint import Checkpoint, CheckpointManager
from .config import RunConfig, ScalingConfig
from .worker_group import InsufficientResourcesError, WorkerGroup

_NO_RUNTIME = ("fit() needs runtime=: an actor runtime such as ray_tpu.core "
               "(see WorkerGroup); the port imports no runtime itself")


@dataclass
class Result:
    """Reference analog: ``air.result.Result`` / ``ResultGrid`` entry."""

    metrics: Dict[str, Any] = field(default_factory=dict)
    checkpoint: Optional[Checkpoint] = None
    error: Optional[str] = None
    metrics_history: List[Dict[str, Any]] = field(default_factory=list)
    path: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.error is None


class BackendExecutor:
    """Starts the worker gang and drives the user train loop.

    Reference: ``backend_executor.py`` — ``start`` (:93) creates the
    WorkerGroup, ``start_training`` (:275) launches train_func per worker
    with rank env, results polled from per-worker sessions.
    """

    def __init__(self, scaling: ScalingConfig, env: Optional[dict] = None,
                 runtime=None):
        self.scaling = scaling
        self.env = env
        self.runtime = runtime
        self.worker_group: Optional[WorkerGroup] = None

    def start(self) -> None:
        self.worker_group = WorkerGroup(
            self.scaling.num_workers,
            resources_per_worker=self.scaling.worker_resources(),
            placement_strategy=self.scaling.placement_strategy,
            env=self.env, runtime=self.runtime,
        )

    def run(self, train_fn: Callable, config: Optional[Dict],
            on_report: Optional[Callable] = None,
            poll_interval: float = 0.2,
            loaded_checkpoint: Optional[Checkpoint] = None) -> List[Any]:
        assert self.worker_group is not None, "call start() first"
        if self.scaling.mesh is not None:
            # The ScalingConfig's mesh layout is the worker's parallelism
            # contract — surface it in the train config so train_funcs
            # build exactly the requested dp/fsdp/pp/sp/tp/ep mesh.
            config = dict(config or {})
            config.setdefault("mesh_spec", self.scaling.mesh)
        if loaded_checkpoint is not None:
            self.worker_group.setup_sessions(
                loaded_checkpoint=loaded_checkpoint
            )
        done_refs = self.worker_group.run_train_fns(train_fn, config)
        pending = list(done_refs)
        while pending:
            ready, pending = self.runtime.wait(
                pending, num_returns=len(pending), timeout=poll_interval)
            for batch in self.worker_group.drain_results():
                for metrics, ckpt in batch:
                    if on_report is not None:
                        on_report(metrics, ckpt)
        outcomes = self.runtime.get(done_refs)
        # Final drain after completion.
        for batch in self.worker_group.drain_results():
            for metrics, ckpt in batch:
                if on_report is not None:
                    on_report(metrics, ckpt)
        return outcomes

    def shutdown(self) -> None:
        if self.worker_group is not None:
            self.worker_group.shutdown()
            self.worker_group = None


class DataParallelTrainer:
    """Run ``train_loop_per_worker`` on N workers; aggregate rank-0 reports.

    Reference: ``DataParallelTrainer``.
    """

    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[Dict] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        datasets: Optional[Dict[str, Any]] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
        runtime=None,
    ):
        self._train_fn = train_loop_per_worker
        self._config = train_loop_config
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self._datasets = datasets or {}
        self._resume_from = resume_from_checkpoint
        self._runtime = runtime

    def fit(self) -> Result:
        import os
        import tempfile

        if self._runtime is None:
            raise ValueError(_NO_RUNTIME)
        name = self.run_config.name or f"train-{uuid.uuid4().hex[:8]}"
        storage = self.run_config.storage_path or os.path.join(
            tempfile.gettempdir(), "rt_results"
        )
        trial_dir = os.path.join(storage, name)
        ckpt_cfg = self.run_config.checkpoint_config
        manager = CheckpointManager(
            os.path.join(trial_dir, "checkpoints"),
            num_to_keep=ckpt_cfg.num_to_keep,
            score_attribute=ckpt_cfg.checkpoint_score_attribute,
            score_order=ckpt_cfg.checkpoint_score_order,
        )
        history: List[Dict] = []
        latest_ckpt: List[Optional[Checkpoint]] = [self._resume_from]
        step_counter = [0]

        def on_report(metrics: Dict, ckpt: Optional[Checkpoint]):
            history.append(metrics)
            if ckpt is not None:
                step_counter[0] += 1
                if ckpt_cfg.async_save:
                    manager.save_async(ckpt, step_counter[0], metrics)
                else:
                    manager.save(ckpt, step_counter[0], metrics)
                latest_ckpt[0] = ckpt

        executor = BackendExecutor(self.scaling_config, runtime=self._runtime)
        fail_cfg = self.run_config.failure_config
        failures_left = fail_cfg.max_failures
        start_deadline: Optional[float] = None
        while True:
            try:
                # Gang start gets its own patience budget: waiting for
                # backfill capacity must not burn max_failures, only
                # exceeding gang_start_timeout_s does. Only the capacity
                # error is retried; config bugs propagate.
                executor.start()
            except InsufficientResourcesError as e:
                executor.shutdown()
                now = time.monotonic()
                if start_deadline is None:
                    start_deadline = now + fail_cfg.gang_start_timeout_s
                    import sys

                    print(f"train: gang start failed ({e}); waiting up "
                          f"to {fail_cfg.gang_start_timeout_s:.0f}s for "
                          "capacity", file=sys.stderr)
                if now < start_deadline:
                    time.sleep(1.0)
                    continue
                start_deadline = None
                if failures_left != 0:
                    failures_left -= 1
                    continue
                manager.wait_async()
                return Result(metrics=history[-1] if history else {},
                              checkpoint=latest_ckpt[0], error=str(e),
                              metrics_history=history, path=trial_dir)
            start_deadline = None
            try:
                if self._datasets:
                    shards = self._shard_datasets(executor.worker_group)
                    for rank, worker_shards in enumerate(shards):
                        executor.worker_group.workers[
                            rank].setup_session.remote(
                            dataset_shards=worker_shards
                        )
                outcomes = executor.run(
                    self._train_fn, self._config, on_report=on_report,
                    loaded_checkpoint=latest_ckpt[0],
                )
            except Exception as e:  # noqa: BLE001 — worker gang crashed
                executor.shutdown()
                if failures_left != 0:
                    failures_left -= 1
                    continue  # restart from latest checkpoint
                manager.wait_async()
                return Result(metrics=history[-1] if history else {},
                              checkpoint=latest_ckpt[0], error=str(e),
                              metrics_history=history, path=trial_dir)
            executor.shutdown()
            errors = [o[1] for o in outcomes if o[0] == "error"]
            if errors and failures_left != 0:
                failures_left -= 1
                continue
            manager.wait_async()  # async checkpoint saves land before done
            return Result(
                metrics=history[-1] if history else {},
                checkpoint=latest_ckpt[0],
                error=errors[0] if errors else None,
                metrics_history=history,
                path=trial_dir,
            )

    def _shard_datasets(self, worker_group) -> List[Dict[str, Any]]:
        """Split datasets across workers (reference: dataset_spec
        get_dataset_shards)."""
        n = len(worker_group)
        out: List[Dict[str, Any]] = [dict() for _ in range(n)]
        for name, ds in self._datasets.items():
            if hasattr(ds, "split"):
                shards = ds.split(n)
            else:
                shards = [ds] * n
            for rank in range(n):
                out[rank][name] = shards[rank]
        return out

    def as_trainable(self):
        """Adapt for the Tune layer (reference: base_trainer.py:365): a
        function trainable whose fit reports its final metrics and
        checkpoint once, to the session of the trial that calls it."""
        trainer = self

        def trainable(config: Dict):
            from . import session as tune_session

            # The trial's session, taken before the fit: on an in-process
            # runtime the train worker runs in this thread, within a
            # session of its own.
            s = tune_session.get_session()
            merged = dict(trainer._config or {})
            merged.update(config)
            t = DataParallelTrainer(
                trainer._train_fn,
                train_loop_config=merged,
                scaling_config=trainer.scaling_config,
                run_config=trainer.run_config,
                datasets=trainer._datasets,
                runtime=trainer._runtime,
            )
            result = t.fit()
            if s is not None and result.metrics:
                s.report(result.metrics, result.checkpoint)
            return result.metrics

        return trainable


class TorchTrainer(DataParallelTrainer):
    """The port's native trainer (the JAX package's ``JaxTrainer`` slot)."""
