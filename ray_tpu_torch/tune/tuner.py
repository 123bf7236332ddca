"""Experiment execution: Trial, TrialRunner, Tuner, ResultGrid. Counterpart
of the JAX package's ``tune/tuner.py`` on the port's session and
checkpoints, and on the actor runtime the caller passes (``runtime=``:
``remote``, ``get`` and ``kill``; ``ray_tpu.core`` has them, and so does an
in-process runtime that runs each actor in the caller's process). The
port starts no runtime itself: ``fit()`` without one raises.

Reference analog:
  - ``tune/tuner.py:40,220`` ``Tuner.fit`` → ``tune/impl/tuner_internal.py``
    → ``tune/tune.py:129`` ``tune.run``
  - ``tune/execution/trial_runner.py:236,864`` — the step loop driving
    trial actors, consuming intermediate results, applying scheduler
    decisions, handling failures
  - ``tune/trainable/function_trainable.py:277`` — user functions report
    via the session; here trials are actors hosting the user fn in a
    background thread, drained by the runner (same shape, no queue thread).

PBT exploit = stop the trial actor, mutate config, restart from the source
trial's checkpoint (reference: pbt.py _exploit :607).

Where the JAX package's runner kills a trial's worker process, an
in-process runtime cannot end a thread. So a trial is stopped in three
steps: the runner asks it to stop (its function's next ``report`` raises
``SystemExit``, which ends it), waits for its thread to end, then kills
the actor. A stopped trial runs no step after that, and a PBT relaunch
never shares its slot with the run it replaces. Each trial's thread runs
within the trial's own session (``train.session.within``), so trials that
share a process never see each other's reports. A trial's dict
checkpoint holds host copies of its tensors, taken at ``report``; it
rides the experiment-state pickle, as in the JAX package.

An experiment directory the port wrote restores in the port; one the JAX
package wrote is not read here (its pickle names that package's classes).
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ..core.serialization import install
from ..train.checkpoint import Checkpoint
from ..train.config import FailureConfig, RunConfig
from ..train.session import SessionContext, init_session, within
from ..train.session import report as _report
from .schedulers import FIFOScheduler, TrialDecision, TrialScheduler
from .search import BasicVariantGenerator, Searcher

_NO_RUNTIME = ("fit() needs runtime=: an actor runtime such as ray_tpu.core "
               "(remote, get and kill); the port imports no runtime itself")

# How long the runner waits for a stopped trial's function to end (its
# next report, or its return) before it kills the actor all the same.
STOP_JOIN_S = 120.0


class TrialStatus:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    TERMINATED = "TERMINATED"
    STOPPED = "STOPPED"
    ERROR = "ERROR"


@dataclass
class Trial:
    trial_id: str
    config: Dict
    status: str = TrialStatus.PENDING
    results: List[Dict] = field(default_factory=list)
    last_result: Dict = field(default_factory=dict)
    checkpoint: Optional[Checkpoint] = None
    error: Optional[str] = None
    iteration: int = 0
    rungs_passed: Dict = field(default_factory=dict)
    failures: int = 0
    actor: Any = None
    done_ref: Any = None


class _TrialActor:
    """Hosts one trial's user function in a background thread, within the
    trial's session."""

    def __init__(self):
        install()  # this process sends tensors (checkpoints)
        self._thread: Optional[threading.Thread] = None
        self._session = None
        self._done = False
        self._error: Optional[str] = None

    def start(self, fn, config, checkpoint=None, trial_id: str = ""):
        self._session = init_session(SessionContext(
            trial_id=trial_id, loaded_checkpoint=checkpoint,
        ))

        def run():
            try:
                with within(self._session):
                    fn(config)
            except SystemExit:
                pass
            except Exception:  # noqa: BLE001
                import traceback

                self._error = traceback.format_exc()
            finally:
                self._done = True

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        return True

    def drain(self):
        # Done is read before the drain: a report made between the two
        # reads is then drained now or at the next poll, never lost.
        done, error = self._done, self._error
        return self._session.drain(), done, error

    def request_stop(self):
        self._session.request_stop()
        return True

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait for the trial's function to end; True once it has."""
        self._thread.join(timeout)
        return not self._thread.is_alive()


@dataclass
class ResultGrid:
    """Reference analog: ``tune/result_grid.py``."""

    trials: List[Trial]

    def get_best_result(self, metric: str, mode: str = "min") -> Trial:
        scored = [t for t in self.trials if metric in t.last_result]
        if not scored:
            raise ValueError(f"no trial reported metric {metric!r}")
        return sorted(
            scored, key=lambda t: t.last_result[metric],
            reverse=(mode == "max"),
        )[0]

    def get_dataframe(self):
        rows = []
        for t in self.trials:
            row = {"trial_id": t.trial_id, "status": t.status}
            row.update({f"config/{k}": v for k, v in t.config.items()})
            row.update(t.last_result)
            rows.append(row)
        try:
            import pandas as pd

            return pd.DataFrame(rows)
        except ImportError:
            return rows

    @property
    def errors(self) -> List[str]:
        return [t.error for t in self.trials if t.error]

    def _repr_html_(self) -> str:
        """Notebook widget: one row per trial with config + last
        metrics (reference: ResultGrid._repr_html_)."""
        import html as _html

        rows = []
        for t in self.trials:
            metrics = {k: v for k, v in (t.last_result or {}).items()
                       if isinstance(v, (int, float))}
            cfg = _html.escape(str(t.config)[:120])
            ms = _html.escape(", ".join(
                f"{k}={v:.4g}" for k, v in list(metrics.items())[:6]))
            rows.append(f"<tr><td>{_html.escape(t.trial_id)}</td>"
                        f"<td>{_html.escape(t.status)}</td>"
                        f"<td><code>{cfg}</code></td><td>{ms}</td></tr>")
        return ("<table><tr><th>trial</th><th>status</th><th>config"
                "</th><th>last result</th></tr>" + "".join(rows)
                + "</table>")


class TrialRunner:
    """The experiment step loop (trial_runner.py:864)."""

    STATE_FILE = "experiment_state.pkl"

    def __init__(self, trainable: Callable, searcher: Searcher,
                 scheduler: Optional[TrialScheduler] = None,
                 max_concurrent: int = 4,
                 max_failures: int = 0,
                 stop: Optional[Dict[str, Any]] = None,
                 resources_per_trial: Optional[Dict[str, float]] = None,
                 poll_interval: float = 0.05,
                 experiment_path: Optional[str] = None,
                 checkpoint_period: float = 1.0,
                 syncer=None, runtime=None):
        if runtime is None:
            raise ValueError(_NO_RUNTIME)
        install()  # this process sends tensors (restored checkpoints)
        self.runtime = runtime
        self.trainable = trainable
        self.searcher = searcher
        self.scheduler = scheduler or FIFOScheduler()
        self.max_concurrent = max_concurrent
        self.max_failures = max_failures
        self.stop_criteria = stop or {}
        self.resources = resources_per_trial or {"CPU": 1.0}
        self.poll_interval = poll_interval
        self.trials: List[Trial] = []
        self.experiment_path = experiment_path
        # Min seconds between experiment-state writes: pickling every
        # trial's full results at poll frequency would dominate the loop
        # (reference: trial_runner checkpoint_period, default ~10s).
        self.checkpoint_period = checkpoint_period
        self._dirty = False
        self._last_save = 0.0
        self._actor_cls = runtime.remote(_TrialActor)
        # Remote mirror (reference: tune/syncer.py): every experiment-
        # state write is followed by an upload, so the sweep survives
        # losing this host's filesystem entirely.
        self.syncer = syncer

    # -- experiment-level checkpointing --------------------------------------
    # Reference: trial_runner.py:682 ``checkpoint`` — the runner persists
    # its full state (trial table, searcher, scheduler) so a crashed sweep
    # resumes with completed trials intact (``Tuner.restore``,
    # tuner.py:159).
    def save_state(self) -> None:
        if not self.experiment_path:
            return
        import cloudpickle

        os.makedirs(self.experiment_path, exist_ok=True)
        if self.syncer is not None:
            # Dir-backed trial checkpoints reference THIS host's paths;
            # materialize them so the pickle is portable to a fresh
            # workdir after sync_down.
            for t in self.trials:
                ckpt = t.checkpoint
                if ckpt is not None and getattr(ckpt, "_data", None) is None:
                    try:
                        t.checkpoint = Checkpoint.from_dict(ckpt.to_dict())
                    except Exception:  # noqa: BLE001 — keep original
                        pass
        # Live actor handles are per-process; strip them for the dump and
        # put them back (single-threaded runner loop — no races). One
        # blob keeps trial references shared by scheduler rungs / PBT
        # state consistent on load.
        stash = [(t, t.actor, t.done_ref) for t in self.trials]
        for t in self.trials:
            t.actor = None
            t.done_ref = None
        try:
            blob = cloudpickle.dumps({
                "trials": self.trials,
                "searcher": self.searcher,
                "scheduler": self.scheduler,
                "trainable": self.trainable,
                "stop": self.stop_criteria,
                "max_concurrent": self.max_concurrent,
                "max_failures": self.max_failures,
                "resources": self.resources,
            })
        finally:
            for t, actor, done_ref in stash:
                t.actor = actor
                t.done_ref = done_ref
        tmp = os.path.join(self.experiment_path, self.STATE_FILE + ".tmp")
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, os.path.join(self.experiment_path, self.STATE_FILE))
        if self.syncer is not None:
            self.syncer.sync_up(self.experiment_path)
        self._dirty = False
        self._last_save = time.monotonic()

    @classmethod
    def load_state(cls, experiment_path: str) -> Dict:
        import cloudpickle

        with open(os.path.join(experiment_path, cls.STATE_FILE), "rb") as f:
            return cloudpickle.loads(f.read())

    def restore_from(self, state: Dict) -> None:
        """Adopt a saved experiment state: completed trials keep their
        results; trials that were RUNNING at save time become PENDING
        and relaunch from their last in-trial checkpoint."""
        self.trials = state["trials"]
        self.searcher = state["searcher"]
        self.scheduler = state["scheduler"]
        for t in self.trials:
            t.actor = None
            t.done_ref = None
            if t.status == TrialStatus.RUNNING:
                t.status = TrialStatus.PENDING

    # -- lifecycle -----------------------------------------------------------
    def _launch(self, trial: Trial,
                checkpoint: Optional[Checkpoint] = None) -> None:
        actor = self._actor_cls.options(
            num_cpus=self.resources.get("CPU", 1.0),
            resources={k: v for k, v in self.resources.items()
                       if k != "CPU"} or None,
        ).remote()
        trial.actor = actor
        trial.done_ref = actor.start.remote(
            self.trainable, trial.config,
            checkpoint or trial.checkpoint, trial.trial_id,
        )
        trial.status = TrialStatus.RUNNING

    def _stop_trial(self, trial: Trial, status: str) -> None:
        trial.status = status
        self._dirty = True
        if trial.actor is not None:
            get = self.runtime.get
            try:
                # Ask first, then wait for the function to end: killing
                # the actor ends a worker process but not a thread.
                get(trial.actor.request_stop.remote(), timeout=30)
                get(trial.actor.join.remote(STOP_JOIN_S),
                    timeout=STOP_JOIN_S + 30)
            except Exception:  # noqa: BLE001 — a dead actor is stopped
                pass
            try:
                self.runtime.kill(trial.actor)
            except Exception:  # noqa: BLE001
                pass
            trial.actor = None

    # -- the loop ------------------------------------------------------------
    def run(self) -> ResultGrid:
        while True:
            self._maybe_start_trials()
            running = [t for t in self.trials
                       if t.status == TrialStatus.RUNNING]
            if not running and not self._more_trials_possible():
                break
            for trial in running:
                self._poll_trial(trial)
            if self._dirty and (time.monotonic() - self._last_save
                                >= self.checkpoint_period):
                self.save_state()
            time.sleep(self.poll_interval)
        if self._dirty:
            self.save_state()
        return ResultGrid(self.trials)

    def _more_trials_possible(self) -> bool:
        probe = self.searcher.suggest("__peek__") if hasattr(
            self.searcher, "_variants"
        ) else None
        if probe is not None:
            # un-consume: re-insert at front
            self.searcher._index -= 1  # type: ignore[attr-defined]
            return True
        return False

    def _maybe_start_trials(self) -> None:
        running = sum(1 for t in self.trials
                      if t.status == TrialStatus.RUNNING)
        # Restored PENDING trials first (resume from their checkpoint)
        # before consuming fresh samples from the searcher.
        for trial in self.trials:
            if running >= self.max_concurrent:
                return
            if trial.status == TrialStatus.PENDING and trial.actor is None:
                self._launch(trial, checkpoint=trial.checkpoint)
                self._dirty = True
                running += 1
        while running < self.max_concurrent:
            trial_id = f"trial_{len(self.trials):05d}_{uuid.uuid4().hex[:6]}"
            config = self.searcher.suggest(trial_id)
            if config is None:
                return
            trial = Trial(trial_id, config)
            self.trials.append(trial)
            self._launch(trial)
            self._dirty = True
            running += 1

    def _poll_trial(self, trial: Trial) -> None:
        try:
            reports, done, error = self.runtime.get(
                trial.actor.drain.remote(), timeout=30)
        except Exception as e:  # actor died
            self._handle_failure(trial, str(e))
            return
        decision = TrialDecision.CONTINUE
        if reports:
            self._dirty = True
        for metrics, ckpt in reports:
            trial.iteration += 1
            metrics.setdefault("training_iteration", trial.iteration)
            trial.results.append(metrics)
            trial.last_result = metrics
            if ckpt is not None:
                trial.checkpoint = ckpt
            if self._should_stop_by_criteria(metrics):
                decision = TrialDecision.STOP
            if decision == TrialDecision.CONTINUE:
                decision = self.scheduler.on_result(trial, metrics)
        if decision == TrialDecision.STOP:
            self._stop_trial(trial, TrialStatus.STOPPED)
            self.scheduler.on_trial_complete(trial, trial.last_result)
            self.searcher.on_trial_complete(trial.trial_id, trial.last_result)
            return
        if decision == TrialDecision.EXPLOIT:
            self._exploit(trial)
            return
        if done:
            if error:
                self._handle_failure(trial, error)
            else:
                self._stop_trial(trial, TrialStatus.TERMINATED)
                self.scheduler.on_trial_complete(trial, trial.last_result)
                self.searcher.on_trial_complete(trial.trial_id,
                                                trial.last_result)

    def _should_stop_by_criteria(self, metrics: Dict) -> bool:
        for key, threshold in self.stop_criteria.items():
            v = metrics.get(key)
            if v is not None and v >= threshold:
                return True
        return False

    def _exploit(self, trial: Trial) -> None:
        """PBT: restart from a better trial's checkpoint with mutated config.

        Reference: pbt.py _exploit (:607).
        """
        source = self.scheduler.choose_exploit_source(trial, self.trials)
        if source is None or source.checkpoint is None:
            return
        self._stop_trial(trial, TrialStatus.PENDING)
        trial.config = self.scheduler.mutate_config(dict(source.config))
        trial.checkpoint = source.checkpoint
        self._launch(trial, checkpoint=source.checkpoint)

    def _handle_failure(self, trial: Trial, error: str) -> None:
        trial.failures += 1
        self._stop_trial(trial, TrialStatus.ERROR)
        if trial.failures <= self.max_failures:
            # Trial-level FT: restart from its last checkpoint
            # (reference: trial_runner.py restore-on-failure path).
            self._launch(trial, checkpoint=trial.checkpoint)
            trial.status = TrialStatus.RUNNING
        else:
            trial.error = error
            self.searcher.on_trial_complete(trial.trial_id, None, error=True)


@dataclass
class TuneConfig:
    """Reference: tune/tune_config.py."""

    metric: Optional[str] = None
    mode: str = "min"
    num_samples: int = 1
    max_concurrent_trials: int = 4
    search_alg: Optional[Searcher] = None
    scheduler: Optional[TrialScheduler] = None


class Tuner:
    """Reference: ``tune/tuner.py`` — Tuner(trainable, param_space).fit().

    ``runtime=`` is the actor runtime the trials run on (as ``TorchTrainer``
    takes it). A trainer with ``as_trainable`` (``TorchTrainer``) runs as
    a function trainable on the runtime it was given."""

    def __init__(self, trainable: Callable,
                 *, param_space: Optional[Dict] = None,
                 tune_config: Optional[TuneConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 resources_per_trial: Optional[Dict[str, float]] = None,
                 runtime=None):
        if hasattr(trainable, "as_trainable"):
            trainable = trainable.as_trainable()
        self.trainable = trainable
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config or RunConfig()
        self.resources_per_trial = resources_per_trial
        self.runtime = runtime
        self._restored_state: Optional[Dict] = None
        self._restored_path: Optional[str] = None
        self._restored_syncer = None
        self._staging_dir: Optional[str] = None

    def _experiment_name(self) -> str:
        return self.run_config.name or "tune_experiment"

    def _experiment_path(self) -> Optional[str]:
        if self._restored_path:
            return self._restored_path
        sp = self.run_config.storage_path
        if sp is None:
            return None
        from .syncer import is_uri

        if is_uri(sp):
            # Remote destination: the experiment runs in a local staging
            # dir and the syncer mirrors it to the URI after every
            # state write (reference: tune/syncer.py upload_dir). The
            # staging dir is uniqued per Tuner instance — a fixed
            # name-keyed path would let concurrent same-named sweeps
            # cross-contaminate each other's remote mirrors.
            if self._staging_dir is None:
                import tempfile

                self._staging_dir = os.path.join(
                    tempfile.gettempdir(), "rt_tune_staging",
                    f"{self._experiment_name()}-{uuid.uuid4().hex[:8]}")
            return self._staging_dir
        return os.path.join(sp, self._experiment_name())

    def _syncer(self):
        from .syncer import Syncer, is_uri

        if self._restored_syncer is not None:
            return self._restored_syncer
        sp = self.run_config.storage_path
        if not is_uri(sp):
            return None
        return Syncer(sp.rstrip("/") + "/" + self._experiment_name())

    @classmethod
    def restore(cls, path: str, trainable: Optional[Callable] = None,
                runtime=None) -> "Tuner":
        """Resume a crashed/interrupted experiment from its persisted
        state: completed trials keep their results (never retrained),
        in-flight trials resume from their last in-trial checkpoint,
        and searcher/scheduler state (consumed samples, ASHA rungs, PBT
        history) carries over. Reference: ``tune/tuner.py:159``
        ``Tuner.restore`` + experiment checkpointing
        (``tune/execution/trial_runner.py:682``).

        ``path`` may be a storage URI (the syncer's upload destination):
        the experiment is synced down into a FRESH staging dir first, so
        restore works with the original local workdir gone entirely.
        The experiment must be one the port wrote: the JAX package's
        state pickle names that package's classes, which the port never
        imports."""
        from .syncer import Syncer, is_uri

        syncer = None
        if is_uri(path):
            import tempfile

            syncer = Syncer(path)
            staging = os.path.join(
                tempfile.gettempdir(), "rt_tune_staging",
                f"restore-{uuid.uuid4().hex[:8]}")
            os.makedirs(staging, exist_ok=True)
            if syncer.sync_down(staging) == 0:
                raise FileNotFoundError(
                    f"no experiment state found at {path!r}")
            path = staging
        state = TrialRunner.load_state(path)
        tuner = cls(
            trainable or state["trainable"],
            tune_config=TuneConfig(
                max_concurrent_trials=state["max_concurrent"]),
            run_config=RunConfig(
                stop=state["stop"],
                failure_config=FailureConfig(
                    max_failures=state["max_failures"])),
            resources_per_trial=state["resources"],
            runtime=runtime,
        )
        tuner._restored_state = state
        tuner._restored_path = path
        tuner._restored_syncer = syncer
        return tuner

    @staticmethod
    def can_restore(path: str) -> bool:
        from .syncer import Syncer, is_uri

        if is_uri(path):
            try:
                return Syncer(path).client.exists(TrialRunner.STATE_FILE)
            except Exception:  # noqa: BLE001 — unknown scheme etc.
                return False
        return os.path.exists(os.path.join(path, TrialRunner.STATE_FILE))

    def fit(self) -> ResultGrid:
        if self.runtime is None:
            raise ValueError(_NO_RUNTIME)
        searcher = self.tune_config.search_alg or BasicVariantGenerator(
            self.param_space, num_samples=self.tune_config.num_samples
        )
        runner = TrialRunner(
            self.trainable, searcher,
            scheduler=self.tune_config.scheduler,
            max_concurrent=self.tune_config.max_concurrent_trials,
            max_failures=self.run_config.failure_config.max_failures,
            stop=self.run_config.stop,
            resources_per_trial=self.resources_per_trial,
            experiment_path=self._experiment_path(),
            syncer=self._syncer(),
            runtime=self.runtime,
        )
        if self._restored_state is not None:
            runner.restore_from(self._restored_state)
        return runner.run()


def run(trainable: Callable, config: Optional[Dict] = None,
        num_samples: int = 1, scheduler: Optional[TrialScheduler] = None,
        stop: Optional[Dict] = None, max_concurrent_trials: int = 4,
        runtime=None, **kwargs) -> ResultGrid:
    """Functional entry point (reference: ``tune.run``, tune/tune.py:129)."""
    tuner = Tuner(
        trainable,
        param_space=config,
        tune_config=TuneConfig(num_samples=num_samples, scheduler=scheduler,
                               max_concurrent_trials=max_concurrent_trials),
        run_config=RunConfig(stop=stop),
        runtime=runtime,
    )
    return tuner.fit()


def report(metrics: Dict, checkpoint: Optional[Checkpoint] = None) -> None:
    """In-trial reporting (reference: ``tune.report`` / session.report):
    to the session the calling thread runs within."""
    _report(metrics, checkpoint)
