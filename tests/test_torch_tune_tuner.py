"""The port's ``Tuner`` (``ray_tpu_torch.tune``) against the JAX package's
``ray_tpu.tune.Tuner``, and on an in-process runtime.

- On ``runtime=ray_tpu.core`` (the JAX Tuner starts the same runtime):
  the same numpy trainable through both Tuners gives the same configs,
  statuses, results and best trial, for a grid under FIFO, ASHA (one
  trial at a time: the decisions are then the same whatever the timing),
  a PBT exploit, ``Tuner.restore`` of a sweep interrupted mid-trial, and
  a sweep synced to a ``file://`` URI restored with its local copy gone.
- On ``chip_smoke.InlineRuntime`` (every actor in this process, as on
  the card): concurrent trials' reports reach their own trial; a stopped
  trial's function ends at its next report; ``Tuner(TorchTrainer(...))``
  reports each trial's fit once; an RLlib algorithm's ``as_trainable``
  reports each iteration through the port's ``tune.report``.
- A tiny GPT-2 (2 layers, d 64, weights bridged by ``models/convert.py``)
  trained in each trial of both Tuners: per-trial losses within 1e-5
  relative (``tests/test_torch_train.py``'s tolerance; both fp32).

No check depends on timing: where trials run two at a time, what is
checked holds for every interleaving.
"""

import importlib
import os
import pathlib
import shutil
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ray_tpu.core
from ray_tpu.models import gpt2 as jgpt2
from torch_time_limit import time_limit

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (InlineRuntime)

LIBS = {"jax": "ray_tpu", "torch": "ray_tpu_torch"}
_limit = time_limit(240)


def _tune(pkg):
    return importlib.import_module(LIBS[pkg] + ".tune")


def _train(pkg):
    return importlib.import_module(LIBS[pkg] + ".train")


def _rt(pkg):
    return {"runtime": ray_tpu.core} if pkg == "torch" else {}


def _grid(result):
    return [dict(config=t.config, status=t.status, results=t.results,
                 last=t.last_result) for t in result.trials]


def _both(run):
    """``run(pkg)`` for each package, the two sweeps at once (each on
    actors of its own); returns (jax's, the port's)."""
    out, errors = {}, []

    def one(pkg):
        try:
            out[pkg] = run(pkg)
        except BaseException as e:  # noqa: BLE001 — raised below
            errors.append(e)

    threads = [threading.Thread(target=one, args=(pkg,)) for pkg in LIBS]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    return out["jax"], out["torch"]


# -- the port's Tuner against the JAX package's, on ray_tpu.core --------------

def test_grid_under_fifo_matches_jax(rt_shared):
    def run(pkg):
        name = LIBS[pkg] + ".tune"

        def trainable(config):
            import importlib

            tune = importlib.import_module(name)
            for i in range(4):
                tune.report({"loss": (config["x"] - 2) ** 2 + 1.0 / (i + 1),
                             "tag": config["tag"]})

        t = _tune(pkg)
        return t.Tuner(trainable, param_space={
            "x": t.grid_search([1, 2, 3]), "tag": "a"},
            tune_config=t.TuneConfig(max_concurrent_trials=2),
            **_rt(pkg)).fit()

    want, got = _both(run)
    assert _grid(got) == _grid(want)
    assert all(t.status == "TERMINATED" and len(t.results) == 4
               for t in got.trials)
    assert (got.get_best_result("loss").config
            == want.get_best_result("loss").config == {"x": 2, "tag": "a"})
    frames = [g.get_dataframe().drop(columns=["trial_id"]).to_dict()
              for g in (want, got)]
    assert frames[0] == frames[1]
    assert list(got.get_dataframe()["config/x"]) == [1, 2, 3]
    assert "<table>" in got._repr_html_()


class Recording:
    """A scheduler that logs each decision of the one it wraps:
    (config, training_iteration, decision)."""

    def __init__(self, inner):
        self.inner, self.log = inner, []

    def on_result(self, trial, result):
        d = self.inner.on_result(trial, result)
        self.log.append((dict(trial.config), result["training_iteration"],
                         d))
        return d

    def on_trial_complete(self, trial, result):
        self.inner.on_trial_complete(trial, result)

    def choose_exploit_source(self, trial, trials):
        return self.inner.choose_exploit_source(trial, trials)

    def mutate_config(self, config):
        return self.inner.mutate_config(config)


def test_asha_one_at_a_time_matches_jax(rt_shared):
    max_t = 8

    def run(pkg):
        name = LIBS[pkg] + ".tune"

        def trainable(config):
            import importlib

            tune = importlib.import_module(name)
            for i in range(max_t):
                tune.report({"loss": config["q"] + 10.0 / (i + 1)})

        t = _tune(pkg)
        sched = Recording(t.AsyncHyperBandScheduler(
            metric="loss", mode="min", grace_period=1, reduction_factor=2,
            max_t=max_t))
        grid = t.Tuner(trainable, param_space={
            "q": t.grid_search([1.0, 0.0, 5.0])},
            tune_config=t.TuneConfig(scheduler=sched,
                                     max_concurrent_trials=1),
            **_rt(pkg)).fit()
        return grid, sched.log

    (want, want_log), (got, got_log) = _both(run)
    # Every decision, in order: one trial at a time, they do not depend
    # on when the runner drained each report.
    assert got_log == want_log
    assert [t.status for t in got.trials] == [t.status for t in want.trials]
    assert [t.config for t in got.trials] == [t.config for t in want.trials]
    stopped_early = set()
    for tj, tt in zip(want.trials, got.trials):
        n = sum(1 for c, _, _ in want_log if c == tj.config)
        # Reports drained with the STOP stay in a trial's results (the JAX
        # package's rule), so the results agree up to the decision.
        assert tt.results[:n] == tj.results[:n]
        if n < max_t:
            stopped_early.add(tj.config["q"])
        else:
            assert tt.last_result == tj.last_result
    assert stopped_early == {5.0}
    assert (got.get_best_result("loss").config
            == want.get_best_result("loss").config == {"q": 0.0})


def test_pbt_exploit_matches_jax(rt_shared):
    steps = 3  # = the perturbation interval: the exploit is the last report

    def run(pkg):
        name = LIBS[pkg]

        def trainable(config):
            import importlib

            tune = importlib.import_module(name + ".tune")
            train = importlib.import_module(name + ".train")
            ckpt = train.session.get_checkpoint()
            level = ckpt.to_dict()["level"] if ckpt else 0.0
            for _ in range(steps):
                level += config["lr"]
                tune.report({"score": level}, checkpoint=train.Checkpoint
                            .from_dict({"level": level}))

        t = _tune(pkg)
        sched = Recording(t.PopulationBasedTraining(
            metric="score", mode="max", perturbation_interval=steps,
            hyperparam_mutations={"lr": [0.5, 1.0, 2.0]}, seed=1))
        grid = t.Tuner(trainable, param_space={
            "lr": t.grid_search([1.0, 0.1])},
            tune_config=t.TuneConfig(scheduler=sched,
                                     max_concurrent_trials=1),
            **_rt(pkg)).fit()
        return grid, sched.log

    (want, want_log), (got, got_log) = _both(run)
    assert got_log == want_log
    assert ("EXPLOIT" in [d for _, _, d in got_log])
    assert _grid(got) == _grid(want)
    exploited = got.trials[1]
    assert exploited.config != {"lr": 0.1}
    # It restarted from the source's checkpoint (level 3.0).
    assert exploited.results[steps]["score"] == pytest.approx(
        3.0 + exploited.config["lr"])
    assert all(t.status == "TERMINATED" for t in got.trials)


class Interrupt(Exception):
    pass


class InterruptOnce:
    """A scheduler that raises ``Interrupt`` once, at the ``at``-th result
    of the trial whose config is ``config``, as a sweep whose process is
    killed mid-trial would stop; the flags live on the class (one a package), so a
    restored copy of the pickled scheduler does not raise again."""

    armed = {}
    trial = {}

    def __init__(self, pkg, inner, config, at):
        self.pkg, self.inner, self.config, self.at = pkg, inner, config, at

    def on_result(self, trial, result):
        if (InterruptOnce.armed[self.pkg] and trial.config == self.config
                and result["training_iteration"] == self.at):
            InterruptOnce.armed[self.pkg] = False
            InterruptOnce.trial[self.pkg] = trial
            raise Interrupt()
        return self.inner.on_result(trial, result)

    def on_trial_complete(self, trial, result):
        self.inner.on_trial_complete(trial, result)

    def choose_exploit_source(self, trial, trials):
        return self.inner.choose_exploit_source(trial, trials)

    def mutate_config(self, config):
        return self.inner.mutate_config(config)


def test_restore_of_an_interrupted_sweep_matches_jax(rt_shared, tmp_path,
                                                     monkeypatch):
    steps = 4

    def run(pkg):
        name = LIBS[pkg]
        log = tmp_path / f"starts_{pkg}.log"

        def trainable(config):
            import importlib

            tune = importlib.import_module(name + ".tune")
            train = importlib.import_module(name + ".train")
            with open(log, "a") as f:
                f.write(f"{config['x']}\n")
            ckpt = train.session.get_checkpoint()
            start = ckpt.to_dict()["step"] if ckpt else 0
            for step in range(start + 1, steps + 1):
                tune.report({"score": config["x"] * step},
                            checkpoint=train.Checkpoint.from_dict(
                                {"step": step}))

        t = _tune(pkg)
        mod = importlib.import_module(LIBS[pkg] + ".tune.tuner")
        plain_launch = mod.TrialRunner._launch

        def launch_and_save(self, trial, checkpoint=None):
            # The state on disk then holds every trial launched before the
            # interruption, whatever the timing of the polls.
            plain_launch(self, trial, checkpoint)
            self.save_state()

        monkeypatch.setattr(mod.TrialRunner, "_launch", launch_and_save)
        tuner = t.Tuner(trainable, param_space={
            "x": t.grid_search([1, 2])},
            tune_config=t.TuneConfig(
                scheduler=InterruptOnce(pkg, t.FIFOScheduler(), {"x": 2},
                                        2),
                max_concurrent_trials=1),
            run_config=_train(pkg).RunConfig(
                name="exp", storage_path=str(tmp_path / pkg)),
            **_rt(pkg))
        InterruptOnce.armed[pkg] = True
        with pytest.raises(Interrupt):
            tuner.fit()
        ray_tpu.core.kill(InterruptOnce.trial[pkg].actor)  # orphaned
        path = str(tmp_path / pkg / "exp")
        assert t.Tuner.can_restore(path)
        before = mod.TrialRunner.load_state(path)
        assert [tr.status for tr in before["trials"]] == [
            "TERMINATED", "RUNNING"]
        grid = t.Tuner.restore(path, **_rt(pkg)).fit()
        return grid, sorted(log.read_text().split())

    (want, want_starts), (got, got_starts) = _both(run)
    assert _grid(got) == _grid(want)
    assert [len(t.results) for t in got.trials] == [steps] * 2
    assert [t.last_result["score"] for t in got.trials] == [4, 8]
    assert all(t.status == "TERMINATED" for t in got.trials)
    # The trial finished before the interruption was not trained again;
    # the interrupted one started twice.
    assert got_starts == want_starts == ["1", "2", "2"]


def test_sync_to_file_uri_and_restore_matches_jax(rt_shared, tmp_path):
    def run(pkg):
        name = LIBS[pkg] + ".tune"

        def trainable(config):
            import importlib

            tune = importlib.import_module(name)
            for i in range(3):
                tune.report({"score": config["x"] * (i + 1)})

        t = _tune(pkg)
        uri_root = f"file://{tmp_path}/bucket_{pkg}"
        tuner = t.Tuner(trainable, param_space={
            "x": t.grid_search([1, 2])},
            tune_config=t.TuneConfig(max_concurrent_trials=2),
            run_config=_train(pkg).RunConfig(name="sync-exp",
                                             storage_path=uri_root),
            **_rt(pkg))
        first = tuner.fit()
        exp_uri = uri_root + "/sync-exp"
        assert t.Tuner.can_restore(exp_uri)
        assert not t.Tuner.can_restore(uri_root + "/absent")
        staging = tuner._experiment_path()
        assert "rt_tune_staging" in staging and os.path.isdir(staging)
        shutil.rmtree(staging)
        again = t.Tuner.restore(exp_uri, **_rt(pkg)).fit()
        return first, again

    (want1, want2), (got1, got2) = _both(run)
    assert _grid(got1) == _grid(want1) == _grid(want2) == _grid(got2)
    assert got2.get_best_result("score", "max").last_result["score"] == 6
    from ray_tpu_torch.core.storage import client_for_uri

    assert client_for_uri(f"file://{tmp_path}/bucket_torch/sync-exp").exists(
        "experiment_state.pkl")


def test_fit_without_runtime_raises():
    from ray_tpu_torch import tune

    with pytest.raises(ValueError, match="runtime="):
        tune.Tuner(lambda c: None).fit()
    with pytest.raises(ValueError, match="runtime="):
        tune.run(lambda c: None, config={})


# -- on an in-process runtime ------------------------------------------------

class Runtime(chip_smoke.InlineRuntime):
    """``InlineRuntime`` that keeps every actor it builds and runs the
    trial actor as ``HookedTrialActor``."""

    def __init__(self, trial_cls=None):
        self.actors, self.trial_cls = [], trial_cls

    def remote(self, cls):
        from ray_tpu_torch.tune.tuner import _TrialActor

        rt = self
        if cls is _TrialActor and self.trial_cls is not None:
            cls = self.trial_cls

        class Keeping(chip_smoke.InlineRuntime.ActorClass):
            def remote(self, *args, **kwargs):
                actor = super().remote(*args, **kwargs)
                rt.actors.append(actor._obj)
                return actor

        return Keeping(self, cls)


def test_concurrent_trials_in_one_process_keep_their_reports():
    """Two trials run at once as threads of this process; each reports
    its own config. Every report reaches its own trial."""
    from ray_tpu_torch import tune

    both = threading.Barrier(2, timeout=30)

    def trainable(config):
        both.wait()  # both trials' sessions exist before either reports
        for i in range(5):
            tune.report({"x": config["x"], "i": i})

    grid = tune.Tuner(trainable, param_space={
        "x": tune.grid_search([1, 2])},
        tune_config=tune.TuneConfig(max_concurrent_trials=2),
        runtime=Runtime()).fit()
    for t in grid.trials:
        assert t.status == "TERMINATED", t.error
        assert [(r["x"], r["i"]) for r in t.results] == [
            (t.config["x"], i) for i in range(5)]


def test_sessions_within_threads_keep_their_reports():
    """More threads than cores, a short switch interval: each thread runs
    within its own session, nested over the process's, and every report
    lands in its own thread's session, the inner one while it runs."""
    from ray_tpu_torch.train import session

    outer = session.init_session(session.SessionContext(trial_id="proc"))
    n_threads, n_reports = 4 * (os.cpu_count() or 1), 50
    inner, mine = {}, {}

    def run(i):
        mine[i] = session._Session(session.SessionContext(trial_id=f"t{i}"))
        inner[i] = session._Session(session.SessionContext(trial_id=f"n{i}"))
        with session.within(mine[i]):
            for k in range(n_reports):
                session.report({"i": i, "k": k})
                if k == n_reports // 2:
                    with session.within(inner[i]):
                        session.report({"inner": i})
            assert session.get_trial_id() == f"t{i}"

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
        session.shutdown_session()
    assert not any(th.is_alive() for th in threads)
    for i in range(n_threads):
        assert [m for m, _ in mine[i].drain()] == [
            {"i": i, "k": k} for k in range(n_reports)]
        assert [m for m, _ in inner[i].drain()] == [{"inner": i}]
    assert outer.drain() == []


def test_stopped_trial_in_one_process_runs_no_further_step():
    """A trial stopped by the stop criteria ends at its next report: the
    runner asks it to stop, then waits for its thread, then kills the
    actor. The step after the stop request runs up to its report; none
    after it."""
    from ray_tpu_torch import tune
    from ray_tpu_torch.tune.tuner import _TrialActor

    asked = threading.Event()

    class HookedTrialActor(_TrialActor):
        def request_stop(self):
            out = super().request_stop()
            asked.set()
            return out

    ran = []

    def trainable(config):
        for i in range(20):
            ran.append(i)
            tune.report({"i": i})
            if i == 1:  # wait, so the stop meets this trial mid-run
                asked.wait(10)

    rt = Runtime(HookedTrialActor)
    grid = tune.Tuner(trainable, param_space={},
                      run_config=_train("torch").RunConfig(
                          stop={"training_iteration": 2}),
                      runtime=rt).fit()
    (trial,) = grid.trials
    (actor,) = rt.actors
    assert not actor._thread.is_alive()  # joined before the kill
    assert trial.status == "STOPPED"
    assert [r["i"] for r in trial.results] == [0, 1]
    assert ran == [0, 1, 2]


def test_tuner_of_torch_trainer_reports_each_fit_once(tmp_path):
    """``Tuner(TorchTrainer(...))`` on in-process runtimes: each trial's
    train worker runs in the trial's thread within its own session; the
    trial gets its fit's final metrics once, equal to a direct fit."""
    from ray_tpu_torch import tune
    from ray_tpu_torch.train import RunConfig, TorchTrainer, session

    both = threading.Barrier(2, timeout=30)

    def train_fn(config):
        if config.get("together"):
            both.wait()  # both fits' worker sessions exist
        for i in range(3):
            session.report({"x": config["x"], "i": i,
                            "rank": session.get_world_rank()})

    def trainer(**config):
        return TorchTrainer(train_fn, train_loop_config=config,
                            run_config=RunConfig(storage_path=str(tmp_path)),
                            runtime=Runtime())

    grid = tune.Tuner(trainer(together=True), param_space={
        "x": tune.grid_search([1, 2])},
        tune_config=tune.TuneConfig(max_concurrent_trials=2),
        runtime=Runtime()).fit()
    for t in grid.trials:
        direct = trainer(x=t.config["x"]).fit()
        assert t.status == "TERMINATED", t.error
        assert len(t.results) == 1
        got = dict(t.last_result)
        assert got.pop("training_iteration") == 1
        assert got == direct.metrics == {"x": t.config["x"], "i": 2,
                                         "rank": 0}


def test_algorithm_as_trainable_reports_through_port_tune():
    """``Algorithm.as_trainable`` without ``report`` reports each
    iteration through the port's ``tune.report``: a small PPO config
    through the port's Tuner on the CPU."""
    from ray_tpu_torch import tune
    from ray_tpu_torch.rllib import PPO, PPOConfig

    base = (PPOConfig().environment("FastCartPole")
            .rollouts(num_envs_per_worker=2, rollout_fragment_length=16)
            .training(sgd_minibatch_size=16, num_sgd_iter=1))
    trainable = PPO.as_trainable(base, stop_iters=2, device="cpu")
    grid = tune.Tuner(trainable, param_space={
        "lr": tune.grid_search([1e-3, 3e-4])},
        tune_config=tune.TuneConfig(max_concurrent_trials=1),
        runtime=Runtime()).fit()
    for t in grid.trials:
        assert t.status == "TERMINATED", t.error
        assert [r["training_iteration"] for r in t.results] == [1, 2]
        assert t.last_result["timesteps_total"] == 2 * 2 * 16
        assert all(np.isfinite(r["total_loss"]) for r in t.results)


# -- a tiny GPT-2 in each trial of both Tuners --------------------------------

TINY = dict(vocab_size=128, max_seq=64, num_layers=2, num_heads=2,
            d_model=64)


def test_tiny_gpt2_trials_match_jax(rt_shared):
    def jax_trainable(config):
        import jax
        import jax.numpy as jnp

        from ray_tpu import tune
        from ray_tpu.models import gpt2
        from ray_tpu.parallel.mesh import MeshSpec
        from ray_tpu.train.optim import adamw_lowmem
        from ray_tpu.train.step import build_sharded_train

        cfg = gpt2.GPT2Config(**config["tiny"], dtype=jnp.float32,
                              attention_impl="flash")
        init, step, _ = build_sharded_train(
            lambda k: gpt2.init_params(k, cfg),
            lambda p, b: gpt2.loss_fn(p, b, cfg),
            MeshSpec(dp=1).build(jax.devices()[:1]),
            optimizer=adamw_lowmem(config["lr"], eps=1e-5))
        params, opt, n = init(jax.random.PRNGKey(0))
        for tokens in config["batches"]:
            params, opt, n, m = step(params, opt, n,
                                     {"tokens": jnp.asarray(tokens)})
            tune.report({"loss": float(m["loss"])})

    def torch_trainable(config):
        import torch

        from ray_tpu_torch import device, tune
        from ray_tpu_torch.models import gpt2
        from ray_tpu_torch.models.convert import gpt2_params_from_numpy
        from ray_tpu_torch.train.optim import adamw_lowmem
        from ray_tpu_torch.train.step import build_train

        cfg = gpt2.GPT2Config(**config["tiny"], dtype=torch.float32,
                              attention_impl="flash")

        def init_fn(_generator):
            m = gpt2.GPT2(cfg)
            m.load_state_dict(gpt2_params_from_numpy(config["init"], cfg))
            return m

        with device.full_fp32():
            init, step = build_train(init_fn, lambda m, b: m.loss_fn(b),
                                     optimizer=adamw_lowmem(config["lr"],
                                                            eps=1e-5),
                                     device="cpu")
            model, opt, n = init(0)
            for tokens in config["batches"]:
                model, opt, n, m = step(model, opt, n,
                                        {"tokens": torch.from_numpy(tokens)})
                tune.report({"loss": float(m["loss"])})

    jcfg = jgpt2.GPT2Config(**TINY, dtype=jnp.float32)
    init = jax.tree.map(np.asarray,
                        jgpt2.init_params(jax.random.PRNGKey(0), jcfg)[0])
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 128, (2, 33)).astype(np.int32)
               for _ in range(3)]

    def run(pkg, trainable, **extra):
        t = _tune(pkg)
        return t.Tuner(trainable, param_space={
            "lr": t.grid_search([1e-3, 3e-3]), "tiny": TINY,
            "batches": batches, **extra},
            tune_config=t.TuneConfig(max_concurrent_trials=2),
            **_rt(pkg)).fit()

    want, got = _both(lambda pkg: run(pkg, jax_trainable) if pkg == "jax"
                      else run(pkg, torch_trainable, init=init))
    for tj, tt in zip(want.trials, got.trials):
        assert tj.status == tt.status == "TERMINATED", (tj.error, tt.error)
        assert tj.config["lr"] == tt.config["lr"]
        jl = [r["loss"] for r in tj.results]
        tl = [r["loss"] for r in tt.results]
        assert len(tl) == len(jl) == 3
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert (got.get_best_result("loss").config["lr"]
            == want.get_best_result("loss").config["lr"])
