"""The port's copies of the JAX package's Tune searchers and schedulers
(``ray_tpu_torch.tune.search``, ``.schedulers``) against the originals:
for the same seeds and the same streams of results, the same
suggestions, decisions, exploit sources and mutated configs, exactly.
And why the copies exist: ``ray_tpu.tune`` reaches JAX through
``train`` and ``parallel``, the port's ``tune`` does not.
"""

import math
import os
import pathlib
import subprocess
import sys
from dataclasses import dataclass, field
from typing import Dict

import pytest

import ray_tpu.tune as jtune
import ray_tpu_torch.tune as ttune

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGES = (jtune, ttune)


@dataclass
class FakeTrial:
    trial_id: str
    config: Dict
    rungs_passed: Dict = field(default_factory=dict)


def space(t, grid=True):
    out = {"lr": t.loguniform(1e-5, 1e-1), "wd": t.uniform(0.0, 0.3),
           "layers": t.randint(1, 9), "act": t.choice(["relu", "gelu",
                                                        "tanh"]),
           "fixed": "x"}
    if grid:
        out["bs"] = t.grid_search([16, 32, 64])
    return out


def objective(cfg):
    """A deterministic score from a config (lower is better)."""
    return ((math.log10(cfg["lr"]) + 3.0) ** 2 + (cfg["wd"] - 0.1) ** 2
            + 0.05 * cfg["layers"] + {"relu": 0.0, "gelu": 0.1,
                                      "tanh": 0.3}[cfg["act"]])


def drain(searcher, n, feedback=True):
    """``n`` suggestions, each completed with its objective right away;
    None ends the stream."""
    out = []
    for i in range(n):
        cfg = searcher.suggest(f"t{i}")
        out.append(cfg)
        if cfg is None:
            break
        if feedback:
            score = objective(cfg)
            searcher.on_trial_complete(f"t{i}", {
                "loss": score, "training_iteration": 1 + i % 3})
    return out


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("cls", ["BasicVariantGenerator", "RandomSearch"])
def test_variant_generators_suggest_the_same(cls, seed):
    runs = [drain(getattr(t, cls)(space(t), num_samples=3, seed=seed), 12)
            for t in PACKAGES]
    assert runs[0] == runs[1]
    assert len(runs[0]) == 10 and runs[0][-1] is None  # 9 variants, then None


@pytest.mark.parametrize("seed", [0, 3])
def test_tpe_suggests_the_same(seed):
    runs = [drain(t.TPESearcher(space(t, grid=False), "loss", mode="min",
                                n_startup_trials=5, n_candidates=16,
                                max_trials=20, seed=seed), 22)
            for t in PACKAGES]
    assert runs[0] == runs[1]
    assert runs[0][-1] is None and len(runs[0]) == 21


def test_tpe_refuses_grid_search_in_both():
    for t in PACKAGES:
        with pytest.raises(ValueError, match="grid_search"):
            t.TPESearcher(space(t), "loss")


@pytest.mark.parametrize("seed", [0, 5])
def test_bohb_suggests_the_same(seed):
    pairs = [t.create_bohb(space(t, grid=False), "loss", mode="min",
                           max_t=9, grace_period=1, reduction_factor=3,
                           max_trials=18, seed=seed) for t in PACKAGES]
    runs = [drain(searcher, 20) for _, searcher in pairs]
    assert runs[0] == runs[1]
    assert [s.rungs for s, _ in pairs][0] == [s.rungs for s, _ in pairs][1]
    assert ([s._history for _, s in pairs][0]
            == [s._history for _, s in pairs][1])


def test_concurrency_limiter_gates_the_same():
    outs = []
    for t in PACKAGES:
        lim = t.ConcurrencyLimiter(
            t.RandomSearch(space(t, grid=False), num_samples=6, seed=1),
            max_concurrent=2)
        seq = [lim.suggest("a"), lim.suggest("b"), lim.suggest("c")]
        lim.on_trial_complete("a", {"loss": 1.0})
        seq += [lim.suggest("d"), lim.suggest("e")]
        lim.on_trial_complete("b", None, error=True)
        seq += [lim.suggest("f")]
        outs.append(seq)
    assert outs[0] == outs[1]
    assert outs[0][2] is None and outs[0][4] is None  # at the cap


def result_stream(n_trials, steps, seed):
    """(trial index, step, score) in a fixed interleaving: trials start
    one after another and report with a trend and numpy noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    quality = rng.uniform(0.0, 2.0, n_trials)
    out = []
    for step in range(1, steps + 1):
        for i in range(n_trials):
            score = float(quality[i] + 5.0 / step
                          + 0.1 * rng.standard_normal())
            out.append((i, step, score))
    return out


def decisions(scheduler, stream, configs, metric="loss"):
    trials = [FakeTrial(f"t{i}", dict(c)) for i, c in enumerate(configs)]
    out = []
    for i, step, score in stream:
        out.append(scheduler.on_result(trials[i], {
            metric: score, "training_iteration": step}))
    return out, trials


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", ["min", "max"])
def test_asha_decides_the_same(mode, seed):
    stream = result_stream(8, 12, seed)
    outs = [decisions(t.AsyncHyperBandScheduler(
        metric="loss", mode=mode, grace_period=1, reduction_factor=2,
        max_t=10), stream, [{}] * 8) for t in PACKAGES]
    assert outs[0][0] == outs[1][0]
    assert ([t.rungs_passed for t in outs[0][1]]
            == [t.rungs_passed for t in outs[1][1]])
    assert "STOP" in outs[0][0]


@pytest.mark.parametrize("seed", [0, 4])
def test_median_stopping_decides_the_same(seed):
    stream = result_stream(6, 8, seed)
    outs = [decisions(t.MedianStoppingRule(
        metric="loss", mode="min", grace_period=2, min_samples_required=3),
        stream, [{}] * 6)[0] for t in PACKAGES]
    assert outs[0] == outs[1]
    assert "STOP" in outs[0]


def pbt_run(t, stream, configs, pb2=False, seed=3):
    if pb2:
        sched = t.PB2(metric="loss", mode="min", perturbation_interval=2,
                      hyperparam_bounds={"lr": (1e-4, 1e-1),
                                         "wd": (0.0, 0.3)},
                      log_scale_keys=("lr",),
                      hyperparam_mutations={"act": ["relu", "gelu"]},
                      n_candidates=32, seed=seed)
    else:
        sched = t.PopulationBasedTraining(
            metric="loss", mode="min", perturbation_interval=2,
            hyperparam_mutations={"lr": [1e-3, 1e-2, 1e-1],
                                  "wd": t.uniform(0.0, 0.3),
                                  "act": lambda: "tanh"},
            quantile_fraction=0.25, resample_probability=0.25, seed=seed)
    trials = [FakeTrial(f"t{i}", dict(c)) for i, c in enumerate(configs)]
    out = []
    for i, step, score in stream:
        d = sched.on_result(trials[i], {"loss": score,
                                        "training_iteration": step})
        out.append(d)
        if d == "EXPLOIT":
            src = sched.choose_exploit_source(trials[i], trials)
            new = sched.mutate_config(dict(src.config))
            out.append((src.trial_id, new))
            trials[i].config = new
    return out


@pytest.mark.parametrize("pb2", [False, True], ids=["pbt", "pb2"])
@pytest.mark.parametrize("seed", [0, 1])
def test_pbt_and_pb2_exploit_and_mutate_the_same(pb2, seed):
    import numpy as np

    rng = np.random.default_rng(10 + seed)
    configs = [{"lr": float(10 ** rng.uniform(-4, -1)),
                "wd": float(rng.uniform(0, 0.3)), "layers": 4,
                "act": "relu"} for _ in range(6)]
    stream = result_stream(6, 10, seed)
    outs = [pbt_run(t, stream, configs, pb2=pb2, seed=seed)
            for t in PACKAGES]
    assert outs[0] == outs[1]
    exploits = [o for o in outs[0] if isinstance(o, tuple)]
    assert len(exploits) >= 2  # the GP's branch (>= 4 rows) runs for PB2


def test_domains_sample_the_same():
    import random

    for cls_args in (("uniform", (0.5, 2.0)), ("loguniform", (1e-4, 1.0)),
                     ("randint", (3, 17)), ("choice", (["a", "b", "c"],))):
        name, args = cls_args
        draws = []
        for t in PACKAGES:
            dom = getattr(t, name)(*args)
            rng = random.Random(11)
            draws.append([dom.sample(rng) for _ in range(20)])
        assert draws[0] == draws[1], name


def _import_with_jax_blocked(module):
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'ml_dtypes'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"import {module}\n"
        "print('ok')\n")
    env = dict(os.environ)
    env.pop("PYTHONSTARTUP", None)
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_tune_imports_without_jax():
    r = _import_with_jax_blocked("ray_tpu_torch.tune")
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]


def test_jax_tune_needs_jax():
    """Why the port keeps copies: the JAX package's ``tune`` imports
    ``train`` (for ``Checkpoint``), whose ``config`` imports
    ``parallel``, whose ``collective`` imports JAX."""
    r = _import_with_jax_blocked("ray_tpu.tune")
    assert r.returncode != 0 and "blocked: jax" in r.stderr, r.stderr[-2000:]
