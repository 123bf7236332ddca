"""A copy of the JAX package's ``tune/schedulers.py`` (numpy only), kept
here because the port imports nothing of that package: the same stream
of results gives the same decisions and mutated configs. Its docstring:

Trial schedulers: FIFO, ASHA, PBT, PB2, median stopping.

Reference analog: ``python/ray/tune/schedulers/`` —
``async_hyperband.py`` (ASHA), ``pbt.py:130`` (PopulationBasedTraining with
``_exploit`` :607), ``pb2.py:209`` (PB2), ``median_stopping_rule.py``.
Decision protocol mirrors the reference: schedulers see each intermediate
result and answer CONTINUE / STOP / (PBT) EXPLOIT.
"""

from __future__ import annotations

import math
import random
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np


class TrialDecision:
    CONTINUE = "CONTINUE"
    STOP = "STOP"
    EXPLOIT = "EXPLOIT"  # PBT: clone weights+config from a better trial


class TrialScheduler:
    def on_result(self, trial, result: Dict) -> str:
        return TrialDecision.CONTINUE

    def on_trial_complete(self, trial, result: Optional[Dict]) -> None:
        pass

    def choose_exploit_source(self, trial, trials) -> Optional[Any]:
        return None

    def mutate_config(self, config: Dict) -> Dict:
        return config


class FIFOScheduler(TrialScheduler):
    """Run every trial to completion (reference: fifo.py)."""


class AsyncHyperBandScheduler(TrialScheduler):
    """ASHA: asynchronous successive halving.

    Reference: ``schedulers/async_hyperband.py`` — rungs at
    grace_period * reduction_factor^k; a trial reaching a rung is stopped
    unless its metric is in the top 1/reduction_factor of results recorded
    at that rung.
    """

    def __init__(self, metric: str = "loss", mode: str = "min",
                 time_attr: str = "training_iteration",
                 grace_period: int = 1, reduction_factor: float = 3,
                 max_t: int = 100):
        assert mode in ("min", "max")
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.grace = grace_period
        self.rf = reduction_factor
        self.max_t = max_t
        self.rungs: List[float] = []
        t = grace_period
        while t < max_t:
            self.rungs.append(t)
            t = int(math.ceil(t * reduction_factor))
        # rung milestone -> recorded metric values
        self._recorded: Dict[float, List[float]] = defaultdict(list)

    def on_result(self, trial, result: Dict) -> str:
        t = result.get(self.time_attr)
        value = result.get(self.metric)
        if t is None or value is None:
            return TrialDecision.CONTINUE
        if t >= self.max_t:
            return TrialDecision.STOP
        decision = TrialDecision.CONTINUE
        for rung in self.rungs:
            if t == rung or (t > rung and not trial.rungs_passed.get(rung)):
                trial.rungs_passed[rung] = True
                recorded = self._recorded[rung]
                recorded.append(value)
                if len(recorded) >= self.rf:
                    cutoff = self._cutoff(recorded)
                    bad = (value > cutoff if self.mode == "min"
                           else value < cutoff)
                    if bad:
                        decision = TrialDecision.STOP
        return decision

    def _cutoff(self, recorded: List[float]) -> float:
        k = max(1, int(len(recorded) / self.rf))
        ordered = sorted(recorded, reverse=(self.mode == "max"))
        return ordered[k - 1]


class MedianStoppingRule(TrialScheduler):
    """Stop trials whose running mean is worse than the median of others.

    Reference: ``schedulers/median_stopping_rule.py``.
    """

    def __init__(self, metric: str = "loss", mode: str = "min",
                 time_attr: str = "training_iteration",
                 grace_period: int = 1, min_samples_required: int = 3):
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.grace = grace_period
        self.min_samples = min_samples_required
        self._means: Dict[str, float] = {}
        self._counts: Dict[str, int] = defaultdict(int)

    def on_result(self, trial, result: Dict) -> str:
        value = result.get(self.metric)
        t = result.get(self.time_attr, 0)
        if value is None:
            return TrialDecision.CONTINUE
        n = self._counts[trial.trial_id] + 1
        self._counts[trial.trial_id] = n
        prev = self._means.get(trial.trial_id, 0.0)
        self._means[trial.trial_id] = prev + (value - prev) / n
        if t < self.grace or len(self._means) < self.min_samples:
            return TrialDecision.CONTINUE
        others = [m for tid, m in self._means.items()
                  if tid != trial.trial_id]
        if not others:
            return TrialDecision.CONTINUE
        med = sorted(others)[len(others) // 2]
        mine = self._means[trial.trial_id]
        worse = mine > med if self.mode == "min" else mine < med
        return TrialDecision.STOP if worse else TrialDecision.CONTINUE


class PopulationBasedTraining(TrialScheduler):
    """PBT: periodically exploit better trials + explore their config.

    Reference: ``schedulers/pbt.py:130`` — every ``perturbation_interval``
    a bottom-quantile trial copies a top-quantile trial's checkpoint and
    perturbs hyperparameters (x1.2 / x0.8 or resample).
    """

    def __init__(self, metric: str = "loss", mode: str = "min",
                 time_attr: str = "training_iteration",
                 perturbation_interval: int = 5,
                 hyperparam_mutations: Optional[Dict] = None,
                 quantile_fraction: float = 0.25,
                 resample_probability: float = 0.25,
                 seed: Optional[int] = None):
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.resample_prob = resample_probability
        self.rng = random.Random(seed)
        self._last_perturb: Dict[str, int] = defaultdict(int)
        self._scores: Dict[str, float] = {}

    def on_result(self, trial, result: Dict) -> str:
        value = result.get(self.metric)
        t = result.get(self.time_attr, 0)
        if value is None:
            return TrialDecision.CONTINUE
        self._scores[trial.trial_id] = value
        if t - self._last_perturb[trial.trial_id] < self.interval:
            return TrialDecision.CONTINUE
        self._last_perturb[trial.trial_id] = t
        if len(self._scores) < 2:
            return TrialDecision.CONTINUE
        ordered = sorted(
            self._scores.items(), key=lambda kv: kv[1],
            reverse=(self.mode == "max"),
        )
        n = len(ordered)
        k = max(1, int(n * self.quantile))
        bottom_ids = {tid for tid, _ in ordered[-k:]}
        if trial.trial_id in bottom_ids and n > k:
            return TrialDecision.EXPLOIT
        return TrialDecision.CONTINUE

    def choose_exploit_source(self, trial, trials):
        ordered = sorted(
            (t for t in trials if t.trial_id in self._scores
             and t.trial_id != trial.trial_id),
            key=lambda t: self._scores[t.trial_id],
            reverse=(self.mode == "max"),
        )
        if not ordered:
            return None
        k = max(1, int(len(ordered) * self.quantile))
        return self.rng.choice(ordered[:k])

    def mutate_config(self, config: Dict) -> Dict:
        """Reference: pbt.py _explore — perturb or resample each mutable."""
        out = dict(config)
        for key, spec in self.mutations.items():
            if key not in out:
                continue
            if self.rng.random() < self.resample_prob or not isinstance(
                out[key], (int, float)
            ):
                if isinstance(spec, list):
                    out[key] = self.rng.choice(spec)
                elif callable(spec):
                    out[key] = spec()
                elif hasattr(spec, "sample"):
                    out[key] = spec.sample(self.rng)
            else:
                factor = 1.2 if self.rng.random() > 0.5 else 0.8
                out[key] = out[key] * factor
                if isinstance(config[key], int):
                    out[key] = max(1, int(out[key]))
        return out


class PB2(PopulationBasedTraining):
    """Population Based Bandits: exploit like PBT, but *explore* by
    maximizing a GP-UCB acquisition instead of random x0.8/x1.2 perturbs.

    Reference analog: ``tune/schedulers/pb2.py`` (``PB2`` :209,
    ``select_config`` :38, ``explore`` :138; Parker-Holder et al. 2020).
    The reference fits a time-varying squared-exp GP with GPy over rows
    ``[t, reward, *hyperparams] -> reward change`` and picks the config
    maximizing UCB. This implementation is self-contained numpy: same
    data model, an RBF kernel with a time-decay (forgetting) factor
    standing in for the TV kernel, and a random-candidate UCB search
    within ``hyperparam_bounds``.

    Bounded (continuous) keys get GP selection; keys listed in
    ``hyperparam_mutations`` but not bounded fall back to PBT perturbs.
    """

    def __init__(self, metric: str = "loss", mode: str = "min",
                 time_attr: str = "training_iteration",
                 perturbation_interval: int = 5,
                 hyperparam_bounds: Optional[Dict[str, Tuple[float, float]]]
                 = None,
                 log_scale_keys: Tuple[str, ...] = (),
                 hyperparam_mutations: Optional[Dict] = None,
                 quantile_fraction: float = 0.25,
                 ucb_coeff: float = 1.0,
                 forgetting: float = 0.9,
                 lengthscale: float = 0.3,
                 max_gp_points: int = 200,
                 n_candidates: int = 128,
                 seed: Optional[int] = None):
        super().__init__(metric=metric, mode=mode, time_attr=time_attr,
                         perturbation_interval=perturbation_interval,
                         hyperparam_mutations=hyperparam_mutations,
                         quantile_fraction=quantile_fraction, seed=seed)
        if not hyperparam_bounds:
            raise ValueError("PB2 requires hyperparam_bounds "
                             "({key: (low, high)})")
        for k, (lo, hi) in hyperparam_bounds.items():
            if not hi > lo:
                raise ValueError(f"bad bounds for {k!r}: ({lo}, {hi})")
            if k in log_scale_keys and lo <= 0:
                raise ValueError(
                    f"log-scale key {k!r} needs a positive lower bound, "
                    f"got {lo}")
        self.bounds = dict(hyperparam_bounds)
        self.log_keys = set(log_scale_keys)
        self.ucb_coeff = ucb_coeff
        self.forgetting = forgetting
        self.lengthscale = lengthscale
        self.max_gp_points = max_gp_points
        self.n_candidates = n_candidates
        self._np_rng = np.random.default_rng(seed)
        # Per-trial last (t, score) to turn scores into per-interval
        # reward *changes* (the GP's target, pb2.py:349 _save_trial_state).
        self._prev: Dict[str, Tuple[float, float]] = {}
        # Rows: (t, unit config vector, dy/dt)
        self._data: List[Tuple[float, np.ndarray, float]] = []

    # -- unit-cube transform ------------------------------------------------
    def _to_unit(self, key: str, value: float) -> float:
        lo, hi = self.bounds[key]
        if key in self.log_keys:
            lo, hi, value = math.log(lo), math.log(hi), math.log(
                max(value, 1e-300))
        return float(np.clip((value - lo) / (hi - lo), 0.0, 1.0))

    def _from_unit(self, key: str, unit: float) -> float:
        lo, hi = self.bounds[key]
        if key in self.log_keys:
            return float(math.exp(
                math.log(lo) + unit * (math.log(hi) - math.log(lo))))
        return float(lo + unit * (hi - lo))

    def _vec(self, config: Dict) -> np.ndarray:
        return np.array([self._to_unit(k, float(config[k]))
                         for k in sorted(self.bounds)], np.float64)

    # -- data collection ----------------------------------------------------
    def on_result(self, trial, result: Dict) -> str:
        value = result.get(self.metric)
        t = result.get(self.time_attr, 0)
        if value is not None:
            prev = self._prev.get(trial.trial_id)
            if prev is not None and t > prev[0] and all(
                    k in trial.config for k in self.bounds):
                dy = (value - prev[1]) / (t - prev[0])
                if self.mode == "min":
                    dy = -dy  # GP always maximizes improvement
                self._data.append((float(t), self._vec(trial.config), dy))
                if len(self._data) > self.max_gp_points:
                    self._data = self._data[-self.max_gp_points:]
            self._prev[trial.trial_id] = (float(t), float(value))
        return super().on_result(trial, result)

    def choose_exploit_source(self, trial, trials):
        # The exploited trial restarts from the source's checkpoint: its
        # next report's score jump reflects the CLONE, not its config.
        # Drop its last (t, score) so that jump never enters the GP data
        # (reference pb2.py resets trial state on exploit).
        self._prev.pop(trial.trial_id, None)
        return super().choose_exploit_source(trial, trials)

    # -- GP posterior -------------------------------------------------------
    def _kernel(self, X1: np.ndarray, T1: np.ndarray,
                X2: np.ndarray, T2: np.ndarray,
                t_scale: float) -> np.ndarray:
        sq = ((X1[:, None, :] - X2[None, :, :]) ** 2).sum(-1)
        k = np.exp(-0.5 * sq / self.lengthscale ** 2)
        # Time-varying decay: old observations lose weight — the PB2
        # TV-SquaredExp kernel's (1-eps)^(|t1-t2|/2) term.
        dt = np.abs(T1[:, None] - T2[None, :]) / max(t_scale, 1e-9)
        return k * (self.forgetting ** dt)

    def mutate_config(self, config: Dict) -> Dict:
        # Non-bounded mutation keys keep the PBT behavior.
        out = super().mutate_config(config) if self.mutations else dict(
            config)
        if len(self._data) < 4:
            # Cold start: uniform-random in bounds (reference falls back
            # to random exploration until the GP has data).
            for k in self.bounds:
                out[k] = self._from_unit(k, float(self._np_rng.random()))
            return out
        T = np.array([d[0] for d in self._data])
        X = np.stack([d[1] for d in self._data])
        y = np.array([d[2] for d in self._data])
        y_mu, y_sd = float(y.mean()), float(y.std()) + 1e-9
        y = (y - y_mu) / y_sd
        t_scale = float(T.max() - T.min()) or 1.0
        K = self._kernel(X, T, X, T, t_scale)
        K[np.diag_indices_from(K)] += 1e-3
        try:
            L = np.linalg.cholesky(K)
        except np.linalg.LinAlgError:
            K[np.diag_indices_from(K)] += 1e-2
            L = np.linalg.cholesky(K)
        alpha = np.linalg.solve(L.T, np.linalg.solve(L, y))
        # Candidates: random cube points + jitters around the source
        # config (exploit locality, pb2 explore :138).
        d = len(self.bounds)
        cand = self._np_rng.random((self.n_candidates, d))
        base = self._vec(config)[None, :]
        local = np.clip(
            base + self._np_rng.normal(0.0, 0.1,
                                       (self.n_candidates // 4, d)),
            0.0, 1.0)
        cand = np.vstack([cand, local, base])
        t_now = np.full(len(cand), float(T.max()))
        Ks = self._kernel(cand, t_now, X, T, t_scale)  # [c, n]
        mu = Ks @ alpha
        v = np.linalg.solve(L, Ks.T)  # [n, c]
        var = np.clip(1.0 - (v ** 2).sum(0), 1e-9, None)
        ucb = mu + self.ucb_coeff * np.sqrt(var)
        best = cand[int(np.argmax(ucb))]
        for i, k in enumerate(sorted(self.bounds)):
            val = self._from_unit(k, float(best[i]))
            if isinstance(config.get(k), int):
                val = max(1, int(round(val)))
            out[k] = val
        return out
