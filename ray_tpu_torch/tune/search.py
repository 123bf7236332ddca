"""A copy of the JAX package's ``tune/search.py`` (standard library
only), kept here because the port imports nothing of that package: the
same seed gives the same suggestions. Its docstring:

Search spaces and search algorithms.

Reference analog: ``python/ray/tune/search/`` — the sampling primitives
(``tune.uniform/loguniform/choice/grid_search``) and
``basic_variant.py``/``variant_generator.py`` (grid expansion + random
sampling). External searcher integrations (hyperopt/optuna/...) plug in via
the same ``Searcher`` interface.
"""

from __future__ import annotations

import itertools
import math
import random
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional


# -- sampling primitives (tune.* search space API) ---------------------------

class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


@dataclass
class Uniform(Domain):
    low: float
    high: float

    def sample(self, rng):
        return rng.uniform(self.low, self.high)


@dataclass
class LogUniform(Domain):
    low: float
    high: float

    def sample(self, rng):
        return math.exp(rng.uniform(math.log(self.low), math.log(self.high)))


@dataclass
class RandInt(Domain):
    low: int
    high: int

    def sample(self, rng):
        return rng.randrange(self.low, self.high)


@dataclass
class Choice(Domain):
    categories: List[Any]

    def sample(self, rng):
        return rng.choice(self.categories)


@dataclass
class GridSearch:
    values: List[Any]


def uniform(low: float, high: float) -> Uniform:
    return Uniform(low, high)


def loguniform(low: float, high: float) -> LogUniform:
    return LogUniform(low, high)


def randint(low: int, high: int) -> RandInt:
    return RandInt(low, high)


def choice(categories: List[Any]) -> Choice:
    return Choice(list(categories))


def grid_search(values: List[Any]) -> GridSearch:
    return GridSearch(list(values))


# -- searchers ---------------------------------------------------------------

class Searcher:
    """Suggest configs; receive completed-trial feedback.

    Reference: ``tune/search/searcher.py`` Searcher interface.
    """

    def suggest(self, trial_id: str) -> Optional[Dict]:
        raise NotImplementedError

    def on_trial_complete(self, trial_id: str, result: Optional[Dict],
                          error: bool = False) -> None:
        pass


class BasicVariantGenerator(Searcher):
    """Grid expansion x num_samples random sampling.

    Reference: ``tune/search/basic_variant.py`` — every grid_search key is
    fully expanded; Domain leaves are sampled per variant; the whole space
    repeats ``num_samples`` times.
    """

    def __init__(self, space: Dict, num_samples: int = 1,
                 seed: Optional[int] = None):
        self.space = space
        self.num_samples = num_samples
        self.rng = random.Random(seed)
        self._variants = self._expand()
        self._index = 0

    def _expand(self) -> List[Dict]:
        grid_keys = [k for k, v in self.space.items()
                     if isinstance(v, GridSearch)]
        grids = [self.space[k].values for k in grid_keys]
        variants = []
        for _ in range(self.num_samples):
            for combo in itertools.product(*grids) if grids else [()]:
                cfg = {}
                for k, v in self.space.items():
                    if isinstance(v, GridSearch):
                        cfg[k] = combo[grid_keys.index(k)]
                    elif isinstance(v, Domain):
                        cfg[k] = v.sample(self.rng)
                    elif callable(v) and not isinstance(v, type):
                        cfg[k] = v()  # tune.sample_from style
                    else:
                        cfg[k] = v
                variants.append(cfg)
        return variants

    def total(self) -> int:
        return len(self._variants)

    def suggest(self, trial_id: str) -> Optional[Dict]:
        if self._index >= len(self._variants):
            return None
        cfg = self._variants[self._index]
        self._index += 1
        return cfg


class TPESearcher(Searcher):
    """Tree-structured Parzen Estimator (model-based search).

    Reference analog: ``tune/search/hyperopt`` (HyperOptSearch wraps
    hyperopt's TPE; Bergstra et al. 2011). Implementation here is
    self-contained: after ``n_startup_trials`` random configs, completed
    trials split into good/bad quantiles; candidates are drawn from a
    kernel density over the good set and ranked by the density ratio
    l(x)/g(x), independently per dimension.
    """

    def __init__(self, space: Dict, metric: str, mode: str = "min",
                 n_startup_trials: int = 10, n_candidates: int = 24,
                 gamma: float = 0.25, max_trials: Optional[int] = 64,
                 seed: Optional[int] = None):
        assert mode in ("min", "max")
        # Unlike the finite variant generators, a model-based searcher can
        # suggest forever — max_trials bounds the sweep (None = unbounded;
        # the caller then owns termination).
        for k, v in space.items():
            if isinstance(v, GridSearch):
                raise ValueError(
                    f"TPESearcher does not expand grid_search ({k!r}); "
                    "use Choice or BasicVariantGenerator")
        self.space = space
        self.metric = metric
        self.mode = mode
        self.n_startup = n_startup_trials
        self.n_candidates = n_candidates
        self.gamma = gamma
        self.max_trials = max_trials
        self._suggested = 0
        self.rng = random.Random(seed)
        self._live: Dict[str, Dict] = {}
        self._history: List[tuple] = []  # (config, score)

    # -- numeric transform per domain ------------------------------------
    def _to_unit(self, key, value) -> Optional[float]:
        dom = self.space[key]
        if isinstance(dom, Uniform):
            return (value - dom.low) / max(dom.high - dom.low, 1e-12)
        if isinstance(dom, LogUniform):
            lo, hi = math.log(dom.low), math.log(dom.high)
            return (math.log(value) - lo) / max(hi - lo, 1e-12)
        if isinstance(dom, RandInt):
            return (value - dom.low) / max(dom.high - 1 - dom.low, 1)
        return None  # Choice handled categorically

    def _from_unit(self, key, unit: float):
        dom = self.space[key]
        unit = min(1.0, max(0.0, unit))
        if isinstance(dom, Uniform):
            return min(dom.high, max(dom.low,
                                     dom.low + unit * (dom.high - dom.low)))
        if isinstance(dom, LogUniform):
            lo, hi = math.log(dom.low), math.log(dom.high)
            # Clamp: exp(log-interpolation) can overshoot by 1 ulp.
            return min(dom.high, max(dom.low,
                                     math.exp(lo + unit * (hi - lo))))
        if isinstance(dom, RandInt):
            return int(round(dom.low + unit * (dom.high - 1 - dom.low)))
        raise TypeError(key)

    def _sample_random(self) -> Dict:
        cfg = {}
        for k, v in self.space.items():
            if isinstance(v, Domain):
                cfg[k] = v.sample(self.rng)
            elif callable(v) and not isinstance(v, type):
                cfg[k] = v()  # tune.sample_from style
            else:
                cfg[k] = v
        return cfg

    def _split(self):
        scored = sorted(self._history, key=lambda cs: cs[1],
                        reverse=(self.mode == "max"))
        n_good = max(1, int(self.gamma * len(scored)))
        return [c for c, _ in scored[:n_good]], [c for c, _ in scored[n_good:]]

    @staticmethod
    def _kde_logpdf(unit: float, points: List[float], bw: float) -> float:
        if not points:
            return 0.0
        total = sum(math.exp(-0.5 * ((unit - p) / bw) ** 2) for p in points)
        return math.log(total / len(points) + 1e-12)

    def suggest(self, trial_id: str) -> Optional[Dict]:
        if self.max_trials is not None and self._suggested >= self.max_trials:
            return None
        self._suggested += 1
        if len(self._history) < self.n_startup or not self._history:
            cfg = self._sample_random()
            self._live[trial_id] = cfg
            return cfg
        good, bad = self._split()
        bw = max(0.1, 1.0 / max(len(good), 1) ** 0.5)
        # Candidate-independent per-key statistics, hoisted out of the
        # candidate loop (they only depend on the good/bad split).
        stats: Dict[str, tuple] = {}
        for k, dom in self.space.items():
            if isinstance(dom, Choice):
                counts_g = {c: 1.0 for c in dom.categories}
                for g in good:
                    counts_g[g[k]] = counts_g.get(g[k], 1.0) + 1.0
                counts_b = {c: 1.0 for c in dom.categories}
                for b in bad:
                    counts_b[b[k]] = counts_b.get(b[k], 1.0) + 1.0
                stats[k] = (counts_g, counts_b)
            elif isinstance(dom, Domain):
                stats[k] = ([self._to_unit(k, g[k]) for g in good],
                            [self._to_unit(k, b[k]) for b in bad])
        best_cfg, best_score = None, -math.inf
        for _ in range(self.n_candidates):
            cand = {}
            score = 0.0
            for k, dom in self.space.items():
                if isinstance(dom, Choice):
                    # Categorical TPE: sample from good-frequencies,
                    # score by smoothed count ratio.
                    counts_g, counts_b = stats[k]
                    cats, weights = zip(*counts_g.items())
                    choice = self.rng.choices(cats, weights=weights)[0]
                    score += (math.log(counts_g[choice] / max(len(good), 1))
                              - math.log(counts_b[choice] / max(len(bad), 1)))
                    cand[k] = choice
                elif isinstance(dom, Domain):
                    anchors, bad_units = stats[k]
                    anchor = self.rng.choice(anchors)
                    unit = anchor + self.rng.gauss(0.0, bw)
                    cand[k] = self._from_unit(k, unit)
                    unit = self._to_unit(k, cand[k])
                    score += self._kde_logpdf(
                        unit, anchors, bw) - self._kde_logpdf(
                        unit, bad_units, bw)
                elif callable(dom) and not isinstance(dom, type):
                    cand[k] = dom()
                else:
                    cand[k] = dom
            if score > best_score:
                best_cfg, best_score = cand, score
        self._live[trial_id] = best_cfg
        return best_cfg

    def on_trial_complete(self, trial_id: str, result: Optional[Dict],
                          error: bool = False) -> None:
        cfg = self._live.pop(trial_id, None)
        if cfg is None or error or not result or self.metric not in result:
            return
        self._history.append((cfg, float(result[self.metric])))


class BOHBSearcher(TPESearcher):
    """BOHB's model-based component: a TPE/KDE model fit on the *largest
    budget* that has enough observations, paired with successive-halving
    brackets for the multi-fidelity part.

    Reference analog: ``tune/search/bohb`` (TuneBOHB wrapping
    hpbandster's KDE model) used with
    ``tune/schedulers/hb_bohb.py`` (HyperBandForBOHB); Falkner et al.
    2018. The pairing here is :class:`AsyncHyperBandScheduler` — ASHA
    provides the budget allocation (rungs = budgets); this searcher
    provides the model. Use :func:`create_bohb` to build the pair.

    The BOHB rule implemented (paper §3.2): keep observations per budget
    (the trial's highest reached ``time_attr``); fit the good/bad KDE
    split only from the largest budget b with ``|D_b| >= d + min_points``
    observations, so the model always reflects the highest-fidelity
    evidence available.
    """

    def __init__(self, space: Dict, metric: str, mode: str = "min",
                 time_attr: str = "training_iteration",
                 min_points_in_model: Optional[int] = None,
                 n_candidates: int = 24, gamma: float = 0.25,
                 max_trials: Optional[int] = 64,
                 seed: Optional[int] = None):
        dims = sum(1 for v in space.values() if isinstance(v, Domain))
        min_points = (min_points_in_model if min_points_in_model
                      is not None else dims + 2)
        super().__init__(space, metric, mode=mode,
                         n_startup_trials=min_points,
                         n_candidates=n_candidates, gamma=gamma,
                         max_trials=max_trials, seed=seed)
        self.time_attr = time_attr
        self.min_points = min_points
        # budget -> [(config, score)]
        self._by_budget: Dict[float, List[tuple]] = {}

    def on_trial_complete(self, trial_id: str, result: Optional[Dict],
                          error: bool = False) -> None:
        cfg = self._live.pop(trial_id, None)
        if cfg is None or error or not result or self.metric not in result:
            return
        budget = float(result.get(self.time_attr, 0))
        self._by_budget.setdefault(budget, []).append(
            (cfg, float(result[self.metric])))
        # Rebuild the model set from the largest adequately-populated
        # budget (falling back to pooling everything when no single
        # budget qualifies yet).
        for b in sorted(self._by_budget, reverse=True):
            if len(self._by_budget[b]) >= self.min_points:
                self._history = list(self._by_budget[b])
                return
        self._history = [cs for rows in self._by_budget.values()
                         for cs in rows]


def create_bohb(space: Dict, metric: str, mode: str = "min",
                time_attr: str = "training_iteration",
                max_t: int = 100, grace_period: int = 1,
                reduction_factor: float = 3,
                max_trials: Optional[int] = 64,
                seed: Optional[int] = None):
    """Build the (scheduler, searcher) BOHB pair — the reference requires
    HyperBandForBOHB + TuneBOHB together (hb_bohb.py docstring); this is
    the equivalent coupled construction."""
    from .schedulers import AsyncHyperBandScheduler

    scheduler = AsyncHyperBandScheduler(
        metric=metric, mode=mode, time_attr=time_attr,
        grace_period=grace_period, reduction_factor=reduction_factor,
        max_t=max_t)
    searcher = BOHBSearcher(space, metric, mode=mode, time_attr=time_attr,
                            max_trials=max_trials, seed=seed)
    return scheduler, searcher


class RandomSearch(BasicVariantGenerator):
    """Pure random sampling (no grid keys required)."""


class ConcurrencyLimiter(Searcher):
    """Caps in-flight suggestions from a wrapped searcher (reference:
    ``tune/search/concurrency_limiter.py``): model-based searchers like
    TPE degrade when many trials launch before any feedback arrives —
    the limiter returns None (no new trial) while ``max_concurrent``
    suggestions are outstanding."""

    def __init__(self, searcher: Searcher, max_concurrent: int = 2):
        if max_concurrent < 1:
            raise ValueError("max_concurrent must be >= 1")
        self.searcher = searcher
        self.max_concurrent = max_concurrent
        self._live: set = set()

    def suggest(self, trial_id: str):
        if len(self._live) >= self.max_concurrent:
            return None
        config = self.searcher.suggest(trial_id)
        if config is not None:
            self._live.add(trial_id)
        return config

    def on_trial_complete(self, trial_id: str, result=None,
                          error: bool = False) -> None:
        self._live.discard(trial_id)
        self.searcher.on_trial_complete(trial_id, result, error=error)
