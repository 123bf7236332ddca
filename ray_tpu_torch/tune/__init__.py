"""Tune library of the port (counterpart of the JAX package's ``tune``):
experiment execution on the port's session and an injected actor runtime
(``Tuner(..., runtime=)``), search, schedulers. ``search``,
``schedulers`` and ``syncer`` are copies of the JAX package's; ``tuner``
is its counterpart.

Reference analog: ``python/ray/tune``.
"""

from .schedulers import (
    AsyncHyperBandScheduler,
    FIFOScheduler,
    MedianStoppingRule,
    PB2,
    PopulationBasedTraining,
    TrialDecision,
    TrialScheduler,
)
from .search import (
    BasicVariantGenerator,
    BOHBSearcher,
    Choice,
    Domain,
    GridSearch,
    ConcurrencyLimiter,
    RandomSearch,
    TPESearcher,
    Searcher,
    create_bohb,
    choice,
    grid_search,
    loguniform,
    randint,
    uniform,
)
from .tuner import (
    ResultGrid,
    Trial,
    TrialRunner,
    TrialStatus,
    TuneConfig,
    Tuner,
    report,
    run,
)

__all__ = [
    "AsyncHyperBandScheduler", "BOHBSearcher", "BasicVariantGenerator",
    "Choice", "Domain",
    "FIFOScheduler", "GridSearch", "MedianStoppingRule", "PB2",
    "ConcurrencyLimiter", "PopulationBasedTraining", "RandomSearch",
    "ResultGrid", "Searcher", "TPESearcher", "create_bohb",
    "Trial", "TrialDecision", "TrialRunner", "TrialScheduler", "TrialStatus",
    "TuneConfig", "Tuner", "choice", "grid_search", "loguniform", "randint",
    "report", "run", "uniform",
]
