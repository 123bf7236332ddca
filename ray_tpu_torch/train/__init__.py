"""Train library of the port (counterparts of the JAX package's
``train``): the training step builders, the optimizers, and the Train
surface on an injected actor runtime (``WorkerGroup``, ``TorchTrainer``,
``session``, checkpoints, ``TorchPredictor``/``BatchPredictor``).

Reference analog: ``python/ray/train`` + the AIR session/config/checkpoint
surface (``python/ray/air``).
"""

from . import session
from .checkpoint import (Checkpoint, CheckpointManager, restore_arrays,
                         save_arrays)
from .config import CheckpointConfig, FailureConfig, RunConfig, ScalingConfig
from .predictor import BatchPredictor, Predictor, TorchPredictor
from .step import build_sharded_train, default_optimizer, make_eval_step
from .trainer import BackendExecutor, DataParallelTrainer, Result, TorchTrainer
from .worker_group import WorkerGroup

__all__ = [
    "BatchPredictor",
    "Predictor",
    "TorchPredictor",
    "BackendExecutor", "Checkpoint", "CheckpointConfig", "CheckpointManager",
    "DataParallelTrainer", "FailureConfig", "Result", "RunConfig",
    "ScalingConfig", "TorchTrainer", "WorkerGroup", "build_sharded_train",
    "default_optimizer", "make_eval_step", "restore_arrays", "save_arrays",
    "session",
]
