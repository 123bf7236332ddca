"""Train/AIR-style configuration dataclasses: counterpart of the JAX
package's ``train/config.py``.

Reference analog: ``python/ray/air/config.py`` — ``ScalingConfig`` (:79),
``RunConfig`` (:452 area), ``FailureConfig``, ``CheckpointConfig`` (:511).
A ScalingConfig names a mesh layout (the port's ``MeshSpec``) and a
worker count; ``use_gpu`` asks each worker's bundle for a card, where the
JAX package's ``use_tpu`` asks for a TPU.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from ..parallel.mesh import MeshSpec


@dataclass
class ScalingConfig:
    """How a trainer scales over the cluster.

    num_workers: worker processes joining the SPMD program (reference:
      train workers).
    use_gpu: each worker's bundle holds ``"GPU": 1.0`` (the runtime must
      offer it: ``init(resources=device.gpu_resources())``).
    mesh: parallelism layout over all devices the job claims; the train
      loop's config receives it as ``mesh_spec``.
    resources_per_worker: scheduler resources per worker actor.
    """

    num_workers: int = 1
    use_gpu: bool = False
    mesh: Optional[MeshSpec] = None
    resources_per_worker: Dict[str, float] = field(default_factory=dict)
    placement_strategy: str = "PACK"

    def worker_resources(self) -> Dict[str, float]:
        res = dict(self.resources_per_worker)
        res.setdefault("CPU", 1.0)
        if self.use_gpu:
            res.setdefault("GPU", 1.0)
        return res


@dataclass
class FailureConfig:
    """Reference: air/config.py FailureConfig — trial-level retries.

    gang_start_timeout_s: how long a restart may wait for cluster
    capacity before the failed reservation burns one of max_failures."""

    max_failures: int = 0
    gang_start_timeout_s: float = 120.0


@dataclass
class CheckpointConfig:
    """Reference: air/config.py:511 — keep-N + score-based retention."""

    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"
    checkpoint_frequency: int = 0
    checkpoint_at_end: bool = True
    # Snapshot to the host at the report, pickling and disk IO on a
    # background thread (the trainer joins pending saves before returning).
    async_save: bool = False


@dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(
        default_factory=CheckpointConfig)
    stop: Optional[Dict[str, Any]] = None
    verbose: int = 1
