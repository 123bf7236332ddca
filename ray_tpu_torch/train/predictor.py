"""Batch inference: Predictor + BatchPredictor over a dataset.
Counterpart of the JAX package's ``train/predictor.py``; ``TorchPredictor``
takes ``JaxPredictor``'s place.

Reference analog: ``python/ray/train/batch_predictor.py`` — a
BatchPredictor fans a dataset's blocks over a pool of scoring actors,
each hosting a Predictor restored from a Train Checkpoint. The actors run
on the runtime the caller passes (``runtime=``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..core.serialization import install
from ..device import default_device
from ..models.convert import tensor_from_numpy
from .checkpoint import Checkpoint, host_numpy, tree_map


class Predictor:
    """Loads model state from a Checkpoint and scores batches.

    Reference: ``train/predictor.py`` Predictor — subclass per framework.
    """

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint,
                        **kwargs) -> "Predictor":
        raise NotImplementedError

    def predict(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        raise NotImplementedError


def _to_device(x, dev):
    if isinstance(x, np.ndarray):
        x = tensor_from_numpy(x)
    return x.to(dev) if isinstance(x, torch.Tensor) else x


class TorchPredictor(Predictor):
    """Predictor over a pure ``apply_fn(params, batch) -> output``.

    ``params`` is a tree of tensors or numpy arrays; it goes to
    ``default_device(device)`` once, here. Numpy batches go in and numpy
    comes out (bf16 widened to fp32), under ``torch.inference_mode()``.
    """

    def __init__(self, params: Any, apply_fn: Callable, device=None):
        self._dev = default_device(device)
        self._params = tree_map(lambda x: _to_device(x, self._dev), params)
        self._apply = apply_fn

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint,
                        apply_fn: Optional[Callable] = None, device=None,
                        **_) -> "TorchPredictor":
        """``params`` is the checkpoint dict's ``params`` entry, as for the
        JAX package's ``JaxPredictor``, or its ``__arrays__``'s, where the
        port's train loops keep tensors so that they are saved as arrays."""
        if apply_fn is None:
            raise ValueError("TorchPredictor needs apply_fn=(params, batch)"
                             " -> outputs")
        data = checkpoint.to_dict()
        params = data.get("params", data.get("__arrays__", {}).get("params"))
        if params is None:
            raise ValueError("checkpoint has no 'params' entry")
        return cls(params, apply_fn, device=device)

    def predict(self, batch):
        with torch.inference_mode():
            out = self._apply(self._params,
                              tree_map(lambda x: _to_device(x, self._dev),
                                       batch))
            return tree_map(host_numpy, out)


class _ScoringWorker:
    """Actor body hosting one Predictor (reference: the scoring actors
    BatchPredictor spawns via map_batches compute=actors)."""

    def __init__(self, checkpoint: Checkpoint, predictor_cls,
                 predictor_kwargs: dict):
        install()  # this process sends tensors back
        self._predictor = predictor_cls.from_checkpoint(
            checkpoint, **predictor_kwargs)

    def score(self, block, batch_format: str):
        from ..data.dataset import block_to_format

        return self._predictor.predict(block_to_format(block, batch_format))


class BatchPredictor:
    """Scores a whole dataset with a pool of predictor actors.

    Reference: ``train/batch_predictor.py`` BatchPredictor —
    ``from_checkpoint(...)`` then ``predict(dataset)`` returns a dataset
    of predictions.
    """

    def __init__(self, checkpoint: Checkpoint, predictor_cls,
                 **predictor_kwargs):
        self._checkpoint = checkpoint
        self._predictor_cls = predictor_cls
        self._predictor_kwargs = predictor_kwargs

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, predictor_cls,
                        **predictor_kwargs) -> "BatchPredictor":
        return cls(checkpoint, predictor_cls, **predictor_kwargs)

    def predict(self, dataset, *, runtime, batch_format: str = "numpy",
                min_scoring_workers: int = 1,
                max_scoring_workers: int = 4,
                num_cpus: float = 1.0):
        """Block-parallel scoring over a pool of actors of ``runtime``;
        returns ``type(dataset)`` over the per-block prediction batches
        (the dataset class is the caller's: any class built from a list of
        block refs with ``num_blocks()`` and ``_blocks``, as the JAX
        package's ``Dataset``)."""
        from ..util.actor_pool import ActorPool

        install()  # the checkpoint may hold tensors
        worker_cls = runtime.remote(_ScoringWorker)
        n = max(min_scoring_workers,
                min(max_scoring_workers, dataset.num_blocks()))
        pool = ActorPool([
            worker_cls.options(num_cpus=num_cpus).remote(
                self._checkpoint, self._predictor_cls,
                self._predictor_kwargs)
            for _ in range(n)
        ], runtime)
        results = list(pool.map(
            lambda a, ref: a.score.remote(ref, batch_format),
            dataset._blocks,
        ))
        return type(dataset)([runtime.put(b) for b in results])
