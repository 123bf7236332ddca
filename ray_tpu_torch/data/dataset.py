"""Feeding the device from a dataset: counterpart of the JAX package's
``Dataset.to_jax`` (``data/dataset.py:522-537``), with the port's copy of
the numpy branch of ``BlockAccessor.to_numpy``/``to_format``
(``data/block.py:59,84``).

``to_torch`` is a function over any object with ``iter_batches(
batch_size=, batch_format="numpy", drop_last=)`` (the JAX package's
``Dataset`` is one), so the port needs no dataset class of its own.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator

import numpy as np
import torch

from ..device import default_device
from ..models.convert import tensor_from_numpy


def to_torch(dataset, *, batch_size: int = 256, device=None,
             drop_last: bool = True) -> Iterator[Dict[str, torch.Tensor]]:
    """Numpy batches of ``dataset`` as tensors on ``default_device(device)``
    (CUDA unless the caller asks for the CPU)."""
    dev = default_device(device)
    for batch in dataset.iter_batches(batch_size=batch_size,
                                      batch_format="numpy",
                                      drop_last=drop_last):
        yield {k: tensor_from_numpy(v).to(dev) for k, v in batch.items()}


def block_to_numpy(block: Any) -> Dict[str, np.ndarray]:
    """A block (a list of rows or of values, a dict of columns, or a
    pandas DataFrame) as a dict of numpy columns."""
    if isinstance(block, dict):
        return block
    if isinstance(block, list):
        if not block:
            return {}
        if isinstance(block[0], dict):
            keys = block[0].keys()
            return {k: np.asarray([r[k] for r in block]) for k in keys}
        return {"value": np.asarray(block)}
    return {c: block[c].to_numpy() for c in block.columns}


def block_to_format(block: Any, batch_format: str) -> Dict[str, np.ndarray]:
    """``BlockAccessor.to_format``'s numpy branch, the only format the
    port's scoring workers take."""
    if batch_format in ("numpy", "np"):
        return block_to_numpy(block)
    raise ValueError(f"batch_format {batch_format!r}: the port scores "
                     "numpy batches only")
