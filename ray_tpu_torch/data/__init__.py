"""Data of the port (counterparts of the JAX package's ``data``)."""

from .dataset import block_to_format, block_to_numpy, to_torch

__all__ = ["block_to_format", "block_to_numpy", "to_torch"]
